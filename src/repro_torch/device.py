"""Where the port's constructors put their tensors."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; raises RuntimeError when no card is present.

    There is no quiet fall-back to the CPU: a caller who wants the CPU
    passes ``device="cpu"``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to build on the CPU")
    return dev
