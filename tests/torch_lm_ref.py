"""Shared inputs of the LM parity tests (``tests/test_torch_models.py``,
``test_torch_lm_decode.py``, ``test_torch_serve_lm.py``): the JAX
package's parameters and batches carried into the port as numpy arrays,
bf16 as its uint16 bits."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke as jget_smoke
from repro.models import LM as JLM
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_numpy


def to_numpy(a) -> np.ndarray:
    """A JAX array as numpy, bf16 as its uint16 bit pattern."""
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


def to_torch(a) -> torch.Tensor:
    """A JAX or numpy array as a CPU tensor, bf16 bit for bit."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        a = a.view(np.uint16)
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def as_f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.to(torch.float64).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32), np.float64)


def rel_err(ref, got) -> float:
    """max |ref - got| / max |ref|."""
    r, g = as_f64(ref), as_f64(got)
    return float(np.abs(r - g).max() / (np.abs(r).max() + 1e-30))


def batch(cfg, B=2, S=16, seed=0) -> dict:
    """``tests/test_models.py``'s ``_batch``, as JAX arrays."""
    rng = np.random.default_rng(seed)
    b = {"tokens": jnp.asarray(rng.integers(0, cfg.vocab, (B, S))
                               .astype(np.int32)),
         "labels": jnp.asarray(rng.integers(0, cfg.vocab, (B, S))
                               .astype(np.int32))}
    if cfg.frontend == "vision":
        b["patch_embeds"] = jnp.asarray(
            rng.normal(0, 0.02, (B, cfg.frontend_len, cfg.d_model))
        ).astype(jnp.bfloat16)
    if cfg.frontend == "audio":
        b["frame_embeds"] = jnp.asarray(
            rng.normal(0, 0.02, (B, S, cfg.d_model))).astype(jnp.bfloat16)
    return b


def torch_batch(b: dict) -> dict:
    return {k: to_torch(v) for k, v in b.items()}


def models(arch: str, seed: int):
    """(reference LM, its params, the port's LM holding the same params) of
    ``arch``'s smoke config, the params from ``jax.random.key(seed)``."""
    jlm = JLM(jget_smoke(arch))
    params, _ = jlm.init(jax.random.key(seed))
    tlm = lm_params_from_numpy(tconfigs.get_smoke(arch),
                               jax.tree.map(to_numpy, params), device="cpu")
    return jlm, params, tlm
