"""Encoded-column descriptors: prune before decode (late materialization).

Port of ``src/repro/core/encoding.py``. A dictionary-encoded stream carries
uint32 codes and a ``DictEncoding`` whose ``lut`` holds the distinct values
in ascending order, so code order is value order and code equality is value
equality. The engine gathers ``lut[code]`` at the entry of each pass-1 and
pass-2 body, so its masks are bit-identical to pruning the decoded column,
which is never stored. ``with_pad`` grows the dictionary by one slot that
decodes to a ragged-tail fill (NEG, 0), and the engine pads the code stream
with ``pad_code``.

The dictionary is ``np.unique``'s, built on the device: a stable sort and
the first value of each run of equal values. The two libraries differ on
floats, and the port follows numpy:
- ``np.unique`` collapses every NaN into one last entry (``equal_nan``);
  ``torch.unique`` keeps each NaN as a value of its own. The port collapses
  them, so a column with NaNs gets the same codes as in the JAX package.
- Both merge -0.0 and 0.0 (they compare equal) into one entry, whose sign is
  that of the first in sort order; the two sorts may order the two zeros
  differently, and the entries then differ in sign only, which no compare
  of the engine sees.

torch implements neither ``repeat_interleave`` (``index_select``) nor CPU
compares for ``uint32``, so uint32 columns go through their int32 view or
``hashing.by_value``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .hashing import by_value


def _as_tensor(values) -> torch.Tensor:
    if isinstance(values, torch.Tensor):
        return values
    return torch.from_numpy(np.ascontiguousarray(values))


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` along dim 0, uint32 through its int32 view."""
    if x.dtype == torch.uint32:
        return x.view(torch.int32)[idx].view(torch.uint32)
    return x[idx]


def cast_fill(fill, dtype: torch.dtype) -> torch.Tensor:
    """A one-element CPU tensor of ``dtype`` holding ``fill`` converted as
    numpy converts it, as the JAX package's ``jnp.asarray(fill, dtype)``
    does: NEG into int32 is -2^31, where ``torch.full`` refuses the
    overflow."""
    np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    with np.errstate(invalid="ignore", over="ignore"):
        return torch.from_numpy(np.asarray(fill).astype(np_dtype)[None])


def as_x32(x: torch.Tensor) -> torch.Tensor:
    """``x`` as ``jnp.asarray`` gives it to the JAX package (x64 off): int64
    and uint64 wrap into int32 and uint32, float64 rounds to float32; every
    other dtype stays."""
    if x.dtype == torch.int64:
        return x.to(torch.int32)
    if x.dtype == torch.uint64:
        return x.view(torch.int64).to(torch.int32).view(torch.uint32)
    if x.dtype == torch.float64:
        return x.to(torch.float32)
    return x


@dataclasses.dataclass(frozen=True)
class DictEncoding:
    """Sorted-dictionary encoding: ``decoded = lut[codes]``.

    ``pad_slot`` marks a ``with_pad``-appended last slot holding a
    ragged-tail fill; ``size`` is the logical dictionary size without it.
    """

    lut: torch.Tensor
    pad_slot: bool = False

    @property
    def size(self) -> int:
        return int(self.lut.shape[0]) - int(self.pad_slot)

    @property
    def pad_code(self) -> int:
        """Code of the pad slot (only after ``with_pad``)."""
        if not self.pad_slot:
            raise ValueError("encoding has no pad slot; call with_pad()")
        return self.size

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """Elementwise gather ``lut[codes]`` on codes of any shape."""
        return take_rows(self.lut, by_value(codes))

    def with_pad(self, fill) -> "DictEncoding":
        """An encoding with one more slot, decoding to ``fill`` converted
        to the dictionary's dtype (``cast_fill``)."""
        if self.pad_slot:
            return self
        lut = self.lut
        tail = cast_fill(fill, lut.dtype)
        if lut.dtype == torch.uint32:
            lut = torch.cat([lut.view(torch.int32),
                             tail.view(torch.int32).to(lut.device)])
            lut = lut.view(torch.uint32)
        else:
            lut = torch.cat([lut, tail.to(lut.device)])
        return DictEncoding(lut=lut, pad_slot=True)


def dict_encode(values) -> tuple[torch.Tensor, DictEncoding]:
    """Encode ``values`` (a tensor or numpy array, any shape) into
    (uint32 codes of the same shape, DictEncoding), as ``np.unique(values,
    return_inverse=True)`` does, on the device the values live on."""
    v = _as_tensor(values)
    flat = v.reshape(-1)
    key = by_value(flat)
    srt, order = torch.sort(key, stable=True)
    new = torch.ones(srt.shape, dtype=torch.bool, device=v.device)
    new[1:] = srt[1:] != srt[:-1]
    if srt.is_floating_point():
        new[1:] &= ~(srt[1:].isnan() & srt[:-1].isnan())
    gid = torch.cumsum(new, 0) - 1
    codes = torch.empty(flat.shape, dtype=torch.int32, device=v.device)
    codes[order] = gid.to(torch.int32)
    lut = take_rows(flat, order[new])
    if ambiguous_floats(flat):
        # which zero and which NaN stand for their class is np.unique's
        # pick (its sort's, which varies with the host's SIMD): take it
        lut = torch.from_numpy(np.unique(flat.cpu().numpy())).to(v.device)
    return codes.view(torch.uint32).reshape(v.shape), DictEncoding(lut=lut)


_SAME_SIZE_INT = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def ambiguous_floats(x: torch.Tensor) -> bool:
    """Whether a float ``x`` holds both -0.0 and +0.0, or NaNs of two bit
    patterns: values that ``np.unique`` collapses into one, choosing the
    one that stands for them by its own sort."""
    if not x.is_floating_point() or x.numel() == 0:
        return False
    zero = x == 0
    neg = torch.signbit(x)
    nan_bits = x[x.isnan()].view(_SAME_SIZE_INT[x.element_size()])
    ambiguous = (zero & neg).any() & (zero & ~neg).any()
    if nan_bits.numel():
        ambiguous |= nan_bits.amin() != nan_bits.amax()
    return bool(ambiguous)


def rle_encode(values) -> tuple[torch.Tensor, torch.Tensor]:
    """Run-length encode a 1-D column -> (run values, int32 run lengths)."""
    v = _as_tensor(values)
    if v.ndim != 1:
        raise ValueError("rle_encode expects a 1-D array")
    m = v.shape[0]
    if m == 0:
        return v, torch.zeros(0, dtype=torch.int32, device=v.device)
    key = by_value(v)
    change = torch.ones(m, dtype=torch.bool, device=v.device)
    change[1:] = key[1:] != key[:-1]
    starts = torch.nonzero(change).flatten()
    ends = torch.cat([starts[1:], starts.new_tensor([m])])
    return take_rows(v, starts), (ends - starts).to(torch.int32)


def rle_expand(run_values: torch.Tensor, run_lengths: torch.Tensor,
               total: int | None = None) -> torch.Tensor:
    """The flat column of the runs (inverse of ``rle_encode``); ``total``
    is the row count when the caller knows it."""
    m = int(run_lengths.sum()) if total is None else int(total)
    if run_values.dtype == torch.uint32:
        return rle_expand(run_values.view(torch.int32), run_lengths,
                          m).view(torch.uint32)
    return torch.repeat_interleave(run_values, run_lengths, output_size=m)


def normalize_encodings(encoding, nstreams: int) -> tuple:
    """Canonicalize ``encoding=`` to a per-stream tuple: None (nothing
    encoded), one ``DictEncoding`` (stream 0) or a sequence of
    ``DictEncoding | None`` no longer than the streams (padded with None,
    e.g. for the engine's appended validity column)."""
    if encoding is None:
        return (None,) * nstreams
    encs = (encoding,) if isinstance(encoding, DictEncoding) else \
        tuple(encoding)
    if len(encs) > nstreams:
        raise ValueError(
            f"encoding has {len(encs)} entries for {nstreams} streams")
    for e in encs:
        if e is not None and not isinstance(e, DictEncoding):
            raise TypeError(f"encoding entries must be DictEncoding or "
                            f"None, got {type(e).__name__}")
    return encs + (None,) * (nstreams - len(encs))
