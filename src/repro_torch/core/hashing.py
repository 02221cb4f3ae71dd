"""Integer hashing: murmur3 fmix32 and range reduction, bit-exact with the JAX package.

PyTorch on the CPU implements neither ``>>`` nor ``%`` for ``torch.uint32``,
so the arithmetic runs in int64 and is masked back to 32 bits after every
multiply. Inputs may be uint32, int32 (read as its bit pattern), int64 or
float32 (hashed by its bits). Outputs of ``mix32`` are int64 in [0, 2^32);
``hash_mod`` returns int64 row indices.

``signed=True`` is the arithmetic of the JAX package's Pallas kernels on an
int32 key (``kernels/common.py`` ``mix32`` / ``hash_mod`` compute in the
key's own dtype): every ``>>`` is arithmetic, every product wraps as int32,
and the range reduction and its modulo are signed. The mixed hash is then
always below 2^31, so a width below 2^16 is filled only in its lower half,
and at widths of 2^15 or more the multiply-shift gives -1 for about one key
in 2^16 (``lo * mod`` wraps negative while ``hi`` is 0): such a probe
matches no column of the Pallas kernels' one-hot and is dropped.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_C3 = 0x9E3779B9  # golden-ratio increment between the seeds of multi_hash


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """The 32-bit lanes of ``x`` as int64 values in [0, 2^32)."""
    if x.dtype in (torch.uint32, torch.float32):
        x = x.view(torch.int32)
    return x.to(torch.int64) & _M32


def by_value(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a tensor that compares as its values do: uint32 by value in
    int64 (torch compares no uint32 on the CPU), other integers in int64,
    floats as they are."""
    if x.dtype == torch.uint32:
        return as_u32(x)
    return x if x.is_floating_point() else x.to(torch.int64)


def _fmix(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = (h * _C1) & _M32
    h = h ^ (h >> 13)
    h = (h * _C2) & _M32
    return h ^ (h >> 16)


def _signed(h: torch.Tensor) -> torch.Tensor:
    """32-bit lanes in [0, 2^32) read as int32 values (in int64)."""
    return torch.where(h >= (1 << 31), h - (1 << 32), h)


def _sar(h: torch.Tensor, s: int) -> torch.Tensor:
    """Arithmetic shift of 32-bit lanes, back in [0, 2^32)."""
    return (_signed(h) >> s) & _M32


def _fmix_signed(h: torch.Tensor) -> torch.Tensor:
    h = h ^ _sar(h, 16)
    h = (h * _C1) & _M32
    h = h ^ _sar(h, 13)
    h = (h * _C2) & _M32
    return h ^ _sar(h, 16)


def mix32(x: torch.Tensor, seed: int = 0, *,
          signed: bool = False) -> torch.Tensor:
    """Murmur3 fmix32 finalizer with seed. Bijective for a fixed seed.
    ``signed``: with the int32 shifts of the Pallas kernels (module doc)."""
    h = as_u32(x) ^ (seed & _M32)
    return _fmix_signed(h) if signed else _fmix(h)


def multi_hash(x: torch.Tensor, mod: int, num: int,
               seed: int = 0) -> torch.Tensor:
    """``num`` independent hashes in {0..mod-1}; shape ``x.shape + (num,)``.

    Hash j mixes with the seed ``j * 0x9E3779B9 + seed`` (mod 2^32) and
    reduces by modulo, on both sides of 2^16 (unlike ``hash_mod``).
    Returns int64.
    """
    seeds = (torch.arange(num, dtype=torch.int64, device=x.device) * _C3
             + seed) & _M32
    return _fmix(as_u32(x)[..., None] ^ seeds) % mod


def hash_mod_dyn(x: torch.Tensor, mod: int, seed: int = 0, *,
                 small: bool = True, signed: bool = False) -> torch.Tensor:
    """``hash_mod`` with the multiply-shift / modulo branch chosen by the caller.

    The small branch is the 16-bit split multiply-shift of the JAX package,
    which wraps at 32 bits exactly as uint32 arithmetic does there.
    ``signed``: in int32 arithmetic, as the Pallas kernels hash an int32
    key; the answer may then be -1 (module doc).
    """
    h = mix32(x, seed, signed=signed)
    if signed:
        if small:
            lo = h & 0xFFFF
            t = _signed((_signed(h) >> 16) * mod
                        + (_signed((lo * mod) & _M32) >> 16))
            return _signed(t & _M32) >> 16
        m = mod & _M32
        return _signed(h) % (m - (1 << 32) if m >= (1 << 31) else m)
    if small:
        lo = h & 0xFFFF
        hi = h >> 16
        t = (hi * mod + (((lo * mod) & _M32) >> 16)) & _M32
        return t >> 16
    return h % mod


def hash_mod(x: torch.Tensor, mod: int, seed: int = 0, *,
             signed: bool = False) -> torch.Tensor:
    """Hash entries into {0, ..., mod-1}: multiply-shift below 2^16, else
    modulo. ``signed``: as the Pallas kernels hash an int32 key."""
    return hash_mod_dyn(x, mod, seed, small=mod < (1 << 16), signed=signed)
