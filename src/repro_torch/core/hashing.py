"""Integer hashing: murmur3 fmix32 and range reduction, bit-exact with the JAX package.

PyTorch on the CPU implements neither ``>>`` nor ``%`` for ``torch.uint32``,
so the arithmetic runs in int64 and is masked back to 32 bits after every
multiply. Inputs may be uint32, int32 (read as its bit pattern), int64 or
float32 (hashed by its bits). Outputs of ``mix32`` are int64 in [0, 2^32);
``hash_mod`` returns int64 row indices.
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


def mix32(x: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """Murmur3 fmix32 finalizer with seed. Bijective for a fixed seed."""
    return _fmix(as_u32(x) ^ (seed & _M32))


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
                 small: bool = True) -> torch.Tensor:
    """``hash_mod`` with the multiply-shift / modulo branch chosen by the caller.

    The small branch is the 16-bit split multiply-shift of the JAX package,
    which wraps at 32 bits exactly as uint32 arithmetic does there.
    """
    h = mix32(x, seed)
    if small:
        lo = h & 0xFFFF
        hi = h >> 16
        t = (hi * mod + (((lo * mod) & _M32) >> 16)) & _M32
        return t >> 16
    return h % mod


def hash_mod(x: torch.Tensor, mod: int, seed: int = 0) -> torch.Tensor:
    """Hash entries into {0, ..., mod-1}: multiply-shift below 2^16, else modulo."""
    return hash_mod_dyn(x, mod, seed, small=mod < (1 << 16))
