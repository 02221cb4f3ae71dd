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


def to_u32(h: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as a uint32 tensor of the same bits."""
    return _signed(h).to(torch.int32).view(torch.uint32)


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


def _u32_seed(seed: int) -> int:
    """``seed`` as the JAX package converts it (``jnp.uint32(seed)``), which
    refuses a Python int outside [0, 2^32)."""
    if not 0 <= seed <= _M32:
        raise OverflowError(f"Python integer {seed} out of bounds for uint32")
    return seed


def fingerprint(cols, bits: int = 32, seed: int = 0) -> torch.Tensor:
    """Fingerprint one column or a list of columns into ``bits``-bit uint32.

    The paper's CWorker computes fingerprints of wide / multi-column entries
    before they reach the switch (Ex. 8, Thm 4). Column i of a list mixes as
    ``mix32(as_u32(c) + h * 0x9E3779B9, seed + i * 101)`` with every product
    and sum wrapped at 32 bits; the shapes broadcast. Returns uint32, the
    dtype the DISTINCT kernels take. ``fingerprint_bits_thm4`` sizes
    ``bits``.
    """
    if bits > 32:
        raise ValueError("fingerprints are uint32 lanes; bits must be <= 32")
    if isinstance(cols, (list, tuple)):
        cols = [torch.as_tensor(c) for c in cols]
        h = torch.zeros(torch.broadcast_shapes(*(c.shape for c in cols)),
                        dtype=torch.int64, device=cols[0].device)
        for i, c in enumerate(cols):
            h = mix32((as_u32(c) + h * _C3) & _M32, _u32_seed(seed + i * 101))
    else:
        h = mix32(torch.as_tensor(cols), _u32_seed(seed))
    return to_u32(h if bits == 32 else h & ((1 << bits) - 1))


def fingerprint_bits_thm4(d: int, D: int, delta: float,
                          w: int | None = None) -> int:
    """Thm 4: required fingerprint length f = ceil(log2(d * M^2 / delta)).

    M is the per-row distinct load bound; three regimes by D against
    d ln(2d/delta).
    """
    import math

    if D > d * math.log(2 * d / delta):
        M = math.e * D / d
    elif D >= d * math.log(1 / delta) / math.e:
        M = math.e * math.log(2 * d / delta)
    else:
        M = 1.3 * math.log(2 * d / delta) / math.log(
            (d / (D * math.e)) * math.log(2 * d / delta))
    return max(1, math.ceil(math.log2(d * M * M / delta)))
