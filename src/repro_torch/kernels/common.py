"""Build, load and launch the CUDA pruning kernels.

The kernels are CUDA C++ for Hopper (``csrc/*.cu``) with a plain C
interface. On first use on a card, every source is compiled with ``nvcc``
for ``sm_90a`` and ``--ftz=true`` (one process per source, all started
together; f32 subnormals flush in every add, minimum, maximum and compare,
as XLA's do, ``flush_subnormals``), linked into
one shared library under ``_build/<hash of the sources>/`` beside this file,
and loaded with ``ctypes``. A change to any source changes the hash and so
triggers a rebuild. Nothing here runs when the module is imported.

``nvcc`` is taken from ``CUDA_HOME`` (as PyTorch resolves it: the
environment variable, then ``PATH``, then ``/usr/local/cuda``); a missing
compiler or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from functools import lru_cache
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
# every source computes f32 with subnormals flushed to a zero of their sign
# (add.ftz, min.ftz, setp.*.ftz), as XLA computes: ROADMAP Queue 3 A25
FTZ_FLAGS = ("--ftz=true",)
LIB_NAME = "libcheetah_kernels.so"

_lib: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _source_hash() -> str:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS + FTZ_FLAGS).encode())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    """Path of ``nvcc``; raises RuntimeError when there is none."""
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = []
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found: set CUDA_HOME or put nvcc on PATH to build the "
        "repro_torch CUDA kernels")


def build(verbose: bool = False) -> Path:
    """Compile the kernel sources into the shared library; returns its path.

    The objects compile in parallel; the library is moved into place
    atomically, so concurrent builders never load a half-written file.
    """
    out_dir = BUILD_ROOT / _source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        common = [nvcc, *ARCH_FLAGS, *FTZ_FLAGS, "-std=c++17", "-O3",
                  "-Xcompiler", "-fPIC", f"-I{CSRC}"]
        if verbose:
            common.append("-Xptxas=-v")
        procs = []
        objs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = os.path.join(tmp, src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [*common, "-c", str(src), "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for src, p in procs:
            out, _ = p.communicate()
            if verbose and out:
                print(out)
            if p.returncode != 0:
                failed.append(f"{src.name}:\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = os.path.join(tmp, LIB_NAME)
        res = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", tmp_lib,
                              *objs], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + res.stdout + res.stderr)
        os.replace(tmp_lib, lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
    return _lib


P = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_longlong
U32 = ctypes.c_uint32
F32 = ctypes.c_float


def library_fn(name: str, argtypes: list, restype):
    """The C function ``name`` of the kernel library, typed."""
    fn = getattr(library(), name)
    fn.argtypes = argtypes
    fn.restype = restype
    return fn


def workspace(device: torch.device, size_fn: str, *args) -> torch.Tensor:
    """Scratch device memory of the size that the C function ``size_fn``
    gives for the int arguments ``args`` (the row-parallel walks' partition
    buffers); the launch carves it up."""
    nbytes = int(library_fn(size_fn, [I32] * len(args), ctypes.c_size_t)(
        *args))
    return torch.empty(max(nbytes, 16), dtype=torch.uint8, device=device)


class LaunchCount:
    """A named launch count.

    ``launches`` is a plain integer that goes up by one for every launch
    and nowhere else, so a caller can show that a path ran the kernel.
    """

    def __init__(self, name: str):
        self.name = name
        self.launches = 0


class CudaKernel(LaunchCount):
    """One C entry point of the kernel library and its launch count. An
    entry point that picks one of two kernels by an argument counts the
    second in a ``LaunchCount`` of its own, passed to ``launch``."""

    def __init__(self, name: str, argtypes: list, smem_fn: str | None = None):
        super().__init__(name)
        self.argtypes = argtypes
        self.smem_fn = smem_fn
        self._fn = None  # the typed C function, once the library is loaded

    def smem_bytes(self, *args) -> int:
        """Dynamic shared memory the launch will ask for."""
        return int(library_fn(self.smem_fn, [I32] * len(args),
                              ctypes.c_size_t)(*args))

    def launch(self, device: torch.device, *args,
               count: LaunchCount | None = None) -> None:
        """Launch on ``device``'s current stream, with ``device`` made the
        current one (shared-memory attributes are set per device); raises on
        a refused launch. The launch adds one to ``count``, or to this
        entry point's own count."""
        if self._fn is None:
            self._fn = library_fn(self.name, self.argtypes + [P], I32)
        stream = torch.cuda.current_stream(device).cuda_stream
        if device.index in (None, torch.cuda.current_device()):
            err = self._fn(*args, stream)
        else:
            with torch.cuda.device(device):
                err = self._fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch: "
                               f"cudaError {err}")
        (count or self).launches += 1


def ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype,
               device: torch.device | None = None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (on
    ``device``, when given)."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, the other inputs on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_rowpar(m: int, w: int, slot_bytes: int) -> None:
    """Raise unless a row-parallel walk takes a stream of m entries and a
    row of w slots of ``slot_bytes`` each: a row of more than 32 slots is
    walked in shared memory, so it must fit there, and entry indices fit an
    int32."""
    if w > 32 and w * slot_bytes > MAX_SMEM:
        raise ValueError(f"a row of {w} slots ({w * slot_bytes} bytes) does "
                         f"not fit the {MAX_SMEM} bytes of shared memory of "
                         "the row-parallel walk")
    if m >= (1 << 31):
        raise ValueError(f"the row-parallel walk indexes entries in int32; "
                         f"got m = {m}")


@lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The SMs of ``device``, asked once."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def grid_for(m: int, device: torch.device, threads: int = 256) -> int:
    """Blocks for a grid-stride elementwise kernel over m entries."""
    return max(1, min(-(-m // threads), sm_count(device) * 16))


def query_out(keys: torch.Tensor, m: int, dtype: torch.dtype) -> torch.Tensor:
    """An empty output of m entries whose entry i sits at key i's offset
    mod 16 (in keys), so that a persistent query (``csrc/query.cuh``) stores
    each unit of 4 keys' entries with one vector store, whatever 4-byte
    offset the keys start at; a view into a buffer of m + 3."""
    off = (keys.data_ptr() >> 2) & 3
    return torch.empty(m + 3, dtype=dtype, device=keys.device)[off:off + m]


MAX_SMEM = 232448  # bytes a Hopper block can opt into (227 KB)
FLT_MIN = 1.1754943508222875e-38  # the least normal float32


def flush_subnormals(x: torch.Tensor) -> torch.Tensor:
    """f32 subnormals as a zero of their sign, as XLA flushes them in every
    add, minimum, maximum and compare (on the CPU as on the TPU); a copy, a
    select or a gather keeps them. The plain versions flush the operands of
    each such operation with this, and the kernels compute with ``.ftz``
    (``build``)."""
    return torch.where(x.abs() < FLT_MIN, x * 0, x)


def ftz_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """An f32 add as XLA takes it: operands and result flushed."""
    return flush_subnormals(flush_subnormals(a) + flush_subnormals(b))


def xla_minimum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.minimum`` of f32 tensors: subnormals flushed, a NaN wins, and
    -0 is below +0 (``torch.minimum`` may take +0 of the two zeros)."""
    a, b = flush_subnormals(a), flush_subnormals(b)
    zeros = (a == 0) & (b == 0)
    return torch.where(zeros, torch.where(a.signbit(), a, b),
                       torch.minimum(a, b))


def xla_maximum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum`` of f32 tensors: subnormals flushed, a NaN wins, and
    +0 is above -0."""
    a, b = flush_subnormals(a), flush_subnormals(b)
    zeros = (a == 0) & (b == 0)
    return torch.where(zeros, torch.where(a.signbit(), b, a),
                       torch.maximum(a, b))


_I32_MAX = 0x7FFFFFFF


def ordered_i32(x: torch.Tensor) -> torch.Tensor:
    """The order-preserving int32 image of f32 ``x`` (-0 below +0), with
    every NaN, whatever its sign, mapped above every other value."""
    i = x.view(torch.int32)
    return torch.where(x.isnan(), _I32_MAX,
                       torch.where(i < 0, i ^ _I32_MAX, i))


def unordered_f32(o: torch.Tensor) -> torch.Tensor:
    """The inverse of ``ordered_i32`` (a NaN comes back as 0x7FFFFFFF)."""
    return torch.where(o < 0, o ^ _I32_MAX, o).view(torch.float32)


def amax_f32(x: torch.Tensor) -> torch.Tensor:
    """``jnp.max`` of an f32 tensor: subnormals flushed, a NaN wins, and +0
    is above -0 (a maximum of the order-preserving int32 image)."""
    return unordered_f32(ordered_i32(flush_subnormals(x)).amax())


def cummin_f32(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The running ``jnp.minimum`` along ``dim`` of flushed f32 ``x``: a
    NaN wins from where it stands on, and -0 is below +0 (a ``cummin`` of
    the order-preserving int32 image, every NaN put at the bottom)."""
    o = torch.where(x.isnan(), -_I32_MAX - 1, ordered_i32(x))
    return unordered_f32(torch.cummin(o, dim).values)


def xla_sum_f32(t: torch.Tensor) -> torch.Tensor:
    """``jnp.sum(t, axis=0)`` of f32 ``t`` [S, ...] in the order of XLA's CPU
    reduction (ROADMAP Queue 3 A29), every add flushed: one element is
    itself (a copy); up to 32 add in order from +0; more are cut into
    ceil(S / 32) windows of 32, the first short by (32 * windows - S) // 2
    and the last by the rest, each window adds in order from +0, and the
    window sums add by the same rule. One torch function on the CPU and the
    card alike: 32 flushed adds across all the windows at once a level."""
    S = t.shape[0]
    if S == 1:
        return t[0].clone()
    t = flush_subnormals(t)
    if S > 32:
        nwin = -(-S // 32)
        front = (32 * nwin - S) // 2
        # +0 in front and -0 behind are the adds a window without them
        # takes: +0 + +0 is +0, and x + -0 is x for every x
        pads = torch.zeros((32 * nwin - S,) + tuple(t.shape[1:]),
                           dtype=t.dtype, device=t.device)
        pads[front:] = -0.0
        t = torch.cat([pads[:front], t, pads[front:]]).reshape(
            (nwin, 32) + tuple(t.shape[1:]))
        acc = torch.zeros_like(t[:, 0])
        for i in range(32):
            acc = flush_subnormals(acc + t[:, i])
        return xla_sum_f32(acc) if nwin > 1 else acc[0]
    acc = torch.zeros_like(t[0])
    for i in range(S):
        acc = flush_subnormals(acc + t[i])
    return acc
