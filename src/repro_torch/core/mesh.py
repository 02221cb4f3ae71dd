"""The port's device mesh: the positions the mesh engine spreads lanes over.

In the JAX package a mesh is a ``jax.sharding.Mesh``: one controller over
several devices (the tier-1 suite's 8 forced CPU devices), or, across
processes, ``jax.distributed`` (2 processes x 4 devices). ``Mesh`` mirrors
both with one class:

- ``devices`` is the tuple of torch devices this process drives, one a
  mesh position; a device may repeat (``("cpu",) * 8``, or
  ``("cuda:0",) * 8`` on one card);
- ``group`` is an optional ``torch.distributed`` process group joining
  processes that hold equal numbers of positions.

``mesh.shape[axis]`` is the global position count, ``len(devices)`` times
the group's size. Process p's position j is global position
``p * len(devices) + j``, and over S lanes it owns the contiguous lanes
``[pos * S/D, (pos + 1) * S/D)``, as ``shard_map``'s ``P(axis)`` assigns
them.

The mesh runs two collectives and nothing more: ``all_gather`` of a state
along its lane axis (local copies onto ``devices[0]``, then
``torch.distributed.all_gather`` over the group) and ``all_reduce`` sum
(JOIN's Bloom OR-merge). Neither is asynchronous, so no two collectives
are ever in flight at once: the JAX package needs a fence for that under
gloo (``src/repro/core/streaming.py:185-210``), the port does not. Under
gloo a CUDA tensor crosses through the host. Each collective adds one to
``mesh.collectives``.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..device import resolve_device


class Mesh:
    """A 1-D mesh of positions over this process's ``devices``, joined
    with the other processes of ``group`` when one is given."""

    def __init__(self, devices, axis: str = "shards", group=None):
        devices = tuple(torch.device(d) for d in devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices = devices
        self.axis = axis
        self.group = group
        self.world = 1 if group is None else dist.get_world_size(group)
        self.rank = 0 if group is None else dist.get_rank(group)
        self.size = len(devices) * self.world
        self.shape = {axis: self.size}
        self.collectives = 0

    @property
    def first(self) -> int:
        """The global position of this process's first position."""
        return self.rank * len(self.devices)

    def positions(self, lanes: int):
        """(device, first global lane) of each of this process's positions,
        at ``lanes`` lanes a position."""
        return [(dev, (self.first + j) * lanes)
                for j, dev in enumerate(self.devices)]

    # ------------------------------------------------------- collectives
    def _backend(self) -> str | None:
        return None if self.group is None else dist.get_backend(self.group)

    def _gather_tensor(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """``t`` (this process's share) joined along ``dim`` with every
        other process's, in rank order."""
        if self.group is None:
            return t
        wire = _wire(t.contiguous())
        if self._backend() == "gloo":
            wire = wire.cpu()
        outs = [torch.empty_like(wire) for _ in range(self.world)]
        dist.all_gather(outs, wire, group=self.group)
        return _unwire(torch.cat(outs, dim=dim), t.dtype).to(t.device)

    def all_gather(self, parts, dim: int = 0):
        """The whole of a state along its lane axis ``dim``, on
        ``devices[0]``: ``parts`` is this process's share in position order
        (a list of dataclasses of tensors, tensors or tuples of tensors,
        one a position or one for all), joined locally, then across the
        group's processes in rank order. Nothing (None) gathers to None."""
        parts = list(parts)
        if parts[0] is None:
            return None
        self.collectives += 1
        home = self.devices[0]

        def join(*xs):
            x = torch.cat([t.to(home) for t in xs], dim=dim) \
                if len(xs) > 1 else xs[0].to(home)
            return self._gather_tensor(x, dim)

        return _map(join, parts)

    def all_reduce(self, parts) -> torch.Tensor:
        """The sum over every position of ``parts`` (this process's tensors,
        one a position or one for all), on ``devices[0]``."""
        self.collectives += 1
        home = self.devices[0]
        total = parts[0].to(home).clone()
        for t in parts[1:]:
            total += t.to(home)
        if self.group is not None:
            wire = total.cpu() if self._backend() == "gloo" else total
            dist.all_reduce(wire, group=self.group)
            total = wire.to(home)
        return total

    def replicate(self, gathered, fold) -> dict:
        """``fold(gathered)`` once on each distinct device of this
        process's positions, ``devices[0]`` first: {device: result}. Every
        position then reads the same merge from its own device (the
        reference's broadcast of the merged state)."""
        out = {}
        for dev in self.devices:
            if dev not in out:
                out[dev] = fold(gathered if not out
                                else to_device(gathered, dev))
        return out


def to_device(state, device):
    """``state`` (a dataclass of tensors, a tensor, a tuple or None) with
    its tensors on ``device``."""
    return _map(lambda t: t.to(device), [state])


def _map(fn, parts: list):
    """fn over the tensors of ``parts`` field by field (dataclasses), item
    by item (tuples) or whole (tensors)."""
    p0 = parts[0]
    if p0 is None:
        return None
    if isinstance(p0, torch.Tensor):
        return fn(*parts)
    if isinstance(p0, tuple):
        return tuple(_map(fn, [p[i] for p in parts]) for i in range(len(p0)))
    return dataclasses.replace(p0, **{
        f.name: fn(*[getattr(p, f.name) for p in parts])
        for f in dataclasses.fields(p0)
        if isinstance(getattr(p0, f.name), torch.Tensor)})


def _wire(t: torch.Tensor) -> torch.Tensor:
    """A tensor of a type every backend carries (bool as uint8, uint32 as
    int32), the same bytes."""
    if t.dtype == torch.bool:
        return t.view(torch.uint8)
    if t.dtype == torch.uint32:
        return t.view(torch.int32)
    return t


def _unwire(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t.view(dtype) if t.dtype != dtype else t


def default_positions(device=None) -> int:
    """How many positions ``default_mesh`` gives for ``device``: the
    process group's size when one is initialized, else the visible cards
    (the card) or 1 (the CPU)."""
    dev = resolve_device(device)
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def mesh_spreads(shards: int, max_devices: int | None = None,
                 device=None) -> list:
    """The position counts a ``default_mesh`` of ``device`` can spread S
    lanes over, widest first: the divisors of S in [2, max_devices], where
    None means every position ``default_positions`` gives (as the JAX
    package's planner takes ``len(jax.devices())``). Under an initialized
    process group ``default_mesh`` holds one position a process, so the one
    spread it can build is the group's size."""
    ndev = default_positions(device)
    limit = ndev if max_devices is None else max_devices
    if dist.is_available() and dist.is_initialized():
        return [ndev] if 2 <= ndev <= limit and shards % ndev == 0 else []
    return [d for d in range(min(shards, limit), 1, -1) if shards % d == 0]


def default_mesh(axis: str = "shards", num_devices: int | None = None,
                 device=None) -> Mesh:
    """A 1-D mesh over the first ``num_devices`` positions (default: all),
    the counterpart of the JAX package's ``default_mesh``.

    On the card the positions are the visible cards (``device=None`` means
    the card, and raises without one). On the CPU the position ``"cpu"``
    repeats ``num_devices`` times (default 1), the counterpart of the
    reference's forced host device count. When a default process group is
    initialized, the mesh joins it with one position a process on this
    process's current card (or the CPU), and ``num_devices``, when given,
    must be the group's size."""
    dev = resolve_device(device)
    here = (torch.device("cuda", torch.cuda.current_device())
            if dev.type == "cuda" else torch.device("cpu"))
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if num_devices is not None and num_devices != world:
            raise ValueError(
                f"num_devices={num_devices}: a mesh over the process group "
                f"has one position a process ({world})")
        return Mesh((here,), axis, group=dist.group.WORLD)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        n = count if num_devices is None else num_devices
        if not 1 <= n <= count:
            raise ValueError(f"num_devices={num_devices}: {count} cards "
                             "are visible")
        return Mesh(tuple(torch.device("cuda", i) for i in range(n)), axis)
    n = 1 if num_devices is None else num_devices
    if n < 1:
        raise ValueError(f"num_devices must be >= 1, got {num_devices}")
    return Mesh((here,) * n, axis)
