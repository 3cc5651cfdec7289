"""The device mesh: the port's scale-out substrate.

Counterpart of ``sculptmate_tpu/parallel/mesh.py``, with the same axes:

- ``dp``: data parallelism over assets (each dp row runs its own replica);
- ``sp``: x-slabs of the density lattice and the marching cubes of a
  high-resolution extraction (``parallel/farm.py:sharded_extract``);
- ``tp``: attention heads and feed-forward hidden units of the backbone
  (``ops/sharding.py``).

Design: one controller, not a process group. The JAX mesh is one process
driving a ``Mesh`` of devices whose collectives GSPMD inserts. The port
keeps that shape: one Python process, a mesh that is an array of
``torch.device`` with axis names, and the transfers
(``.to(device, non_blocking=True)``) and reductions written out where the
modules need them. A ``torch.distributed`` process group does not fit:
NCCL puts one rank on one card, so on a machine with one card a process
group could only run at world size 1, which splits nothing. A
single-controller mesh may name one device more than once: every split,
halo and reduction then runs on that one card (or, with
``devices=["cpu"] * 8``, on the CPU as the tests run it), and on a machine
with several cards the same code places the shards on ``cuda:0..n-1``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sculptmate_tpu_torch.runtime.device import canonical


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """An ndarray of ``torch.device`` (one axis per name) and its axis
    names; ``shape[axis]`` is the size of an axis, as on a JAX mesh."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def groups(self, axis: str, inner: Optional[str] = None) -> List[Tuple[torch.device, ...]]:
        """One tuple of devices per index along ``axis``: the devices along
        ``inner`` (or the first device alone when ``inner`` is None), at
        index 0 of every other axis."""
        names = list(self.axis_names)
        if axis not in names or (inner is not None and inner not in names) or axis == inner:
            raise ValueError(f"mesh axes {self.axis_names} have no {axis!r}" + (f" and {inner!r}" if inner else ""))
        lead = [names.index(axis)] + ([names.index(inner)] if inner else [])
        arr = np.moveaxis(self.devices, lead, list(range(len(lead))))
        arr = arr.reshape(arr.shape[: len(lead)] + (-1,))[..., 0]  # index 0 of the other axes
        return [tuple(row) for row in arr] if inner else [(d,) for d in arr]


def make_mesh(shape: Optional[Tuple[int, ...]] = None, axis_names: Sequence[str] = ("dp",), devices=None) -> DeviceMesh:
    """A mesh of ``shape`` over ``devices`` (default: every visible CUDA
    device; without one it raises, it never falls back to the CPU). A
    device may be named more than once (``["cpu"] * 8``, or one card four
    times). ``shape`` defaults to all devices on the first axis."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass devices=['cpu', ...] to build a CPU mesh")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(shape)) != n or len(shape) != len(axis_names):
        raise ValueError(f"mesh {tuple(shape)} over axes {tuple(axis_names)} != {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return DeviceMesh(arr.reshape(shape), tuple(axis_names))


def factor2(n: int) -> Tuple[int, int]:
    """Split n into the most-square (a, b) factoring, a * b == n."""
    a = int(np.sqrt(n))
    while n % a:
        a -= 1
    return a, n // a


def replicate(devices: Sequence[torch.device], system) -> Dict[torch.device, object]:
    """One copy of ``system`` (a ``TSR`` or an ``SF3D``) per distinct device
    of ``devices``, keyed by the device with its index and shared where
    devices repeat: the system itself on its own device, elsewhere its
    ``replica(device)``."""
    own, out = canonical(system.device), {}
    for d in map(canonical, devices):
        if d not in out:
            out[d] = system if d == own else system.replica(d)
    return out


def shard_batch(mesh: DeviceMesh, x: torch.Tensor, axis: str = "dp") -> List[torch.Tensor]:
    """``torch.tensor_split`` of ``x`` along its first dimension into one
    part per index of ``axis``, each on that shard's (first) device."""
    groups = mesh.groups(axis)
    return [p.to(g[0], non_blocking=True) for p, g in zip(torch.tensor_split(x, len(groups)), groups)]


def gather(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The parts joined along their first dimension in shard order, on
    ``device`` (a copy to the host waits for its part)."""
    device = torch.device(device)
    return torch.cat([p.to(device, non_blocking=device.type == "cuda") for p in parts])
