"""Mesh construction (the counterpart of ``pixelbox_tpu/parallel/mesh.py``).

JAX's ``Mesh`` lays devices out on named axes and ``shard_map`` runs one
program over them.  The port is single-controller the same way: one
process drives every device of the mesh, launching each shard's kernels
on its own device's stream.  Only the k candidates a shard keeps cross
between devices (peer copies), never the index.

A device may appear more than once: n shards on one card are n row
ranges of one index, each a copy of its rows on that card, so the
sharded code path runs whether the mesh spans cards or not.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from pixelbox_tpu_torch.utils.device import resolve_device


class Mesh:
    """Devices laid out on named axes: ``devices`` is a numpy object array
    of ``torch.device`` of shape ``shape``; ``shape[axis]`` is an axis's
    size by name, as on a JAX mesh."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"devices of rank {devices.ndim} for axes {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))

    def axis_devices(self, axis: str = "data") -> list:
        """The devices along ``axis`` (the first device of every other
        axis): shard s of a row-sharded index lives on the s-th."""
        a = self.axis_names.index(axis)
        idx = [0] * self.devices.ndim
        out = []
        for s in range(self.devices.shape[a]):
            idx[a] = s
            out.append(self.devices[tuple(idx)])
        return out


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = ("data",),
    shape: Optional[Tuple[int, ...]] = None,
    device=None,
) -> Mesh:
    """A mesh over ``n_devices`` devices.

    ``device=None`` (the default) takes the visible CUDA cards in order,
    all of them unless ``n_devices`` says fewer; more shards than cards
    repeat the cards round-robin (``make_mesh(4)`` on one card is four
    shards on ``cuda:0``).  ``device="cpu"`` (or any one device) puts every
    shard on that device: ``make_mesh(8, device="cpu")`` is the port's
    counterpart of the 8 virtual CPU devices the JAX tests run on.  A CUDA
    mesh without a visible card raises — it never drops to the CPU.

    The default layout is 1-D ``('data',)``: index rows shard over it for
    scans, batch rows for the ingest embed.  Pass ``axis_names`` and a
    ``shape`` for a 2-D layout."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA card is visible (pass device='cpu' for a CPU mesh)"
            )
        cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        n = len(cards) if n_devices is None else int(n_devices)
        devices = [cards[i % len(cards)] for i in range(n)]
    else:
        dev = resolve_device(device)
        n = 1 if n_devices is None else int(n_devices)
        devices = [dev] * n
    if n < 1:
        raise ValueError(f"a mesh needs at least one device, got {n}")
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(shape), axis_names)
