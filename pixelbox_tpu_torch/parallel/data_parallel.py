"""Data-parallel ingest embedding: the batch split over the mesh — the
counterpart of ``pixelbox_tpu/parallel/data_parallel.py``.

The JAX package places the batch with ``NamedSharding(P('data'))`` and
lets XLA partition the forward.  The port does the same by hand: the
padded batch splits into one contiguous slice per shard, each slice runs
through a replica of the embedder on its shard's device (one replica per
distinct device, the weights copied once), and the latents come back to
the mesh's first device, trimmed to the true length.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

_REPLICAS_LOCK = threading.Lock()


def shard_batch(batch, mesh, axis: str = "data") -> list:
    """Split a batch (numpy or tensor, [n, ...]) over the mesh's ``axis``,
    zero-padding to a multiple of the axis size (the caller trims outputs
    to the true length): one equal slice per shard, on its device."""
    x = batch if torch.is_tensor(batch) else torch.from_numpy(np.ascontiguousarray(batch))
    n = x.shape[0]
    devices = mesh.axis_devices(axis)
    n_pad = -(-n // len(devices)) * len(devices)
    if n_pad != n:
        x = torch.cat([x, x.new_zeros((n_pad - n,) + tuple(x.shape[1:]))], dim=0)
    per = n_pad // len(devices)
    return [x[s * per : (s + 1) * per].to(dev) for s, dev in enumerate(devices)]


def _canonical(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _replica(embedder, device):
    """The embedder itself on its own device, else its copy there (made
    once, kept on the embedder)."""
    dev = _canonical(device)
    if dev == _canonical(embedder.device):
        return embedder
    with _REPLICAS_LOCK:
        replicas = embedder.__dict__.setdefault("_replicas", {})
        if dev not in replicas:
            replicas[dev] = embedder.replica(dev)
        return replicas[dev]


def embed_batch_sharded(embedder, batch, mesh, axis: str = "data") -> torch.Tensor:
    """Embed a batch data-parallel over the mesh → f32 [n, dim] on the
    mesh's first device.  Every slice is enqueued on its device before the
    latents are gathered, so the cards run at once."""
    n = batch.shape[0]
    parts = [_replica(embedder, x.device).embed_preprocessed(x) for x in shard_batch(batch, mesh, axis)]
    dev0 = parts[0].device
    return torch.cat([p.to(dev0) for p in parts], dim=0)[:n]
