"""Deterministic random-projection stub embedder.

A fixed random linear projection of downsampled pixels through tanh.  The
projection comes from a seeded ``torch.Generator`` — which draws other
numbers than the JAX package's ``jax.random`` from the same seed — or
from a ``[feat, dim]`` numpy matrix passed in as ``weights`` (the way to
share one projection with the JAX package).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from pixelbox_tpu_torch.models.base import Embedder
from pixelbox_tpu_torch.models.registry import register_embedder
from pixelbox_tpu_torch.utils.device import resolve_device


@register_embedder("stub")
class StubEmbedder(Embedder):
    POOL = 8  # average-pool 224→28 before projecting

    def __init__(
        self,
        dim: int = 128,
        input_size: int = 224,
        seed: int = 0,
        weights: Optional[np.ndarray] = None,
        device="cuda",
    ):
        self.dim = int(dim)
        self.input_size = int(input_size)
        self.device = resolve_device(device)
        pooled = self.input_size // self.POOL
        feat = pooled * pooled * 3
        if weights is None:
            g = torch.Generator().manual_seed(int(seed))
            w = torch.randn((feat, self.dim), generator=g, dtype=torch.float32)
            w = w / torch.tensor(math.sqrt(feat), dtype=torch.float32)
        else:
            w = torch.from_numpy(np.array(weights, dtype=np.float32))
            assert tuple(w.shape) == (feat, self.dim), (tuple(w.shape), feat, self.dim)
        self._w = w.to(self.device)

    @torch.no_grad()
    def embed_preprocessed(self, batch) -> torch.Tensor:
        x = torch.as_tensor(batch, dtype=torch.float32, device=self.device)
        b, s, _, _ = x.shape
        p = self.POOL
        pooled = x.reshape(b, s // p, p, s // p, p, 3).mean(dim=(2, 4))
        flat = pooled.reshape(b, -1) * 2.0 - 1.0  # center [0,1] → [-1,1]
        return torch.tanh(flat @ self._w * 4.0)
