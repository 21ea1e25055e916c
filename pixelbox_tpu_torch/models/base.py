"""Embedder interface.

Contract (mirroring the reference's ``mlhash`` contract,
src/image_hashes/efficientnet.rs:31-42, batched): images in → tanh-bounded
f32 latents out → quantized u8 via ``ops.quantize.quantize_embedding``.
"""

from __future__ import annotations

import abc
import copy

import numpy as np
import torch

from pixelbox_tpu_torch.ops.preprocess import preprocess_host
from pixelbox_tpu_torch.ops.quantize import quantize_embedding


class Embedder(abc.ABC):
    """Batched image embedder producing fixed-width f32 latents on
    ``self.device``."""

    #: latent width (the reference ships 8, src/image_hashes/efficientnet.rs:8)
    dim: int
    #: expected square input resolution (224 for the reference embedder)
    input_size: int = 224
    #: where the forward runs (set by each embedder's constructor)
    device: torch.device

    @abc.abstractmethod
    def embed_preprocessed(self, batch) -> torch.Tensor:
        """f32 [B, S, S, 3] (NHWC, numpy or tensor) in [0,1] → f32 [B, dim]
        on ``self.device``."""

    def replica(self, device) -> "Embedder":
        """A copy of this embedder whose forward runs on ``device``, with
        the same weights (its tensors and modules copied there) — one
        shard's model in a data-parallel embed (``parallel/data_parallel``)."""
        dev = torch.device(device)
        rep = copy.copy(self)
        rep.device = dev
        rep._replicas = {}
        for name, value in vars(self).items():
            if torch.is_tensor(value):
                setattr(rep, name, value.to(dev, copy=True))
            elif isinstance(value, torch.nn.Module):
                setattr(rep, name, copy.deepcopy(value).to(dev))
        return rep

    def embed_images(self, images) -> np.ndarray:
        """List of HxWx3 u8 arrays (any sizes) → f32 [B, dim]."""
        batch = np.stack([preprocess_host(im, self.input_size) for im in images])
        return self.embed_preprocessed(batch).cpu().numpy()

    def mlhash(self, image: np.ndarray) -> np.ndarray:
        """One image → quantized u8 hash (the reference's ``mlhash`` shape)."""
        return self.mlhash_batch([np.asarray(image)])[0]

    def mlhash_batch(self, images) -> np.ndarray:
        latents = torch.from_numpy(self.embed_images(images))
        return quantize_embedding(latents).numpy()
