"""Embedding models (``torch.nn``) + registry.

The reference runs a single-image ONNX EfficientNet forward per file on CPU
(src/image_hashes/efficientnet.rs:31-42).  Here embedders are batched
``nn.Module``s on an explicit device, discovered through
:func:`get_embedder`.
"""

from pixelbox_tpu_torch.models.base import Embedder
from pixelbox_tpu_torch.models.registry import get_embedder, register_embedder

__all__ = ["Embedder", "get_embedder", "register_embedder"]
