"""Per-modality serving mixins for :class:`pixelbox_tpu_torch.engine.Engine`.

Ported so far: semantic (visual-similarity) search, perceptual-hash
search and whole-index duplicate finding; BLIP ``text:``, faces, IVF and
watch wait (ROADMAP.md).
"""

from pixelbox_tpu_torch.serving.duplicates import DuplicateFinding
from pixelbox_tpu_torch.serving.phash import PhashServing
from pixelbox_tpu_torch.serving.semantic import SemanticServing

__all__ = ["DuplicateFinding", "PhashServing", "SemanticServing"]
