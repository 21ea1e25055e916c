"""Per-modality serving mixins for :class:`pixelbox_tpu_torch.engine.Engine`.

Only the semantic (visual-similarity) modality is ported so far; phash,
BLIP ``text:``, faces, IVF, duplicates and watch wait (ROADMAP.md).
"""

from pixelbox_tpu_torch.serving.semantic import SemanticServing

__all__ = ["SemanticServing"]
