"""Per-modality serving mixins for :class:`pixelbox_tpu_torch.engine.Engine`,
and the micro-batching scan service behind the web server.

Ported so far: semantic (visual-similarity) search, the IVF clustered
index, perceptual-hash search, whole-index duplicate finding, watched
folders and the batching service; BLIP ``text:`` and faces wait
(ROADMAP.md).
"""

from pixelbox_tpu_torch.serving.duplicates import DuplicateFinding
from pixelbox_tpu_torch.serving.ivf import IvfServing
from pixelbox_tpu_torch.serving.phash import PhashServing
from pixelbox_tpu_torch.serving.semantic import SemanticServing
from pixelbox_tpu_torch.serving.service import BatchingScanService, ScanInputs
from pixelbox_tpu_torch.serving.watch import WatchMixin

__all__ = [
    "BatchingScanService",
    "DuplicateFinding",
    "IvfServing",
    "PhashServing",
    "ScanInputs",
    "SemanticServing",
    "WatchMixin",
]
