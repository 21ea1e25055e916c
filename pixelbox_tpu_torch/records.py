"""IndexedImage record — the engine's result/ingest unit.

Mirrors the reference struct (src/indexed_image.rs:15-32): identity +
metadata + thumbnail + both hashes + query distance.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np


@dataclass
class IndexedImage:
    id: int = 0
    filename: str = ""
    path: str = ""
    resolution: Tuple[int, int] = (0, 0)
    thumbnail: Optional[bytes] = None  # QOI-compressed RGB
    tags: Dict[str, str] = field(default_factory=dict)
    phash: Optional[np.ndarray] = None        # uint8 bytes
    visual_hash: Optional[np.ndarray] = None  # uint8 embedding
    blip_hash: Optional[np.ndarray] = None    # uint8 BLIP ITC latent (text search)
    #: face search (Engine(faces=True)): [(normalized (x0,y0,x1,y1), u8 hash)]
    faces: Optional[list] = None
    distance_from_query: Optional[float] = None

    def get_thumbnail(self) -> Tuple[np.ndarray, Tuple[int, int]]:
        """Decode the QOI thumbnail → (HxWx3 u8, (width, height)).

        Reference: src/indexed_image.rs:93-96.
        """
        from pixelbox_tpu_torch.ingest.thumbnail import qoi_decode

        assert self.thumbnail is not None
        return qoi_decode(self.thumbnail)
