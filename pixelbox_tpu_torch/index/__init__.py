"""Index storage: device-resident packed vector stores + host-side catalog."""

from pixelbox_tpu_torch.index.store import VectorStore
from pixelbox_tpu_torch.index.catalog import Catalog

__all__ = ["VectorStore", "Catalog"]
