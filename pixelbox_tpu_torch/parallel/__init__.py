"""Multi-device execution: meshes, sharded scans, data-parallel embedding
(the counterpart of ``pixelbox_tpu/parallel``).

- **scan**: index rows sharded over the mesh's devices; per-shard top-k on
  each device; the k·n candidates merged by (dist, id) on the first
  device (``sharded_scan``);
- **ingest**: the embed batch split over the mesh (``data_parallel``).

One process drives every device of the mesh; a mesh may repeat a device
(n shards on one card).  Multi-process meshes (``torch.distributed``) are
not ported yet.
"""

from pixelbox_tpu_torch.parallel.mesh import make_mesh
from pixelbox_tpu_torch.parallel.sharded_scan import (
    shard_semantic_index,
    sharded_cosine_scan_topk,
)

__all__ = ["make_mesh", "shard_semantic_index", "sharded_cosine_scan_topk"]
