"""Mesh-sharded IVF: clustered ANN over the port's single-controller mesh
(the counterpart of ``pixelbox_tpu/parallel/sharded_ivf.py``).

- the centroids are trained ONCE on the full corpus and every shard
  holds a copy;
- rows shard by contiguous store ranges (the flat sharded scan's layout,
  ``parallel/sharded_scan``); each shard packs ITS rows into its own
  buckets under the shared centroids, with GLOBAL row ids, on its mesh
  device;
- a query probes the same ``nprobe`` clusters on every shard (the probe
  order depends only on the centroids), scans its local buckets (K5 +
  K1c) and its local exact spill (``ops.ivf.ivf_local_topk``), and the
  k·n candidates — not the index — are copied to the mesh's first device
  and merged by K1c on (dist, global row id) (``sharded_scan.
  _merge_gathered``).

Every shard probes the same clusters, so the union of probed rows is the
one-device probe set for the same centroids (plus rows that spill under
the per-shard caps, which are scanned exactly).  With ``nprobe ==
n_clusters`` the result equals the flat exact scan, ties included.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from pixelbox_tpu_torch.ops import ivf as ivf_ops
from pixelbox_tpu_torch.ops import topk as topk_ops
from pixelbox_tpu_torch.ops.fused_scan import _as_queries
from pixelbox_tpu_torch.parallel.sharded_scan import _merge_gathered


class ShardedIVFIndex(NamedTuple):
    """Per-shard IVF indexes (``ops.ivf.IVFIndex``, one on each device of
    the mesh's ``data`` axis, all with the shared centroids and a common
    bucket cap), with global row ids in ``bucket_rows`` / ``spill_rows``."""

    shards: Tuple[ivf_ops.IVFIndex, ...]

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def n_clusters(self) -> int:
        return self.shards[0].n_clusters

    @property
    def bucket_cap(self) -> int:
        return self.shards[0].bucket_cap

    @property
    def dim(self) -> int:
        return self.shards[0].dim

    @property
    def kind(self) -> str:
        return self.shards[0].kind

    @property
    def device(self) -> torch.device:
        return self.shards[0].device

    @property
    def devices(self) -> list:
        return [s.device for s in self.shards]


def build_sharded_ivf(
    rows_u8: np.ndarray,
    valid: np.ndarray,
    centroids: np.ndarray,
    mesh,
    axis: str = "data",
    bucket_cap: Optional[int] = None,
    precision: str = "u8",
) -> Tuple[ShardedIVFIndex, List[np.ndarray]]:
    """Pack each shard's row range into buckets under the shared centroids
    on its device.  Returns ``(index, spill_ids_per_shard)`` (ascending
    global ids; :func:`rebuild_sharded_spill` extends them on appends).
    ``len(rows_u8)`` must divide by the mesh axis size."""
    rows_u8 = np.asarray(rows_u8, dtype=np.uint8)
    valid = np.asarray(valid, dtype=bool)
    n, d = rows_u8.shape
    devices = mesh.axis_devices(axis)
    n_shards = len(devices)
    assert n % n_shards == 0, (n, n_shards)
    local_rows = n // n_shards
    c = centroids.shape[0]
    if bucket_cap is None:
        per_shard_live = max(
            int(valid[s * local_rows : (s + 1) * local_rows].sum()) for s in range(n_shards)
        )
        bucket_cap = ivf_ops.default_bucket_cap(per_shard_live, c)
    bucket_cap = int(max(8, bucket_cap))

    shards, spill_ids = [], []
    for s, dev in enumerate(devices):
        lo, hi = s * local_rows, (s + 1) * local_rows
        ids = np.arange(lo, hi, dtype=np.int32)
        bd, bs, bm, br, bv, spill_pos = ivf_ops.pack_buckets(
            rows_u8[lo:hi], valid[lo:hi], centroids, bucket_cap, row_ids=ids,
            precision=precision, device=dev,
        )
        gids = spill_pos.astype(np.int64) + lo
        spill = ivf_ops._pack_spill(
            rows_u8[gids], gids.astype(np.int32), d, precision=precision, device=dev
        )
        shards.append(ivf_ops.IVFIndex(
            torch.from_numpy(np.array(centroids, dtype=np.float32)).to(dev),
            *ivf_ops._to_dev((bd, bs, bm, br, bv), dev),
            *spill,
        ))
        spill_ids.append(gids)
    return ShardedIVFIndex(tuple(shards)), spill_ids


def rebuild_sharded_spill(sivf: ShardedIVFIndex, rows_u8: np.ndarray,
                          ids_per_shard: List[np.ndarray]) -> ShardedIVFIndex:
    """A new index sharing ``sivf``'s buckets and centroids, each shard's
    spill rebuilt from its id list (ascending, global) on the shard's own
    device — the append path: O(spill + delta) host work and transfer, no
    bucket repack."""
    rows_u8 = np.asarray(rows_u8, dtype=np.uint8)
    return ShardedIVFIndex(tuple(
        ivf_ops.rebuild_spill(shard, rows_u8, ids) for shard, ids in zip(sivf.shards, ids_per_shard)
    ))


@torch.no_grad()
def sharded_ivf_scan_topk(query_u8, sivf: ShardedIVFIndex, mesh=None, k: int = 100,
                          nprobe: Optional[int] = None, max_distance: float = 1e3,
                          axis: str = "data"):
    """Distributed IVF top-k, on the mesh's first device.

    ``ops.ivf.ivf_scan_topk``'s contract: approximate selection over the
    probed clusters (every shard probes the same ``nprobe``; None = the
    recall-governed default), exact distances, ties by ascending global
    row id; with ``nprobe == n_clusters`` it equals the flat exact scan.
    Every shard's kernels are enqueued before the merge reads anything."""
    if mesh is not None and mesh.shape[axis] != sivf.n_shards:
        raise ValueError(f"index has {sivf.n_shards} shards, the mesh's {axis!r} axis "
                         f"{mesh.shape[axis]}")
    q, squeeze = _as_queries(query_u8, sivf.device)
    if nprobe is None:
        nprobe = ivf_ops.default_nprobe(sivf.n_clusters)
    nprobe = int(max(1, min(nprobe, sivf.n_clusters)))
    q_on = {}
    parts = []
    for shard in sivf.shards:
        if shard.device not in q_on:
            q_on[shard.device] = q.to(shard.device)
        parts.append(ivf_ops.ivf_local_topk(q_on[shard.device], shard, int(k), nprobe, max_distance))
    best_d, best_i = _merge_gathered(parts, int(k), sivf.device)
    best_d, best_i = topk_ops.finalize_topk(best_d, best_i)
    if squeeze:
        return best_d[0], best_i[0]
    return best_d, best_i
