"""Row-sharded scans: per-shard top-k and a (dist, id) merge — the
counterpart of ``pixelbox_tpu/parallel/sharded_scan.py``.

An index's rows shard over the mesh's ``data`` axis: shard s holds a
copy of rows [s·L, (s+1)·L) on the mesh's s-th device.  The shards are
cut from a full index on one device (the store's), so a mesh spreads the
scan but does not hold a library larger than that device's memory.  Every
shard scans its own rows with the single-device port's kernels, keeps its
local top-k, and offsets its row ids to global ids; the k·n candidates —
kilobytes, not the index — are copied to the mesh's first device and
merged by (dist, global id) with K1c (``fused_scan.lex_topk``), which
keeps the single-device tie-break, so sharded and unsharded scans return
the same results.

One process drives every device (the JAX ``shard_map`` is one program
over the mesh too).  Every shard's kernels are enqueued before the first
host read — the auto path's proof check in ``repair_unproven`` — so the
cards of a mesh work at once.

Per shard, each scan takes the mapping the single-device port takes for
the same mode: the plain blocked scans for ``mode="exact"``; the fused
exact kernels (K1b/K4b/K2b + K1c) for ``mode="pallas"`` (and ``"fast"``,
which rested on the TPU-only ``approx_min_k``), for the auto paths'
small-shard gate and for their repair; the fused threshold scan
(K1a/K4a + K1c, row 8 of the kernel table) for the auto paths.  The
Hamming scan runs K2b + K1c on a card and their plain versions on a CPU
shard.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from pixelbox_tpu_torch.ops import fused_scan as fs
from pixelbox_tpu_torch.ops import topk as topk_ops
from pixelbox_tpu_torch.ops.int4 import (
    cosine4_scan_topk,
    cosine4a_scan_topk,
    semantic4_rows_from_u8,
)
from pixelbox_tpu_torch.ops.packed import PackedHammingIndex, semantic_rows_from_u8
from pixelbox_tpu_torch.ops.scan import ScanSample, cosine_scan_topk, repair_unproven

#: Rows the θ sample of a shard aims at (the JAX package's constant).
SAMPLE_ROWS = 65536
#: Per-shard modes of the exact sharded scans.
MODES = ("exact", "fast", "pallas")


class ShardedIndex:
    """A row-sharded mirror of a packed index (``PackedSemanticIndex``,
    ``PackedSemantic4Index`` or ``PackedHammingIndex``): ``shards[s]`` is
    a contiguous copy of rows [s·L, (s+1)·L) on ``devices[s]`` — a copy
    even where a device repeats, so the same code runs on one card or
    many.  Each shard's kernel row meta and θ sample are derived on first
    use and kept with the mirror; an append refreshes the meta of the rows
    it writes and drops the samples of the shards it touches."""

    def __init__(self, shards: List, mesh, axis: str = "data"):
        self.shards = list(shards)
        self.mesh = mesh
        self.axis = axis
        self.local_rows = self.shards[0].capacity
        self._metas: List[Optional[torch.Tensor]] = [None] * len(self.shards)
        self._samples: List[Optional[ScanSample]] = [None] * len(self.shards)

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def capacity(self) -> int:
        return self.local_rows * self.n_shards

    @property
    def dim(self) -> int:
        return self.shards[0].dim

    @property
    def devices(self) -> list:
        return [s.device for s in self.shards]

    @property
    def hamming(self) -> bool:
        return isinstance(self.shards[0], PackedHammingIndex)

    def meta(self, s: int) -> torch.Tensor:
        """Shard s's kernel meta: ``build_row_meta`` ([4, L] int32) for the
        cosine layouts, ``build_hamming_meta`` (uint8 [L]) for Hamming."""
        if self._metas[s] is None:
            build = fs.build_hamming_meta if self.hamming else fs.build_row_meta
            self._metas[s] = build(self.shards[s])
        return self._metas[s]

    def sample(self, s: int) -> ScanSample:
        """Shard s's θ sample: every stride-th local row, the stride the
        JAX rule gives (the largest power of two up to L // 65536 that
        divides L)."""
        if self._samples[s] is None:
            stride = 1
            while (
                stride * 2 <= max(1, self.local_rows // SAMPLE_ROWS)
                and self.local_rows % (stride * 2) == 0
            ):
                stride *= 2
            self._samples[s] = ScanSample(
                self.shards[s].data[::stride].contiguous(),
                self.meta(s)[..., ::stride].contiguous(),
            )
        return self._samples[s]

    def with_valid_mask(self, mask) -> "ShardedIndex":
        """A view whose validity is ANDed with ``mask`` (numpy bool
        [capacity]): the mask shards with the rows (the JAX masked-validity
        scans).  Data is shared; meta and samples are derived anew."""
        m = torch.from_numpy(np.asarray(mask, dtype=bool))
        shards = []
        for s, shard in enumerate(self.shards):
            lo = s * self.local_rows
            part = m[lo : lo + self.local_rows].to(shard.device)
            shards.append(shard._replace(valid=shard.valid & part))
        return ShardedIndex(shards, self.mesh, self.axis)

    def _write(self, start: int, fields: dict) -> None:
        """In-place write of rows [start, start + m) of every field in
        ``fields`` (name → numpy [m, ...]) into the shards that own them."""
        m = len(next(iter(fields.values())))
        end = start + m
        if start < 0 or end > self.capacity:
            raise ValueError(f"rows [{start}, {end}) outside the mirror's {self.capacity} rows")
        first, last = start // self.local_rows, (end - 1) // self.local_rows
        for s in range(first, last + 1):
            lo = max(start, s * self.local_rows)
            hi = min(end, (s + 1) * self.local_rows)
            a, b = lo - s * self.local_rows, hi - s * self.local_rows
            shard = self.shards[s]
            for name, rows in fields.items():
                src = torch.from_numpy(np.ascontiguousarray(rows[lo - start : hi - start]))
                getattr(shard, name)[a:b] = src.to(shard.device)
            if self._metas[s] is not None:
                piece = type(shard)(*(x[a:b] for x in shard))
                build = fs.build_hamming_meta if self.hamming else fs.build_row_meta
                self._metas[s][..., a:b] = build(piece)
            self._samples[s] = None


class ShardedMirror:
    """A store's row-sharded mirror (an engine keeps one per modality),
    synced lazily: :meth:`get` returns it for the store's current (kind,
    version).  An append within capacity writes only the new rows — with
    their current validity, so a row removed since stays out — into the
    shards that own them; a structural change (a delete, compaction,
    capacity or width growth) reshards in full and counts in
    ``full_reshards``."""

    def __init__(self):
        self.index: Optional[ShardedIndex] = None
        self.full_reshards = 0
        self._at = self._struct = None
        self._synced_n = 0

    def get(self, store, mesh) -> ShardedIndex:
        key = (store.kind, store.version)
        if self.index is not None and self._at == key:
            return self.index
        start, end = self._synced_n, store.n
        if (
            self.index is not None
            and self._struct == (store.kind, store.structural_version)
            and end > start
        ):
            rows, valid = store._host_rows[start:end], store._host_valid[start:end]
            if store.kind == "hamming":
                append_to_sharded_hamming_index(self.index, rows, valid, start)
            else:
                append_to_sharded_index(self.index, rows, valid, start, kind=store.kind)
        else:
            self.index = _shard(store.device_index, mesh, mesh.axis_names[0])
            self.full_reshards += 1
            self._struct = (store.kind, store.structural_version)
        self._at, self._synced_n = key, end
        return self.index


def _shard(index, mesh, axis: str) -> ShardedIndex:
    n = index.capacity
    devices = mesh.axis_devices(axis)
    if n % len(devices):
        raise ValueError(f"capacity {n} does not divide over {len(devices)} shards")
    rows = n // len(devices)
    shards = [
        type(index)(*(x[s * rows : (s + 1) * rows].to(dev, copy=True) for x in index))
        for s, dev in enumerate(devices)
    ]
    return ShardedIndex(shards, mesh, axis)


def shard_semantic_index(index, mesh, axis: str = "data") -> ShardedIndex:
    """Lay a packed semantic index (u8 or int4 layout) out row-sharded over
    the mesh: one contiguous copy of L = capacity / n rows per shard.
    Capacity must divide by the axis size (stores grow in block multiples)."""
    return _shard(index, mesh, axis)


def shard_hamming_index(index: PackedHammingIndex, mesh, axis: str = "data") -> ShardedIndex:
    """:func:`shard_semantic_index` for the packed phash index."""
    return _shard(index, mesh, axis)


def _check_mesh(index: ShardedIndex, mesh) -> None:
    if mesh is not None and mesh.shape[index.axis] != index.n_shards:
        raise ValueError(
            f"index has {index.n_shards} shards, the mesh's {index.axis!r} axis "
            f"{mesh.shape[index.axis]}"
        )


def _per_shard(index: ShardedIndex, q: torch.Tensor, scan):
    """Run ``scan(s, shard, q_on_its_device)`` on every shard and offset its
    row ids to global ids (-1 stays -1).  Returns the per-shard outputs,
    ids offset; nothing here reads back to the host."""
    q_on = {}
    outs = []
    for s, shard in enumerate(index.shards):
        dev = shard.device
        if dev not in q_on:
            q_on[dev] = q.to(dev)
        d, i, *rest = scan(s, shard, q_on[dev])
        off = s * index.local_rows
        i = torch.where(i >= 0, i + off, torch.full_like(i, -1))
        outs.append((d, i, *rest))
    return outs


def _merge_gathered(parts, k: int, device):
    """Per-shard [Q, k] (dist, global id) → the [Q, k] top k by (dist,
    id) on ``device``: the shards' candidates side by side, K1c over them
    (ids break ties; empty slots (+inf, -1) sort last)."""
    flat_d = torch.cat([d.to(device) for d, _ in parts], dim=1).contiguous()
    flat_i = torch.cat([i.to(device) for _, i in parts], dim=1).contiguous()
    return fs.lex_topk(flat_d, flat_i, k)


def _finish(index, parts, k, squeeze):
    d, i = _merge_gathered([(p[0], p[1]) for p in parts], k, index.devices[0])
    d, i = topk_ops.finalize_topk(d, i)
    return (d[0], i[0]) if squeeze else (d, i)


def _queries(query_u8, index: ShardedIndex):
    return fs._as_queries(query_u8, index.devices[0])


def _block_rows(index: ShardedIndex, block_rows: Optional[int]) -> int:
    return min(32768, index.local_rows) if block_rows is None else int(block_rows)


def sharded_cosine_scan_topk(
    query_u8,
    index: ShardedIndex,
    mesh=None,
    k: int = 100,
    max_distance: float = 1e3,
    block_rows: Optional[int] = None,
    mode: str = "exact",
):
    """Exact top-k over a row-sharded u8 index (:func:`shard_semantic_index`):
    per shard the plain blocked scan (``mode="exact"``) or the fused exact
    kernels K1b + K1c (``"pallas"``, ``"fast"``), then the merge.  Results
    on the mesh's first device, identical to the single-device scan."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    _check_mesh(index, mesh)
    q, squeeze = _queries(query_u8, index)
    br = _block_rows(index, block_rows)

    def scan(s, shard, qs):
        if mode == "exact":
            return cosine_scan_topk(qs, shard, k=k, max_distance=max_distance, block_rows=br)
        return fs.fused_cosine_scan_topk(qs, shard, index.meta(s), k=k, max_distance=max_distance)

    return _finish(index, _per_shard(index, q, scan), k, squeeze)


def sharded_threshold_pass(q, index: ShardedIndex, k, max_distance, make_queries):
    """Row 8 of the kernel table: per shard the fused threshold scan over
    its rows and its θ sample (K1a/K4a + K1c), ids offset, the k·n
    candidates merged on the first device.
    ``make_queries`` prepares the queries on a shard's device
    (``CosineQueries.from_u8`` or ``Int4Queries.from_u8``).  Returns
    (dist [Q, k], idx [Q, k], proven [Q]): the merged result is exact
    where every shard proved its local top-k."""
    def scan(s, shard, qs):
        return fs._threshold_scan(
            make_queries(qs), shard.data, index.meta(s), index.sample(s), k,
            max_distance, None, None, "dist",
        )

    parts = _per_shard(index, q, scan)
    dev0 = index.devices[0]
    best_d, best_i = _merge_gathered([(p[0], p[1]) for p in parts], k, dev0)
    proven = torch.stack([p[2].to(dev0) for p in parts]).all(dim=0)
    return best_d, best_i, proven


def _sharded_auto(q, squeeze, index, k, max_distance, block_rows, make_queries, exact):
    """The shared auto path: the threshold pass, then one repair of the
    unproven queries through ``exact``; shards of at most 4·block_rows
    rows take ``exact`` directly (selection is cheap there)."""
    if index.local_rows <= 4 * _block_rows(index, block_rows):
        best_d, best_i = exact(q)
    else:
        best_d, best_i, proven = sharded_threshold_pass(q, index, k, max_distance, make_queries)
        best_d, best_i = repair_unproven(q, best_d, best_i, proven, exact)
    best_d, best_i = topk_ops.finalize_topk(best_d, best_i)
    return (best_d[0], best_i[0]) if squeeze else (best_d, best_i)


def sharded_cosine_scan_topk_auto(
    query_u8,
    index: ShardedIndex,
    mesh=None,
    k: int = 100,
    max_distance: float = 1e3,
    block_rows: Optional[int] = None,
):
    """Guaranteed-exact sharded u8 scan, results identical to
    ``mode="exact"``: every shard runs the threshold scan on its resident
    rows (its own θ sample, K1a + K1c) and proves its local top-k; the merged result is
    exact iff every shard proved; the unproven queries are re-scanned by
    the sharded fused exact scan (K1b + K1c) in 8·4ⁿ buckets.  Shards of
    at most 4·block_rows rows take that exact scan directly."""
    _check_mesh(index, mesh)
    q, squeeze = _queries(query_u8, index)

    def exact(rq):
        return sharded_cosine_scan_topk(
            rq, index, k=k, max_distance=max_distance, block_rows=block_rows, mode="pallas"
        )

    return _sharded_auto(
        q, squeeze, index, k, max_distance, block_rows, fs.CosineQueries.from_u8, exact
    )


def sharded_cosine4_scan_topk(
    query_u8,
    index: ShardedIndex,
    mesh=None,
    k: int = 100,
    max_distance: float = 1e3,
    block_rows: Optional[int] = None,
    query_mode: str = "asym",
    mode: str = "exact",
):
    """Exact top-k over a row-sharded int4 index: per shard the plain
    blocked ``cosine4a_scan_topk`` / ``cosine4_scan_topk``
    (``mode="exact"``) or the fused K4b + K1c (``"pallas"``), then the
    merge; ``query_mode="asym"`` keeps the queries at u8 precision."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if query_mode not in ("asym", "sym"):
        raise ValueError(f"int4 query_mode must be 'asym' or 'sym', got {query_mode!r}")
    _check_mesh(index, mesh)
    q, squeeze = _queries(query_u8, index)
    br = _block_rows(index, block_rows)
    plain = cosine4a_scan_topk if query_mode == "asym" else cosine4_scan_topk

    def scan(s, shard, qs):
        if mode == "exact":
            return plain(qs, shard, k=k, max_distance=max_distance, block_rows=br)
        return fs.fused_cosine4_scan_topk(
            qs, shard, index.meta(s), k=k, max_distance=max_distance, query_mode=query_mode
        )

    return _finish(index, _per_shard(index, q, scan), k, squeeze)


def sharded_cosine4_scan_topk_auto(
    query_u8,
    index: ShardedIndex,
    mesh=None,
    k: int = 100,
    max_distance: float = 1e3,
    block_rows: Optional[int] = None,
    query_mode: str = "asym",
):
    """Guaranteed-exact sharded int4 scan: :func:`sharded_cosine_scan_topk_auto`
    over the packed 4-bit shards (K4a + K1c per shard, repair K4b + K1c)."""
    _check_mesh(index, mesh)
    q, squeeze = _queries(query_u8, index)
    if q.shape[1] != index.dim:
        raise ValueError(f"query width {q.shape[1]} != index dim {index.dim}")

    def exact(rq):
        return sharded_cosine4_scan_topk(
            rq, index, k=k, max_distance=max_distance, block_rows=block_rows,
            query_mode=query_mode, mode="pallas",
        )

    def make_queries(qs):
        return fs.Int4Queries.from_u8(qs, query_mode)

    return _sharded_auto(
        q, squeeze, index, k, max_distance, block_rows, make_queries, exact
    )


def sharded_hamming_scan_topk(
    query_u8,
    index: ShardedIndex,
    mesh=None,
    k: int = 100,
    max_distance: float = 1e3,
    wrap_u8: bool = False,
    byte_limit: Optional[int] = None,
    valid_mask=None,
):
    """Exact sharded Hamming scan: per shard K2b + K1c (their plain
    versions on a CPU shard), then the merge.  ``byte_limit`` and
    ``valid_mask`` (bool [capacity]) carry the zip-truncate width groups
    (engine.rs:594-604) onto the mesh: the mask shards with the rows and
    folds into each shard's row mask."""
    _check_mesh(index, mesh)
    q, squeeze = _queries(query_u8, index)
    mask = None if valid_mask is None else np.asarray(valid_mask, dtype=bool)

    def scan(s, shard, qs):
        if mask is None:
            meta = index.meta(s)
        else:
            lo = s * index.local_rows
            meta = fs.build_hamming_meta(shard, mask[lo : lo + index.local_rows])
        return fs.fused_hamming_scan_topk(
            qs, shard, meta, k=k, max_distance=max_distance, wrap_u8=wrap_u8,
            byte_limit=byte_limit,
        )

    return _finish(index, _per_shard(index, q, scan), k, squeeze)


def append_to_sharded_index(
    sharded: ShardedIndex, rows_u8: np.ndarray, valid: np.ndarray, start: int,
    kind: str = "semantic",
) -> ShardedIndex:
    """Write freshly appended rows [start, start + m) into the shards that
    own them, in place (continuous ingest under ``serve_on_mesh`` moves
    only the delta rows).  ``valid`` carries the rows' CURRENT validity,
    so a row tombstoned since it was appended stays out.  ``kind`` is the
    store's ("semantic" or "semantic4").  Capacity growth, deletes and
    compaction are the caller's full reshard."""
    pack = semantic4_rows_from_u8 if kind == "semantic4" else semantic_rows_from_u8
    data, row_sum, row_mag2 = pack(np.ascontiguousarray(rows_u8, dtype=np.uint8))
    sharded._write(start, {
        "data": data, "row_sum": row_sum, "row_mag2": row_mag2,
        "valid": np.asarray(valid, dtype=bool),
    })
    return sharded


def append_to_sharded_hamming_index(
    sharded: ShardedIndex, rows_u8: np.ndarray, valid: np.ndarray, start: int
) -> ShardedIndex:
    """The Hamming twin of :func:`append_to_sharded_index`: the packed
    phash rows and their current validity, written in place."""
    sharded._write(start, {
        "data": np.asarray(rows_u8, dtype=np.uint8),
        "valid": np.asarray(valid, dtype=bool),
    })
    return sharded

