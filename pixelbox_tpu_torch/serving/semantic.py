"""Semantic (visual-similarity) serving — the engine's hot query path
(torch port of ``serving/semantic.py``), on one device or row-sharded
over a mesh (``Engine.serve_on_mesh``).

Scan-mode dispatch on one device (reference engine.rs:352-396):

- ``auto`` (default) and ``fast``: ``ops.scan.cosine_scan_topk_auto`` —
  the fused threshold scan plus exact repair, results identical to
  ``exact``.  ``fast`` rested on the TPU-only ``approx_min_k``; it is
  served as ``auto``, as the JAX package already does for int4;
- ``exact``: the blocked exact scan (plain PyTorch);
- ``pallas``: the fused exact kernel scan (``fused_cosine_scan_topk``) —
  the flag keeps its name;
- ``ivf``: the clustered ANN (``serving/ivf.py``, ``ops/ivf.py``): the
  ``ivf_nprobe`` nearest clusters' buckets (K5 + K1c) and the exact spill,
  at the library's precision (int4 buckets: the exact-u8 rerank).

On a mesh (``parallel/sharded_scan``; ``ivf``: ``parallel/sharded_ivf``),
as the JAX package dispatches:
``auto`` → the sharded auto (per-shard K1a + K1c, merged, repaired);
the other modes → the sharded exact scan (per shard: the plain blocked
scan for ``exact``, K1b + K1c for ``pallas`` and ``fast``).  An int4
library: ``exact`` → the sharded plain int4 scan, the others → the
sharded int4 auto (K4a + K1c).  The mirror syncs lazily
(:meth:`SemanticServing._get_sharded_index`).

An int4 library (``semantic_precision="int4"``, the ``semantic4`` store)
scans in the asymmetric int4 metric: ``exact`` → the plain
``ops.int4.cosine4a_scan_topk``; ``auto``/``fast``/``pallas`` →
``ops.int4.cosine4_scan_topk_auto`` (kernels K4a/K4b + K1c).  With
``int4_rerank`` on (the default) the scan retrieves the top
``default_rerank_candidates(k)`` unbounded and ``scan_with_u8_rerank``
rescores them with the exact u8 metric from the store's host mirror.

Caches the row meta and the θ sample per store kind and version, as the
JAX package does per version.  Mixed into :class:`pixelbox_tpu_torch.engine.Engine`;
state lives on the engine.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from pixelbox_tpu_torch.ops.fused_scan import build_row_meta, fused_cosine_scan_topk
from pixelbox_tpu_torch.ops.int4 import (
    cosine4_scan_topk_auto,
    cosine4a_scan_topk,
    scan_with_u8_rerank,
)
from pixelbox_tpu_torch.ops.scan import (
    DEFAULT_BLOCK_ROWS,
    build_scan_sample,
    cosine_scan_topk,
    cosine_scan_topk_auto,
)
from pixelbox_tpu_torch.parallel.sharded_scan import (
    sharded_cosine4_scan_topk,
    sharded_cosine4_scan_topk_auto,
    sharded_cosine_scan_topk,
    sharded_cosine_scan_topk_auto,
)
from pixelbox_tpu_torch.records import IndexedImage
from pixelbox_tpu_torch.serving.common import _read_locked
from pixelbox_tpu_torch.serving.service import ScanInputs
from pixelbox_tpu_torch.utils.timing import timed

SCAN_MODES = ("auto", "exact", "fast", "pallas", "ivf")


class SemanticServing:
    def _sem_cache_key(self):
        """What the cached meta and sample are valid for: the store's kind
        (its row layout) and its mutation counter."""
        return (self._sem_store.kind, self._sem_store.version)

    def _get_row_meta(self) -> torch.Tensor:
        """Cached [4, N] row meta for the scan kernels."""
        if self._row_meta is None or self._row_meta_at_ver != self._sem_cache_key():
            self._row_meta = build_row_meta(self._sem_store.device_index)
            self._row_meta_at_ver = self._sem_cache_key()
        return self._row_meta

    def _get_scan_sample(self):
        """Cached θ-estimation subsample for the auto scan; None while the
        index is small enough that auto takes the fused exact scan."""
        index = self._sem_store.device_index
        if index.capacity <= 4 * DEFAULT_BLOCK_ROWS:
            return None
        if self._scan_sample is None or self._scan_sample_at_ver != self._sem_cache_key():
            self._scan_sample = build_scan_sample(index)
            self._scan_sample_at_ver = self._sem_cache_key()
        return self._scan_sample

    def _get_sharded_index(self):
        """The semantic store's row-sharded mirror over ``scan_mesh``,
        synced lazily on the store's (kind, version)
        (``parallel.sharded_scan.ShardedMirror``: appends as deltas,
        structural changes as full reshards).  It keeps each shard's row
        meta and θ sample."""
        return self._sem_mirror.get(self._sem_store, self.scan_mesh)

    @property
    def _sharded_full_reshards(self) -> int:
        """Full reshards of the semantic mirror (delta syncs do not count)."""
        return self._sem_mirror.full_reshards

    def semantic_scan_inputs(self) -> ScanInputs:
        """The semantic store's device index with its cached θ sample and
        row meta — the batching service's ``index_provider``.  The caches
        are keyed on the store's (kind, version), which every in-place
        append and tombstone bumps."""
        return ScanInputs(
            self._sem_store.device_index, self._get_scan_sample(), self._get_row_meta()
        )

    # ------------------------------------------------------------------ #
    # Visual similarity query (engine.rs:352-396)

    def query_by_image_hash_from_file(self, path: str) -> None:
        self._cached_search_results = None
        if self.embedder is None:
            self.last_query_error = (
                "similarity search disabled: no embedder model "
                "(embedder='none'); tag/filename search and similar-id on "
                "stored hashes remain available"
            )
            self._cached_search_results = []
            return
        t0 = time.perf_counter()
        with timed("engine.load_image"):
            record = self.load_image(path)
        print(f"Time to compute image hash: {time.perf_counter()-t0:.3f}s", file=sys.stderr)
        if record is None:
            self.last_query_error = f"cannot decode image: {path}"
            return
        self.query_by_image_hash_from_image(record)

    @_read_locked
    def query_by_image_hash_from_id(self, image_id: int) -> None:
        """Find-similar on an INDEXED image using its stored hash (no
        decode/forward; an exact self-match by construction)."""
        self._cached_search_results = None
        blob = self.catalog.get_hash("semantic_hashes", image_id)
        if blob is None:
            self.last_query_error = f"image {image_id} has no semantic hash"
            self._cached_search_results = []
            return
        info = self.catalog.get_image(image_id)
        record = IndexedImage(
            id=image_id,
            filename=info["filename"] if info else "",
            path=info["path"] if info else "",
            visual_hash=np.frombuffer(blob, dtype=np.uint8),
        )
        self.query_by_image_hash_from_image(record)

    def similarity_scan(self, visual_hash, k: int, max_distance: float):
        """One query hash → (dist [k] f32, idx [k] i32) tensors under the
        engine's scan mode, in the index's own metric (an int4 library:
        the asymmetric int4 metric, before any rerank)."""
        if self.scan_mode not in SCAN_MODES:
            raise ValueError(f"unknown scan mode {self.scan_mode!r} (modes: {', '.join(SCAN_MODES)})")
        if self.scan_mode == "ivf":
            return self._ivf_scan(np.asarray(visual_hash, dtype=np.uint8), k, max_distance)
        if self.scan_mesh is not None:
            return self._sharded_scan(visual_hash, k, max_distance)
        index = self._sem_store.device_index
        q = torch.from_numpy(np.array(visual_hash, dtype=np.uint8)).to(index.device)
        if self.semantic_precision == "int4":
            if self.scan_mode == "exact":
                return cosine4a_scan_topk(q, index, k=k, max_distance=max_distance)
            return cosine4_scan_topk_auto(
                q, index, k=k, max_distance=max_distance,
                sample=self._get_scan_sample(), meta=self._get_row_meta(),
            )
        if self.scan_mode == "exact":
            return cosine_scan_topk(q, index, k=k, max_distance=max_distance)
        if self.scan_mode == "pallas":
            return fused_cosine_scan_topk(
                q, index, self._get_row_meta(), k=k, max_distance=max_distance
            )
        return cosine_scan_topk_auto(
            q, index, k=k, max_distance=max_distance,
            sample=self._get_scan_sample(), row_meta=self._get_row_meta(),
        )

    def _sharded_scan(self, visual_hash, k: int, max_distance: float):
        """:meth:`similarity_scan` on the mesh (the JAX branches
        ``serving/semantic.py:219-240`` and ``:257-287``)."""
        q = torch.from_numpy(np.array(visual_hash, dtype=np.uint8))
        sharded = self._get_sharded_index()
        if self.semantic_precision == "int4":
            fn = (
                sharded_cosine4_scan_topk
                if self.scan_mode == "exact"
                else sharded_cosine4_scan_topk_auto
            )
            return fn(q, sharded, self.scan_mesh, k=k, max_distance=max_distance)
        if self.scan_mode == "auto":
            return sharded_cosine_scan_topk_auto(
                q, sharded, self.scan_mesh, k=k, max_distance=max_distance
            )
        return sharded_cosine_scan_topk(
            q, sharded, self.scan_mesh, k=k, max_distance=max_distance, mode=self.scan_mode
        )

    @_read_locked
    def query_by_image_hash_from_image(self, record: IndexedImage) -> None:
        if record.visual_hash is None:
            print("TODO: IndexedImage is somehow missing a hash!", file=sys.stderr)
            return
        self._cached_search_results = None
        if self._sem_store is None or self._sem_store.size == 0:
            self._cached_search_results = []
            return
        t0 = time.perf_counter()
        k = int(self.max_search_results)
        md = float(self.max_distance_from_query)
        with timed("engine.similarity_scan"):
            if self.scan_mode == "ivf":
                # Clustered ANN: probe the nprobe nearest clusters; the
                # selection is approximate, the distances exact (int4
                # libraries: asymmetric candidates + the exact-u8 rerank).
                dist, idx = self._ivf_query(np.asarray(record.visual_hash, dtype=np.uint8), k)
            elif self.semantic_precision == "int4" and self.int4_rerank:
                dist, idx = self._int4_scan_rerank(
                    lambda c, cmd: self.similarity_scan(record.visual_hash, c, cmd),
                    record.visual_hash, k, md,
                )
            else:
                dist, idx = self.similarity_scan(record.visual_hash, k, md)
                dist = dist.cpu().numpy()
                idx = idx.cpu().numpy()
        keep = idx >= 0
        with timed("engine.build_results"):
            self._cached_search_results = self._build_results(idx[keep], dist[keep])
        n = len(self._cached_search_results)
        print(f"Time to search DB: {time.perf_counter()-t0:.3f}s  Results: {n}", file=sys.stderr)

    def _int4_scan_rerank(self, scan, query_u8, k: int, max_distance: float):
        """int4 candidates, then the exact-u8 rescore (``ops.int4.
        scan_with_u8_rerank``): ``scan(c, md)`` gives the int4 scan's
        (dist, idx) tensors.  Spans: ``engine.int4_scan`` covers the
        candidate scan, ``engine.int4_scan_rerank`` the scan and the host
        rescore together.  Returns host (dist [.., k] f32, idx int64)."""

        def candidates(c, cmd):
            with timed("engine.int4_scan"):
                d, i = scan(c, cmd)
                return d.cpu().numpy(), i.cpu().numpy()

        with timed("engine.int4_scan_rerank"):
            return scan_with_u8_rerank(
                candidates, np.asarray(query_u8, dtype=np.uint8),
                self._sem_store._host_rows, k=k, max_distance=max_distance,
            )

    def _masked_exact_topk(self, q, store, ensure_sharded, rows, k, max_distance):
        """Exact top-k over a row-masked semantic index (broad catalog
        filters): the store's validity ANDed with the filter's rows.  One
        device: the resident index; under ``serve_on_mesh``: the sharded
        mirror, the mask sharded with its rows, so filtered scans scale
        with the mesh too.  Exact (not auto) — a filter-shrunk validity
        set breaks the θ sample's assumptions, so proofs would just fail
        into repairs.  An int4 store scans in the asymmetric int4 metric.
        Returns (dist [k], idx [k]) tensors."""
        int4 = store.kind == "semantic4"
        if self.scan_mesh is not None:
            base = ensure_sharded()
            mask = np.zeros(base.capacity, dtype=bool)
            mask[np.asarray(rows, dtype=np.int64)] = True
            scan = sharded_cosine4_scan_topk if int4 else sharded_cosine_scan_topk
            return scan(q, base.with_valid_mask(mask), self.scan_mesh, k=k,
                        max_distance=max_distance)
        index = store.device_index
        mask = torch.zeros(index.capacity, dtype=torch.bool, device=index.device)
        mask[torch.as_tensor(np.asarray(rows, dtype=np.int64)).to(index.device)] = True
        scan = cosine4a_scan_topk if int4 else cosine_scan_topk
        return scan(q, index._replace(valid=index.valid & mask), k=k, max_distance=max_distance)
