"""Semantic (visual-similarity) serving — the engine's hot query path
(torch port of ``serving/semantic.py``, single device).

Scan-mode dispatch (reference engine.rs:352-396):

- ``auto`` (default) and ``fast``: ``ops.scan.cosine_scan_topk_auto`` —
  the fused threshold scan plus exact repair, results identical to
  ``exact``.  ``fast`` rested on the TPU-only ``approx_min_k``; it is
  served as ``auto``, as the JAX package already does for int4;
- ``exact``: the blocked exact scan (plain PyTorch);
- ``pallas``: the fused exact kernel scan (``fused_cosine_scan_topk``) —
  the flag keeps its name;
- ``ivf``, int4 precision and mesh serving raise NotImplementedError.

Caches the row meta and the θ sample per store version, as the JAX
package does.  Mixed into :class:`pixelbox_tpu_torch.engine.Engine`;
state lives on the engine.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from pixelbox_tpu_torch.ops.fused_scan import build_row_meta, fused_cosine_scan_topk
from pixelbox_tpu_torch.ops.scan import (
    DEFAULT_BLOCK_ROWS,
    build_scan_sample,
    cosine_scan_topk,
    cosine_scan_topk_auto,
)
from pixelbox_tpu_torch.records import IndexedImage
from pixelbox_tpu_torch.serving.common import _read_locked
from pixelbox_tpu_torch.utils.timing import timed

SCAN_MODES = ("auto", "exact", "fast", "pallas")


class SemanticServing:
    def _get_row_meta(self) -> torch.Tensor:
        """Cached [4, N] row meta for the scan kernels."""
        if self._row_meta is None or self._row_meta_at_ver != self._sem_store.version:
            self._row_meta = build_row_meta(self._sem_store.device_index)
            self._row_meta_at_ver = self._sem_store.version
        return self._row_meta

    def _get_scan_sample(self):
        """Cached θ-estimation subsample for the auto scan; None while the
        index is small enough that auto scans directly."""
        index = self._sem_store.device_index
        if index.capacity <= 4 * DEFAULT_BLOCK_ROWS:
            return None
        if self._scan_sample is None or self._scan_sample_at_ver != self._sem_store.version:
            self._scan_sample = build_scan_sample(index)
            self._scan_sample_at_ver = self._sem_store.version
        return self._scan_sample

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
        engine's scan mode."""
        if self.scan_mode not in SCAN_MODES:
            raise NotImplementedError(
                f"scan mode {self.scan_mode!r} is not yet ported to "
                f"pixelbox_tpu_torch (ported: {', '.join(SCAN_MODES)})"
            )
        index = self._sem_store.device_index
        q = torch.as_tensor(np.asarray(visual_hash, dtype=np.uint8)).to(index.device)
        if self.scan_mode == "exact":
            return cosine_scan_topk(q, index, k=k, max_distance=max_distance)
        if self.scan_mode == "pallas":
            return fused_cosine_scan_topk(
                q, index, self._get_row_meta(), k=k, max_distance=max_distance
            )
        sample = self._get_scan_sample()
        return cosine_scan_topk_auto(
            q, index, k=k, max_distance=max_distance, sample=sample,
            row_meta=None if sample is None else self._get_row_meta(),
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
        with timed("engine.similarity_scan"):
            dist, idx = self.similarity_scan(
                record.visual_hash, k, float(self.max_distance_from_query)
            )
            dist = dist.cpu().numpy()
            idx = idx.cpu().numpy()
        keep = idx >= 0
        with timed("engine.build_results"):
            self._cached_search_results = self._build_results(idx[keep], dist[keep])
        n = len(self._cached_search_results)
        print(f"Time to search DB: {time.perf_counter()-t0:.3f}s  Results: {n}", file=sys.stderr)
