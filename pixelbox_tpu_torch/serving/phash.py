"""Perceptual-hash (Hamming) serving, single device (torch port of
``serving/phash.py``).

The capability behind the reference's phash table + hamming UDF
(engine.rs:594-663).  Uniform-width indexes take the guaranteed-exact
threshold scan over the packed u8 rows (``ops.hamming_gemm``: K2a + K1c,
repair K2b + K1c); mixed widths (aspect-preserving compat phashes)
replicate the reference's zip-truncate semantics per width group with the
exact scan (K2b + K1c).  Mesh serving is not yet ported.  Mixed into
:class:`pixelbox_tpu_torch.engine.Engine`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pixelbox_tpu_torch.serving.common import _read_locked
from pixelbox_tpu_torch.utils.timing import timed


def _no_mesh(engine) -> None:
    if engine.scan_mesh is not None:
        raise NotImplementedError(
            "mesh-sharded phash scans are not yet ported to pixelbox_tpu_torch"
        )


class PhashServing:
    @_read_locked
    def query_by_phash(self, phash_bytes: np.ndarray, k: Optional[int] = None) -> None:
        """Perceptual-hash (Hamming) search — the capability behind the
        reference's phash table + hamming UDF (engine.rs:594-663).

        Uniform-width indexes run the guaranteed-exact threshold scan over
        the packed store (ops.hamming_gemm).  Mixed widths replicate the
        reference's zip-truncate semantics (engine.rs:594-604): rows are
        grouped by min(query_width, row_width) and each group scans with
        that byte limit + divisor; groups merge by (dist, row id).
        """
        self._cached_search_results = None
        if self._ph_store is None or self._ph_store.size == 0:
            self._cached_search_results = []
            return
        _no_mesh(self)
        ph = np.asarray(phash_bytes, dtype=np.uint8).ravel()
        wq = len(ph)
        dim = self._ph_store.dim
        kk = int(k or self.max_search_results)
        md = float(self.max_distance_from_query)

        with timed("engine.phash_scan"):
            if wq >= dim and self.phash_store_uniform():
                dist, idx = self._phash_gemm_scan(ph[:dim], kk, md)
            else:
                widths = np.asarray(self._ph_widths, dtype=np.int64)
                dist, idx = self._phash_mixed_scan(ph, wq, widths, kk, md)
        keep = idx >= 0
        ids = [self._ph_image_ids[int(row)] for row in idx[keep]]
        with timed("engine.build_results"):
            self._cached_search_results = self._results_from_image_ids(ids, dist[keep])

    def phash_store_uniform(self) -> bool:
        """True when every stored phash has the store's width — the case
        the batched scan serves.  Cached per store version (appends,
        deletes, compaction and ``grow_dim`` bump it): converting the
        per-row width list costs tens of ms at 10^6 rows.

        Callers hold the index read lock: a check during an append would
        read the store's version before its width list.  It takes none
        itself, because the scan service's collector calls it on behalf
        of requests that hold theirs, and a new top-level read there would
        queue behind a waiting writer that waits on those requests."""
        ver = self._ph_store.version
        cached = getattr(self, "_ph_uniform_cache", None)
        if cached is None or cached[0] != ver:
            widths = np.asarray(self._ph_widths, dtype=np.int64)
            cached = (ver, bool(np.all(widths == self._ph_store.dim)))
            self._ph_uniform_cache = cached
        return cached[1]

    def _ensure_ph_gemm(self):
        """The scan's derived state for the packed phash store — the index,
        its row mask (``build_hamming_meta``) and the θ sample — cached on
        the store version, as the JAX package caches its ±1 GEMM index.
        ``grow_dim``, appends, deletes and compaction all bump the
        version."""
        from pixelbox_tpu_torch.ops.fused_scan import build_hamming_meta
        from pixelbox_tpu_torch.ops.hamming_gemm import build_hamming_scan_sample

        if (
            getattr(self, "_ph_gemm", None) is None
            or self._ph_gemm_at_ver != self._ph_store.version
        ):
            self._ph_gemm = self._ph_store.device_index
            self._ph_gemm_meta = build_hamming_meta(self._ph_gemm)
            self._ph_gemm_sample = build_hamming_scan_sample(self._ph_gemm, self._ph_gemm_meta)
            self._ph_gemm_at_ver = self._ph_store.version

    def _phash_gemm_scan(self, q: np.ndarray, k: int, max_distance: float):
        """Uniform-width scan of one or more hashes → numpy (dist, rows)."""
        from pixelbox_tpu_torch.ops.hamming_gemm import hamming_gemm_scan_topk_auto

        self._ensure_ph_gemm()
        dist, idx = hamming_gemm_scan_topk_auto(
            torch.from_numpy(np.ascontiguousarray(q)), self._ph_gemm, k=k,
            max_distance=max_distance, sample=self._ph_gemm_sample,
            meta=self._ph_gemm_meta,
        )
        return dist.cpu().numpy(), idx.cpu().numpy()

    def phash_scan_batched(self, queries: np.ndarray, k: int, max_distance: float):
        """Batched uniform-width Hamming scan: u8 [B, H] → (dist [B,k],
        device rows [B,k]).  Raises on a mixed-width (compat) store —
        those queries take the grouped zip-truncate path per query."""
        q = np.asarray(queries, dtype=np.uint8)
        dim = self._ph_store.dim
        if q.shape[1] < dim or not self.phash_store_uniform():
            raise ValueError("mixed-width phash store: no batched path")
        _no_mesh(self)
        return self._phash_gemm_scan(q[:, :dim], k, max_distance)

    def phash_ids_for_rows(self, rows) -> list:
        return [self._ph_image_ids[int(r)] for r in rows]

    def _phash_mixed_scan(
        self, ph: np.ndarray, wq: int, widths: np.ndarray, k: int,
        max_distance: float,
    ):
        """Zip-truncate Hamming scan over mixed-width rows: one exact scan
        (K2b + K1c) per distinct min(wq, row_width) with the group folded
        into the row mask, merged by (dist, id)."""
        from pixelbox_tpu_torch.ops.fused_scan import build_hamming_meta
        from pixelbox_tpu_torch.ops.hamming_gemm import hamming_gemm_scan_topk

        index = self._ph_store.device_index
        cap = index.capacity
        q = np.zeros(self._ph_store.dim, dtype=np.uint8)
        q[: min(wq, len(q))] = ph[: len(q)]
        qt = torch.from_numpy(q)
        limits = np.minimum(widths, wq)
        cand = []
        for m in np.unique(limits):
            m = int(m)
            if m == 0:
                continue  # 0-length zip → 0/0 = NaN in the reference: excluded
            group = np.zeros(cap, dtype=bool)
            group[np.nonzero(limits == m)[0]] = True
            d, i = hamming_gemm_scan_topk(
                qt, index, k=k, max_distance=max_distance,
                meta=build_hamming_meta(index, group), byte_limit=m,
            )
            d, i = d.cpu().numpy(), i.cpu().numpy()
            keep = i >= 0
            cand.append((d[keep], i[keep]))
        if not cand:
            return np.full(k, np.inf, np.float32), np.full(k, -1, np.int32)
        all_d = np.concatenate([d for d, _ in cand])
        all_i = np.concatenate([i for _, i in cand])
        order = np.lexsort((all_i, all_d))[:k]
        out_d = np.full(k, np.inf, np.float32)
        out_i = np.full(k, -1, np.int32)
        out_d[: len(order)] = all_d[order]
        out_i[: len(order)] = all_i[order]
        return out_d, out_i
