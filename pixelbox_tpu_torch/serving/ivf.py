"""IVF (clustered-ANN) index management and serving (torch port of
``serving/ivf.py``).

The lowest-latency rung for large libraries (``ops/ivf.py``): k-means
centroids with a persistence sidecar (``<db>.ivf.npz``, numpy only, so a
library's sidecar written by either package is read by the other),
incremental spill extension on pure appends, a full repack on structural
change, the mesh-sharded mirror, and the batched serving-layer probe (u8
exact distances; int4 buckets with the exact-u8 rerank).  Mixed into
:class:`pixelbox_tpu_torch.engine.Engine`; the engine owns the caches and
locks.  Spans: ``engine.ivf_train``, ``engine.ivf_build``,
``engine.ivf_extend``, ``engine.ivf_tune_nprobe``.
"""

from __future__ import annotations

import os
import sys
from typing import Optional

import numpy as np

from pixelbox_tpu_torch.serving.service import _host
from pixelbox_tpu_torch.utils.timing import span


class IvfServing:
    def _get_ivf(self):
        """Cached IVF clustered index over the semantic store.

        Pure appends (a version bump, the same ``structural_version``)
        extend the exact-scanned spill incrementally; a full repack runs
        once the spill outgrows its threshold or the store mutates
        structurally.  K-means retrains only when no centroids exist yet,
        the dim changed, the requested ``ivf_clusters`` differs from the
        trained one, or the live rows more than doubled since training.
        """
        from pixelbox_tpu_torch.ops import ivf as ivf_ops

        store = self._sem_store
        if (
            self._ivf is not None
            and self._ivf_version == store.version
            and self._ivf_cfg == self._ivf_cfg_key()
            and self._ivf_gen == self._ivf_centroid_gen
        ):
            return self._ivf
        with self._ivf_build_lock:
            return self._build_ivf_locked(ivf_ops, store)

    def _ivf_cfg_key(self):
        """Knobs whose change invalidates the cached IVF index (0 = auto
        cluster count); ``ivf_target_recall`` too, so setting it after an
        index is cached rebuilds and tunes."""
        return (int(self.ivf_clusters or 0), float(self.ivf_target_recall or 0.0))

    def _ensure_ivf_centroids(self, ivf_ops, rows, valid, n_live) -> bool:
        """Train or restore the shared k-means centroids (under the build
        lock).  Returns True when a retrain happened — the centroid
        generation bump invalidates both packed caches.  Retrain keys on
        the REQUESTED ``ivf_clusters`` knob (0 = auto), not its clamp to
        the live count."""
        dim = rows.shape[1]
        if self._ivf_centroids is None:
            self._load_ivf_sidecar(dim)
        want_knob = int(self.ivf_clusters or 0)
        # Auto (knob 0) accepts whatever was trained: a flag-less reopen of
        # an explicitly clustered library must not retrain.
        knob_mismatch = want_knob != 0 and want_knob != self._ivf_trained_want
        retrain = (
            self._ivf_centroids is None
            or self._ivf_centroids.shape[1] != dim
            or knob_mismatch
            or n_live > 2 * max(1, self._ivf_trained_n)
        )
        if retrain:
            c = min(want_knob, n_live) if want_knob else ivf_ops.default_n_clusters(n_live)
            with span("engine.ivf_train"):
                self._ivf_centroids = ivf_ops.spherical_kmeans(
                    rows, valid, c, iters=10, seed=0, device=self.device
                )
            self._ivf_trained_n = n_live
            self._ivf_trained_want = want_knob
            self._ivf_centroid_gen += 1
            self._save_ivf_sidecar()
        return retrain

    def _build_ivf_locked(self, ivf_ops, store):
        # Double-check under the lock: a concurrent query may have just
        # finished the identical build.
        cfg = self._ivf_cfg_key()
        if (
            self._ivf is not None
            and self._ivf_version == store.version
            and self._ivf_cfg == cfg
            and self._ivf_gen == self._ivf_centroid_gen
        ):
            return self._ivf
        # Capture the store state BEFORE reading rows, so a pack that
        # missed a mid-build append is never stamped current.
        ver = store.version
        struct = store.structural_version
        n_now = store.n
        rows = store._host_rows[:n_now]
        valid = store._host_valid[:n_now]
        n_live = int(valid.sum())
        if n_live == 0:
            return None
        retrained = self._ensure_ivf_centroids(ivf_ops, rows, valid, n_live)
        if (
            not retrained
            and self._ivf is not None
            and self._ivf_cfg == cfg
            and self._ivf_gen == self._ivf_centroid_gen
            and self._ivf_structural == struct
            and n_now >= self._ivf_packed_n
        ):
            # Pure appends since the last pack: extend the spill only.  Its
            # base is the pre-pack part of the current spill, so repeated
            # extends stay duplicate-free.
            delta = np.flatnonzero(valid[self._ivf_packed_n :]).astype(np.int64) + self._ivf_packed_n
            old_spill = ivf_ops.live_spill_ids(self._ivf).astype(np.int64)
            base_spill = old_spill[old_spill < self._ivf_packed_n]
            total_spill = len(base_spill) + len(delta)
            # Every query scans the spill exactly; repack once it stops
            # being a rounding error next to the probed buckets.
            if total_spill <= max(8192, (self._ivf_packed_n // 16)):
                with span("engine.ivf_extend"):
                    self._ivf = ivf_ops.rebuild_spill(
                        self._ivf, rows, np.concatenate([base_spill, delta])
                    )
                self._ivf_version = ver
                return self._ivf
        with span("engine.ivf_build"):
            self._ivf = ivf_ops.build_ivf(
                rows, valid, self._ivf_centroids, precision=self._ivf_precision(),
                device=self.device,
            )
        self._ivf_version = ver
        self._ivf_structural = struct
        self._ivf_packed_n = n_now
        self._ivf_cfg = cfg
        self._ivf_gen = self._ivf_centroid_gen
        # Opt-in measured nprobe, tuned against the fresh pack (spill-only
        # extends keep it).
        self._ivf_tuned_nprobe = None
        if self.ivf_nprobe is None and self.ivf_target_recall:
            from pixelbox_tpu_torch.ops.ivf_build import tune_nprobe

            with span("engine.ivf_tune_nprobe"):
                tuned, rec = tune_nprobe(
                    self._ivf, rows, target_recall=float(self.ivf_target_recall), valid=valid,
                )
            self._ivf_tuned_nprobe = tuned
            print(
                f"ivf: tuned nprobe={tuned} (measured recall@10 "
                f"{rec:.4f} vs target {self.ivf_target_recall})",
                file=sys.stderr,
            )
        return self._ivf

    def _ivf_precision(self) -> str:
        """The bucket packing of the library's precision ("int8" libraries
        pack "u8" buckets)."""
        return "int4" if self.semantic_precision == "int4" else "u8"

    def _get_ivf_sharded(self):
        """Row-sharded IVF mirror (``serve_on_mesh`` + ``scan_mode ==
        "ivf"``): the single-device path's centroids, sidecar and retrain
        policy; each shard packs its contiguous store range into its own
        buckets with global row ids (``parallel/sharded_ivf``).  Pure
        appends extend the per-shard spills; structural changes rebuild."""
        from pixelbox_tpu_torch.ops import ivf as ivf_ops
        from pixelbox_tpu_torch.parallel import sharded_ivf as sivf_mod

        store = self._sem_store
        if (
            self._ivf_sharded is not None
            and self._ivf_sharded_at_ver == store.version
            and self._ivf_sharded_cfg == self._ivf_cfg_key()
            and self._ivf_sharded_gen == self._ivf_centroid_gen
        ):
            return self._ivf_sharded
        with self._ivf_build_lock:
            return self._build_ivf_sharded_locked(ivf_ops, sivf_mod, store)

    def _mesh_padded_mirror(self, store):
        """The host mirror padded to a row count the mesh divides
        (compaction leaves exactly n rows); pad rows are invalid and never
        pack into buckets or spill."""
        rows = store._host_rows
        valid = store._host_valid
        n_shards = self.scan_mesh.shape["data"]
        n_pad = -(-rows.shape[0] // n_shards) * n_shards
        if n_pad != rows.shape[0]:
            rows = np.concatenate(
                [rows, np.zeros((n_pad - rows.shape[0], rows.shape[1]), dtype=rows.dtype)]
            )
            valid = np.concatenate([valid, np.zeros(n_pad - valid.shape[0], dtype=bool)])
        return rows, valid

    def _build_ivf_sharded_locked(self, ivf_ops, sivf_mod, store):
        cfg = self._ivf_cfg_key()
        if (
            self._ivf_sharded is not None
            and self._ivf_sharded_at_ver == store.version
            and self._ivf_sharded_cfg == cfg
            and self._ivf_sharded_gen == self._ivf_centroid_gen
        ):
            return self._ivf_sharded
        ver = store.version
        struct = store.structural_version
        n_now = store.n
        rows, valid = self._mesh_padded_mirror(store)
        n_live = int(valid[:n_now].sum())
        if n_live == 0:
            return None
        retrained = self._ensure_ivf_centroids(ivf_ops, rows[:n_now], valid[:n_now], n_live)
        if (
            not retrained
            and self._ivf_sharded is not None
            and self._ivf_sharded_cfg == cfg
            and self._ivf_sharded_gen == self._ivf_centroid_gen
            and self._ivf_sharded_struct == struct
            and n_now >= self._ivf_sharded_packed_n
        ):
            packed_n = self._ivf_sharded_packed_n
            local_rows = rows.shape[0] // self.scan_mesh.shape["data"]
            delta = np.flatnonzero(valid[packed_n:n_now]).astype(np.int64) + packed_n
            bases = [b[b < packed_n] for b in self._ivf_sharded_spill_ids]
            total_spill = sum(len(b) for b in bases) + len(delta)
            if total_spill <= max(8192, packed_n // 16):
                per_shard = [
                    np.concatenate([b, delta[(delta // local_rows) == s]])
                    for s, b in enumerate(bases)
                ]
                with span("engine.ivf_extend"):
                    self._ivf_sharded = sivf_mod.rebuild_sharded_spill(
                        self._ivf_sharded, rows, per_shard
                    )
                self._ivf_sharded_spill_ids = per_shard
                self._ivf_sharded_at_ver = ver
                return self._ivf_sharded
        with span("engine.ivf_build"):
            self._ivf_sharded, spill_ids = sivf_mod.build_sharded_ivf(
                rows, valid, self._ivf_centroids, self.scan_mesh, precision=self._ivf_precision(),
            )
        self._ivf_sharded_spill_ids = spill_ids
        self._ivf_sharded_at_ver = ver
        self._ivf_sharded_struct = struct
        self._ivf_sharded_packed_n = n_now
        self._ivf_sharded_cfg = cfg
        self._ivf_sharded_gen = self._ivf_centroid_gen
        # The tuned nprobe is index-specific: re-tune against THIS sharded
        # index through its real scan path.
        self._ivf_tuned_nprobe = None
        if self.ivf_nprobe is None and self.ivf_target_recall:
            from pixelbox_tpu_torch.ops.ivf_build import tune_nprobe

            sivf = self._ivf_sharded
            mesh = self.scan_mesh
            if self.semantic_precision == "int4" and self.int4_rerank:
                from pixelbox_tpu_torch.ops.int4 import scan_with_u8_rerank

                def _scan(qs, nprobe):
                    return scan_with_u8_rerank(
                        lambda c_, md_: tuple(_host(x) for x in sivf_mod.sharded_ivf_scan_topk(
                            qs, sivf, mesh, k=c_, nprobe=nprobe, max_distance=md_,
                        )),
                        qs, self._sem_store._host_rows, k=10, max_distance=1e3,
                    )
            else:
                def _scan(qs, nprobe):
                    return sivf_mod.sharded_ivf_scan_topk(qs, sivf, mesh, k=10, nprobe=nprobe)

            with span("engine.ivf_tune_nprobe"):
                tuned, rec = tune_nprobe(
                    sivf, rows, target_recall=float(self.ivf_target_recall), valid=valid,
                    scan_fn=_scan,
                )
            self._ivf_tuned_nprobe = tuned
            print(
                f"ivf (sharded): tuned nprobe={tuned} (measured recall@10 "
                f"{rec:.4f} vs target {self.ivf_target_recall})",
                file=sys.stderr,
            )
        return self._ivf_sharded

    def _ivf_sidecar_path(self) -> Optional[str]:
        if not self.db_path or self.db_path == ":memory:":
            return None
        return self.db_path + ".ivf.npz"

    def _library_uuid(self) -> str:
        """Stable per-library identity (persisted in pixelbox_settings),
        minted on first use: a library rebuilt in place gets a fresh uuid,
        so its stale sidecar is rejected."""
        u = self.catalog.get_setting("library_uuid")
        if not u:
            import uuid

            u = uuid.uuid4().hex
            self.catalog.set_setting("library_uuid", u)
        return u

    def _load_ivf_sidecar(self, dim: int) -> None:
        """Restore trained centroids from the library sidecar, so a
        reopened library's first ivf query skips k-means (the buckets
        always repack from the live store)."""
        path = self._ivf_sidecar_path()
        if path is None or not os.path.exists(path):
            return
        try:
            with np.load(path) as z:
                cents = np.asarray(z["centroids"], dtype=np.float32)
                trained_n = int(z["trained_n"])
                trained_want = int(z["trained_want"]) if "trained_want" in z else 0
                lib_uuid = str(z["library_uuid"]) if "library_uuid" in z else ""
        except Exception as e:  # noqa: BLE001 — stale/corrupt: retrain
            print(f"ivf sidecar unreadable ({e}); retraining", file=sys.stderr)
            return
        if lib_uuid != self._library_uuid():
            print("ivf sidecar belongs to a different library; retraining", file=sys.stderr)
            return
        if cents.ndim == 2 and cents.shape[1] == dim:
            self._ivf_centroids = cents
            self._ivf_trained_n = trained_n
            self._ivf_trained_want = trained_want

    def _save_ivf_sidecar(self) -> None:
        path = self._ivf_sidecar_path()
        if path is None or self._ivf_centroids is None:
            return
        try:
            np.savez(path, centroids=self._ivf_centroids,
                     trained_n=np.int64(self._ivf_trained_n),
                     trained_want=np.int64(self._ivf_trained_want),
                     library_uuid=self._library_uuid())
        except Exception as e:  # noqa: BLE001 — a non-fatal cache
            print(f"ivf sidecar not saved: {e}", file=sys.stderr)

    def ivf_scan_batched(self, queries_u8, k: int, max_distance: float,
                         n_real: Optional[int] = None):
        """Batched IVF scan for the serving layer: u8 [B, D] queries →
        host (dist [B, k], store row ids [B, k]).  The mesh under
        ``serve_on_mesh``, one device otherwise — the dispatch (and the
        int4 rerank) of ``query_by_image_hash_from_image``'s ivf branch,
        without the engine lock.  ``n_real`` (from the batching service)
        limits the int4 host rescore to the batch's real rows."""
        return self._ivf_query(
            np.asarray(queries_u8, dtype=np.uint8), int(k),
            max_distance=float(max_distance), n_real=n_real,
        )

    def _ivf_scan(self, q_u8, k: int, max_distance: float):
        """(dist, idx) tensors of the clustered scan in the index's own
        metric (int4 buckets: the asymmetric one, before any rerank): the
        mesh under ``serve_on_mesh``, one device otherwise.  The nprobe is
        the explicit knob, else the build-time tuned value, else the 2%
        auto policy."""
        if self.scan_mesh is not None:
            from pixelbox_tpu_torch.parallel.sharded_ivf import sharded_ivf_scan_topk

            sivf = self._get_ivf_sharded()
            nprobe = self.ivf_nprobe or self._ivf_tuned_nprobe
            return sharded_ivf_scan_topk(q_u8, sivf, self.scan_mesh, k=k, nprobe=nprobe,
                                         max_distance=max_distance)
        from pixelbox_tpu_torch.ops.ivf import ivf_scan_topk

        ivf = self._get_ivf()
        nprobe = self.ivf_nprobe or self._ivf_tuned_nprobe
        return ivf_scan_topk(q_u8, ivf, k=k, nprobe=nprobe, max_distance=max_distance)

    def _ivf_query(self, q_u8: np.ndarray, k: int, max_distance: Optional[float] = None,
                   n_real: Optional[int] = None):
        """Clustered-ANN scan at the library's precision; host arrays.

        u8 libraries return exact u8 reciprocal-cosine distances over the
        probed set.  int4 libraries probe nibble buckets in the asymmetric
        metric and — with ``int4_rerank`` on — rescore the candidates
        against the u8 host mirror (``ops.int4.scan_with_u8_rerank``), so
        the distances are true u8 values as in the flat int4 flow."""
        md = float(self.max_distance_from_query if max_distance is None else max_distance)

        def _scan(c, md_):
            d, i = self._ivf_scan(q_u8, c, md_)
            return _host(d), _host(i)

        if self.semantic_precision == "int4" and self.int4_rerank:
            from pixelbox_tpu_torch.ops.int4 import scan_with_u8_rerank

            return scan_with_u8_rerank(
                _scan, q_u8, self._sem_store._host_rows, k=k, max_distance=md, n_real=n_real,
            )
        return _scan(k, md)
