"""Engine — the top-level index/query API (torch port of ``engine.py``;
reference src/engine.rs:79-439).

SQLite is the host-side metadata catalog (the durable mirror of the
hashes); distances are computed by device scans over the packed store;
ingest is a batched host-decode → device-embed pipeline.  A library
written by either package opens in the other: the catalog schema, the
persisted settings and the checkpoint format are shared.

Semantics kept from the reference (as in the JAX package):

- ``new``/``open`` lifecycle with WAL + idempotent inserts (engine.rs:98-145);
- query language incl. the sticky ``similar:`` image cache, compared
  case-insensitively by path (engine.rs:510-537);
- text queries INNER JOIN semantic_hashes (engine.rs:306), ordered by
  distance to the cached similar-image (0.0 when none), with NO distance
  threshold (engine.rs:294-315);
- image-hash queries apply strict ``dist < max_distance_from_query``
  (engine.rs:375-383); results cached until the next query.

Ported so far: the semantic modality at either index precision (u8, or
int4 with the exact-u8 rerank), perceptual-hash search
(``query_by_phash``), whole-index duplicate finding, watched folders, the
removal and tag surface, :meth:`Engine.attach_scan_service` for the web
server's batching service (``serve.py``), and multi-device serving:
:meth:`Engine.serve_on_mesh` row-shards the semantic and phash indexes
over a mesh of devices (``parallel/``; one process drives them all, and
one card may hold several shards), and ``Engine.mesh`` splits the ingest
and query embed batches over a mesh; the IVF clustered index
(``scan_mode = "ivf"``, :class:`serving.ivf.IvfServing`) on one device or
row-sharded over the mesh.  The BLIP and face mixins (and their mesh
branches) and multi-process meshes wait (ROADMAP.md).
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from pixelbox_tpu_torch.index.catalog import Catalog
from pixelbox_tpu_torch.index.store import VectorStore
from pixelbox_tpu_torch.ingest.decode import DecodedImage, decode_image_bytes, decode_image_file
from pixelbox_tpu_torch.ingest.thumbnail import make_thumbnail, qoi_encode
from pixelbox_tpu_torch.models import get_embedder
from pixelbox_tpu_torch.ops import phash as phash_ops
from pixelbox_tpu_torch.ops.distances import cosine_distance
from pixelbox_tpu_torch.ops.int4 import cosine4a_distance_np, rerank_candidates_u8
from pixelbox_tpu_torch.parallel.sharded_scan import ShardedMirror
from pixelbox_tpu_torch.query import parse_query
from pixelbox_tpu_torch.records import IndexedImage
from pixelbox_tpu_torch.serving import (
    DuplicateFinding,
    IvfServing,
    PhashServing,
    SemanticServing,
    WatchMixin,
)
from pixelbox_tpu_torch.serving.common import _read_locked
from pixelbox_tpu_torch.utils.device import resolve_device
from pixelbox_tpu_torch.utils.rwlock import RWLock
from pixelbox_tpu_torch.utils.timing import timed

DEFAULT_MAX_QUERY_DISTANCE = 1e3  # engine.rs:23
DEFAULT_MAX_SEARCH_RESULTS = 100  # engine.rs:24
RECENT_IMAGES_TO_SHOW = 10  # engine.rs:25


class Engine(SemanticServing, IvfServing, PhashServing, DuplicateFinding, WatchMixin):
    """Index + query engine over a catalog DB and a device vector store.

    ``device`` ("cuda" by default, "cpu", or a torch.device) holds the
    packed store and runs the embedder and the scans; a CUDA device
    without a visible card raises instead of falling back to the CPU.
    """

    def __init__(
        self,
        db_path: str,
        create: bool = False,
        embedder: Optional[str] = None,
        embedder_kwargs: Optional[dict] = None,
        dim: Optional[int] = None,
        phash_compat: Optional[bool] = None,
        semantic_precision: Optional[str] = None,
        int4_rerank: bool = True,
        device="cuda",
    ):
        if semantic_precision not in (None, "int8", "int4"):
            raise ValueError(
                f"semantic_precision must be 'int8' or 'int4', got {semantic_precision!r}"
            )
        self.device = resolve_device(device)
        self.catalog = Catalog(db_path, create=create)
        self.db_path = db_path
        # phash geometry persists (it defines how query phashes are
        # computed); new libraries default to compat (phash.rs:7).
        if phash_compat is None:
            stored_pc = self.catalog.get_setting("phash_compat")
            phash_compat = stored_pc in (None, "", "1")
        else:
            self.catalog.set_setting("phash_compat", "1" if phash_compat else "0")
        self.phash_compat = bool(phash_compat)
        #: "int8" (default, reference-exact distances) or "int4": the
        #: device index packs two 4-bit codes per byte (ops/int4.py) — 2×
        #: rows per card at coarser distances; the catalog keeps the full
        #: u8 hashes either way.  Persisted: None keeps the library's
        #: setting, an explicit value overrides and re-persists it.
        if semantic_precision is None:
            semantic_precision = self.catalog.get_setting("semantic_precision") or "int8"
        else:
            self.catalog.set_setting("semantic_precision", semantic_precision)
        self.semantic_precision = semantic_precision
        #: int4 queries rescore the scan's top-C candidates with the EXACT
        #: u8 metric from the store's host mirror (ops/int4.py,
        #: rerank_candidates_u8): returned distances are true u8
        #: reciprocal-cosine values (comparable with int8 mode;
        #: `max_distance_from_query` keeps its u8 meaning; stored-hash
        #: self-matches score exactly 0).  Off → raw int4-metric results.
        self.int4_rerank = bool(int4_rerank)
        if not self.int4_rerank and self.semantic_precision == "int4":
            print(
                "WARNING: int4 library with int4_rerank disabled — "
                "results are raw int4-metric (measured recall@10 vs the "
                "u8 ground truth ~0.5 on the structured bench, vs 1.0 "
                "with the default exact-u8 rerank); distances are NOT "
                "comparable with int8 libraries.  See PERF.md 'int4'.",
                file=sys.stderr,
            )
        #: Guards row↔image-id mappings and in-place device appends: query
        #: flows hold the read side across scan→assemble; appends, deletes
        #: and compaction take the write side (utils/rwlock.py).
        self.index_rwlock = RWLock()

        # The embedder CHOICE persists in the library (it defines what the
        # stored hashes MEAN): explicit name / model path win and
        # re-persist; omitted ones restore the library's stored choice; a
        # brand-new library defaults to the stub.
        if embedder is None:
            embedder = self.catalog.get_setting("embedder_name") or "stub"
        else:
            self.catalog.set_setting("embedder_name", embedder)
        self._embedder_name = embedder
        self._embedder_kwargs = dict(embedder_kwargs or {})
        if dim is not None:
            self._embedder_kwargs.setdefault("dim", dim)
        if self._embedder_kwargs.get("input_size"):
            self.catalog.set_setting(
                "embedder_input_size", str(int(self._embedder_kwargs["input_size"]))
            )
        elif "input_size" not in self._embedder_kwargs:
            stored_isz = self.catalog.get_setting("embedder_input_size")
            if stored_isz:
                self._embedder_kwargs["input_size"] = int(stored_isz)
        kw = self._embedder_kwargs
        if "model" in kw and "checkpoint_path" not in kw:
            kw["checkpoint_path"] = kw.pop("model")
        model = kw.get("checkpoint_path")
        if isinstance(model, str) and model:
            self.catalog.set_setting("embedder_model", model)
        elif "checkpoint_path" not in kw and embedder == "efficientnet":
            stored_model = self.catalog.get_setting("embedder_model")
            if stored_model:
                kw["checkpoint_path"] = stored_model
        # The embedding width persists too; stored semantic hashes are the
        # fallback source for pre-existing/reference libraries.
        if kw.get("dim") is not None:
            self.catalog.set_setting("embedder_dim", str(int(kw["dim"])))
        else:
            stored_dim = self.catalog.get_setting("embedder_dim")
            if not stored_dim:
                first = next(self.catalog.iter_hashes("semantic_hashes"), None)
                if first is not None:
                    stored_dim = str(len(first[1]))
            if stored_dim:
                kw["dim"] = int(stored_dim)
        self._embedder = None  # lazy, like the reference's lazy_static MODEL
        self._embedder_lock = threading.Lock()

        # Searching and filtering (public fields, engine.rs:91-92).
        self.max_search_results: int = DEFAULT_MAX_SEARCH_RESULTS
        self.max_distance_from_query: float = DEFAULT_MAX_QUERY_DISTANCE
        #: "auto" (default): fused threshold scan + exact repair, results
        #: identical to "exact"; "exact": the blocked exact scan; "fast":
        #: served as "auto"; "pallas": the fused exact kernel scan; "ivf":
        #: clustered ANN — probe the ivf_nprobe nearest k-means clusters
        #: only (approximate selection, exact distances; ops/ivf.py).
        self.scan_mode: str = "auto"
        #: IVF knobs, active when scan_mode == "ivf": the index builds
        #: lazily from the u8 host mirror; k-means retrains when the library
        #: doubles since training or ivf_clusters changes; row-sharded over
        #: the mesh under serve_on_mesh (parallel/sharded_ivf).
        #: ``ivf_nprobe=None`` = the recall-governed default (2% of the
        #: clusters, floor 8 — ops.ivf.default_nprobe).
        self.ivf_nprobe: Optional[int] = None
        #: Opt-in MEASURED nprobe: when set (e.g. 0.99) and ivf_nprobe is
        #: unset, each full repack tunes nprobe on held-out noisy copies of
        #: store rows until recall@10 against the exact scan meets it
        #: (ops.ivf_build.tune_nprobe).
        self.ivf_target_recall: Optional[float] = None
        self._ivf_tuned_nprobe: Optional[int] = None
        self.ivf_clusters: Optional[int] = None  # default ~4*sqrt(N)
        self._ivf = None
        self._ivf_version = -1
        self._ivf_centroids = None
        self._ivf_trained_n = 0
        self._ivf_trained_want = 0  # the requested knob at training (0 = auto)
        # The store state at the last full bucket pack, and the knobs the
        # cached index was built with.
        self._ivf_structural = -1
        self._ivf_packed_n = 0
        self._ivf_cfg = None
        # Bumped on every retrain, so both packed caches (one device and
        # sharded) invalidate when either path retrains.
        self._ivf_centroid_gen = 0
        self._ivf_gen = -1
        # The mesh-sharded IVF mirror (serve_on_mesh + scan_mode == "ivf").
        self._ivf_sharded = None
        self._ivf_sharded_at_ver = -1
        self._ivf_sharded_struct = -1
        self._ivf_sharded_packed_n = 0
        self._ivf_sharded_cfg = None
        self._ivf_sharded_gen = -1
        self._ivf_sharded_spill_ids = None
        # Queries hold the read lock, so concurrent ivf queries could both
        # pay the k-means train; the build is serialized.
        self._ivf_build_lock = threading.Lock()
        self._row_meta = None
        self._row_meta_at_ver = -1
        self._scan_sample = None
        self._scan_sample_at_ver = -1
        self._cached_search_results: Optional[List[IndexedImage]] = None
        self._cached_image_search: Optional[IndexedImage] = None
        self.last_query_error: Optional[str] = None

        # Device store + row↔image_id mappings, rebuilt from the catalog.
        self._sem_store: Optional[VectorStore] = None
        self._sem_image_ids: List[int] = []
        self._sem_row_by_image: dict = {}
        self._ph_store: Optional[VectorStore] = None
        self._ph_image_ids: List[int] = []
        self._ph_row_by_image: dict = {}
        #: True byte width per phash row (aspect-preserving compat hashes
        #: vary in length, phash.rs:7); the store zero-pads to the max
        #: width but distances use zip-truncate semantics over TRUE widths
        #: (engine.rs:594-604) — see query_by_phash.
        self._ph_widths: List[int] = []
        self._ph_gemm = None
        self._ph_gemm_at_ver = -1
        #: Optional ``parallel.mesh.Mesh``: ingest and query embed batches
        #: split over its 'data' axis (parallel/data_parallel).
        self.mesh = None
        #: Optional mesh for QUERIES: the semantic and phash indexes are
        #: mirrored row-sharded over it and scans merge per-shard top-k
        #: (parallel/sharded_scan).  Set via serve_on_mesh().
        self.scan_mesh = None
        self._sem_mirror = ShardedMirror()
        self._ph_mirror = ShardedMirror()
        self._watcher: Optional[threading.Thread] = None
        self._watch_stop: Optional[threading.Event] = None
        self._cached_index_size: Optional[int] = None
        self._recently_indexed: List[str] = []
        self._recent_lock = threading.Lock()
        self._load_stores()

        self._pipeline = None
        self.last_pipeline = None

    # ------------------------------------------------------------------ #
    # Lifecycle (engine.rs:98-145)

    @classmethod
    def new(cls, db_path: str, **kwargs) -> "Engine":
        """Create a fresh database (like Engine::new, engine.rs:98-115)."""
        return cls(db_path, create=True, **kwargs)

    @classmethod
    def open(cls, db_path: str, **kwargs) -> "Engine":
        """Open an existing database (engine.rs:117-145)."""
        return cls(db_path, create=False, **kwargs)

    def _new_sem_store(self, dim: int) -> VectorStore:
        if self.semantic_precision == "int4" and dim % 2 != 0:
            raise ValueError(
                f"semantic_precision='int4' packs two dims per byte and "
                f"needs an even embedding dim, got {dim}"
            )
        kind = "semantic4" if self.semantic_precision == "int4" else "semantic"
        return VectorStore(dim=dim, kind=kind, device=self.device)

    def _load_stores(self) -> None:
        sem = list(self.catalog.iter_hashes("semantic_hashes"))
        if sem:
            dim = len(sem[0][1])
            self._sem_store = self._new_sem_store(dim)
            rows = np.frombuffer(b"".join(h for _, h in sem), dtype=np.uint8)
            self._sem_store.append(rows.reshape(len(sem), dim))
            self._sem_image_ids = [i for i, _ in sem]
            self._sem_row_by_image = {img: r for r, img in enumerate(self._sem_image_ids)}
        ph = list(self.catalog.iter_hashes("phashes"))
        if ph:
            # Aspect-preserving compat hashes vary in width; the store
            # zero-pads to the max, and the TRUE widths are kept so
            # queries replicate the reference's zip-truncate distance
            # (engine.rs:594-604) per row-width group.
            self._ph_widths = [len(h) for _, h in ph]
            dim = max(self._ph_widths)
            self._ph_store = VectorStore(dim=dim, kind="hamming", device=self.device)
            mat = np.zeros((len(ph), dim), dtype=np.uint8)
            for r, (_, h) in enumerate(ph):
                mat[r, : len(h)] = np.frombuffer(h, dtype=np.uint8)
            self._ph_store.append(mat)
            self._ph_image_ids = [i for i, _ in ph]
            self._ph_row_by_image = {img: r for r, img in enumerate(self._ph_image_ids)}

    @property
    def embedder(self):
        """The semantic embedder (on ``self.device``), or None in tags-only
        mode (``embedder="none"``)."""
        if self._embedder_name in (None, "none"):
            return None
        with self._embedder_lock:  # concurrent first uploads build one model
            if self._embedder is None:
                self._embedder = get_embedder(
                    self._embedder_name, device=self.device, **self._embedder_kwargs
                )
        return self._embedder

    # ------------------------------------------------------------------ #
    # Index size (engine.rs:157-171)

    def try_get_num_indexed_images(self) -> Optional[int]:
        return self._cached_index_size

    def get_num_indexed_images(self) -> int:
        self._cached_index_size = self.catalog.num_images()
        return self._cached_index_size

    def get_last_added(self) -> List[str]:
        with self._recent_lock:
            return list(self._recently_indexed)

    # ------------------------------------------------------------------ #
    # Ingest (engine.rs:173-259)

    def is_indexing_active(self) -> bool:
        return self._pipeline is not None and self._pipeline.is_active()

    def start_indexing(self, num_workers: Optional[int] = None) -> None:
        """Crawl tracked folders and index everything new (engine.rs:177-205)."""
        from pixelbox_tpu_torch.ingest.pipeline import IngestPipeline

        if self.is_indexing_active():
            return
        self._pipeline = IngestPipeline(
            engine=self, folders=self.get_tracked_folders(), num_workers=num_workers
        )
        self._pipeline.start()

    def stop_indexing(self) -> None:
        if self._pipeline is not None:
            self._pipeline.stop()
            self._pipeline = None

    def wait_for_indexing(self, timeout: Optional[float] = None) -> bool:
        """Join the running ingest; the finished pipeline stays readable as
        ``last_pipeline`` (its counters and ``elapsed_s``)."""
        if self._pipeline is None:
            return True
        done = self._pipeline.join(timeout)
        if done:
            self.last_pipeline = self._pipeline
            self._pipeline = None
        return done

    def insert_image_from_path(self, path: str) -> Optional[int]:
        """Decode, hash and insert one image file (engine.rs:218); None if
        its path is already indexed.  Raises IOError on an undecodable
        file."""
        record = self.load_image(path)
        if record is None:
            raise IOError(f"cannot decode image: {path}")
        return self.insert_image_from_memory(record)

    def insert_image_from_memory(self, record: IndexedImage) -> Optional[int]:
        """Insert one fully-hashed record; None if its path is already
        indexed (the one-record case of :meth:`insert_records_batch`)."""
        return self.insert_records_batch([record])[0]

    def insert_records_batch(self, records) -> List[Optional[int]]:
        """Insert many fully-hashed records in one catalog transaction and
        one device append (the ingest writer's hot path).

        Takes the index WRITE lock: the append writes in place into the
        device tensors a concurrent query may be scanning."""
        with self.index_rwlock.write_locked():
            return self._insert_records_batch_locked(records)

    def _insert_records_batch_locked(self, records) -> List[Optional[int]]:
        rows = [
            {
                "filename": r.filename,
                "path": r.path,
                "width": r.resolution[0],
                "height": r.resolution[1],
                "thumbnail": r.thumbnail,
                "tags": r.tags,
                "phash": None if r.phash is None else r.phash.tobytes(),
                "semantic_hash": (
                    None if r.visual_hash is None else r.visual_hash.tobytes()
                ),
            }
            for r in records
        ]
        ids = self.catalog.insert_images_batch(rows)

        new = [(i, r) for i, r in zip(ids, records) if i is not None]
        if new:
            self._append_hashes(
                [i for i, _ in new], [r.visual_hash for _, r in new], [r.phash for _, r in new]
            )
            with self._recent_lock:
                self._recently_indexed.extend(r.path for _, r in new)
                del self._recently_indexed[:-RECENT_IMAGES_TO_SHOW]
        self._cached_index_size = None
        return ids

    def _append_hashes(self, image_ids, visual_hashes, phashes) -> None:
        """Append the new images' semantic hashes and phashes to the device
        stores, one store append each (the JAX engine's single-record
        ``_append_hashes``, taken a batch at a time; None entries are
        skipped).  Call under the index write lock."""
        sem = [(i, h) for i, h in zip(image_ids, visual_hashes) if h is not None]
        if sem:
            if self._sem_store is None:
                self._sem_store = self._new_sem_store(len(sem[0][1]))
            row_ids = self._sem_store.append(np.stack([h for _, h in sem]))
            for (img_id, _), row in zip(sem, row_ids):
                self._sem_image_ids.append(img_id)
                self._sem_row_by_image[img_id] = int(row)
        ph = [(i, h) for i, h in zip(image_ids, phashes) if h is not None]
        if ph:
            if self._ph_store is None:
                self._ph_store = VectorStore(
                    dim=len(ph[0][1]), kind="hamming", device=self.device
                )
            # Never truncate: a wider hash grows the whole store
            # (existing rows zero-pad; true widths stay recorded).
            w = max(self._ph_store.dim, max(len(h) for _, h in ph))
            if w > self._ph_store.dim:
                self._ph_store.grow_dim(w)
            mat = np.zeros((len(ph), w), dtype=np.uint8)
            for j, (_, h) in enumerate(ph):
                mat[j, : len(h)] = h
            row_ids = self._ph_store.append(mat)
            for (img_id, h), row in zip(ph, row_ids):
                self._ph_image_ids.append(img_id)
                self._ph_widths.append(len(h))
                self._ph_row_by_image[img_id] = int(row)

    # ------------------------------------------------------------------ #
    # Record construction (indexed_image.rs:35-91)

    def load_image(self, path: str) -> Optional[IndexedImage]:
        """Decode + hash one image file into an IndexedImage record."""
        decoded = decode_image_file(path)
        if decoded is None:
            return None
        return self._record_from_decoded(decoded)

    def load_image_from_memory(
        self, data: bytes, filename: str = "", path: str = ""
    ) -> Optional[IndexedImage]:
        """Decode + hash an image held in memory (an upload)."""
        decoded = decode_image_bytes(data, filename, path)
        if decoded is None:
            return None
        return self._record_from_decoded(decoded)

    def set_embed_batch_size(self, batch_size: int) -> None:
        """Record the ingest embed batch size (in-process AND persisted)."""
        batch_size = int(batch_size)
        self._embed_batch_size = batch_size
        if self.catalog.get_setting("embed_batch_size") != str(batch_size):
            self.catalog.set_setting("embed_batch_size", str(batch_size))

    def _embed_query_ingest_exact(
        self, rgb: np.ndarray, frame: Optional[np.ndarray] = None
    ) -> np.ndarray:
        """Quantized semantic hash through the EXACT ingest batch path.

        A re-dropped copy of an indexed image must score exactly 0
        (engine.rs:352-361).  A batched ingest embed and a single-query
        embed could pick different convolution algorithms and drift by
        ulps, flipping a u8 bin; replaying the ingest writer's padded batch
        shape through the same functions — with cuDNN deterministic and
        benchmark off (utils/device.hold_exact_numerics) — makes the two
        bit-identical.  The batch size is read from the library when not
        set in-process (set_embed_batch_size).

        Caveat (documented, not guarded): the MESH state is not persisted.
        Under ``self.mesh`` the batch splits over the mesh's devices, so
        each device runs the forward at another batch size; a library
        ingested under a data-parallel mesh and queried without one (or
        vice versa) can then drift by ulps and flip a u8 bin.  Attach the
        same mesh for bit-exact self-matches of mesh-ingested libraries.
        """
        from pixelbox_tpu_torch.ingest.pipeline import DEFAULT_BATCH_SIZE, _normalize_frames
        from pixelbox_tpu_torch.ops.preprocess import fill_resize_u8
        from pixelbox_tpu_torch.ops.quantize import quantize_embedding

        b = getattr(self, "_embed_batch_size", None)
        if b is None:
            stored = self.catalog.get_setting("embed_batch_size")
            b = int(stored) if stored else DEFAULT_BATCH_SIZE
            self._embed_batch_size = b
        if frame is None:
            frame = fill_resize_u8(rgb, self.embedder.input_size)
        with timed("engine.query_embed"):
            frames = np.zeros((b,) + frame.shape, dtype=np.uint8)
            frames[0] = frame
            stacked = _normalize_frames(torch.from_numpy(frames).to(self.embedder.device))
            if self.mesh is not None:
                from pixelbox_tpu_torch.parallel.data_parallel import embed_batch_sharded

                latents = embed_batch_sharded(self.embedder, stacked, self.mesh)
            else:
                latents = self.embedder.embed_preprocessed(stacked)
            return quantize_embedding(latents).cpu().numpy()[0]

    def _record_from_decoded(self, decoded: DecodedImage) -> IndexedImage:
        # Share the embed frame's pre-crop cover image as the thumbnail
        # source (one full-res resample, same as the ingest pipeline).
        frame = big = None
        if self.embedder is not None:
            from pixelbox_tpu_torch.ops.preprocess import fill_resize_u8_with_big

            frame, big = fill_resize_u8_with_big(decoded.rgb, self.embedder.input_size)
        thumb = qoi_encode(make_thumbnail(decoded.rgb, prescaled=big))
        ph = phash_ops.phash(decoded.rgb, aspect_preserving=self.phash_compat)
        vh = (
            None
            if self.embedder is None
            else self._embed_query_ingest_exact(decoded.rgb, frame=frame)
        )
        return IndexedImage(
            filename=decoded.filename,
            path=decoded.path,
            resolution=decoded.resolution,
            thumbnail=thumb,
            tags=decoded.tags,
            phash=ph,
            visual_hash=vh,
        )

    # ------------------------------------------------------------------ #
    # Removal (the reference stages it as a TODO, engine.rs:414)

    def remove_image(self, image_id: int) -> bool:
        """Remove an image from the catalog and the device stores.  Its
        rows are tombstoned in place (ids stay stable), under the index
        write lock: a query scanning the store must not see the flip."""
        with self.index_rwlock.write_locked():
            return self._remove_image_locked(image_id)

    def _remove_image_locked(self, image_id: int) -> bool:
        if self.catalog.get_image(image_id) is None:
            return False
        self.catalog.remove_image(image_id)
        for store, row_by_image in (
            (self._sem_store, self._sem_row_by_image),
            (self._ph_store, self._ph_row_by_image),
        ):
            row = row_by_image.pop(image_id, None)
            if store is not None and row is not None:
                store.delete([row])
        self._cached_index_size = None
        return True

    def compact(self) -> None:
        """Drop tombstoned rows from the device stores (semantic, semantic4
        and hamming) and renumber the row↔image mappings.  Takes the index
        write lock: renumbering must not interleave with a query mapping
        scan rows back to image ids (the watcher compacts from its own
        thread while serving continues)."""
        with self.index_rwlock.write_locked():
            self._compact_locked()

    def _compact_locked(self) -> None:
        def compact_store(store, image_ids, row_by_image):
            if store is None or store.n_deleted == 0:
                return image_ids, row_by_image
            mapping = store.compact()
            new_ids = [0] * store.n
            new_rows = {}
            for old_row, img_id in enumerate(image_ids):
                new_row = mapping[old_row] if old_row < len(mapping) else -1
                if new_row >= 0:
                    new_ids[int(new_row)] = img_id
                    new_rows[img_id] = int(new_row)
            return new_ids, new_rows

        self._sem_image_ids, self._sem_row_by_image = compact_store(
            self._sem_store, self._sem_image_ids, self._sem_row_by_image
        )
        if self._ph_store is not None and self._ph_store.n_deleted > 0:
            width_by_image = dict(zip(self._ph_image_ids, self._ph_widths))
            self._ph_image_ids, self._ph_row_by_image = compact_store(
                self._ph_store, self._ph_image_ids, self._ph_row_by_image
            )
            self._ph_widths = [width_by_image[img] for img in self._ph_image_ids]
        # The sharded mirrors are stale now (their structural keys catch
        # this too); drop them eagerly to free device memory.
        self._sem_mirror.index = self._ph_mirror.index = None

    def remove_tracked_folder_and_images(self, folder_glob: str) -> int:
        """Remove a folder AND everything indexed under it.

        Only paths strictly INSIDE the directory match (``prefix/…``):
        removing ``/photos/vacay`` must not touch ``/photos/vacation``.
        LIKE wildcards in the folder path are escaped so ``%``/``_`` in
        directory names cannot widen the match.
        """
        self.remove_tracked_folder(folder_glob)
        # Strip the glob tail the crawler appends (crawler.rs:36-40 adds
        # /**/*.* itself), then the trailing separator, leaving a bare dir.
        prefix = folder_glob
        while prefix.endswith(("/*.*", "/**", "/*")):
            prefix = prefix[: prefix.rindex("/")]
        prefix = prefix.rstrip(os.sep + "/")
        if not prefix:
            return 0
        escaped = prefix.replace("!", "!!").replace("%", "!%").replace("_", "!_")
        conn = self.catalog._connect()
        ids = [
            r[0]
            for r in conn.execute(
                "SELECT id FROM images WHERE path LIKE ? ESCAPE '!'",
                (escaped + os.sep + "%",),
            )
        ]
        for i in ids:
            self.remove_image(i)
        return len(ids)

    # ------------------------------------------------------------------ #
    # Editable tags (reference roadmap README.md "Editable tags";
    # searchable immediately via the tag:/all: operators)

    def set_tag(self, image_id: int, name: str, value: str = "") -> bool:
        """Set/overwrite a user tag on an indexed image."""
        if self.catalog.get_image(image_id) is None:
            return False
        self.catalog.set_tag(image_id, name, value)
        return True

    def remove_tag(self, image_id: int, name: str) -> bool:
        return self.catalog.remove_tag(image_id, name)

    # ------------------------------------------------------------------ #
    # Tracked folders (engine.rs:404-439)

    def add_tracked_folder(self, folder_glob: str) -> None:
        self.catalog.add_tracked_folder(folder_glob)

    def remove_tracked_folder(self, folder_glob: str) -> None:
        self.catalog.remove_tracked_folder(folder_glob)

    def get_tracked_folders(self) -> List[str]:
        return self.catalog.get_tracked_folders()

    # ------------------------------------------------------------------ #
    # Text query (engine.rs:261-350)

    @_read_locked
    def query(self, user_input: str) -> None:
        """Run a text query; results via :meth:`get_query_results`.

        Raises QueryTokenizeError on malformed input (the reference's Err).
        """
        self.last_query_error = None
        if not user_input:
            return  # bail early, keep previous results (engine.rs:273)

        parsed = parse_query(user_input)
        self._cached_search_results = None

        # `similar:` — recompute the cached query image only when the path
        # changed (case-insensitive), engine.rs:510-533; the cache is sticky.
        if parsed.similar_path is not None and self.embedder is None:
            self.last_query_error = "similar: requires an embedder model (tags-only mode)"
        elif parsed.similar_path is not None:
            cached = self._cached_image_search
            if cached is None or cached.path.lower() != parsed.similar_path.lower():
                t0 = time.perf_counter()
                record = self.load_image(parsed.similar_path)
                print(
                    f"Time to compute image hash: {time.perf_counter()-t0:.3f}s",
                    file=sys.stderr,
                )
                self._cached_image_search = record
                if record is not None:
                    # Remember the path as typed for the staleness compare.
                    record.path = parsed.similar_path

        if parsed.face_path is not None or parsed.text_query is not None:
            self.last_query_error = (
                "face: and text: queries are not yet ported to pixelbox_tpu_torch"
            )
            self._cached_search_results = []
            return

        # Tags-only mode with no stored hashes: serve text queries straight
        # from the catalog.
        if self.embedder is None and not self._sem_image_ids:
            if parsed.has_filter:
                ids = self.catalog.filter_images(parsed.where_sql, parsed.params)
            else:
                conn = self.catalog._connect()
                ids = [r[0] for r in conn.execute("SELECT id FROM images ORDER BY id")]
            ids = ids[: int(self.max_search_results)]
            self._cached_search_results = self._results_from_image_ids(
                ids, np.zeros(len(ids), dtype=np.float32)
            )
            print(f"{len(self._cached_search_results)} results", file=sys.stderr)
            return

        # Candidate rows: text filters via the catalog; INNER JOIN
        # semantic_hashes semantics — only images with embeddings match.
        if parsed.has_filter:
            ids = self.catalog.filter_images(parsed.where_sql, parsed.params)
            rows = np.array(
                [self._sem_row_by_image[i] for i in ids if i in self._sem_row_by_image],
                dtype=np.int64,
            )
        else:
            rows = np.arange(len(self._sem_image_ids), dtype=np.int64)

        k = int(self.max_search_results)
        sim = self._cached_image_search
        if sim is not None and sim.visual_hash is not None and len(rows):
            # Order by cosine distance to the cached image over the matched
            # subset; NO distance threshold on this path (engine.rs:294-315).
            int4 = self.semantic_precision == "int4"
            q_u8 = np.asarray(sim.visual_hash, dtype=np.uint8)
            with timed("engine.text_query_scan"):
                if len(rows) > 16384:
                    # Broad filter: one exact device scan with the filter
                    # folded into the validity mask — of the sharded
                    # mirror under serve_on_mesh (int4: candidates in the
                    # asymmetric int4 metric, then — rerank on — the
                    # exact-u8 rescore, so a pair scores the same with or
                    # without a filter).
                    q = torch.as_tensor(q_u8)

                    def masked_scan(c, md):
                        return self._masked_exact_topk(
                            q, self._sem_store, self._get_sharded_index, rows, c, md
                        )

                    if int4 and self.int4_rerank:
                        dists, idxs = self._int4_scan_rerank(masked_scan, q_u8, k, np.inf)
                    else:
                        dists, idxs = (x.cpu().numpy() for x in masked_scan(k, np.inf))
                    keep = idxs >= 0
                    sel, sel_dists = idxs[keep], dists[keep]
                elif int4 and self.int4_rerank:
                    # The candidate set IS the filtered subset: score it in
                    # the exact u8 metric from the host mirror, ordered by
                    # (dist, row id) like the unfiltered reranked path.
                    d_k, i_k = rerank_candidates_u8(
                        q_u8, rows, self._sem_store._host_rows, k=k, max_distance=np.inf
                    )
                    keep = i_k >= 0
                    sel, sel_dists = i_k[keep], d_k[keep]
                else:
                    db_rows = self._sem_store.get_rows(rows)
                    if int4:
                        # Rerank off: the device index's asymmetric metric,
                        # so filtered and unfiltered orderings agree.
                        dists = cosine4a_distance_np(q_u8[None, :], db_rows)
                    else:
                        dists = cosine_distance(
                            torch.as_tensor(q_u8)[None, :], torch.from_numpy(db_rows)
                        ).numpy()
                    order = np.argsort(dists, kind="stable")[:k]
                    sel, sel_dists = rows[order], dists[order]
        else:
            sel = rows[:k]  # id order, dist 0.0 (engine.rs:291-293)
            sel_dists = np.zeros(len(sel), dtype=np.float32)

        self._cached_search_results = self._build_results(sel, sel_dists)
        print(f"{len(self._cached_search_results)} results", file=sys.stderr)

    # ------------------------------------------------------------------ #
    # Results (engine.rs:398-402)

    def get_query_results(self) -> Optional[List[IndexedImage]]:
        return self._cached_search_results

    def clear_query_results(self) -> None:
        self._cached_search_results = None

    def serve_on_mesh(self, mesh=None, axis: str = "data") -> None:
        """Serve similarity and phash queries from row-sharded mirrors of
        the indexes over ``mesh`` (default: a mesh over every visible card
        for a CUDA engine, the engine's own device otherwise).

        Each shard holds a copy of 1/n of the rows; queries scan every
        shard and merge the k candidates of each.  The shards are cut
        from the store's full index, which stays resident on the engine's
        device: the mesh spreads the scan, it adds no capacity (the
        engine's device holds N + N/n rows when it is also in the mesh).
        The mirrors sync lazily: an append ships only its rows, a
        structural change reshards.  Resets the mirrors of the modalities
        the port has (semantic, phash)."""
        from pixelbox_tpu_torch.parallel.mesh import make_mesh

        if mesh is None:
            mesh = make_mesh(
                axis_names=(axis,), device=None if self.device.type == "cuda" else self.device
            )
        self.scan_mesh = mesh
        self._sem_mirror = ShardedMirror()
        self._ph_mirror = ShardedMirror()

    def attach_scan_service(self, service) -> None:
        """Register this engine's batched phash and IVF scans on a
        BatchingScanService (``serve.build_scan_service`` calls this), so
        concurrent queries of those kinds coalesce into device batches
        beside the semantic ones.  BLIP ``text:`` and faces are not
        ported."""
        if self._ph_store is not None:
            service.register_kind(
                "phash", lambda q, k, md: self.phash_scan_batched(q, k, md)
            )
        # IVF (used when scan_mode == "ivf"): the clustered index builds
        # lazily on first use, so registration is free.
        service.register_kind(
            "ivf", lambda q, k, md, n_real=None: self.ivf_scan_batched(q, k, md, n_real=n_real)
        )

    def _build_results(self, rows, dists) -> List[IndexedImage]:
        ids = [self._sem_image_ids[int(row)] for row in rows]
        infos = self.catalog.get_images_with_tags(ids)
        out = []
        for row, image_id, d in zip(rows, ids, dists):
            info = infos.get(image_id)
            if info is None:
                continue
            rec = self._record_from_info(info)
            rec.visual_hash = self._sem_store.get_rows([int(row)])[0]
            rec.distance_from_query = float(d)
            out.append(rec)
        return out

    def _results_from_image_ids(self, ids, dists) -> List[IndexedImage]:
        infos = self.catalog.get_images_with_tags(ids)
        out = []
        for image_id, d in zip(ids, dists):
            info = infos.get(image_id)
            if info is None:
                continue
            rec = self._record_from_info(info)
            rec.distance_from_query = float(d)
            out.append(rec)
        return out

    @staticmethod
    def _record_from_info(info: dict) -> IndexedImage:
        return IndexedImage(
            id=info["id"],
            filename=info["filename"],
            path=info["path"],
            resolution=info["resolution"],
            thumbnail=info["thumbnail"],
            tags=info["tags"],
        )

    # ------------------------------------------------------------------ #

    def close(self) -> None:
        self.stop_watching()
        self.stop_indexing()
        self.catalog.close()
