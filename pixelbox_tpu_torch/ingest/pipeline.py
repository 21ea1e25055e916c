"""Batched ingest pipeline: crawl → decode pool → device embed → append
(torch port of ``ingest/pipeline.py``, non-turbo).

The reference's ingest (src/crawler.rs + engine.rs:173-216) is a 3-stage
CPU pipeline: glob thread → 4 decode workers → DB-writer thread, joined
by channels with a bounded(128) buffer.  The port keeps the host topology
and embeds on the device in batches:

    [walker thread]   glob walk + extension filter + already-indexed skip
          │ path queue (unbounded, like crawler.rs:27)
    [decode pool xN]  decode → EXIF → QOI thumbnail → phash → 224² resize
          │ item queue (bounded 128, backpressure like crawler.rs:8,28)
    [device thread]   stack batch → embed → quantize → append to
                      catalog + packed store (single writer, engine.rs:186)

The device thread is the lone writer, so the store and catalog need no
extra synchronization.  Stopping mid-run is safe: inserts are idempotent
by path, so a re-index resumes where it left off (engine.rs:231).
Turbo ingest (device phash), faces, BLIP and OCR wait (ROADMAP.md).
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from pixelbox_tpu_torch.ingest.crawler import crawl
from pixelbox_tpu_torch.ingest.decode import decode_image_file, stringify_filepath
from pixelbox_tpu_torch.ingest.thumbnail import make_thumbnail, qoi_encode
from pixelbox_tpu_torch.ops import phash as phash_ops
from pixelbox_tpu_torch.ops.preprocess import fill_resize_u8_with_big
from pixelbox_tpu_torch.ops.quantize import quantize_embedding
from pixelbox_tpu_torch.records import IndexedImage
from pixelbox_tpu_torch.utils.timing import span

PARALLEL_FILE_PROCESSORS = 4  # engine.rs:22
MAX_PENDING_TX = 128          # crawler.rs:8
DEFAULT_BATCH_SIZE = 64
_SENTINEL = None
_INV_255 = np.float32(1.0 / 255.0)


def _normalize_frames(frames_u8: torch.Tensor) -> torch.Tensor:
    """u8 frames → f32 in [0, 1] as ``x * f32(1/255)``.

    A multiply, NOT a division: the JAX package writes ``/ 255`` under
    jit, and XLA:CPU rewrites a division by a constant into exactly this
    multiply by the f32-rounded reciprocal.  A true division differs for
    126 of the 256 byte values and would feed B0 different inputs."""
    x = frames_u8.to(torch.float32)
    return x * torch.tensor(_INV_255, dtype=torch.float32, device=x.device)


@dataclass
class _Item:
    record: IndexedImage
    preprocessed: Optional[np.ndarray]  # u8 frame [S, S, 3]


class IngestPipeline:
    def __init__(
        self,
        engine,
        folders: List[str],
        num_workers: Optional[int] = None,
        batch_size: int = DEFAULT_BATCH_SIZE,
    ):
        self.engine = engine
        self.folders = list(folders)
        self.num_workers = num_workers or PARALLEL_FILE_PROCESSORS
        self.batch_size = batch_size
        # Query embeds replay this exact batch shape for bit-identical
        # self-matches (engine._embed_query_ingest_exact); persisted.
        engine.set_embed_batch_size(batch_size)
        self._stop = threading.Event()
        self._path_q: "queue.Queue" = queue.Queue()
        self._item_q: "queue.Queue" = queue.Queue(maxsize=MAX_PENDING_TX)
        self._threads: List[threading.Thread] = []
        self._writer: Optional[threading.Thread] = None
        self.images_indexed = 0
        self.images_skipped = 0
        self.images_failed = 0
        self._started_at: Optional[float] = None
        #: Seconds from start() to the writer's last batch (images/s).
        self.elapsed_s: Optional[float] = None

    # ------------------------------------------------------------------ #

    def start(self) -> None:
        self._started_at = time.perf_counter()
        walker = threading.Thread(target=self._walk, name="pixelbox-walker", daemon=True)
        walker.start()
        self._threads.append(walker)
        for i in range(self.num_workers):
            t = threading.Thread(
                target=self._decode_worker, name=f"pixelbox-decode-{i}", daemon=True
            )
            t.start()
            self._threads.append(t)
        self._writer = threading.Thread(
            target=self._device_writer, name="pixelbox-writer", daemon=True
        )
        self._writer.start()

    def stop(self) -> None:
        """Stop like dropping the crawler channel (engine.rs:207-212)."""
        self._stop.set()

    def is_active(self) -> bool:
        return self._writer is not None and self._writer.is_alive()

    def join(self, timeout: Optional[float] = None) -> bool:
        if self._writer is None:
            return True
        self._writer.join(timeout)
        return not self._writer.is_alive()

    # ------------------------------------------------------------------ #

    def _walk(self) -> None:
        try:
            for path in crawl(self.folders):
                if self._stop.is_set():
                    break
                self._path_q.put(path)
        finally:
            for _ in range(self.num_workers):
                self._path_q.put(_SENTINEL)

    def _decode_worker(self) -> None:
        engine = self.engine
        while not self._stop.is_set():
            try:
                path = self._path_q.get(timeout=0.1)
            except queue.Empty:
                continue
            if path is _SENTINEL:
                break
            try:
                if engine.catalog.has_path(stringify_filepath(path)):
                    # INSERT OR IGNORE semantics, checked before decode.
                    self.images_skipped += 1
                    continue
                decoded = decode_image_file(path)
                if decoded is None:
                    self.images_failed += 1
                    continue
                # The embed input ships to the device as a u8 frame (÷255
                # there); its pre-crop cover image is the thumbnail source.
                pre, big = (
                    (None, None)
                    if engine.embedder is None
                    else fill_resize_u8_with_big(decoded.rgb, engine.embedder.input_size)
                )
                thumb = qoi_encode(make_thumbnail(decoded.rgb, prescaled=big))
                ph = phash_ops.phash(decoded.rgb, aspect_preserving=engine.phash_compat)
                record = IndexedImage(
                    filename=decoded.filename,
                    path=decoded.path,
                    resolution=decoded.resolution,
                    thumbnail=thumb,
                    tags=decoded.tags,
                    phash=ph,
                )
                item = _Item(record=record, preprocessed=pre)
                while not self._stop.is_set():
                    try:
                        self._item_q.put(item, timeout=0.25)
                        break
                    except queue.Full:
                        continue
            except Exception:
                self.images_failed += 1
        # Each worker signals drain-completion to the writer.
        self._item_q.put(_SENTINEL)

    def _device_writer(self) -> None:
        workers_done = 0
        batch: List[_Item] = []
        while True:
            flush = False
            try:
                item = self._item_q.get(timeout=0.25)
                if item is _SENTINEL:
                    workers_done += 1
                    if workers_done == self.num_workers:
                        flush = True
                else:
                    batch.append(item)
                    if len(batch) >= self.batch_size:
                        flush = True
            except queue.Empty:
                # Idle — flush a partial batch so small folders finish fast.
                flush = bool(batch)
            if self._stop.is_set():
                flush = bool(batch)
            if flush and batch:
                self._embed_and_insert(batch)
                batch = []
            if workers_done == self.num_workers or (
                self._stop.is_set() and not batch
            ):
                break
        if self._started_at is not None:
            self.elapsed_s = time.perf_counter() - self._started_at
            print(f"Indexing took {self.elapsed_s:.1f} seconds.")

    def _pad_batch(self, arr: np.ndarray) -> np.ndarray:
        """Pad to the fixed batch size: the query replays this exact shape
        (engine._embed_query_ingest_exact), so partial flushes do too."""
        m = arr.shape[0]
        if m == self.batch_size:
            return arr
        pad = np.zeros((self.batch_size - m,) + arr.shape[1:], dtype=arr.dtype)
        return np.concatenate([arr, pad], axis=0)

    def _embed_and_insert(self, batch: List[_Item]) -> None:
        m = len(batch)
        embedder = self.engine.embedder
        if embedder is None:
            hashes = [None] * m  # tags-only mode: no semantic hashes
        else:
            with span("ingest.embed_batch"):
                frames_u8 = torch.from_numpy(
                    self._pad_batch(np.stack([it.preprocessed for it in batch]))
                ).to(embedder.device)
                stacked = _normalize_frames(frames_u8)
                mesh = getattr(self.engine, "mesh", None)
                if mesh is not None:
                    from pixelbox_tpu_torch.parallel.data_parallel import embed_batch_sharded

                    latents = embed_batch_sharded(embedder, stacked, mesh)
                else:
                    latents = embedder.embed_preprocessed(stacked)
                hashes = quantize_embedding(latents).cpu().numpy()[:m]
        for it, vh in zip(batch, hashes):
            it.record.visual_hash = vh
        ids = self.engine.insert_records_batch([it.record for it in batch])
        for i in ids:
            if i is not None:
                self.images_indexed += 1
            else:
                self.images_skipped += 1
