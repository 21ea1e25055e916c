"""Micro-batching scan service — production query serving (torch port of
``serving/service.py``).

The scan is far more efficient batched (one 256-query pass of the collect
kernel costs barely more than one 8-query pass — PERF.md), but
interactive clients arrive one query at a time.  This service coalesces
concurrent requests into device batches: callers block on
:meth:`BatchingScanService.submit`; a collector thread drains the queue up
to ``max_batch`` (or ``max_wait_ms``), groups requests by MODALITY and
query width (semantic / phash — each has its own index and distance
kind), pads each group to a bucketed batch shape, runs ONE scan per
group, and distributes per-query results.

The semantic scans take their index, θ sample and row meta from the
``index_provider`` — the engine's caches, keyed on the store's (kind,
version) — never from a cache keyed on the tensor's identity: the store
appends and tombstones in place, so a tensor outlives its contents.
"""

from __future__ import annotations

import inspect
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from pixelbox_tpu_torch.ops.int4 import (
    PackedSemantic4Index,
    cosine4_scan_topk_auto,
    scan_with_u8_rerank,
)
from pixelbox_tpu_torch.ops.scan import cosine_scan_topk_auto
from pixelbox_tpu_torch.utils.timing import timed

#: Batch shapes of the semantic scans.  Every batch selects on the
#: distance (``epilogue="dist"``): the tensor-core K1a and K4a filter on
#: the cos key inside their one launch, and on the H100 the cos-key pass
#: (K1d / K4d + K1e) is slower at every bucket (chip_smoke.py's "auto
#: dist vs cos" and "full bucket" lines, PERF.md §6).
_BUCKETS = (1, 8, 32, 128, 256)


def _bucket(n: int) -> int:
    for b in _BUCKETS:
        if n <= b:
            return b
    return _BUCKETS[-1]


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class ScanInputs(NamedTuple):
    """What a semantic batch scans: the packed index (u8
    ``PackedSemanticIndex`` or int4 ``PackedSemantic4Index``), its θ
    sample (None while the index is small enough for the exact scan) and
    its kernel row meta."""

    index: object
    sample: object
    meta: torch.Tensor


@dataclass
class _Request:
    query: np.ndarray
    kind: str = "semantic"
    event: threading.Event = field(default_factory=threading.Event)
    dist: Optional[np.ndarray] = None
    idx: Optional[np.ndarray] = None
    error: Optional[Exception] = None


class BatchingScanService:
    """Coalesces concurrent similarity queries into single device scans.

    ``kind="semantic"`` scans run the guaranteed-exact auto scan over the
    ``index_provider``'s inputs (results identical to every other scan
    mode).  Other modalities register batched scan callables via
    ``scan_fns`` / :meth:`register_kind` — e.g. the engine's batched phash
    scan — and their requests coalesce the same way (grouped per kind
    within a drained batch, so a mixed burst costs one device pass per
    modality).
    """

    def __init__(
        self,
        index_provider: Callable[[], ScanInputs],
        k: int = 100,
        max_distance: float = 1e3,
        max_batch: int = 256,
        max_wait_ms: float = 2.0,
        scan_fns: Optional[Dict[str, Callable]] = None,
        rerank_rows_provider: Optional[Callable] = None,
    ):
        """``index_provider``: zero-arg callable returning the current
        :class:`ScanInputs` (the engine's ``semantic_scan_inputs``), so
        appends and deletes are picked up between batches.
        ``scan_fns``: {kind: fn(queries_u8_2d, k, max_distance) ->
        (dist [B,k], idx [B,k])} for non-semantic modalities.
        ``rerank_rows_provider``: zero-arg callable returning the u8 host
        mirror [N, D] — when set and the index is int4, batched scans
        retrieve the top-C int4 candidates and rescore them with the exact
        u8 metric (the engine's ``int4_rerank``)."""
        self._provider = index_provider
        self._rerank_rows = rerank_rows_provider
        self.k = k
        self.max_distance = max_distance
        self.max_batch = min(max_batch, _BUCKETS[-1])
        self.max_wait_s = max_wait_ms / 1e3
        self._scan_fns: Dict[str, Callable] = dict(scan_fns or {})
        self._scan_n_real: Dict[str, bool] = {}
        self._q: "queue.Queue[_Request]" = queue.Queue()
        self.batches_run = 0
        self.queries_served = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._collector, name="pixelbox-scan-batcher", daemon=True
        )
        self._thread.start()

    # ------------------------------------------------------------------ #

    def warmup(self, dim: int, buckets=_BUCKETS, kinds=("semantic",)) -> None:
        """Run each kind's scan once per batch-size bucket with zero
        queries (results discarded), so the first real queries find the
        kernels built, each bucket's semantic selection run once and the cached
        sample and meta in place.  Callers skip an empty store; any other
        failure (a kernel that does not build or launch) raises."""
        for kind in kinds:
            for b in buckets:
                queries = np.zeros((b, dim), dtype=np.uint8)
                if kind == "semantic":
                    self._semantic_scan(queries)
                else:
                    self._scan_fns[kind](queries, self.k, self.max_distance)

    def register_kind(self, kind: str, fn: Callable) -> None:
        """Register a batched scan callable for a modality:
        ``fn(queries_u8 [B, D], k, max_distance) -> (dist, idx)``.

        Callables that also accept an ``n_real`` keyword get the real
        request count of the zero-padded bucket — scans with a host
        rescore stage use it to skip rescoring the padding, like the
        built-in semantic int4 path.
        """
        try:
            takes_n_real = "n_real" in inspect.signature(fn).parameters
        except (TypeError, ValueError):  # builtins / partials without a signature
            takes_n_real = False
        self._scan_fns[kind] = fn
        self._scan_n_real[kind] = takes_n_real

    @property
    def kinds(self) -> Tuple[str, ...]:
        return ("semantic",) + tuple(sorted(self._scan_fns))

    def submit(
        self,
        query_u8: np.ndarray,
        timeout: Optional[float] = 60.0,
        kind: str = "semantic",
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Blocking query: u8 [D] → (dist [k], idx [k]); a scan error in
        the collector is raised here."""
        if kind != "semantic" and kind not in self._scan_fns:
            raise KeyError(f"no scan fn registered for kind {kind!r}")
        req = _Request(query=np.asarray(query_u8, dtype=np.uint8), kind=kind)
        self._q.put(req)
        if not req.event.wait(timeout):
            raise TimeoutError("scan service timed out")
        if req.error is not None:
            raise req.error
        return req.dist, req.idx

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)

    # ------------------------------------------------------------------ #

    def _collector(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            batch: List[_Request] = [first]
            t0 = time.monotonic()
            while len(batch) < self.max_batch:
                remaining = self.max_wait_s - (time.monotonic() - t0)
                if remaining <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=remaining))
                except queue.Empty:
                    break
            # One device pass per (kind, query width) group; widths can
            # differ for compat phashes and must not be zero-padded into
            # one another.
            groups: Dict[Tuple[str, int], List[_Request]] = {}
            for r in batch:
                groups.setdefault((r.kind, r.query.shape[0]), []).append(r)
            for (kind, _w), grp in groups.items():
                self._run_group(kind, grp)

    def _run_group(self, kind: str, batch: List[_Request]) -> None:
        try:
            m = len(batch)
            queries = np.zeros((_bucket(m), batch[0].query.shape[0]), dtype=np.uint8)
            for i, r in enumerate(batch):
                queries[i] = r.query
            with timed(f"serving.batched_scan.{kind}"):
                if kind == "semantic":
                    dist, idx = self._semantic_scan(queries, n_real=m)
                elif self._scan_n_real.get(kind):
                    dist, idx = self._scan_fns[kind](
                        queries, self.k, self.max_distance, n_real=m
                    )
                else:
                    dist, idx = self._scan_fns[kind](queries, self.k, self.max_distance)
            dist, idx = _host(dist), _host(idx)
            for i, r in enumerate(batch):
                r.dist = dist[i]
                r.idx = idx[i]
                r.event.set()
            self.batches_run += 1
            self.queries_served += m
        except Exception as e:  # noqa: BLE001 — every waiting caller gets it
            for r in batch:
                r.error = e
                r.event.set()

    def _semantic_scan(self, queries: np.ndarray, n_real: Optional[int] = None):
        index, sample, meta = self._provider()
        q = torch.from_numpy(queries).to(index.device)
        if not isinstance(index, PackedSemantic4Index):
            return cosine_scan_topk_auto(
                q, index, k=self.k, max_distance=self.max_distance,
                sample=sample, row_meta=meta,
            )

        def scan(c, md):
            d, i = cosine4_scan_topk_auto(
                q, index, k=c, max_distance=md, sample=sample, meta=meta,
            )
            return _host(d), _host(i)

        rows = self._rerank_rows() if self._rerank_rows else None
        if rows is None:
            return scan(self.k, self.max_distance)
        # Top-C candidates in the int4 metric (unbounded — WHERE dist <
        # max applies in u8 space after rescoring), exact-u8 rescore from
        # the host mirror, trimmed to the batch's n_real rows (the scan
        # runs on the padded bucket; the host rescore must not).
        return scan_with_u8_rerank(
            scan, queries, rows, k=self.k, max_distance=self.max_distance, n_real=n_real,
        )
