#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pixelbox_tpu_torch) on one card.

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and exits non-zero):

1. Device: requires ``torch.cuda.is_available()``; prints the card and
   ``nvidia-smi`` name/power limit; holds the exact numerics (TF32 off,
   cuDNN deterministic, benchmark off).
2. Build: compiles ``pixelbox_tpu_torch/csrc/fused_scan.cu``,
   ``csrc/tc_scan.cu`` (the tensor-core K1a, K4a, K2a, K1b, K2b and K4b),
   ``csrc/tc_theta.cu`` (the θ stage), ``csrc/ivf_probe.cu`` (K5, the IVF
   probe, its work list, the first port's K5 and the gathered mode) and ``csrc/breakdown.cu`` (the
   tensor-core ladder and the first port's) for sm_90a, one nvcc each, in
   parallel; logs the tensor-core and select kernels' registers and
   spills and ptxas's wgmma warnings.  Meanwhile the main thread makes
   the seeded host data of phases 3-6 (phase 3's rows, the hash-only
   records that grow phases 4-6's libraries to 1,048,576 rows).
3. Kernels vs plain at the main shapes (1,048,576 rows × 128, k = 100,
   Q ∈ {1, 8, 256}) in five cases: θ from the sample, θ = max_distance, a
   max_distance filter that excludes rows, 1% invalid rows, and a tie
   flood that must defeat the proof and be repaired.  Every kernel launch
   the path makes is recorded and replayed through the kernel's plain
   PyTorch version on the same inputs — outputs must be bit-identical —
   and the end-to-end results must equal the exact scan, and the numpy
   oracle on a sub-sample of queries.  Kernel and plain medians are timed
   with CUDA events; the tensor-core K1a at Q ∈ {1, 8, 256} (and 2048 in
   3c) in turns against the ``__dp4a`` kernel it replaced, per call and
   device-only; the tensor-core K1b in turns against the first port's
   ``__dp4a`` chunk kernel (their exact scans held equal, K1c's launches
   counted) at a repair bucket (Q = 8 over the 1M rows) and at the
   small-library gate: the first 131,072 rows, every 97th a tombstone,
   Q = 1 and 256 through ``cosine_scan_topk_auto`` (which must take K1b +
   K1c, replayed bit-identical, equal to the exact scan and the oracle);
   K1c (``lex_topk`` on the select kernel) on the main pass's buffer
   (256 × 4,096 → 100) and a repair's K1b partials (8 × 12,800 → 100) in
   turns against the first port's re-launch chain, ``torch.topk`` and
   ``torch.sort`` of the keys, after holding the chain's result equal;
   the θ stage (``sample_theta`` on the θ kernel, two launches) at
   Q ∈ {1, 256} over the 65,536-row sample in turns against the first
   port's composition (``sample_theta_chain``: the plain-torch
   mini-sample, K1a and K1c), per call and device-only.
3b. Hamming kernels vs plain at the phash's published width (1,048,576
   rows × 32 bytes, k = 100, Q ∈ {1, 8, 256}, and 2048 in the first and
   the last case) in seven cases: θ from the sample, θ = max_distance,
   max_distance 0.1, 1% tombstones, the u8 wrap, byte_limit 24 with a
   width-group mask, and an 8,192-row tie flood that must defeat the
   proof and be repaired.  Replayed and
   checked as in phase 3, with the proof rate and the repaired count
   printed per Q; the tensor-core K2a timed at every Q in turns against the
   ``__popc`` kernel it replaced; the tensor-core K2b at a mesh shard's
   duplicate batch (256 stored rows × 262,144 rows, k = 8, max_distance
   0.1) and at Q ∈ {8, 256} over the 1M rows (k = 100), in turns against
   the first port's ``__popc`` chunk kernel (their exact scans held equal),
   per call and device-only, and the exact scan as a whole (+ K1c, its
   launches counted).
3c. Large batches (the JAX package's buffer-select kernel, Q > 1024):
   cosine ``auto`` at Q = 2048 over phase 3's 1,048,576 × 128 rows, every
   launch replayed through its plain version.
3d. int4 kernels vs plain over phase 3's rows packed to 4 bits (1,048,576
   × 64 bytes), k ∈ {100, 400} (400 = the rerank's candidate count),
   Q ∈ {1, 8, 256, 2048}, both query modes (asym, sym), in five cases: θ
   from the sample, θ = max_distance, a max_distance filter, 1%
   tombstones, and a tie flood that must be repaired.  Every launch is
   replayed bit-identical through its plain version; end results must
   equal the plain exact scan, and the numpy oracle on one query per case
   and mode; the proof rate is printed per Q, and every query a non-flood
   case leaves unproven is explained: its exact count against the cap, its
   θ and k-th distance, and the same query rerun alone (Q = 1).  At k = 400, Q ∈ {1, 8,
   256} the cos-key pass (K4d + K1e) runs too, with the same checks.  The
   tensor-core K4a is timed in turns against the ``__dp4a`` kernel it
   replaced at Q ∈ {1, 8, 256, 2048}, both modes, and K4d against K4a;
   the tensor-core K4b at the int4 duplicates batch (256 stored rows ×
   the 65,536-row cut, k = 400, unbounded) and at Q = 8 over the 1M rows
   (k = 400), both modes, as K2b in 3b;
   K1c on the 256 × 16,384 → 400 buffer against the chain; the whole
   auto scan (asym, k = 400) with ``epilogue="dist"`` against ``"cos"``
   at the batching service's buckets 1/8/32/128/256.
3e. The cos-key kernels (K1d, K1e) inside phase 3's loop: in every case
   with a threshold pass, ``cosine_scan_topk_auto(epilogue="cos")`` at
   Q ∈ {1, 8, 256}, every launch replayed bit-identical, the results equal
   to ``epilogue="dist"``, the exact scan and the oracle; the proof rate
   per Q; K1d timed against K1a in turns, and K1e; the whole auto scan
   with ``epilogue="dist"`` against ``"cos"`` at the batching service's
   buckets 1/8/32/128/256, in turns.
4. Engine: indexes 32 seeded images with EfficientNet-B0 at 224²/dim 128
   from a seeded checkpoint (then 64 more, warm), checks the exact-0.0
   self-match, grows the store to 1,047,552 rows with seeded hash-only
   records (phase 6b's append of 1,024 fills it to 1,048,576 within its
   capacity), runs ``similar`` under ``auto`` and ``pallas`` — counting
   kernel launches from zero, and splitting its latency into the engine's
   timing spans — and holds the results against the exact scan and the
   plain (CPU) path.
5. Phash engine: indexes seeded images under ``phash_compat=False`` and a
   second library with mixed aspect ratios under ``True``; ``phash-similar``
   (the CLI) returns an indexed image at exactly 0.0 in both, and the
   first library's ``similar --scan-mode ivf`` (the CLI, on the card) too,
   its ``similar-id`` at full nprobe = the plain (CPU) path; grows the
   phash store to 1,048,576 rows with seeded, clustered hash-only
   records; times ``query_by_phash`` with the engine's spans; runs
   ``find_duplicate_pairs`` by phash over the whole phash store and by
   semantic over phase 4's store, holding sampled batches against the
   plain path — counting kernel launches from zero.
6. int4 engine: a ``semantic_precision="int4"`` library on phase 4's
   checkpoint (32 images, grown to 1,048,576 rows with seeded hash-only
   records); ``similar`` under ``auto`` with the exact-u8 rerank, split
   into the int4 scan and the host rerank, checked against the plain
   (CPU) path, with recall@10 against the u8 exact scan; the same query
   with the rerank off against the numpy oracle; ``duplicates`` by
   semantic over a 16,384-row int4 library (a cut of the 1M library)
   with its scan and rerank timed apart — counting launches from zero.
6b. IVF (``scan_mode = "ivf"``, default clusters ~4·sqrt(N)) on phase
   4's engine: the train and build spans; ``similar`` end to end (median
   of 5 after the first query); ``ivf_scan_topk`` at Q ∈ {1, 8, 256} at
   the default nprobe (and the device kernels a call, by
   ``torch.profiler``), and K5 (``ivf_probe_topk``, with its work list
   ``ivf_probe_invert`` where Q · nprobe > clusters) in turns with the first port's
   ``ivf_probe_collect_dp4a``, a call and on the device, warm and with
   L2 flushed, each alone and with its K1c, against its bound and its
   plain version; at full nprobe (Q = 8)
   the result equal to ``cosine_scan_topk_auto`` bit for bit; recall@10
   at the default nprobe over 256 perturbed stored rows against the
   exact scan; an append of 1,024 rows that must extend the spill
   (``engine.ivf_extend``, no ``engine.ivf_build``), full nprobe still
   equal to the exact scan; a second engine on the same library that
   must read the ``.ivf.npz`` sidecar (no ``engine.ivf_train``).  On phase
   6's int4 engine: ivf with the rerank at full nprobe equal to the flat
   int4 path, and ``tune_nprobe`` once at target 0.99 (the device rerank:
   K5's gathered mode + K1c).  Then k past MAX_K once per kind: u8 k =
   1,500, int4 user k = 300 (C = 1,200) and phash k = 1,500, each equal
   to its plain (CPU) version.  Launches counted from zero around each
   main-path step and every one replayed bit-identical through its plain
   version.
7. Serving: phase 4's 1M-row engine behind the port's HTTP server
   (``serve.make_server`` on 127.0.0.1:0, its batching service warmed at
   every bucket) and phase 5's 1M-row phash library behind its own
   (and a full bucket into the service's ``ivf`` kind, equal to the
   engine's ``_ivf_query``):
   one concurrent burst of 64 ``GET /api/similar?id=``, 16 ``POST
   /api/similar`` and 16 ``POST /api/phash-similar``, every response
   equal to the engine's direct call; then ``/api/tag`` → ``search
   tag:``, ``/api/remove`` of a top hit and an append of 1,024 seeded rows,
   which a second burst must see; a full bucket (256 concurrent submits)
   straight into the service against its dist-path scan, then (uncounted)
   the same bucket served again on the distance, which the service takes
   at every bucket, and on the cos key (K1d + K1e), in turns: results
   equal, the burst's wall split at the service's batch (4 rounds, each
   epilogue first in two); then a burst and
   a full bucket on phase 6's int4 engine (rerank on), served the same two
   ways in turns (K4a against K4d + K1e) — counting launches from zero
   around each burst; no served batch takes the cos key.
8. Mesh serving (runs before phase 7, which keeps its stores as phase 6
   left them): phases 4–6's 1M-row u8, phash and int4 libraries put on a
   4-shard mesh through ``Engine.serve_on_mesh`` (the visible cards
   round-robin; with one card all four shards on it, 262,144 rows each):
   ``similar`` (auto; pallas and exact modes; an upload; ivf at full
   nprobe on the sharded IVF index),
   ``phash-similar`` at 32 B and at 24 B (the mixed-width path), int4
   ``similar`` with the rerank, and 16 batches of 256 of the phash and u8
   duplicate passes (8 of the int4 one) — each equal to the same engine
   on one device, and to the numpy oracle on sampled queries.  Every
   per-shard and merge launch is replayed bit-identical through its plain
   version; the sharded auto is timed against the one-device auto at
   Q ∈ {1, 8, 256} in turns, and one shard's K1a and the merge K1c (with
   ``torch.sort`` of its keys, in turns with the chain) at Q = 256 —
   counting launches from zero around the mesh path.
8b. Mesh mutations (after phase 7): the u8 library as phase 7 left it
   (grown past 1M rows by its append) back on the mesh, then a tag, a
   removal (one full reshard) and a 1,024-row append within the capacity
   (a delta sync), each seen by the next query, which then equals the
   engine on one device; launches counted from zero and replayed.
9. The breakdown ladder: ``tools.measure_breakdown.run()`` at its full
   shape (Q = 256 × 1,048,576 × 128, TILE 8,192, 20 repeats) on the
   tensor-core ladder — counting launches from zero around it — then each
   rung once at that shape on rows planted near the queries,
   bit-identical to its plain version and to the first port's
   ``__dp4a`` ladder, and timed in turns against it (uncounted).

Phases 4-9 must run every u8 and int4 collect and chunk top-k at D = 128
and every Hamming collect and chunk top-k at 32 B on the tensor-core
kernels, every θ stage on the θ kernel, every top-k on the select kernel
and the ladder on the tensor-core one (their ``__dp4a`` / ``__popc``
predecessors, the first port's ``lex_topk_segments``,
``sample_theta_chain`` and plain-torch mini-sample on the card and
``breakdown_ladder_dp4a`` launched no time).  The last lines are
the card's nvidia-smi line, the kernels' JSON summary (time, plain time,
bound, library time per kernel; the tensor-core collects with their
predecessor's time and error against their outputs and a per-Q table,
K1c per shape with the chain's) and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

N_ROWS = 1 << 20
DIM = 128
PH_BYTES = 32  # 16×16 phash bits (phash.rs:4-5)
K = 100
QS = (1, 8, 256)
PH_QS = (1, 8, 256, 2048)
MAIN_Q = 256   # the main pass's timed batch
SERVICE_BUCKETS = (1, 8, 32, 128, 256)  # serving/service.py's batch shapes
REPAIR_Q = 8   # a repair bucket
BIG_Q = 2048   # past the JAX package's carry kernels (buffer select)
FLOOD = (123456, 600000, 8192)  # tie flood: source row, first copy, copies
SEED = 20261016
#: Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense int8
#: tensor-core ops/s, f32 outside the tensor cores (scalar compares).
HBM_BPS = 3.35e12
INT8_OPS = 1979e12
F32_OPS = 67e12
INT4_KS = (100, 400)   # k = 100, and C = 400 candidates of the exact-u8 rerank
INT4_DUP_ROWS = 1 << 14  # the int4 duplicates library: a cut of the 1M one
APPEND_ROWS = 1024       # phases 7 and 8: the append between their queries
MESH_SHARDS = 4          # phase 8: shards over the visible cards (4 on one card)
DUP_BATCHES = 16         # phase 8: duplicate batches of 256 compared on the mesh
MESH_SHARD_ROWS = N_ROWS // MESH_SHARDS  # phase 8: a shard's rows on one card
SMALL_ROWS = 131072      # phase 3: a library at ops/scan.py's K1b gate (4 x 32,768 rows)
IVF_QS = (1, 8, 256)     # phase 6b: the IVF scan's timed batches


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# --------------------------------------------------------------------- #
# Seeded data


def clustered_hashes(rng, n, d, n_centers=4096, noise=0.35):
    """Embedding-like u8 hashes: quantized tanh of noisy cluster centres."""
    import numpy as np

    from pixelbox_tpu_torch.ops.oracle import quantize_embedding_np

    centers = rng.standard_normal((n_centers, d), dtype=np.float32)
    out = np.empty((n, d), np.uint8)
    step = 1 << 18
    for s in range(0, n, step):
        e = min(n, s + step)
        x = centers[rng.integers(0, n_centers, e - s)]
        x = x + noise * rng.standard_normal((e - s, d), dtype=np.float32)
        out[s:e] = quantize_embedding_np(np.tanh(x))
    return out


def clustered_phashes(rng, n, h, n_centers=65536):
    """phash-like rows: random centres with ~1/8 of their bits flipped."""
    import numpy as np

    centers = rng.integers(0, 256, (n_centers, h), dtype=np.uint8)
    out = centers[rng.integers(0, n_centers, n)]
    # AND of three random bytes: each noise bit is set with p = 1/8.
    noise = rng.integers(0, 256, (n, h), dtype=np.uint8)
    noise &= rng.integers(0, 256, (n, h), dtype=np.uint8)
    noise &= rng.integers(0, 256, (n, h), dtype=np.uint8)
    return out ^ noise


def flip_bits(rng, rows, flips=6):
    import numpy as np

    out = rows.copy()
    for r in range(out.shape[0]):
        bits = rng.choice(8 * out.shape[1], flips, replace=False)
        out[r, bits // 8] ^= (1 << (bits % 8)).astype(np.uint8)
    return out


def perturb(rng, rows, flips=6):
    import numpy as np

    q = rows.astype(np.int32)
    for r in range(q.shape[0]):
        cols = rng.choice(q.shape[1], flips, replace=False)
        q[r, cols] = np.clip(q[r, cols] + rng.integers(-60, 61, flips), 0, 255)
    return q.astype(np.uint8)


def synthetic_records(prefix, key, rows):
    """Hash-only records ``<prefix>_<j>`` holding ``rows[j]`` as ``key``."""
    from pixelbox_tpu_torch.records import IndexedImage

    return [IndexedImage(filename=f"{prefix}_{j:07d}.png", path=f"/synthetic/{prefix}_{j:07d}.png",
                         **{key: rows[j]}) for j in range(len(rows))]


def insert_synthetic(eng, records):
    """Insert records through the engine's batch insert, 131,072 a batch."""
    step = 1 << 17
    for s in range(0, len(records), step):
        eng.insert_records_batch(records[s : s + step])


def host_data():
    """Phases 3-6's seeded host data, made while the kernels build (the
    main thread only waits on nvcc then): phase 3's rows and queries (and
    its generator, which phase 3 goes on drawing from), and the hash-only
    records that grow phases 4, 5 and 6's libraries to N_ROWS (each phase
    inserts the first as many as its library has room for)."""
    import numpy as np

    rng3 = np.random.default_rng(SEED)
    db = clustered_hashes(rng3, N_ROWS, DIM)
    base_q = perturb(rng3, db[rng3.integers(0, N_ROWS, max(QS))])
    base_q[1] = db[4242]  # an exact copy: distance 0 at row 4242
    rng = np.random.default_rng(SEED + 10)
    ph = clustered_phashes(rng, N_ROWS, PH_BYTES, n_centers=262144)
    ph[1::1000] = flip_bits(rng, ph[0::1000][: len(ph[1::1000])], 4)  # near-dups
    growth = {
        "syn": synthetic_records("syn", "visual_hash", clustered_hashes(rng, N_ROWS - APPEND_ROWS, DIM)),
        "ph": synthetic_records("ph", "phash", ph),
        "syn4": synthetic_records("syn4", "visual_hash", near_dup_hashes(rng, N_ROWS)),
    }
    return (rng3, db, base_q), growth


def oracle_topk(q, db, valid, k, md):
    """numpy oracle over the valid rows, ids mapped back to row numbers
    (dropping rows keeps the ascending-row-id tie order)."""
    import numpy as np

    from pixelbox_tpu_torch.ops.oracle import cosine_scan_topk_np

    keep = np.nonzero(valid)[0]
    od, oi = cosine_scan_topk_np(q, db[keep], k=k, max_distance=md)
    return od, np.where(oi >= 0, keep[np.maximum(oi, 0)], -1).astype(np.int32)


# --------------------------------------------------------------------- #
# Phase 3 helpers: record every kernel call the path makes


class Recorder:
    """Wraps the kernel wrappers of ops.fused_scan; records inputs and
    outputs so each call can be replayed through its plain version.  The
    threshold pass runs eager inside (a graph's replay runs no wrapper)."""

    NAMES = (
        "cosine_threshold_collect", "cosine_chunk_topk", "lex_topk_select",
        "hamming_threshold_collect", "hamming_chunk_topk",
        "cosine4_threshold_collect", "cosine4_chunk_topk",
        "cosine_coskey_collect", "cosine4_coskey_collect", "coskey_rescore",
        "sample_theta",
    )

    #: K5, its work list and its gathered mode, whose wrappers live in
    #: ops/ivf.py.
    IVF_NAMES = ("ivf_probe_topk", "ivf_probe_invert", "ivf_gathered_collect")

    def __init__(self, fs):
        from pixelbox_tpu_torch.ops import ivf

        self.slots = [(fs, n) for n in self.NAMES] + [(ivf, n) for n in self.IVF_NAMES]
        self.orig = {(m, n): getattr(m, n) for m, n in self.slots}
        self.calls = []
        self.fs = fs

    def __enter__(self):
        from pixelbox_tpu_torch.ops.scan_graphs import GraphCache

        class Eager(GraphCache):
            def _on_card(self, t):
                return False

        for m, n in self.slots:
            setattr(m, n, self._wrap(n, self.orig[(m, n)]))
        self.graphs, self.fs.SCAN_GRAPHS = self.fs.SCAN_GRAPHS, Eager(self.fs.LAUNCHES)
        return self

    def __exit__(self, *exc):
        for m, n in self.slots:
            setattr(m, n, self.orig[(m, n)])
        self.fs.SCAN_GRAPHS = self.graphs

    def _wrap(self, name, fn):
        def wrapper(*args, **kwargs):
            out = fn(*args, **kwargs)
            self.calls.append((name, args, kwargs, out))
            return out

        return wrapper


class PlainOnCard:
    """Counts plain versions run on the card outside replays: the θ
    stage's old composition (``sample_theta_chain`` and the plain-torch
    mini-sample ``mini_sample_theta`` on a CUDA sample) and K5's plain
    versions (``ivf_probe_topk_plain``, ``ivf_probe_collect_plain``,
    ``ivf_probe_invert_plain``, ``ivf_gathered_collect_plain`` on CUDA
    tensors).  Phases 4-9 must call none of them."""

    NAMES = ("sample_theta_chain", "mini_sample_theta")
    IVF_NAMES = ("ivf_probe_topk_plain", "ivf_probe_collect_plain", "ivf_probe_invert_plain",
                 "ivf_gathered_collect_plain")
    counts = {n: 0 for n in NAMES + IVF_NAMES}
    _replay = 0

    @classmethod
    def install(cls, fs):
        from pixelbox_tpu_torch.ops import ivf

        for n in cls.NAMES:
            setattr(fs, n, cls._wrap(n, getattr(fs, n)))
        for n in cls.IVF_NAMES:
            setattr(ivf, n, cls._wrap(n, getattr(ivf, n)))

    @classmethod
    def _wrap(cls, name, fn):
        def wrapper(first, *args, **kwargs):
            # K5 plain: (q_codes, ...) or (bids, ...); the θ stage: (qk, smp, ...)
            on_card = first.is_cuda if name in cls.IVF_NAMES else args[0].data.is_cuda
            if on_card and not cls._replay:
                cls.counts[name] += 1
            return fn(first, *args, **kwargs)

        return wrapper

    @classmethod
    def reset(cls):
        for n in cls.NAMES:
            cls.counts[n] = 0

    @classmethod
    def replaying(cls):
        from contextlib import contextmanager

        @contextmanager
        def scope():
            cls._replay += 1
            try:
                yield
            finally:
                cls._replay -= 1

        return scope()


def same_collect(fs, what, out, ref, cap):
    """Hold a collect's (count, cand, cand_i) against another run's on the
    same inputs: counts equal, and the sorted (dist, row) sets equal where
    count <= cap.  Returns the two compared distance tensors."""
    import torch

    c1, d1, i1 = out
    c2, d2, i2 = ref
    check(torch.equal(c1, c2), f"{what}: counts differ")
    ok = c1 <= cap
    lens = torch.clamp(c1, max=cap)
    s1 = fs.lex_topk_segments_plain(d1, i1, cap, lens, segment=cap)
    s2 = fs.lex_topk_segments_plain(d2, i2, cap, lens, segment=cap)
    check(torch.equal(s1[0][ok], s2[0][ok]), f"{what}: distances differ")
    check(torch.equal(s1[1][ok], s2[1][ok]), f"{what}: row ids differ")
    return s1[0][ok], s2[0][ok]


def max_abs_err(a, b):
    """Largest |a − b| over the places where both are finite (0.0 if none)."""
    import torch

    fin = torch.isfinite(a) & torch.isfinite(b)
    return float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) else 0.0


def replay(fs, call):
    """Re-run one recorded call through the plain version; returns
    (max_abs_err over compared finite values)."""
    import torch

    name, args, kwargs, out = call
    if name == "ivf_probe_invert":
        from pixelbox_tpu_torch.ops import ivf

        with PlainOnCard.replaying():
            want = ivf.ivf_probe_invert_plain(*args, **kwargs)
        got, want = ivf.probe_work_pairs(out.cpu()), ivf.probe_work_pairs(want.cpu())
        check(all(torch.equal(x, y) for x, y in zip(got, want)),
              "ivf_probe_invert differs from plain (up to the order of a bucket's pairs)")
        return 0.0
    if name in Recorder.IVF_NAMES:
        from pixelbox_tpu_torch.ops import ivf

        with PlainOnCard.replaying():
            d2, i2 = getattr(ivf, name + "_plain")(*args, **kwargs)
        check(torch.equal(out[0], d2) and torch.equal(out[1], i2), f"{name} differs from plain")
        a, b = out[0], d2
    elif name == "coskey_rescore":
        d2 = fs.coskey_rescore_plain(*args)
        check(torch.equal(out, d2), "coskey_rescore differs from plain")
        a, b = out, d2
    elif name == "sample_theta":
        with PlainOnCard.replaying():
            t2 = fs.sample_theta_plain(*args, **kwargs)
            if not torch.equal(out, t2):
                # What a later reader needs to tell a race from a spec
                # difference: the queries, both values, the plain θ0, and
                # the kernel again on the same inputs.
                bad = (out != t2).nonzero().flatten()[:8]
                again = fs.sample_theta(*args, **kwargs)
                theta0 = fs.mini_sample_theta(*args, **kwargs)
                log(f"sample_theta differs from plain at {bad.numel()} of {out.numel()} queries "
                    f"{bad.tolist()}: kernel {out[bad].tolist()}, plain {t2[bad].tolist()}, plain θ0 "
                    f"{theta0[bad].tolist()}; the kernel again {again[bad].tolist()} "
                    f"(= plain: {torch.equal(again, t2)})")
        check(torch.equal(out, t2), "sample_theta differs from plain")
        a, b = out, t2
    elif name.endswith("collect"):
        a, b = same_collect(fs, f"{name} against plain", out,
                            getattr(fs, name + "_plain")(*args), args[-1])
    elif name.endswith("chunk_topk"):
        d2, i2 = getattr(fs, name + "_plain")(*args, **kwargs)
        check(torch.equal(out[0], d2) and torch.equal(out[1], i2), f"{name} differs from plain")
        a, b = out[0], d2
    else:
        d2, i2 = fs.lex_topk_select_plain(*args, **kwargs)
        check(torch.equal(out[0], d2) and torch.equal(out[1], i2), "K1c differs from plain")
        a, b = out[0], d2
    return max_abs_err(a, b)


def median_ms(fn, reps=10):
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def interleaved_ms(fns, reps=10):
    """Medians of CUDA-event times of each function, run in turns (one of
    each per round) so that clock and neighbour drift hit them alike."""
    import torch

    for f in fns:
        f()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for _ in range(reps):
        for j, f in enumerate(fns):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            f()
            e.record()
            torch.cuda.synchronize()
            times[j].append(s.elapsed_time(e))
    return [statistics.median(t) for t in times]


def gpu_ms(fns, reps=20, rounds=3):
    """Device time a call, of each function in turns: a sleep kernel first
    lets the host queue ``reps`` back-to-back calls, so the CUDA events
    bracket device work only (the wrappers' host cost is hidden); the
    least of ``rounds`` rounds."""
    import torch

    for f in fns:
        f()
    torch.cuda.synchronize()
    best = [float("inf")] * len(fns)
    for _ in range(rounds):
        for j, f in enumerate(fns):
            torch.cuda._sleep(20_000_000)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(reps):
                f()
            e.record()
            torch.cuda.synchronize()
            best[j] = min(best[j], s.elapsed_time(e) / reps)
    return best


#: The tensor-core kernels and the ones they replaced, kept as timing
#: references (ops/fused_scan.py).
PREVIOUS = {"cosine_threshold_collect": "cosine_threshold_collect_dp4a",
            "cosine_chunk_topk": "cosine_chunk_topk_dp4a",
            "cosine4_threshold_collect": "cosine4_threshold_collect_dp4a",
            "hamming_threshold_collect": "hamming_threshold_collect_popc",
            "hamming_chunk_topk": "hamming_chunk_topk_popc",
            "cosine4_chunk_topk": "cosine4_chunk_topk_dp4a"}


def time_against_previous(fs, call, smi, tag, err, reps=10):
    """A tensor-core collect's recorded call: its predecessor held against
    the recorded outputs on the same inputs (its error in ``err`` under its
    own name), time_kernel's numbers (single calls), then the kernel
    against its predecessor in turns — single-call medians and device-only
    times."""
    name, args, kwargs, out = call
    prev = PREVIOUS[name]
    a, b = same_collect(fs, f"{prev} against {name}", getattr(fs, prev)(*args, **kwargs),
                        out, args[-1])
    err[prev] = max(err[prev], max_abs_err(a, b))
    st = time_kernel(fs, call, smi, tag, reps=reps)
    new, old = getattr(fs, name), getattr(fs, PREVIOUS[name])
    st["ms"], st["previous_ms"] = interleaved_ms(
        [lambda: new(*args, **kwargs), lambda: old(*args, **kwargs)], reps)
    st["gpu_ms"], st["previous_gpu_ms"] = gpu_ms(
        [lambda: new(*args, **kwargs), lambda: old(*args, **kwargs)], reps=max(2, 2 * reps))
    qn = args[0].shape[0]
    log(f"{tag} {name} Q={qn} vs {PREVIOUS[name]} (same counts and candidates) in turns: {st['ms']:.4f} / "
        f"{st['previous_ms']:.4f} ms a call ({st['previous_ms'] / st['ms']:.2f}x), device only "
        f"{st['gpu_ms']:.4f} / {st['previous_gpu_ms']:.4f} ms ({st['previous_gpu_ms'] / st['gpu_ms']:.2f}x); "
        f"bound {st['bound_ms']:.4f} ms ({smi})")
    return st


def time_chunk_against_previous(fs, call, smi, tag, err, reps=10):
    """A tensor-core chunk top-k's call (K1b / K2b / K4b): the first port's
    kernel on the same inputs, the exact scan from its partials (K1c)
    held equal to the one from the new kernel's (its error under its own
    name); time_kernel's numbers (single calls; the bound of the exact
    scan's own work); then in turns, per call and device-only, the kernel
    against the first port's, and the exact scan as a whole (chunk kernel
    + K1c, K1c's launches counted) against the first port's."""
    import torch

    name, args, kwargs, out = call
    prev = PREVIOUS[name]
    new, old = getattr(fs, name), getattr(fs, prev)
    qn, k = args[0].shape[0], args[-1]

    def finish(part):
        return fs.lex_topk(part[0].reshape(qn, -1), part[1].reshape(qn, -1), k)

    def k1c_launches(part):
        before = fs.launch_counts()["lex_topk_select"]
        finish(part)
        return fs.launch_counts()["lex_topk_select"] - before

    old_out = old(*args, **kwargs)
    a, b = finish(out), finish(old_out)
    check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
          f"{tag} {name}: the exact scan from {prev}'s partials differs")
    err[prev] = max(err[prev], max_abs_err(a[0], b[0]))
    st = time_kernel(fs, call, smi, tag, reps=reps)
    st["k1c_launches"], st["previous_k1c_launches"] = k1c_launches(out), k1c_launches(old_out)
    st["chunks"], st["previous_chunks"] = out[0].shape[1], old_out[0].shape[1]
    fns = [lambda: new(*args, **kwargs), lambda: old(*args, **kwargs)]
    scans = [lambda: finish(new(*args, **kwargs)), lambda: finish(old(*args, **kwargs))]
    st["ms"], st["previous_ms"] = interleaved_ms(fns, reps)
    st["gpu_ms"], st["previous_gpu_ms"] = gpu_ms(fns, reps=max(2, 2 * reps))
    st["scan_ms"], st["previous_scan_ms"] = interleaved_ms(scans, reps)
    st["scan_gpu_ms"], st["previous_scan_gpu_ms"] = gpu_ms(scans, reps=max(2, 2 * reps))
    log(f"{tag} {name} Q={qn} x {args[2 if name.startswith('hamming') else 5].shape[0]:,} k={k} vs {prev} "
        f"(same exact scan) in turns: {st['ms']:.4f} / {st['previous_ms']:.4f} ms a call, device only "
        f"{st['gpu_ms']:.4f} / {st['previous_gpu_ms']:.4f} ms ({st['previous_gpu_ms'] / st['gpu_ms']:.2f}x); "
        f"the exact scan (+ K1c: {st['k1c_launches']} / {st['previous_k1c_launches']} launches over "
        f"{st['chunks']} / {st['previous_chunks']} chunks) {st['scan_ms']:.4f} / {st['previous_scan_ms']:.4f} "
        f"ms a call, device {st['scan_gpu_ms']:.4f} / {st['previous_scan_gpu_ms']:.4f} ms; bound "
        f"{st['bound_ms']:.4f} ms ({st['bound_by']}); dot only {st['dot_only_ms']:.4f} ms ({smi})")
    return st


def chunk_by_shape(st):
    return {key: st[key] for key in (
        "ms", "previous_ms", "gpu_ms", "previous_gpu_ms", "scan_ms", "previous_scan_ms", "scan_gpu_ms",
        "previous_scan_gpu_ms", "k1c_launches", "previous_k1c_launches", "chunks", "previous_chunks",
        "plain_ms", "bound_ms", "bound_by", "dot_only_ms")}


def k1c_args(call):
    """(dist, idx, k, lens) of a recorded K1c call."""
    _, args, kwargs, _ = call
    return (*args[:3], args[3] if len(args) > 3 else kwargs.get("lens"))


def time_k1c(fs, call, smi, tag, err, reps=10):
    """K1c (lex_topk on the select kernel: one launch, two past
    SELECT_SLOTS entries a row) on a recorded call's row, against the first
    port's re-launch chain (lex_topk_segments_chain) in turns — single-call
    medians and device-only times — after holding the chain's result equal
    to it (its error under lex_topk_segments); the plain version, the
    bound, and torch.topk / torch.sort of the (dist, id) keys."""
    import torch

    dist, idx, k, lens = k1c_args(call)
    new = lambda: fs.lex_topk(dist, idx, k, lens)  # noqa: E731
    old = lambda: fs.lex_topk_segments_chain(dist, idx, k, lens)  # noqa: E731
    before = fs.launch_counts()
    got = new()
    launches = fs.launch_counts()["lex_topk_select"] - before["lex_topk_select"]
    prev = old()
    check(torch.equal(got[0], prev[0]) and torch.equal(got[1], prev[1]),
          f"{tag} K1c: the first port's chain differs from lex_topk_select")
    err["lex_topk_segments"] = max(err["lex_topk_segments"], max_abs_err(got[0], prev[0]))
    keys = fs._keys(dist, idx, lens)
    fns = [new, old, lambda: torch.topk(keys, k, dim=1, largest=False, sorted=True),
           lambda: torch.sort(keys, dim=1)]
    st = {"launches_a_call": launches}
    st["ms"], st["previous_ms"], st["library_ms"], st["sort_ms"] = interleaved_ms(fns, reps)
    (st["gpu_ms"], st["previous_gpu_ms"], st["library_gpu_ms"],
     st["sort_gpu_ms"]) = gpu_ms(fns, reps=max(2, 2 * reps))
    st["plain_ms"] = median_ms(lambda: fs.lex_topk_select_plain(dist, idx, k, lens), reps)
    nbytes, ops, peak = work_of("lex_topk_select", (dist, idx, k, lens), got)
    b_bytes, b_ops = nbytes / HBM_BPS * 1e3, ops / peak * 1e3
    st.update(bound_ms=max(b_bytes, b_ops), bound_by="bytes" if b_bytes >= b_ops else "operations",
              bytes=nbytes, ops=ops)
    qn, m = dist.shape
    log(f"{tag} K1c {qn} x {m:,} -> {k} ({ops:,} filled, lens {'given' if lens is not None else 'none'}): "
        f"lex_topk_select ({launches} launch{'es' if launches > 1 else ''}) vs the first port's chain "
        f"(same outputs) in turns: {st['ms']:.4f} / {st['previous_ms']:.4f} ms a call, device only "
        f"{st['gpu_ms']:.4f} / {st['previous_gpu_ms']:.4f} ms ({st['previous_gpu_ms'] / st['gpu_ms']:.2f}x); "
        f"plain {st['plain_ms']:.4f} ms; of the (dist, id) keys in the same turns torch.topk "
        f"{st['library_ms']:.4f} / {st['library_gpu_ms']:.4f} ms, torch.sort {st['sort_ms']:.4f} / "
        f"{st['sort_gpu_ms']:.4f} ms (a call / device); bound {st['bound_ms']:.4f} ms "
        f"({st['bound_by']}: {nbytes:,} B) ({smi})")
    return st


def by_q(st):
    return {k: st[k] for k in ("ms", "previous_ms", "gpu_ms", "previous_gpu_ms", "plain_ms",
                               "bound_ms", "bound_by", "dot_only_ms") if k in st}



def ab_collect(fs, a_call, b_call, smi, tag, reps=20):
    """K1a/K4a (``a_call``) against K1d/K4d (``b_call``) on the same
    queries and rows, in turns; logs and returns (a_ms, b_ms)."""
    fa, fb = getattr(fs, a_call[0]), getattr(fs, b_call[0])
    a_ms, b_ms = interleaved_ms([lambda: fa(*a_call[1]), lambda: fb(*b_call[1])], reps)
    qn = a_call[1][0].shape[0]
    log(f"{tag} A/B in turns, Q={qn}: {a_call[0]} {a_ms:.4f} ms, {b_call[0]} {b_ms:.4f} ms "
        f"({b_ms / a_ms:.3f}x; median of {reps} each, CUDA events; {smi})")
    return a_ms, b_ms


def ab_auto_buckets(auto, queries, smi, tag, reps=30):
    """The guaranteed-exact auto scan with ``epilogue="dist"`` against
    ``"cos"`` at each of the batching service's buckets, in turns: CUDA
    events around the whole call (launches, host syncs and any repair
    included).  Returns {Q: (dist_ms, cos_ms)}."""
    out = {}
    for qn in SERVICE_BUCKETS:
        q = queries[:qn]
        out[qn] = interleaved_ms([lambda: auto(q, "dist"), lambda: auto(q, "cos")], reps)
        d_ms, c_ms = out[qn]
        log(f"{tag} auto dist vs cos in turns, Q={qn}: {d_ms:.4f} / {c_ms:.4f} ms "
            f"({c_ms / d_ms:.3f}x; median of {reps} each; {smi})")
    return out


def time_theta_stage(fs, smp, queries, md, smi, reps=10):
    """The θ stage of the main pass (k = K over N_ROWS rows) on the θ kernel
    against the first port's composition (``sample_theta_chain``: the
    plain-torch mini-sample, K1a and K1c) in turns, per call and device
    only, at Q = 1 and Q = MAIN_Q, after holding both equal to the plain
    version (uncounted: the main paths' counts are read elsewhere).  The
    bound: the sample's rows and meta rows 0-2 read once, the queries and
    θ, or the 2·Q·S·D int8 product."""
    import torch

    s, d = smp.data.shape
    j = min(s, max(1, -(-max(16 * K // 5, 256) * s // N_ROWS)))
    per_q = {}
    for qn in (1, MAIN_Q):
        qk = fs.CosineQueries.from_u8(queries[:qn])
        new = lambda: fs.sample_theta(qk, smp, md, j)  # noqa: E731
        old = lambda: fs.sample_theta_chain(qk, smp, md, j)  # noqa: E731
        want = fs.sample_theta_plain(qk, smp, md, j)
        check(torch.equal(new(), want) and torch.equal(old(), want), f"θ stage Q={qn}: differs from plain")
        st = {}
        st["ms"], st["previous_ms"] = interleaved_ms([new, old], reps)
        st["gpu_ms"], st["previous_gpu_ms"] = gpu_ms([new, old], reps=2 * reps)
        st["plain_ms"] = median_ms(lambda: fs.sample_theta_plain(qk, smp, md, j), reps)
        nbytes = s * d + 12 * s + qn * (d + 12) + 4 * qn
        ops = 2 * qn * s * d
        b_bytes, b_ops = nbytes / HBM_BPS * 1e3, ops / INT8_OPS * 1e3
        st.update(bound_ms=max(b_bytes, b_ops), bound_by="bytes" if b_bytes >= b_ops else "operations",
                  bytes=nbytes, ops=ops, library_ms=None)
        log(f"[3] θ stage Q={qn} over the {s:,}-row sample (j={j}): sample_theta (the θ kernel, "
            f"2 launches) vs sample_theta_chain (plain mini-sample + K1a + K1c) in turns, both = plain: "
            f"{st['ms']:.4f} / {st['previous_ms']:.4f} ms a call ({st['previous_ms'] / st['ms']:.2f}x), "
            f"device only {st['gpu_ms']:.4f} / {st['previous_gpu_ms']:.4f} ms "
            f"({st['previous_gpu_ms'] / st['gpu_ms']:.2f}x); plain {st['plain_ms']:.4f} ms; bound "
            f"{st['bound_ms']:.4f} ms ({st['bound_by']}: {nbytes:,} B, {ops:,} ops) "
            f"(medians of {reps} in turns, CUDA events; {smi})")
        per_q[qn] = st
    return {**per_q[MAIN_Q], "by_q": {qn: by_q(st) for qn, st in per_q.items()}}


def small_library(fs, scan, smi, err, db, rng):
    """K1b at the small-library gate (ops/scan.py: a library of at most
    4 · DEFAULT_BLOCK_ROWS rows answers every query with K1b + K1c): the
    first SMALL_ROWS of phase 3's rows, every 97th a tombstone, a
    ``similar`` (Q = 1) and a full service bucket (Q = 256) through
    ``cosine_scan_topk_auto``; every launch replayed bit-identical, the
    results equal to the exact scan and the oracle (query 0), then K1b
    timed in turns against the first port's kernel."""
    import numpy as np
    import torch

    from pixelbox_tpu_torch.ops.packed import PackedSemanticIndex, semantic_rows_from_u8

    check(SMALL_ROWS <= 4 * scan.DEFAULT_BLOCK_ROWS, "the small library is past the K1b gate")
    dev = torch.device("cuda")
    rows = db[:SMALL_ROWS]
    valid = np.arange(SMALL_ROWS) % 97 != 0
    data, rsum, rmag2 = semantic_rows_from_u8(rows)
    idx = PackedSemanticIndex(*(torch.from_numpy(x).to(dev) for x in (data, rsum, rmag2, valid)))
    meta = fs.build_row_meta(idx)
    queries = perturb(rng, rows[rng.integers(0, SMALL_ROWS, MAIN_Q)])
    od, oi = oracle_topk(queries[:1], rows, valid, K, 1e3)
    out = {}
    for qn in (1, MAIN_Q):
        q = torch.from_numpy(queries[:qn]).to(dev)
        with Recorder(fs) as rec:
            d, i = scan.cosine_scan_topk_auto(q, idx, k=K, row_meta=meta)
            torch.cuda.synchronize()
        names = [c[0] for c in rec.calls]
        check(names == ["cosine_chunk_topk", "lex_topk_select"], f"small library Q={qn}: the path launched {names}")
        for call in rec.calls:
            err[call[0]] = max(err[call[0]], replay(fs, call))
        ex_d, ex_i = scan.cosine_scan_topk(q, idx, k=K)
        check(torch.equal(d, ex_d) and torch.equal(i, ex_i), f"small library Q={qn}: differs from the exact scan")
        check(np.array_equal(d[0].cpu().numpy(), od[0]) and np.array_equal(i[0].cpu().numpy(), oi[0]),
              f"small library Q={qn}: differs from the numpy oracle")
        log(f"[3] small library {SMALL_ROWS:,} rows (1/97 tombstones) Q={qn}: K1b + K1c, replayed "
            f"bit-identical; = exact scan and oracle")
        out[f"{qn}x{SMALL_ROWS // 1024}k"] = time_chunk_against_previous(
            fs, rec.calls[0], smi, "[3] small library", err)
    del idx, meta
    torch.cuda.empty_cache()
    return out


def phase_kernels(fs, scan, smi, err, seeded):
    import numpy as np
    import torch

    from pixelbox_tpu_torch.ops.packed import PackedSemanticIndex, semantic_rows_from_u8

    dev = torch.device("cuda")
    rng, db, base_q = seeded  # host_data's, made during the builds

    flood_row, flood_at, flood_n = FLOOD
    cases = []
    valid_all = np.ones(N_ROWS, bool)
    cases.append(("theta_from_sample", db, valid_all, base_q, 1e3, "auto"))
    cases.append(("theta_max_distance", db, valid_all, base_q, 1e3, "fused"))
    cases.append(("max_distance_filter", db, valid_all, base_q, 0.05, "both"))
    valid_1pct = valid_all.copy()
    valid_1pct[rng.choice(N_ROWS, N_ROWS // 100, replace=False)] = False
    valid_1pct[4242] = False  # the exact copy's row is a tombstone
    cases.append(("invalid_rows_1pct", db, valid_1pct, base_q, 1e3, "both"))
    db_flood = db.copy()
    db_flood[flood_at : flood_at + flood_n] = db[flood_row]  # 8,192 duplicates
    flood_q = base_q.copy()
    flood_q[0] = db[flood_row]
    flood_q[2] = perturb(rng, db[flood_row][None])[0]
    cases.append(("tie_flood", db_flood, valid_all, flood_q, 1e3, "both"))

    timed_calls = {}
    proof_cos = {}
    for name, rows, valid, queries, md, which in cases:
        data, rsum, rmag2 = semantic_rows_from_u8(rows)
        idx = PackedSemanticIndex(*(torch.from_numpy(x).to(dev) for x in (data, rsum, rmag2, valid)))
        meta = fs.build_row_meta(idx)
        smp = scan.build_scan_sample(idx)
        sub = [0, 1] if which != "fused" else [1]
        od, oi = oracle_topk(queries[sub], rows, valid, K, md)
        for qn in QS:
            q = torch.from_numpy(queries[:qn]).to(dev)
            ex_d, ex_i = scan.cosine_scan_topk(q, idx, k=K, max_distance=md)
            with Recorder(fs) as rec:
                results = []
                if which in ("auto", "both"):
                    td, ti, exact = fs.fused_threshold_scan_topk(q, idx, meta, smp, k=K, max_distance=md)
                    check(torch.equal(td[exact], ex_d[exact]) and torch.equal(ti[exact], ex_i[exact]),
                          f"{name}: a query flagged exact differs from the exact scan")
                    results.append(("auto", *scan.cosine_scan_topk_auto(
                        q, idx, k=K, max_distance=md, sample=smp, row_meta=meta)))
                    n_exact = int(exact.sum())
                    # [3e] the cos-key pass (K1d + K1e) on the same inputs
                    cd, ci, cex = fs.fused_threshold_scan_topk(
                        q, idx, meta, smp, k=K, max_distance=md, epilogue="cos")
                    check(torch.equal(cd[cex], ex_d[cex]) and torch.equal(ci[cex], ex_i[cex]),
                          f"{name}: a query the cos-key pass flagged exact differs from the exact scan")
                    results.append(("auto_cos", *scan.cosine_scan_topk_auto(
                        q, idx, k=K, max_distance=md, sample=smp, row_meta=meta, epilogue="cos")))
                    n_cos = int(cex.sum())
                    if name != "tie_flood":
                        proof_cos.setdefault(qn, []).append(n_cos)
                if which in ("fused", "both"):
                    results.append(("fused", *fs.fused_cosine_scan_topk(q, idx, meta, k=K, max_distance=md)))
                torch.cuda.synchronize()
            for call in rec.calls:
                err[call[0]] = max(err[call[0]], replay(fs, call))
                if name in ("theta_from_sample", "theta_max_distance"):
                    timed_calls.setdefault((call[0], qn), []).append(call)
            for label, d, i in results:
                check(tuple(d.shape) == (qn, K) and tuple(i.shape) == (qn, K), f"{name}/{label}: shape")
                check(bool(torch.isfinite(d[i >= 0]).all()), f"{name}/{label}: non-finite kept distance")
                check(torch.equal(d, ex_d) and torch.equal(i, ex_i),
                      f"{name}/{label}: differs from the exact scan at Q={qn}")
                for r, qrow in enumerate(sub):
                    if qrow < qn:
                        check(np.array_equal(d[qrow].cpu().numpy(), od[r])
                              and np.array_equal(i[qrow].cpu().numpy(), oi[r]),
                              f"{name}/{label}: differs from the numpy oracle (query {qrow})")
            extra = (f", proven {n_exact}/{qn} (cos key {n_cos}/{qn})"
                     if which in ("auto", "both") else "")
            log(f"[3] {name} Q={qn}: {len(rec.calls)} kernel calls replayed bit-identical; "
                f"= exact scan and oracle{extra}")
            if name == "tie_flood" and qn >= 1:
                fi = i[0].cpu().numpy()
                flood_ids = np.concatenate([[flood_row], np.arange(flood_at, flood_at + K - 1)])
                check(np.array_equal(fi, flood_ids), "tie flood: ids not ascending within the tie")
                check(not bool(exact[0]) and not bool(cex[0]), "tie flood: the proof was not defeated")
        if name == "theta_from_sample":
            qall = torch.from_numpy(queries).to(dev)
            ab_auto_buckets(lambda q, e: scan.cosine_scan_topk_auto(
                q, idx, k=K, max_distance=md, sample=smp, row_meta=meta, epilogue=e), qall, smi, "[3e] u8")
            theta_st = time_theta_stage(fs, smp, qall, md, smi)
        del idx, meta, smp
        torch.cuda.empty_cache()

    # Timing at the main path's shapes: K1a at the main pass (Q = MAIN_Q
    # over all rows, k = 100); K1b at a repair bucket and at the
    # small-library gate, in turns against the first port's kernel; K1c
    # on the main pass's buffer and a repair's K1b partials.
    def main_pass(call):
        return call[1][5].shape[0] == N_ROWS

    stats = {"sample_theta": theta_st}
    for n in ("cosine_coskey_collect", "coskey_rescore"):
        stats[n] = time_kernel(fs, next(c for c in timed_calls[(n, MAIN_Q)] if main_pass(c)), smi, "[3e]")
    k1b = {f"{REPAIR_Q}x1M": time_chunk_against_previous(
        fs, next(c for c in timed_calls[("cosine_chunk_topk", REPAIR_Q)] if main_pass(c)), smi, "[3] repair", err)}
    k1b.update(small_library(fs, scan, smi, err, db, rng))
    stats["cosine_chunk_topk"] = {**k1b[f"{REPAIR_Q}x1M"],
                                  "by_shape": {n: chunk_by_shape(st) for n, st in k1b.items()}}
    k1c = timed_calls[("lex_topk_select", MAIN_Q)]
    k1c_calls = {
        "main_pass": next(c for c in k1c if k1c_args(c)[2] == K and k1c_args(c)[3] is not None),
        "k1b_partials": next(c for c in timed_calls[("lex_topk_select", REPAIR_Q)]
                             if k1c_args(c)[3] is None),  # the exact scan's (no lens)
    }
    k1c_st = {shape: time_k1c(fs, c, smi, f"[3] {shape}", err) for shape, c in k1c_calls.items()}
    stats["lex_topk_select"] = {**k1c_st["main_pass"], "by_shape": k1c_st}
    # the first port's K1c alone: its first launch on the main pass's buffer
    d, i, kk, ln = k1c_args(k1c_calls["main_pass"])
    stats["lex_topk_segments"] = time_kernel(
        fs, ("lex_topk_segments", (d, i, kk, ln), {}, fs.lex_topk_segments(d, i, kk, ln)), smi,
        "[3] the first port's K1c, first launch of its chain:")
    k1a = {}
    for qn in QS:  # the tensor-core K1a against the __dp4a kernel it replaced
        call = next(c for c in timed_calls[("cosine_threshold_collect", qn)] if main_pass(c))
        k1a[qn] = time_against_previous(fs, call, smi, "[3]", err)
    stats["cosine_threshold_collect"] = {**k1a[MAIN_Q], "by_q": {q: by_q(st) for q, st in k1a.items()}}
    ab_collect(fs, next(c for c in timed_calls[("cosine_threshold_collect", MAIN_Q)] if main_pass(c)),
               next(c for c in timed_calls[("cosine_coskey_collect", MAIN_Q)] if main_pass(c)),
               smi, "[3e] K1a vs K1d")
    for qn, runs in sorted(proof_cos.items()):
        log(f"[3e] cos-key proof rate Q={qn} (cases but the tie flood): {sum(runs)}/{qn * len(runs)} "
            f"= {sum(runs) / (qn * len(runs)):.4f}")
    return stats, db


# --------------------------------------------------------------------- #
# Phase 3b: the Hamming kernels at the phash's published width


def oracle_hamming(q, db, valid, k, md, limit, wrap):
    import numpy as np

    from pixelbox_tpu_torch.ops.oracle import hamming_scan_topk_np

    keep = np.nonzero(valid)[0]
    od, oi = hamming_scan_topk_np(q[:, :limit], db[keep][:, :limit], k=k, max_distance=md, wrap_u8=wrap)
    return od, np.where(oi >= 0, keep[np.maximum(oi, 0)], -1).astype(np.int32)


def phase_hamming(fs, scan, hg, smi, err):
    import numpy as np
    import torch

    from pixelbox_tpu_torch.ops.packed import PackedHammingIndex

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 2)
    t0 = time.perf_counter()
    db = clustered_phashes(rng, N_ROWS, PH_BYTES)
    base_q = flip_bits(rng, db[rng.integers(0, N_ROWS, max(PH_QS))])
    base_q[1] = db[4242]  # an exact copy: distance 0 at row 4242
    log(f"[3b] seeded {N_ROWS}x{PH_BYTES} phash rows in {time.perf_counter() - t0:.1f}s")

    flood_row, flood_at, flood_n = FLOOD
    valid_all = np.ones(N_ROWS, bool)
    valid_1pct = valid_all.copy()
    valid_1pct[rng.choice(N_ROWS, N_ROWS // 100, replace=False)] = False
    valid_1pct[4242] = False
    wrap_q = base_q.copy()
    wrap_q[0] = ~db[777]            # 256 differing bits: wraps to distance 0
    wrap_q[2] = ~db[778] ^ 1        # 255 bits
    group = np.arange(N_ROWS) % 3 != 0   # a width group
    db_flood = db.copy()
    db_flood[flood_at : flood_at + flood_n] = db[flood_row]  # 8,192 duplicates
    flood_q = base_q.copy()
    flood_q[0] = db[flood_row]
    flood_q[2] = flip_bits(rng, db[flood_row][None])[0]
    # (name, rows, valid, group, queries, max_distance, byte_limit, wrap,
    #  paths, largest Q): Q = 2048 (past the JAX carry kernels) for the
    # main pass and the flood, as in phase 3d.
    big = max(PH_QS)
    cases = [
        ("theta_from_sample", db, valid_all, None, base_q, 1e3, PH_BYTES, False, "auto", big),
        ("theta_max_distance", db, valid_all, None, base_q, 1e3, PH_BYTES, False, "fused", MAIN_Q),
        ("max_distance_0.1", db, valid_all, None, base_q, 0.1, PH_BYTES, False, "both", MAIN_Q),
        ("tombstones_1pct", db, valid_1pct, None, base_q, 1e3, PH_BYTES, False, "both", MAIN_Q),
        ("wrap_u8", db, valid_all, None, wrap_q, 1e3, PH_BYTES, True, "both", MAIN_Q),
        ("byte_limit_24_group", db, valid_all, group, base_q, 1e3, 24, False, "both", MAIN_Q),
        ("tie_flood", db_flood, valid_all, None, flood_q, 1e3, PH_BYTES, False, "both", big),
    ]
    timed_calls = {}
    for name, rows, valid, grp, queries, md, limit, wrap, which, q_max in cases:
        idx = PackedHammingIndex(torch.from_numpy(rows).to(dev), torch.from_numpy(valid).to(dev))
        meta = fs.build_hamming_meta(idx, grp)
        smp = hg.build_hamming_scan_sample(idx, meta)
        ref = idx if grp is None else idx._replace(valid=meta.bool())
        sub = [0, 1, 2] if which != "fused" else [1]
        ovalid = valid if grp is None else valid & grp
        od, oi = oracle_hamming(queries[sub], rows, ovalid, K, md, limit, wrap)
        for qn in (q for q in PH_QS if q <= q_max):
            q = torch.from_numpy(queries[:qn]).to(dev)
            ex_d, ex_i = scan.hamming_scan_topk(q, ref, k=K, max_distance=md, wrap_u8=wrap, byte_limit=limit)
            kw = dict(k=K, max_distance=md, wrap_u8=wrap, byte_limit=limit)
            extra = ""
            with Recorder(fs) as rec:
                results = []
                if which in ("auto", "both"):
                    td, ti, exact = fs.fused_hamming_threshold_scan_topk(q, idx, meta, smp, **kw)
                    check(torch.equal(td[exact], ex_d[exact]) and torch.equal(ti[exact], ex_i[exact]),
                          f"{name}: a query flagged exact differs from the exact scan")
                    results.append(("auto", *hg.hamming_gemm_scan_topk_auto(
                        q, idx, sample=smp, meta=meta, **kw)))
                    n_exact = int(exact.sum())
                    extra = f"; proven {n_exact}/{qn}, repaired {qn - n_exact}"
                if which in ("fused", "both"):
                    results.append(("fused", *hg.hamming_gemm_scan_topk(q, idx, meta=meta, **kw)))
                torch.cuda.synchronize()
            for call in rec.calls:
                err[call[0]] = max(err[call[0]], replay(fs, call))
                if name in ("theta_from_sample", "theta_max_distance"):
                    timed_calls.setdefault((call[0], qn), []).append(call)
            for label, d, i in results:
                check(tuple(d.shape) == (qn, K) and tuple(i.shape) == (qn, K), f"{name}/{label}: shape")
                check(torch.equal(d, ex_d) and torch.equal(i, ex_i),
                      f"{name}/{label}: differs from the exact scan at Q={qn}")
                for r, qrow in enumerate(sub):
                    if qrow < qn:
                        check(np.array_equal(d[qrow].cpu().numpy(), od[r])
                              and np.array_equal(i[qrow].cpu().numpy(), oi[r]),
                              f"{name}/{label}: differs from the numpy oracle (query {qrow})")
            log(f"[3b] {name} Q={qn}: {len(rec.calls)} kernel calls replayed bit-identical; "
                f"= exact scan and oracle{extra}")
            if name == "tie_flood":
                fi = i[0].cpu().numpy()
                flood_ids = np.concatenate([[flood_row], np.arange(flood_at, flood_at + K - 1)])
                check(np.array_equal(fi, flood_ids), "tie flood: ids not ascending within the tie")
                check(not bool(exact[0]), "tie flood: the proof was not defeated")
            if name == "wrap_u8":
                check(float(d[0, 0]) == 0.0 and int(i[0, 0]) == 777, "wrap_u8: 256 bits did not wrap to 0")
        del idx, meta, smp, ref
        torch.cuda.empty_cache()

    # K2b at the main paths' shapes, each replayed bit-identical through its
    # plain version and held against the first port's kernel: a mesh shard's
    # duplicate batch (256 stored rows against 262,144 rows, k = 8,
    # max_distance 0.1; phase 8's launches), the repair bucket and a full
    # batch over the 1M rows (k = 100).
    data = torch.from_numpy(db).to(dev)
    meta = torch.ones(N_ROWS, dtype=torch.uint8, device=dev)
    q = torch.from_numpy(db[rng.choice(MESH_SHARD_ROWS, MAIN_Q, replace=False)]).to(dev)
    args = (q, 0.1, data[:MESH_SHARD_ROWS], meta[:MESH_SHARD_ROWS], PH_BYTES, False, 8)
    dup = ("hamming_chunk_topk", args, {}, fs.hamming_chunk_topk(*args))
    err["hamming_chunk_topk"] = max(err["hamming_chunk_topk"], replay(fs, dup))
    k2b = {"mesh_dup": time_chunk_against_previous(fs, dup, smi, "[3b] mesh shard dup", err)}
    for qn in (REPAIR_Q, MAIN_Q):
        call = next(c for c in timed_calls[("hamming_chunk_topk", qn)] if c[1][2].shape[0] == N_ROWS)
        k2b[f"{qn}x1M"] = time_chunk_against_previous(fs, call, smi, "[3b]", err, reps=10 if qn < MAIN_Q else 5)
    del data, meta
    stats = {"hamming_chunk_topk": {**k2b["mesh_dup"],
                                    "by_shape": {n: chunk_by_shape(st) for n, st in k2b.items()}}}
    k2a = {}
    for qn in PH_QS:  # the tensor-core K2a against the __popc kernel it replaced
        call = next(c for c in timed_calls[("hamming_threshold_collect", qn)]
                    if c[1][2].shape[0] == N_ROWS)
        k2a[qn] = time_against_previous(fs, call, smi, "[3b]", err, reps=10 if qn <= MAIN_Q else 3)
    stats["hamming_threshold_collect"] = {**k2a[MAIN_Q], "by_q": {q: by_q(st) for q, st in k2a.items()}}
    return stats


# --------------------------------------------------------------------- #
# Phase 3c: large batches — cosine auto at Q = 2048 (the JAX package's
# buffer-select kernel, pallas_threshold_scan_topk, serves Q > 1024)


def phase_big_batch(fs, scan, smi, err, db):
    import numpy as np
    import torch

    from pixelbox_tpu_torch.ops.packed import PackedSemanticIndex, semantic_rows_from_u8

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 3)
    queries = perturb(rng, db[rng.integers(0, N_ROWS, BIG_Q)])
    queries[5] = db[31337]
    data, rsum, rmag2 = semantic_rows_from_u8(db)
    idx = PackedSemanticIndex(*(torch.from_numpy(x).to(dev)
                                for x in (data, rsum, rmag2, np.ones(N_ROWS, bool))))
    meta = fs.build_row_meta(idx)
    smp = scan.build_scan_sample(idx)
    q = torch.from_numpy(queries).to(dev)
    ex_d, ex_i = scan.cosine_scan_topk(q, idx, k=K)
    with Recorder(fs) as rec:
        td, ti, exact = fs.fused_threshold_scan_topk(q, idx, meta, smp, k=K)
        d, i = scan.cosine_scan_topk_auto(q, idx, k=K, sample=smp, row_meta=meta)
        torch.cuda.synchronize()
    check(torch.equal(td[exact], ex_d[exact]) and torch.equal(ti[exact], ex_i[exact]),
          "Q=2048: a query flagged exact differs from the exact scan")
    check(torch.equal(d, ex_d) and torch.equal(i, ex_i), "Q=2048: auto differs from the exact scan")
    check(float(d[5, 0]) == 0.0 and int(i[5, 0]) == 31337, "Q=2048: the exact copy is not first at 0")
    od, oi = oracle_topk(queries[[0, 5]], db, np.ones(N_ROWS, bool), K, 1e3)
    for r, qrow in enumerate((0, 5)):
        check(np.array_equal(d[qrow].cpu().numpy(), od[r]) and np.array_equal(i[qrow].cpu().numpy(), oi[r]),
              f"Q=2048: differs from the numpy oracle (query {qrow})")
    names = sorted({c[0] for c in rec.calls})
    check("cosine_threshold_collect" in names, "Q=2048: K1a was not launched")
    for call in rec.calls:
        err[call[0]] = max(err[call[0]], replay(fs, call))
    n_exact = int(exact.sum())
    log(f"[3c] cosine auto Q={BIG_Q} over {N_ROWS:,}x{DIM}: {len(rec.calls)} kernel calls "
        f"({', '.join(names)}) replayed bit-identical; = exact scan and oracle; proven "
        f"{n_exact}/{BIG_Q}, repaired {BIG_Q - n_exact}")
    main = next(c for c in rec.calls if c[0] == "cosine_threshold_collect" and c[1][5].shape[0] == N_ROWS)
    st = time_against_previous(fs, main, smi, "[3c]", err, reps=3)
    del idx, meta, smp
    torch.cuda.empty_cache()
    return st


# --------------------------------------------------------------------- #
# Phase 3d: the int4 kernels (K4a/K4b) over the packed 4-bit rows


def phase_int4_kernels(fs, scan, smi, err, db):
    import numpy as np
    import torch

    from pixelbox_tpu_torch.ops import int4

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 5)
    base_q = perturb(rng, db[rng.integers(0, N_ROWS, BIG_Q)])
    base_q[1] = db[4242]  # an exact copy of row 4242
    flood_row, flood_at, flood_n = FLOOD
    valid_all = np.ones(N_ROWS, bool)
    valid_1pct = valid_all.copy()
    valid_1pct[rng.choice(N_ROWS, N_ROWS // 100, replace=False)] = False
    valid_1pct[4242] = False
    # 20,000 copies: more than k = 400's 16,384-slot collect buffer, so
    # even the one-ulp-widened θ cannot prove the flood.
    flood_n = 20000
    db_flood = db.copy()
    db_flood[flood_at : flood_at + flood_n] = db[flood_row]
    flood_q = base_q.copy()
    flood_q[0] = db[flood_row]
    flood_q[2] = perturb(rng, db[flood_row][None])[0]
    # (name, rows, valid, queries, max_distance, paths, largest Q,
    #  oracle query, oracle modes): Q = 2048 (past the JAX carry kernels)
    # for the main pass and the flood; the numpy oracle (seconds a query
    # at 1M rows) on one query of each row set.
    both = ("asym", "sym")
    cases = [
        ("theta_from_sample", db, valid_all, base_q, 1e3, "auto", BIG_Q, 1, both),
        ("theta_max_distance", db, valid_all, base_q, 1e3, "fused", MAIN_Q, 1, both),
        ("max_distance_filter", db, valid_all, base_q, 0.05, "both", MAIN_Q, 1, both),
        ("tombstones_1pct", db, valid_1pct, base_q, 1e3, "both", MAIN_Q, 1, ("asym",)),
        ("tie_flood", db_flood, valid_all, flood_q, 1e3, "both", BIG_Q, 0, ("asym",)),
    ]
    oracles = {}
    timed_calls = {}
    proof = {}
    kmax = max(INT4_KS)
    for name, rows, valid, queries, md, which, q_max, oq, oracle_modes in cases:
        idx = int4.build_semantic4_index(rows, device=dev)
        idx = idx._replace(valid=torch.from_numpy(valid).to(dev))
        meta = int4.build_semantic4_meta(idx)
        smp = scan.build_scan_sample(idx)
        qall = torch.from_numpy(queries).to(dev)
        for mode in ("asym", "sym"):
            exact_fn = int4.cosine4a_scan_topk if mode == "asym" else int4.cosine4_scan_topk
            oracle_fn = int4.cosine4a_scan_topk_np if mode == "asym" else int4.cosine4_scan_topk_np
            # The exact scan and the oracle at the largest Q and k: smaller
            # Q and k are their prefixes ((dist, id) order, same filter).
            ex_d, ex_i = exact_fn(qall[:q_max], idx, k=kmax, max_distance=md)
            okey = (id(rows), id(valid), mode, oq)
            if mode in oracle_modes and okey not in oracles:
                keep = np.nonzero(valid)[0]
                od, oi = oracle_fn(queries[oq], rows[keep], k=kmax, max_distance=int4.UNBOUNDED_DISTANCE)
                oracles[okey] = (od[0], np.where(oi[0] >= 0, keep[np.maximum(oi[0], 0)], -1))
            if mode in oracle_modes:
                od, oi = oracles[okey]
                od, oi = np.where(od < np.float32(md), od, np.inf), np.where(od < np.float32(md), oi, -1)
            for k in INT4_KS:
                for qn in (x for x in PH_QS if x <= q_max):
                    q = qall[:qn]
                    wd, wi = ex_d[:qn, :k], ex_i[:qn, :k]
                    extra = ""
                    with Recorder(fs) as rec:
                        results = []
                        if which in ("auto", "both"):
                            td, ti, exact = fs.fused_threshold4_scan_topk(
                                q, idx, meta, smp, k=k, max_distance=md, query_mode=mode)
                            first_pass = list(rec.calls)
                            check(torch.equal(td[exact], wd[exact]) and torch.equal(ti[exact], wi[exact]),
                                  f"int4 {name}/{mode}: a query flagged exact differs from the exact scan")
                            results.append(("auto", *int4.cosine4_scan_topk_auto(
                                q, idx, k=k, max_distance=md, sample=smp, meta=meta, query_mode=mode)))
                            n_exact = int(exact.sum())
                            proof.setdefault((qn, name == "tie_flood"), []).append((n_exact, qn))
                            extra = f"; proven {n_exact}/{qn}, repaired {qn - n_exact}"
                            if k == kmax and qn in QS:  # the cos-key pass: K4d + K1e
                                _, _, cex = fs.fused_threshold4_scan_topk(
                                    q, idx, meta, smp, k=k, max_distance=md, query_mode=mode, epilogue="cos")
                                results.append(("auto_cos", *int4.cosine4_scan_topk_auto(
                                    q, idx, k=k, max_distance=md, sample=smp, meta=meta,
                                    query_mode=mode, epilogue="cos")))
                                extra += f" (cos key proven {int(cex.sum())}/{qn})"
                        if which in ("fused", "both") and qn <= MAIN_Q:
                            results.append(("fused", *fs.fused_cosine4_scan_topk(
                                q, idx, meta, k=k, max_distance=md, query_mode=mode)))
                        torch.cuda.synchronize()
                    for call in rec.calls:
                        err[call[0]] = max(err[call[0]], replay(fs, call))
                        if name in ("theta_from_sample", "theta_max_distance"):
                            timed_calls.setdefault((call[0], mode, k, qn), []).append(call)
                    if which in ("auto", "both") and name != "tie_flood":
                        explain_unproven(fs, err, first_pass, td, exact,
                                         lambda qq: fs.fused_threshold4_scan_topk(
                                             qq, idx, meta, smp, k=k, max_distance=md, query_mode=mode),
                                         q, k, f"[3d] int4 {name} {mode} k={k} Q={qn}")
                    for label, d, i in results:
                        check(tuple(d.shape) == (qn, k) and tuple(i.shape) == (qn, k),
                              f"int4 {name}/{label}: shape")
                        check(torch.equal(d, wd) and torch.equal(i, wi),
                              f"int4 {name}/{mode}/{label}: differs from the exact scan at Q={qn}, k={k}")
                        if oq < qn and mode in oracle_modes:
                            check(np.array_equal(d[oq].cpu().numpy(), od[:k])
                                  and np.array_equal(i[oq].cpu().numpy(), oi[:k]),
                                  f"int4 {name}/{mode}/{label}: differs from the numpy oracle")
                    oracle = " and oracle" if oq < qn and mode in oracle_modes else ""
                    log(f"[3d] int4 {name} {mode} k={k} Q={qn}: {len(rec.calls)} kernel calls replayed "
                        f"bit-identical; = exact scan{oracle}{extra}")
                    if name == "tie_flood":
                        fi = i[0].cpu().numpy()
                        flood_ids = np.concatenate([[flood_row], np.arange(flood_at, flood_at + k - 1)])
                        check(np.array_equal(fi, flood_ids), "int4 tie flood: ids not ascending within the tie")
                        check(not bool(exact[0]), "int4 tie flood: the proof was not defeated")
                        if mode == "sym":
                            check(float(d[0, 0]) == 0.0, "int4 sym: a stored row's self-distance is not 0")
            del ex_d, ex_i
            if name == "theta_from_sample" and mode == "asym":
                ab_auto_buckets(lambda q, e: int4.cosine4_scan_topk_auto(
                    q, idx, k=kmax, max_distance=md, sample=smp, meta=meta, epilogue=e),
                    qall, smi, f"[3d] int4 asym k={kmax}")
        del idx, meta, smp, qall
        torch.cuda.empty_cache()
    for (qn, flood), runs in sorted(proof.items()):
        got, tot = sum(a for a, _ in runs), sum(b for _, b in runs)
        log(f"[3d] int4 proof rate Q={qn}{' (tie flood)' if flood else ''}: {got}/{tot} = {got / tot:.4f}")

    # Timing at the int4 main path's shapes: the tensor-core K4a at the
    # main pass (over all rows, k = 400 — the rerank's candidates) at every
    # Q, in turns against the __dp4a kernel it replaced; K4b at a repair
    # bucket; K1c on the main pass's buffer; asym (the default) in the
    # kernels line, sym beside it.
    def main_call(n, mode, qn):
        return next(c for c in timed_calls[(n, mode, kmax, qn)] if c[1][5].shape[0] == N_ROWS)

    stats = {}
    k4a = {}
    for mode in ("asym", "sym"):
        for qn in PH_QS:
            k4a[mode, qn] = time_against_previous(fs, main_call("cosine4_threshold_collect", mode, qn), smi,
                                                  f"[3d] {mode} k={kmax}", err, reps=10 if qn <= MAIN_Q else 3)
    stats["cosine4_threshold_collect"] = {
        **k4a["asym", MAIN_Q], "by_q": {q: by_q(k4a["asym", q]) for q in PH_QS},
        "sym_by_q": {q: by_q(k4a["sym", q]) for q in PH_QS}}
    # K4b at the main paths' shapes, both modes, each replayed bit-identical
    # through its plain version and held against the first port's kernel:
    # the int4 duplicates batch (256 stored rows against the 65,536-row cut,
    # k = 400, unbounded; phase 6's launches) and the repair bucket over the
    # 1M rows (k = 400).
    idx = int4.build_semantic4_index(db[:INT4_DUP_ROWS], device=dev)
    meta = int4.build_semantic4_meta(idx)
    dup_q = torch.from_numpy(db[rng.choice(INT4_DUP_ROWS, MAIN_Q, replace=False)]).to(dev)
    k4b = {}
    for mode in ("asym", "sym"):
        qk = fs.Int4Queries.from_u8(dup_q, mode)
        args = (*qk[:4], int4.UNBOUNDED_DISTANCE, idx.data, meta, qk.sym, kmax)
        dup = ("cosine4_chunk_topk", args, {}, fs.cosine4_chunk_topk(*args))
        err["cosine4_chunk_topk"] = max(err["cosine4_chunk_topk"], replay(fs, dup))
        k4b[f"dup_{mode}"] = time_chunk_against_previous(fs, dup, smi, f"[3d] int4 dup {mode}", err)
        k4b[f"{REPAIR_Q}x1M_{mode}"] = time_chunk_against_previous(
            fs, main_call("cosine4_chunk_topk", mode, REPAIR_Q), smi, f"[3d] {mode} k={kmax}", err)
    del idx, meta
    stats["cosine4_chunk_topk"] = {**k4b["dup_asym"],
                                   "by_shape": {n: chunk_by_shape(st) for n, st in k4b.items()}}
    for mode in ("asym", "sym"):
        st = time_kernel(fs, main_call("cosine4_coskey_collect", mode, MAIN_Q), smi, f"[3d] {mode} k={kmax}")
        if mode == "asym":
            stats.setdefault("cosine4_coskey_collect", st)
    k1c = next(c for c in timed_calls[("lex_topk_select", "asym", kmax, MAIN_Q)]
               if k1c_args(c)[2] == kmax and k1c_args(c)[3] is not None
               and k1c_args(c)[0].shape[1] == fs.SELECT_SLOTS)
    stats["k1c_int4"] = time_k1c(fs, k1c, smi, "[3d] int4", err)
    for mode in ("asym", "sym"):
        ab_collect(fs, *(next(c for c in timed_calls[(n, mode, kmax, MAIN_Q)] if c[1][5].shape[0] == N_ROWS)
                         for n in ("cosine4_threshold_collect", "cosine4_coskey_collect")),
                   smi, f"[3d] {mode} k={kmax} K4a vs K4d")
    return stats


def explain_unproven(fs, err, calls, td, exact, scan_one, q, k, tag):
    """Every query a threshold pass left unproven: its exact count against
    the buffer's cap, its θ and k-th distance from the recorded main
    collect (over all N_ROWS rows), then the same query alone (Q = 1)
    through ``scan_one`` — its count, θ and proof — every launch replayed."""
    import torch

    main = [c for c in calls if c[0].endswith("collect") and c[1][5].shape[0] == N_ROWS]
    if not main or bool(exact.all()):
        return
    args, out = main[-1][1], main[-1][3]
    cap, theta, count = args[-1], args[4], out[0]
    for qi in torch.nonzero(~exact).flatten().tolist():
        with Recorder(fs) as rec:
            _, _, ex1 = scan_one(q[qi:qi + 1])
            torch.cuda.synchronize()
        for call in rec.calls:
            err[call[0]] = max(err[call[0]], replay(fs, call))
        one = [c for c in rec.calls if c[0].endswith("collect") and c[1][5].shape[0] == N_ROWS][-1]
        log(f"{tag}: query {qi} unproven: count {int(count[qi])} vs cap {cap}, θ {float(theta[qi])!r}, "
            f"k-th distance {float(td[qi, k - 1])!r}; alone (Q=1): count {int(one[3][0][0])}, "
            f"θ {float(one[1][4][0])!r}, proven {bool(ex1[0])}")


# --------------------------------------------------------------------- #
# Kernel time, plain time, bound and library time of one recorded call


def sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.split()[0]
    return float(out) * 1e6


def work_of(name, args, out):
    """(bytes, ops, ops peak) that the call's function needs on these
    inputs: each input read once (rows the kernel skips as invalid are
    not read), each output written once (only the collected candidates of
    a buffer, only the meaningful entries of a K1c input); ops as the
    int8 products of the dot (Hamming: the ±1 int8 product of 8·limit
    bits per (query, row) that the TPU kernel computes) or, for K1c, one
    comparison per meaningful candidate at the f32 scalar rate."""
    import torch

    if name == "coskey_rescore":
        q, data, lens, cand_i = args[0], args[5], args[8], args[9]
        qn, d = q.shape
        used = int(lens.sum())
        # per used slot: its id, the row and 12 B of its meta; per query:
        # codes, sums, moments, θ, lens; the [Q, cap] f32 output
        nbytes = used * (4 + data.shape[1] + 12) + qn * (d + 20) + cand_i.numel() * 4
        return nbytes, 2 * used * d, INT8_OPS
    if name.startswith("lex_topk"):
        dist, k = args[0], args[2]
        lens = args[3] if len(args) > 3 else None
        qn, m = dist.shape
        used = int(torch.clamp(lens, max=m).sum()) if lens is not None else qn * m
        return used * 8 + (qn * 4 if lens is not None else 0) + out[0].numel() * 8, used, F32_OPS
    if name.startswith("cosine"):
        q, data, meta = args[0], args[5], args[6]
        nv = int((meta[1] > 0).sum())
        qn, d = q.shape
        qbytes = qn * (d + 12) + (4 * qn if name.endswith("collect") else 0)
        rows = nv * data.shape[1] + 12 * data.shape[0]   # int4: D/2 packed bytes a row
        ops = 2 * qn * nv * d
    else:
        q, data, meta, limit = args[0], args[2], args[3], args[4]
        nv = int((meta != 0).sum())
        qn, h = q.shape
        qbytes = qn * h + (4 * qn if name == "hamming_threshold_collect" else 0)
        rows = nv * limit + data.shape[0]
        ops = 2 * qn * nv * 8 * limit
    if name.endswith("collect"):
        cap = args[-1]
        outb = int(torch.clamp(out[0], max=cap).sum()) * 8 + 4 * qn
    else:  # a chunk top-k: the exact scan's [Q, k] result (its partials are the design's)
        outb = qn * args[-1] * 8
    return rows + qbytes + outb, ops, INT8_OPS


def dot_only(name, args):
    """The dot alone, as one library call: ``torch._int_mm`` of the int8
    query codes (cosine; int4: against an unpacked int8 copy of the
    rows) or the ±1 bit-unpacked hashes (Hamming, the TPU kernel's
    layout) against the rows; queries padded to 32 rows, the call's least
    M."""
    import torch

    if name.startswith("cosine4"):
        from pixelbox_tpu_torch.ops.fused_scan import unpack_u4

        q, data = args[0], unpack_u4(args[5]).contiguous()
    elif name.startswith("cosine"):
        q, data = args[0], args[5]
    else:
        shifts = torch.arange(8, device=args[0].device, dtype=torch.uint8)

        def pm1(x):
            bits = (x[..., None] >> shifts) & 1
            return (bits.to(torch.int8) * 2 - 1).reshape(x.shape[0], -1).contiguous()

        q, data = pm1(args[0]), pm1(args[2])
    qp = torch.zeros((max(32, q.shape[0]), q.shape[1]), dtype=torch.int8, device=q.device)
    qp[: q.shape[0]] = q
    bt = data.t()
    return lambda: torch._int_mm(qp, bt)


def time_kernel(fs, call, smi, tag, reps=10):
    """Kernel and plain medians (CUDA events), the bound from this call's
    inputs, and the library call's time."""
    import torch

    name, args, kwargs, out = call
    kern, plain = getattr(fs, name), getattr(fs, name + "_plain")
    k_ms = median_ms(lambda: kern(*args, **kwargs), reps)
    p_ms = median_ms(lambda: plain(*args, **kwargs), reps)
    nbytes, ops, peak = work_of(name, args, out)
    b_bytes, b_ops = nbytes / HBM_BPS * 1e3, ops / peak * 1e3
    st = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": max(b_bytes, b_ops),
          "bound_by": "bytes" if b_bytes >= b_ops else "operations",
          "bytes": nbytes, "ops": ops, "library_ms": None}
    extra = ""
    if name.startswith("lex_topk"):
        dist, idx, k = args[:3]
        lens = args[3] if len(args) > 3 else kwargs.get("lens")
        keys = fs._keys(dist, idx, lens)
        st["library_ms"] = median_ms(lambda: torch.topk(keys, k, dim=1, largest=False, sorted=True), reps)
        extra = f", library torch.topk on the (dist, id) keys {st['library_ms']:.4f} ms"
    elif name != "coskey_rescore":  # no one library call gathers and dots per slot
        st["dot_only_ms"] = median_ms(dot_only(name, args), reps)
        of = " over an unpacked int8 copy" if name.startswith("cosine4") else ""
        extra = f", dot only (torch._int_mm{of}, not the same function) {st['dot_only_ms']:.4f} ms"
    if name.startswith("hamming"):
        limit, q, meta = args[4], args[0], args[3]
        words = -(-limit // 4)
        popc_ms = q.shape[0] * int((meta != 0).sum()) * words / (132 * 16 * sm_clock_hz()) * 1e3
        extra += f", estimate (not measured): __popc at 16/clock/SM {popc_ms:.4f} ms"
    qn = args[0].shape[0]
    log(f"{tag} {name} Q={qn}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
        f"{st['bound_ms']:.4f} ms ({st['bound_by']}: {nbytes:,} B, {ops:,} ops){extra} "
        f"(median of {reps}, CUDA events; {smi})")
    return st


# --------------------------------------------------------------------- #
# Phase 4: the engine


def write_images(folder, n, rng, prefix="img"):
    import numpy as np
    from PIL import Image

    paths = []
    for i in range(n):
        h, w = int(rng.integers(180, 360)), int(rng.integers(180, 360))
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        f = rng.uniform(0.01, 0.08, 3)
        ph = rng.uniform(0, 6.3, 3)
        img = np.stack([np.sin(xx * f[c] + yy * f[(c + 1) % 3] + ph[c]) for c in range(3)], -1)
        img = (127.5 + 100 * img + rng.normal(0, 12, img.shape)).clip(0, 255).astype(np.uint8)
        ext = "png" if i % 2 == 0 else "jpg"
        p = os.path.realpath(os.path.join(folder, f"{prefix}_{i:03d}.{ext}"))
        Image.fromarray(img).save(p, quality=92) if ext == "jpg" else Image.fromarray(img).save(p)
        paths.append(p)
    return paths


def phase_engine(fs, scan, smi, tmp, growth):
    import numpy as np
    import torch

    from pixelbox_tpu_torch.engine import Engine
    from pixelbox_tpu_torch.models.efficientnet import save_params, seeded_state_dict
    from pixelbox_tpu_torch.ops.packed import PackedSemanticIndex
    from pixelbox_tpu_torch.utils import timing

    rng = np.random.default_rng(SEED + 1)
    folder = os.path.join(tmp, "photos")
    os.makedirs(folder)
    paths = write_images(folder, 32, rng)
    ckpt = os.path.join(tmp, "b0_seeded.npz")
    save_params(seeded_state_dict(DIM, seed=SEED, input_size=224), ckpt)
    eng = Engine.new(
        os.path.join(tmp, "lib.db"), embedder="efficientnet", dim=DIM,
        embedder_kwargs={"checkpoint_path": ckpt, "input_size": 224}, device="cuda",
    )
    fs.reset_launch_counts()  # the main path starts here
    eng.add_tracked_folder(folder)
    eng.start_indexing()
    check(eng.wait_for_indexing(timeout=600), "indexing did not finish")
    pipe = eng.last_pipeline
    n_img = eng.get_num_indexed_images()
    check(n_img == 32, f"indexed {n_img} of 32 images")
    ips = n_img / pipe.elapsed_s
    log(f"[4] ingest: {n_img} images in {pipe.elapsed_s:.2f}s = {ips:.1f} images/s "
        f"(EfficientNet-B0 224², batch 64, cold start included; {smi})")

    eng.query_by_image_hash_from_file(paths[5])
    res = eng.get_query_results()
    check(res and res[0].path == paths[5] and res[0].distance_from_query == 0.0,
          f"self-match not first at 0.0: {[(r.path, r.distance_from_query) for r in (res or [])[:3]]}")
    log(f"[4] self-match: {os.path.basename(paths[5])} first at distance 0.0 ({len(res)} results)")

    # Warm ingest: a second folder through the same (now initialised) path.
    folder2 = os.path.join(tmp, "photos2")
    os.makedirs(folder2)
    write_images(folder2, 64, rng, prefix="more")
    eng.add_tracked_folder(folder2)
    eng.start_indexing()
    check(eng.wait_for_indexing(timeout=600), "second indexing did not finish")
    pipe2 = eng.last_pipeline
    check(pipe2.images_indexed == 64, f"indexed {pipe2.images_indexed} of 64 more images")
    n_img = eng.get_num_indexed_images()
    log(f"[4] ingest (warm): 64 images in {pipe2.elapsed_s:.2f}s = "
        f"{64 / pipe2.elapsed_s:.1f} images/s; {smi}")

    t0 = time.perf_counter()
    # Phase 6b's append brings the store to N_ROWS, inside its capacity.
    insert_synthetic(eng, growth.pop("syn")[: N_ROWS - APPEND_ROWS - n_img])
    check(eng._sem_store.n == N_ROWS - APPEND_ROWS, f"store did not reach {N_ROWS - APPEND_ROWS:,} rows")
    log(f"[4] grew the store to {eng._sem_store.n} rows (capacity "
        f"{eng._sem_store.device_index.capacity}) in {time.perf_counter() - t0:.1f}s")

    index = eng._sem_store.device_index
    cpu_index = PackedSemanticIndex(*(t.cpu() for t in index))
    out = {}
    for mode in ("auto", "pallas"):
        eng.scan_mode = mode
        eng.query_by_image_hash_from_file(paths[9])  # warm-up: builds the cached meta/sample
        timing.reset_stats()
        lat = []
        for rep in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            eng.query_by_image_hash_from_file(paths[9])
            lat.append(time.perf_counter() - t)
        spans = {n: round(s["mean_ms"], 3) for n, s in sorted(timing.get_stats().items())}
        res = eng.get_query_results()
        out[mode] = [(r.path, r.distance_from_query) for r in res]
        check(res[0].path == paths[9] and res[0].distance_from_query == 0.0, f"{mode}: self-match")
        log(f"[4] similar ({mode}) on {eng._sem_store.n:,} rows: end-to-end median "
            f"{statistics.median(lat) * 1e3:.2f} ms (decode+B0+scan); {smi}")
        log(f"[4] similar ({mode}) spans, mean ms over the 5 timed queries: {json.dumps(spans)}")
    counts = fs.launch_counts()  # the main path ends here; the timings below launch on their own
    log(f"[4] kernel launches on the main path: {json.dumps(counts)}")
    for n in ("cosine_threshold_collect", "cosine_chunk_topk", "lex_topk_select"):
        check(counts[n] > 0, f"kernel {n} was not launched on the main path")

    h = res[0].visual_hash
    for mode in ("auto", "pallas"):
        eng.scan_mode = mode
        scan_lat = []
        for rep in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            eng.similarity_scan(h, K, 1e3)
            torch.cuda.synchronize()
            scan_lat.append(time.perf_counter() - t)
        log(f"[4] similar ({mode}) scan alone (direct call, synchronized): median "
            f"{statistics.median(scan_lat) * 1e3:.3f} ms; {smi}")

    eng.scan_mode = "exact"
    eng.query_by_image_hash_from_file(paths[9])
    exact = [(r.path, r.distance_from_query) for r in eng.get_query_results()]
    check(out["auto"] == exact and out["pallas"] == exact, "engine results differ from the exact scan")
    q = torch.as_tensor(h)
    pd, pi = scan.cosine_scan_topk_auto(q, cpu_index, k=K, max_distance=1e3)
    d, i = eng.similarity_scan(h, K, 1e3)
    check(torch.equal(d.cpu(), pd) and torch.equal(i.cpu(), pi), "engine scan differs from the plain path")
    log(f"[4] auto and pallas results = exact scan = plain (CPU) path; top-3 "
        f"{[(os.path.basename(p), round(x, 6)) for p, x in exact[:3]]}")
    return counts, eng, ckpt, paths


# --------------------------------------------------------------------- #
# Phase 5: the phash engine and the duplicate finder


def run_cli(argv):
    """One CLI command in this process; returns its standard output."""
    import io
    from contextlib import redirect_stdout

    from pixelbox_tpu_torch.cli import main as cli_main

    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = cli_main(argv)
    check(rc == 0, f"CLI {' '.join(argv[:1])} exited {rc}")
    return buf.getvalue()


def phase_phash(fs, scan, hg, smi, tmp, sem_eng, ckpt, growth):
    import numpy as np
    import torch
    from PIL import Image

    from pixelbox_tpu_torch.engine import Engine
    from pixelbox_tpu_torch.ingest.decode import decode_image_file
    from pixelbox_tpu_torch.ops.phash import phash
    from pixelbox_tpu_torch.utils import timing

    rng = np.random.default_rng(SEED + 4)
    fs.reset_launch_counts()  # the phash path starts here
    libs = {}
    for compat in (False, True):
        folder = os.path.join(tmp, f"phash_photos_{int(compat)}")
        os.makedirs(folder)
        paths = write_images(folder, 24, rng, prefix="ph")  # random sizes: mixed aspects
        first = Image.open(paths[0]).convert("RGB")
        first.save(os.path.join(folder, "ph_copy.png"))
        first.save(os.path.join(folder, "ph_000_q70.jpg"), quality=70)
        db = os.path.join(tmp, f"phash_{int(compat)}.db")
        eng = Engine.new(
            db, embedder="efficientnet", dim=DIM, phash_compat=compat, device="cuda",
            embedder_kwargs={"checkpoint_path": ckpt, "input_size": 224},
        )
        eng.add_tracked_folder(folder)
        eng.start_indexing()
        check(eng.wait_for_indexing(timeout=600), "phash library: indexing did not finish")
        widths = sorted(set(eng._ph_widths))
        check(len(widths) > 1 if compat else widths == [PH_BYTES], f"phash widths {widths}")
        eng.close()
        probe = paths[3]
        got = run_cli(["phash-similar", db, probe, "--json", "--device", "cuda"])
        res = json.loads(got)
        check(res[0]["path"] == probe and res[0]["distance"] == 0.0,
              f"phash-similar self-match not first at 0.0: {res[:2]}")
        check(got == run_cli(["phash-similar", db, probe, "--json", "--device", "cpu"]),
              "phash-similar on the card differs from the plain (CPU) path")
        dup = run_cli(["duplicates", db, "--json", "--device", "cuda"])
        check(dup == run_cli(["duplicates", db, "--json", "--device", "cpu"]),
              "duplicates on the card differ from the plain (CPU) path")
        if not compat:
            # The ivf scan mode through the CLI on the card; at full nprobe
            # (4 of 4 clusters) = the plain (CPU) path on the stored hash.
            ivf = ["--json", "--scan-mode", "ivf", "--ivf-clusters", "4"]
            res = json.loads(run_cli(["similar", db, probe, *ivf, "--device", "cuda"]))
            check(res[0]["path"] == probe and res[0]["distance"] == 0.0,
                  f"similar --scan-mode ivf: self-match not first at 0.0: {res[:2]}")
            by_id = ["similar-id", db, str(res[0]["id"]), *ivf, "--nprobe", "4"]
            check(run_cli(by_id + ["--device", "cuda"]) == run_cli(by_id + ["--device", "cpu"]),
                  "similar-id --scan-mode ivf on the card differs from the plain (CPU) path")
            log(f"[5] CLI similar --scan-mode ivf (4 clusters) returns {os.path.basename(probe)} first "
                f"at 0.0 on the card; similar-id at full nprobe = the plain (CPU) path")
        pairs = json.loads(dup)
        check(len(pairs) >= 1, "duplicates found no pair in a library holding a copy")
        log(f"[5] phash_compat={compat}: 26 images, phash widths {widths}; phash-similar "
            f"(CLI) returns {os.path.basename(probe)} first at 0.0 ({len(res)} results); "
            f"duplicates {len(pairs)} pairs; both = the plain (CPU) path")
        libs[compat] = (db, paths)

    db, paths = libs[False]
    eng = Engine.open(db, device="cuda")
    n0 = eng._ph_store.n
    t0 = time.perf_counter()
    n_fill = N_ROWS - n0
    insert_synthetic(eng, growth.pop("ph")[:n_fill])
    check(eng._ph_store.n == N_ROWS, f"phash store did not reach {N_ROWS:,} rows")
    log(f"[5] grew the phash store to {eng._ph_store.n:,} rows x {eng._ph_store.dim} B "
        f"(capacity {eng._ph_store.device_index.capacity:,}) in {time.perf_counter() - t0:.1f}s")

    probe = paths[3]
    ph = phash(decode_image_file(probe).rgb, aspect_preserving=False)
    eng.query_by_phash(ph)  # warm-up: builds the cached row mask and θ sample
    timing.reset_stats()
    lat = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.query_by_phash(ph)
        lat.append(time.perf_counter() - t)
    spans = {n: round(v["mean_ms"], 3) for n, v in sorted(timing.get_stats().items())}
    res = eng.get_query_results()

    dups = []
    for e, by, md in ((eng, "phash", 0.1), (sem_eng, "semantic", 0.05)):
        timing.reset_stats()
        t = time.perf_counter()
        pairs = e.find_duplicate_pairs(max_distance=md, by=by)
        dt = time.perf_counter() - t
        span = timing.get_stats().get("engine.duplicate_scan", {}).get("total_s", float("nan"))
        dups.append((e, by, md, pairs, dt, span))
    counts = fs.launch_counts()  # the phash path ends here; the checks below launch on their own
    log(f"[5] kernel launches on the phash path: {json.dumps(counts)}")
    for n in ("hamming_threshold_collect", "hamming_chunk_topk", "lex_topk_select"):
        check(counts[n] > 0, f"kernel {n} was not launched on the phash path")

    check(res[0].path == probe and res[0].distance_from_query == 0.0, "query_by_phash: self-match")
    index = eng._ph_store.device_index
    ed, ei = scan.hamming_scan_topk(torch.from_numpy(ph).cuda(), index, k=K)
    keep = ei >= 0
    check([eng._ph_image_ids[int(r)] for r in ei[keep].cpu()] == [r.id for r in res]
          and ed[keep].cpu().tolist() == [r.distance_from_query for r in res],
          "query_by_phash differs from the plain exact scan")
    scan_lat = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng._phash_gemm_scan(ph, K, 1e3)
        torch.cuda.synchronize()
        scan_lat.append(time.perf_counter() - t)
    log(f"[5] query_by_phash on {N_ROWS:,} rows: end-to-end median "
        f"{statistics.median(lat) * 1e3:.2f} ms, scan alone (direct call, synchronized) median "
        f"{statistics.median(scan_lat) * 1e3:.3f} ms; = plain exact scan; {smi}")
    log(f"[5] query_by_phash spans, mean ms over the 5 timed queries: {json.dumps(spans)}")

    for e, by, md, pairs, dt, span in dups:
        store = e._ph_store if by == "phash" else e._sem_store
        row_map = e._ph_row_by_image if by == "phash" else e._sem_row_by_image
        rows = np.asarray(sorted(row_map.values()), dtype=np.int64)
        index = store.device_index
        for s in (0, len(rows) // 2, len(rows) - 256):
            qb = store.get_rows(rows[s : s + 256])
            if by == "phash":
                d1, i1 = e._phash_gemm_scan(qb, 8, md)
                d2, i2 = scan.hamming_scan_topk(torch.from_numpy(qb).cuda(), index, k=8, max_distance=md)
            else:
                smp = e._get_scan_sample()
                d1, i1 = scan.cosine_scan_topk_auto(
                    torch.from_numpy(qb).cuda(), index, k=8, max_distance=md, sample=smp,
                    row_meta=e._get_row_meta(),
                )
                d1, i1 = d1.cpu().numpy(), i1.cpu().numpy()
                d2, i2 = scan.cosine_scan_topk(torch.from_numpy(qb).cuda(), index, k=8, max_distance=md)
            check(np.array_equal(d1, d2.cpu().numpy()) and np.array_equal(i1, i2.cpu().numpy()),
                  f"duplicates by {by}: batch at row {s} differs from the plain exact scan")
        log(f"[5] find_duplicate_pairs(by={by}, max_distance={md}) over {len(rows):,} rows: "
            f"{len(pairs):,} pairs in {dt:.2f}s (engine.duplicate_scan {span:.2f}s; "
            f"{len(rows) / dt:,.0f} rows/s); 3 sampled batches = plain exact scan; {smi}")
        if by == "phash":
            check(len(pairs) >= n_fill // 1000, "duplicates by phash missed the planted near-dups")
    return counts, eng, paths


# --------------------------------------------------------------------- #
# Phase 6: the int4 engine (semantic4 store, exact-u8 rerank, duplicates)


def near_dup_hashes(rng, n):
    """``n`` clustered u8 hashes, every 1,000th pair a planted near-dup."""
    filler = clustered_hashes(rng, n, DIM)
    filler[1::1000] = perturb(rng, filler[0::1000][: len(filler[1::1000])], 3)
    return filler


def grow_semantic(eng, records, n_rows):
    """Insert the first of the hash-only ``records`` up to ``n_rows``
    semantic rows."""
    n0 = eng._sem_store.n if eng._sem_store is not None else 0
    insert_synthetic(eng, records[: n_rows - n0])
    check(eng._sem_store.n == n_rows, f"store did not reach {n_rows:,} rows")


def phase_int4_engine(fs, scan, smi, tmp, ckpt, growth):
    import numpy as np
    import torch

    from pixelbox_tpu_torch.engine import Engine
    from pixelbox_tpu_torch.ops import int4
    from pixelbox_tpu_torch.ops.packed import PackedSemanticIndex, semantic_rows_from_u8
    from pixelbox_tpu_torch.utils import timing

    rng = np.random.default_rng(SEED + 6)
    folder = os.path.join(tmp, "photos_int4")
    os.makedirs(folder)
    paths = write_images(folder, 32, rng, prefix="i4")
    kw = dict(embedder="efficientnet", dim=DIM, semantic_precision="int4", device="cuda",
              embedder_kwargs={"checkpoint_path": ckpt, "input_size": 224})
    fs.reset_launch_counts()  # the int4 path starts here
    eng = Engine.new(os.path.join(tmp, "int4.db"), **kw)
    eng.add_tracked_folder(folder)
    eng.start_indexing()
    check(eng.wait_for_indexing(timeout=600), "int4 library: indexing did not finish")
    check(eng._sem_store.kind == "semantic4" and eng._sem_store.device_index.data.shape[1] == DIM // 2,
          "the int4 library's store is not packed")
    eng.query_by_image_hash_from_file(paths[5])
    res = eng.get_query_results()
    check(res[0].path == paths[5] and res[0].distance_from_query == 0.0, "int4: self-match not first at 0.0")
    t0 = time.perf_counter()
    grow_semantic(eng, growth.pop("syn4"), N_ROWS)
    index = eng._sem_store.device_index
    log(f"[6] int4 library: 32 images, grown to {eng._sem_store.n:,} rows ({index.data.numel() / 2**20:.0f} MiB "
        f"of packed nibbles on the card, capacity {index.capacity:,}) in {time.perf_counter() - t0:.1f}s")

    # similar under auto with the exact-u8 rerank
    eng.query_by_image_hash_from_file(paths[9])  # warm-up: builds the cached meta/sample
    timing.reset_stats()
    lat = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.query_by_image_hash_from_file(paths[9])
        lat.append(time.perf_counter() - t)
    spans = {n: round(v["mean_ms"], 3) for n, v in sorted(timing.get_stats().items())}
    rerank_res = [(r.id, r.distance_from_query) for r in eng.get_query_results()]
    h = eng.get_query_results()[0].visual_hash
    eng.int4_rerank = False
    eng.query_by_image_hash_from_file(paths[9])
    raw_res = [(r.id, r.distance_from_query) for r in eng.get_query_results()]
    eng.int4_rerank = True

    # duplicates by semantic over the cut library
    dup = Engine.new(os.path.join(tmp, "int4_dup.db"), **{**kw, "embedder": "none"})
    grow_semantic(dup, synthetic_records("dup4", "visual_hash", near_dup_hashes(rng, INT4_DUP_ROWS)),
                  INT4_DUP_ROWS)
    timing.reset_stats()
    t = time.perf_counter()
    pairs = dup.find_duplicate_pairs(max_distance=0.05, by="semantic")
    dup_s = time.perf_counter() - t
    dstats = timing.get_stats()
    counts = fs.launch_counts()  # the int4 path ends here; the checks below launch on their own
    log(f"[6] kernel launches on the int4 path: {json.dumps(counts)}")
    for n in ("cosine4_threshold_collect", "cosine4_chunk_topk", "lex_topk_select"):
        check(counts[n] > 0, f"kernel {n} was not launched on the int4 path")

    check(rerank_res[0][1] == 0.0 and eng.catalog.get_image(rerank_res[0][0])["path"] == paths[9],
          "int4 rerank: self-match not first at 0.0")
    log(f"[6] similar (auto, int4 + exact-u8 rerank) on {N_ROWS:,} rows: end-to-end median "
        f"{statistics.median(lat) * 1e3:.2f} ms; {smi}")
    log(f"[6] similar spans, mean ms over the 5 timed queries: {json.dumps(spans)}")

    # Scan alone and rerank alone (direct calls, synchronized)
    c = int4.default_rerank_candidates(K)
    scan_lat, rr_lat = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        cd, ci = eng.similarity_scan(h, c, int4.UNBOUNDED_DISTANCE)
        torch.cuda.synchronize()
        scan_lat.append(time.perf_counter() - t)
        ci = ci.cpu().numpy()
        t = time.perf_counter()
        fd, fi = int4.rerank_candidates_u8(h, ci, eng._sem_store._host_rows, k=K, max_distance=1e3)
        rr_lat.append(time.perf_counter() - t)
    log(f"[6] similar int4 scan alone (k={c}, direct call, synchronized) median "
        f"{statistics.median(scan_lat) * 1e3:.3f} ms; host rerank alone (rerank_candidates_u8, "
        f"{c} candidates) median {statistics.median(rr_lat) * 1e3:.3f} ms; {smi}")

    # Against the plain (CPU) path, the u8 exact scan and the oracle
    cpu_index = int4.PackedSemantic4Index(*(x.cpu() for x in index))
    pd, pi = int4.cosine4_scan_topk_auto(torch.as_tensor(h), cpu_index, k=c,
                                         max_distance=int4.UNBOUNDED_DISTANCE)
    check(torch.equal(torch.as_tensor(cd).cpu(), pd) and np.array_equal(ci, pi.numpy()),
          "int4 engine scan differs from the plain (CPU) path")
    ids = eng._sem_image_ids
    want = [(ids[int(r)], float(x)) for x, r in zip(fd, fi) if r >= 0]
    check(rerank_res == want, "int4 similar (rerank) differs from the plain path + host rerank")
    host = eng._sem_store._host_rows[: eng._sem_store.n]
    od, oi = int4.cosine4a_scan_topk_np(h, host, k=K, max_distance=1e3)
    check(raw_res == [(ids[int(r)], float(x)) for x, r in zip(od[0], oi[0]) if r >= 0],
          "int4 similar (rerank off) differs from the numpy oracle")
    # recall@10 of the reranked results against the u8 exact scan, over
    # 256 perturbed stored rows and the query above
    qs = perturb(rng, host[rng.integers(0, len(host), MAIN_Q)])
    qs[0] = h
    u8 = PackedSemanticIndex(*(torch.from_numpy(x).cuda() for x in (*semantic_rows_from_u8(host),
                                                                    np.ones(len(host), bool))))
    _, ui = scan.cosine_scan_topk(torch.from_numpy(qs).cuda(), u8, k=10)
    _, ri = int4.scan_with_u8_rerank(
        lambda cc, md: tuple(x.cpu().numpy() for x in int4.cosine4_scan_topk_auto(
            torch.from_numpy(qs).cuda(), index, k=cc, max_distance=md,
            sample=eng._get_scan_sample(), meta=eng._get_row_meta())),
        qs, eng._sem_store._host_rows, k=10)
    _, ai = int4.cosine4_scan_topk_auto(torch.from_numpy(qs).cuda(), index, k=10,
                                        sample=eng._get_scan_sample(), meta=eng._get_row_meta())
    ui, ai = ui.cpu().numpy(), ai.cpu().numpy()
    recall = np.mean([len(set(ri[j]) & set(ui[j])) / 10 for j in range(MAIN_Q)])
    recall_raw = np.mean([len(set(ai[j]) & set(ui[j])) / 10 for j in range(MAIN_Q)])
    log(f"[6] int4 similar (rerank) = plain (CPU) path + host rerank; rerank off = numpy oracle "
        f"(self-distance {raw_res[0][1]:.6f}); recall@10 vs the u8 exact scan over {MAIN_Q} queries: "
        f"reranked {recall:.4f}, int4 alone {recall_raw:.4f}; top-3 {rerank_res[:3]}")
    del u8, cpu_index

    span = {n: dstats.get(n, {}).get("total_s", float("nan"))
            for n in ("engine.duplicate_scan", "engine.int4_scan", "engine.int4_scan_rerank")}
    log(f"[6] find_duplicate_pairs(by=semantic, max_distance=0.05) over {INT4_DUP_ROWS:,} int4 rows "
        f"(cut from 1M): {len(pairs):,} pairs in {dup_s:.2f}s ({INT4_DUP_ROWS / dup_s:,.0f} rows/s); "
        f"int4 scan {span['engine.int4_scan']:.2f}s, host rerank "
        f"{span['engine.int4_scan_rerank'] - span['engine.int4_scan']:.2f}s, pair loop "
        f"{span['engine.duplicate_scan'] - span['engine.int4_scan_rerank']:.2f}s; {smi}")
    check(len(pairs) >= INT4_DUP_ROWS // 1000, "int4 duplicates missed the planted near-dups")
    dindex = dup._sem_store.device_index
    rows = np.arange(dup._sem_store.n)
    for s in (0, len(rows) // 2, len(rows) - 256):
        qb = torch.from_numpy(dup._sem_store.get_rows(rows[s : s + 256])).cuda()
        d1, i1 = int4.cosine4_scan_topk_auto(qb, dindex, k=c, max_distance=int4.UNBOUNDED_DISTANCE,
                                             sample=dup._get_scan_sample(), meta=dup._get_row_meta())
        d2, i2 = int4.cosine4a_scan_topk(qb, dindex, k=c, max_distance=int4.UNBOUNDED_DISTANCE)
        check(torch.equal(d1, d2) and torch.equal(i1, i2),
              f"int4 duplicates: batch at row {s} differs from the plain exact scan")
    log("[6] int4 duplicates: 3 sampled candidate batches = plain exact scan")
    dup.close()
    return counts, eng


# --------------------------------------------------------------------- #
# Phase 6b: the IVF clustered index (scan_mode "ivf") on the card


def ivf_work(args, out):
    """(bytes, ops, K1c's bytes) of K5's function on these inputs, the JAX
    ``_ivf_probe_topk`` up to its tree merge: every distinct probed
    bucket's rows and meta read once (data, sum, mag2, row id, valid), the
    queries and their bucket ids, and the [Q, P, k'] (dist, id) partials
    written (the first port's kernel: [Q, P·cap], every slot); ops the
    int8 products of the valid probed slots (D a slot, int4 buckets
    unpacked to D).  K1c then reads those partials: their bytes are
    logged beside the bound."""
    import torch

    q_codes, bids, bdata, bvalid = args[0], args[5], args[6], args[10]
    qn, d = q_codes.shape
    cap = bdata.shape[1]
    distinct = int(torch.unique(bids).numel())
    per_bucket = cap * (bdata.shape[2] + 13)
    valid_slots = int(bvalid[bids.long()].sum())
    partials = out[0].numel() * 8
    nbytes = distinct * per_bucket + qn * (d + 16) + bids.numel() * 4 + partials
    return nbytes, 2 * valid_slots * d, partials


def gathered_work(args, out):
    """(bytes, ops, split bytes) of K5's gathered mode: each candidate's
    id and row read once and the queries; ops 2·D a valid candidate.  The
    [Q, M] (dist, id) buffer K1c selects from comes apart, outside the
    bound."""
    q_codes, cand, rows = args[0], args[5], args[6]
    qn, d = q_codes.shape
    ok = int(((cand >= 0) & (cand < rows.shape[0])).sum())
    return cand.numel() * 4 + ok * d + qn * (d + 16), 2 * ok * d, out[0].numel() * 8


def l2_cold_ms(fns, reps=10):
    """Device time of one launch of each function, in turns, with the 50 MB
    L2 flushed first (256 MiB written just before it, so the launch queues
    behind the flush and the events bracket its device work alone);
    medians of ``reps``."""
    import torch

    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    for f in fns:
        f()
    times = [[] for _ in fns]
    for _ in range(reps):
        for j, f in enumerate(fns):
            flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            f()
            e.record()
            torch.cuda.synchronize()
            times[j].append(s.elapsed_time(e))
    del flush
    return [statistics.median(t) for t in times]


def bound_of(nbytes, ops):
    """(bound ms, what bounds it): bytes at the HBM rate, int8 ops at the
    tensor cores' rate."""
    b_bytes, b_ops = nbytes / HBM_BPS * 1e3, ops / INT8_OPS * 1e3
    return max(b_bytes, b_ops), "bytes" if b_bytes >= b_ops else "operations"


def time_ivf_probe(fs, call, smi, tag, err, reps=10):
    """K5's recorded call (``ivf_probe_topk``): the first port's kernel on
    the same inputs, its K1c result held equal to the new kernel's and its
    partials to its plain version (errors under its own name); then in
    turns with it, a call, on the device and with L2 flushed, each kernel
    alone and with its K1c; the plain versions; the work list
    (``ivf_probe_invert``, where the probe builds one) alone; against their
    bounds."""
    import torch

    from pixelbox_tpu_torch.ops import ivf

    name, args, kwargs, out = call
    k, qn, bids = args[-1], args[0].shape[0], args[5]
    new = lambda: ivf.ivf_probe_topk(*args)  # noqa: E731
    old = lambda: ivf.ivf_probe_collect_dp4a(*args[:-1])  # noqa: E731

    def new_k1c():
        d, i = new()
        return fs.lex_topk(d.reshape(qn, -1), i.reshape(qn, -1), k)

    def old_k1c():
        return fs.lex_topk(*old(), k)

    a, b = new_k1c(), old_k1c()
    check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
          f"{tag} K5 + K1c differs from the first port's K5 + K1c")
    old_out = old()
    with PlainOnCard.replaying():
        ref = ivf.ivf_probe_collect_plain(*args[:-1])
    check(torch.equal(old_out[0], ref[0]) and torch.equal(old_out[1], ref[1]),
          f"{tag} ivf_probe_collect_dp4a differs from plain")
    err["ivf_probe_collect_dp4a"] = max(err["ivf_probe_collect_dp4a"], max_abs_err(a[0], b[0]),
                                        max_abs_err(old_out[0], ref[0]))
    ms, prev_ms = interleaved_ms([new, old], reps)
    g_ms, prev_g = gpu_ms([new, old])
    cold, prev_cold = l2_cold_ms([new, old], reps)
    comp_ms, prev_comp_ms = interleaved_ms([new_k1c, old_k1c], reps)
    comp_g, prev_comp_g = gpu_ms([new_k1c, old_k1c])
    with PlainOnCard.replaying():
        p_ms = median_ms(lambda: ivf.ivf_probe_topk_plain(*args), 3)
        prev_p_ms = median_ms(lambda: ivf.ivf_probe_collect_plain(*args[:-1]), 3)
    nbytes, ops, k1c_bytes = ivf_work(args, out)
    prev_bytes, _, prev_k1c_bytes = ivf_work(args[:-1], old_out)
    bound, by = bound_of(nbytes, ops)
    prev_bound, prev_by = bound_of(prev_bytes, ops)
    st = {"ms": ms, "gpu_ms": g_ms, "cold_gpu_ms": cold, "plain_ms": p_ms, "bound_ms": bound, "bound_by": by,
          "bytes": nbytes, "ops": ops, "k1c_buffer_bytes": k1c_bytes, "library_ms": None,
          "with_k1c_ms": comp_ms, "with_k1c_gpu_ms": comp_g,
          "previous_ms": prev_ms, "previous_gpu_ms": prev_g, "previous_cold_gpu_ms": prev_cold,
          "previous_plain_ms": prev_p_ms, "previous_bound_ms": prev_bound, "previous_bound_by": prev_by,
          "previous_k1c_buffer_bytes": prev_k1c_bytes, "previous_with_k1c_ms": prev_comp_ms,
          "previous_with_k1c_gpu_ms": prev_comp_g, "k_prime": out[0].shape[-1]}
    log(f"{tag} ivf_probe_topk Q={qn} x {bids.shape[1]} buckets x cap {args[6].shape[1]}, k={k} (k'="
        f"{st['k_prime']}) vs ivf_probe_collect_dp4a in turns (K1c results equal): {ms:.4f} / {prev_ms:.4f} "
        f"ms a call, device {g_ms:.4f} / {prev_g:.4f} ({prev_g / g_ms:.2f}x), L2 flushed {cold:.4f} / "
        f"{prev_cold:.4f}; with K1c {comp_ms:.4f} / {prev_comp_ms:.4f} ms a call, device {comp_g:.4f} / "
        f"{prev_comp_g:.4f}; plain {p_ms:.4f} / {prev_p_ms:.4f} ms; bound {bound:.4f} / {prev_bound:.4f} ms "
        f"({by}: {nbytes:,} / {prev_bytes:,} B, {ops:,} ops; K1c reads {k1c_bytes:,} / {prev_k1c_bytes:,} "
        f"B); no one library call computes it (CUDA events; {smi})")
    c = args[6].shape[0]
    if ivf.shares_buckets(qn, bids.shape[1], c):
        inv = lambda: ivf.ivf_probe_invert(bids, c)  # noqa: E731
        work = inv()
        with PlainOnCard.replaying():
            inv_p_ms = median_ms(lambda: ivf.ivf_probe_invert_plain(bids, c), 3)
        inv_bytes = bids.numel() * 4 + (1 + int(work[0]) * (1 + ivf.IVF_PROBE_NQ)) * 4
        inv_bound, inv_by = bound_of(inv_bytes, 0)
        st["invert"] = {"ms": median_ms(inv, reps), "gpu_ms": gpu_ms([inv])[0], "plain_ms": inv_p_ms,
                        "bound_ms": inv_bound, "bound_by": inv_by, "items": int(work[0]),
                        "library_ms": None}
        log(f"{tag} ivf_probe_invert {bids.numel():,} pairs over {c:,} buckets -> {int(work[0]):,} work items: "
            f"{st['invert']['ms']:.4f} ms a call, {st['invert']['gpu_ms']:.4f} device; plain {inv_p_ms:.4f} ms; "
            f"bound {inv_bound:.4f} ms ({inv_bytes:,} B) ({smi})")
    return st


def time_ivf_kernel(call, smi, tag, reps=10):
    """K5's gathered mode: a call and on the device (CUDA events), its
    plain version on the card, against its bound."""
    from pixelbox_tpu_torch.ops import ivf

    name, args, kwargs, out = call
    kern, plain = getattr(ivf, name), getattr(ivf, name + "_plain")
    k_ms = median_ms(lambda: kern(*args, **kwargs), reps)
    g_ms = gpu_ms([lambda: kern(*args, **kwargs)])[0]
    cold_ms = l2_cold_ms([lambda: kern(*args, **kwargs)], reps)[0]
    with PlainOnCard.replaying():
        p_ms = median_ms(lambda: plain(*args, **kwargs), 3)
    nbytes, ops, split = gathered_work(args, out)
    bound, by = bound_of(nbytes, ops)
    st = {"ms": k_ms, "gpu_ms": g_ms, "cold_gpu_ms": cold_ms, "plain_ms": p_ms,
          "bound_ms": bound, "bound_by": by,
          "bytes": nbytes, "ops": ops, "split_out_bytes": split, "split_out_ms": split / HBM_BPS * 1e3,
          "library_ms": None}
    log(f"{tag} {name} Q={args[0].shape[0]} x {args[5].shape[1]} candidates: kernel {k_ms:.4f} ms a call, "
        f"{g_ms:.4f} device ({cold_ms:.4f} with L2 flushed before each launch); plain {p_ms:.4f} ms; "
        f"bound {bound:.4f} ms ({by}: {nbytes:,} B, {ops:,} ops; the split-off "
        f"selection's buffer {split:,} B more, {st['split_out_ms']:.4f} ms at the memory rate); no one library "
        f"call computes it (median of {reps}, CUDA events; {smi})")
    return st


def device_kernels(fn) -> int:
    """Device kernels (and copies) one call of ``fn`` runs, counted by
    ``torch.profiler`` (CUPTI)."""
    import torch
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


def phase_ivf(fs, scan, hg, smi, err, sem_eng, sem_paths, ph_eng, i4_eng):
    """Phase 6b: phase 4's 1M-row engine and phase 6's int4 engine under
    ``scan_mode = "ivf"`` (default clusters), and the scans' k past MAX_K
    once per kind.  Launches counted from 0 around each main-path step;
    every launch recorded and replayed bit-identical through its plain
    version."""
    import numpy as np
    import torch

    from pixelbox_tpu_torch.engine import Engine
    from pixelbox_tpu_torch.ops import int4
    from pixelbox_tpu_torch.ops import ivf as ivf_mod
    from pixelbox_tpu_torch.ops import ivf_build
    from pixelbox_tpu_torch.ops.packed import PackedHammingIndex, PackedSemanticIndex
    from pixelbox_tpu_torch.records import IndexedImage
    from pixelbox_tpu_torch.utils import timing

    rng = np.random.default_rng(SEED + 9)
    counts = {n: 0 for n in fs.LAUNCHES}
    replayed = {"calls": {}, "s": 0.0}
    stats = {"by_q": {}}
    rec = Recorder(fs)

    def counted(fn):
        """The main path: launch counts from 0 just before ``fn`` and read
        just after, its calls recorded for the replays (the timings and
        the reference scans around it are neither)."""
        fs.reset_launch_counts()
        with rec:
            out = fn()
        for n, c in fs.launch_counts().items():
            counts[n] += c
        return out

    def results(e):
        return [(r.id, r.distance_from_query) for r in e.get_query_results()]

    eng, store = sem_eng, sem_eng._sem_store
    eng.scan_mode, eng.ivf_nprobe, eng.ivf_clusters = "ivf", None, None
    timing.reset_stats()
    t0 = time.perf_counter()
    counted(lambda: eng.query_by_image_hash_from_file(sem_paths[9]))  # trains and packs
    first_s = time.perf_counter() - t0
    spans = timing.get_stats()
    ivf = eng._ivf
    res = eng.get_query_results()
    check(res[0].path == sem_paths[9] and res[0].distance_from_query == 0.0, "ivf: self-match")
    nprobe = ivf_mod.default_nprobe(ivf.n_clusters)
    mb = sum(t.numel() * t.element_size() for t in ivf[1:6]) / 2**20
    log(f"[6b] ivf on {store.n:,} rows: {ivf.n_clusters:,} clusters (default), cap {ivf.bucket_cap}, "
        f"{mb:.0f} MiB of buckets, spill {len(ivf_mod.live_spill_ids(ivf)):,} rows; first query "
        f"{first_s:.2f}s: engine.ivf_train {spans['engine.ivf_train']['total_s']:.2f}s, "
        f"engine.ivf_build {spans['engine.ivf_build']['total_s']:.2f}s; default nprobe {nprobe}; {smi}")
    timing.reset_stats()
    lat = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        counted(lambda: eng.query_by_image_hash_from_file(sem_paths[9]))
        lat.append(time.perf_counter() - t)
    spans = {n: round(v["mean_ms"], 3) for n, v in sorted(timing.get_stats().items())}
    log(f"[6b] similar (ivf, nprobe {nprobe}) end-to-end median {statistics.median(lat) * 1e3:.2f} ms; "
        f"spans, mean ms over the 5: {json.dumps(spans)}; {smi}")
    replay_recorded(fs, err, rec, replayed)

    # The scan alone at Q = 1 / 8 / 256 and K5 against its bound.
    index, smp, meta = store.device_index, eng._get_scan_sample(), eng._get_row_meta()
    qs = torch.from_numpy(perturb(rng, store._host_rows[rng.integers(0, store.n, MAIN_Q)])).cuda()
    for qn in IVF_QS:
        q = qs[:qn]
        counted(lambda: ivf_mod.ivf_scan_topk(q, ivf, k=K))
        k5 = next(c for c in rec.calls if c[0] == "ivf_probe_topk")
        replay_recorded(fs, err, rec, replayed)
        host = []
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            ivf_mod.ivf_scan_topk(q, ivf, k=K)
            torch.cuda.synchronize()
            host.append(time.perf_counter() - t)
        scan_ms = median_ms(lambda: ivf_mod.ivf_scan_topk(q, ivf, k=K))
        exact_ms = median_ms(lambda: scan.cosine_scan_topk_auto(q, index, k=K, sample=smp, row_meta=meta))
        st = time_ivf_probe(fs, k5, smi, f"[6b] Q={qn}", err)
        st.update(scan_ms=scan_ms, scan_host_ms=statistics.median(host) * 1e3, auto_ms=exact_ms,
                  device_kernels=device_kernels(lambda: ivf_mod.ivf_scan_topk(q, ivf, k=K)),
                  auto_device_kernels=device_kernels(
                      lambda: scan.cosine_scan_topk_auto(q, index, k=K, sample=smp, row_meta=meta)))
        stats["by_q"][qn] = st
        log(f"[6b] ivf_scan_topk Q={qn} k={K} nprobe {nprobe}: {scan_ms:.4f} ms a call (CUDA events), "
            f"{st['scan_host_ms']:.3f} ms host clock + synchronize, {st['device_kernels']} device kernels "
            f"a call (torch.profiler); the exact auto scan {exact_ms:.4f} ms, {st['auto_device_kernels']} "
            f"kernels; {smi}")
    stats.update(stats["by_q"][MAIN_Q])

    # Full nprobe = the exact scan, bit for bit; recall@10 at the default.
    q8 = qs[:8]
    got = counted(lambda: ivf_mod.ivf_scan_topk(q8, ivf, k=K, nprobe=ivf.n_clusters))
    want = scan.cosine_scan_topk_auto(q8, index, k=K, sample=smp, row_meta=meta)
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          "ivf at full nprobe differs from the exact scan")
    replay_recorded(fs, err, rec, replayed)
    _, gi = counted(lambda: ivf_mod.ivf_scan_topk(qs, ivf, k=10))
    _, ei = scan.cosine_scan_topk_auto(qs, index, k=10, sample=smp, row_meta=meta)
    gi, ei = gi.cpu().numpy(), ei.cpu().numpy()
    recall = float(np.mean([len(set(gi[j]) & set(ei[j])) / 10 for j in range(MAIN_Q)]))
    stats["recall_at_10"] = recall
    replay_recorded(fs, err, rec, replayed)
    log(f"[6b] ivf at full nprobe ({ivf.n_clusters:,}), Q=8 = the exact scan bit for bit; recall@10 at "
        f"nprobe {nprobe} over {MAIN_Q} perturbed stored rows against the exact scan: {recall:.4f}")

    # A pure append extends the spill; full nprobe still = the exact scan.
    filler = clustered_hashes(rng, APPEND_ROWS, DIM)
    eng.insert_records_batch([
        IndexedImage(filename=f"ivf_{j:05d}.png", path=f"/synthetic/ivf_{j:05d}.png", visual_hash=filler[j])
        for j in range(APPEND_ROWS)])
    timing.reset_stats()
    counted(lambda: eng.query_by_image_hash_from_id(eng._sem_image_ids[-3]))
    spans = timing.get_stats()
    check("engine.ivf_extend" in spans and "engine.ivf_build" not in spans and eng._ivf.bucket_data is
          ivf.bucket_data, f"the append did not extend the spill: {sorted(spans)}")
    check(results(eng)[0] == (eng._sem_image_ids[-3], 0.0), "ivf: the appended row's self-match")
    ivf = eng._ivf
    index, smp, meta = store.device_index, eng._get_scan_sample(), eng._get_row_meta()
    got = counted(lambda: ivf_mod.ivf_scan_topk(q8, ivf, k=K, nprobe=ivf.n_clusters))
    want = scan.cosine_scan_topk_auto(q8, index, k=K, sample=smp, row_meta=meta)
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          "ivf after the append: full nprobe differs from the exact scan")
    replay_recorded(fs, err, rec, replayed)
    log(f"[6b] +{APPEND_ROWS:,} rows ({store.n:,}): engine.ivf_extend "
        f"{spans['engine.ivf_extend']['total_s'] * 1e3:.1f} ms, no engine.ivf_build; spill "
        f"{len(ivf_mod.live_spill_ids(ivf)):,} rows; full nprobe = the exact scan")

    # A reopen reads the sidecar: no retrain, the same results (at full
    # nprobe: the reopened engine packs the appended rows into buckets).
    eng.ivf_nprobe = 1 << 30
    eng.query_by_image_hash_from_id(eng._sem_image_ids[-3])
    want = results(eng)
    eng.ivf_nprobe = None
    timing.reset_stats()
    t0 = time.perf_counter()
    again = Engine.open(eng.db_path, device="cuda")
    again.scan_mode, again.ivf_nprobe = "ivf", 1 << 30
    counted(lambda: again.query_by_image_hash_from_id(eng._sem_image_ids[-3]))
    check("engine.ivf_train" not in timing.get_stats(), "the reopened engine retrained")
    check(np.array_equal(again._ivf_centroids, eng._ivf_centroids) and results(again) == want,
          "the reopened engine differs")
    log(f"[6b] reopened in {time.perf_counter() - t0:.1f}s: the sidecar read, no engine.ivf_train, "
        f"results = before")
    again.close()
    del again
    replay_recorded(fs, err, rec, replayed)

    # The int4 engine: ivf with the rerank at full nprobe = the flat int4
    # path; tune_nprobe once (the device rerank, K5's gathered mode).
    i4 = i4_eng
    ids = [int(x) for x in rng.choice(i4._sem_image_ids, 3, replace=False)]
    i4.scan_mode = "auto"
    flat = []
    for i in ids:
        i4.query_by_image_hash_from_id(i)
        flat.append(results(i4))
    i4.scan_mode, i4.ivf_nprobe = "ivf", 1 << 30
    t0 = time.perf_counter()
    for i, w in zip(ids, flat):
        counted(lambda: i4.query_by_image_hash_from_id(i))
        check(results(i4) == w, f"int4 ivf at full nprobe (rerank) differs from the flat path, id {i}")
    i4_ivf = i4._ivf
    log(f"[6b] int4 ivf: {i4_ivf.n_clusters:,} clusters, cap {i4_ivf.bucket_cap}, nibble buckets; "
        f"{len(ids)} similar at full nprobe with the rerank = the flat int4 path "
        f"({time.perf_counter() - t0:.1f}s, the build included)")
    replay_recorded(fs, err, rec, replayed)
    i4s = i4._sem_store
    t0 = time.perf_counter()
    tuned, rec_at = counted(lambda: ivf_build.tune_nprobe(
        i4_ivf, i4s._host_rows[: i4s.n], target_recall=0.99, valid=i4s._host_valid[: i4s.n]))
    tune_s = time.perf_counter() - t0
    g = next(c for c in rec.calls if c[0] == "ivf_gathered_collect")
    replay_recorded(fs, err, rec, replayed)
    stats["gathered"] = time_ivf_kernel(g, smi, "[6b] tune_nprobe's rerank")
    log(f"[6b] tune_nprobe(int4, target 0.99): nprobe {tuned}, recall@10 {rec_at:.4f}, {tune_s:.1f}s; {smi}")
    i4.scan_mode, i4.ivf_nprobe = "auto", None

    # k past MAX_K, once per kind, through the engines: = the plain versions.
    eng.scan_mode = "auto"
    h = store.get_rows([3])[0]
    cpu_index = PackedSemanticIndex(*(t.cpu() for t in index))
    got = counted(lambda: eng.similarity_scan(h, 1500, 1e3))
    want = scan.cosine_scan_topk_auto(torch.as_tensor(h), cpu_index, k=1500)
    check(torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1]), "u8 k=1500")
    del cpu_index
    replay_recorded(fs, err, rec, replayed)
    h4 = i4s.get_rows([5])[0]
    cpu4 = int4.PackedSemantic4Index(*(t.cpu() for t in i4s.device_index))
    got = counted(lambda: i4._int4_scan_rerank(lambda c, md: i4.similarity_scan(h4, c, md), h4, 300, 1e3))

    def plain4(c, md):
        return tuple(x.numpy() for x in int4.cosine4_scan_topk_auto(torch.as_tensor(h4), cpu4, k=c,
                                                                    max_distance=md))

    want = int4.scan_with_u8_rerank(plain4, h4, i4s._host_rows, k=300)
    check(np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1]), "int4 user k=300")
    del cpu4
    replay_recorded(fs, err, rec, replayed)
    pst = ph_eng._ph_store
    hp = pst.get_rows([7])
    pidx = pst.device_index
    got = counted(lambda: hg.hamming_gemm_scan_topk_auto(torch.from_numpy(hp).cuda(), pidx, k=1500))
    cpuh = PackedHammingIndex(*(t.cpu() for t in pidx))
    want = hg.hamming_gemm_scan_topk_auto(torch.from_numpy(hp), cpuh, k=1500)
    check(torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1]), "phash k=1500")
    replay_recorded(fs, err, rec, replayed)
    log(f"[6b] k past MAX_K ({fs.MAX_K}): u8 k=1500 over {store.n:,} rows, int4 user k=300 "
        f"(C={int4.default_rerank_candidates(300)}) over {i4s.n:,}, phash k=1500 over {pst.n:,} "
        f"= their plain versions")
    log(f"[6b] kernel launches on the ivf path: {json.dumps(counts)}")
    for n in ("ivf_probe_topk", "ivf_probe_invert", "ivf_gathered_collect", "lex_topk_select",
              "cosine_chunk_topk"):
        check(counts[n] > 0, f"kernel {n} was not launched on the ivf path")
    log(f"[6b] {sum(replayed['calls'].values())} kernel calls replayed bit-identical through their plain "
        f"versions in {replayed['s']:.1f}s: {json.dumps(replayed['calls'])}")
    check(replayed["calls"] == {n: c for n, c in counts.items() if c},
          "the replays do not cover every launch of the ivf path")
    return counts, stats


# --------------------------------------------------------------------- #
# Phase 7: the web server and its batching service on the card


def http_burst(reqs):
    """Fire ``reqs`` — (endpoint, url, body or None) — all at once, one
    thread each; returns ([(endpoint, status, JSON, start, end)], wall s).
    Any HTTP error raises."""
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    def one(r):
        label, url, body = r
        req = urllib.request.Request(url, data=body, method="GET" if body is None else "POST")
        t = time.perf_counter()
        with urllib.request.urlopen(req, timeout=300) as resp:
            out = json.loads(resp.read())
            status = resp.status
        return label, status, out, t, time.perf_counter()

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(reqs)) as ex:
        res = list(ex.map(one, reqs))
    return res, time.perf_counter() - t0


def log_burst(tag, res, wall, smi):
    """Requests/s, p50 and p99 per endpoint (host clock, client side)."""
    import numpy as np

    log(f"{tag} {len(res)} requests in {wall * 1e3:.1f} ms = {len(res) / wall:.1f} requests/s; {smi}")
    for label in sorted({r[0] for r in res}):
        mine = [r for r in res if r[0] == label]
        lat = np.array([(r[4] - r[3]) * 1e3 for r in mine])
        span = max(r[4] for r in mine) - min(r[3] for r in mine)
        log(f"{tag}   {label}: {len(mine)} requests, {len(mine) / span:.1f}/s, "
            f"p50 {np.percentile(lat, 50):.2f} ms, p99 {np.percentile(lat, 99):.2f} ms")


def service_burst(svc, queries, kind="semantic"):
    """``svc.submit`` (of ``kind``) from one thread a query, all released
    at once; returns the per-query (dist, rows)."""
    import threading

    out = [None] * len(queries)
    start = threading.Barrier(len(queries))

    def one(j):
        start.wait(timeout=60)
        out[j] = svc.submit(queries[j], timeout=300, kind=kind)

    threads = [threading.Thread(target=one, args=(j,)) for j in range(len(queries))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    check(all(r is not None for r in out), "service burst: a submit did not return")
    return out


def with_gc_ms(fn):
    """Run ``fn``; returns (its result, ms that Python's cyclic garbage
    collector ran meanwhile, the oldest generation it collected or -1)."""

    spent, start, oldest = [0.0], [0.0], [-1]

    def timer(phase, info):
        if phase == "start":
            start[0] = time.perf_counter()
        else:
            spent[0] += time.perf_counter() - start[0]
            oldest[0] = max(oldest[0], info["generation"])

    gc.callbacks.append(timer)
    try:
        out = fn()
    finally:
        gc.callbacks.remove(timer)
    return out, spent[0] * 1e3, oldest[0]


def phase_serving(fs, smi, sem_eng, sem_paths, ph_eng, ph_paths, i4_eng):
    import threading
    import urllib.request

    import numpy as np

    from pixelbox_tpu_torch.records import IndexedImage
    from pixelbox_tpu_torch.serve import _serialize_results, build_scan_service, make_server
    from pixelbox_tpu_torch.serving.service import _BUCKETS

    rng = np.random.default_rng(SEED + 7)
    counts = {n: 0 for n in fs.LAUNCHES}
    servers = []

    def counted(fn):
        """Run ``fn`` with every launch count set to 0 first and add the
        counts just after: the serving path's launches, none of the
        direct calls that check it."""
        fs.reset_launch_counts()
        out = fn()
        for n, c in fs.launch_counts().items():
            counts[n] += c
        return out

    def start(eng):
        svc = build_scan_service(eng)
        srv = make_server(eng, "127.0.0.1", 0, svc)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        servers.append((srv, svc))
        return svc, f"http://127.0.0.1:{srv.server_address[1]}"

    def direct_id(eng, image_id):
        eng.query_by_image_hash_from_id(image_id)
        return _serialize_results(eng.get_query_results())

    def same(got, want, what):
        check(got == json.loads(json.dumps(want)), f"{what}: the server's JSON differs from the engine's direct call")

    def post(url, path, body):
        req = urllib.request.Request(url + path, data=json.dumps(body).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            return json.loads(r.read())

    for eng in (sem_eng, ph_eng, i4_eng):
        eng.scan_mode = "auto"
    t0 = time.perf_counter()
    svc, url = counted(lambda: start(sem_eng))
    ph_svc, ph_url = counted(lambda: start(ph_eng))
    log(f"[7] two servers up (services warmed at every bucket) in {time.perf_counter() - t0:.2f}s")

    ids = list(sem_eng._sem_image_ids[:8]) + [  # indexed photos, then hash-only rows
        int(x) for x in rng.choice(sem_eng._sem_image_ids[8:], 56, replace=False)]
    up = [open(p, "rb").read() for p in sem_paths[:16]]
    ph_up = [open(p, "rb").read() for p in ph_paths[:16]]

    def burst_reqs():
        return ([("GET /api/similar?id=", f"{url}/api/similar?id={i}", None) for i in ids]
                + [("POST /api/similar", f"{url}/api/similar", b) for b in up]
                + [("POST /api/phash-similar", f"{ph_url}/api/phash-similar", b) for b in ph_up])

    res, wall = counted(lambda: http_burst(burst_reqs()))
    log_burst("[7] burst 1:", res, wall, smi)
    for (label, _, out, _, _), i in zip(res[:64], ids):
        same(out, direct_id(sem_eng, i), f"{label}{i}")
        check(out[0]["id"] == i and out[0]["distance"] == 0.0, f"similar?id={i}: not first at 0.0")
    for (label, _, out, _, _), b in zip(res[64:80], up):
        sem_eng.query_by_image_hash_from_image(sem_eng.load_image_from_memory(b, "upload", ""))
        same(out, _serialize_results(sem_eng.get_query_results()), label)
    for (label, _, out, _, _), b in zip(res[80:], ph_up):
        ph_eng.query_by_phash(ph_eng.load_image_from_memory(b, "upload", "").phash)
        same(out, _serialize_results(ph_eng.get_query_results()), label)
    for name, s, n_req in (("u8", svc, 80), ("phash", ph_svc, 16)):
        check(s.batches_run < n_req, f"{name} service: {s.batches_run} batches for {n_req} requests")
        log(f"[7] {name} service: {s.queries_served} queries in {s.batches_run} batches "
            f"(mean batch {s.queries_served / s.batches_run:.1f}, warm-up excluded)")
    log("[7] burst 1: all 96 responses = the engine's direct calls")

    # Mutations the next burst must see: a tag, a tombstone of a top hit,
    # and an append of seeded rows holding exact copies of the queries.
    tagged = ids[3]
    check(post(url, "/api/tag", {"id": tagged, "name": "smoke", "value": "servedtag"})["tags"]
          .get("smoke") == "servedtag", "/api/tag")
    with urllib.request.urlopen(f"{url}/api/search?q=tag:servedtag", timeout=300) as r:
        check([x["id"] for x in json.loads(r.read())] == [tagged], "search tag: does not see the new tag")
    victim = next(x["id"] for x in res[0][2][1:] if x["id"] not in ids)  # a top hit, not a query
    check(post(url, "/api/remove", {"id": victim}) == {"removed": victim}, "/api/remove")
    copies = np.stack([sem_eng._sem_store.get_rows([sem_eng._sem_row_by_image[i]])[0] for i in ids])
    fresh = np.concatenate([copies, clustered_hashes(rng, APPEND_ROWS - len(ids), DIM)])
    new_ids = sem_eng.insert_records_batch([
        IndexedImage(filename=f"app_{j:04d}.png", path=f"/synthetic/app_{j:04d}.png", visual_hash=fresh[j])
        for j in range(APPEND_ROWS)])
    log(f"[7] mutated: tagged {tagged}, removed {victim}, appended {APPEND_ROWS} rows "
        f"(store {sem_eng._sem_store.n:,} rows, capacity {sem_eng._sem_store.device_index.capacity:,})")

    res2, wall2 = counted(lambda: http_burst(burst_reqs()[:80]))
    log_burst("[7] burst 2:", res2, wall2, smi)
    for (label, _, out, _, _), i, copy_id in zip(res2[:64], ids, new_ids):
        same(out, direct_id(sem_eng, i), f"after the mutations, {label}{i}")
        got = [x["id"] for x in out]
        check(got[:2] == [i, copy_id] and out[1]["distance"] == 0.0,
              f"similar?id={i}: the appended copy is not second at 0.0")
        check(victim not in got, f"similar?id={i}: the removed image {victim} came back")
        if i == tagged:
            check(out[0]["tags"].get("smoke") == "servedtag", "the tag is missing from the results")
    for (label, _, out, _, _), b in zip(res2[64:80], up):
        sem_eng.query_by_image_hash_from_image(sem_eng.load_image_from_memory(b, "upload", ""))
        same(out, _serialize_results(sem_eng.get_query_results()), f"after the mutations, {label}")
    log("[7] burst 2: all 80 responses = direct calls; every appended copy found, the removed image gone")

    def full_bucket(s, eng, tag):
        """A full bucket straight into a service against the same service's
        dist-path scan of the queries in two half buckets; returns the
        queries and the results."""
        full = _BUCKETS[-1]
        rows = eng._sem_store.get_rows(rng.choice(eng._sem_store.n, full, replace=False))
        full_q = perturb(rng, rows)
        batches0, before = s.batches_run, dict(counts)
        t0 = time.perf_counter()
        got, gc_ms, gc_gen = with_gc_ms(lambda: counted(lambda: service_burst(s, full_q)))
        wall = time.perf_counter() - t0
        half = full // 2
        want = [tuple(np.asarray(x.cpu() if hasattr(x, "cpu") else x)
                      for x in s._semantic_scan(full_q[h:h + half], n_real=half))
                for h in (0, half)]
        for j, (d, i) in enumerate(got):
            wd, wi = want[j // half]
            check(np.array_equal(i, wi[j % half]) and np.array_equal(d, wd[j % half]),
                  f"{tag} full-bucket burst: query {j} differs from the dist-path scan")
        delta = {n: counts[n] - before[n] for n in counts if counts[n] != before[n]}
        log(f"{tag} full-bucket burst: {len(full_q)} submits in {wall * 1e3:.1f} ms "
            f"(garbage collection {gc_ms:.1f} ms of it, oldest generation {gc_gen}), "
            f"{s.batches_run - batches0} batches, launches {json.dumps(delta)}; "
            f"every result = the dist-path scan; {smi}")
        return full_q, got

    def served_in_turns(s, full_q, got, tag, auto_name, rounds=4):
        """The full bucket through a service again, on the distance (K1a /
        K4a) and on the cos key (K1d / K4d + K1e), the service's scan call
        ``auto_name`` wrapped to pass each epilogue, in turns, the first of
        each round alternating, uncounted: every result = the counted burst's.
        The service's batching window is widened meanwhile, so that each
        burst forms one batch of 256 (its 256 submits outlast the 2 ms
        window now and then).  Per run: the burst's wall, and its split at
        the batch — submits until it starts, the batch (scan + host
        copies), its end until the last submit returns — the garbage
        collector's time within it, and the kernels it launched."""
        import pixelbox_tpu_torch.serving.service as service_mod

        auto = getattr(service_mod, auto_name)
        run_group = s._run_group
        marks = []

        def marked(kind, batch):
            marks.append(time.perf_counter())
            run_group(kind, batch)
            marks.append(time.perf_counter())

        def forced(epi):
            return lambda *args, **kwargs: auto(*args, **{**kwargs, "epilogue": epi})

        split = {"dist": [], "cos": []}
        s._run_group = marked
        window, s.max_wait_s = s.max_wait_s, 1.0
        try:
            for r in range(rounds):
                for epi in ("dist", "cos") if r % 2 == 0 else ("cos", "dist"):
                    setattr(service_mod, auto_name, forced(epi))
                    marks.clear()
                    before = fs.launch_counts()
                    t0 = time.perf_counter()
                    out, gc_ms, _ = with_gc_ms(lambda: service_burst(s, full_q))
                    t1 = time.perf_counter()
                    setattr(service_mod, auto_name, auto)
                    in_batches = sum(marks[j + 1] - marks[j] for j in range(0, len(marks), 2))
                    split[epi].append(((t1 - t0) * 1e3, (marks[0] - t0) * 1e3, in_batches * 1e3,
                                       (t1 - marks[-1]) * 1e3, gc_ms, len(marks) // 2))
                    for j, ((d, i), (wd, wi)) in enumerate(zip(out, got)):
                        check(np.array_equal(i, wi) and np.array_equal(d, wd),
                              f"{tag} full bucket on the {epi} path: query {j} differs from the served burst")
                    launched = {n: c - before[n] for n, c in fs.launch_counts().items() if c != before[n]}
                    if len(split[epi]) == 1:
                        log(f"{tag} full bucket on the {epi} path: launches {json.dumps(launched)}")
        finally:
            setattr(service_mod, auto_name, auto)
            s._run_group = run_group
            s.max_wait_s = window
        med = {e: [statistics.median(x[j] for x in v) for j in range(5)] for e, v in split.items()}
        for e, (wall, pre, batch, post, gc_ms) in med.items():
            log(f"{tag} full bucket served on the {e} path, medians of {rounds} in turns: burst "
                f"{wall:.1f} ms = submits until the batch {pre:.1f} + the batch {batch:.1f} + "
                f"results back {post:.1f}; garbage collection {gc_ms:.1f} ms within it (runs, "
                f"burst/batch/garbage collection ms and batches: "
                f"{', '.join(f'{x[0]:.1f}/{x[2]:.1f}/{x[4]:.1f}/{x[5]}' for x in split[e])}); {smi}")
        no_gc = {e: statistics.median(x[0] - x[4] for x in v) for e, v in split.items()}
        log(f"{tag} full bucket: the cos key / the distance {med['cos'][0] / med['dist'][0]:.3f}x "
            f"the burst ({no_gc['cos'] / no_gc['dist']:.3f}x without the garbage collection: "
            f"{no_gc['dist']:.1f} / {no_gc['cos']:.1f} ms), {med['cos'][2] / med['dist'][2]:.3f}x "
            f"the batch; every result = the served burst")
        return med

    full_q, got = full_bucket(svc, sem_eng, "[7] u8")
    served_in_turns(svc, full_q, got, "[7] u8", "cosine_scan_topk_auto")

    # The service's ivf kind: a full bucket = the engine's _ivf_query.
    rows = sem_eng._sem_store.get_rows(rng.choice(sem_eng._sem_store.n, _BUCKETS[-1], replace=False))
    ivf_q = perturb(rng, rows)
    batches0 = svc.batches_run
    t0 = time.perf_counter()
    got = counted(lambda: service_burst(svc, ivf_q, kind="ivf"))
    wall = time.perf_counter() - t0
    want = sem_eng._ivf_query(ivf_q, svc.k, max_distance=svc.max_distance)
    for j, (d, i) in enumerate(got):
        check(np.array_equal(i, want[1][j]) and np.array_equal(d, want[0][j]),
              f"[7] ivf full bucket: query {j} differs from the engine's _ivf_query")
    log(f"[7] ivf full bucket: {len(ivf_q)} submits of kind ivf in {wall * 1e3:.1f} ms (the index "
        f"repacked after this phase's mutations, inside), {svc.batches_run - batches0} batches; every "
        f"result = the engine's _ivf_query; {smi}")

    # The int4 engine (exact-u8 rerank on), served on the distance (K4a).
    i4_svc, i4_url = counted(lambda: start(i4_eng))
    i4_ids = [int(x) for x in rng.choice(i4_eng._sem_image_ids, 32, replace=False)]
    res3, wall3 = counted(lambda: http_burst(
        [("GET /api/similar?id= (int4)", f"{i4_url}/api/similar?id={i}", None) for i in i4_ids]))
    log_burst("[7] int4 burst:", res3, wall3, smi)
    for (label, _, out, _, _), i in zip(res3, i4_ids):
        same(out, direct_id(i4_eng, i), f"{label}{i}")
    check(i4_svc.batches_run < len(i4_ids), "int4 service: no coalescing")
    log(f"[7] int4 burst: 32 responses = direct calls; {i4_svc.queries_served} queries in "
        f"{i4_svc.batches_run} batches")
    full_q, got = full_bucket(i4_svc, i4_eng, "[7] int4")
    served_in_turns(i4_svc, full_q, got, "[7] int4", "cosine4_scan_topk_auto")

    for srv, s in servers:
        srv.shutdown()
        srv.server_close()
        s.close()
    log(f"[7] kernel launches on the serving path: {json.dumps(counts)}")
    for n in ("cosine_threshold_collect", "cosine4_threshold_collect", "hamming_threshold_collect",
              "lex_topk_select", "ivf_probe_topk", "ivf_probe_invert"):
        check(counts[n] > 0, f"kernel {n} was not launched on the serving path")
    # Every batch selects on the distance: no served path takes the cos key.
    for n in ("cosine_coskey_collect", "cosine4_coskey_collect", "coskey_rescore"):
        check(counts[n] == 0, f"the service launched {n}")
    return counts


# --------------------------------------------------------------------- #
# Phase 8: multi-device serving — phases 4-6's libraries row-sharded over
# a mesh (Engine.serve_on_mesh), row 8 of the kernel table


def phase_mesh(fs, scan, smi, err, sem_eng, sem_paths, ph_eng, i4_eng):
    import numpy as np
    import torch

    from pixelbox_tpu_torch.ops import int4
    from pixelbox_tpu_torch.parallel import sharded_scan as ss
    from pixelbox_tpu_torch.parallel.mesh import make_mesh

    rng = np.random.default_rng(SEED + 8)
    cards = torch.cuda.device_count()
    n_shards = min(MESH_SHARDS, cards) if cards > 1 else MESH_SHARDS
    mesh = make_mesh(n_shards)
    log(f"[8] mesh: {n_shards} shards on {[str(d) for d in mesh.axis_devices()]}"
        + (f" (one card: all {n_shards} shards on it)" if cards == 1 else ""))
    engines = (sem_eng, ph_eng, i4_eng)
    for e in engines:
        e.scan_mode = "auto"
        e.scan_mesh = None

    def results(e):
        return [(r.id, r.distance_from_query) for r in e.get_query_results()]

    sem_ids = [int(x) for x in sem_eng._sem_image_ids[:2]] + [
        int(x) for x in rng.choice(sem_eng._sem_image_ids[100:], 4, replace=False)]
    i4_ids = [int(x) for x in rng.choice(i4_eng._sem_image_ids, 4, replace=False)]
    ph_ids = [int(x) for x in rng.choice(ph_eng._ph_image_ids, 4, replace=False)]
    ph_q = [ph_eng._ph_store.get_rows([ph_eng._ph_row_by_image[i]])[0] for i in ph_ids]

    def drive(final=False):
        """The phase's queries through the engines' entry points."""
        out = {}
        for i in sem_ids:
            sem_eng.query_by_image_hash_from_id(i)
            out[("u8", i)] = results(sem_eng)
        for mode in ("pallas", "exact"):
            sem_eng.scan_mode = mode
            sem_eng.query_by_image_hash_from_id(sem_ids[0])
            out[("u8", mode)] = results(sem_eng)
        sem_eng.scan_mode = "auto"
        sem_eng.query_by_image_hash_from_file(sem_paths[2])
        out[("u8", "file")] = results(sem_eng)
        for i, q in zip(ph_ids, ph_q):
            ph_eng.query_by_phash(q)
            out[("phash", i)] = results(ph_eng)
            ph_eng.query_by_phash(q[:24])  # narrower query: the mixed-width path
            out[("phash24", i)] = results(ph_eng)
        for i in i4_ids:
            i4_eng.query_by_image_hash_from_id(i)
            out[("int4", i)] = results(i4_eng)
        # IVF at full nprobe (on the mesh: the sharded index, built here).
        sem_eng.scan_mode, sem_eng.ivf_nprobe = "ivf", 1 << 30
        for i in sem_ids[:2]:
            sem_eng.query_by_image_hash_from_id(i)
            out[("ivf", i)] = results(sem_eng)
        sem_eng.scan_mode, sem_eng.ivf_nprobe = "auto", None
        return out

    def dup_cut():
        """The first DUP_BATCHES batches of 256 of each duplicate pass (the
        int4 one, whose host rerank dominates, the first 8)."""
        out = {}
        for e, by, md, nb in ((ph_eng, "phash", 0.1, DUP_BATCHES), (sem_eng, "semantic", 0.05, DUP_BATCHES),
                              (i4_eng, "semantic", 0.05, 8)):
            store, _, groups = e._duplicate_scans(by, 8, md)
            rows, scan_fn = groups[0]
            qrows = store.get_rows(rows[: nb * 256])
            out[(e.db_path, by)] = [scan_fn(qrows[s : s + 256]) for s in range(0, len(qrows), 256)]
        return out

    t0 = time.perf_counter()
    ref = drive()
    ref_dup = dup_cut()
    log(f"[8] one-device references in {time.perf_counter() - t0:.1f}s")

    # Row 8 on the card: the sharded auto against the one-device auto, in
    # turns, and the per-shard K1a and the merge K1c of one pass at Q = 256.
    store = sem_eng._sem_store
    index = store.device_index
    mirror = ss.shard_semantic_index(index, mesh)
    smp, meta = sem_eng._get_scan_sample(), sem_eng._get_row_meta()
    qs = torch.from_numpy(perturb(rng, store._host_rows[rng.integers(0, store.n, MAIN_Q)])).cuda()
    for qn in QS:
        q = qs[:qn]
        one_ms, mesh_ms = interleaved_ms([
            lambda: scan.cosine_scan_topk_auto(q, index, k=K, sample=smp, row_meta=meta),
            lambda: ss.sharded_cosine_scan_topk_auto(q, mirror, mesh, k=K),
        ], reps=20)
        log(f"[8] u8 auto in turns, Q={qn}: one device {one_ms:.4f} ms, {n_shards}-shard mesh "
            f"{mesh_ms:.4f} ms ({mesh_ms / one_ms:.3f}x; capacity {index.capacity:,}, "
            f"{mirror.local_rows:,} rows a shard; median of 20 each, CUDA events; {smi})")
    with Recorder(fs) as rec:
        ss.sharded_threshold_pass(qs, mirror, K, 1e3, fs.CosineQueries.from_u8)
        torch.cuda.synchronize()
    pass_ms = median_ms(lambda: ss.sharded_threshold_pass(qs, mirror, K, 1e3, fs.CosineQueries.from_u8))
    shard_k1a = next(c for c in rec.calls if c[0] == "cosine_threshold_collect"
                     and c[1][5].shape[0] == mirror.local_rows)
    merge = rec.calls[-1]
    check(merge[0] == "lex_topk_select" and merge[1][0].shape[1] == n_shards * K, "the merge call")
    st = {"pass_ms": pass_ms, "shard_k1a": time_kernel(fs, shard_k1a, smi, "[8] one shard's"),
          "merge": time_k1c(fs, merge, smi, "[8] merge", err)}
    row_bytes = index.capacity * (DIM + 12)  # meta rows 0-2: row 3 is padding no kernel reads
    log(f"[8] the sharded threshold pass at Q={MAIN_Q} ({n_shards} x θ stage + K1a + K1c, "
        f"merge): {pass_ms:.4f} ms; bound {row_bytes / HBM_BPS * 1e3:.4f} ms (bytes: every row "
        f"and its meta read once, {row_bytes:,} B); merge K1c {st['merge']['ms']:.4f} ms a call, "
        f"{st['merge']['gpu_ms']:.4f} device, against torch.sort of its (dist, id) keys "
        f"{st['merge']['sort_ms']:.4f} / {st['merge']['sort_gpu_ms']:.4f} ms; {smi}")
    del mirror, rec
    torch.cuda.empty_cache()

    replayed = {"calls": {}, "s": 0.0}
    fs.reset_launch_counts()  # the mesh path starts here
    with Recorder(fs) as rec:
        t0 = time.perf_counter()
        for e in engines:
            e.serve_on_mesh(mesh)
        got = drive()
        t_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        got_dup = dup_cut()
        t_dup = time.perf_counter() - t0
        counts = fs.launch_counts()  # and ends here
    replay_recorded(fs, err, rec, replayed)
    log(f"[8] serve_on_mesh + {len(got)} queries in {t_first:.2f}s (sharding included); "
        f"duplicate cuts in {t_dup:.2f}s; {smi}")
    log(f"[8] kernel launches on the mesh path: {json.dumps(counts)}")
    for n in ("cosine_threshold_collect", "cosine_chunk_topk", "cosine4_threshold_collect",
              "hamming_chunk_topk", "lex_topk_select", "ivf_probe_topk"):
        check(counts[n] > 0, f"kernel {n} was not launched on the mesh path")

    for key, want in ref.items():
        check(got[key] == want, f"mesh {key}: differs from the one-device result")
    for key, want in ref_dup.items():
        for j, ((d1, i1), (d2, i2)) in enumerate(zip(got_dup[key], want)):
            check(np.array_equal(d1, d2) and np.array_equal(i1, i2),
                  f"mesh duplicates {key}: batch {j} differs from the one-device scan")
    log(f"[8] mesh = one device: u8 similar ({len(sem_ids)} ids, auto; pallas and exact modes; "
        f"one upload), phash-similar ({len(ph_ids)} at 32 B and at 24 B), int4 similar with the "
        f"rerank ({len(i4_ids)}), ivf at full nprobe on the sharded index (2), duplicate cuts "
        f"{[len(v) for v in got_dup.values()]} batches")

    # numpy oracle on sampled queries
    for i in sem_ids[:2]:
        row = sem_eng._sem_row_by_image[i]
        od, oi = oracle_topk(store._host_rows[row][None], store._host_rows[: store.n],
                             store._host_valid[: store.n], K, 1e3)
        ids = sem_eng._sem_image_ids
        check(got[("u8", i)] == [(ids[int(r)], float(x)) for x, r in zip(od[0], oi[0]) if r >= 0],
              f"mesh u8 similar {i}: differs from the numpy oracle")
    pst = ph_eng._ph_store
    od, oi = oracle_hamming(ph_q[0][None], pst._host_rows[: pst.n], pst._host_valid[: pst.n],
                            K, 1e3, PH_BYTES, False)
    check(got[("phash", ph_ids[0])] == [(ph_eng._ph_image_ids[int(r)], float(x))
                                        for x, r in zip(od[0], oi[0]) if r >= 0],
          "mesh phash-similar: differs from the numpy oracle")
    log("[8] mesh u8 (2 queries) and phash (1 query) = the numpy oracle")
    log_replayed("[8]", replayed, counts)

    for e in engines:
        e.scan_mesh = None
        e._sem_mirror.index = e._ph_mirror.index = None
    sem_eng._ivf_sharded = None
    torch.cuda.empty_cache()
    return counts, {"mesh": mesh, "q_id": sem_ids[3], "k1c_merge": st["merge"]}


def replay_recorded(fs, err, rec, replayed):
    """Replay the calls recorded so far through their plain versions,
    before a mutation writes into the tensors they read (the mirrors and
    the stores change in place); plain versions launch nothing."""
    import torch

    t = time.perf_counter()
    for call in rec.calls:
        err[call[0]] = max(err[call[0]], replay(fs, call))
        replayed["calls"][call[0]] = replayed["calls"].get(call[0], 0) + 1
    rec.calls.clear()
    torch.cuda.synchronize()
    replayed["s"] += time.perf_counter() - t


def log_replayed(tag, replayed, counts):
    log(f"{tag} {sum(replayed['calls'].values())} kernel calls of the mesh path (per shard and "
        f"merges) replayed bit-identical through their plain versions in {replayed['s']:.1f}s: "
        f"{json.dumps(replayed['calls'])}")
    check(replayed["calls"] == {n: c for n, c in counts.items() if c},
          "the replays do not cover every launch of the mesh path")


def phase_mesh_mutations(fs, err, smi, sem_eng, mesh, q_id):
    """Phase 8b, after phase 7: the u8 library (as phase 7 left it) back on
    the mesh, then a tag, a removal (one full reshard) and a 1,024-row
    append within the capacity (a delta sync), each seen by the next
    query; the result then equals the engine on one device."""
    import numpy as np

    from pixelbox_tpu_torch.records import IndexedImage

    rng = np.random.default_rng(SEED + 9)
    store = sem_eng._sem_store
    check(q_id in sem_eng._sem_row_by_image, f"image {q_id} is gone before phase 8b")
    check(store.n + APPEND_ROWS <= store.device_index.capacity,
          "no room for the append within the capacity")

    def results():
        return [(r.id, r.distance_from_query) for r in sem_eng.get_query_results()]

    replayed = {"calls": {}, "s": 0.0}
    fs.reset_launch_counts()  # the mesh path starts here
    with Recorder(fs) as rec:
        sem_eng.serve_on_mesh(mesh)
        sem_eng.query_by_image_hash_from_id(q_id)
        before = results()
        r0 = sem_eng._sharded_full_reshards
        check(sem_eng.set_tag(q_id, "mesh", "meshtag"), "set_tag")
        sem_eng.query("tag:meshtag")
        check([r.id for r in sem_eng.get_query_results()] == [q_id], "search tag: misses the new tag")
        victim = before[1][0]
        check(sem_eng.remove_image(victim), "remove_image")
        sem_eng.query_by_image_hash_from_id(q_id)
        after_rm = results()
        reshard_rm = sem_eng._sharded_full_reshards - r0
        replay_recorded(fs, err, rec, replayed)  # before the append writes into the shards
        copy = store.get_rows([sem_eng._sem_row_by_image[q_id]])
        fresh = np.concatenate([copy, clustered_hashes(rng, APPEND_ROWS - 1, DIM)])
        cap0 = store.device_index.capacity
        new_ids = sem_eng.insert_records_batch([
            IndexedImage(filename=f"mesh_{j:04d}.png", path=f"/synthetic/mesh_{j:04d}.png",
                         visual_hash=fresh[j]) for j in range(APPEND_ROWS)])
        sem_eng.query_by_image_hash_from_id(q_id)
        after_app = results()
        reshard_app = sem_eng._sharded_full_reshards - r0 - reshard_rm
        counts = fs.launch_counts()  # and ends here
    replay_recorded(fs, err, rec, replayed)
    log(f"[8b] kernel launches on the mesh path: {json.dumps(counts)}")
    check(counts["cosine_threshold_collect"] > 0 and counts["lex_topk_select"] > 0,
          "the sharded threshold pass did not run")

    check(reshard_rm == 1 and reshard_app == 0 and store.device_index.capacity == cap0,
          f"reshards: removal {reshard_rm} (want 1), append {reshard_app} (want 0, a delta)")
    check(all(i != victim for i, _ in after_rm) and after_rm[0] == (q_id, 0.0), "after the removal")
    want = [r for r in after_rm if r[1] == 0.0] + [(new_ids[0], 0.0)]
    check(after_app[: len(want)] == want, "after the append: the copy is not next at 0.0")
    sem_eng.scan_mesh = None
    sem_eng.query_by_image_hash_from_id(q_id)
    check(results() == after_app, "after the mutations: mesh differs from one device")
    log(f"[8b] tag {q_id} found; removed {victim}: 1 full reshard, the victim gone; appended "
        f"{APPEND_ROWS} rows within the capacity {cap0:,} ({store.n:,} rows, "
        f"{cap0 // mesh.shape['data']:,} a shard): a delta sync (0 reshards), the copy "
        f"{new_ids[0]} next at 0.0; = one device ({smi})")
    log_replayed("[8b]", replayed, counts)
    sem_eng._sem_mirror.index = None
    return counts


# --------------------------------------------------------------------- #
# Phase 9: the breakdown ladder (tools.measure_breakdown), row 9


def phase_ladder(fs, smi):
    import numpy as np
    import torch

    from pixelbox_tpu_torch.ops.packed import query_moments_from_u8
    from pixelbox_tpu_torch.tools import measure_breakdown as mb

    fs.reset_launch_counts()
    for n in mb.LAUNCHES:  # the ladder's main path starts here
        mb.LAUNCHES[n] = 0
    t0 = time.perf_counter()
    res = mb.run()
    counts = {**fs.launch_counts(), **mb.LAUNCHES}  # and ends here
    log(f"[9] measure_breakdown at Q={mb.Q} x {mb.N_ROWS:,} x {mb.DIM}, TILE {mb.TILE}, "
        f"{mb.ITERS} repeats each: {json.dumps(res)} ({time.perf_counter() - t0:.1f}s; {smi})")
    check(counts["breakdown_ladder"] >= 4 * mb.ITERS, "the ladder kernel did not run its rungs")
    check(counts["cosine_threshold_collect"] > 0, "the shipping scan did not run")

    # Each rung once against its plain version and the first port's
    # ladder, on rows planted near the queries so that every lane it
    # compares is finite and varied.
    q, idx, meta = mb.ladder_inputs(mb.N_ROWS, mb.DIM, mb.Q, seed=SEED, planted=True, device="cuda")
    mom = query_moments_from_u8(q[0])
    st = {"rungs": {}, "max_abs_err": 0.0, "previous_max_abs_err": 0.0}
    qp = mom[0].contiguous()
    st["library_ms"] = median_ms(lambda: torch._int_mm(qp, idx.data.t()))
    log(f"[9] library: the gemm rung's dot alone (torch._int_mm, Q={mb.Q}) {st['library_ms']:.4f} ms")
    for rung in mb.RUNGS:
        out, dsum = mb.ladder(rung, *mom, idx.data, meta)
        torch.cuda.synchronize()
        pout, psum = mb.ladder_plain(rung, *mom, idx.data, meta)
        check(torch.equal(out.view(torch.int32), pout.view(torch.int32)) and torch.equal(dsum, psum),
              f"ladder rung {rung} differs from its plain version")
        fin = torch.isfinite(out) & torch.isfinite(pout)
        st["max_abs_err"] = max(st["max_abs_err"], float((out[fin] - pout[fin]).abs().max()))
        oout, osum = mb.ladder_dp4a(rung, *mom, idx.data, meta)
        check(torch.equal(out.view(torch.int32), oout.view(torch.int32)) and torch.equal(dsum, osum),
              f"ladder rung {rung}: the first port's ladder differs")
        fin = torch.isfinite(out) & torch.isfinite(oout)
        st["previous_max_abs_err"] = max(st["previous_max_abs_err"], float((out[fin] - oout[fin]).abs().max()))
        lanes = out if rung in ("gemm", "chain") else out[:, :1]
        check(bool(torch.isfinite(lanes).all()) and lanes.unique().numel() >= lanes.numel() // 4,
              f"ladder rung {rung}: outputs not finite and varied")
        p_ms = median_ms(lambda: mb.ladder_plain(rung, *mom, idx.data, meta), reps=3)
        n, d = idx.data.shape
        # the rungs past gemm read meta rows 0-2 (12 B a row), as K1a does
        nbytes = n * d + (0 if rung == "gemm" else 12 * n) + mb.Q * (d + 8) + mb.Q * 128 * 4
        ops = 2 * mb.Q * n * d
        b_bytes, b_ops = nbytes / HBM_BPS * 1e3, ops / INT8_OPS * 1e3
        # the rung against the first port's ladder in turns (uncounted: the
        # main path's counts are read), a call and device-only
        fns = [lambda: mb.ladder(rung, *mom, idx.data, meta), lambda: mb.ladder_dp4a(rung, *mom, idx.data, meta)]
        new_ms, old_ms = interleaved_ms(fns, reps=10)
        new_gpu, old_gpu = gpu_ms(fns, reps=10, rounds=2)
        st["rungs"][rung] = {"ms": res[f"{rung}_ms"], "plain_ms": p_ms, "bound_ms": max(b_bytes, b_ops),
                             "bound_by": "bytes" if b_bytes >= b_ops else "operations",
                             "library_ms": st["library_ms"], "turns_ms": new_ms, "previous_ms": old_ms,
                             "gpu_ms": new_gpu, "previous_gpu_ms": old_gpu}
        log(f"[9] rung {rung}: kernel {res[f'{rung}_ms']:.4f} ms, plain {p_ms:.4f} ms, bound "
            f"{max(b_bytes, b_ops):.4f} ms ({st['rungs'][rung]['bound_by']}: {nbytes:,} B, "
            f"{ops:,} ops); replayed bit-identical, finite and varied, = the first port's ladder; "
            f"vs breakdown_ladder_dp4a in turns {new_ms:.4f} / {old_ms:.4f} ms a call, device only "
            f"{new_gpu:.4f} / {old_gpu:.4f} ms ({old_gpu / new_gpu:.2f}x); torch._int_mm "
            f"{st['library_ms']:.4f} ms ({smi})")
    st.update(res)
    del idx, meta
    torch.cuda.empty_cache()
    return counts, st


def phase_time(tag: str, t0: float) -> float:
    now = time.perf_counter()
    log(f"[{tag}] phase wall time {now - t0:.1f}s")
    return now


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this smoke needs a CUDA card",
              file=sys.stderr)
        return 2
    from pixelbox_tpu_torch.ops import fused_scan as fs
    from pixelbox_tpu_torch.ops import hamming_gemm as hg
    from pixelbox_tpu_torch.ops import scan
    from pixelbox_tpu_torch.utils.device import hold_exact_numerics

    # [1] device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    hold_exact_numerics()
    log(f"[1] device: {kind}; torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"nvidia-smi: {smi}; TF32 off, cuDNN deterministic")
    check("jax" not in sys.modules, "jax was imported")

    # [2] build: one nvcc for each source, started together
    from concurrent.futures import ThreadPoolExecutor

    from pixelbox_tpu_torch.ops import ivf
    from pixelbox_tpu_torch.tools import measure_breakdown

    t0 = time.perf_counter()
    loads = (fs.load_kernels, fs.load_tc_kernels, fs.load_theta_kernels, ivf.load_ivf_kernels,
             measure_breakdown.load_kernels)
    with ThreadPoolExecutor(len(loads)) as pool:
        builds = [pool.submit(load) for load in loads]
        t1 = time.perf_counter()
        seeded3, growth = host_data()
        gc.freeze()  # 3M long-lived records: out of the collector's way until they are inserted
        log(f"[2] host data (phase 3's rows, phases 4-6's {sum(map(len, growth.values())):,} records) "
            f"made in {time.perf_counter() - t1:.1f}s while the kernels build")
        kerns = [b.result() for b in builds]
    for kern in kerns:
        log(f"[2] built {os.path.basename(kern.path)} in {kern.build_seconds:.2f}s")
        lines = kern.ptxas.splitlines()
        for j, line in enumerate(lines):
            named = ("tc_cosine", "tc_hamming", "tc_chunk_topk", "tc_theta", "lex_topk_select", "tc_ladder",
                     "ivf_probe_tc_kernel", "ivf_invert_kernel", "ivf_probe_dp4a_kernel", "ivf_gathered_kernel")
            if "Compiling entry" in line and any(n in line for n in named):  # by name
                name = line.split("'")[1]
                at = min(name.find(n) for n in named if n in name)
                end = name.find("EEv", at)  # the template arguments: NQ, then kind or wrap
                used = next((x.strip() for x in lines[j:j + 5] if "registers" in x), "")
                spill = next((x.strip() for x in lines[j:j + 5] if "spill" in x), "")
                log(f"[2] ptxas {name[at:end + 1] if end > 0 else name[at:at + 22]}: {used}; {spill}")
            elif "fused_scan" in kern.path and ("registers" in line or "spill" in line):
                log(f"[2] ptxas: {line.strip()}")
        for warn in sorted({x.split(" in function")[0].split("info    : ")[-1] for x in lines if "(C75" in x}):
            log(f"[2] ptxas: {warn}")
    log(f"[2] {len(loads)} builds in {time.perf_counter() - t0:.2f}s (in parallel)")

    # [3] kernels vs plain, [3b] Hamming, [3c] large batches
    err = {n: 0.0 for n in (*Recorder.NAMES, *Recorder.IVF_NAMES, *PREVIOUS.values(), "lex_topk_segments",
                            "ivf_probe_collect_dp4a")}
    PlainOnCard.install(fs)
    t0 = time.perf_counter()
    stats, db = phase_kernels(fs, scan, smi, err, seeded3)
    t0 = phase_time("3", t0)
    stats.update(phase_hamming(fs, scan, hg, smi, err))
    t0 = phase_time("3b", t0)
    stats["cosine_threshold_collect"]["by_q"][BIG_Q] = by_q(phase_big_batch(fs, scan, smi, err, db))
    t0 = phase_time("3c", t0)
    stats.update(phase_int4_kernels(fs, scan, smi, err, db))
    stats["lex_topk_select"]["by_shape"]["int4"] = stats.pop("k1c_int4")
    t0 = phase_time("3d", t0)
    del db

    # [4] engine, [5] phash engine and duplicates, [6] int4 engine
    PlainOnCard.reset()  # phases 4-9 start here
    with tempfile.TemporaryDirectory(prefix="pixelbox_smoke_") as tmp:
        counts4, sem_eng, ckpt, sem_paths = phase_engine(fs, scan, smi, tmp, growth)
        t0 = phase_time("4", t0)
        counts5, ph_eng, ph_paths = phase_phash(fs, scan, hg, smi, tmp, sem_eng, ckpt, growth)
        t0 = phase_time("5", t0)
        counts6, i4_eng = phase_int4_engine(fs, scan, smi, tmp, ckpt, growth)
        gc.unfreeze()
        t0 = phase_time("6", t0)
        counts6b, ivf_st = phase_ivf(fs, scan, hg, smi, err, sem_eng, sem_paths, ph_eng, i4_eng)
        t0 = phase_time("6b", t0)
        counts8, carry = phase_mesh(fs, scan, smi, err, sem_eng, sem_paths, ph_eng, i4_eng)
        stats["lex_topk_select"]["by_shape"]["mesh_merge"] = carry["k1c_merge"]
        t0 = phase_time("8", t0)
        counts7 = phase_serving(fs, smi, sem_eng, sem_paths, ph_eng, ph_paths, i4_eng)
        t0 = phase_time("7", t0)
        counts8b = phase_mesh_mutations(fs, err, smi, sem_eng, carry["mesh"], carry["q_id"])
        t0 = phase_time("8b", t0)
        for eng in (sem_eng, ph_eng, i4_eng):
            eng.close()
    counts9, ladder = phase_ladder(fs, smi)
    phase_time("9", t0)

    check("jax" not in sys.modules, "jax was imported")
    main_counts = (counts4, counts5, counts6, counts6b, counts7, counts8, counts8b, counts9, {
        "sample_theta_chain": PlainOnCard.counts["sample_theta_chain"],
        "mini_sample_theta_on_card": PlainOnCard.counts["mini_sample_theta"],
        **{n + "_on_card": c for n, c in PlainOnCard.counts.items() if n in PlainOnCard.IVF_NAMES}})
    for old, new in (("cosine_threshold_collect_dp4a", "cosine_threshold_collect"),
                     ("cosine_chunk_topk_dp4a", "cosine_chunk_topk"),
                     ("cosine4_threshold_collect_dp4a", "cosine4_threshold_collect"),
                     ("hamming_threshold_collect_popc", "hamming_threshold_collect"),
                     ("hamming_chunk_topk_popc", "hamming_chunk_topk"),
                     ("cosine4_chunk_topk_dp4a", "cosine4_chunk_topk"),
                     ("lex_topk_segments", "lex_topk_select"),
                     ("breakdown_ladder_dp4a", "breakdown_ladder"),
                     ("sample_theta_chain", "sample_theta"),
                     ("mini_sample_theta_on_card", "sample_theta"),
                     ("ivf_probe_collect_dp4a", "ivf_probe_topk"),
                     ("ivf_probe_topk_plain_on_card", "ivf_probe_topk"),
                     ("ivf_probe_collect_plain_on_card", "ivf_probe_topk"),
                     ("ivf_probe_invert_plain_on_card", "ivf_probe_invert"),
                     ("ivf_gathered_collect_plain_on_card", "ivf_gathered_collect")):
        n_old, n_new = (sum(c.get(n, 0) for c in main_counts) for n in (old, new))
        check(n_new > 0 and n_old == 0, f"main paths: {new} {n_new} launches, {old} {n_old}")
        log(f"main paths (phases 4-9): {new} {n_new} launches, the first port's {old} {n_old}")
    replaces = {
        "cosine_threshold_collect": "pixelbox_tpu/ops/pallas_scan.py:979",
        "cosine_chunk_topk": "pixelbox_tpu/ops/pallas_scan.py:1074",
        "lex_topk_select": "pixelbox_tpu/ops/pallas_scan.py:192",
        "lex_topk_segments": "pixelbox_tpu/ops/pallas_scan.py:192",
        "hamming_threshold_collect": "pixelbox_tpu/ops/pallas_scan.py:1012",
        "hamming_chunk_topk": "pixelbox_tpu/ops/hamming_gemm.py:156",
        "cosine4_threshold_collect": "pixelbox_tpu/ops/int4.py:376",
        "cosine4_chunk_topk": "pixelbox_tpu/ops/int4.py:265",
        "cosine_coskey_collect": "pixelbox_tpu/ops/pallas_scan.py:171",
        "cosine4_coskey_collect": "pixelbox_tpu/ops/pallas_scan.py:171",
        "coskey_rescore": "pixelbox_tpu/ops/pallas_scan.py:747",
        "sample_theta": "pixelbox_tpu/ops/pallas_scan.py:589",
    }
    sources = {"sample_theta": "tc_theta.cu", **{n: "tc_scan.cu" for n in PREVIOUS}}
    kernels = []
    for n in (*Recorder.NAMES, "lex_topk_segments"):
        st = stats[n]
        kernels.append({
            "name": n,
            "route": "cuda",
            "source": "pixelbox_tpu_torch/csrc/" + sources.get(n, "fused_scan.cu"),
            "replaces": replaces[n],
            "launches": sum(c.get(n, 0) for c in main_counts),
            "max_abs_err": err[n],
            **{key: st[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            **{key: st[key] for key in ("dot_only_ms", "previous_ms", "gpu_ms", "previous_gpu_ms", "by_q",
                                        "sym_by_q", "library_gpu_ms", "sort_ms", "sort_gpu_ms",
                                        "by_shape") if key in st},
            **({"previous_max_abs_err": err[PREVIOUS[n]]} if n in PREVIOUS else {}),
            **({"previous_max_abs_err": err["lex_topk_segments"]} if n == "lex_topk_select" else {}),
        })
    k1b = stats["cosine_chunk_topk"]
    kernels.append({  # the first port's K1b, kept as the timing reference (times in turns)
        "name": "cosine_chunk_topk_dp4a",
        "route": "cuda",
        "source": "pixelbox_tpu_torch/csrc/fused_scan.cu",
        "replaces": replaces["cosine_chunk_topk"],
        "launches": sum(c.get("cosine_chunk_topk_dp4a", 0) for c in main_counts),
        "max_abs_err": err["cosine_chunk_topk_dp4a"],
        "ms": k1b["previous_ms"], "gpu_ms": k1b["previous_gpu_ms"],
        **{key: k1b[key] for key in ("plain_ms", "bound_ms", "bound_by", "library_ms")},
    })
    ivf_by_q = ivf_st["by_q"]
    inv = ivf_by_q[MAIN_Q]["invert"]
    ivf_entries = (
        ("ivf_probe_topk", "pixelbox_tpu/ops/ivf.py:498", ivf_st["ms"], ivf_st["gpu_ms"],
         {key: ivf_st[key] for key in ("cold_gpu_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                       "with_k1c_ms", "with_k1c_gpu_ms", "k1c_buffer_bytes", "k_prime")}
         | {"by_q": {q: {key: v[key] for key in ("ms", "gpu_ms", "cold_gpu_ms", "plain_ms", "bound_ms",
                                                  "with_k1c_ms", "with_k1c_gpu_ms", "previous_ms",
                                                  "previous_gpu_ms", "previous_cold_gpu_ms",
                                                  "previous_with_k1c_ms", "previous_with_k1c_gpu_ms",
                                                  "scan_ms", "scan_host_ms", "auto_ms", "device_kernels",
                                                  "auto_device_kernels")} for q, v in ivf_by_q.items()},
            "recall_at_10": ivf_st["recall_at_10"]}),
        ("ivf_probe_invert", "pixelbox_tpu/ops/ivf.py:498", inv["ms"], inv["gpu_ms"],
         {key: inv[key] for key in ("plain_ms", "bound_ms", "bound_by", "library_ms", "items")}),
        ("ivf_probe_collect_dp4a", "pixelbox_tpu/ops/ivf.py:498", ivf_st["previous_ms"], ivf_st["previous_gpu_ms"],
         {"cold_gpu_ms": ivf_st["previous_cold_gpu_ms"], "plain_ms": ivf_st["previous_plain_ms"],
          "bound_ms": ivf_st["previous_bound_ms"], "bound_by": ivf_st["previous_bound_by"], "library_ms": None,
          "with_k1c_ms": ivf_st["previous_with_k1c_ms"], "with_k1c_gpu_ms": ivf_st["previous_with_k1c_gpu_ms"]}),
        ("ivf_gathered_collect", "pixelbox_tpu/ops/ivf_build.py:645", ivf_st["gathered"]["ms"],
         ivf_st["gathered"]["gpu_ms"],
         {key: ivf_st["gathered"][key] for key in ("cold_gpu_ms", "plain_ms", "bound_ms", "bound_by",
                                                    "split_out_bytes", "split_out_ms", "library_ms")}),
    )
    for n, rep_, ms_, gpu_, extra in ivf_entries:
        kernels.append({
            "name": n,
            "route": "cuda",
            "source": "pixelbox_tpu_torch/csrc/ivf_probe.cu",
            "replaces": rep_,
            "jax_route": "XLA, no pallas_call",  # the JAX package computes these in XLA
            "launches": sum(c.get(n, 0) for c in main_counts),
            "max_abs_err": err[n],
            "ms": ms_,
            "gpu_ms": gpu_,
            **extra,
        })
    gemm = ladder["rungs"]["gemm"]
    kernels.append({
        "name": "breakdown_ladder",
        "route": "cuda",
        "source": "pixelbox_tpu_torch/csrc/breakdown.cu",
        "replaces": "scripts/measure_breakdown.py:52",
        "launches": counts9["breakdown_ladder"],
        "max_abs_err": ladder["max_abs_err"],
        **{key: gemm[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "previous_ms", "gpu_ms",
                                      "previous_gpu_ms")},
        "library_ms": ladder["library_ms"],
        "previous_max_abs_err": ladder["previous_max_abs_err"],
        "rungs": ladder["rungs"],
    })
    kernels.append({  # the first port's ladder, kept as the timing reference (times in turns)
        "name": "breakdown_ladder_dp4a",
        "route": "cuda",
        "source": "pixelbox_tpu_torch/csrc/breakdown.cu",
        "replaces": "scripts/measure_breakdown.py:52",
        "launches": sum(c.get("breakdown_ladder_dp4a", 0) for c in main_counts),
        "max_abs_err": ladder["previous_max_abs_err"],
        "ms": gemm["previous_ms"], "gpu_ms": gemm["previous_gpu_ms"],
        **{key: gemm[key] for key in ("plain_ms", "bound_ms", "bound_by")},
        "library_ms": ladder["library_ms"],
        "rungs": {r: {"ms": s["previous_ms"], "gpu_ms": s["previous_gpu_ms"]} for r, s in ladder["rungs"].items()},
    })
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
