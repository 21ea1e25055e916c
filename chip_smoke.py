#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pixelbox_tpu_torch) on one card.

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and exits non-zero):

1. Device: requires ``torch.cuda.is_available()``; prints the card and
   ``nvidia-smi`` name/power limit; holds the exact numerics (TF32 off,
   cuDNN deterministic, benchmark off).
2. Build: compiles ``pixelbox_tpu_torch/csrc/fused_scan.cu`` and
   ``csrc/breakdown.cu`` for sm_90a, one nvcc each, in parallel.
3. Kernels vs plain at the main shapes (1,048,576 rows × 128, k = 100,
   Q ∈ {1, 8, 256}) in five cases: θ from the sample, θ = max_distance, a
   max_distance filter that excludes rows, 1% invalid rows, and a tie
   flood that must defeat the proof and be repaired.  Every kernel launch
   the path makes is recorded and replayed through the kernel's plain
   PyTorch version on the same inputs — outputs must be bit-identical —
   and the end-to-end results must equal the exact scan, and the numpy
   oracle on a sub-sample of queries.  Kernel and plain medians are timed
   with CUDA events.
3b. Hamming kernels vs plain at the phash's published width (1,048,576
   rows × 32 bytes, k = 100, Q ∈ {1, 8, 256, 2048}) in seven cases: θ
   from the sample, θ = max_distance, max_distance 0.1, 1% tombstones,
   the u8 wrap, byte_limit 24 with a width-group mask, and an 8,192-row
   tie flood that must defeat the proof and be repaired.  Replayed and
   checked as in phase 3, with the proof rate and the repaired count
   printed per Q.
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
   and mode; the proof rate is printed per Q.  At k = 400, Q ∈ {1, 8,
   256} the cos-key pass (K4d + K1e) runs too, with the same checks; K4d
   is timed against K4a in turns, and the whole auto scan (asym, k = 400)
   with ``epilogue="dist"`` against ``"cos"`` at the batching service's
   buckets 1/8/32/128/256.
3e. The cos-key kernels (K1d, K1e) inside phase 3's loop: in every case
   with a threshold pass, ``cosine_scan_topk_auto(epilogue="cos")`` at
   Q ∈ {1, 8, 256}, every launch replayed bit-identical, the results equal
   to ``epilogue="dist"``, the exact scan and the oracle; the proof rate
   per Q; K1d timed against K1a in turns, and K1e; the whole auto scan
   with ``epilogue="dist"`` against ``"cos"`` at the batching service's
   buckets 1/8/32/128/256, in turns.
4. Engine: indexes 32 seeded images with EfficientNet-B0 at 224²/dim 128
   from a seeded checkpoint (then 64 more, warm), checks the exact-0.0
   self-match, grows the store to 1,048,576 rows with seeded hash-only
   records, runs ``similar`` under ``auto`` and ``pallas`` — counting
   kernel launches from zero, and splitting its latency into the engine's
   timing spans — and holds the results against the exact scan and the
   plain (CPU) path.
5. Phash engine: indexes seeded images under ``phash_compat=False`` and a
   second library with mixed aspect ratios under ``True``; ``phash-similar``
   (the CLI) returns an indexed image at exactly 0.0 in both; grows the
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
   semantic over a 65,536-row int4 library (a cut of the 1M library)
   with its scan and rerank timed apart — counting launches from zero.
7. Serving: phase 4's 1M-row engine behind the port's HTTP server
   (``serve.make_server`` on 127.0.0.1:0, its batching service warmed at
   every bucket) and phase 5's 1M-row phash library behind its own:
   one concurrent burst of 64 ``GET /api/similar?id=``, 16 ``POST
   /api/similar`` and 16 ``POST /api/phash-similar``, every response
   equal to the engine's direct call; then ``/api/tag`` → ``search
   tag:``, ``/api/remove`` of a top hit and an append of 1,024 seeded rows,
   which a second burst must see; a full bucket (256 concurrent submits,
   the batches the cos key serves) straight into the service against its
   dist-path scan; then a burst and a full bucket on phase 6's int4 engine
   (rerank on) — counting launches from zero around each burst.
8. Mesh serving (runs before phase 7, which keeps its stores as phase 6
   left them): phases 4–6's 1M-row u8, phash and int4 libraries put on a
   4-shard mesh through ``Engine.serve_on_mesh`` (the visible cards
   round-robin; with one card all four shards on it, 262,144 rows each):
   ``similar`` (auto; pallas and exact modes; an upload),
   ``phash-similar`` at 32 B and at 24 B (the mixed-width path), int4
   ``similar`` with the rerank, and 64 batches of 256 of the phash and u8
   duplicate passes (8 of the int4 one) — each equal to the same engine
   on one device, and to the numpy oracle on sampled queries.  Every
   per-shard and merge launch is replayed bit-identical through its plain
   version; the sharded auto is timed against the one-device auto at
   Q ∈ {1, 8, 256} in turns, and one shard's K1a and the merge K1c (with
   ``torch.sort`` of its keys) at Q = 256 — counting launches from zero
   around the mesh path.
8b. Mesh mutations (after phase 7): the u8 library as phase 7 left it
   (grown past 1M rows by its append) back on the mesh, then a tag, a
   removal (one full reshard) and a 1,024-row append within the capacity
   (a delta sync), each seen by the next query, which then equals the
   engine on one device; launches counted from zero and replayed.
9. The breakdown ladder: ``tools.measure_breakdown.run()`` at its full
   shape (Q = 256 × 1,048,576 × 128, TILE 8,192, 20 repeats) — counting
   launches from zero around it — then each rung once at that shape on
   rows planted near the queries, bit-identical to its plain version.

The last lines are the card's nvidia-smi line, the kernels' JSON summary
(time, plain time, bound, library time per kernel) and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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
INT4_DUP_ROWS = 1 << 16  # the int4 duplicates library: a cut of the 1M one
APPEND_ROWS = 1024       # phases 7 and 8: the append between their queries
MESH_SHARDS = 4          # phase 8: shards over the visible cards (4 on one card)
DUP_BATCHES = 64         # phase 8: duplicate batches of 256 compared on the mesh


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
    outputs so each call can be replayed through its plain version."""

    NAMES = (
        "cosine_threshold_collect", "cosine_chunk_topk", "lex_topk_segments",
        "hamming_threshold_collect", "hamming_chunk_topk",
        "cosine4_threshold_collect", "cosine4_chunk_topk",
        "cosine_coskey_collect", "cosine4_coskey_collect", "coskey_rescore",
    )

    def __init__(self, fs):
        self.fs = fs
        self.orig = {n: getattr(fs, n) for n in self.NAMES}
        self.calls = []

    def __enter__(self):
        for n in self.NAMES:
            setattr(self.fs, n, self._wrap(n, self.orig[n]))
        return self

    def __exit__(self, *exc):
        for n in self.NAMES:
            setattr(self.fs, n, self.orig[n])

    def _wrap(self, name, fn):
        def wrapper(*args, **kwargs):
            out = fn(*args, **kwargs)
            self.calls.append((name, args, kwargs, out))
            return out

        return wrapper


def replay(fs, call):
    """Re-run one recorded call through the plain version; returns
    (max_abs_err over compared finite values)."""
    import torch

    name, args, kwargs, out = call
    if name == "coskey_rescore":
        d2 = fs.coskey_rescore_plain(*args)
        check(torch.equal(out, d2), "coskey_rescore differs from plain")
        a, b = out, d2
    elif name.endswith("collect"):
        cap = args[-1]
        c2, d2, i2 = getattr(fs, name + "_plain")(*args)
        c1, d1, i1 = out
        check(torch.equal(c1, c2), f"{name} count differs from plain")
        ok = c1 <= cap
        lens = torch.clamp(c1, max=cap)
        s1 = fs.lex_topk_segments_plain(d1, i1, cap, lens, segment=cap)
        s2 = fs.lex_topk_segments_plain(d2, i2, cap, lens, segment=cap)
        check(torch.equal(s1[0][ok], s2[0][ok]), f"{name} distances differ from plain")
        check(torch.equal(s1[1][ok], s2[1][ok]), f"{name} row ids differ from plain")
        a, b = s1[0][ok], s2[0][ok]
    elif name.endswith("chunk_topk"):
        d2, i2 = getattr(fs, name + "_plain")(*args, **kwargs)
        check(torch.equal(out[0], d2) and torch.equal(out[1], i2), f"{name} differs from plain")
        a, b = out[0], d2
    else:
        dist, idx, k = args[:3]
        lens = args[3] if len(args) > 3 else kwargs.get("lens")
        d2, i2 = fs.lex_topk_segments_plain(dist, idx, k, lens)
        check(torch.equal(out[0], d2) and torch.equal(out[1], i2), "K1c differs from plain")
        a, b = out[0], d2
    fin = torch.isfinite(a) & torch.isfinite(b)
    return float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) else 0.0


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


def phase_kernels(fs, scan, smi, err):
    import numpy as np
    import torch

    from pixelbox_tpu_torch.ops.packed import PackedSemanticIndex, semantic_rows_from_u8

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    db = clustered_hashes(rng, N_ROWS, DIM)
    base_q = perturb(rng, db[rng.integers(0, N_ROWS, max(QS))])
    base_q[1] = db[4242]  # an exact copy: distance 0 at row 4242
    log(f"[3] seeded {N_ROWS}x{DIM} rows in {time.perf_counter() - t0:.1f}s")

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
        del idx, meta, smp
        torch.cuda.empty_cache()

    # Timing at the main path's shapes: K1a and K1c at the main pass
    # (Q = MAIN_Q over all rows, k = 100), K1b at a repair bucket.
    def main_pass(call):
        name, args, kwargs, _ = call
        if name == "lex_topk_segments":
            return args[2] == K and (len(args) > 3 or kwargs.get("lens") is not None)
        return args[5].shape[0] == N_ROWS

    stats = {}
    for n, qn in (("cosine_threshold_collect", MAIN_Q), ("cosine_chunk_topk", REPAIR_Q),
                  ("lex_topk_segments", MAIN_Q), ("cosine_coskey_collect", MAIN_Q),
                  ("coskey_rescore", MAIN_Q)):
        call = next(c for c in timed_calls[(n, qn)] if main_pass(c))
        stats[n] = time_kernel(fs, call, smi, "[3e]" if "coskey" in n else "[3]")
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
    # (name, rows, valid, group, queries, max_distance, byte_limit, wrap, paths)
    cases = [
        ("theta_from_sample", db, valid_all, None, base_q, 1e3, PH_BYTES, False, "auto"),
        ("theta_max_distance", db, valid_all, None, base_q, 1e3, PH_BYTES, False, "fused"),
        ("max_distance_0.1", db, valid_all, None, base_q, 0.1, PH_BYTES, False, "both"),
        ("tombstones_1pct", db, valid_1pct, None, base_q, 1e3, PH_BYTES, False, "both"),
        ("wrap_u8", db, valid_all, None, wrap_q, 1e3, PH_BYTES, True, "both"),
        ("byte_limit_24_group", db, valid_all, group, base_q, 1e3, 24, False, "both"),
        ("tie_flood", db_flood, valid_all, None, flood_q, 1e3, PH_BYTES, False, "both"),
    ]
    timed_calls = {}
    for name, rows, valid, grp, queries, md, limit, wrap, which in cases:
        idx = PackedHammingIndex(torch.from_numpy(rows).to(dev), torch.from_numpy(valid).to(dev))
        meta = fs.build_hamming_meta(idx, grp)
        smp = hg.build_hamming_scan_sample(idx, meta)
        ref = idx if grp is None else idx._replace(valid=meta.bool())
        sub = [0, 1, 2] if which != "fused" else [1]
        ovalid = valid if grp is None else valid & grp
        od, oi = oracle_hamming(queries[sub], rows, ovalid, K, md, limit, wrap)
        for qn in PH_QS:
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

    stats = {}
    for n, qn in (("hamming_threshold_collect", MAIN_Q), ("hamming_chunk_topk", REPAIR_Q),
                  ("hamming_threshold_collect", BIG_Q), ("hamming_chunk_topk", MAIN_Q)):
        call = next(c for c in timed_calls[(n, qn)] if c[1][2].shape[0] == N_ROWS)
        st = time_kernel(fs, call, smi, "[3b]", reps=10 if qn <= MAIN_Q else 3)
        stats.setdefault(n, st)  # the main-path shape (listed first) goes in the kernels line
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
    st = time_kernel(fs, main, smi, "[3c]", reps=3)
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

    # Timing at the int4 main path's shapes: K4a at the main pass (Q =
    # MAIN_Q over all rows, k = 400 — the rerank's candidates), K4b at a
    # repair bucket; asym (the default) in the kernels line, sym logged.
    stats = {}
    for n, qn in (("cosine4_threshold_collect", MAIN_Q), ("cosine4_chunk_topk", REPAIR_Q),
                  ("cosine4_threshold_collect", BIG_Q), ("cosine4_coskey_collect", MAIN_Q)):
        for mode in ("asym", "sym"):
            call = next(c for c in timed_calls[(n, mode, kmax, qn)] if c[1][5].shape[0] == N_ROWS)
            st = time_kernel(fs, call, smi, f"[3d] {mode} k={kmax}", reps=10 if qn <= MAIN_Q else 3)
            if mode == "asym":
                stats.setdefault(n, st)
    for mode in ("asym", "sym"):
        ab_collect(fs, *(next(c for c in timed_calls[(n, mode, kmax, MAIN_Q)] if c[1][5].shape[0] == N_ROWS)
                         for n in ("cosine4_threshold_collect", "cosine4_coskey_collect")),
                   smi, f"[3d] {mode} k={kmax} K4a vs K4d")
    return stats


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
    if name == "lex_topk_segments":
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
    else:
        outb = out[0].numel() * 8
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
    if name == "lex_topk_segments":
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


def phase_engine(fs, scan, smi, tmp):
    import numpy as np
    import torch

    from pixelbox_tpu_torch.engine import Engine
    from pixelbox_tpu_torch.models.efficientnet import save_params, seeded_state_dict
    from pixelbox_tpu_torch.ops.packed import PackedSemanticIndex
    from pixelbox_tpu_torch.records import IndexedImage
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
    filler = clustered_hashes(rng, N_ROWS - n_img, DIM)
    step = 1 << 17
    for s in range(0, filler.shape[0], step):
        batch = [
            IndexedImage(filename=f"syn_{j:07d}.png", path=f"/synthetic/syn_{j:07d}.png",
                         visual_hash=filler[j])
            for j in range(s, min(filler.shape[0], s + step))
        ]
        eng.insert_records_batch(batch)
    check(eng._sem_store.n == N_ROWS, f"store did not reach {N_ROWS:,} rows")
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
    for n in ("cosine_threshold_collect", "cosine_chunk_topk", "lex_topk_segments"):
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


def phase_phash(fs, scan, hg, smi, tmp, sem_eng, ckpt):
    import numpy as np
    import torch
    from PIL import Image

    from pixelbox_tpu_torch.engine import Engine
    from pixelbox_tpu_torch.ingest.decode import decode_image_file
    from pixelbox_tpu_torch.ops.phash import phash
    from pixelbox_tpu_torch.records import IndexedImage
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
    filler = clustered_phashes(rng, N_ROWS - n0, PH_BYTES, n_centers=262144)
    filler[1::1000] = flip_bits(rng, filler[0::1000][: len(filler[1::1000])], 4)  # near-dups
    step = 1 << 17
    for s in range(0, filler.shape[0], step):
        eng.insert_records_batch([
            IndexedImage(filename=f"ph_{j:07d}.png", path=f"/synthetic/ph_{j:07d}.png",
                         phash=filler[j])
            for j in range(s, min(filler.shape[0], s + step))
        ])
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
    for n in ("hamming_threshold_collect", "hamming_chunk_topk", "lex_topk_segments"):
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
            check(len(pairs) >= len(filler) // 1000, "duplicates by phash missed the planted near-dups")
    return counts, eng, paths


# --------------------------------------------------------------------- #
# Phase 6: the int4 engine (semantic4 store, exact-u8 rerank, duplicates)


def grow_semantic(eng, rng, n_rows, prefix):
    """Seeded hash-only records up to ``n_rows`` semantic rows."""
    from pixelbox_tpu_torch.records import IndexedImage

    n0 = eng._sem_store.n if eng._sem_store is not None else 0
    filler = clustered_hashes(rng, n_rows - n0, DIM)
    filler[1::1000] = perturb(rng, filler[0::1000][: len(filler[1::1000])], 3)  # near-dups
    step = 1 << 17
    for s in range(0, filler.shape[0], step):
        eng.insert_records_batch([
            IndexedImage(filename=f"{prefix}_{j:07d}.png", path=f"/synthetic/{prefix}_{j:07d}.png",
                         visual_hash=filler[j])
            for j in range(s, min(filler.shape[0], s + step))
        ])
    check(eng._sem_store.n == n_rows, f"store did not reach {n_rows:,} rows")


def phase_int4_engine(fs, scan, smi, tmp, ckpt):
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
    grow_semantic(eng, rng, N_ROWS, "syn4")
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
    grow_semantic(dup, rng, INT4_DUP_ROWS, "dup4")
    timing.reset_stats()
    t = time.perf_counter()
    pairs = dup.find_duplicate_pairs(max_distance=0.05, by="semantic")
    dup_s = time.perf_counter() - t
    dstats = timing.get_stats()
    counts = fs.launch_counts()  # the int4 path ends here; the checks below launch on their own
    log(f"[6] kernel launches on the int4 path: {json.dumps(counts)}")
    for n in ("cosine4_threshold_collect", "cosine4_chunk_topk", "lex_topk_segments"):
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


def service_burst(svc, queries):
    """``svc.submit`` from one thread a query, all released at once;
    returns the per-query (dist, rows)."""
    import threading

    out = [None] * len(queries)
    start = threading.Barrier(len(queries))

    def one(j):
        start.wait(timeout=60)
        out[j] = svc.submit(queries[j], timeout=300)

    threads = [threading.Thread(target=one, args=(j,)) for j in range(len(queries))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    check(all(r is not None for r in out), "service burst: a submit did not return")
    return out


def phase_serving(fs, smi, sem_eng, sem_paths, ph_eng, ph_paths, i4_eng):
    import threading
    import urllib.request

    import numpy as np
    from pixelbox_tpu_torch.records import IndexedImage
    from pixelbox_tpu_torch.serve import _serialize_results, build_scan_service, make_server
    from pixelbox_tpu_torch.serving.service import _COSKEY_MIN_BUCKET

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
        """A full bucket straight into a service — the batches the cos key
        serves (K1d/K4d + K1e) — against the same service's dist-path scan
        of the queries in two half buckets."""
        rows = eng._sem_store.get_rows(rng.choice(eng._sem_store.n, _COSKEY_MIN_BUCKET, replace=False))
        full_q = perturb(rng, rows)
        batches0, before = s.batches_run, dict(counts)
        t0 = time.perf_counter()
        got = counted(lambda: service_burst(s, full_q))
        wall = time.perf_counter() - t0
        half = _COSKEY_MIN_BUCKET // 2
        want = [tuple(np.asarray(x.cpu() if hasattr(x, "cpu") else x)
                      for x in s._semantic_scan(full_q[h:h + half], n_real=half))
                for h in (0, half)]
        for j, (d, i) in enumerate(got):
            wd, wi = want[j // half]
            check(np.array_equal(i, wi[j % half]) and np.array_equal(d, wd[j % half]),
                  f"{tag} full-bucket burst: query {j} differs from the dist-path scan")
        delta = {n: counts[n] - before[n] for n in counts if counts[n] != before[n]}
        log(f"{tag} full-bucket burst: {len(full_q)} submits in {wall * 1e3:.1f} ms, "
            f"{s.batches_run - batches0} batches, launches {json.dumps(delta)}; "
            f"every result = the dist-path scan; {smi}")

    full_bucket(svc, sem_eng, "[7] u8")

    # The int4 engine (exact-u8 rerank on): K4d on a serving path.
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
    full_bucket(i4_svc, i4_eng, "[7] int4")

    for srv, s in servers:
        srv.shutdown()
        srv.server_close()
        s.close()
    log(f"[7] kernel launches on the serving path: {json.dumps(counts)}")
    for n in ("cosine_threshold_collect", "cosine4_threshold_collect", "cosine_coskey_collect",
              "coskey_rescore", "cosine4_coskey_collect", "hamming_threshold_collect", "lex_topk_segments"):
        check(counts[n] > 0, f"kernel {n} was not launched on the serving path")
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
    check(merge[0] == "lex_topk_segments" and merge[1][0].shape[1] == n_shards * K, "the merge call")
    st = {"pass_ms": pass_ms, "shard_k1a": time_kernel(fs, shard_k1a, smi, "[8] one shard's"),
          "merge": time_kernel(fs, merge, smi, "[8] merge")}
    keys = fs._keys(merge[1][0], merge[1][1], None)
    st["merge"]["sort_ms"] = median_ms(lambda: torch.sort(keys, dim=1))
    row_bytes = index.capacity * (DIM + 12)  # meta rows 0-2: row 3 is padding no kernel reads
    log(f"[8] the sharded threshold pass at Q={MAIN_Q} ({n_shards} x θ stage + K1a + K1c, "
        f"merge): {pass_ms:.4f} ms; bound {row_bytes / HBM_BPS * 1e3:.4f} ms (bytes: every row "
        f"and its meta read once, {row_bytes:,} B); merge K1c {st['merge']['ms']:.4f} ms against "
        f"torch.sort of its (dist, id) keys {st['merge']['sort_ms']:.4f} ms; {smi}")
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
              "hamming_chunk_topk", "lex_topk_segments"):
        check(counts[n] > 0, f"kernel {n} was not launched on the mesh path")

    for key, want in ref.items():
        check(got[key] == want, f"mesh {key}: differs from the one-device result")
    for key, want in ref_dup.items():
        for j, ((d1, i1), (d2, i2)) in enumerate(zip(got_dup[key], want)):
            check(np.array_equal(d1, d2) and np.array_equal(i1, i2),
                  f"mesh duplicates {key}: batch {j} differs from the one-device scan")
    log(f"[8] mesh = one device: u8 similar ({len(sem_ids)} ids, auto; pallas and exact modes; "
        f"one upload), phash-similar ({len(ph_ids)} at 32 B and at 24 B), int4 similar with the "
        f"rerank ({len(i4_ids)}), duplicate cuts {[len(v) for v in got_dup.values()]} batches")

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
    torch.cuda.empty_cache()
    return counts, {"mesh": mesh, "q_id": sem_ids[3]}


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
    check(counts["cosine_threshold_collect"] > 0 and counts["lex_topk_segments"] > 0,
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
    mb.LAUNCHES["breakdown_ladder"] = 0  # the ladder's main path starts here
    t0 = time.perf_counter()
    res = mb.run()
    counts = {**fs.launch_counts(), **mb.LAUNCHES}  # and ends here
    log(f"[9] measure_breakdown at Q={mb.Q} x {mb.N_ROWS:,} x {mb.DIM}, TILE {mb.TILE}, "
        f"{mb.ITERS} repeats each: {json.dumps(res)} ({time.perf_counter() - t0:.1f}s; {smi})")
    check(counts["breakdown_ladder"] >= 4 * mb.ITERS, "the ladder kernel did not run its rungs")
    check(counts["cosine_threshold_collect"] > 0, "the shipping scan did not run")

    # Each rung once against its plain version, on rows planted near the
    # queries so that every lane it compares is finite and varied.
    q, idx, meta = mb.ladder_inputs(mb.N_ROWS, mb.DIM, mb.Q, seed=SEED, planted=True, device="cuda")
    mom = query_moments_from_u8(q[0])
    st = {"rungs": {}, "max_abs_err": 0.0}
    for rung in mb.RUNGS:
        out, dsum = mb.ladder(rung, *mom, idx.data, meta)
        torch.cuda.synchronize()
        pout, psum = mb.ladder_plain(rung, *mom, idx.data, meta)
        check(torch.equal(out.view(torch.int32), pout.view(torch.int32)) and torch.equal(dsum, psum),
              f"ladder rung {rung} differs from its plain version")
        fin = torch.isfinite(out) & torch.isfinite(pout)
        st["max_abs_err"] = max(st["max_abs_err"], float((out[fin] - pout[fin]).abs().max()))
        lanes = out if rung in ("gemm", "chain") else out[:, :1]
        check(bool(torch.isfinite(lanes).all()) and lanes.unique().numel() >= lanes.numel() // 4,
              f"ladder rung {rung}: outputs not finite and varied")
        p_ms = median_ms(lambda: mb.ladder_plain(rung, *mom, idx.data, meta), reps=3)
        n, d = idx.data.shape
        # the rungs past gemm read meta rows 0-2 (12 B a row), as K1a does
        nbytes = n * d + (0 if rung == "gemm" else 12 * n) + mb.Q * (d + 8) + mb.Q * 128 * 4
        ops = 2 * mb.Q * n * d
        b_bytes, b_ops = nbytes / HBM_BPS * 1e3, ops / INT8_OPS * 1e3
        st["rungs"][rung] = {"ms": res[f"{rung}_ms"], "plain_ms": p_ms, "bound_ms": max(b_bytes, b_ops),
                             "bound_by": "bytes" if b_bytes >= b_ops else "operations"}
        log(f"[9] rung {rung}: kernel {res[f'{rung}_ms']:.4f} ms, plain {p_ms:.4f} ms, bound "
            f"{max(b_bytes, b_ops):.4f} ms ({st['rungs'][rung]['bound_by']}: {nbytes:,} B, "
            f"{ops:,} ops); replayed bit-identical, finite and varied ({smi})")
    qp = mom[0].contiguous()
    st["library_ms"] = median_ms(lambda: torch._int_mm(qp, idx.data.t()))
    log(f"[9] library: the gemm rung's dot alone (torch._int_mm, Q={mb.Q}) {st['library_ms']:.4f} ms")
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

    from pixelbox_tpu_torch.tools import measure_breakdown

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        builds = [pool.submit(load) for load in (fs.load_kernels, measure_breakdown.load_kernels)]
        kerns = [b.result() for b in builds]
    for kern in kerns:
        log(f"[2] built {os.path.basename(kern.path)} in {kern.build_seconds:.2f}s")
        for line in kern.ptxas.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[2] ptxas: {line.strip()}")
    log(f"[2] both builds in {time.perf_counter() - t0:.2f}s (in parallel)")

    # [3] kernels vs plain, [3b] Hamming, [3c] large batches
    err = {n: 0.0 for n in Recorder.NAMES}
    t0 = time.perf_counter()
    stats, db = phase_kernels(fs, scan, smi, err)
    t0 = phase_time("3", t0)
    stats.update(phase_hamming(fs, scan, hg, smi, err))
    t0 = phase_time("3b", t0)
    phase_big_batch(fs, scan, smi, err, db)
    t0 = phase_time("3c", t0)
    stats.update(phase_int4_kernels(fs, scan, smi, err, db))
    t0 = phase_time("3d", t0)
    del db

    # [4] engine, [5] phash engine and duplicates, [6] int4 engine
    with tempfile.TemporaryDirectory(prefix="pixelbox_smoke_") as tmp:
        counts4, sem_eng, ckpt, sem_paths = phase_engine(fs, scan, smi, tmp)
        t0 = phase_time("4", t0)
        counts5, ph_eng, ph_paths = phase_phash(fs, scan, hg, smi, tmp, sem_eng, ckpt)
        t0 = phase_time("5", t0)
        counts6, i4_eng = phase_int4_engine(fs, scan, smi, tmp, ckpt)
        t0 = phase_time("6", t0)
        counts8, carry = phase_mesh(fs, scan, smi, err, sem_eng, sem_paths, ph_eng, i4_eng)
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
    replaces = {
        "cosine_threshold_collect": "pixelbox_tpu/ops/pallas_scan.py:979",
        "cosine_chunk_topk": "pixelbox_tpu/ops/pallas_scan.py:1074",
        "lex_topk_segments": "pixelbox_tpu/ops/pallas_scan.py:192",
        "hamming_threshold_collect": "pixelbox_tpu/ops/pallas_scan.py:1012",
        "hamming_chunk_topk": "pixelbox_tpu/ops/pallas_scan.py:192",
        "cosine4_threshold_collect": "pixelbox_tpu/ops/int4.py:376",
        "cosine4_chunk_topk": "pixelbox_tpu/ops/int4.py:376",
        "cosine_coskey_collect": "pixelbox_tpu/ops/pallas_scan.py:171",
        "cosine4_coskey_collect": "pixelbox_tpu/ops/pallas_scan.py:171",
        "coskey_rescore": "pixelbox_tpu/ops/pallas_scan.py:747",
    }
    kernels = []
    for n in Recorder.NAMES:
        st = stats[n]
        kernels.append({
            "name": n,
            "route": "cuda",
            "source": "pixelbox_tpu_torch/csrc/fused_scan.cu",
            "replaces": replaces[n],
            "launches": sum(c[n] for c in (counts4, counts5, counts6, counts7, counts8, counts8b, counts9)),
            "max_abs_err": err[n],
            **{key: st[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            **({"dot_only_ms": st["dot_only_ms"]} if "dot_only_ms" in st else {}),
        })
    kernels.append({
        "name": "breakdown_ladder",
        "route": "cuda",
        "source": "pixelbox_tpu_torch/csrc/breakdown.cu",
        "replaces": "scripts/measure_breakdown.py:52",
        "launches": counts9["breakdown_ladder"],
        "max_abs_err": ladder["max_abs_err"],
        **{key: ladder["rungs"]["gemm"][key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": ladder["library_ms"],
        "rungs": ladder["rungs"],
    })
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
