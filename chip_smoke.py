#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pixelbox_tpu_torch) on one card.

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and exits non-zero):

1. Device: requires ``torch.cuda.is_available()``; prints the card and
   ``nvidia-smi`` name/power limit; holds the exact numerics (TF32 off,
   cuDNN deterministic, benchmark off).
2. Build: compiles ``pixelbox_tpu_torch/csrc/*.cu`` for sm_90a.
3. Kernels vs plain at the main shapes (1,048,576 rows × 128, k = 100,
   Q ∈ {1, 8, 256}) in five cases: θ from the sample, θ = max_distance, a
   max_distance filter that excludes rows, 1% invalid rows, and a tie
   flood that must defeat the proof and be repaired.  Every kernel launch
   the path makes is recorded and replayed through the kernel's plain
   PyTorch version on the same inputs — outputs must be bit-identical —
   and the end-to-end results must equal the exact scan, and the numpy
   oracle on a sub-sample of queries.  Kernel and plain medians are timed
   with CUDA events.
4. Engine: indexes 32 seeded images with EfficientNet-B0 at 224²/dim 128
   from a seeded checkpoint (then 64 more, warm), checks the exact-0.0
   self-match, grows the store to 1,048,576 rows with seeded hash-only
   records, runs ``similar`` under ``auto`` and ``pallas`` — counting
   kernel launches from zero, and splitting its latency into the engine's
   timing spans — and holds the results against the exact scan and the
   plain (CPU) path.

The last lines are the kernels' JSON summary and
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
K = 100
QS = (1, 8, 256)
SEED = 20261016


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
    """Wraps the three kernel wrappers of ops.fused_scan; records inputs
    and outputs so each call can be replayed through its plain version."""

    NAMES = ("cosine_threshold_collect", "cosine_chunk_topk", "lex_topk_segments")

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
    if name == "cosine_threshold_collect":
        q_codes, q_sum, q_mag2, qr, theta, data, meta, cap = args
        c2, d2, i2 = fs.cosine_threshold_collect_plain(
            q_codes, q_sum, q_mag2, qr, theta, data, meta, cap
        )
        c1, d1, i1 = out
        check(torch.equal(c1, c2), "K1a count differs from plain")
        ok = c1 <= cap
        lens = torch.clamp(c1, max=cap)
        s1 = fs.lex_topk_segments_plain(d1, i1, cap, lens, segment=cap)
        s2 = fs.lex_topk_segments_plain(d2, i2, cap, lens, segment=cap)
        check(torch.equal(s1[0][ok], s2[0][ok]), "K1a distances differ from plain")
        check(torch.equal(s1[1][ok], s2[1][ok]), "K1a row ids differ from plain")
        a, b = s1[0][ok], s2[0][ok]
    elif name == "cosine_chunk_topk":
        d2, i2 = fs.cosine_chunk_topk_plain(*args, **kwargs)
        check(torch.equal(out[0], d2) and torch.equal(out[1], i2), "K1b differs from plain")
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


def phase_kernels(fs, scan, smi):
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

    flood_row = 123456
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
    db_flood[600000:608192] = db[flood_row]  # 8,192 duplicates
    flood_q = base_q.copy()
    flood_q[0] = db[flood_row]
    flood_q[2] = perturb(rng, db[flood_row][None])[0]
    cases.append(("tie_flood", db_flood, valid_all, flood_q, 1e3, "both"))

    err = {n: 0.0 for n in Recorder.NAMES}
    timed_calls = {}
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
            extra = f", proven {n_exact}/{qn}" if which in ("auto", "both") else ""
            log(f"[3] {name} Q={qn}: {len(rec.calls)} kernel calls replayed bit-identical; "
                f"= exact scan and oracle{extra}")
            if name == "tie_flood" and qn >= 1:
                fi = i[0].cpu().numpy()
                flood_ids = np.concatenate([[flood_row], np.arange(600000, 600000 + K - 1)])
                check(np.array_equal(fi, flood_ids), "tie flood: ids not ascending within the tie")
                check(not bool(exact[0]), "tie flood: the proof was not defeated")
        del idx, meta, smp
        torch.cuda.empty_cache()

    # Timing at the main path's shapes: K1a and K1c at the main pass
    # (Q = 256 over all rows, k = 100), K1b at a repair bucket (Q = 8).
    def main_pass(call):
        name, args, kwargs, _ = call
        if name == "lex_topk_segments":
            return args[2] == K and (len(args) > 3 or kwargs.get("lens") is not None)
        return args[5].shape[0] == N_ROWS

    timing = {}
    for n, qn in (("cosine_threshold_collect", 256), ("cosine_chunk_topk", 8),
                  ("lex_topk_segments", 256)):
        _, args, kwargs, _ = next(c for c in timed_calls[(n, qn)] if main_pass(c))
        kern, plain = getattr(fs, n), getattr(fs, n + "_plain")
        k_ms = median_ms(lambda: kern(*args, **kwargs))
        p_ms = median_ms(lambda: plain(*args, **kwargs))
        timing[n] = (k_ms, p_ms)
        shape = "x".join(str(x) for x in args[0].shape)
        log(f"[3] {n} on {shape} (Q={qn}): kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms "
            f"(median of 10, CUDA events; {smi})")
    return err, timing


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
        h = res[0].visual_hash
        scan_lat = []
        for rep in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            d, i = eng.similarity_scan(h, K, 1e3)
            torch.cuda.synchronize()
            scan_lat.append(time.perf_counter() - t)
        log(f"[4] similar ({mode}) on {eng._sem_store.n:,} rows: end-to-end median "
            f"{statistics.median(lat) * 1e3:.2f} ms (decode+B0+scan), scan median "
            f"{statistics.median(scan_lat) * 1e3:.3f} ms; {smi}")
        log(f"[4] similar ({mode}) spans, mean ms over the 5 timed queries: {json.dumps(spans)}")
    counts = fs.launch_counts()  # the main path ends here
    log(f"[4] kernel launches on the main path: {json.dumps(counts)}")
    for n, c in counts.items():
        check(c > 0, f"kernel {n} was not launched on the main path")

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
    eng.close()
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this smoke needs a CUDA card",
              file=sys.stderr)
        return 2
    from pixelbox_tpu_torch.ops import fused_scan as fs
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

    # [2] build
    t0 = time.perf_counter()
    kern = fs.load_kernels()
    log(f"[2] built {os.path.basename(kern.path)} in {time.perf_counter() - t0:.2f}s")
    for line in kern.ptxas.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[2] ptxas: {line.strip()}")

    # [3] kernels vs plain
    err, timing = phase_kernels(fs, scan, smi)

    # [4] engine
    with tempfile.TemporaryDirectory(prefix="pixelbox_smoke_") as tmp:
        counts = phase_engine(fs, scan, smi, tmp)

    check("jax" not in sys.modules, "jax was imported")
    replaces = {
        "cosine_threshold_collect": "pixelbox_tpu/ops/pallas_scan.py:192",
        "cosine_chunk_topk": "pixelbox_tpu/ops/pallas_scan.py:192",
        "lex_topk_segments": "pixelbox_tpu/ops/pallas_scan.py:192",
    }
    kernels = [
        {
            "name": n,
            "route": "cuda",
            "source": "pixelbox_tpu_torch/csrc/fused_scan.cu",
            "replaces": replaces[n],
            "launches": counts[n],
            "max_abs_err": err[n],
            "ms": timing[n][0],
            "plain_ms": timing[n][1],
        }
        for n in Recorder.NAMES
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
