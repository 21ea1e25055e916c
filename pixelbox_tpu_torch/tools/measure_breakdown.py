"""Per-stage breakdown of the threshold scan on the card — the port of
``scripts/measure_breakdown.py``.

    python -m pixelbox_tpu_torch.tools.measure_breakdown

A ladder of one hand-written kernel (``csrc/breakdown.cu``
``tc_ladder_kernel``, the port of that script's ``_ablate_kernel``),
templated on the rung, at Q = 256 × 1,048,576 × 128 with TILE = 8,192:

  gemm      the int8 product only (lanes 0..127 of each tile, plus the
            [Q] int64 sum of every dot, which keeps the whole product)
  coskey    + the cos key of K1d and its filter; each tile's least key
  epilogue  + K1a's spec distance and its θ = 0.02 filter; each tile's
            least distance
  chain     + the TPU kernel's depth-2 lane-class summary

then the θ stage alone (``fused_scan.sample_theta``) and the shipping
threshold scan (``fused_scan.fused_threshold_scan_topk``, k = 100).  The
kernel is built from the shipping K1a's product (``csrc/tc_scan.cu``: the
TMA ring, int8 ``wgmma`` with the rows K-major as A and up to 256 queries
as B, the exact f32 centered dot from the accumulators), so differences
between rungs are K1a's stages.  A 64-row sub-tile is one lane's 64
registers of a tile (rows 128 apart, a 3-D TMA box), so that the chain
walks each lane's registers in order.  Each timing is CUDA events
around 20 launches on 20 distinct query batches, divided by 20; the
null floor is one trivial launch timed the same way.  Prints one JSON
line with the JAX script's keys and the card's ``nvidia-smi`` name and
power limit.

:func:`ladder` is the kernel's wrapper: a CUDA tensor goes to the kernel
(or it raises), a CPU tensor to :func:`ladder_plain`, its plain PyTorch
version, which follows the JAX kernel op for op (tiles summed in order).
:func:`ladder_dp4a` launches the first port's ladder (``ladder_kernel``,
the ``__dp4a`` K1a's staged-query loop), kept as the timing reference.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import threading
from typing import Optional

import numpy as np
import torch

from pixelbox_tpu_torch.ops import fused_scan as fs
from pixelbox_tpu_torch.ops.distances import _f32
from pixelbox_tpu_torch.ops.packed import (
    PackedSemanticIndex,
    query_moments_from_u8,
    semantic_rows_from_u8,
)

RUNGS = ("gemm", "coskey", "epilogue", "chain")
N_ROWS, DIM, K, Q = 1 << 20, 128, 100, 256
TILE = 8192
ITERS = 20
LANES = 128
#: The most 128-row registers a tile holds: the tensor-core kernel's
#: 64-row sub-tile is one lane's registers (8,192 rows a tile).
MAX_REGS = 64
#: The JAX kernel's constants: the stand-in query rsqrt, the epilogue's
#: distance filter and the cos key's filter.
QR, THETA, KEY_THETA = 1e-3, 0.02, -0.5

#: Launch counts of the ladder kernel and of the first port's (one per
#: wrapper call that launches; CPU tensors, which take the plain version,
#: do not count).
LAUNCHES = {"breakdown_ladder": 0, "breakdown_ladder_dp4a": 0}

_KERNELS: Optional[fs._Kernels] = None
_KERNELS_LOCK = threading.Lock()


def load_kernels() -> fs._Kernels:
    """Compile ``csrc/breakdown.cu`` for sm_90a (once per content) and bind
    ``px_tc_ladder`` and the first port's ``px_ladder``.  Raises on any
    failure — there is no fallback."""
    global _KERNELS
    with _KERNELS_LOCK:
        if _KERNELS is None:
            kern = fs.build_library(("breakdown.cu",), "libpixelbox_breakdown")
            vp, ci = ctypes.c_void_p, ctypes.c_int
            kern.lib.px_tc_ladder.restype = ci
            kern.lib.px_tc_ladder.argtypes = [ci] + [vp] * 5 + [ci] * 4 + [vp] * 8
            kern.lib.px_ladder.restype = ci
            kern.lib.px_ladder.argtypes = [ci] + [vp] * 5 + [ci] * 4 + [vp] * 9
            _KERNELS = kern
        return _KERNELS


def _check_args(rung, q_codes, q_sum, q_mag2, data, meta, tile_rows):
    if rung not in RUNGS:
        raise ValueError(f"rung must be one of {RUNGS}, got {rung!r}")
    dev = data.device
    qn, d = q_codes.shape
    n = data.shape[0]
    fs._require(q_codes, "q_codes", torch.int8, (qn, d), dev)
    fs._require(q_sum, "q_sum", torch.int32, (qn,), dev)
    fs._require(q_mag2, "q_mag2", torch.int32, (qn,), dev)
    fs._require(data, "data", torch.int8, (n, d), dev)
    fs._require(meta, "meta", torch.int32, (4, n), dev)
    if d != DIM:
        raise ValueError(f"dim {d}: the ladder takes rows of {DIM} bytes")
    regs = tile_rows // LANES
    if tile_rows % LANES or regs < 2 or regs > MAX_REGS or regs & (regs - 1):
        raise ValueError(f"tile_rows {tile_rows}: needs 128·2^j rows, 2 <= 2^j <= {MAX_REGS}")
    if n % tile_rows:
        raise ValueError(f"{n} rows is not a multiple of tile_rows {tile_rows}")
    return dev, qn, n, d


def ladder(rung: str, q_codes, q_sum, q_mag2, data, meta, tile_rows: int = TILE):
    """One rung of the ladder over int8 rows ``data`` [N, D] and their
    [4, N] ``meta`` (``fused_scan.build_row_meta``) for int8 query codes
    [Q, D] with their sums and moments (``query_moments_from_u8``).
    Returns (out [Q, 128] f32 — the JAX kernel's output — and dot_sum
    [Q] int64, the sum of every row's dot for the gemm rung, zeros for
    the others).

    Replaces ``scripts/measure_breakdown.py:_ablate_kernel`` (launch
    :127).  On the card: ``tc_ladder_kernel``, the shipping K1a's int8
    ``wgmma`` product over rows of :data:`DIM` bytes, then per rung its
    stages on the accumulators, at tiles of at most 8,192 rows
    (:data:`MAX_REGS` registers); bound by the rows' bytes and the int8
    product for gemm, by each rung's work on every pair past it.
    """
    dev, qn, n, d = _check_args(rung, q_codes, q_sum, q_mag2, data, meta, tile_rows)
    if dev.type != "cuda":
        return ladder_plain(rung, q_codes, q_sum, q_mag2, data, meta, tile_rows)
    if data.data_ptr() % 16:
        raise ValueError("data must be 16-byte aligned")
    if q_codes.data_ptr() % 16:  # a TMA source: copy an unaligned view
        q_codes = q_codes.clone()
    kern = load_kernels()
    t = n // tile_rows
    one = torch.empty(1, dtype=torch.int32, device=dev)  # stands in for unused scratch
    part_dot = part_min = part_lmin = part_l2min = part_meta = one
    if rung == "gemm":
        part_dot = torch.empty((t, LANES, qn), dtype=torch.int32, device=dev)
    elif rung == "chain":
        part_lmin = torch.empty((t, LANES, qn), dtype=torch.float32, device=dev)
        part_l2min = torch.empty_like(part_lmin)
        part_meta = torch.empty((t, LANES, qn), dtype=torch.int32, device=dev)
    else:
        part_min = torch.full((t, qn), -1, dtype=torch.int32, device=dev)
    out = torch.empty((qn, LANES), dtype=torch.float32, device=dev)
    dot_sum = torch.zeros(qn, dtype=torch.int64, device=dev)
    q_mag2f = q_mag2.to(torch.float32)
    with torch.cuda.device(dev):
        rc = kern.lib.px_tc_ladder(
            RUNGS.index(rung), fs._ptr(q_codes), fs._ptr(q_sum), fs._ptr(q_mag2f), fs._ptr(data),
            fs._ptr(meta), qn, n, d, tile_rows, fs._ptr(part_dot), fs._ptr(part_min),
            fs._ptr(part_lmin), fs._ptr(part_l2min), fs._ptr(part_meta), fs._ptr(out),
            fs._ptr(dot_sum), fs._stream(dev),
        )
    fs._check(rc, "breakdown_ladder")
    LAUNCHES["breakdown_ladder"] += 1
    return out, dot_sum


def ladder_dp4a(rung: str, q_codes, q_sum, q_mag2, data, meta, tile_rows: int = TILE):
    """:func:`ladder` on the first port's ``__dp4a`` kernel
    (``csrc/breakdown.cu`` ``ladder_kernel``: the first port's K1a tiling,
    one thread a row against 32 staged queries), for CUDA tensors only:
    the timing reference of the tensor-core ladder.  Same outputs."""
    dev, qn, n, d = _check_args(rung, q_codes, q_sum, q_mag2, data, meta, tile_rows)
    if fs._COLLECT_Q * d + fs._COLLECT_Q * 256 * 4 > 48 * 1024:
        raise ValueError(f"dim {d} too wide for the ladder kernel")
    kern = load_kernels()
    t = n // tile_rows
    one = torch.empty(1, dtype=torch.int32, device=dev)  # stands in for unused scratch
    part_dot = part_sum = part_min = part_lmin = part_l2min = part_meta = one
    if rung == "gemm":
        part_dot = torch.empty((t, qn, LANES), dtype=torch.int32, device=dev)
        part_sum = torch.zeros((t, qn), dtype=torch.int64, device=dev)
    elif rung == "chain":
        part_lmin = torch.empty((t, qn, LANES), dtype=torch.float32, device=dev)
        part_l2min = torch.empty_like(part_lmin)
        part_meta = torch.empty((t, qn, LANES), dtype=torch.int32, device=dev)
    else:
        part_min = torch.full((t, qn), -1, dtype=torch.int32, device=dev)
    out = torch.empty((qn, LANES), dtype=torch.float32, device=dev)
    dot_sum = torch.zeros(qn, dtype=torch.int64, device=dev)
    q_mag2f = q_mag2.to(torch.float32)
    with torch.cuda.device(dev):
        rc = kern.lib.px_ladder(
            RUNGS.index(rung), fs._ptr(q_codes), fs._ptr(q_sum), fs._ptr(q_mag2f), fs._ptr(data),
            fs._ptr(meta), qn, n, d, tile_rows, fs._ptr(part_dot), fs._ptr(part_sum),
            fs._ptr(part_min), fs._ptr(part_lmin), fs._ptr(part_l2min), fs._ptr(part_meta),
            fs._ptr(out), fs._ptr(dot_sum), fs._stream(dev),
        )
    fs._check(rc, "breakdown_ladder_dp4a")
    LAUNCHES["breakdown_ladder_dp4a"] += 1
    return out, dot_sum


def _rung_values(rung, q_codes, q_sum, q_mag2, data, meta):
    """[Q, B] values a rung keeps for a row block (+inf where its filter
    fails or the row is invalid) — the JAX kernel's, op for op."""
    qn = q_codes.shape[0]
    dot8 = fs._dot8(q_codes, data)
    dot_c = fs._centered("cosine", dot8, q_sum[:, None], meta[0][None, :], data.shape[1])
    rr = meta[2].contiguous().view(torch.float32)[None, :]
    qr = torch.full((qn, 1), float(np.float32(QR)), dtype=torch.float32, device=data.device)
    valid = (meta[1] > 0)[None, :]
    if rung == "coskey":
        v = -(dot_c.to(torch.float32) * (qr * rr))
        keep = valid & (v < _f32(KEY_THETA, v))
    else:
        v = fs._spec_epilogue(dot_c, qr, rr, q_mag2[:, None], meta[1][None, :])
        keep = valid & (v < _f32(THETA, v))
    return torch.where(keep, v, torch.full_like(v, float("inf")))


def _chain_summary(v):
    """The JAX chain over the registers of a block of tiles: ``v`` [Q, T,
    regs, 128] → (lmin, l2min, lcnt, lreg, l2reg), each [Q, T, 128]."""
    inf = torch.full_like(v[:, :, 0], float("inf"))
    zero = torch.zeros(v[:, :, 0].shape, dtype=torch.int32, device=v.device)
    lmin, l2min, lreg, l2reg, lcnt = inf, inf, zero, zero, zero
    for r in range(v.shape[2]):
        x = v[:, :, r]
        lcnt = lcnt + (x < inf).to(torch.int32)
        upd1 = x < lmin
        d_val = torch.where(upd1, lmin, x)
        d_reg = torch.where(upd1, lreg, torch.full_like(lreg, r))
        lmin = torch.where(upd1, x, lmin)
        lreg = torch.where(upd1, torch.full_like(lreg, r), lreg)
        upd2 = d_val < l2min
        l2min = torch.where(upd2, d_val, l2min)
        l2reg = torch.where(upd2, d_reg, l2reg)
    return lmin, l2min, lcnt, lreg, l2reg


def ladder_plain(rung, q_codes, q_sum, q_mag2, data, meta, tile_rows: int = TILE):
    """Plain PyTorch version of :func:`ladder`: every tile's partial as the
    JAX kernel computes it, added into the [Q, 128] output in tile order
    (f32, one correctly rounded add at a time)."""
    _check_args(rung, q_codes, q_sum, q_mag2, data, meta, tile_rows)
    dev = data.device
    qn = q_codes.shape[0]
    n = data.shape[0]
    t_n = n // tile_rows
    out = torch.zeros((qn, LANES), dtype=torch.float32, device=dev)
    dot_sum = torch.zeros(qn, dtype=torch.int64, device=dev)
    if rung == "gemm":
        # Σ over rows of q·row = q · Σ rows, exact in int64.
        dot_sum = (q_codes.to(torch.int64) * data.to(torch.int64).sum(0)).sum(1)
        for t in range(t_n):
            lo = t * tile_rows
            out = out + fs._dot8(q_codes, data[lo : lo + LANES]).to(torch.float32)
        return out, dot_sum
    # Row blocks of whole tiles bound the [Q, rows] temporaries.
    per = max(1, fs._PLAIN_BLOCK // tile_rows)
    for t0 in range(0, t_n, per):
        lo, hi = t0 * tile_rows, min(n, (t0 + per) * tile_rows)
        v = _rung_values(rung, q_codes, q_sum, q_mag2, data[lo:hi], meta[:, lo:hi])
        tiles = v.reshape(qn, -1, tile_rows)
        if rung in ("coskey", "epilogue"):
            m0 = tiles.min(dim=2).values
            for t in range(m0.shape[1]):
                out[:, 0] = out[:, 0] + m0[:, t]
            continue
        parts = _chain_summary(tiles.reshape(qn, tiles.shape[1], -1, LANES))
        for t in range(tiles.shape[1]):
            for p in parts:
                out = out + p[:, t].to(torch.float32)
    return out, dot_sum


# --------------------------------------------------------------------- #
# Inputs and the timed run


def ladder_inputs(n: int, d: int, q: int, seed: int = 0, planted: bool = False,
                  batches: int = 1, device="cpu"):
    """Seeded inputs: (queries u8 [batches, Q, D], index, meta).

    ``planted=False``: uniform u8 rows and queries, as the JAX script
    draws them — on such rows no row passes the epilogue's θ = 0.02 or
    the cos key's −0.5, so those rungs give +inf in lane 0 and the chain
    +inf everywhere.  ``planted=True``: queries and rows near one base
    of centred norm ~1000 (so the stand-in rsqrt 1e-3 is about the true
    one); rows of the 128-row registers r ≡ 0, 1 (mod 4) are near copies
    (they pass), r ≡ 2 farther, r ≡ 3 uniform, and every 97th row is a
    tombstone — every rung's output is finite and varied."""
    rng = np.random.default_rng(seed)
    if planted:
        base = rng.standard_normal(d)
        base *= 995.0 / np.linalg.norm(base)  # centred (2u - 255) units
        qs = base + rng.normal(0.0, 3.0, (batches, q, d))
        rows = np.empty((n, d))
        reg = (np.arange(n) // LANES) % 4
        near = reg <= 1
        rows[near] = base + rng.normal(0.0, 4.0, (int(near.sum()), d))
        mid = reg == 2
        rows[mid] = base + rng.normal(0.0, 60.0, (int(mid.sum()), d))
        far = reg == 3
        rows[far] = rng.uniform(-255.0, 255.0, (int(far.sum()), d))
        to_u8 = lambda x: np.clip(np.rint((x + 255.0) / 2.0), 0, 255).astype(np.uint8)
        qs_u8, rows_u8 = to_u8(qs), to_u8(rows)
        valid = np.arange(n) % 97 != 0
    else:
        rows_u8 = rng.integers(0, 256, (n, d), dtype=np.uint8)
        qs_u8 = rng.integers(0, 256, (batches, q, d), dtype=np.uint8)
        valid = np.ones(n, dtype=bool)
    data, row_sum, row_mag2 = semantic_rows_from_u8(rows_u8)
    index = PackedSemanticIndex(
        *(torch.from_numpy(x).to(device) for x in (data, row_sum, row_mag2, valid))
    )
    return torch.from_numpy(qs_u8).to(device), index, fs.build_row_meta(index)


def _loop_ms(fn, iters: int) -> float:
    """Mean ms per call of ``fn(i)`` over i = 0..iters-1, back to back
    between two CUDA events, after one warm-up call."""
    fn(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def card_line() -> str:
    """The card's ``nvidia-smi`` name and power limit."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def run(n: int = N_ROWS, q: int = Q, d: int = DIM, tile_rows: int = TILE, k: int = K,
        iters: int = ITERS, seed: int = 0, device="cuda") -> dict:
    """Time the null floor, each rung, the θ stage and the shipping scan on
    the card; returns the JAX script's keys in ms.  Raises without a
    card: these are device times."""
    from pixelbox_tpu_torch.ops.scan import build_scan_sample
    from pixelbox_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the breakdown times the card: pass a CUDA device")
    qs, index, meta = ladder_inputs(n, d, q, seed, batches=iters, device=dev)
    sample = build_scan_sample(index)
    moments = [query_moments_from_u8(qs[i]) for i in range(iters)]
    results = {}
    nul = torch.zeros((8, 8), dtype=torch.float32, device=dev)
    results["null_floor_ms"] = _loop_ms(lambda i: torch.sum(nul), iters)
    for rung in RUNGS:
        results[f"{rung}_ms"] = _loop_ms(
            lambda i: ladder(rung, *moments[i], index.data, meta, tile_rows), iters
        )
    qks = [fs.CosineQueries.from_u8(qs[i]) for i in range(iters)]
    s = sample.data.shape[0]
    # The main pass's sample rank at k (fused_scan._threshold_scan).
    j = min(s, max(1, -(-max(16 * k // 5, 256) * s // n)))
    results["theta_stage_ms"] = _loop_ms(lambda i: fs.sample_theta(qks[i], sample, 1e3, j), iters)
    results["v2_total_ms"] = _loop_ms(
        lambda i: fs.fused_threshold_scan_topk(qs[i], index, meta, sample, k=k), iters
    )
    return results


def main() -> int:
    res = run()
    res["device"] = card_line()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
