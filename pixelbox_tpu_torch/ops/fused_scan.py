"""Fused threshold scans with guaranteed-exact top-k — the counterpart of
``pixelbox_tpu/ops/pallas_scan.py``.

Three hand-written Hopper kernels (``csrc/fused_scan.cu``) replace the
JAX package's one Pallas TPU kernel on the main path
(``pallas_scan.py:_threshold_kernel``, kind="cosine", select="carry"):

- **K1a** :func:`cosine_threshold_collect` — exact int8 dot + spec-v2
  epilogue + strict ``dist < θ_q`` filter; passing rows are appended to a
  per-query ``[Q, cap]`` buffer with an exact atomic count.
- **K1b** :func:`cosine_chunk_topk` — the same dot and epilogue with
  θ = max_distance; each block sorts its row chunk by (dist, id) in shared
  memory and keeps the chunk's first k.
- **K1c** :func:`lex_topk_segments` — per (query, segment) bitonic sort on
  (dist, id), keeping k; re-launched until one segment per query remains.
  It finishes K1a's buffer and K1b's partials, and sorting on the id as
  the second key makes both independent of atomic order.

Uses, exactly where the JAX package launched its kernel:

- θ estimate (:func:`sample_theta`, was ``_pallas_sample_theta``): stage 1
  plain torch over a 1/16 mini-sample, stage 2 K1a + K1c over the sample;
- main pass (:func:`fused_threshold_scan_topk`, was
  ``pallas_threshold_scan_topk_v2``): K1a + K1c, proof
  ``count <= cap ∧ (count >= k ∨ θ unbound)`` (the JAX buffer contract);
- exact scan (:func:`fused_cosine_scan_topk`, was
  ``pallas_cosine_scan_topk``): K1b + K1c, unconditionally exact — the
  auto path's repair and ``--scan-mode pallas``.

Dispatch is by device and nothing else: a CUDA tensor goes to the kernel
(or the wrapper raises), a CPU tensor goes to the kernel's plain PyTorch
version in this module.  The plain versions compute the dot exactly (a
float64 matmul of int8 codes is exact for any realistic D) and select
with a (dist, id) sort; the CPU tests hold them bit-identical to the JAX
package, and ``chip_smoke.py`` holds the kernels bit-identical to them.

What bounds the kernels on the card: K1a/K1b read the int8 index once
per query tile (32 / 4 queries) and spend ~D/4 ``__dp4a`` per (query,
row) plus one correctly-rounded divide — integer-ALU and divide bound at
Q >= 32, HBM-read bound below.  The design keeps distances out of device
memory (only θ-passing rows or each chunk's top-k are written); making
the dot a tensor-core ``wgmma`` int8 product and fusing K1a with K1c is
later work (ROADMAP.md).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from pixelbox_tpu_torch.ops import topk as topk_ops
from pixelbox_tpu_torch.ops.distances import _f32, rsqrt_spec
from pixelbox_tpu_torch.ops.packed import PackedSemanticIndex, query_moments_from_u8

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SOURCES = ("fused_scan.cu",)
NVCC_FLAGS = (
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "-gencode", "arch=compute_90a,code=sm_90a", "-fmad=false",
    "-Xptxas", "-v",
)

#: Queries staged per K1a block; K1a stages ``_COLLECT_Q * D`` bytes of
#: shared memory (must stay under the 48 KB static-launch limit).
_COLLECT_Q = 32
#: Rows per K1b chunk (power of two); the chunk keeps its first k.
CHUNK_ROWS = 1024
#: Candidates per K1c segment (power of two, >= 2k so each pass shrinks).
SEGMENT = 2048
#: Largest k the kernels take (K1b keeps k of CHUNK_ROWS, K1c k of SEGMENT/2).
MAX_K = 1024
#: Row block of the plain versions (bounds their [Q, block] temporaries).
_PLAIN_BLOCK = 65536


# --------------------------------------------------------------------- #
# Build + bind (nvcc into the package's git-ignored build directory,
# plain C interface, ctypes)


class _Kernels(NamedTuple):
    lib: ctypes.CDLL
    path: str
    build_seconds: float
    ptxas: str


_KERNELS: Optional[_Kernels] = None
_KERNELS_LOCK = threading.Lock()


def _build_dir() -> Path:
    d = os.environ.get("PIXELBOX_TPU_TORCH_BUILD_DIR")
    return Path(d) if d else _CSRC.parent / "_build"


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def load_kernels() -> _Kernels:
    """Compile ``csrc/*.cu`` for sm_90a (once per source/flag content) and
    load the library.  Raises on any failure — there is no fallback."""
    global _KERNELS
    with _KERNELS_LOCK:
        if _KERNELS is None:
            _KERNELS = _build_and_load()
        return _KERNELS


def _build_and_load() -> _Kernels:
    srcs = [_CSRC / s for s in _SOURCES]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.read_bytes())
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"libpixelbox_fused_scan-{h.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    ptxas = ""
    if not so.exists():
        tmp = out_dir / f".{so.name}.{os.getpid()}"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}"
            )
        ptxas = res.stderr
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.px_threshold_collect.restype = ci
    lib.px_threshold_collect.argtypes = [vp] * 7 + [ci] * 4 + [vp] * 4
    lib.px_chunk_topk.restype = ci
    lib.px_chunk_topk.argtypes = [vp] * 4 + [cf, vp, vp] + [ci] * 6 + [vp] * 3
    lib.px_lex_topk_segments.restype = ci
    lib.px_lex_topk_segments.argtypes = [vp] * 3 + [ci] * 5 + [vp] * 3
    return _Kernels(lib, str(so), time.perf_counter() - t0, ptxas)


def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def _stream(dev: torch.device):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {rc})")


def _require(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_query_args(q_codes, q_sum, q_mag2, qr, data, meta):
    dev = data.device
    qn, d = q_codes.shape
    n = data.shape[0]
    _require(q_codes, "q_codes", torch.int8, (qn, d), dev)
    _require(q_sum, "q_sum", torch.int32, (qn,), dev)
    _require(q_mag2, "q_mag2", torch.int32, (qn,), dev)
    _require(qr, "qr", torch.float32, (qn,), dev)
    _require(data, "data", torch.int8, (n, d), dev)
    _require(meta, "meta", torch.int32, (4, n), dev)
    if data.data_ptr() % 16:
        raise ValueError("data must be 16-byte aligned")
    return dev, qn, n, d


#: Plain-integer launch counts, one per kernel wrapper; each wrapper adds
#: one where it launches its kernel and nowhere else (CPU tensors, which
#: take the plain version, do not count).
LAUNCHES = {"cosine_threshold_collect": 0, "cosine_chunk_topk": 0, "lex_topk_segments": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


# --------------------------------------------------------------------- #
# Row meta: [4, N] int32 = [row_sum, mag2 (0 = invalid), bitcast f32
# rsqrt_spec(mag2), pad] — the JAX package's layout (pallas_scan.py:94).


def build_row_meta(index: PackedSemanticIndex) -> torch.Tensor:
    """[4, N] int32 kernel meta: row 0 = centered row sums; row 1 = row
    mag2 with 0 marking invalid rows (real rows always have mag2 >= D > 0);
    row 2 = per-row ``rsqrt_spec(mag2)`` f32 bits; row 3 = padding."""
    mag2 = torch.where(index.valid, index.row_mag2, torch.zeros_like(index.row_mag2))
    rr = rsqrt_spec(mag2.to(torch.float32)).view(torch.int32)
    return torch.stack(
        [index.row_sum, mag2, rr, torch.zeros_like(mag2)], dim=0
    ).to(torch.int32).contiguous()


def _tile_dist(q_codes, q_sum, q_mag2, qr, data, meta):
    """Plain [Q, B] spec-v2 distances + [1, B] validity of a row block —
    op for op the kernels' ``spec_dist`` (and ``_kind_dist_tile``)."""
    dot8 = torch.matmul(
        q_codes.to(torch.float64), data.to(torch.float64).T
    ).to(torch.int32)                                   # exact: |dot| < 2^53
    d = data.shape[1]
    row_sum, row_mag2 = meta[0], meta[1]
    rr = meta[2].contiguous().view(torch.float32)
    dot_c = 4 * dot8 + 2 * (q_sum[:, None] + row_sum[None, :]) + d
    dot_f = dot_c.to(torch.float32)
    cos = dot_f * (qr[:, None] * rr[None, :])
    g = torch.maximum(cos, _f32(1e-6, cos))
    dist = torch.ones_like(g) / g - _f32(1.0, g)
    dist = torch.maximum(dist, _f32(0.0, dist))
    q_mag2_f = q_mag2.to(torch.float32)[:, None]
    row_mag2_f = row_mag2.to(torch.float32)[None, :]
    ident = (dot_f == q_mag2_f) & (q_mag2_f == row_mag2_f)
    dist = torch.where(ident, _f32(0.0, dist), dist)
    return dist, (row_mag2 > 0)[None, :]


# --------------------------------------------------------------------- #
# K1a: θ-filtered collect


def cosine_threshold_collect(q_codes, q_sum, q_mag2, qr, theta, data, meta, cap: int):
    """Append every valid row with ``dist < theta[q]`` to query q's buffer.

    Returns (count [Q] i32 — the EXACT number of passing rows, cand_d
    [Q, cap] f32, cand_i [Q, cap] i32).  Only the first ``min(count, cap)``
    slots of a row are meaningful; their order is unspecified on the card
    (atomic appends) and ascending row id in the plain version — consumers
    sort by (dist, id).

    Replaces ``pallas_scan.py:_threshold_kernel`` (select="buffer"
    semantics) for the θ stage and the main pass.  On the card it is bound
    by the int8 dot (D/4 ``__dp4a`` per query and row) and the divide;
    it writes only the θ-passing rows (~320 per query at the default
    target), so distances never reach device memory.
    """
    dev, qn, n, d = _check_query_args(q_codes, q_sum, q_mag2, qr, data, meta)
    _require(theta, "theta", torch.float32, (qn,), dev)
    if dev.type != "cuda":
        return cosine_threshold_collect_plain(
            q_codes, q_sum, q_mag2, qr, theta, data, meta, cap
        )
    if _COLLECT_Q * d > 48 * 1024:
        raise ValueError(f"dim {d} too wide for cosine_threshold_collect")
    k = load_kernels()
    count = torch.zeros(qn, dtype=torch.int32, device=dev)
    cand_d = torch.empty((qn, cap), dtype=torch.float32, device=dev)
    cand_i = torch.empty((qn, cap), dtype=torch.int32, device=dev)
    q_mag2f = q_mag2.to(torch.float32)
    with torch.cuda.device(dev):
        rc = k.lib.px_threshold_collect(
            _ptr(q_codes), _ptr(q_sum), _ptr(q_mag2f), _ptr(qr), _ptr(theta),
            _ptr(data), _ptr(meta), qn, n, d, cap,
            _ptr(count), _ptr(cand_d), _ptr(cand_i), _stream(dev),
        )
    _check(rc, "cosine_threshold_collect")
    LAUNCHES["cosine_threshold_collect"] += 1
    return count, cand_d, cand_i


def cosine_threshold_collect_plain(q_codes, q_sum, q_mag2, qr, theta, data, meta, cap):
    """Plain PyTorch version of K1a (collects in ascending row order)."""
    dev = data.device
    qn, n = q_codes.shape[0], data.shape[0]
    count = torch.zeros(qn, dtype=torch.int64, device=dev)
    cand_d = torch.full((qn, cap), float("inf"), dtype=torch.float32, device=dev)
    cand_i = torch.full((qn, cap), -1, dtype=torch.int32, device=dev)
    for start in range(0, n, _PLAIN_BLOCK):
        end = min(n, start + _PLAIN_BLOCK)
        dist, valid = _tile_dist(
            q_codes, q_sum, q_mag2, qr, data[start:end], meta[:, start:end]
        )
        mask = valid & (dist < theta[:, None])
        pos = torch.cumsum(mask, dim=1) - 1 + count[:, None]
        qi, ri = mask.nonzero(as_tuple=True)
        slot = pos[qi, ri]
        keep = slot < cap
        qi, ri, slot = qi[keep], ri[keep], slot[keep]
        cand_d[qi, slot] = dist[qi, ri]
        cand_i[qi, slot] = (ri + start).to(torch.int32)
        count += mask.sum(dim=1)
    return count.to(torch.int32), cand_d, cand_i


# --------------------------------------------------------------------- #
# K1b: per-chunk exact top-k (θ = max_distance)


def cosine_chunk_topk(q_codes, q_sum, q_mag2, qr, max_distance, data, meta, k: int):
    """Per row chunk of :data:`CHUNK_ROWS`, the exact top-k by (dist, id) of
    {valid rows with dist < max_distance}: ([Q, n_chunks, k] f32,
    [Q, n_chunks, k] i32), missing entries +inf / -1.

    Replaces ``pallas_scan.py:_threshold_kernel`` as launched by
    ``pallas_cosine_scan_topk`` (θ = max_distance).  Bound on the card by
    the dot and by the shared-memory bitonic sort of each 1024-row chunk
    (4 queries a block); the index is read once per 4 queries.
    """
    dev, qn, n, d = _check_query_args(q_codes, q_sum, q_mag2, qr, data, meta)
    md = float(np.float32(max_distance))
    if dev.type != "cuda":
        return cosine_chunk_topk_plain(q_codes, q_sum, q_mag2, qr, md, data, meta, k)
    if k > MAX_K:
        raise ValueError(f"k={k} exceeds the scan kernels' limit of {MAX_K}")
    kern = load_kernels()
    n_chunks = -(-n // CHUNK_ROWS)
    out_d = torch.empty((qn, n_chunks, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((qn, n_chunks, k), dtype=torch.int32, device=dev)
    q_mag2f = q_mag2.to(torch.float32)
    with torch.cuda.device(dev):
        rc = kern.lib.px_chunk_topk(
            _ptr(q_codes), _ptr(q_sum), _ptr(q_mag2f), _ptr(qr), md,
            _ptr(data), _ptr(meta), qn, n, d, CHUNK_ROWS, k, n_chunks,
            _ptr(out_d), _ptr(out_i), _stream(dev),
        )
    _check(rc, "cosine_chunk_topk")
    LAUNCHES["cosine_chunk_topk"] += 1
    return out_d, out_i


def cosine_chunk_topk_plain(q_codes, q_sum, q_mag2, qr, max_distance, data, meta, k):
    """Plain PyTorch version of K1b."""
    dev = data.device
    qn, n = q_codes.shape[0], data.shape[0]
    n_chunks = -(-n // CHUNK_ROWS)
    kk = min(k, CHUNK_ROWS)
    out_d = torch.full((qn, n_chunks, k), float("inf"), dtype=torch.float32, device=dev)
    out_i = torch.full((qn, n_chunks, k), -1, dtype=torch.int32, device=dev)
    md = _f32(max_distance, out_d)
    block = _PLAIN_BLOCK // CHUNK_ROWS * CHUNK_ROWS
    for start in range(0, n, block):
        end = min(n, start + block)
        dist, valid = _tile_dist(
            q_codes, q_sum, q_mag2, qr, data[start:end], meta[:, start:end]
        )
        dist = torch.where(valid & (dist < md), dist, torch.full_like(dist, float("inf")))
        nc = -(-(end - start) // CHUNK_ROWS)
        pad = nc * CHUNK_ROWS - (end - start)
        if pad:
            dist = torch.cat([dist, dist.new_full((qn, pad), float("inf"))], 1)
        # Positions ascend with row id inside a chunk: a stable sort by
        # dist is the (dist, id) order.
        d_s, order = torch.sort(dist.reshape(qn, nc, CHUNK_ROWS), dim=-1, stable=True)
        d_s, order = d_s[..., :kk], order[..., :kk]
        rows = order + (start + torch.arange(nc, device=dev) * CHUNK_ROWS)[None, :, None]
        c0 = start // CHUNK_ROWS
        out_d[:, c0 : c0 + nc, :kk] = d_s
        out_i[:, c0 : c0 + nc, :kk] = torch.where(
            torch.isfinite(d_s), rows, torch.full_like(rows, -1)
        ).to(torch.int32)
    return out_d, out_i


# --------------------------------------------------------------------- #
# K1c: segmented lexicographic top-k


def _keys(dist, idx, lens):
    """(dist, id) → int64 keys (dist >= 0: its f32 bits order like the
    value); empty entries (non-finite, id < 0, or at/after lens) → max."""
    valid = torch.isfinite(dist) & (idx >= 0)
    if lens is not None:
        pos = torch.arange(dist.shape[1], device=dist.device)
        valid &= pos[None, :] < lens[:, None]
    bits = dist.contiguous().view(torch.int32).to(torch.int64)
    key = (bits << 32) | idx.to(torch.int64)
    return torch.where(valid, key, torch.full_like(key, torch.iinfo(torch.int64).max))


def lex_topk_segments(dist, idx, k: int, lens=None, segment: int = SEGMENT):
    """Per (query, segment of ``segment`` candidates), the segment's first k
    by (dist, id): ([Q, n_seg, k] f32, [Q, n_seg, k] i32), empty entries
    +inf / -1.  ``lens[q]`` (optional) marks how many leading entries of
    query q's row are meaningful.

    Replaces the selection half of ``pallas_scan.py:_threshold_kernel``
    (its sorted carry insertion and the buffer wrapper's final top-k).
    Bound on the card by the shared-memory bitonic sort (S·log²S/4 compare-
    exchanges per segment); one block per (query, segment).
    """
    dev = dist.device
    qn, m = dist.shape
    _require(dist, "dist", torch.float32, (qn, m), dev)
    _require(idx, "idx", torch.int32, (qn, m), dev)
    if lens is not None:
        _require(lens, "lens", torch.int32, (qn,), dev)
    if dev.type != "cuda":
        return lex_topk_segments_plain(dist, idx, k, lens, segment)
    if k > segment // 2:
        raise ValueError(f"k={k} exceeds half the segment ({segment})")
    kern = load_kernels()
    n_seg = -(-m // segment)
    out_d = torch.empty((qn, n_seg, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((qn, n_seg, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = kern.lib.px_lex_topk_segments(
            _ptr(dist), _ptr(idx),
            ctypes.c_void_p(None if lens is None else lens.data_ptr()),
            qn, m, segment, k, n_seg, _ptr(out_d), _ptr(out_i), _stream(dev),
        )
    _check(rc, "lex_topk_segments")
    LAUNCHES["lex_topk_segments"] += 1
    return out_d, out_i


def lex_topk_segments_plain(dist, idx, k, lens=None, segment: int = SEGMENT):
    """Plain PyTorch version of K1c."""
    qn, m = dist.shape
    n_seg = -(-m // segment)
    key = _keys(dist, idx, lens)
    big = torch.iinfo(torch.int64).max
    pad = n_seg * segment - m
    if pad:
        key = torch.cat([key, key.new_full((qn, pad), big)], 1)
    key = torch.sort(key.reshape(qn, n_seg, segment), dim=-1).values[..., :k]
    empty = key == big
    d = (key >> 32).to(torch.int32).contiguous().view(torch.float32)
    i = (key & 0xFFFFFFFF).to(torch.int32)
    return (
        torch.where(empty, torch.full_like(d, float("inf")), d),
        torch.where(empty, torch.full_like(i, -1), i),
    )


def lex_topk(dist, idx, k: int, lens=None):
    """Exact top-k by (dist, id) of each query's candidates: K1c re-launched
    over its own output until one segment remains.  ([Q, k], [Q, k])."""
    qn = dist.shape[0]
    d, i = lex_topk_segments(dist, idx, k, lens)
    while d.shape[1] > 1:
        d, i = lex_topk_segments(d.reshape(qn, -1), i.reshape(qn, -1), k)
    return d[:, 0], i[:, 0]


# --------------------------------------------------------------------- #
# Query prep, θ estimate, and the two public scans


def _prep(query_u8: torch.Tensor):
    q_codes, q_sum, q_mag2 = query_moments_from_u8(query_u8)
    qr = rsqrt_spec(q_mag2.to(torch.float32))
    return q_codes.contiguous(), q_sum.contiguous(), q_mag2.contiguous(), qr


def sample_theta(q_codes, q_sum, q_mag2, qr, smp, max_distance, j: int):
    """Per-query j-th smallest sample distance — the θ estimate for the
    threshold scan — in the JAX package's two stages
    (``pallas_scan.py:_pallas_sample_theta``):

    1. θ0 from a 1/16 mini-subsample in plain torch (~4j mini rows' worth,
       floor 8);
    2. K1a + K1c over the FULL sample: the exact top-j of {dist < θ0}.

    ``smp`` is an ``ops.scan.ScanSample`` (contiguous ``data`` [S, D] and
    its [4, S] kernel ``meta``).

    If θ0 comes up short (fewer than j rows under it) or K1a's buffer
    overflowed, the value falls back to θ0 itself, exactly as the JAX
    package does; θ accuracy only shapes work, never the proof.  Returns
    [Q] f32; value == max_distance ⟺ θ is unbound.
    """
    s = smp.data.shape[0]
    dev = smp.data.device
    md = _f32(max_distance, smp.data)
    stride = 16
    while stride > 1 and (s // stride < 1024 or s % stride != 0):
        stride //= 2
    mini = smp.data[::stride].contiguous()
    mmeta = smp.meta[:, ::stride].contiguous()
    s0 = mini.shape[0]
    j0 = min(s0, max(8, -(-4 * j * s0 // s)))
    dist0, valid0 = _tile_dist(q_codes, q_sum, q_mag2, qr, mini, mmeta)
    dist0 = torch.where(valid0 & (dist0 < md), dist0, torch.full_like(dist0, float("inf")))
    t0, _ = topk_ops.block_topk(dist0, torch.zeros_like(dist0, dtype=torch.int32), j0)
    theta0 = torch.minimum(t0[:, j0 - 1], md).contiguous()

    cap = max(2048, topk_ops._next_pow2(16 * j))
    count, cand_d, cand_i = cosine_threshold_collect(
        q_codes, q_sum, q_mag2, qr, theta0, smp.data, smp.meta, cap
    )
    best_d, _ = lex_topk(cand_d, cand_i, j, lens=torch.clamp(count, max=cap))
    jth = best_d[:, j - 1]
    ok = torch.isfinite(jth) & (count <= cap)
    return torch.where(ok, jth, theta0).to(dev)


def _as_queries(query_u8, device) -> Tuple[torch.Tensor, bool]:
    """u8 queries [Q, D] (or [D], promoted) on ``device``; the flag says
    whether the caller should squeeze its results back to one query."""
    q = query_u8 if torch.is_tensor(query_u8) else torch.as_tensor(np.asarray(query_u8))
    q = q.to(device=device, dtype=torch.uint8)
    squeeze = q.ndim == 1
    return (q[None, :] if squeeze else q), squeeze


def fused_threshold_scan_topk(
    query_u8,
    index: PackedSemanticIndex,
    row_meta: torch.Tensor,
    smp,
    k: int = 100,
    max_distance: float = 1e3,
    target_count: Optional[int] = None,
    cap: Optional[int] = None,
):
    """Batched guaranteed-verifiable u8 cosine threshold scan — the port of
    ``pallas_threshold_scan_topk_v2`` (and of the buffer-select
    ``pallas_threshold_scan_topk``: one design serves every batch size).
    Returns (dist [Q,k], idx [Q,k], exact [Q]).

    ``exact[q]`` ⟺ the result provably equals the exact scan: K1a's count
    is exact, so ``count <= cap`` means every θ-passing row was collected,
    and then ``count >= k`` (the k-th smallest is < θ) or θ unbound (the
    collected set IS the WHERE-clause result) makes the collected top-k
    the true top-k.  Use via ``ops.scan.cosine_scan_topk_auto``, which
    repairs unproven queries.
    """
    q, squeeze = _as_queries(query_u8, index.device)
    n_pad = index.capacity
    q_codes, q_sum, q_mag2, qr = _prep(q)
    md = _f32(max_distance, q_codes)
    s = smp.data.shape[0]
    if target_count is None:
        target_count = max(16 * k // 5, 256)
    j = min(s, max(1, -(-target_count * s // n_pad)))
    theta_j = sample_theta(q_codes, q_sum, q_mag2, qr, smp, max_distance, j)
    theta = torch.minimum(theta_j, md).contiguous()
    unbound = ~(theta_j < md)
    if cap is None:
        cap = max(4096, topk_ops._next_pow2(8 * target_count))
    count, cand_d, cand_i = cosine_threshold_collect(
        q_codes, q_sum, q_mag2, qr, theta, index.data, row_meta, cap
    )
    best_d, best_i = lex_topk(cand_d, cand_i, k, lens=torch.clamp(count, max=cap))
    exact = (count <= cap) & ((count >= k) | unbound)
    if squeeze:
        return best_d[0], best_i[0], exact[0]
    return best_d, best_i, exact


def fused_cosine_scan_topk(
    query_u8,
    index: PackedSemanticIndex,
    row_meta: torch.Tensor,
    k: int = 100,
    max_distance: float = 1e3,
):
    """Sample-free fused exact scan — the port of ``pallas_cosine_scan_topk``
    (θ = max_distance for every query; K1b + K1c).  Unconditionally the
    exact top-k of ``WHERE dist < max_distance``: the auto path's repair
    and ``--scan-mode pallas``."""
    q, squeeze = _as_queries(query_u8, index.device)
    q_codes, q_sum, q_mag2, qr = _prep(q)
    part_d, part_i = cosine_chunk_topk(
        q_codes, q_sum, q_mag2, qr, max_distance, index.data, row_meta, k
    )
    qn = q.shape[0]
    best_d, best_i = lex_topk(part_d.reshape(qn, -1), part_i.reshape(qn, -1), k)
    if squeeze:
        return best_d[0], best_i[0]
    return best_d, best_i
