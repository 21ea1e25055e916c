"""Int4 (half-byte) semantic index — torch port of ``ops/int4.py``.

Two 4-bit codes a byte: a 1M×128 index takes 64 MiB on the card instead
of 128 MiB, doubling the rows a card holds.

Quantization: the u8 code v8 ∈ [0,255] maps to v4 = round(v8·15/255) ∈
[0,15], which dequantizes to the exact u8 grid value 17·v4.  Distances
reuse the exact-integer cosine spec over centered values 34·v4 − 255:

    Σ(34a−255)(34b−255) = 1156·Σab − 8670·(Σa + Σb) + 65025·D

— an int32 affine fix over the int8 code dot, with the same canonical f32
epilogue as the u8 path, so numpy oracle == plain PyTorch == the card's
kernels bit for bit.  The asymmetric metric (the default ``query_mode``)
keeps the query at u8 precision (centered 2q − 255) against the 4-bit
rows.  Either is a DIFFERENT (coarser) metric than the u8 index; the
exact-u8 rerank (:func:`scan_with_u8_rerank`) rescores the int4 scan's
top candidates from the store's u8 host mirror.

Packing layout: column-blocked, NOT interleaved — byte j of a row holds
dim j in its low nibble and dim j + D/2 in its high nibble (the JAX
package's layout, so both packages pack identical bytes).

The exact scans here are plain PyTorch (the JAX package ran them in XLA);
the guaranteed-exact :func:`cosine4_scan_topk_auto` runs the hand-written
kernels K4a/K4b + K1c (``ops/fused_scan.py``) on a CUDA index and their
plain versions on a CPU index.  The host-side packing, the numpy oracles
and the rerank are copies of the JAX package's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pixelbox_tpu_torch.ops import topk as topk_ops
from pixelbox_tpu_torch.ops.distances import _cosine_distance_from_moments, _f32
from pixelbox_tpu_torch.ops.fused_scan import (
    _as_queries,
    _dot8,
    affine4,
    build_row_meta,
    fused_cosine4_scan_topk,
    fused_threshold4_scan_topk,
    unpack_u4,
)
from pixelbox_tpu_torch.ops.oracle import _scan_topk_np, cosine_distance_np
from pixelbox_tpu_torch.ops.packed import query4_moments_from_u8, query_moments_from_u8
from pixelbox_tpu_torch.ops.scan import DEFAULT_BLOCK_ROWS, build_scan_sample, repair_unproven


class PackedSemantic4Index(NamedTuple):
    """Device tensors for the int4 semantic index."""

    data: torch.Tensor      # uint8 [N_pad, D/2], two 4-bit codes per byte
    row_sum: torch.Tensor   # int32 [N_pad]: Σ v4
    row_mag2: torch.Tensor  # int32 [N_pad]: Σ (34·v4 − 255)²
    valid: torch.Tensor     # bool [N_pad]

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    @property
    def dim(self) -> int:
        return 2 * self.data.shape[1]

    @property
    def device(self) -> torch.device:
        return self.data.device


# --------------------------------------------------------------------- #
# Host packing (numpy; copies of the JAX package's)


def quantize_u8_to_u4(v8: np.ndarray) -> np.ndarray:
    """u8 codes → 4-bit codes, round-half-up on the 15/255 rescale."""
    v8 = np.asarray(v8, dtype=np.uint16)
    return ((v8 * 15 + 127) // 255).astype(np.uint8)


def dequantize_u4_to_u8(v4: np.ndarray) -> np.ndarray:
    return (np.asarray(v4, dtype=np.uint16) * 17).astype(np.uint8)


def pack_u4_rows(v4: np.ndarray) -> np.ndarray:
    """4-bit codes [n, D] → packed bytes [n, D/2] (column-blocked)."""
    v4 = np.asarray(v4, dtype=np.uint8)
    n, d = v4.shape
    assert d % 2 == 0, d
    half = d // 2
    return (v4[:, :half] | (v4[:, half:] << 4)).astype(np.uint8)


def unpack_u4_rows_np(packed: np.ndarray) -> np.ndarray:
    p = np.asarray(packed, dtype=np.uint8)
    return np.concatenate([p & 0xF, p >> 4], axis=-1)


def semantic4_rows_from_u8(rows_u8: np.ndarray):
    """u8 rows [n, D] → (packed [n, D/2], row_sum [n], row_mag2 [n])."""
    v4 = quantize_u8_to_u4(rows_u8)
    packed = pack_u4_rows(v4)
    # int32 temporaries like the u8 twin (packed.py): |34v−255| ≤ 255, so
    # row_mag2 ≤ 65025·D fits int32 for any realistic D — int64 would
    # double host peak memory on every store realloc.
    v = v4.astype(np.int32)
    row_sum = np.sum(v, axis=-1, dtype=np.int32)
    c = 34 * v - 255
    row_mag2 = np.sum(c * c, axis=-1, dtype=np.int32)
    return packed, row_sum, row_mag2


def build_semantic4_index(
    rows_u8: np.ndarray, block_rows: int = DEFAULT_BLOCK_ROWS, device="cuda"
) -> PackedSemantic4Index:
    """Pack u8 rows into a padded int4 index on ``device``."""
    n, d = rows_u8.shape
    n_pad = -(-n // block_rows) * block_rows
    packed, row_sum, row_mag2 = semantic4_rows_from_u8(rows_u8)
    data = np.zeros((n_pad, d // 2), dtype=np.uint8)
    data[:n] = packed
    rs = np.zeros(n_pad, np.int32)
    rs[:n] = row_sum
    rm = np.zeros(n_pad, np.int32)
    rm[:n] = row_mag2
    valid = np.zeros(n_pad, bool)
    valid[:n] = True
    return PackedSemantic4Index(
        *(torch.from_numpy(x).to(device) for x in (data, rs, rm, valid))
    )


# --------------------------------------------------------------------- #
# Oracle (numpy, exact; copies of the JAX package's)


def cosine4_distance_np(a_u8: np.ndarray, b_u8: np.ndarray) -> np.ndarray:
    """Reciprocal cosine over the int4-quantized codes (canonical f32
    rounding spec, ops/distances.py)."""
    ca = 34 * quantize_u8_to_u4(a_u8).astype(np.int64) - 255
    cb = 34 * quantize_u8_to_u4(b_u8).astype(np.int64) - 255
    dot = np.sum(ca * cb, axis=-1)
    mag2_a = np.sum(ca * ca, axis=-1).astype(np.float32)
    mag2_b = np.sum(cb * cb, axis=-1).astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = (np.float32(1.0) / np.sqrt(mag2_a)) * (
            np.float32(1.0) / np.sqrt(mag2_b)
        )
        cos = dot.astype(np.float32) * inv
        dist = np.float32(1.0) / np.maximum(cos, np.float32(1e-6)) - np.float32(1.0)
    dist = np.maximum(dist, np.float32(0.0))
    dot_f = dot.astype(np.float32)
    ident = (dot_f == mag2_a) & (mag2_a == mag2_b)
    zero = (mag2_a == np.float32(0.0)) | (mag2_b == np.float32(0.0))
    return np.where(ident | zero, np.float32(0.0), dist).astype(np.float32)


def cosine4a_distance_np(a_u8: np.ndarray, b_u8: np.ndarray) -> np.ndarray:
    """ASYMMETRIC int4 distance: unquantized u8 query (centered 2q−255)
    vs int4-quantized rows (centered 34·v4 − 255).  Same canonical f32
    spec; far better retrieval vs the u8 ground truth than the symmetric
    metric because only ONE side pays quantization error (classic ADC —
    asymmetric distance computation — from the PQ literature)."""
    ca = 2 * np.asarray(a_u8, dtype=np.int64) - 255
    cb = 34 * quantize_u8_to_u4(b_u8).astype(np.int64) - 255
    dot = np.sum(ca * cb, axis=-1)
    mag2_a = np.sum(ca * ca, axis=-1).astype(np.float32)
    mag2_b = np.sum(cb * cb, axis=-1).astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = (np.float32(1.0) / np.sqrt(mag2_a)) * (
            np.float32(1.0) / np.sqrt(mag2_b)
        )
        cos = dot.astype(np.float32) * inv
        dist = np.float32(1.0) / np.maximum(cos, np.float32(1e-6)) - np.float32(1.0)
    dist = np.maximum(dist, np.float32(0.0))
    dot_f = dot.astype(np.float32)
    ident = (dot_f == mag2_a) & (mag2_a == mag2_b)
    zero = (mag2_a == np.float32(0.0)) | (mag2_b == np.float32(0.0))
    return np.where(ident | zero, np.float32(0.0), dist).astype(np.float32)


def cosine4a_scan_topk_np(query_u8, db_u8, k=100, max_distance=1e3):
    q = np.atleast_2d(np.asarray(query_u8, dtype=np.uint8))
    db = np.asarray(db_u8, dtype=np.uint8)
    n, dim = db.shape
    chunk = max(1, (1 << 27) // max(1, n * dim))
    dist = np.empty((q.shape[0], n), dtype=np.float32)
    for st in range(0, q.shape[0], chunk):
        e = min(st + chunk, q.shape[0])
        dist[st:e] = cosine4a_distance_np(q[st:e, None, :], db[None, :, :])
    return _scan_topk_np(dist, k, max_distance)


def cosine4_scan_topk_np(query_u8, db_u8, k=100, max_distance=1e3):
    """Oracle for :func:`cosine4_scan_topk`.  Memory-bounded like the u8
    oracle: the naive broadcast would materialize [Q, N, D] int64."""
    q = np.atleast_2d(np.asarray(query_u8, dtype=np.uint8))
    db = np.asarray(db_u8, dtype=np.uint8)
    n, dim = db.shape
    chunk = max(1, (1 << 27) // max(1, n * dim))
    dist = np.empty((q.shape[0], n), dtype=np.float32)
    for s in range(0, q.shape[0], chunk):
        e = min(s + chunk, q.shape[0])
        dist[s:e] = cosine4_distance_np(q[s:e, None, :], db[None, :, :])
    return _scan_topk_np(dist, k, max_distance)


# --------------------------------------------------------------------- #
# Plain blocked exact scans (PyTorch)


@torch.no_grad()
def _scan4(query_u8, index: PackedSemantic4Index, k, max_distance, block_rows, sym):
    q, squeeze = _as_queries(query_u8, index.device)
    qn, d = q.shape
    n_pad = index.capacity
    block_rows = min(block_rows, n_pad)
    assert n_pad % block_rows == 0, (n_pad, block_rows)
    assert index.dim == d, (index.dim, d)

    moments = query4_moments_from_u8 if sym else query_moments_from_u8
    q_i8, q_sum, q_mag2 = moments(q)
    q_mag2_f = q_mag2.to(torch.float32)[:, None]
    md = _f32(max_distance, q_i8)
    best_d, best_i = topk_ops.empty_topk((qn,), k, device=q.device)
    for base in range(0, n_pad, block_rows):
        sl = slice(base, base + block_rows)
        dot8 = _dot8(q_i8, unpack_u4(index.data[sl]))
        dot_c = affine4(dot8, q_sum, index.row_sum[sl], d, sym)
        dist = _cosine_distance_from_moments(
            dot_c.to(torch.float32), q_mag2_f, index.row_mag2[sl].to(torch.float32)[None, :]
        )
        keep = index.valid[sl][None, :] & (dist < md)
        dist = torch.where(keep, dist, torch.full_like(dist, float("inf")))
        idx = base + torch.arange(block_rows, dtype=torch.int32, device=q.device)
        cand_d, cand_i = topk_ops.block_topk(dist, idx.expand(qn, -1), k)
        best_d, best_i = topk_ops.merge_sorted_topk(best_d, best_i, cand_d, cand_i, k)
    best_d, best_i = topk_ops.finalize_topk(best_d, best_i)
    if squeeze:
        return best_d[0], best_i[0]
    return best_d, best_i


def cosine4a_scan_topk(
    query_u8,
    index: PackedSemantic4Index,
    k: int = 100,
    max_distance: float = 1e3,
    block_rows: int = DEFAULT_BLOCK_ROWS,
):
    """Exact blocked top-k with ASYMMETRIC distances (u8 query, int4
    rows); ``cosine4a_scan_topk_np`` is the oracle.  Returns (dist [Q, k]
    f32, idx [Q, k] int32), missing entries +inf / -1; ties by row id."""
    return _scan4(query_u8, index, k, max_distance, block_rows, sym=False)


def cosine4_scan_topk(
    query_u8,
    index: PackedSemantic4Index,
    k: int = 100,
    max_distance: float = 1e3,
    block_rows: int = DEFAULT_BLOCK_ROWS,
):
    """Exact blocked top-k over the int4 index with the u8 queries
    int4-quantized too (``cosine4_scan_topk_np`` is the oracle)."""
    return _scan4(query_u8, index, k, max_distance, block_rows, sym=True)


# --------------------------------------------------------------------- #
# Guaranteed-exact scan (the hand-written kernels; plain on a CPU index)


def build_semantic4_meta(index: PackedSemantic4Index) -> torch.Tensor:
    """[4, N] int32 meta for the int4 kernels — the same layout as the u8
    kernels' (row_sum; row_mag2 with 0 marking invalid; rsqrt bits)."""
    return build_row_meta(index)


def cosine4_scan_topk_auto(
    query_u8,
    index: PackedSemantic4Index,
    k: int = 100,
    max_distance: float = 1e3,
    block_rows: int = DEFAULT_BLOCK_ROWS,
    sample=None,
    meta=None,
    query_mode: str = "asym",
    epilogue: str = "dist",
):
    """Guaranteed-exact int4 scan: results always identical to
    :func:`cosine4a_scan_topk` (``query_mode="asym"``, the default — u8
    queries against the int4 rows) or :func:`cosine4_scan_topk` ("sym").

    Small indexes (capacity <= 4·block_rows, the JAX package's gate) take
    the fused exact scan (K4b + K1c).  Otherwise the fused threshold scan
    (K4a + K1c) runs and unproven queries are re-scanned by the fused
    exact scan in a small padded bucket.  Pass the cached ``sample``
    (``ops.scan.build_scan_sample`` of this index) and ``meta``
    (:func:`build_semantic4_meta`) to skip re-deriving them.  ``epilogue``
    picks the threshold pass's selection: "dist" (K4a) or "cos" (the cos
    key, K4d + K1e); the results are the same.
    """
    if query_mode not in ("asym", "sym"):
        raise ValueError(f"int4 query_mode must be 'asym' or 'sym', got {query_mode!r}")
    q, squeeze = _as_queries(query_u8, index.device)
    if meta is None:
        meta = build_semantic4_meta(index)

    def exact_scan(rq):
        return fused_cosine4_scan_topk(
            rq, index, meta, k=k, max_distance=max_distance, query_mode=query_mode
        )

    if index.capacity <= 4 * block_rows:
        best_d, best_i = exact_scan(q)
    else:
        if sample is None:
            sample = build_scan_sample(index)
        best_d, best_i, exact = fused_threshold4_scan_topk(
            q, index, meta, sample, k=k, max_distance=max_distance, query_mode=query_mode,
            epilogue=epilogue,
        )
        best_d, best_i = repair_unproven(q, best_d, best_i, exact, exact_scan)
    if squeeze:
        return best_d[0], best_i[0]
    return best_d, best_i


# --------------------------------------------------------------------- #
# Exact u8 rerank of int4 candidates (host numpy; copies of the JAX
# package's)
#
# The int4 device index trades precision for 2× row capacity, but the
# store's AUTHORITATIVE u8 rows never leave the host mirror.  Rescoring
# the scan's top-C candidates with the exact u8 metric therefore costs
# one small host GEMM — and it recovers the retrieval quality the 4-bit
# metric loses.  Returned distances are TRUE u8 reciprocal-cosine
# distances (canonical numpy spec, ops/oracle.cosine_distance_np), so
# results are directly comparable with int8-mode results,
# `max_distance_from_query` keeps its u8-metric meaning (strict
# `dist < max` in u8 space, engine.rs:375-383), and stored-hash
# self-matches score exactly 0 again.


#: "Unbounded" max_distance for the candidate-retrieval scan.  The
#: reciprocal-cosine distance tops out at 1/1e-6 − 1 < 1e6 (ops/distances,
#: engine.rs:582-587), so a strict `dist < 1e7` filter excludes nothing —
#: the real `max_distance_from_query` bound applies in u8 space after the
#: rescore.  (1e3, the engine's DEFAULT max distance, is NOT unbounded.)
UNBOUNDED_DISTANCE = 1e7


def default_rerank_candidates(k: int) -> int:
    """Candidate-list size for the u8 rerank: 4·k with a 400 floor.  Very
    large k caps the margin at +4096 extra candidates so kernel top-k
    lanes stay bounded."""
    k = int(k)
    return max(4 * k, 400) if k <= 1024 else k + 4096


def rerank_candidates_u8(
    query_u8: np.ndarray,
    cand_idx: np.ndarray,
    host_rows_u8: np.ndarray,
    k: int = 100,
    max_distance: float = 1e3,
    chunk_queries: int = 32,
):
    """Exact u8 rescoring of per-query candidate rows.

    Parameters
    ----------
    query_u8: [Q, D] (or [D]) u8 query codes.
    cand_idx: [Q, C] (or [C]) global row ids from an int4 scan; −1 marks
        empty slots (filtered out).
    host_rows_u8: [N, D] u8 — the store's host mirror
        (``VectorStore.get_rows`` backing array).
    k, max_distance: final ``WHERE dist < max … LIMIT k`` semantics,
        evaluated in the exact u8 metric.

    Returns (dist [Q, k] f32 inf-padded, idx [Q, k] int64 −1-padded),
    ordered exactly as the full u8 oracle orders the same rows:
    (dist, global row id) lexicographic ascending — so whenever the
    candidate set covers the true top-k, the output IS the exact u8
    top-k.
    """
    q = np.atleast_2d(np.asarray(query_u8, dtype=np.uint8))
    squeeze = np.asarray(cand_idx).ndim == 1
    ci = np.atleast_2d(np.asarray(cand_idx, dtype=np.int64))
    qn, c = ci.shape
    assert q.shape[0] == qn, (q.shape, ci.shape)
    rows = np.asarray(host_rows_u8, dtype=np.uint8)
    out_d = np.full((qn, k), np.inf, dtype=np.float32)
    out_i = np.full((qn, k), -1, dtype=np.int64)
    maxd = np.float32(max_distance)
    for s in range(0, qn, chunk_queries):
        e = min(s + chunk_queries, qn)
        idx_blk = ci[s:e]
        # −1 marks empty slots.  The length bound only guards the gather
        # against crashing; it is NOT a compaction-race guard — a
        # compact() renumbers surviving rows, so a stale in-range id
        # would rescore the wrong vector.  Callers must hold the index
        # read lock across scan + rerank (every engine path does).
        ok = (idx_blk >= 0) & (idx_blk < rows.shape[0])
        safe = np.where(ok, idx_blk, 0)
        gathered = rows[safe]                       # [B, C, D]
        dist = cosine_distance_np(q[s:e, None, :], gathered)
        dist = np.where(ok, dist, np.inf).astype(np.float32)
        for bi in range(e - s):
            d_row = dist[bi]
            keep = np.nonzero(d_row < maxd)[0]
            order = keep[np.lexsort((idx_blk[bi, keep], d_row[keep]))][:k]
            out_d[s + bi, : len(order)] = d_row[order]
            out_i[s + bi, : len(order)] = idx_blk[bi, order]
    if squeeze:
        return out_d[0], out_i[0]
    return out_d, out_i


def scan_with_u8_rerank(
    scan_fn,
    query_u8: np.ndarray,
    host_rows_u8: np.ndarray,
    k: int = 100,
    max_distance: float = 1e3,
    n_real: int | None = None,
):
    """Candidates-then-rerank orchestration, in ONE place.

    The engine's ``int4_rerank`` contract: retrieve ``C =
    default_rerank_candidates(k)`` candidates in the int4 metric
    UNBOUNDED (the ``WHERE dist < max`` filter applies in the exact u8
    metric after rescoring), then rescore them against the store's u8
    host mirror with the real ``(k, max_distance)``.

    ``scan_fn(candidates, unbounded_distance) -> (dist, idx)`` (host
    arrays) wraps whichever int4 scan the caller uses.  Callers must hold
    the index read lock across scan + rerank: a compaction between them
    renumbers rows, and a renumbered id that is still in range would
    silently rescore the wrong row.

    ``n_real``: for batched callers that zero-pad queries up to a bucket,
    the padded scan still runs on the full batch, but only the first
    ``n_real`` rows are rescored on the host (and only those rows are
    returned).
    """
    c = default_rerank_candidates(k)
    _dist, idx = scan_fn(c, UNBOUNDED_DISTANCE)
    idx = np.asarray(idx)
    q = np.asarray(query_u8, dtype=np.uint8)
    if n_real is not None:
        idx = idx[:n_real]
        q = q[:n_real]
    return rerank_candidates_u8(
        q, idx, host_rows_u8,
        k=k, max_distance=max_distance,
    )
