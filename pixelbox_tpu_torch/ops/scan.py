"""Blockwise brute-force similarity scans with streaming top-k (torch port
of ``ops/scan.py``).

The exact scan runs in plain PyTorch (the JAX package ran it in XLA)::

    for each row block B of the packed index:
        int8 dot    dot8[Q, B] = q_i8 @ block_i8^T   (exact: f64 matmul)
        affine fix  dot_c = 4*dot8 + 2*(q_sum + row_sum) + D
        epilogue    dist = 1/max(cos, 1e-6) - 1       (f32, spec v2)
        merge       running top-k over blocks         (bitonic, (dist, id))

``cosine_scan_topk_auto`` is the guaranteed-exact fast path: the fused
threshold scan (``ops/fused_scan.py``; hand-written kernels on a CUDA
index, their plain versions on a CPU index) plus an exact repair of the
queries it could not prove.  ``hamming_scan_topk`` is the plain exact
phash scan; its guaranteed-exact fast path is
``ops.hamming_gemm.hamming_gemm_scan_topk_auto``.

Result semantics replicate ``WHERE dist < max_distance ORDER BY dist ASC
LIMIT k`` (engine.rs:375-383): entries with dist >= max_distance are
excluded; missing entries have idx == -1 and dist == +inf.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import torch

from pixelbox_tpu_torch.ops import topk as topk_ops
from pixelbox_tpu_torch.ops.distances import _cosine_distance_from_moments, _f32
from pixelbox_tpu_torch.ops.fused_scan import (
    _as_queries,
    _hamming_tile_dist,
    build_row_meta,
    fused_cosine_scan_topk,
    fused_threshold_scan_topk,
)
from pixelbox_tpu_torch.ops.packed import (
    PackedHammingIndex,
    PackedSemanticIndex,
    query_moments_from_u8,
)
from pixelbox_tpu_torch.utils.timing import bump, span

DEFAULT_BLOCK_ROWS = 32768


def _cosine_block_dist(q_i8, q_sum, q_mag2_f, blk, blk_sum, blk_mag2, blk_valid,
                       max_distance, d):
    """Distances of one row block: exact int8 dot + spec epilogue +
    filtering.  Returns [Q, B] f32 with +inf marking invalid/over-threshold
    rows."""
    dot8 = torch.matmul(q_i8.to(torch.float64), blk.to(torch.float64).T).to(torch.int32)
    dot_c = 4 * dot8 + 2 * (q_sum[:, None] + blk_sum[None, :]) + d
    dist = _cosine_distance_from_moments(
        dot_c.to(torch.float32), q_mag2_f, blk_mag2.to(torch.float32)[None, :]
    )
    keep = blk_valid[None, :] & (dist < max_distance)
    return torch.where(keep, dist, torch.full_like(dist, float("inf")))


@torch.no_grad()
def cosine_scan_topk(
    query_u8,
    index: PackedSemanticIndex,
    k: int = 100,
    max_distance: float = 1e3,
    block_rows: int = DEFAULT_BLOCK_ROWS,
):
    """Top-k smallest reciprocal-cosine distances of queries against the index.

    query_u8: uint8 [Q, D] (or [D], auto-promoted).
    Returns (dist [Q, k] f32, idx [Q, k] int32); idx == -1 marks entries
    excluded by ``dist < max_distance`` or an index smaller than k.
    Bit-exact reference parity; ties by ascending row id.
    """
    q, squeeze = _as_queries(query_u8, index.device)
    qn, d = q.shape
    n_pad = index.capacity
    block_rows = min(block_rows, n_pad)
    assert n_pad % block_rows == 0, (n_pad, block_rows)

    q_i8, q_sum, q_mag2 = query_moments_from_u8(q)
    q_mag2_f = q_mag2.to(torch.float32)[:, None]
    md = _f32(max_distance, q_i8)
    best_d, best_i = topk_ops.empty_topk((qn,), k, device=q.device)
    for base in range(0, n_pad, block_rows):
        sl = slice(base, base + block_rows)
        dist = _cosine_block_dist(
            q_i8, q_sum, q_mag2_f, index.data[sl], index.row_sum[sl],
            index.row_mag2[sl], index.valid[sl], md, d,
        )
        idx = base + torch.arange(block_rows, dtype=torch.int32, device=q.device)
        cand_d, cand_i = topk_ops.block_topk(dist, idx.expand(qn, -1), k)
        best_d, best_i = topk_ops.merge_sorted_topk(best_d, best_i, cand_d, cand_i, k)
    best_d, best_i = topk_ops.finalize_topk(best_d, best_i)
    if squeeze:
        return best_d[0], best_i[0]
    return best_d, best_i


class ScanSample(NamedTuple):
    """Strided row subsample of a packed index (θ estimation): a
    contiguous copy of its rows (the kernels read them densely) and their
    kernel meta — for a PackedSemanticIndex or an ops.int4
    PackedSemantic4Index (rows stay packed) the [4, S] int32 layout of
    fused_scan.build_row_meta (row sums, and mag2 = 0 for invalid rows);
    for a PackedHammingIndex the uint8 [S] row mask of
    fused_scan.build_hamming_meta."""

    data: torch.Tensor      # int8 [S, D] | uint8 [S, D/2] | uint8 [S, H]
    meta: torch.Tensor      # int32 [4, S] | uint8 [S]


def build_scan_sample(index, sample_rows: Optional[int] = None) -> ScanSample:
    """Derive the strided sample (cache it alongside the index; engines
    key it on the store's mutation counter).  ``sample_rows`` defaults to
    65536 (PIXELBOX_SCAN_SAMPLE_ROWS overrides); θ only gates candidate
    selection, never the proof, so the size trades work, not exactness."""
    if sample_rows is None:
        sample_rows = int(os.environ.get("PIXELBOX_SCAN_SAMPLE_ROWS", "65536"))
    cap = index.capacity
    stride = 1
    while stride * 2 <= max(1, cap // sample_rows) and cap % (stride * 2) == 0:
        stride *= 2
    sub = type(index)(*(x[::stride].contiguous() for x in index))
    return ScanSample(sub.data, build_row_meta(sub))


def repair_unproven(q, best_d, best_i, exact, exact_scan):
    """Splice exact re-scans over queries whose threshold results weren't
    proven.  ``exact_scan(q_bucket) -> (d, i)`` runs the exact path on a
    zero-padded query bucket (bucket sizes 8·4^n, as in the JAX package).
    The proof's read (span ``scan.proof``) and the rows of the unproven
    queries (``scan.unproven``) are host syncs; the re-scan is the span
    ``scan.repair``."""
    with span("scan.proof", wait=True) as w:
        w.syncs += exact.is_cuda
        proven = bool(exact.all())
    if proven:
        return best_d, best_i
    with span("scan.repair"):
        best_d = best_d.clone()
        best_i = best_i.clone()
        with span("scan.unproven", wait=True) as w:
            w.syncs += exact.is_cuda
            bad = torch.nonzero(~exact).flatten()
        nb = int(bad.numel())
        bump("repaired_queries", nb)
        bucket = 8
        while bucket < nb:
            bucket *= 4
        repair = torch.zeros((bucket, q.shape[1]), dtype=torch.uint8, device=q.device)
        repair[:nb] = q[bad]
        rd, ri = exact_scan(repair)
        best_d[bad] = rd[:nb]
        best_i[bad] = ri[:nb]
        return best_d, best_i


def to_host(*tensors) -> tuple:
    """A scan's results as numpy arrays (span ``scan.download``), each
    tensor on a card one count of ``host_syncs``: a copy the host waits
    for."""
    with span("scan.download", wait=True) as w:
        for t in tensors:
            w.syncs += t.is_cuda
        return tuple(t.cpu().numpy() for t in tensors)


def cosine_scan_topk_auto(
    query_u8,
    index: PackedSemanticIndex,
    k: int = 100,
    max_distance: float = 1e3,
    block_rows: int = DEFAULT_BLOCK_ROWS,
    sample: Optional[ScanSample] = None,
    row_meta: Optional[torch.Tensor] = None,
    epilogue: str = "dist",
):
    """Guaranteed-exact scan (host-level repair); results always identical
    to :func:`cosine_scan_topk`.

    Small indexes (capacity <= 4·block_rows — the JAX package's own gate)
    take the fused exact scan (K1b + K1c).  Otherwise the fused threshold
    scan runs and unproven
    queries (rare — unlucky sampling, tie floods) are re-scanned by the
    fused exact scan in a small padded bucket and spliced back.  On a
    CUDA index both go through the hand-written kernels; on a CPU index
    through their plain versions.  Pass the cached ``sample``
    (build_scan_sample) and ``row_meta`` (fused_scan.build_row_meta) to
    skip re-deriving them.  ``epilogue`` picks the threshold pass's
    selection: "dist" (K1a) or "cos" (the cos key, K1d + K1e); the
    results are the same.
    """
    q, squeeze = _as_queries(query_u8, index.device)
    if row_meta is None:
        row_meta = build_row_meta(index)
    if index.capacity <= 4 * block_rows:
        best_d, best_i = fused_cosine_scan_topk(
            q, index, row_meta, k=k, max_distance=max_distance
        )
    else:
        if sample is None:
            sample = build_scan_sample(index)
        best_d, best_i, exact = fused_threshold_scan_topk(
            q, index, row_meta, sample, k=k, max_distance=max_distance, epilogue=epilogue
        )

        def exact_rescan(rq):
            return fused_cosine_scan_topk(
                rq, index, row_meta, k=k, max_distance=max_distance
            )

        best_d, best_i = repair_unproven(q, best_d, best_i, exact, exact_rescan)
    if squeeze:
        return best_d[0], best_i[0]
    return best_d, best_i


@torch.no_grad()
def hamming_scan_topk(
    query_u8,
    index: PackedHammingIndex,
    k: int = 100,
    max_distance: float = 1e3,
    block_rows: int = DEFAULT_BLOCK_ROWS,
    wrap_u8: bool = False,
    byte_limit: Optional[int] = None,
):
    """Top-k smallest normalized Hamming distances (phash search), the
    plain blocked exact scan.

    Same result semantics as :func:`cosine_scan_topk`.  ``wrap_u8``
    replicates the reference's u8 popcount-accumulator overflow
    (engine.rs:603).  ``byte_limit`` compares only the first
    ``byte_limit`` bytes and normalizes by 8×byte_limit — the device half
    of the reference's zip-truncate semantics for unequal-width hashes
    (engine.rs:594-604).  Query width must equal the index width.
    """
    q, squeeze = _as_queries(query_u8, index.device)
    qn, h = q.shape
    assert h == index.dim, (h, index.dim)
    n_pad = index.capacity
    block_rows = min(block_rows, n_pad)
    assert n_pad % block_rows == 0, (n_pad, block_rows)
    eff = h if byte_limit is None else int(byte_limit)
    assert 0 < eff <= h, (eff, h)

    md = _f32(max_distance, q)
    best_d, best_i = topk_ops.empty_topk((qn,), k, device=q.device)
    for base in range(0, n_pad, block_rows):
        sl = slice(base, base + block_rows)
        dist, valid = _hamming_tile_dist(q, index.data[sl], index.valid[sl], eff, wrap_u8)
        dist = torch.where(valid & (dist < md), dist, torch.full_like(dist, float("inf")))
        idx = base + torch.arange(block_rows, dtype=torch.int32, device=q.device)
        cand_d, cand_i = topk_ops.block_topk(dist, idx.expand(qn, -1), k)
        best_d, best_i = topk_ops.merge_sorted_topk(best_d, best_i, cand_d, cand_i, k)
    best_d, best_i = topk_ops.finalize_topk(best_d, best_i)
    if squeeze:
        return best_d[0], best_i[0]
    return best_d, best_i
