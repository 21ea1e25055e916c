"""Streaming top-k primitives for blockwise index scans (torch port of
``ops/topk.py``).

The reference's query is ``WHERE dist < max ORDER BY dist ASC LIMIT k``
(src/engine.rs:375-383).  Ties prefer the earlier (smaller) row index,
matching SQLite's rowid scan order for equal distances.

``torch.topk`` does not promise an order among ties (``lax.top_k`` is
positionally stable), so selection here is a STABLE sort by distance —
ties keep their input positions, which ascend with row id.  Pools whose
layout does not follow row ids are sorted on a (dist, id) key by the
scan kernels' K1c (``ops/fused_scan.lex_topk``).
"""

from __future__ import annotations

import torch

_IDX_SENTINEL = 2 ** 31 - 1


def block_topk(dist: torch.Tensor, idx: torch.Tensor, k: int):
    """Top-k smallest distances within one block, ties by position.

    dist, idx: [..., B] → ([..., k], [..., k]).  If B < k, pads with +inf/-1.
    """
    b = dist.shape[-1]
    if b < k:
        pad = k - b
        dist = torch.cat(
            [dist, dist.new_full(dist.shape[:-1] + (pad,), float("inf"))], -1
        )
        idx = torch.cat([idx, idx.new_full(idx.shape[:-1] + (pad,), -1)], -1)
    d_s, order = torch.sort(dist, dim=-1, stable=True)
    return d_s[..., :k], torch.gather(idx, -1, order[..., :k])


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def merge_sorted_topk(dist_a, idx_a, dist_b, idx_b, k: int):
    """Merge two ASCENDING-sorted candidate lists into the k smallest.

    Bitonic merge with a lexicographic (dist, idx) exchange predicate, so
    ties order by ascending idx exactly like the oracle.  Inputs [..., k]
    must each be sorted ascending by (dist, idx); output is fully sorted.
    """
    kp = _next_pow2(k)
    if kp != k:
        shape = dist_a.shape[:-1] + (kp - k,)
        pad_d = dist_a.new_full(shape, float("inf"))
        pad_i = idx_a.new_full(shape, _IDX_SENTINEL)
        dist_a = torch.cat([dist_a, pad_d], -1)
        dist_b = torch.cat([dist_b, pad_d], -1)
        idx_a = torch.cat([idx_a, pad_i], -1)
        idx_b = torch.cat([idx_b, pad_i], -1)
    # concat(A asc, reverse(B asc)) is bitonic; merging sorts it.
    d = torch.cat([dist_a, torch.flip(dist_b, [-1])], -1)
    i = torch.cat([idx_a, torch.flip(idx_b, [-1])], -1)
    n = 2 * kp
    batch = d.shape[:-1]
    stride = kp
    while stride >= 1:
        dr = d.reshape(*batch, n // (2 * stride), 2, stride)
        ir = i.reshape(*batch, n // (2 * stride), 2, stride)
        d_lo, d_hi = dr[..., 0, :], dr[..., 1, :]
        i_lo, i_hi = ir[..., 0, :], ir[..., 1, :]
        swap = (d_hi < d_lo) | ((d_hi == d_lo) & (i_hi < i_lo))
        new_lo_d = torch.where(swap, d_hi, d_lo)
        new_hi_d = torch.where(swap, d_lo, d_hi)
        new_lo_i = torch.where(swap, i_hi, i_lo)
        new_hi_i = torch.where(swap, i_lo, i_hi)
        d = torch.stack([new_lo_d, new_hi_d], dim=-2).reshape(*batch, n)
        i = torch.stack([new_lo_i, new_hi_i], dim=-2).reshape(*batch, n)
        stride //= 2
    return d[..., :k], i[..., :k]


def tree_merge_sorted(bd: torch.Tensor, bi: torch.Tensor, k: int):
    """Fold [..., S, k] per-segment (dist, idx)-ascending candidate lists
    into the global top-k with log2(S) pairwise bitonic merges (all
    segment pairs of a level at once).  Exactly the top-k of the union:
    each segment contributes at most k survivors.  The plain selection of
    the CPU route (the JAX ``ops/topk.py`` function of the same name)."""
    batch = bd.shape[:-2]
    nseg = bd.shape[-2]
    while nseg > 1:
        if nseg % 2:
            shape = batch + (1, k)
            bd = torch.cat([bd, bd.new_full(shape, float("inf"))], -2)
            bi = torch.cat([bi, bi.new_full(shape, _IDX_SENTINEL)], -2)
            nseg += 1
        d2 = bd.reshape(*batch, nseg // 2, 2, k)
        i2 = bi.reshape(*batch, nseg // 2, 2, k)
        bd, bi = merge_sorted_topk(d2[..., 0, :], i2[..., 0, :], d2[..., 1, :], i2[..., 1, :], k)
        nseg //= 2
    return bd.reshape(*batch, k), bi.reshape(*batch, k)


def empty_topk(batch_shape, k: int, device=None):
    """An empty carry: all +inf distances, -1 indices."""
    shape = tuple(batch_shape) + (k,)
    d = torch.full(shape, float("inf"), dtype=torch.float32, device=device)
    i = torch.full(shape, -1, dtype=torch.int32, device=device)
    return d, i


def finalize_topk(dist: torch.Tensor, idx: torch.Tensor):
    """Replace +inf sentinel entries (below-threshold / padding) with idx=-1."""
    keep = torch.isfinite(dist)
    return (
        torch.where(keep, dist, torch.full_like(dist, float("inf"))),
        torch.where(keep, idx, torch.full_like(idx, -1)),
    )
