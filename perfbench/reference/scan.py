"""The plain reference: exact top-k and duplicate pairs over u8 rows.

Plain PyTorch, from the distance spec (ARCHITECTURE.md §1) and the
reference's query semantics (``WHERE dist < max_distance ORDER BY dist
LIMIT k``, ties by ascending row id).  It imports nothing of the program
and takes nothing the program made: only the rows and queries the
benchmark generated.

Every f32 operation of the spec is computed in f64 and rounded once to
f32.  For +, -, *, / and sqrt of f32 operands that gives the correctly
rounded f32 result (f64 carries more than 2·24 + 2 bits), so the values do
not depend on how the card rounds f32 division.  Dot products of the
centred rows are integers below 2**24, exact in f64.
"""

from __future__ import annotations

import torch

#: Blocks that bound the [queries, rows] temporaries.
QUERY_BLOCK = 512
ROW_BLOCK = 1 << 17
_NONE = torch.iinfo(torch.int64).max


def _f32(x: torch.Tensor) -> torch.Tensor:
    """Round to f32, then hold it in f64 for the next exact step."""
    return x.to(torch.float32).to(torch.float64)


def _rsqrt_spec(m2: torch.Tensor) -> torch.Tensor:
    """fl32(1 / fl32(sqrt(m2))) of exact integer moments, in f64."""
    return _f32(1.0 / _f32(torch.sqrt(m2)))


class CosineRows:
    """Reciprocal-cosine distances against u8 rows [N, D] (spec v2)."""

    def __init__(self, rows_u8: torch.Tensor):
        self.c = 2.0 * rows_u8.to(torch.float64) - 255.0
        self.m2 = (self.c * self.c).sum(dim=1)   # exact integers
        self.r = _rsqrt_spec(self.m2)

    @property
    def n(self) -> int:
        return self.c.shape[0]

    def distances(self, q_u8: torch.Tensor, start: int, end: int) -> torch.Tensor:
        """f32 distances [Q, end - start] of the queries to rows start:end."""
        qc = 2.0 * q_u8.to(self.c.device, torch.float64) - 255.0
        qm2 = (qc * qc).sum(dim=1)[:, None]
        dot = qc @ self.c[start:end].T
        m2 = self.m2[None, start:end]
        inv = _f32(_rsqrt_spec(qm2) * self.r[None, start:end])
        cos = _f32(dot * inv)
        g = torch.clamp(cos, min=float(torch.tensor(1e-6, dtype=torch.float32)))
        dist = torch.clamp(_f32(_f32(1.0 / g) - 1.0), min=0.0)
        pinned = ((dot == qm2) & (qm2 == m2)) | (qm2 == 0) | (m2 == 0)
        return torch.where(pinned, torch.zeros_like(dist), dist).to(torch.float32)


class HammingRows:
    """Normalized Hamming distances against u8 hashes [N, H]: set bits of
    the XOR times fl32(1 / (8·H))."""

    def __init__(self, rows_u8: torch.Tensor, byte_limit: int | None = None):
        h = rows_u8.shape[1] if byte_limit is None else int(byte_limit)
        self.h = h
        self.bits = _pm1(rows_u8[:, :h])
        self.scale = float(torch.tensor(1.0 / (8.0 * h), dtype=torch.float32))

    @property
    def n(self) -> int:
        return self.bits.shape[0]

    def distances(self, q_u8: torch.Tensor, start: int, end: int) -> torch.Tensor:
        qb = _pm1(q_u8[:, : self.h].to(self.bits.device))
        # ±1 products: agreeing bits add 1, differing bits subtract 1.
        agree = qb @ self.bits[start:end].T
        differ = (8 * self.h - agree) / 2.0
        return _f32(differ * self.scale).to(torch.float32)


def _pm1(rows_u8: torch.Tensor) -> torch.Tensor:
    """u8 [N, H] → f64 [N, 8H] of ±1 per bit."""
    shifts = torch.arange(8, device=rows_u8.device, dtype=torch.uint8)
    bits = torch.bitwise_and(torch.bitwise_right_shift(rows_u8[..., None], shifts), 1)
    return bits.reshape(rows_u8.shape[0], -1).to(torch.float64) * 2.0 - 1.0


def _keys(dist: torch.Tensor, start: int, max_distance: float) -> torch.Tensor:
    """(dist, row id) as one int64 key that sorts as the pair does; rows
    at or past the cut get the largest key."""
    ids = torch.arange(start, start + dist.shape[1], device=dist.device, dtype=torch.int64)
    key = torch.bitwise_left_shift(dist.view(torch.int32).to(torch.int64), 32) | ids[None, :]
    keep = dist < torch.tensor(max_distance, dtype=torch.float32, device=dist.device)
    return torch.where(keep, key, torch.full_like(key, _NONE))


def topk(rows, queries_u8: torch.Tensor, k: int, max_distance: float):
    """Exact top-k of each query: (dist f32 [Q, k], row id int64 [Q, k]),
    missing entries +inf and -1."""
    out_d, out_i = [], []
    for qs in range(0, queries_u8.shape[0], QUERY_BLOCK):
        q = queries_u8[qs : qs + QUERY_BLOCK]
        best = None
        for start in range(0, rows.n, ROW_BLOCK):
            end = min(rows.n, start + ROW_BLOCK)
            key = _keys(rows.distances(q, start, end), start, max_distance)
            if best is not None:
                key = torch.cat([best, key], dim=1)
            best = torch.topk(key, min(k, key.shape[1]), dim=1, largest=False).values
        if best.shape[1] < k:
            pad = torch.full((best.shape[0], k - best.shape[1]), _NONE, device=best.device)
            best = torch.cat([best, pad], dim=1)
        best = torch.sort(best, dim=1).values
        hit = best != _NONE
        dist = torch.bitwise_right_shift(best, 32).to(torch.int32).view(torch.float32)
        out_d.append(torch.where(hit, dist, torch.full_like(dist, float("inf"))).cpu())
        out_i.append(torch.where(hit, best & 0xFFFFFFFF, torch.full_like(best, -1)).cpu())
    return torch.cat(out_d), torch.cat(out_i)


def duplicate_pairs(rows, rows_u8: torch.Tensor, query_rows, k: int, max_distance: float,
                    image_id=lambda r: r):
    """The duplicate pairs that the given rows take part in through their
    own top-k: {(id_a, id_b): dist} with id_a < id_b, the self-match left
    out.  A pass's whole pair list is the union of this over every row."""
    query_rows = torch.as_tensor(query_rows, dtype=torch.int64)
    dist, idx = topk(rows, rows_u8[query_rows], k, max_distance)
    pairs = {}
    for a, ds, rs in zip(query_rows.tolist(), dist.tolist(), idx.tolist()):
        for d, b in zip(ds, rs):
            if b < 0 or b == a:
                continue
            ia, ib = image_id(a), image_id(b)
            pairs[(min(ia, ib), max(ia, ib))] = d
    return pairs
