"""CPU (numpy) oracle replicating the reference scan exactly.

This is the ground truth the TPU scans are tested against — the moral
equivalent of the reference's SQLite scan (src/engine.rs:375-383): per-row
distance, strict ``dist < max_distance`` filter, ascending sort with ties
broken by row order (SQLite's rowid scan order), LIMIT k.

Distances use the same exact-integer formulation as ``ops.distances`` (int64
accumulation, f32 finals), so oracle and device agree bit-for-bit on f32
distance values.
"""

from __future__ import annotations

import numpy as np


def cosine_distance_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Reciprocal cosine distance over u8 vectors; broadcasts; f32 output."""
    ca = 2 * np.asarray(a, dtype=np.int64) - 255
    cb = 2 * np.asarray(b, dtype=np.int64) - 255
    dot = np.sum(ca * cb, axis=-1)
    mag2_a = np.sum(ca * ca, axis=-1).astype(np.float32)
    mag2_b = np.sum(cb * cb, axis=-1).astype(np.float32)
    # Canonical rounding spec v2 (separable magnitudes) — see
    # ops.distances._cosine_distance_from_moments.  numpy's f32 sqrt and
    # division are correctly rounded, matching XLA:CPU with fast-math off.
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = (np.float32(1.0) / np.sqrt(mag2_a)) * (
            np.float32(1.0) / np.sqrt(mag2_b)
        )
        cos = dot.astype(np.float32) * inv
        dist = np.float32(1.0) / np.maximum(cos, np.float32(1e-6)) - np.float32(1.0)
    # Spec rounding guards: clamp the cos>1 rounding noise, pin identical
    # vectors (dot == m2a == m2b on the f32 moment copies) to exactly 0.
    dist = np.maximum(dist, np.float32(0.0))
    dot_f = dot.astype(np.float32)
    ident = (dot_f == mag2_a) & (mag2_a == mag2_b)
    # Integer moments: the reference's mag < 1e-6 guard fires exactly when
    # the magnitude product is zero (engine.rs:582-584).
    zero = (mag2_a == np.float32(0.0)) | (mag2_b == np.float32(0.0))
    return np.where(ident | zero, np.float32(0.0), dist).astype(np.float32)


def byte_distance_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    d = np.asarray(a).shape[-1]
    l1 = np.sum(
        np.abs(np.asarray(a, dtype=np.int64) - np.asarray(b, dtype=np.int64)), axis=-1
    )
    return (l1.astype(np.float32) * np.float32(1.0 / (255.0 * d))).astype(np.float32)


def hamming_distance_np(
    a: np.ndarray, b: np.ndarray, *, wrap_u8: bool = False
) -> np.ndarray:
    h = np.asarray(a).shape[-1]
    x = np.bitwise_xor(np.asarray(a, dtype=np.uint8), np.asarray(b, dtype=np.uint8))
    bits = np.sum(np.unpackbits(x, axis=-1), axis=-1).astype(np.int64)
    if wrap_u8:
        bits = bits % 256
    return (bits.astype(np.float32) * np.float32(1.0 / (8.0 * h))).astype(np.float32)


def hamming_distance_zip_np(a, b, *, wrap_u8: bool = False) -> np.float32:
    """Pairwise Hamming over possibly UNEQUAL-width hashes, reference
    semantics (engine.rs:594-604): ``zip`` truncates to the shorter hash
    and the divisor is 8×that length.  Zero-length pairs divide 0/0 → NaN,
    exactly like the Rust f32 division (NaN fails every ``dist < max``).
    """
    a = np.frombuffer(bytes(a), dtype=np.uint8) if isinstance(a, (bytes, bytearray)) else np.asarray(a, dtype=np.uint8)
    b = np.frombuffer(bytes(b), dtype=np.uint8) if isinstance(b, (bytes, bytearray)) else np.asarray(b, dtype=np.uint8)
    m = min(a.shape[-1], b.shape[-1])
    bits = np.int64(
        np.sum(np.unpackbits(np.bitwise_xor(a[:m], b[:m])))
    )
    if wrap_u8:
        bits = bits % 256
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.float32(np.float32(bits) * (np.float32(1.0) / np.float32(8.0 * m)))


def _scan_topk_np(dist: np.ndarray, k: int, max_distance: float):
    """Shared filter/sort/limit: dist [Q, N] → (dist [Q,k], idx [Q,k])."""
    qn, n = dist.shape
    out_d = np.full((qn, k), np.inf, dtype=np.float32)
    out_i = np.full((qn, k), -1, dtype=np.int32)
    for qi in range(qn):
        keep = np.nonzero(dist[qi] < np.float32(max_distance))[0]
        # Stable sort by distance → ties broken by ascending row index.
        order = keep[np.argsort(dist[qi, keep], kind="stable")][:k]
        out_d[qi, : len(order)] = dist[qi, order]
        out_i[qi, : len(order)] = order
    return out_d, out_i


def cosine_scan_topk_np(
    query_u8: np.ndarray, db_u8: np.ndarray, k: int = 100, max_distance: float = 1e3
):
    """Oracle for ``ops.scan.cosine_scan_topk`` over raw u8 db rows [N, D].

    Memory-bounded: computes the [Q, N] distance matrix in query chunks
    (the naive broadcast materializes Q×N×D int64).
    """
    q = np.atleast_2d(np.asarray(query_u8, dtype=np.uint8))
    db = np.asarray(db_u8, dtype=np.uint8)
    n, dim = db.shape
    chunk = max(1, (1 << 27) // max(1, n * dim))  # ~128M element partials
    dist = np.empty((q.shape[0], n), dtype=np.float32)
    for s in range(0, q.shape[0], chunk):
        e = min(s + chunk, q.shape[0])
        dist[s:e] = cosine_distance_np(q[s:e, None, :], db[None, :, :])
    return _scan_topk_np(dist, k, max_distance)


def hamming_scan_topk_np(
    query_u8: np.ndarray,
    db_u8: np.ndarray,
    k: int = 100,
    max_distance: float = 1e3,
    wrap_u8: bool = False,
):
    q = np.atleast_2d(np.asarray(query_u8, dtype=np.uint8))
    dist = hamming_distance_np(
        q[:, None, :], np.asarray(db_u8, dtype=np.uint8)[None, :, :], wrap_u8=wrap_u8
    )
    return _scan_topk_np(dist, k, max_distance)


def quantize_embedding_np(x: np.ndarray) -> np.ndarray:
    """Numpy twin of ``ops.quantize.quantize_embedding`` (Rust cast semantics)."""
    xf = np.asarray(x, dtype=np.float32)
    scaled = np.clip(xf * np.float32(128.0), -128.0, 128.0)
    as_i8 = np.clip(np.trunc(scaled), -128.0, 127.0)
    as_i8 = np.where(np.isnan(xf), np.float32(0.0), as_i8)
    return (as_i8 + np.float32(128.0)).astype(np.uint8)
