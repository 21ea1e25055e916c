"""The plain reference against a brute-force NumPy top-k and pair set on
tiny libraries, ties included.

The NumPy side is written apart from the reference: the spec's f32 steps
as NumPy f32 operations (correctly rounded), a full sort of every row by
(dist, row id), and the pair union taken over every row."""

import numpy as np
import pytest
import torch

from perfbench.reference import scan as ref


def np_cosine(q, rows):
    cq = 2 * q.astype(np.int64) - 255
    cr = 2 * rows.astype(np.int64) - 255
    dot = (cq[:, None, :] * cr[None, :, :]).sum(-1).astype(np.float32)
    mq = (cq * cq).sum(-1).astype(np.float32)[:, None]
    mr = (cr * cr).sum(-1).astype(np.float32)[None, :]
    one = np.float32(1.0)
    inv = (one / np.sqrt(mq)) * (one / np.sqrt(mr))
    cos = dot * inv
    dist = np.maximum(one / np.maximum(cos, np.float32(1e-6)) - one, np.float32(0.0))
    pin = ((dot == mq) & (mq == mr)) | (mq == 0) | (mr == 0)
    return np.where(pin, np.float32(0.0), dist).astype(np.float32)


def np_hamming(q, rows):
    x = np.bitwise_xor(q[:, None, :], rows[None, :, :])
    bits = np.unpackbits(x, axis=-1).sum(-1).astype(np.float32)
    return bits * np.float32(1.0 / (8.0 * rows.shape[1]))


def np_topk(dist, k, md):
    out_d = np.full((dist.shape[0], k), np.inf, np.float32)
    out_i = np.full((dist.shape[0], k), -1, np.int64)
    for qi, row in enumerate(dist):
        keep = [(d, i) for i, d in enumerate(row) if d < np.float32(md)]
        keep.sort()
        for j, (d, i) in enumerate(keep[:k]):
            out_d[qi, j], out_i[qi, j] = d, i
    return out_d, out_i


def library(kind, n=700, seed=3):
    rng = np.random.default_rng(seed)
    width = 128 if kind == "semantic" else 32
    base = rng.integers(0, 256, (n // 7, width), dtype=np.uint8)
    rows = base[rng.integers(0, len(base), n)]
    noise = rng.integers(0, 256, (n, width), dtype=np.uint8)
    mask = rng.random((n, width)) < 0.05
    rows = np.where(mask, noise, rows).astype(np.uint8)
    c = min(60, n // 2)
    rows[n // 2 : n // 2 + c] = rows[:c]               # exact copies: tied distances
    return rows


@pytest.mark.parametrize("kind,k,md", [("semantic", 10, 1e3), ("semantic", 8, 0.05),
                                       ("phash", 10, 1e3), ("phash", 8, 0.1)])
def test_topk_equals_brute_force(kind, k, md, monkeypatch):
    monkeypatch.setattr(ref, "ROW_BLOCK", 256)        # several row blocks and merges
    monkeypatch.setattr(ref, "QUERY_BLOCK", 64)
    rows = library(kind)
    q = np.concatenate([rows[:40], rows[100:140] ^ np.uint8(1)])
    dist = (np_cosine if kind == "semantic" else np_hamming)(q, rows)
    want_d, want_i = np_topk(dist, k, md)
    r = ref.CosineRows(torch.from_numpy(rows)) if kind == "semantic" \
        else ref.HammingRows(torch.from_numpy(rows))
    got_d, got_i = ref.topk(r, torch.from_numpy(q), k, md)
    assert np.array_equal(got_i.numpy(), want_i)
    assert np.array_equal(got_d.numpy().view(np.int32), want_d.view(np.int32))
    # the library's copies make ties: some query has equal distances in its list
    assert any(len(set(row[row < np.inf])) < (row < np.inf).sum() for row in want_d)


@pytest.mark.parametrize("kind,md", [("semantic", 0.05), ("phash", 0.1)])
def test_pairs_equal_brute_force_union(kind, md):
    rows = library(kind, n=420, seed=5)
    k = 8
    dist = (np_cosine if kind == "semantic" else np_hamming)(rows, rows)
    d, i = np_topk(dist, k, md)
    want = {}
    for a in range(len(rows)):
        for dd, b in zip(d[a], i[a]):
            if b >= 0 and b != a:
                want[(min(a, b) + 1, max(a, b) + 1)] = float(dd)
    r = ref.CosineRows(torch.from_numpy(rows)) if kind == "semantic" \
        else ref.HammingRows(torch.from_numpy(rows))
    got = ref.duplicate_pairs(r, torch.from_numpy(rows), range(len(rows)), k, md,
                              image_id=lambda x: x + 1)
    assert got == want and want


def test_half_bit_hamming_reads_the_first_bytes():
    rows = library("phash", n=64)
    r = ref.HammingRows(torch.from_numpy(rows), byte_limit=16)
    q = torch.from_numpy(rows[:4])
    want = np_hamming(rows[:4, :16], rows[:, :16])
    assert np.array_equal(r.distances(q, 0, 64).numpy(), want)
