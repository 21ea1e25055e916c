"""The exact chunk top-k of the port (K1b, K2b, K4b) at the tensor-core
kernels' chunk length, on the CPU.

The same numpy-seeded rows go through the JAX package's exact scans
(``scan.cosine_scan_topk``, ``scan.hamming_scan_topk``,
``hamming_gemm.hamming_gemm_scan_topk``, ``int4.cosine4a_scan_topk`` /
``cosine4_scan_topk``) and through the port's ``fused_cosine_scan_topk``
/ ``fused_hamming_scan_topk`` / ``fused_cosine4_scan_topk``, whose kernel
wrappers take their plain versions for CPU tensors: results equal bit
for bit, ties by ascending row id included; below the small-library gate
the port's ``cosine_scan_topk_auto`` (K1b + K1c) equals the JAX one.  The plain versions'
[Q, n_chunks, k] partials at ``tc_chunk_rows`` are held against a numpy
sort of each chunk, and a model of the kernels' select (a buffer of the
keys below the k-th so far, pruned by the radix select of
``csrc/select_device.cuh``) against ``torch.sort`` of the keys.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pixelbox_tpu.ops import int4 as J
from pixelbox_tpu.ops import scan as jscan
from pixelbox_tpu.ops.hamming_gemm import build_hamming_gemm_index
from pixelbox_tpu.ops.hamming_gemm import hamming_gemm_scan_topk as jax_hamming_gemm_exact
from pixelbox_tpu.ops.packed import PackedHammingIndex as JHIndex
from pixelbox_tpu.ops.packed import PackedSemanticIndex as JSIndex
from pixelbox_tpu.ops.oracle import quantize_embedding_np
from pixelbox_tpu_torch.ops import fused_scan as fs
from pixelbox_tpu_torch.ops import int4 as T
from pixelbox_tpu_torch.ops import scan as tscan
from pixelbox_tpu_torch.ops.packed import PackedHammingIndex as THIndex
from pixelbox_tpu_torch.ops.packed import PackedSemanticIndex as TSIndex
from pixelbox_tpu_torch.ops.packed import semantic_rows_from_u8

BLOCK = 1000  # the JAX scans' row block (divides every capacity below)


def assert_same(got, want):
    gd, gi = (np.asarray(x) for x in got)
    wd, wi = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(gi, wi)
    assert np.array_equal(gd.astype(np.float32).view(np.uint32), wd.astype(np.float32).view(np.uint32))


def chunk_reference(dist, ok, md, k, chunk):
    """numpy partials of the tensor-core layout: per chunk of rows, the
    first k by (dist, row) of the ok rows with dist < md, listed in row
    order, (+inf, -1) past them."""
    qn, n = dist.shape
    n_chunks = -(-n // chunk)
    out_d = np.full((qn, n_chunks, k), np.inf, np.float32)
    out_i = np.full((qn, n_chunks, k), -1, np.int32)
    d = np.where(ok[None, :] & (dist < np.float32(md)), dist, np.inf).astype(np.float32)
    for c in range(n_chunks):
        lo, hi = c * chunk, min(n, (c + 1) * chunk)
        order = np.argsort(d[:, lo:hi], axis=1, kind="stable")[:, :k]
        vals = np.take_along_axis(d[:, lo:hi], order, 1)
        by_row = np.argsort(np.where(np.isfinite(vals), order, hi), axis=1, kind="stable")
        order, vals = np.take_along_axis(order, by_row, 1), np.take_along_axis(vals, by_row, 1)
        m = vals.shape[1]
        out_d[:, c, :m] = vals
        out_i[:, c, :m] = np.where(np.isfinite(vals), order + lo, -1)
    return out_d, out_i


# --------------------------------------------------------------------- #
# The chunk length


@pytest.mark.parametrize(
    "n,k,rows",
    [(1 << 20, 100, 8192), (1 << 20, 400, 32768), (262144, 8, 8192), (262144, 100, 8192),
     (65536, 400, 8192), (1 << 20, 1024, 65536), (300, 5, 8192)],
    ids=["repair_k100", "int4_repair_k400", "mesh_dup_k8", "mesh_similar_k100", "int4_dup_k400",
         "k1024", "tiny"],
)
def test_tc_chunk_rows_take_one_k1c_launch(n, k, rows):
    """The tensor-core chunk at the main paths' shapes, and K1c then takes
    the [Q, n_chunks, k] partials in one launch (or one chunk covers all)."""
    assert fs.tc_chunk_rows(n, k) == rows
    assert rows % 64 == 0 and (-(-n // rows) * k <= fs.SELECT_SLOTS or rows >= n)
    assert fs.hamming_chunk_rows(fs.TC_HAMMING_BYTES, n, k) == rows
    assert fs.hamming_chunk_rows(18, n, k) == fs.CHUNK_ROWS
    assert fs.int4_chunk_rows(128, n, k) == rows
    assert fs.int4_chunk_rows(64, n, k) == fs.CHUNK_ROWS
    for d in fs.TC_COSINE_DIMS:  # the cosine kind: u8 rows of d bytes
        assert fs.cosine_chunk_rows(d, n, k) == rows
    assert fs.cosine_chunk_rows(96, n, k) == fs.CHUNK_ROWS


# --------------------------------------------------------------------- #
# K2b: the exact Hamming scan


def phash_rows(rng, n, h=32, centers=64):
    """Clustered phash-like rows: bit flips off a few bases."""
    base = rng.integers(0, 256, (centers, h), dtype=np.uint8)
    flips = (rng.integers(0, 256, (n, h), dtype=np.uint8) & rng.integers(0, 256, (n, h), dtype=np.uint8)
             & rng.integers(0, 256, (n, h), dtype=np.uint8))
    return base[rng.integers(0, centers, n)] ^ flips


def hamming_dist_np(q, db, limit, wrap):
    bits = np.concatenate([
        np.unpackbits(q[:, None, :limit] ^ db[None, s : s + 2048, :limit], axis=-1).sum(-1)
        for s in range(0, len(db), 2048)
    ], axis=1)
    if wrap:
        bits &= 255
    return bits.astype(np.float32) * np.float32(1.0 / (8.0 * limit))


HAMMING_CASES = {
    # name: (rows, queries, k, max_distance, byte_limit, wrap)
    "ties_across_borders": (20000, 13, 150, 1e3, None, False),
    "plateau_in_a_chunk": (20000, 13, 100, 1e3, None, False),
    "max_distance_0.1": (20000, 70, 8, 0.1, None, False),
    "tombstones": (20000, 13, 30, 1e3, None, False),
    "byte_limit_24_group": (20000, 13, 30, 1e3, 24, False),
    "wrap_u8": (20000, 13, 30, 1e3, None, True),
    "fewer_than_k": (20000, 13, 400, 0.05, None, False),
    "short_last_chunk": (8292, 5, 400, 1e3, None, False),
}


@pytest.mark.parametrize("case", list(HAMMING_CASES))
def test_hamming_exact_scan_at_the_tc_chunk_vs_jax(case):
    n, qn, k, md, limit, wrap = HAMMING_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    db = phash_rows(rng, n)
    valid = np.ones(n, bool)
    q = db[rng.integers(0, n, qn)].copy()
    q[1] = db[77]
    if case == "ties_across_borders":  # copies over the chunk borders at rows 8192 and 16384
        db[8150:8251] = db[77]
        db[16350:16461] = db[77]
    elif case == "plateau_in_a_chunk":
        db[300:900] = db[77]
    elif case == "tombstones":
        valid[rng.choice(n, n // 100, replace=False)] = False
        valid[77] = False
    elif case == "byte_limit_24_group":
        valid &= np.arange(n) % 3 != 1
    elif case == "wrap_u8":
        q[2] = ~db[5]       # 256 differing bits: wraps to 0
        q[3] = ~db[9] ^ 1   # 255 bits
    elif case == "fewer_than_k":
        db[13000:13010] = db[77]
    ji = JHIndex(jnp.asarray(db), jnp.asarray(valid))
    ti = THIndex(torch.from_numpy(db.copy()), torch.from_numpy(valid.copy()))
    qt = torch.from_numpy(q)
    meta = fs.build_hamming_meta(ti)
    eff = 32 if limit is None else limit

    # The plain K2b's partials at the tensor-core chunk
    got = fs.hamming_chunk_topk(qt, md, ti.data, meta, eff, wrap, k)
    rows = fs.tc_chunk_rows(n, k)
    assert got[0].shape == (qn, -(-n // rows), k)
    want = chunk_reference(hamming_dist_np(q, db, eff, wrap), valid, md, k, rows)
    assert_same((got[0].numpy().reshape(qn, -1), got[1].numpy().reshape(qn, -1)),
                (want[0].reshape(qn, -1), want[1].reshape(qn, -1)))

    # The exact scan (K2b + K1c) against the JAX package's
    exact = fs.fused_hamming_scan_topk(qt, ti, meta, k=k, max_distance=md, wrap_u8=wrap, byte_limit=limit)
    block = BLOCK if n % BLOCK == 0 else n
    assert_same(exact, jscan.hamming_scan_topk(jnp.asarray(q), ji, k=k, max_distance=md, block_rows=block,
                                               wrap_u8=wrap, byte_limit=limit))
    if limit is None:
        assert_same(exact, jax_hamming_gemm_exact(jnp.asarray(q), build_hamming_gemm_index(ji), k=k,
                                                  max_distance=md, block_rows=block, wrap_u8=wrap))
    if case == "ties_across_borders":
        assert exact[1][1].tolist() == [77, *range(8150, 8251), *range(16350, 16398)]
    if case == "fewer_than_k":
        assert 0 < int((exact[1][1] >= 0).sum()) < k
    if case == "wrap_u8":
        assert float(exact[0][2, 0]) == 0.0 and int(exact[1][2, 0]) == 5


# --------------------------------------------------------------------- #
# K1b: the exact u8 cosine scan


U8_CASES = {
    # name: (rows, queries, k, max_distance); 1e7 is past the distance's
    # saturation (~1e6): every valid row passes
    "ties_across_borders": (20000, 13, 150, 1e3),
    "unbounded": (20000, 70, 400, 1e7),
    "tombstones_max_distance": (20000, 13, 30, 0.05),
    "fewer_than_k": (20000, 13, 400, 0.05),
    "short_last_chunk": (8292, 5, 400, 1e3),
}


def u8_case(case):
    """The seeded u8 rows, validity and queries of a U8_CASES case, as JAX
    and port indexes (query 1 is row 77)."""
    n, qn, k, md = U8_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)) + 1)
    c = rng.standard_normal((32, 128)).astype(np.float32)
    x = c[rng.integers(0, 32, n)] + 0.35 * rng.standard_normal((n, 128)).astype(np.float32)
    db = quantize_embedding_np(np.tanh(x))
    valid = np.ones(n, bool)
    q = db[rng.integers(0, n, qn)].copy()
    q[1] = db[77]
    if case == "ties_across_borders":  # copies over the chunk borders at rows 8192 and 16384
        db[8150:8251] = db[77]
        db[16350:16461] = db[77]
    elif case == "tombstones_max_distance":
        valid[rng.choice(n, n // 100, replace=False)] = False
        valid[77] = False
    elif case == "fewer_than_k":
        db[13000:13010] = db[77]
    cols = (*semantic_rows_from_u8(db), valid)
    ji = JSIndex(*(jnp.asarray(x) for x in cols))
    ti = TSIndex(*(torch.from_numpy(np.ascontiguousarray(x)) for x in cols))
    return q, ji, ti


@pytest.mark.parametrize("case", list(U8_CASES))
def test_u8_exact_scan_at_the_tc_chunk_vs_jax(case):
    n, qn, k, md = U8_CASES[case]
    q, ji, ti = u8_case(case)
    qt = torch.from_numpy(q)
    meta = fs.build_row_meta(ti)

    # The plain K1b's partials at the tensor-core chunk
    qk = fs.CosineQueries.from_u8(qt)
    got = fs.cosine_chunk_topk(*qk, md, ti.data, meta, k)
    rows = fs.tc_chunk_rows(n, k)
    assert got[0].shape == (qn, -(-n // rows), k)
    dist, ok = fs._tile_dist(*qk, ti.data, meta)
    want = chunk_reference(dist.numpy(), ok[0].numpy(), md, k, rows)
    assert_same((got[0].numpy().reshape(qn, -1), got[1].numpy().reshape(qn, -1)),
                (want[0].reshape(qn, -1), want[1].reshape(qn, -1)))

    # The exact scan (K1b + K1c) against the JAX package's
    exact = fs.fused_cosine_scan_topk(qt, ti, meta, k=k, max_distance=md)
    block = BLOCK if n % BLOCK == 0 else n
    assert_same(exact, jscan.cosine_scan_topk(jnp.asarray(q), ji, k=k, max_distance=md, block_rows=block))
    if case == "ties_across_borders":  # a stored row reads exactly 0 against itself
        assert exact[1][1].tolist() == [77, *range(8150, 8251), *range(16350, 16398)]
    if case == "fewer_than_k":
        assert 0 < int((exact[1][1] >= 0).sum()) < k
    if case == "short_last_chunk":  # the last chunk holds 100 rows, fewer than k
        assert int((got[1][:, -1] >= 0).sum(dim=1).max()) <= n - rows < k


@pytest.mark.parametrize("case", ["ties_across_borders", "tombstones_max_distance"])
def test_u8_auto_below_the_small_library_gate_vs_jax(case):
    """A library of at most 4 · block_rows rows: the port's auto scan takes
    K1b + K1c (no θ pass), the JAX one its exact scan; equal."""
    n, qn, k, md = U8_CASES[case]
    q, ji, ti = u8_case(case)
    block = 5000
    assert n <= 4 * block
    got = tscan.cosine_scan_topk_auto(torch.from_numpy(q), ti, k=k, max_distance=md, block_rows=block)
    assert_same(got, jscan.cosine_scan_topk_auto(jnp.asarray(q), ji, k=k, max_distance=md, block_rows=block))


# --------------------------------------------------------------------- #
# K4b: the exact int4 scans


INT4_CASES = {
    # name: (rows, queries, k, max_distance)
    "ties_across_borders": (20000, 13, 150, 1e3),
    "unbounded": (20000, 70, 400, T.UNBOUNDED_DISTANCE),
    "tombstones_max_distance": (20000, 13, 30, 0.05),
    "fewer_than_k": (20000, 13, 400, 0.05),
    "short_last_chunk": (8292, 5, 400, 1e3),
}


@pytest.mark.parametrize("mode", ["asym", "sym"])
@pytest.mark.parametrize("case", list(INT4_CASES))
def test_int4_exact_scan_at_the_tc_chunk_vs_jax(case, mode):
    n, qn, k, md = INT4_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    c = rng.standard_normal((32, 128)).astype(np.float32)
    x = c[rng.integers(0, 32, n)] + 0.35 * rng.standard_normal((n, 128)).astype(np.float32)
    db = quantize_embedding_np(np.tanh(x))
    valid = np.ones(n, bool)
    q = db[rng.integers(0, n, qn)].copy()
    q[1] = db[77]
    if case == "ties_across_borders":
        db[8150:8251] = db[77]
        db[16350:16461] = db[77]
    elif case == "tombstones_max_distance":
        valid[rng.choice(n, n // 100, replace=False)] = False
        valid[77] = False
    elif case == "fewer_than_k":
        db[13000:13010] = db[77]
    cap = -(-n // BLOCK) * BLOCK
    pad = np.zeros(cap, bool)
    pad[:n] = valid
    ji = J.build_semantic4_index(db, block_rows=BLOCK)._replace(valid=jnp.asarray(pad))
    ti = T.build_semantic4_index(db, block_rows=BLOCK, device="cpu")._replace(valid=torch.from_numpy(pad))
    qt = torch.from_numpy(q)
    meta = T.build_semantic4_meta(ti)
    sym = mode == "sym"

    qk = fs.Int4Queries.from_u8(qt, mode)
    got = fs.cosine4_chunk_topk(qk.q_codes, qk.q_sum, qk.q_mag2, qk.qr, md, ti.data, meta, sym, k)
    rows = fs.tc_chunk_rows(cap, k)
    assert got[0].shape == (qn, -(-cap // rows), k)
    dist, ok = fs._tile_dist4(qk.q_codes, qk.q_sum, qk.q_mag2, qk.qr, ti.data, meta, sym)
    want = chunk_reference(dist.numpy(), ok[0].numpy(), md, k, rows)
    assert_same((got[0].numpy().reshape(qn, -1), got[1].numpy().reshape(qn, -1)),
                (want[0].reshape(qn, -1), want[1].reshape(qn, -1)))

    jfn = J.cosine4_scan_topk if sym else J.cosine4a_scan_topk
    exact = fs.fused_cosine4_scan_topk(qt, ti, meta, k=k, max_distance=md, query_mode=mode)
    assert_same(exact, jfn(jnp.asarray(q), ji, k=k, max_distance=md, block_rows=BLOCK))
    if case == "ties_across_borders" and sym:  # a stored row reads exactly 0 against itself
        assert exact[1][1].tolist() == [77, *range(8150, 8251), *range(16350, 16398)]
    if case == "fewer_than_k":
        assert 0 < int((exact[1][1] >= 0).sum()) < k


@pytest.mark.parametrize("kind", ["hamming", "int4"])
def test_plain_chunk_topk_with_k_past_the_chunk(kind):
    """A chunk shorter than k: every passing row of it, then (+inf, -1);
    the plain versions follow the chunk length they are given."""
    rng = np.random.default_rng(7)
    n, k, chunk = 1000, 300, 256
    if kind == "hamming":
        db = phash_rows(rng, n)
        q = torch.from_numpy(db[:3].copy())
        ti = THIndex(torch.from_numpy(db), torch.ones(n, dtype=torch.bool))
        got = fs.hamming_chunk_topk_plain(q, 0.4, ti.data, fs.build_hamming_meta(ti), 32, False, k, chunk)
        dist, ok = hamming_dist_np(db[:3], db, 32, False), np.ones(n, bool)
        md = 0.4
    else:
        db = rng.integers(0, 256, (n, 128), dtype=np.uint8)
        ti = T.build_semantic4_index(db, block_rows=250, device="cpu")
        meta = T.build_semantic4_meta(ti)
        qk = fs.Int4Queries.from_u8(torch.from_numpy(db[:3].copy()), "asym")
        args = (qk.q_codes, qk.q_sum, qk.q_mag2, qk.qr)
        md = 1e3
        got = fs.cosine4_chunk_topk_plain(*args, md, ti.data, meta, False, k, chunk)
        dist, okt = fs._tile_dist4(*args, ti.data, meta, False)
        dist, ok = dist.numpy(), okt[0].numpy()
    assert got[0].shape == (3, -(-n // chunk), k)
    want = chunk_reference(dist, ok, md, k, chunk)
    assert_same((got[0].numpy().ravel(), got[1].numpy().ravel()), (want[0].ravel(), want[1].ravel()))
    assert bool(torch.isinf(got[0][:, :, chunk:]).all()) and bool((got[1][:, :, chunk:] == -1).all())


# --------------------------------------------------------------------- #
# The kernels' select, step for step, against torch.sort


def radix_bin(keys, k, shift0, shift_end):
    """``radix_select`` of select_device.cuh: the bin (prefix, mask, rank,
    whole) of the k-th smallest key, 8-bit digits MSB first from shift0
    down to shift_end, stopping once the bin holds exactly the rest."""
    prefix = mask = 0
    rank = k
    whole = True
    for shift in range(shift0, shift_end - 1, -8):
        hist = np.bincount([(x >> shift) & 255 for x in keys if x & mask == prefix], minlength=256)
        csum = np.cumsum(hist)
        b = int(np.searchsorted(csum, rank))  # the first bin whose running count reaches rank
        rank -= int(csum[b] - hist[b])
        prefix |= b << shift
        mask |= 0xFF << shift
        whole = int(hist[b]) == rank
        if whole:
            break
    return prefix, mask, rank, whole


def stream_select(keys, k, pair=128):
    """The chunk kernel's select over one query's keys in row order (None:
    the row does not pass): a buffer of cap = next_pow2(max(k + 128,
    min(2k + 128, 2048))) takes each tile pair's keys below τ, in row
    order; past cap − 128 it keeps its k smallest — the radix select of
    the distance bits from the highest bit where the keys differ (the
    bits above it common to all), then the ties at the k-th in row order —
    and τ becomes the largest kept; the end keeps k (K1c reads them in any
    order)."""
    cap = max(1 << (k + pair - 1).bit_length(), min(1 << (2 * k + pair - 1).bit_length(), 2048))
    buf, tau = [], 1 << 64

    def prune(buf):
        lo, hi = min(buf), max(buf)
        shift0 = max(32, (hi ^ lo).bit_length() - 1 & ~7)
        prefix, mask, rank, whole = radix_bin(buf, k, shift0, 32)
        common = ~((1 << (shift0 + 8)) - 1) & ((1 << 64) - 1)
        prefix, mask = prefix | (lo & common), mask | common
        if whole:
            kept = [x for x in buf if x & mask <= prefix]
        else:
            dk, kept = prefix >> 32, []
            for x in buf:
                if x >> 32 < dk or (x >> 32 == dk and rank > 0):
                    rank -= x >> 32 == dk
                    kept.append(x)
        assert len(kept) == k and kept == sorted(kept, key=lambda x: x & 0xFFFFFFFF)
        return kept, max(kept)

    for t0 in range(0, len(keys), pair):
        buf += [x for x in keys[t0 : t0 + pair] if x is not None and x < tau]
        if len(buf) > cap - pair:
            buf, tau = prune(buf)
    if len(buf) > k:
        buf, _ = prune(buf)
    return sorted(buf)


def _keys(rng, case, n):
    rows = np.arange(n, dtype=np.uint64)
    if case == "dist_bits":  # K4b: f32 distance bits, some repeated
        d = np.round(rng.random(n) * 4096).astype(np.float32) / np.float32(1024)
        hi = d.view(np.uint32).astype(np.uint64)
    elif case == "dist_plateau":  # K4b: one distance, its top bytes common to every key
        hi = np.full(n, np.float32(0.3).view(np.uint32), np.uint64)
        hi[::7] = np.float32(0.2999).view(np.uint32)
    elif case == "diff_ties":  # K2b: diffs 0..256, heavy plateaus
        hi = rng.binomial(256, 0.5, n).astype(np.uint64)
    elif case == "plateau_256":  # K2b: every bit differs (bit 40 common to every key)
        hi = np.full(n, 256, np.uint64)
    elif case == "descending":  # every row enters: the most prunes
        hi = np.arange(n, 0, -1).astype(np.uint64)
    else:  # "sparse": few rows pass
        hi = rng.integers(0, 257, n).astype(np.uint64)
    keys = [int(x) for x in (hi << np.uint64(32)) | rows]
    if case == "sparse":
        keys = [x if r % 97 == 0 else None for r, x in enumerate(keys)]
    return keys


@pytest.mark.parametrize(
    "case,n,k",
    [("dist_bits", 2048, 400), ("dist_plateau", 8192, 400), ("diff_ties", 8192, 100),
     ("plateau_256", 2048, 100), ("descending", 4096, 8), ("sparse", 8192, 100),
     ("diff_ties", 4096, 1024), ("dist_bits", 4096, 1)],
)
def test_stream_select_model_equals_sort(case, n, k):
    keys = _keys(np.random.default_rng(n + k), case, n)
    got = stream_select(keys, k)
    full = torch.tensor([x for x in keys if x is not None], dtype=torch.int64)  # all below 2^63
    want = torch.sort(full).values[:k].tolist()
    assert got == want
