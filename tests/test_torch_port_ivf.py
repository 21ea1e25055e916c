"""pixelbox_tpu_torch IVF (ops/ivf.py, ops/ivf_build.py, parallel/sharded_ivf.py)
vs pixelbox_tpu on the CPU, and the scans' k past 1,024.

Inputs are seeded with numpy and go through both packages.  k-means agrees
within f32 summation-order noise; from equal centroids the packs are equal
array for array, and on one packed index carried across
(``ivf_from_jax``) the scans are bit-identical in (dist, idx).  Where the
f32 centroid scores of the two packages (XLA's and torch's matmuls) could
order two clusters differently, the results could differ for a reason
that is not the port's: each test asserts its data keeps such near-ties
away from the decisions it makes (the assignment's argmax, the nprobe-th
probe).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pixelbox_tpu.ops import hamming_gemm as jhg
from pixelbox_tpu.ops import int4 as jint4
from pixelbox_tpu.ops import ivf as jivf
from pixelbox_tpu.ops import ivf_build as jivfb
from pixelbox_tpu.ops import scan as jscan
from pixelbox_tpu.ops.packed import PackedHammingIndex as JHam
from pixelbox_tpu.ops.packed import PackedSemanticIndex as JSem
from pixelbox_tpu_torch.ops import fused_scan as tfs
from pixelbox_tpu_torch.ops import hamming_gemm as thg
from pixelbox_tpu_torch.ops import int4 as tint4
from pixelbox_tpu_torch.ops import ivf as tivf
from pixelbox_tpu_torch.ops import ivf_build as tivfb
from pixelbox_tpu_torch.ops import oracle
from pixelbox_tpu_torch.ops import scan as tscan
from pixelbox_tpu_torch.ops import topk as ttopk
from pixelbox_tpu_torch.ops.packed import PackedHammingIndex, PackedSemanticIndex, semantic_rows_from_u8

D = 32
N = 3000
C = 24
CAP = 96
#: Least gap between two f32 centroid scores a decision may rest on
#: (relative to the scores' scale): some 30x the two packages' f32
#: summation-order differences (a few 1e-7 at D = 32).
GAP = 1e-5


def clustered(rng, n, d, n_blobs=16, spread=12.0):
    centers = rng.normal(size=(n_blobs, d)) * 40.0
    which = rng.integers(0, n_blobs, size=n)
    x = centers[which] + rng.normal(size=(n, d)) * spread
    return np.clip(x + 128.0, 0, 255).astype(np.uint8), which


def _scores(x_u8, cents):
    return (2.0 * x_u8.astype(np.float64) - 255.0) @ np.asarray(cents, np.float64).T


def assert_no_assignment_ties(rows, cents):
    s = np.sort(_scores(rows, cents), axis=1)
    gap = (s[:, -1] - s[:, -2]) / np.abs(s[:, -1])
    assert gap.min() > GAP, gap.min()


def assert_no_probe_ties(q, cents, nprobe):
    if nprobe >= cents.shape[0]:
        return
    s = -np.sort(-_scores(q, cents), axis=1)
    gap = (s[:, nprobe - 1] - s[:, nprobe]) / np.abs(s[:, 0])
    assert gap.min() > GAP, gap.min()


def same(got, want):
    gd, gi = (x.numpy() if torch.is_tensor(x) else np.asarray(x) for x in got)
    wd, wi = (np.asarray(x) for x in want)
    assert np.array_equal(gi, wi)
    assert np.array_equal(gd, wd)


def as_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def lib():
    """Rows (every 37th a tombstone), JAX centroids, and both packings
    built by the JAX package."""
    rng = np.random.default_rng(14)
    rows, _ = clustered(rng, N, D)
    valid = np.ones(N, dtype=bool)
    valid[::37] = False
    cents = jivf.spherical_kmeans(rows, valid, C, iters=6, seed=0)
    assert_no_assignment_ties(rows[valid], cents)
    idx = {p: jivf.build_ivf(rows, valid, cents, bucket_cap=CAP, precision=p) for p in ("u8", "int4")}
    q = rows[rng.integers(0, N, 6)].copy()
    q[0] = rng.integers(0, 256, D)
    return {"rows": rows, "valid": valid, "cents": cents, "idx": idx, "q": q, "rng": rng}


def test_kmeans_and_assignment_match_jax():
    rng = np.random.default_rng(5)
    rows, _ = clustered(rng, 800, D, n_blobs=4, spread=4.0)
    valid = np.ones(len(rows), dtype=bool)
    want = jivf.spherical_kmeans(rows, valid, 4, iters=10, seed=0)
    got = tivf.spherical_kmeans(rows, valid, 4, iters=10, seed=0, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert_no_assignment_ties(rows, want)
    assert np.array_equal(tivf.assign_rows_u8(rows, want, device="cpu"), jivf.assign_rows_u8(rows, want))
    dev = tivfb.kmeans_device(torch.from_numpy(rows), 4, iters=6, seed=2, train_sample=500)
    np.testing.assert_allclose(dev.numpy(), np.asarray(jivfb.kmeans_device(rows, 4, iters=6, seed=2,
                                                                           train_sample=500)),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("precision", ["u8", "int4"])
def test_packs_equal_jax(lib, precision):
    """The host packer, the device packer and ``build_ivf``'s routing to
    each give JAX ``build_ivf``'s arrays, spill and row ids exactly."""
    want = as_np(lib["idx"][precision])
    assert want.spill_count > 0
    host = tivf.build_ivf(lib["rows"], lib["valid"], lib["cents"], bucket_cap=CAP,
                          precision=precision, device="cpu")
    dev = tivfb.build_ivf_device(lib["rows"], lib["valid"], lib["cents"], bucket_cap=CAP,
                                 precision=precision, device="cpu")
    for got in (host, dev):
        for name, a, b in zip(want._fields, want, got):
            if name == "spill":
                for x, y in zip(a, b):
                    assert np.array_equal(x, y.numpy()), name
            else:
                assert np.array_equal(a, b.numpy()), name
        assert torch.equal(got.spill_meta, tfs.build_row_meta(got.spill))
    assert host.kind == ("cosine4a" if precision == "int4" else "cosine")
    ids = np.arange(N, dtype=np.int32)
    for pack in (tivf.pack_buckets_host, tivfb.pack_buckets_device_np):
        got = pack(lib["rows"], lib["valid"], lib["cents"], CAP, ids, precision=precision, device="cpu")
        exp = jivf.pack_buckets_host(lib["rows"], lib["valid"], lib["cents"], CAP, ids, precision=precision)
        for a, b in zip(exp, got):
            assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("precision", ["u8", "int4"])
@pytest.mark.parametrize("nprobe", [1, 8, None, C])
def test_scan_bit_identical_to_jax(lib, precision, nprobe):
    """One JAX-packed index through both packages, tombstones in it: a
    max_distance filter that excludes rows, a k past the bucket cap, and
    (nprobe 8) a squeezed single query at the default k."""
    jidx = lib["idx"][precision]
    tidx = tivf.ivf_from_jax(as_np(jidx), device="cpu")
    q = lib["q"]
    assert_no_probe_ties(q, lib["cents"], nprobe or tivf.default_nprobe(C))
    k = CAP + 30
    same(tivf.ivf_scan_topk(torch.from_numpy(q), tidx, k=k, nprobe=nprobe, max_distance=0.08),
         jivf.ivf_scan_topk(q, jidx, k=k, nprobe=nprobe, max_distance=0.08))
    if nprobe == 8:
        got = tivf.ivf_scan_topk(q[2], tidx, nprobe=nprobe)
        assert got[0].shape == (100,)
        same(got, jivf.ivf_scan_topk(q[2], jidx, nprobe=nprobe))


def test_ties_across_clusters_match_jax_and_exact():
    """Two rows at exactly equal distance in different clusters, the
    higher row id's cluster probed first (the JAX ``test_ivf.py``
    case): ascending row id wins, as in the flat scan."""
    q = np.array([[100, 100, 10, 250, 40, 200, 30, 90]], dtype=np.uint8)
    row0 = np.array([30, 220, 60, 60, 10, 90, 170, 128], dtype=np.uint8)
    row1 = row0.copy()
    row1[[0, 1]] = row1[[1, 0]]
    rows = np.stack([row0, row1])
    valid = np.ones(2, dtype=bool)
    cents = np.concatenate([jivf._unit_rows_f32(row1[None]), jivf._unit_rows_f32(row0[None])])
    assert list(tivf.assign_rows_u8(rows, cents, device="cpu")) == [1, 0]
    jidx = jivf.build_ivf(rows, valid, cents)
    tidx = tivf.build_ivf(rows, valid, cents, device="cpu")
    got = tivf.ivf_scan_topk(torch.from_numpy(q), tidx, k=1, nprobe=2)
    same(got, jivf.ivf_scan_topk(q, jidx, k=1, nprobe=2))
    assert int(got[1][0, 0]) == 0 and np.isfinite(float(got[0][0, 0]))


def test_fewer_rows_than_clusters():
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 256, (5, D), dtype=np.uint8)
    valid = np.ones(5, dtype=bool)
    cents = jivf.spherical_kmeans(rows, valid, 8, iters=3, seed=1)
    got_c = tivf.spherical_kmeans(rows, valid, 8, iters=3, seed=1, device="cpu")
    assert got_c.shape == cents.shape == (5, D)
    np.testing.assert_allclose(got_c, cents, rtol=1e-4, atol=1e-5)
    jidx = jivf.build_ivf(rows, valid, cents)
    tidx = tivf.build_ivf(rows, valid, cents, device="cpu")
    same(tivf.ivf_scan_topk(torch.from_numpy(rows[:2]), tidx, k=8, nprobe=3),
         jivf.ivf_scan_topk(rows[:2], jidx, k=8, nprobe=3))


@pytest.mark.parametrize("precision", ["u8", "int4"])
def test_full_nprobe_equals_exact_scan_and_oracle(lib, precision):
    rows, valid = lib["rows"], lib["valid"]
    tidx = tivf.build_ivf(rows, valid, lib["cents"], bucket_cap=CAP, precision=precision, device="cpu")
    q = torch.from_numpy(lib["q"])
    got = tivf.ivf_scan_topk(q, tidx, k=40, nprobe=C)
    if precision == "u8":
        data, s, m = semantic_rows_from_u8(rows)
        flat = PackedSemanticIndex(*(torch.from_numpy(x) for x in (data, s, m, valid)))
        want = tscan.cosine_scan_topk(q, flat, k=40, block_rows=N)
        keep = np.flatnonzero(valid)
        od, oi = oracle.cosine_scan_topk_np(lib["q"], rows[keep], k=40)
        oi = np.where(oi >= 0, keep[np.maximum(oi, 0)], -1)
    else:
        data, s, m = tint4.semantic4_rows_from_u8(rows)
        flat = tint4.PackedSemantic4Index(*(torch.from_numpy(x) for x in (data, s, m, valid)))
        want = tint4.cosine4a_scan_topk(q, flat, k=40, block_rows=N)
        keep = np.flatnonzero(valid)
        od, oi = tint4.cosine4a_scan_topk_np(lib["q"], rows[keep], k=40)
        oi = np.where(oi >= 0, keep[np.maximum(oi, 0)], -1)
    same(got, want)
    same(got, (od, oi))


def test_rebuild_spill_equals_jax(lib, monkeypatch):
    """The extended spill equals JAX's, and carries its kernel meta: a
    scan reads it and builds none."""
    rows, valid = lib["rows"], lib["valid"]
    base = lib["idx"]["u8"]
    ids = np.concatenate([jivf.live_spill_ids(base).astype(np.int64), np.arange(N - 40, N, 3)])
    ids = np.unique(ids)
    want = as_np(jivf.rebuild_spill(base, rows, ids))
    tbase = tivf.ivf_from_jax(as_np(base), device="cpu")
    got = tivf.rebuild_spill(tbase, rows, ids)
    assert got.bucket_data is tbase.bucket_data
    for a, b in zip(want.spill, got.spill):
        assert np.array_equal(a, b.numpy())
    assert np.array_equal(want.spill_rows, got.spill_rows.numpy())
    assert np.array_equal(tivf.live_spill_ids(got), jivf.live_spill_ids(jivf.rebuild_spill(base, rows, ids)))
    assert torch.equal(got.spill_meta, tfs.build_row_meta(got.spill))
    assert got.spill_meta.shape == (4, got.spill_count)

    def no_meta(index):
        raise AssertionError("the scan rebuilt the spill's meta")

    monkeypatch.setattr(tfs, "build_row_meta", no_meta)
    q = lib["q"]
    same(tivf.ivf_scan_topk(torch.from_numpy(q), got, k=20, nprobe=C),
         jivf.ivf_scan_topk(q, jivf.rebuild_spill(base, rows, ids), k=20, nprobe=C))


@pytest.mark.parametrize("precision", ["u8", "int4"])
def test_tune_nprobe_matches_jax(lib, precision):
    """The int4 index is measured through the device rerank."""
    jidx = lib["idx"][precision]
    tidx = tivf.ivf_from_jax(as_np(jidx), device="cpu")
    kw = dict(target_recall=0.999, q=6, valid=lib["valid"], max_rows_frac=0.5)
    assert tivfb.tune_nprobe(tidx, lib["rows"], **kw) == jivfb.tune_nprobe(jidx, lib["rows"], **kw)


def test_rerank_candidates_u8_device_matches_jax_and_host(lib):
    rows = lib["rows"]
    rng = np.random.default_rng(8)
    cand = np.stack([rng.permutation(N)[:60] for _ in range(5)]).astype(np.int32)
    cand[0, :7] = -1
    cand[1, 3] = N + 5  # out of range: empty
    q = lib["q"][:5]
    got = tivfb.rerank_candidates_u8_device(q, cand, torch.from_numpy(rows), k=20, max_distance=0.2)
    same(got, jivfb.rerank_candidates_u8_device(q, cand, rows, k=20, max_distance=0.2))
    hd, hi = tint4.rerank_candidates_u8(q, cand, rows, k=20, max_distance=0.2)
    same(got, (hd, hi.astype(np.int32)))
    same(tivfb.rerank_candidates_u8_device(q[1], cand[1], torch.from_numpy(rows), k=20),
         jivfb.rerank_candidates_u8_device(q[1], cand[1], rows, k=20))
    # The device orchestration equals the host one over an int4 probe.
    tidx = tivf.ivf_from_jax(as_np(lib["idx"]["int4"]), device="cpu")

    def scan(c, md):
        return tivf.ivf_scan_topk(torch.from_numpy(q), tidx, k=c, nprobe=C, max_distance=md)

    hd, hi = tint4.scan_with_u8_rerank(lambda c, md: tuple(x.numpy() for x in scan(c, md)), q, rows, k=10)
    same(tivfb.scan_with_u8_rerank_device(scan, q, torch.from_numpy(rows), k=10), (hd, hi.astype(np.int32)))


def test_flat_index_device_and_tree_merge():
    rng = np.random.default_rng(4)
    rows = rng.integers(0, 256, (300, D), dtype=np.uint8)
    want = as_np(jivfb.flat_semantic_index_device(rows, n_valid=290, block_rows=128))
    got = tivfb.flat_semantic_index_device(torch.from_numpy(rows), n_valid=290, block_rows=128)
    for a, b in zip(want, got):
        assert np.array_equal(a, b.numpy())
    # tree_merge_sorted: the top 7 of five sorted lists by (dist, id), ties
    # and +inf included, as one stable sort of the union gives them.
    d = np.sort(rng.integers(0, 6, (3, 5, 7)).astype(np.float32), axis=-1)
    d[0, 2, 4:] = np.inf
    i = np.sort(rng.permutation(1000)[:105].reshape(3, 5, 7).astype(np.int32), axis=-1)
    td, ti = ttopk.tree_merge_sorted(torch.from_numpy(d), torch.from_numpy(i), 7)
    key = d.reshape(3, -1).astype(np.float64) * 2000 + i.reshape(3, -1)
    order = np.argsort(key, axis=-1, kind="stable")[:, :7]
    fin = np.isfinite(td.numpy())
    assert np.array_equal(td.numpy(), np.take_along_axis(d.reshape(3, -1), order, -1))
    assert np.array_equal(ti.numpy()[fin], np.take_along_axis(i.reshape(3, -1), order, -1)[fin])


@pytest.mark.parametrize("precision", ["u8", "int4"])
def test_sharded_full_nprobe_equals_one_device(lib, precision):
    from pixelbox_tpu_torch.parallel import make_mesh
    from pixelbox_tpu_torch.parallel import sharded_ivf as sivf

    mesh = make_mesh(4, device="cpu")
    rows, valid = lib["rows"], lib["valid"]
    n = N - N % 4
    sidx, spill_ids = sivf.build_sharded_ivf(rows[:n], valid[:n], lib["cents"], mesh, bucket_cap=40,
                                             precision=precision)
    one = tivf.build_ivf(rows[:n], valid[:n], lib["cents"], bucket_cap=CAP, precision=precision,
                         device="cpu")
    q = torch.from_numpy(lib["q"])
    same(sivf.sharded_ivf_scan_topk(q, sidx, mesh, k=25, nprobe=C),
         tivf.ivf_scan_topk(q, one, k=25, nprobe=C))
    ext = sivf.rebuild_sharded_spill(sidx, rows, [np.sort(np.concatenate([s, [n - 1 - j]]))
                                                  if n - 1 - j not in s else s
                                                  for j, s in enumerate(spill_ids)])
    assert ext.shards[0].bucket_data is sidx.shards[0].bucket_data
    same(sivf.sharded_ivf_scan_topk(lib["q"][0], ext, mesh, k=25, nprobe=C),
         tivf.ivf_scan_topk(lib["q"][0], one, k=25, nprobe=C))


# --------------------------------------------------------------------- #
# K5: the per-bucket top-k' (ivf_probe_topk) and its work list


@pytest.fixture(scope="module")
def probe_lib():
    """A D = 128 library (the tensor-core widths of both packings) of 8
    clusters at cap 96: full buckets with a spill beside partly filled
    ones; 30 copies of one row (ties at the k-th inside its bucket); ten
    equal queries (one bucket probed by more queries than a work item
    holds) and two others."""
    rng = np.random.default_rng(21)
    rows, _ = clustered(rng, 640, 128, n_blobs=8, spread=10.0)
    rows[600:630] = rows[3]
    valid = np.ones(len(rows), dtype=bool)
    valid[::41] = False
    valid[3] = True
    cents = jivf.spherical_kmeans(rows, valid, 8, iters=5, seed=0)
    q = np.concatenate([np.repeat(rows[3:4], 10, 0), rows[[17, 250]]])
    return {"rows": rows, "valid": valid, "cents": cents, "q": q}


@pytest.mark.parametrize("precision", ["u8", "int4"])
def test_probe_topk_plain_matches_jax_and_the_first_port(probe_lib, precision):
    """ivf_probe_topk_plain + K1c = the JAX ``_ivf_probe_topk`` and the
    first port's every-slot probe + K1c, bit for bit, at k < cap, k = cap
    and k > cap, with an emptied bucket and a max_distance cut."""
    nprobe = 3
    q = probe_lib["q"]
    assert_no_probe_ties(q, probe_lib["cents"], nprobe)
    jidx = jivf.build_ivf(probe_lib["rows"], probe_lib["valid"], probe_lib["cents"], bucket_cap=96,
                          precision=precision)
    tidx = tivf.ivf_from_jax(as_np(jidx), device="cpu")
    qt = torch.from_numpy(q)
    bids = tivf.probe_order(qt, tidx.centroids, nprobe)
    fill = tidx.bucket_valid.sum(1)
    assert int(fill.max()) == 96 and 0 < int(fill.min()) < 96 and tidx.spill_count > 0
    empty = int(bids[-1, 1])  # a probed bucket, emptied
    tidx = tidx._replace(bucket_valid=tidx.bucket_valid.index_fill(0, torch.tensor([empty]), False))
    jidx = jidx._replace(bucket_valid=jnp.asarray(tidx.bucket_valid.numpy()))
    assert torch.bincount(bids.flatten().long()).max() > tivf.IVF_PROBE_NQ
    prep = tfs._prep(qt)
    for k, md in ((10, 1e3), (10, 0.02), (96, 1e3), (120, 0.05)):
        args = (*prep, md, bids, tidx.bucket_data, tidx.bucket_sum, tidx.bucket_mag2,
                tidx.bucket_rows, tidx.bucket_valid)
        d, i = tivf.ivf_probe_topk(*args, k)
        kp = min(k, 96)
        assert d.shape == (len(q), nprobe, kp)
        got = tfs.lex_topk(d.reshape(len(q), -1), i.reshape(len(q), -1), k)
        old = tivf.ivf_probe_collect_plain(*args)
        want = tfs.lex_topk(*old, k)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        jd, ji = (np.asarray(x) for x in jivf._ivf_probe_topk(q, jidx, k, nprobe, md))
        ji = np.where(np.isfinite(jd), ji, -1)
        assert np.array_equal(got[0].numpy(), jd) and np.array_equal(got[1].numpy(), ji)
        if kp < 96:  # the selected entries: (dist, row id) keys in slot order, then empties
            live = i != 2 ** 31 - 1
            assert torch.equal(live, torch.isfinite(d))
            assert bool((live[..., 1:] <= live[..., :-1]).all())
            assert not bool(live[-1, 1].any())
        assert bool(torch.isfinite(got[0]).any())


def test_probe_work_list_covers_each_pair_once():
    """ivf_probe_invert: every (query, probe) pair in exactly one work item,
    items grouped by bucket in bucket order (ids outside [0, C) last, as
    bucket -1), at most IVF_PROBE_NQ pairs an item, all but a bucket's last
    item full."""
    nq = tivf.IVF_PROBE_NQ
    rng = np.random.default_rng(3)
    c = 7
    bids = rng.integers(0, c, (13, 5)).astype(np.int32)
    bids[:11, 0] = 2  # one bucket probed by 11 queries
    bids[4, 3], bids[9, 1] = -1, c
    work = tivf.ivf_probe_invert(torch.from_numpy(bids), c)
    n = int(work[0])
    recs = work[1:].reshape(-1, 1 + nq)[:n].numpy()
    flat = bids.reshape(-1)
    slot = np.where((flat >= 0) & (flat < c), flat, c)
    counts = np.bincount(slot, minlength=c + 1)
    assert n == int(((counts + nq - 1) // nq).sum())
    pairs = recs[:, 1:]
    lens = (pairs >= 0).sum(1)
    assert (lens >= 1).all() and (lens <= nq).all()
    assert sorted(pairs[pairs >= 0].tolist()) == list(range(flat.size))
    for rec, ln in zip(recs, lens):
        assert (pairs_of := rec[1 : 1 + ln]).size == ln and (rec[1 + ln :] == -1).all()
        assert all(slot[j] == (rec[0] if rec[0] >= 0 else c) for j in pairs_of)
    order = np.where(recs[:, 0] >= 0, recs[:, 0], c)
    assert (np.diff(order) >= 0).all()
    for b in range(c + 1):
        ln = lens[order == b]
        assert ln.sum() == counts[b] and (ln[:-1] == nq).all()
    buckets, got_lens, pb = tivf.probe_work_pairs(work)
    assert np.array_equal(buckets.numpy(), recs[:, 0]) and np.array_equal(got_lens.numpy(), lens)
    assert pb.shape == (flat.size, 2) and bool((pb[1:, 0] >= pb[:-1, 0]).all())


def _select_bins_model(bits, rows, kp):
    """The tensor-core K5's per-(query, bucket) select (``csrc/ivf_probe.cu``
    ``select_bins``), step for step: the passing keys' distance bits
    (0xffffffff where the slot did not pass) and row ids; returns the mask
    of the k' keys it takes (its path for many copies of one distance, the
    radix select of 64-bit keys, as the sort that it equals)."""
    live = bits != 0xFFFFFFFF
    keys = (bits << 32) | rows
    take = live.copy()
    if int(live.sum()) <= kp:
        return take
    lo, hi = int(bits[live].min()), int(bits[live].max())
    base, width = lo, hi - lo + 1
    sh = max(0, int(width - 1).bit_length() - 8)

    def digit(i):
        off = int(bits[i]) - base
        return off >> sh if live[i] and 0 <= off < width else -1

    r = kp
    while True:
        dg = np.array([digit(i) for i in range(len(bits))])
        hist = np.bincount(dg[dg >= 0], minlength=256)
        cum = np.cumsum(hist)
        kbin = int(np.searchsorted(cum, r))
        r, m = r - int(cum[kbin] - hist[kbin]), int(hist[kbin])
        if r == m:
            tau = None
            break
        if m <= 32:
            tau = np.sort(keys[dg == kbin])[r - 1]
            break
        if sh == 0:  # ties: the radix select of the 64-bit keys
            take[:] = False
            idx = np.flatnonzero(live)
            take[idx[np.argsort(keys[idx])[:kp]]] = True
            return take
        base += kbin << sh
        width, sh = 1 << sh, max(0, sh - 8)
    for i in np.flatnonzero(live):
        d = digit(i)
        take[i] = bits[i] < base or 0 <= d < kbin or (d == kbin and (tau is None or keys[i] <= tau))
    return take


def test_probe_select_model_matches_sort():
    """The kernel's select, modelled: the k' smallest (dist, row id) keys of
    a bucket, as a sort gives them — with far distances (up to
    max_distance), ties on one distance (more than a bin's 32 keys), zero
    distances and filtered slots."""
    rng = np.random.default_rng(11)
    for trial in range(60):
        cap = int(rng.choice([64, 96, 160, 512]))
        kp = int(rng.integers(1, cap))
        dist = rng.gamma(2.0, 0.3, cap).astype(np.float32)
        if trial % 3 == 0:
            dist[rng.integers(0, cap, 5)] = rng.uniform(100, 999, 5).astype(np.float32)
        if trial % 4 == 0:
            dist[rng.integers(0, cap, cap // 3)] = np.float32(0.5)
        if trial % 5 == 0:
            dist[:] = np.float32(0.25)
        if trial % 7 == 0:
            dist[rng.integers(0, cap, 3)] = 0.0
        bits = dist.view(np.uint32).astype(np.int64)
        bits[rng.uniform(size=cap) < 0.3] = 0xFFFFFFFF
        rows = rng.permutation(1 << 20)[:cap].astype(np.int64)
        keys = (bits << 32) | rows
        want = np.zeros(cap, dtype=bool)
        live = np.flatnonzero(bits != 0xFFFFFFFF)
        want[live[np.argsort(keys[live])[:kp]]] = True
        assert np.array_equal(_select_bins_model(bits, rows, kp), want), trial


def test_probe_width():
    assert tivf.probe_width(100, 512, 128, False) == 100
    assert tivf.probe_width(100, 512, 128, True) == 100
    assert tivf.probe_width(700, 512, 64, False) == 512
    assert tivf.probe_width(100, 512, 48, False) == 512   # the first port's width: every slot
    assert tivf.probe_width(100, 512, 32, True) == 512
    assert tivf.probe_width(100, 510, 128, False) == 510  # a cap the kernel's 16-byte copies do not take
    assert tivf.probe_width(100, tivf.IVF_SELECT_MAX_CAP + 8, 128, False) == tivf.IVF_SELECT_MAX_CAP + 8
    assert tivf.tc_probe_width(128, False, tivf.IVF_TC_MAX_CAP)
    assert not tivf.tc_probe_width(128, False, tivf.IVF_TC_MAX_CAP + 8)


# --------------------------------------------------------------------- #
# k past 1,024: every auto scan answers what the JAX package answers


def _u8_index(rows):
    data, s, m = semantic_rows_from_u8(rows)
    valid = np.ones(len(rows), dtype=bool)
    valid[::97] = False
    return (JSem(*(jnp.asarray(x) for x in (data, s, m, valid))),
            PackedSemanticIndex(*(torch.from_numpy(x) for x in (data, s, m, valid))))


@pytest.mark.parametrize("block_rows", [2048, 32768], ids=["threshold", "exact"])
def test_u8_auto_k1500_matches_jax(block_rows):
    rng = np.random.default_rng(21)
    rows = rng.integers(0, 256, (16384, D), dtype=np.uint8)
    jidx, tidx = _u8_index(rows)
    q = rows[rng.integers(0, 16384, 3)]
    same(tscan.cosine_scan_topk_auto(torch.from_numpy(q), tidx, k=1500, block_rows=block_rows),
         jscan.cosine_scan_topk_auto(jnp.asarray(q), jidx, k=1500, block_rows=block_rows))


@pytest.mark.parametrize("user_k", [300, 1100])
@pytest.mark.parametrize("block_rows", [2048, 32768], ids=["threshold", "exact"])
def test_int4_rerank_large_user_k_matches_jax(user_k, block_rows):
    rng = np.random.default_rng(22)
    rows = rng.integers(0, 256, (16384, D), dtype=np.uint8)
    data, s, m = tint4.semantic4_rows_from_u8(rows)
    valid = np.ones(len(rows), dtype=bool)
    jidx = jint4.PackedSemantic4Index(*(jnp.asarray(x) for x in (data, s, m, valid)))
    tidx = tint4.PackedSemantic4Index(*(torch.from_numpy(x) for x in (data, s, m, valid)))
    q = rows[rng.integers(0, 16384, 2)]

    def tscan4(c, md):
        d, i = tint4.cosine4_scan_topk_auto(torch.from_numpy(q), tidx, k=c, max_distance=md,
                                            block_rows=block_rows)
        return d.numpy(), i.numpy()

    def jscan4(c, md):
        return jint4.cosine4_scan_topk_auto(jnp.asarray(q), jidx, k=c, max_distance=md,
                                            block_rows=block_rows)

    same(tint4.scan_with_u8_rerank(tscan4, q, rows, k=user_k),
         jint4.scan_with_u8_rerank(jscan4, q, rows, k=user_k))


@pytest.mark.parametrize("block_rows", [2048, 32768], ids=["threshold", "exact"])
def test_phash_auto_k1500_matches_jax(block_rows):
    rng = np.random.default_rng(23)
    rows = rng.integers(0, 256, (16384, 32), dtype=np.uint8)
    valid = np.ones(len(rows), dtype=bool)
    jidx = jhg.build_hamming_gemm_index(JHam(jnp.asarray(rows), jnp.asarray(valid)))
    tidx = PackedHammingIndex(torch.from_numpy(rows), torch.from_numpy(valid))
    q = rows[rng.integers(0, 16384, 3)]
    same(thg.hamming_gemm_scan_topk_auto(torch.from_numpy(q), tidx, k=1500, block_rows=block_rows),
         jhg.hamming_gemm_scan_topk_auto(jnp.asarray(q), jidx, k=1500, block_rows=block_rows))
