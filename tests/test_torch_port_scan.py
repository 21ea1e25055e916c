"""pixelbox_tpu_torch scans vs pixelbox_tpu scans on the CPU.

The same numpy-seeded index and queries go through the JAX package (its
XLA scans, and its Pallas kernels in interpret mode as
tests/test_pallas_scan.py runs them) and through the port, whose kernel
wrappers take their plain PyTorch versions for CPU tensors.  Final
(dist, idx) outputs are compared bit for bit; every port query flagged
exact must equal the exact scan.  The port's flags need not equal the TPU
carry kernel's: the designs differ, only soundness is required.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pixelbox_tpu.ops import oracle
from pixelbox_tpu.ops import pallas_scan as jps
from pixelbox_tpu.ops import scan as jscan
from pixelbox_tpu.ops.packed import PackedSemanticIndex as JIndex
from pixelbox_tpu_torch.ops import fused_scan as fs
from pixelbox_tpu_torch.ops import scan as tscan
from pixelbox_tpu_torch.ops.packed import PackedSemanticIndex as TIndex
from pixelbox_tpu_torch.ops.packed import semantic_rows_from_u8


def clustered(rng, n, d=128, centers=64, noise=0.35):
    c = rng.standard_normal((centers, d)).astype(np.float32)
    x = c[rng.integers(0, centers, n)] + noise * rng.standard_normal((n, d)).astype(np.float32)
    return oracle.quantize_embedding_np(np.tanh(x))


def both_indexes(db, valid=None):
    data, rs, rm = semantic_rows_from_u8(db)
    valid = np.ones(len(db), bool) if valid is None else valid
    j = JIndex(jnp.asarray(data), jnp.asarray(rs), jnp.asarray(rm), jnp.asarray(valid))
    t = TIndex(*(torch.from_numpy(np.ascontiguousarray(x)) for x in (data, rs, rm, valid)))
    return j, t


def queries_for(rng, db, qn):
    q = db[rng.integers(0, len(db), qn)].astype(np.int32)
    q[:, :6] = np.clip(q[:, :6] + rng.integers(-40, 41, (qn, 6)), 0, 255)
    return q.astype(np.uint8)


def assert_same(got, want):
    gd, gi = (np.asarray(x) for x in got)
    wd, wi = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(gi, wi)
    assert np.array_equal(gd.view(np.uint32), wd.astype(np.float32).view(np.uint32))


def oracle_masked(q, db, valid, k, md=1e3):
    keep = np.nonzero(valid)[0]
    od, oi = oracle.cosine_scan_topk_np(q, db[keep], k=k, max_distance=md)
    return od, np.where(oi >= 0, keep[np.maximum(oi, 0)], -1).astype(np.int32)


@pytest.mark.parametrize("md", [1e3, 0.3], ids=["unfiltered", "max_distance"])
def test_exact_scan_vs_jax(rng, md):
    db = clustered(rng, 4096)
    valid = rng.uniform(size=4096) > 0.02
    ji, ti = both_indexes(db, valid)
    q = queries_for(rng, db, 5)
    want = jscan.cosine_scan_topk(jnp.asarray(q), ji, k=40, max_distance=md, block_rows=1024)
    got = tscan.cosine_scan_topk(torch.from_numpy(q), ti, k=40, max_distance=md, block_rows=1024)
    assert_same(got, want)
    assert_same(got, oracle_masked(q, db, valid, 40, md))


def test_fused_threshold_and_repair_vs_pallas_interpret(rng):
    """Port threshold (plain K1a/K1c) + repair (plain K1b/K1c) vs the JAX
    carry kernels v2 + pallas_cosine_scan_topk in interpret mode."""
    n, k = 8192, 20
    db = clustered(rng, n)
    db[1000:1300] = db[77]  # a tie flood
    ji, ti = both_indexes(db)
    q = queries_for(rng, db, 16)
    q[0] = db[77]
    jmeta = jps.build_row_meta(ji)
    jsample = jscan.build_scan_sample(ji, sample_rows=2048)
    with pltpu.force_tpu_interpret_mode():
        jd, jid, jex = jps.pallas_threshold_scan_topk_v2(
            jnp.asarray(q), ji, jmeta, jsample, k=k, tile_rows=2048
        )
        rd, ri = jps.pallas_cosine_scan_topk(jnp.asarray(q), ji, jmeta, k=k, tile_rows=2048)
    jd, jid = np.asarray(jd).copy(), np.asarray(jid).copy()
    bad = ~np.asarray(jex)
    jd[bad], jid[bad] = np.asarray(rd)[bad], np.asarray(ri)[bad]

    tmeta = fs.build_row_meta(ti)
    np.testing.assert_array_equal(tmeta.numpy(), np.asarray(jmeta))
    tsample = tscan.build_scan_sample(ti, sample_rows=2048)
    td, tid, tex = fs.fused_threshold_scan_topk(torch.from_numpy(q), ti, tmeta, tsample, k=k)
    exact_d, exact_i = tscan.cosine_scan_topk(torch.from_numpy(q), ti, k=k)
    ok = tex.numpy()
    assert not ok[0], "the tie flood must defeat the proof"
    assert_same((td.numpy()[ok], tid.numpy()[ok]), (exact_d.numpy()[ok], exact_i.numpy()[ok]))
    fd, fi = fs.fused_cosine_scan_topk(torch.from_numpy(q), ti, tmeta, k=k)
    assert_same((fd, fi), (exact_d, exact_i))
    repaired = tscan.repair_unproven(
        torch.from_numpy(q), td, tid, tex,
        lambda rq: fs.fused_cosine_scan_topk(rq, ti, tmeta, k=k),
    )
    assert_same(repaired, (jd, jid))
    assert_same(repaired, oracle.cosine_scan_topk_np(q, db, k=k))
    assert repaired[1][0].tolist() == [77] + list(range(1000, 1000 + k - 1))


@pytest.mark.parametrize(
    "case", ["plain", "invalid_rows", "max_distance", "tie_flood"]
)
def test_auto_vs_jax_at_262144_rows(rng, case):
    n, k = 262144, 100
    db = clustered(rng, n, centers=512)
    valid = np.ones(n, bool)
    md = 1e3
    q = queries_for(rng, db, 8)
    if case == "invalid_rows":
        valid[rng.choice(n, n // 100, replace=False)] = False
        q[1] = db[4242]
        valid[4242] = False
    elif case == "max_distance":
        md = 0.05
    elif case == "tie_flood":
        db[100000:104096] = db[31337]
        q[0] = db[31337]
    ji, ti = both_indexes(db, valid)
    want = jscan.cosine_scan_topk_auto(jnp.asarray(q), ji, k=k, max_distance=md)
    got = tscan.cosine_scan_topk_auto(torch.from_numpy(q), ti, k=k, max_distance=md)
    assert_same(got, want)
    assert_same(got, tscan.cosine_scan_topk(torch.from_numpy(q), ti, k=k, max_distance=md))
    od, oi = oracle_masked(q[:2], db, valid, k, md)
    assert_same((got[0][:2], got[1][:2]), (od, oi))
    if case == "tie_flood":
        assert got[1][0].tolist() == [31337] + list(range(100000, 100000 + k - 1))


def test_large_batch_q1056_vs_exact(rng):
    n, k = 16384, 10
    db = clustered(rng, n)
    _, ti = both_indexes(db)
    q = torch.from_numpy(queries_for(rng, db, 1056))
    meta = fs.build_row_meta(ti)
    d, i, ex = fs.fused_threshold_scan_topk(q, ti, meta, tscan.build_scan_sample(ti, 4096), k=k)
    ed, ei = tscan.cosine_scan_topk(q, ti, k=k)
    assert bool(ex.any())
    assert_same((d[ex], i[ex]), (ed[ex], ei[ex]))
    got = tscan.cosine_scan_topk_auto(q, ti, k=k, block_rows=1024)
    assert_same(got, (ed, ei))


def test_kernel_plain_versions_agree_on_cpu(rng):
    """The three kernel wrappers take their plain versions for CPU tensors
    (no launch counted); K1a's count is exact past its capacity."""
    db = clustered(rng, 4096)
    _, ti = both_indexes(db)
    meta = fs.build_row_meta(ti)
    q = torch.from_numpy(queries_for(rng, db, 3))
    qc, qs, qm, qr = fs._prep(q)
    fs.reset_launch_counts()
    theta = torch.tensor([0.0, 0.5, float("inf")], dtype=torch.float32)
    count, cd, ci = fs.cosine_threshold_collect(qc, qs, qm, qr, theta, ti.data, meta, 64)
    assert count.tolist()[0] == 0 and count.tolist()[2] == 4096
    assert (ci[2] == torch.arange(64, dtype=torch.int32)).all()
    pd, pi = fs.cosine_chunk_topk(qc, qs, qm, qr, 1e3, ti.data, meta, 7)
    assert tuple(pd.shape) == (3, -(-4096 // fs.cosine_chunk_rows(ti.data.shape[1], 4096, 7)), 7)
    d, i = fs.lex_topk(pd.reshape(3, -1), pi.reshape(3, -1), 7)
    assert_same((d, i), tscan.cosine_scan_topk(q, ti, k=7))
    assert fs.launch_counts() == {n: 0 for n in fs.LAUNCHES}
