"""pixelbox_tpu_torch's CUDA kernels vs their plain PyTorch versions.

These tests need a CUDA card (the kernels have no CPU mode): they carry
the ``cuda`` marker and skip without a card.  The file imports neither
jax nor pixelbox_tpu and uses no conftest fixture, so on a machine with
a card and without jax it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q
"""

import numpy as np
import pytest
import torch

from pixelbox_tpu_torch.ops import fused_scan as fs
from pixelbox_tpu_torch.ops import hamming_gemm as hg
from pixelbox_tpu_torch.ops import int4
from pixelbox_tpu_torch.ops import scan as tscan
from pixelbox_tpu_torch.ops.oracle import quantize_embedding_np
from pixelbox_tpu_torch.ops.packed import (
    PackedHammingIndex,
    PackedSemanticIndex,
    semantic_rows_from_u8,
)

pytestmark = pytest.mark.cuda


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _index(n, d, seed, dev):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((64, d)).astype(np.float32)
    x = c[rng.integers(0, 64, n)] + 0.35 * rng.standard_normal((n, d)).astype(np.float32)
    db = quantize_embedding_np(np.tanh(x))
    data, rs, rm = semantic_rows_from_u8(db)
    valid = rng.uniform(size=n) > 0.01
    idx = PackedSemanticIndex(*(torch.from_numpy(v).to(dev) for v in (data, rs, rm, valid)))
    q = db[rng.integers(0, n, 40)]
    return idx, torch.from_numpy(q).to(dev)


@pytest.mark.parametrize("dim", [8, 36, 128], ids=["d8_bytes", "d36_words", "d128_vec16"])
def test_kernels_match_plain(dim):
    dev = _card()
    idx, q = _index(65536, dim, seed=dim, dev=dev)
    meta = fs.build_row_meta(idx)
    qc, qs, qm, qr = fs._prep(q)
    got = fs.cosine_chunk_topk(qc, qs, qm, qr, 1e3, idx.data, meta, 50)
    want = fs.cosine_chunk_topk_plain(qc, qs, qm, qr, 1e3, idx.data, meta, 50)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    flat = (got[0].reshape(40, -1), got[1].reshape(40, -1), 50)
    for g, w in zip(fs.lex_topk_segments(*flat), fs.lex_topk_segments_plain(*flat)):
        assert torch.equal(g, w)
    theta = torch.full((40,), 0.2, device=dev)
    c1, d1, i1 = fs.cosine_threshold_collect(qc, qs, qm, qr, theta, idx.data, meta, 4096)
    c2, d2, i2 = fs.cosine_threshold_collect_plain(qc, qs, qm, qr, theta, idx.data, meta, 4096)
    assert torch.equal(c1, c2)
    lens = torch.clamp(c1, max=4096)
    s1 = fs.lex_topk_segments_plain(d1, i1, 4096, lens, segment=4096)
    s2 = fs.lex_topk_segments_plain(d2, i2, 4096, lens, segment=4096)
    ok = c1 <= 4096
    assert torch.equal(s1[0][ok], s2[0][ok]) and torch.equal(s1[1][ok], s2[1][ok])


def test_main_path_goes_through_the_kernels():
    dev = _card()
    idx, q = _index(262144, 128, seed=1, dev=dev)
    fs.reset_launch_counts()
    got = tscan.cosine_scan_topk_auto(q, idx, k=100)
    counts = fs.launch_counts()
    assert counts["cosine_threshold_collect"] > 0 and counts["lex_topk_select"] > 0
    cpu = PackedSemanticIndex(*(t.cpu() for t in idx))
    want = tscan.cosine_scan_topk_auto(q.cpu(), cpu, k=100)
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    fused = fs.fused_cosine_scan_topk(q, idx, fs.build_row_meta(idx), k=100)
    assert fs.launch_counts()["cosine_chunk_topk"] > 0
    assert torch.equal(fused[0].cpu(), want[0]) and torch.equal(fused[1].cpu(), want[1])


def test_wrappers_reject_bad_inputs():
    dev = _card()
    idx, q = _index(4096, 128, seed=2, dev=dev)
    meta = fs.build_row_meta(idx)
    qc, qs, qm, qr = fs._prep(q)
    with pytest.raises(ValueError, match="device|on"):
        fs.cosine_chunk_topk(qc.cpu(), qs, qm, qr, 1e3, idx.data, meta, 10)
    with pytest.raises(ValueError, match="contiguous"):
        fs.cosine_chunk_topk(qc, qs, qm, qr, 1e3, idx.data, meta.t().contiguous().t(), 10)
    with pytest.raises(ValueError, match="exceeds"):
        fs.cosine_chunk_topk(qc, qs, qm, qr, 1e3, idx.data, meta, fs.MAX_K + 1)


def _phash_index(n, h, seed, dev):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (256, h), dtype=np.uint8)
    noise = rng.integers(0, 256, (n, h), dtype=np.uint8) & rng.integers(0, 256, (n, h), dtype=np.uint8)
    db = base[rng.integers(0, 256, n)] ^ (noise & rng.integers(0, 256, (n, h), dtype=np.uint8))
    valid = rng.uniform(size=n) > 0.01
    idx = PackedHammingIndex(torch.from_numpy(db).to(dev), torch.from_numpy(valid).to(dev))
    q = db[rng.integers(0, n, 40)]
    q[1] = ~db[7]  # every bit differs: 8*h bits, wraps under wrap_u8 for h >= 32
    return idx, torch.from_numpy(q).to(dev)


@pytest.mark.parametrize(
    "h,limit,wrap",
    [(32, 32, False), (32, 24, False), (32, 32, True), (18, 18, False), (24, 18, True)],
    ids=["h32", "h32_limit24", "h32_wrap", "h18_bytes", "h24_limit18_wrap"],
)
def test_hamming_kernels_match_plain(h, limit, wrap):
    dev = _card()
    idx, q = _phash_index(65536, h, seed=h + limit, dev=dev)
    group = torch.arange(65536, device=dev) % 3 != 0
    meta = fs.build_hamming_meta(idx, group)
    got = fs.hamming_chunk_topk(q, 0.45, idx.data, meta, limit, wrap, 50)
    want = fs.hamming_chunk_topk_plain(q, 0.45, idx.data, meta, limit, wrap, 50)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    theta = torch.full((40,), 0.3, device=dev)
    c1, d1, i1 = fs.hamming_threshold_collect(q, theta, idx.data, meta, limit, wrap, 4096)
    c2, d2, i2 = fs.hamming_threshold_collect_plain(q, theta, idx.data, meta, limit, wrap, 4096)
    assert torch.equal(c1, c2)
    lens = torch.clamp(c1, max=4096)
    s1 = fs.lex_topk_segments_plain(d1, i1, 4096, lens, segment=4096)
    s2 = fs.lex_topk_segments_plain(d2, i2, 4096, lens, segment=4096)
    ok = c1 <= 4096
    assert torch.equal(s1[0][ok], s2[0][ok]) and torch.equal(s1[1][ok], s2[1][ok])


def test_hamming_main_path_goes_through_the_kernels():
    dev = _card()
    idx, q = _phash_index(262144, 32, seed=3, dev=dev)
    fs.reset_launch_counts()
    got = hg.hamming_gemm_scan_topk_auto(q, idx, k=100)
    assert fs.launch_counts()["hamming_threshold_collect"] > 0
    cpu = PackedHammingIndex(*(t.cpu() for t in idx))
    want = tscan.hamming_scan_topk(q.cpu(), cpu, k=100)
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    exact = hg.hamming_gemm_scan_topk(q, idx, k=100)
    assert fs.launch_counts()["hamming_chunk_topk"] > 0
    assert torch.equal(exact[0].cpu(), want[0]) and torch.equal(exact[1].cpu(), want[1])


def _int4_index(n, d, seed, dev):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((64, d)).astype(np.float32)
    x = c[rng.integers(0, 64, n)] + 0.35 * rng.standard_normal((n, d)).astype(np.float32)
    db = quantize_embedding_np(np.tanh(x))
    idx = int4.build_semantic4_index(db, block_rows=1024, device=dev)
    valid = torch.from_numpy(rng.uniform(size=idx.capacity) > 0.01).to(dev) & idx.valid
    q = db[rng.integers(0, n, 40)]
    q[3] = db[11]
    return idx._replace(valid=valid), torch.from_numpy(q).to(dev)


@pytest.mark.parametrize("mode", ["asym", "sym"])
@pytest.mark.parametrize("dim", [36, 40, 128], ids=["d36_bytes", "d40_words", "d128_vec16"])
def test_int4_kernels_match_plain(dim, mode):
    dev = _card()
    idx, q = _int4_index(65536, dim, seed=dim, dev=dev)
    meta = int4.build_semantic4_meta(idx)
    qk = fs.Int4Queries.from_u8(q, mode)
    args = (qk.q_codes, qk.q_sum, qk.q_mag2, qk.qr)
    for k in (50, 400):
        got = fs.cosine4_chunk_topk(*args, 1e3, idx.data, meta, qk.sym, k)
        want = fs.cosine4_chunk_topk_plain(*args, 1e3, idx.data, meta, qk.sym, k)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    theta = torch.full((40,), 0.2, device=dev)
    c1, d1, i1 = fs.cosine4_threshold_collect(*args, theta, idx.data, meta, qk.sym, 4096)
    c2, d2, i2 = fs.cosine4_threshold_collect_plain(*args, theta, idx.data, meta, qk.sym, 4096)
    assert torch.equal(c1, c2)
    lens = torch.clamp(c1, max=4096)
    s1 = fs.lex_topk_segments_plain(d1, i1, 4096, lens, segment=4096)
    s2 = fs.lex_topk_segments_plain(d2, i2, 4096, lens, segment=4096)
    ok = c1 <= 4096
    assert torch.equal(s1[0][ok], s2[0][ok]) and torch.equal(s1[1][ok], s2[1][ok])


@pytest.mark.parametrize("mode", ["asym", "sym"])
def test_int4_main_path_goes_through_the_kernels(mode):
    dev = _card()
    idx, q = _int4_index(262144, 128, seed=5, dev=dev)
    fs.reset_launch_counts()
    got = int4.cosine4_scan_topk_auto(q, idx, k=400, max_distance=int4.UNBOUNDED_DISTANCE, query_mode=mode)
    counts = fs.launch_counts()
    assert counts["cosine4_threshold_collect"] > 0 and counts["lex_topk_select"] > 0
    cpu = int4.PackedSemantic4Index(*(t.cpu() for t in idx))
    exact = int4.cosine4a_scan_topk if mode == "asym" else int4.cosine4_scan_topk
    want = exact(q.cpu(), cpu, k=400, max_distance=int4.UNBOUNDED_DISTANCE)
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    fused = fs.fused_cosine4_scan_topk(q, idx, int4.build_semantic4_meta(idx), k=100, query_mode=mode)
    assert fs.launch_counts()["cosine4_chunk_topk"] > 0
    want = exact(q.cpu(), cpu, k=100)
    assert torch.equal(fused[0].cpu(), want[0]) and torch.equal(fused[1].cpu(), want[1])


def _key_collect_matches_plain(c1, k1, i1, c2, k2, i2, cap):
    """Counts equal; the collected (key, row) pairs equal as sets (atomic
    slot order on the card) wherever the buffer did not overflow."""
    assert torch.equal(c1, c2)
    for r in range(c1.shape[0]):
        n = int(c1[r])
        if n > cap:
            continue
        o1, o2 = torch.argsort(i1[r, :n]), torch.argsort(i2[r, :n])
        assert torch.equal(i1[r, :n][o1], i2[r, :n][o2])
        assert torch.equal(k1[r, :n][o1].view(torch.int32), k2[r, :n][o2].view(torch.int32))


@pytest.mark.parametrize("kind", ["cosine", "cosine4a", "cosine4"])
@pytest.mark.parametrize("dim", [36, 128], ids=["d36", "d128_vec16"])
def test_coskey_kernels_match_plain(kind, dim):
    """K1d / K4d keys and counts, and K1e's rescored distances, bit for bit
    against their plain versions; K1e's distances equal K1a's / K4a's."""
    dev = _card()
    if kind == "cosine":
        idx, q = _index(65536, dim, seed=dim + 1, dev=dev)
        meta = fs.build_row_meta(idx)
        qk = fs.CosineQueries.from_u8(q)
    else:
        idx, q = _int4_index(65536, dim, seed=dim + 2, dev=dev)
        meta = int4.build_semantic4_meta(idx)
        qk = fs.Int4Queries.from_u8(q, "sym" if kind == "cosine4" else "asym")
    args = (qk.q_codes, qk.q_sum, qk.q_mag2, qk.qr)
    theta = torch.full((40,), 0.2, device=dev)
    theta[5] = 1e7  # saturated: every valid row passes the key filter
    key = fs.cos_key_threshold(theta)
    cap = 4096
    if kind == "cosine":
        got = fs.cosine_coskey_collect(*args, key, idx.data, meta, cap)
        want = fs.cosine_coskey_collect_plain(*args, key, idx.data, meta, cap)
    else:
        got = fs.cosine4_coskey_collect(*args, key, idx.data, meta, qk.sym, cap)
        want = fs.cosine4_coskey_collect_plain(*args, key, idx.data, meta, qk.sym, cap)
    _key_collect_matches_plain(*got, *want, cap)
    assert int(got[0][5]) > cap  # the saturated query overflows
    lens = torch.clamp(got[0], max=cap)
    out = fs.coskey_rescore(*args, theta, idx.data, meta, kind, lens, got[2])
    plain = fs.coskey_rescore_plain(*args, theta, idx.data, meta, kind, lens, got[2])
    assert torch.equal(out, plain)
    d_key = fs.lex_topk(out, got[2], 100, lens=lens)
    d_dist = qk.collect(theta, idx.data, meta, cap)
    d_dist = fs.lex_topk(d_dist[1], d_dist[2], 100, lens=torch.clamp(d_dist[0], max=cap))
    ok = got[0] <= cap
    assert torch.equal(d_key[0][ok], d_dist[0][ok]) and torch.equal(d_key[1][ok], d_dist[1][ok])


@pytest.mark.parametrize("kind", ["cosine", "cosine4a", "cosine4"])
def test_coskey_main_path_goes_through_the_kernels(kind):
    dev = _card()
    if kind == "cosine":
        idx, q = _index(262144, 128, seed=9, dev=dev)
        auto = lambda qq, ii, **kw: tscan.cosine_scan_topk_auto(qq, ii, k=100, **kw)  # noqa: E731
        exact = tscan.cosine_scan_topk
        cpu = PackedSemanticIndex(*(t.cpu() for t in idx))
        collect = "cosine_coskey_collect"
    else:
        idx, q = _int4_index(262144, 128, seed=10, dev=dev)
        mode = "sym" if kind == "cosine4" else "asym"
        auto = lambda qq, ii, **kw: int4.cosine4_scan_topk_auto(qq, ii, k=100, query_mode=mode, **kw)  # noqa: E731
        exact = int4.cosine4_scan_topk if mode == "sym" else int4.cosine4a_scan_topk
        cpu = int4.PackedSemantic4Index(*(t.cpu() for t in idx))
        collect = "cosine4_coskey_collect"
    fs.reset_launch_counts()
    got = auto(q, idx, epilogue="cos")
    counts = fs.launch_counts()
    assert counts[collect] > 0 and counts["coskey_rescore"] > 0
    want = exact(q.cpu(), cpu, k=100)
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    plain = auto(q.cpu(), cpu, epilogue="cos")
    assert torch.equal(plain[0], want[0]) and torch.equal(plain[1], want[1])


# --------------------------------------------------------------------- #
# Mesh serving (row 8) and the breakdown ladder (row 9)


def test_sharded_auto_on_the_card_matches_one_device():
    """Four shards on the visible cards (all on cuda:0 with one card):
    per-shard θ kernel + K1a + K1c and the K1c merge give the one-device
    results."""
    from pixelbox_tpu_torch.parallel import sharded_scan as ss
    from pixelbox_tpu_torch.parallel.mesh import make_mesh

    dev = _card()
    idx, q = _index(1 << 19, 64, seed=11, dev=dev)
    mesh = make_mesh(4)
    mirror = ss.shard_semantic_index(idx, mesh)
    assert mirror.local_rows == 1 << 17  # past the 4·block_rows gate at block_rows 16,384
    fs.reset_launch_counts()
    got = ss.sharded_cosine_scan_topk_auto(q, mirror, mesh, k=50, block_rows=16384)
    counts = fs.launch_counts()
    assert counts["sample_theta"] >= 4 and counts["cosine_threshold_collect"] >= 4
    assert counts["lex_topk_select"] >= 5
    want = tscan.cosine_scan_topk(q, idx, k=50)
    assert torch.equal(got[0].cpu(), want[0].cpu()) and torch.equal(got[1].cpu(), want[1].cpu())
    ph = PackedHammingIndex(idx.data.view(torch.uint8)[:, :32].contiguous(), idx.valid)
    hq = q[:, :32].contiguous()  # u8 rows and queries as 32-byte hashes
    got = ss.sharded_hamming_scan_topk(hq, ss.shard_hamming_index(ph, mesh), mesh, k=20)
    want = hg.hamming_gemm_scan_topk(hq, ph, k=20)
    assert torch.equal(got[0].cpu(), want[0].cpu()) and torch.equal(got[1].cpu(), want[1].cpu())


@pytest.mark.parametrize("tile,qn", [(4096, 40), (8192, 300), (1024, 8)])
@pytest.mark.parametrize("rung", ["gemm", "coskey", "epilogue", "chain"])
def test_ladder_rungs_match_plain(rung, tile, qn):
    """The tensor-core ladder against its plain version at tiles of 32, 64
    and 8 registers (2, 1 and 8 lanes a sub-tile) and a query count past a
    query tile (300: two tiles of 256); one launch counted a call, none
    under the first port's ladder.  At the timed tile (8,192 rows) the
    first port's ladder, the timing reference, returns the same outputs
    (its launch counted apart)."""
    from pixelbox_tpu_torch.ops.packed import query_moments_from_u8
    from pixelbox_tpu_torch.tools import measure_breakdown as mb

    dev = _card()
    q, idx, meta = mb.ladder_inputs(1 << 16, 128, qn, seed=3, planted=True, device=dev)
    mom = query_moments_from_u8(q[0])
    before = dict(mb.LAUNCHES)
    out, dsum = mb.ladder(rung, *mom, idx.data, meta, tile)
    torch.cuda.synchronize()
    assert mb.LAUNCHES["breakdown_ladder"] == before["breakdown_ladder"] + 1
    assert mb.LAUNCHES["breakdown_ladder_dp4a"] == before["breakdown_ladder_dp4a"]
    pout, psum = mb.ladder_plain(rung, *mom, idx.data, meta, tile)
    assert torch.equal(out.view(torch.int32), pout.view(torch.int32)) and torch.equal(dsum, psum)
    lanes = out if rung in ("gemm", "chain") else out[:, :1]
    assert bool(torch.isfinite(lanes).all())
    if tile == mb.TILE:
        oout, osum = mb.ladder_dp4a(rung, *mom, idx.data, meta, tile)
        assert mb.LAUNCHES["breakdown_ladder_dp4a"] == before["breakdown_ladder_dp4a"] + 1
        assert torch.equal(out.view(torch.int32), oout.view(torch.int32)) and torch.equal(dsum, osum)


# --------------------------------------------------------------------- #
# The tensor-core collects (K1a and K2a on int8 wgmma, csrc/tc_scan.cu)


def _collect_agrees(got, want, cap):
    """Counts equal; where count <= cap the collected (dist, row) sets equal
    (sorted by (dist, id): the kernel's slot order is atomic)."""
    c1, d1, i1 = got
    c2, d2, i2 = want
    assert torch.equal(c1, c2)
    lens = torch.clamp(c1, max=cap)
    s1 = fs.lex_topk_segments_plain(d1, i1, cap, lens, segment=cap)
    s2 = fs.lex_topk_segments_plain(d2, i2, cap, lens, segment=cap)
    ok = c1 <= cap
    assert torch.equal(s1[0][ok], s2[0][ok]) and torch.equal(s1[1][ok], s2[1][ok])


def _tc_cases(n_rows, cap):
    """(label, θ [Q] builder, cap): a mid θ, θ = max_distance (unbound),
    θ past the saturation (the +inf key), and a small buffer that
    overflows."""
    return [
        ("mid", lambda qn, dev: torch.full((qn,), 0.2, device=dev), cap),
        ("max_distance", lambda qn, dev: torch.full((qn,), 1e3, device=dev), cap),
        ("saturated", lambda qn, dev: torch.full((qn,), 2 * fs.DIST_SATURATION, device=dev), cap),
        ("overflow", lambda qn, dev: torch.full((qn,), 0.5, device=dev), 64),
    ]


def _tie_flood(idx, q, rows=3000):
    """Rows 100..100+rows copies of row 7, query 0 a copy of it: a tie flood
    at distance 0 that overflows a 2,048-slot buffer."""
    data = idx.data.clone()
    data[100 : 100 + rows] = data[7]
    for name in ("row_sum", "row_mag2"):
        col = getattr(idx, name).clone()
        col[100 : 100 + rows] = col[7]
        idx = idx._replace(**{name: col})
    idx = idx._replace(data=data, valid=idx.valid.clone())
    idx.valid[7] = True
    idx.valid[100 : 100 + rows] = True
    q = q.clone()
    q[0] = (data[7].to(torch.int16) + 128).to(torch.uint8)
    return idx, q


@pytest.mark.parametrize("qn", [1, 3, 8, 257, 2048])
@pytest.mark.parametrize("dim", [32, 64, 128])
def test_tc_cosine_collect_matches_plain(dim, qn):
    """The tensor-core K1a against its plain version at N = 65,537 (not a
    multiple of the 64-row tile), 1% invalid rows, every query tile width
    and Q > 256; each launch counted under the tensor-core kernel."""
    dev = _card()
    idx, _ = _index(65537, dim, seed=dim + qn, dev=dev)
    rng = np.random.default_rng(qn)
    rows_u8 = (idx.data[torch.from_numpy(rng.integers(0, 65537, qn)).to(dev)].to(torch.int16) + 128)
    q = rows_u8.to(torch.uint8)
    idx, q = _tie_flood(idx, q) if qn > 1 else (idx, q)
    meta = fs.build_row_meta(idx)
    qk = fs.CosineQueries.from_u8(q)
    args = (qk.q_codes, qk.q_sum, qk.q_mag2, qk.qr)
    for label, theta_of, cap in [*_tc_cases(65537, 4096), ("flood", lambda n, d: torch.full((n,), 0.05, device=d), 2048)]:
        theta = theta_of(qn, dev)
        fs.reset_launch_counts()
        got = fs.cosine_threshold_collect(*args, theta, idx.data, meta, cap)
        torch.cuda.synchronize()
        assert fs.launch_counts()["cosine_threshold_collect"] == 1, label
        assert fs.launch_counts()["cosine_threshold_collect_dp4a"] == 0, label
        _collect_agrees(got, fs.cosine_threshold_collect_plain(*args, theta, idx.data, meta, cap), cap)
    if qn > 1:
        assert int(got[0][0]) > 2048  # the tie flood overflowed and was still counted


def test_tc_cosine_other_width_takes_the_dp4a_kernel():
    dev = _card()
    idx, q = _index(65537, 36, seed=36, dev=dev)
    meta = fs.build_row_meta(idx)
    qk = fs.CosineQueries.from_u8(q)
    theta = torch.full((q.shape[0],), 0.2, device=dev)
    fs.reset_launch_counts()
    got = fs.cosine_threshold_collect(*qk, theta, idx.data, meta, 4096)
    assert fs.launch_counts()["cosine_threshold_collect_dp4a"] == 1
    assert fs.launch_counts()["cosine_threshold_collect"] == 0
    _collect_agrees(got, fs.cosine_threshold_collect_plain(*qk, theta, idx.data, meta, 4096), 4096)


@pytest.mark.parametrize("qn", [1, 3, 8, 257, 2048])
@pytest.mark.parametrize(
    "limit,wrap", [(32, False), (32, True), (24, False), (24, True)],
    ids=["limit32", "limit32_wrap", "limit24", "limit24_wrap"],
)
def test_tc_hamming_collect_matches_plain(limit, wrap, qn):
    """The tensor-core K2a against its plain version at N = 65,537, 1%
    invalid rows and a width-group mask, limits 32 and 24 with and
    without the u8 wrap, a tie flood, θ = max_distance and an overflowing
    buffer; each launch counted under the tensor-core kernel."""
    dev = _card()
    idx, q = _phash_index(65537, 32, seed=limit + qn, dev=dev)
    data = idx.data.clone()
    data[100:3100] = data[7]  # 3,000 copies of row 7
    idx = idx._replace(data=data)
    rng = np.random.default_rng(qn)
    q = torch.cat([q, data[torch.from_numpy(rng.integers(0, 65537, max(0, qn - 40))).to(dev)]])[:qn]
    q = q.contiguous()
    if qn > 1:
        q[0] = data[7]
    group = torch.arange(65537, device=dev) % 3 != 0
    meta = fs.build_hamming_meta(idx, group)
    meta[7] = 1
    meta[100:3100] = 1
    cases = [
        ("mid", 0.3, 4096), ("max_distance", 1e3, 4096), ("overflow", 0.45, 64), ("flood", 0.05, 2048),
    ]
    for label, th, cap in cases:
        theta = torch.full((qn,), th, device=dev)
        fs.reset_launch_counts()
        got = fs.hamming_threshold_collect(q, theta, idx.data, meta, limit, wrap, cap)
        torch.cuda.synchronize()
        assert fs.launch_counts()["hamming_threshold_collect"] == 1, label
        assert fs.launch_counts()["hamming_threshold_collect_popc"] == 0, label
        want = fs.hamming_threshold_collect_plain(q, theta, idx.data, meta, limit, wrap, cap)
        _collect_agrees(got, want, cap)
    if qn > 1:
        assert int(got[0][0]) > 2048


def test_tc_hamming_other_width_takes_the_popc_kernel():
    dev = _card()
    idx, q = _phash_index(65537, 18, seed=18, dev=dev)
    meta = fs.build_hamming_meta(idx)
    theta = torch.full((q.shape[0],), 0.3, device=dev)
    fs.reset_launch_counts()
    got = fs.hamming_threshold_collect(q, theta, idx.data, meta, 18, False, 4096)
    assert fs.launch_counts()["hamming_threshold_collect_popc"] == 1
    assert fs.launch_counts()["hamming_threshold_collect"] == 0
    _collect_agrees(got, fs.hamming_threshold_collect_plain(q, theta, idx.data, meta, 18, False, 4096), 4096)


# --------------------------------------------------------------------- #
# K1c in one launch (lex_topk_select) and the tensor-core K4a


def _select_inputs(qn, m, fill, seed, dev):
    """[Q, M] candidates as a collect buffer holds them: the first
    ``fill`` a query valid (query 1: none; query 2: a plateau of 3k equal
    distances), lens per query (one past M), the rest garbage."""
    rng = np.random.default_rng(seed)
    dist = torch.from_numpy((2 * rng.random((qn, m))).astype(np.float32))
    idx = torch.from_numpy(np.stack([rng.permutation(4 * m)[:m] for _ in range(qn)]).astype(np.int32))
    lens = torch.from_numpy(rng.integers(fill // 2, fill + 1, qn).astype(np.int32))
    lens[0] = m + 1
    if qn > 1:
        lens[1] = 0
    if qn > 2:
        dist[2, : min(m, 3 * fill)] = 0.25
        lens[2] = min(m, 3 * fill)
    return dist.to(dev), idx.to(dev), lens.to(dev)


@pytest.mark.parametrize(
    "qn,m,k,fill",
    [(256, 4096, 100, 320), (256, 2048, 20, 80), (256, 400, 100, 400), (256, 16384, 400, 1280),
     (8, 102400, 100, 102400), (3, 5000, 1024, 5000), (2, 100, 400, 100)],
    ids=["main_pass", "theta_stage", "mesh_merge", "int4", "k1b_partials", "k1024", "m_below_k"],
)
def test_lex_topk_select_matches_plain(qn, m, k, fill):
    """K1c's select kernel against its plain version at the main path's
    shapes, with and without lens; one launch a call, and lex_topk one
    launch up to SELECT_SLOTS entries a row, two past it."""
    dev = _card()
    dist, idx, lens = _select_inputs(qn, m, fill, seed=m + k, dev=dev)
    for ln in (lens, None):
        if m <= fs.SELECT_SLOTS:
            fs.reset_launch_counts()
            got = fs.lex_topk_select(dist, idx, k, ln)
            torch.cuda.synchronize()
            assert fs.launch_counts()["lex_topk_select"] == 1
            want = fs.lex_topk_select_plain(dist, idx, k, ln)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        fs.reset_launch_counts()
        got = fs.lex_topk(dist, idx, k, ln)
        assert fs.launch_counts()["lex_topk_select"] == (1 if m <= fs.SELECT_SLOTS else 2)
        assert fs.launch_counts()["lex_topk_segments"] == 0
        want = fs.lex_topk_select_plain(dist.cpu(), idx.cpu(), k, None if ln is None else ln.cpu())
        assert torch.equal(got[0].cpu(), want[0][:, 0]) and torch.equal(got[1].cpu(), want[1][:, 0])
        if k <= fs.SEGMENT // 2:
            old = fs.lex_topk_segments_chain(dist, idx, k, ln)
            assert torch.equal(old[0], got[0]) and torch.equal(old[1], got[1])


@pytest.mark.parametrize("qn", [1, 8, 256, 300])
@pytest.mark.parametrize("mode", ["asym", "sym"])
def test_tc_cosine4_collect_matches_plain(mode, qn):
    """The tensor-core K4a against its plain version at N = 65,537 (not a
    multiple of the 64-row tile), 1% invalid rows, a tie flood, Q > 256 and
    an overflowing buffer; each launch counted under the tensor-core
    kernel."""
    dev = _card()
    idx, _ = _int4_index(65537, 128, seed=qn + (mode == "sym"), dev=dev)
    idx = int4.PackedSemantic4Index(*(t[:65537] for t in idx))  # N % 4 != 0: no padding rows
    data = idx.data.clone()
    data[100:3100] = data[7]  # 3,000 copies of row 7
    for name in ("row_sum", "row_mag2"):
        col = getattr(idx, name).clone()
        col[100:3100] = col[7]
        idx = idx._replace(**{name: col})
    valid = idx.valid.clone()
    valid[7] = True
    valid[100:3100] = True
    idx = idx._replace(data=data, valid=valid)
    rng = np.random.default_rng(qn)
    rows = torch.from_numpy(rng.integers(0, 65537, qn)).to(dev)
    q = _dequantized_u8(idx.data[rows]).contiguous()
    if qn > 1:
        q[0] = _dequantized_u8(idx.data[7:8])[0]
    meta = int4.build_semantic4_meta(idx)
    qk = fs.Int4Queries.from_u8(q, mode)
    args = (qk.q_codes, qk.q_sum, qk.q_mag2, qk.qr)
    cases = [("mid", 0.2, 4096), ("max_distance", 1e3, 4096), ("saturated", 2 * fs.DIST_SATURATION, 4096),
             ("overflow", 0.5, 64), ("flood", 0.05, 2048)]
    for label, th, cap in cases:
        theta = torch.full((qn,), th, device=dev)
        fs.reset_launch_counts()
        got = fs.cosine4_threshold_collect(*args, theta, idx.data, meta, qk.sym, cap)
        torch.cuda.synchronize()
        assert fs.launch_counts()["cosine4_threshold_collect"] == 1, label
        assert fs.launch_counts()["cosine4_threshold_collect_dp4a"] == 0, label
        want = fs.cosine4_threshold_collect_plain(*args, theta, idx.data, meta, qk.sym, cap)
        _collect_agrees(got, want, cap)
        old = fs.cosine4_threshold_collect_dp4a(*args, theta, idx.data, meta, qk.sym, cap)
        _collect_agrees(old, want, cap)
    if qn > 1:
        assert int(got[0][0]) > 2048  # the tie flood overflowed and was still counted


def _dequantized_u8(packed):
    """Packed int4 rows → the u8 rows they dequantize to (v4 · 17)."""
    return (fs.unpack_u4(packed).to(torch.int32) * 17).to(torch.uint8)


def test_tc_cosine4_other_width_takes_the_dp4a_kernel():
    dev = _card()
    idx, q = _int4_index(65537, 64, seed=64, dev=dev)
    idx = int4.PackedSemantic4Index(*(t[:65537] for t in idx))
    meta = int4.build_semantic4_meta(idx)
    qk = fs.Int4Queries.from_u8(q, "asym")
    theta = torch.full((q.shape[0],), 0.2, device=dev)
    fs.reset_launch_counts()
    got = fs.cosine4_threshold_collect(*qk[:4], theta, idx.data, meta, False, 4096)
    assert fs.launch_counts()["cosine4_threshold_collect_dp4a"] == 1
    assert fs.launch_counts()["cosine4_threshold_collect"] == 0
    _collect_agrees(got, fs.cosine4_threshold_collect_plain(*qk[:4], theta, idx.data, meta, False, 4096), 4096)


# --------------------------------------------------------------------- #
# The tensor-core chunk top-k (K2b and K4b on int8 wgmma)


def _exact_from(part, qn, k):
    """K1c over a chunk kernel's [Q, n_chunks, k] partials: the exact scan."""
    return fs.lex_topk(part[0].reshape(qn, -1).contiguous(), part[1].reshape(qn, -1).contiguous(), k)


def _chunk_agrees(name, got, want, old, qn, k):
    """The new kernel's partials equal the plain version's, and the exact
    scan from them equals the one from the first port's kernel."""
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), name
    a, b = _exact_from(got, qn, k), _exact_from(old, qn, k)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), name


@pytest.mark.parametrize("qn", [1, 5, 70, 256])
@pytest.mark.parametrize(
    "limit,wrap,md,group",
    [(32, False, 1e3, False), (32, False, 0.1, False), (24, False, 1e3, True), (32, True, 1e3, False)],
    ids=["limit32", "max_distance_0.1", "limit24_group", "wrap"],
)
def test_tc_hamming_chunk_topk_matches_plain(limit, wrap, md, group, qn):
    """The tensor-core K2b against its plain version at N = 20,001 (no
    multiple of any chunk): a 3,000-row tie flood across the 8,192-row
    border, copies across the 16,384 border, 1% tombstones, k ∈ {8, 100,
    400}; each launch counted under the new kernel, and the exact scan
    equal to the first port's."""
    dev = _card()
    n = 20001
    idx, q = _phash_index(n, 32, seed=limit + qn, dev=dev)
    data = idx.data.clone()
    data[8000:11000] = data[7]  # across the chunk border at 8,192
    data[16300:16411] = data[7]
    rng = np.random.default_rng(qn)
    q = torch.cat([q, data[torch.from_numpy(rng.integers(0, n, max(0, qn - 40))).to(dev)]])[:qn].contiguous()
    q[0] = data[7]
    mask = torch.arange(n, device=dev) % 3 != 0 if group else None
    meta = fs.build_hamming_meta(idx._replace(data=data), mask)
    meta[7] = 1
    for k in (8, 100, 400):
        fs.reset_launch_counts()
        got = fs.hamming_chunk_topk(q, md, data, meta, limit, wrap, k)
        torch.cuda.synchronize()
        assert fs.launch_counts()["hamming_chunk_topk"] == 1
        assert fs.launch_counts()["hamming_chunk_topk_popc"] == 0
        assert got[0].shape == (qn, -(-n // fs.tc_chunk_rows(n, k)), k)
        want = fs.hamming_chunk_topk_plain(q, md, data, meta, limit, wrap, k)
        old = fs.hamming_chunk_topk_popc(q, md, data, meta, limit, wrap, k)
        _chunk_agrees(f"k={k}", got, want, old, qn, k)
        if md > 1:  # the flood: distance 0 first, the copies in row order
            d, i = _exact_from(got, qn, k)
            ties = i[0][d[0] == 0].tolist()
            assert ties[0] == 7 and ties == sorted(ties) and len(ties) == k


@pytest.mark.parametrize("qn", [1, 5, 70, 256])
@pytest.mark.parametrize("dim", [32, 64, 128])
def test_tc_cosine_chunk_topk_matches_plain(dim, qn):
    """The tensor-core K1b against its plain version at N = 20,001, a
    3,000-row tie flood across the 8,192-row chunk border, 1% tombstones,
    k ∈ {8, 100, 400} and max_distance 1e3 and 0.05; each launch counted
    under the new kernel, and the exact scan equal to the first port's."""
    dev = _card()
    n = 20001
    idx, q = _index(n, dim, seed=dim + qn, dev=dev)
    data = idx.data.clone()
    data[8000:11000] = data[7]  # across the chunk border at 8,192
    cols = {name: getattr(idx, name).clone() for name in ("row_sum", "row_mag2", "valid")}
    for name in ("row_sum", "row_mag2"):
        cols[name][8000:11000] = cols[name][7]
    cols["valid"][7] = True
    cols["valid"][8000:11000] = True
    idx = idx._replace(data=data, **cols)
    rng = np.random.default_rng(qn)
    pick = torch.from_numpy(rng.integers(0, n, qn)).to(dev)
    q = ((data[pick].to(torch.int16) + 128).to(torch.uint8)).contiguous()
    q[0] = (data[7].to(torch.int16) + 128).to(torch.uint8)
    meta = fs.build_row_meta(idx)
    qc, qs, qm, qr = fs._prep(q)
    for md in (1e3, 0.05):
        for k in (8, 100, 400):
            fs.reset_launch_counts()
            got = fs.cosine_chunk_topk(qc, qs, qm, qr, md, idx.data, meta, k)
            torch.cuda.synchronize()
            assert fs.launch_counts()["cosine_chunk_topk"] == 1
            assert fs.launch_counts()["cosine_chunk_topk_dp4a"] == 0
            assert got[0].shape == (qn, -(-n // fs.tc_chunk_rows(n, k)), k)
            want = fs.cosine_chunk_topk_plain(qc, qs, qm, qr, md, idx.data, meta, k)
            old = fs.cosine_chunk_topk_dp4a(qc, qs, qm, qr, md, idx.data, meta, k)
            _chunk_agrees(f"md={md} k={k}", got, want, old, qn, k)
            if md > 1:  # the flood: distance 0 first, the copies in row order
                d, i = _exact_from(got, qn, k)
                ties = i[0][d[0] == 0].tolist()
                assert ties[0] == 7 and ties == sorted(ties) and len(ties) == k


@pytest.mark.parametrize("qn", [1, 5, 70, 256])
@pytest.mark.parametrize("mode", ["asym", "sym"])
def test_tc_cosine4_chunk_topk_matches_plain(mode, qn):
    """The tensor-core K4b against its plain version at N = 20,001, a
    3,000-row tie flood across the 8,192-row chunk border, 1% tombstones, k ∈ {8,
    100, 400} and max_distance 1e3, 0.05 and unbounded; each launch counted
    under the new kernel, and the exact scan equal to the first port's."""
    dev = _card()
    n = 20001
    idx, _ = _int4_index(n, 128, seed=qn + (mode == "sym"), dev=dev)
    idx = int4.PackedSemantic4Index(*(t[:n] for t in idx))
    data = idx.data.clone()
    data[8000:11000] = data[7]  # across the chunk border at 8,192
    for name in ("row_sum", "row_mag2"):
        col = getattr(idx, name).clone()
        col[8000:11000] = col[7]
        idx = idx._replace(**{name: col})
    valid = idx.valid.clone()
    valid[7] = True
    valid[8000:11000] = True
    idx = idx._replace(data=data, valid=valid)
    rng = np.random.default_rng(qn)
    q = _dequantized_u8(idx.data[torch.from_numpy(rng.integers(0, n, qn)).to(dev)]).contiguous()
    q[0] = _dequantized_u8(idx.data[7:8])[0]
    meta = int4.build_semantic4_meta(idx)
    qk = fs.Int4Queries.from_u8(q, mode)
    args = (qk.q_codes, qk.q_sum, qk.q_mag2, qk.qr)
    for md in (1e3, 0.05, int4.UNBOUNDED_DISTANCE):
        for k in (8, 100, 400):
            fs.reset_launch_counts()
            got = fs.cosine4_chunk_topk(*args, md, idx.data, meta, qk.sym, k)
            torch.cuda.synchronize()
            assert fs.launch_counts()["cosine4_chunk_topk"] == 1
            assert fs.launch_counts()["cosine4_chunk_topk_dp4a"] == 0
            want = fs.cosine4_chunk_topk_plain(*args, md, idx.data, meta, qk.sym, k)
            old = fs.cosine4_chunk_topk_dp4a(*args, md, idx.data, meta, qk.sym, k)
            _chunk_agrees(f"md={md} k={k}", got, want, old, qn, k)


def test_chunk_topk_other_widths_take_the_first_port_kernels():
    """Hashes of 18 bytes, int4 rows of 64 dims and u8 rows of 96 bytes
    take the first port's chunk kernels (their own launch counts) at
    CHUNK_ROWS, equal to the plain versions at that chunk."""
    dev = _card()
    idx8, q8 = _index(20001, 96, seed=96, dev=dev)
    meta8 = fs.build_row_meta(idx8)
    qk8 = fs._prep(q8)
    fs.reset_launch_counts()
    got = fs.cosine_chunk_topk(*qk8, 1e3, idx8.data, meta8, 100)
    assert fs.launch_counts()["cosine_chunk_topk_dp4a"] == 1
    assert fs.launch_counts()["cosine_chunk_topk"] == 0
    want = fs.cosine_chunk_topk_plain(*qk8, 1e3, idx8.data, meta8, 100)
    assert got[0].shape[1] == -(-20001 // fs.CHUNK_ROWS)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    idx, q = _phash_index(20001, 18, seed=18, dev=dev)
    meta = fs.build_hamming_meta(idx)
    fs.reset_launch_counts()
    got = fs.hamming_chunk_topk(q, 1e3, idx.data, meta, 18, False, 100)
    assert fs.launch_counts()["hamming_chunk_topk_popc"] == 1
    assert fs.launch_counts()["hamming_chunk_topk"] == 0
    want = fs.hamming_chunk_topk_plain(q, 1e3, idx.data, meta, 18, False, 100)
    assert got[0].shape[1] == -(-20001 // fs.CHUNK_ROWS)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    idx4, q4 = _int4_index(20001, 64, seed=64, dev=dev)
    meta4 = int4.build_semantic4_meta(idx4)
    qk = fs.Int4Queries.from_u8(q4, "asym")
    fs.reset_launch_counts()
    got = fs.cosine4_chunk_topk(*qk[:4], 1e3, idx4.data, meta4, False, 100)
    assert fs.launch_counts()["cosine4_chunk_topk_dp4a"] == 1
    assert fs.launch_counts()["cosine4_chunk_topk"] == 0
    want = fs.cosine4_chunk_topk_plain(*qk[:4], 1e3, idx4.data, meta4, False, 100)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("kind", ["hamming", "cosine", "cosine4a", "cosine4"])
def test_tc_chunk_topk_split_chunks_match_plain(kind):
    """Few queries over many rows: the plan splits each chunk over several
    blocks and the last to finish merges their parts (N = 200,001: the last
    chunk's later parts hold no row); equal to the plain version."""
    dev = _card()
    n = 200001
    if kind == "hamming":
        idx, q = _phash_index(n, 32, seed=21, dev=dev)
        meta = fs.build_hamming_meta(idx)
    elif kind == "cosine":
        idx, q = _index(n, 128, seed=23, dev=dev)
        meta = fs.build_row_meta(idx)
        qk = fs._prep(q)
    else:
        idx, q = _int4_index(n, 128, seed=22, dev=dev)
        idx = int4.PackedSemantic4Index(*(t[:n] for t in idx))
        meta = int4.build_semantic4_meta(idx)
        qk = fs.Int4Queries.from_u8(q, "sym" if kind == "cosine4" else "asym")
    for qn in (1, 5):
        for k in (400, 1024):
            plan = (__import__("ctypes").c_int * 2)()
            assert fs.load_tc_kernels().lib.px_tc_chunk_plan(
                fs._KIND_CODES[kind], qn, n, 128 if kind == "cosine" else 32, fs.tc_chunk_rows(n, k), k,
                plan) == 0
            assert plan[1] > 1  # split
            if kind == "hamming":
                args = (q[:qn].contiguous(), 1e3, idx.data, meta, 32, False, k)
                got, want = fs.hamming_chunk_topk(*args), fs.hamming_chunk_topk_plain(*args)
            elif kind == "cosine":
                args = (*(x[:qn].contiguous() for x in qk), 1e3, idx.data, meta, k)
                got, want = fs.cosine_chunk_topk(*args), fs.cosine_chunk_topk_plain(*args)
            else:
                args = (*(x[:qn].contiguous() for x in qk[:4]), 1e3, idx.data, meta, qk.sym, k)
                got, want = fs.cosine4_chunk_topk(*args), fs.cosine4_chunk_topk_plain(*args)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (qn, k)


# --------------------------------------------------------------------- #
# The θ stage (csrc/tc_theta.cu) against sample_theta_plain


def _theta_sample(kind, width, s, seed, dev, flood=False):
    """(queries [2048], ScanSample) of s rows of a kind; ``flood``: 3,000
    copies of query 0's row on rows the mini-sample skips (its stage 2
    overflows the buffer)."""
    rng = np.random.default_rng(seed)
    if kind == "hamming":
        base = rng.integers(0, 256, (64, width), dtype=np.uint8)
        noise = (rng.integers(0, 256, (s, width), dtype=np.uint8)
                 & rng.integers(0, 256, (s, width), dtype=np.uint8)
                 & rng.integers(0, 256, (s, width), dtype=np.uint8))
        db = base[rng.integers(0, 64, s)] ^ noise
        q = db[rng.integers(0, s, 2048)].copy()
        if flood:
            db[[r for r in range(s) if r % 16][:3000]] = q[0]
        ok = (rng.uniform(size=s) > 0.01).astype(np.uint8)
        return q, tscan.ScanSample(torch.from_numpy(db).to(dev), torch.from_numpy(ok).to(dev))
    d = width
    c = rng.standard_normal((64, d)).astype(np.float32)
    x = c[rng.integers(0, 64, s)] + 0.35 * rng.standard_normal((s, d)).astype(np.float32)
    db = quantize_embedding_np(np.tanh(x))
    q = db[rng.integers(0, s, 2048)].copy()
    if flood:
        db[[r for r in range(s) if r % 16][:3000]] = q[0]
    valid = rng.uniform(size=s) > 0.01
    if kind == "cosine":
        data, rs, rm = semantic_rows_from_u8(db)
        idx = PackedSemanticIndex(*(torch.from_numpy(v).to(dev) for v in (data, rs, rm, valid)))
    else:
        idx = int4.build_semantic4_index(db, block_rows=s, device=dev)
        idx = idx._replace(valid=torch.from_numpy(valid).to(dev))
    return q, tscan.ScanSample(idx.data, fs.build_row_meta(idx))


def _theta_queries(kind, q, width, limit=None, wrap=False):
    if kind == "hamming":
        return fs.HammingQueries(q.contiguous(), limit or width, wrap)
    if kind == "cosine":
        return fs.CosineQueries.from_u8(q)
    return fs.Int4Queries.from_u8(q, "sym" if kind == "cosine4" else "asym")


_THETA_CASES = [("cosine", 32, None, False), ("cosine", 64, None, False), ("cosine", 128, None, False),
                ("cosine4a", 128, None, False), ("cosine4", 128, None, False),
                ("hamming", 32, None, False), ("hamming", 32, 24, False), ("hamming", 32, None, True)]


@pytest.mark.parametrize("qn", [1, 8, 256, 2048])
@pytest.mark.parametrize("kind,width,limit,wrap", _THETA_CASES)
def test_tc_sample_theta_matches_plain(kind, width, limit, wrap, qn):
    """The θ kernel (one sample_theta launch a call) against
    sample_theta_plain, bit for bit: a 65,536-row sample (j = 20 as k =
    100 over 1M rows) and a 100,000-row one (partial tiles, 6,250 mini
    rows); at k = 400 over 1M (j = 80)."""
    dev = _card()
    for s, j in ((65536, 20), (100000, 80)):
        q, smp = _theta_sample(kind, width, s, seed=width + qn, dev=dev)
        qk = _theta_queries(kind, torch.from_numpy(q[:qn]).to(dev), width, limit, wrap)
        for md in (1e3, 0.25):
            fs.reset_launch_counts()
            got = fs.sample_theta(qk, smp, md, j)
            torch.cuda.synchronize()
            counts = fs.launch_counts()
            assert counts["sample_theta"] == 1 and sum(counts.values()) == 1
            want = fs.sample_theta_plain(qk, smp, md, j)
            assert torch.equal(got, want), (s, md)


@pytest.mark.parametrize("kind,width,limit,wrap", _THETA_CASES)
def test_tc_sample_theta_fallbacks_match_plain(kind, width, limit, wrap):
    """Both fallbacks on the card: a max_distance that leaves fewer than j
    rows under θ0, and a flood of query 0's row that overflows the
    buffer; and launch plans other than the wrapper's."""
    dev = _card()
    s, j = 65536, 20
    q, smp = _theta_sample(kind, width, s, seed=7, dev=dev, flood=True)
    qk = _theta_queries(kind, torch.from_numpy(q[:64]).to(dev), width, limit, wrap)
    theta0 = fs.mini_sample_theta(qk, smp, 1e3, j)
    count = qk.collect_plain(theta0, smp.data, smp.meta, fs.sample_cap(j))[0]
    assert int(count[0]) > fs.sample_cap(j)
    md_small = 1e-4 if kind != "hamming" else 0.01
    count_small = qk.collect_plain(fs.mini_sample_theta(qk, smp, md_small, j), smp.data, smp.meta, 2048)[0]
    assert bool((count_small[1:] < j).any())
    for md in (1e3, md_small):
        want = fs.sample_theta_plain(qk, smp, md, j)
        assert torch.equal(fs.sample_theta(qk, smp, md, j), want)
        _, s0, _ = fs.mini_sample_shape(s, j)
        for plan in (((8, 4, 16), (32, 1, 1024)), ((32, 16, 4), (16, 7, 147)), ((8, 64, 1), (8, 1024, 1))):
            assert torch.equal(fs._tc_sample_theta(qk, smp, md, j, plan=plan), want), plan


@pytest.mark.parametrize("kind,width", [("cosine", 36), ("cosine4a", 64), ("hamming", 18)])
def test_sample_theta_other_widths_take_the_chunk_kernels(kind, width):
    """At widths the θ kernel does not take, stage 1 is the width's chunk
    top-k + K1c and stage 2 its collect + K1c; bit-equal to the plain."""
    dev = _card()
    q, smp = _theta_sample(kind, width, 16384, seed=3, dev=dev)
    qk = _theta_queries(kind, torch.from_numpy(q[:40]).to(dev), width)
    fs.reset_launch_counts()
    got = fs.sample_theta(qk, smp, 1e3, 20)
    torch.cuda.synchronize()
    counts = fs.launch_counts()
    assert counts["sample_theta"] == 0 and counts["lex_topk_select"] == 2
    assert sum(c for n, c in counts.items() if "chunk_topk" in n) == 1
    assert torch.equal(got, fs.sample_theta_plain(qk, smp, 1e3, 20))


# --------------------------------------------------------------------- #
# K5 (ivf_probe_topk and its work list, csrc/ivf_probe.cu; the first
# port's ivf_probe_collect_dp4a) and the scans' k past MAX_K


def _ivf(precision, dev, n=6000, d=128, c=40, cap=96):
    from pixelbox_tpu_torch.ops import ivf

    rng = np.random.default_rng(17)
    centers = rng.normal(size=(12, d)) * 40.0
    rows = np.clip(centers[rng.integers(0, 12, n)] + rng.normal(size=(n, d)) * 10 + 128, 0, 255)
    rows = rows.astype(np.uint8)
    rows[n - 40 :] = rows[5]  # copies: ties inside one bucket
    valid = rng.uniform(size=n) > 0.02
    valid[5] = True
    cents = ivf.spherical_kmeans(rows, valid, c, iters=4, seed=0, device=dev)
    index = ivf.build_ivf(rows, valid, cents, bucket_cap=cap, precision=precision, device=dev)
    # One bucket with every slot invalid.
    bv = index.bucket_valid.clone()
    bv[3] = False
    q = rows[rng.integers(0, n, 9)].copy()
    q[0] = rng.integers(0, 256, d)
    q[1] = rows[5]
    return index._replace(bucket_valid=bv), rows, valid, torch.from_numpy(q).to(dev)


@pytest.mark.parametrize("precision", ["u8", "int4"])
def test_ivf_probe_collect_matches_plain(precision):
    from pixelbox_tpu_torch.ops import ivf

    dev = _card()
    index, _, _, q = _ivf(precision, dev)
    qc, qs, qm, qr = fs._prep(q)
    for nprobe, md in ((1, 1e3), (7, 0.05), (index.n_clusters, 1e3)):
        bids = ivf.probe_order(q, index.centroids, nprobe)
        args = (qc, qs, qm, qr, md, bids, index.bucket_data, index.bucket_sum, index.bucket_mag2,
                index.bucket_rows, index.bucket_valid)
        fs.reset_launch_counts()
        got = ivf.ivf_probe_collect_dp4a(*args)
        torch.cuda.synchronize()
        assert fs.launch_counts()["ivf_probe_collect_dp4a"] == 1
        want = ivf.ivf_probe_collect_plain(*args)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert bool(torch.isfinite(got[0]).any())


@pytest.mark.parametrize("precision,d", [("u8", 32), ("u8", 64), ("u8", 128), ("int4", 128)])
def test_ivf_probe_topk_matches_plain(precision, d):
    """The tensor-core K5 = its plain version (torch.equal) at k < cap, k =
    cap and k > cap, with and without a work list, a max_distance cut,
    ties inside a bucket, partly filled and empty buckets, and a batch of
    equal queries (a bucket probed by more queries than a work item holds);
    the first port's kernel is not launched."""
    from pixelbox_tpu_torch.ops import ivf

    dev = _card()
    index, _, _, q = _ivf(precision, dev, d=d, cap=160)
    fill = index.bucket_valid.sum(1)
    assert int(fill.max()) == 160 and 0 < int(fill[fill > 0].min()) < 160
    batches = (q, q[:1], q[1:2].repeat(20, 1))
    for qb in batches:
        qc, qs, qm, qr = fs._prep(qb)
        for nprobe, k, md in ((1, 10, 1e3), (7, 50, 0.05), (7, 160, 1e3), (12, 300, 1e3),
                              (index.n_clusters, 100, 1e3)):
            bids = ivf.probe_order(qb, index.centroids, nprobe)
            args = (qc, qs, qm, qr, md, bids, index.bucket_data, index.bucket_sum, index.bucket_mag2,
                    index.bucket_rows, index.bucket_valid)
            fs.reset_launch_counts()
            got = ivf.ivf_probe_topk(*args, k)
            torch.cuda.synchronize()
            counts = fs.launch_counts()
            assert counts["ivf_probe_topk"] == 1 and counts["ivf_probe_collect_dp4a"] == 0
            assert counts["ivf_probe_invert"] == int(ivf.shares_buckets(len(qb), nprobe, index.n_clusters))
            want = ivf.ivf_probe_topk_plain(*args, k)
            assert got[0].shape == (len(qb), nprobe, min(k, 160))
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            assert md < 1 or bool(torch.isfinite(got[0]).any())


def test_ivf_probe_invert_matches_plain():
    """The work-list kernel = its plain version up to the order of a
    bucket's pairs, with ids outside [0, C) and one bucket probed by every
    query."""
    from pixelbox_tpu_torch.ops import ivf

    dev = _card()
    rng = np.random.default_rng(9)
    for qn, p, c in ((2, 3, 5), (256, 82, 4094), (300, 20, 20000)):
        bids = rng.integers(0, c, (qn, p)).astype(np.int32)
        bids[:, 0] = 1
        bids[0, -1], bids[-1, -1] = -1, c
        bt = torch.from_numpy(bids)
        fs.reset_launch_counts()
        got = ivf.ivf_probe_invert(bt.to(dev), c)
        assert fs.launch_counts()["ivf_probe_invert"] == 1
        want = ivf.ivf_probe_invert_plain(bt, c)
        for a, b in zip(ivf.probe_work_pairs(got.cpu()), ivf.probe_work_pairs(want)):
            assert torch.equal(a, b)


def test_ivf_gathered_collect_matches_plain():
    from pixelbox_tpu_torch.ops import ivf

    dev = _card()
    _, rows, _, q = _ivf("u8", dev, n=3000)
    rng = np.random.default_rng(5)
    cand = torch.from_numpy(rng.integers(-3, 3010, (9, 1200)).astype(np.int32)).to(dev)
    qc, qs, qm, qr = fs._prep(q)
    rows_dev = torch.from_numpy(rows).to(dev)
    for md in (1e3, 0.1):
        got = ivf.ivf_gathered_collect(qc, qs, qm, qr, md, cand, rows_dev)
        want = ivf.ivf_gathered_collect_plain(qc, qs, qm, qr, md, cand, rows_dev)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("precision", ["u8", "int4"])
def test_ivf_scan_on_the_card_matches_cpu_and_exact(precision):
    """The whole probe (K5 + K1c, the spill's K1b/K4b + K1c) equals the
    CPU route; at full nprobe it equals the exact scan."""
    from pixelbox_tpu_torch.ops import ivf

    dev = _card()
    index, rows, valid, q = _ivf(precision, dev)
    cpu = ivf.IVFIndex(*(t.cpu() for t in index[:6]), type(index.spill)(*(t.cpu() for t in index.spill)),
                       index.spill_rows.cpu(), index.spill_meta.cpu())
    assert index.spill_count > 0
    for nprobe, k in ((None, 100), (5, 300), (index.n_clusters, 50)):
        fs.reset_launch_counts()
        got = ivf.ivf_scan_topk(q, index, k=k, nprobe=nprobe)
        counts = fs.launch_counts()
        assert counts["ivf_probe_topk"] > 0 and counts["ivf_probe_collect_dp4a"] == 0
        want = ivf.ivf_scan_topk(q.cpu(), cpu, k=k, nprobe=nprobe)
        assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    full = ivf.build_ivf(rows, valid, index.centroids.cpu().numpy(), bucket_cap=96, precision=precision,
                         device=dev)
    got = ivf.ivf_scan_topk(q, full, k=50, nprobe=full.n_clusters)
    if precision == "u8":
        data, rs, rm = semantic_rows_from_u8(rows)
        flat = PackedSemanticIndex(*(torch.from_numpy(v).to(dev) for v in (data, rs, rm, valid)))
        want = fs.fused_cosine_scan_topk(q, flat, fs.build_row_meta(flat), k=50)
    else:
        data, rs, rm = int4.semantic4_rows_from_u8(rows)
        flat = int4.PackedSemantic4Index(*(torch.from_numpy(v).to(dev) for v in (data, rs, rm, valid)))
        want = fs.fused_cosine4_scan_topk(q, flat, fs.build_row_meta(flat), k=50)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_scans_past_max_k_match_plain():
    """k past MAX_K: K1c in rounds and the exact scans' collect route, on
    the card equal to their plain versions."""
    dev = _card()
    idx, q = _index(65536, 128, seed=4, dev=dev)
    cpu = PackedSemanticIndex(*(t.cpu() for t in idx))
    for k in (1500, 2 * fs.MAX_K + 7):
        got = fs.fused_cosine_scan_topk(q[:9], idx, fs.build_row_meta(idx), k=k)
        want = fs.fused_cosine_scan_topk(q[:9].cpu(), cpu, fs.build_row_meta(cpu), k=k)
        assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    big, qb = _index(262144, 128, seed=6, dev=dev)
    got = tscan.cosine_scan_topk_auto(qb[:8], big, k=1500)
    bcpu = PackedSemanticIndex(*(t.cpu() for t in big))
    want = tscan.cosine_scan_topk_auto(qb[:8].cpu(), bcpu, k=1500)
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


def test_threshold_scan_counts_its_host_syncs():
    """A threshold scan of host queries on the card: the upload (in
    ``scan.prep``), the proof and the two result copies are its host
    syncs, the last two in wait spans."""
    from pixelbox_tpu_torch.utils import timing

    dev = _card()
    idx, q = _index(262144, 128, seed=8, dev=dev)
    sample, meta = tscan.build_scan_sample(idx), fs.build_row_meta(idx)
    tscan.to_host(*tscan.cosine_scan_topk_auto(q.cpu(), idx, k=10, sample=sample, row_meta=meta))
    with timing.recorded() as rec:
        tscan.to_host(*tscan.cosine_scan_topk_auto(q.cpu(), idx, k=10, sample=sample, row_meta=meta))
    waits = [s.name for s in rec.spans if s.wait]
    assert waits[0] == "scan.proof" and waits[-1] == "scan.download"
    # The upload and each wait one, the download two (a repair adds its
    # ``scan.unproven``).
    assert sum(b.n for b in rec.bumps if b.name == "host_syncs") == len(waits) + 2


# --------------------------------------------------------------------- #
# The threshold pass as one CUDA graph a shape (ops/scan_graphs.py)

_GRAPH_KINDS = ["cosine", "int4_asym", "int4_sym", "hamming", "hamming_wrap"]


def _graph_lib(kind, dev, n=262144, seed=21):
    """(index, meta, θ sample, queries [3, 256, width] u8 on ``dev``, the
    prep spec of ``fused_scan.threshold_pass``, max_distance) of a kind."""
    rng = np.random.default_rng(seed)
    if kind.startswith("hamming"):
        base = rng.integers(0, 256, (4096, 32), dtype=np.uint8)
        noise = rng.integers(0, 256, (n, 32), dtype=np.uint8) & rng.integers(0, 256, (n, 32), dtype=np.uint8)
        rows = base[rng.integers(0, 4096, n)] ^ (noise & rng.integers(0, 256, (n, 32), dtype=np.uint8))
        valid = rng.uniform(size=n) > 0.01
        idx = PackedHammingIndex(torch.from_numpy(rows).to(dev), torch.from_numpy(valid).to(dev))
        meta = fs.build_hamming_meta(idx)
        smp = hg.build_hamming_scan_sample(idx, meta)
        q = rows[rng.integers(0, n, 768)]
        q[1] = ~rows[7]  # every bit differs: 256 bits, 0 under the u8 wrap
        spec = (fs.HammingQueries.from_u8, 32, kind == "hamming_wrap")
        return idx, meta, smp, torch.from_numpy(q).to(dev).reshape(3, 256, -1), spec, 0.1
    c = rng.standard_normal((512, 128)).astype(np.float32)
    x = c[rng.integers(0, 512, n)] + 0.35 * rng.standard_normal((n, 128)).astype(np.float32)
    db = quantize_embedding_np(np.tanh(x))
    if kind == "cosine":
        data, rs, rm = semantic_rows_from_u8(db)
        valid = rng.uniform(size=n) > 0.01
        idx = PackedSemanticIndex(*(torch.from_numpy(v).to(dev) for v in (data, rs, rm, valid)))
        meta = fs.build_row_meta(idx)
        spec = (fs.CosineQueries.from_u8,)
    else:
        idx = int4.build_semantic4_index(db, device=dev)
        meta = int4.build_semantic4_meta(idx)
        spec = (fs.Int4Queries.from_u8, kind[5:])
    q = db[rng.integers(0, n, 768)].astype(np.int32)
    q[:, :6] = np.clip(q[:, :6] + rng.integers(-40, 41, (768, 6)), 0, 255)
    q = torch.from_numpy(q.astype(np.uint8)).to(dev).reshape(3, 256, -1)
    return idx, meta, tscan.build_scan_sample(idx), q, spec, 1e3


def _fresh_graphs(monkeypatch):
    from pixelbox_tpu_torch.ops.scan_graphs import GraphCache

    cache = GraphCache(fs.LAUNCHES)
    monkeypatch.setattr(fs, "SCAN_GRAPHS", cache)
    return cache


def _graph_counts():
    from pixelbox_tpu_torch.utils import timing

    c = timing.counters()
    return c["scan_graph_captures"], c["scan_graph_replays"]


def _counted(fn, *args):
    """(fn(*args), the hand-kernel launches it counted)."""
    before = fs.launch_counts()
    out = fn(*args)
    return out, {n: c - before[n] for n, c in fs.launch_counts().items() if c != before[n]}


@pytest.mark.parametrize("qn,k", [(256, 8), (1, 100)], ids=["q256_k8", "q1_k100"])
@pytest.mark.parametrize("kind", _GRAPH_KINDS)
def test_graphed_threshold_pass_equals_eager(kind, qn, k, monkeypatch):
    """Eager, then captured, then replayed: every call bit-equal to the
    eager chain with the same launches counted; a caller's results survive
    the next replay."""
    dev = _card()
    idx, meta, smp, qs, spec, md = _graph_lib(kind, dev)
    cache = _fresh_graphs(monkeypatch)
    make, *fields = spec
    batches = [qs[i, :qn] for i in (0, 1, 2, 0)]

    def eager(q):
        return fs._threshold_scan(make(q, *fields), idx.data, meta, smp, k, md, None, None, "dist")

    def graphed(q):
        return fs.threshold_pass(q, spec, idx.data, meta, smp, k, md)

    want = [_counted(eager, q) for q in batches]
    c0, r0 = _graph_counts()
    got = []
    for q, (w, launches) in zip(batches, want):
        out, n = _counted(graphed, q)
        assert n == launches and sum(launches.values()) >= 3
        assert all(torch.equal(a, b) for a, b in zip(out, w))
        got.append(out)
    assert _graph_counts() == (c0 + 1, r0 + 3) and len(cache) == 1
    held = want[1][0]
    assert all(torch.equal(a, b) for a, b in zip(got[1], held))   # after two more replays


def test_graphed_pass_follows_store_appends_and_meta_rebuilds(monkeypatch):
    """An append that reallocates the rows, then tombstones that rebuild
    the meta: each is a new key, captured anew, equal to the exact scan.
    The cache keeps none of the tensors a step left behind: they are
    freed, and their graph goes at the next call."""
    import gc

    from torch.multiprocessing.reductions import StorageWeakRef

    from pixelbox_tpu_torch.index.store import VectorStore

    dev = _card()
    rng = np.random.default_rng(23)
    c = rng.standard_normal((256, 128)).astype(np.float32)
    x = c[rng.integers(0, 256, 300000)] + 0.35 * rng.standard_normal((300000, 128)).astype(np.float32)
    db = quantize_embedding_np(np.tanh(x))
    store = VectorStore(dim=128, kind="semantic", device=dev)
    store.append(db[:200000])
    cache = _fresh_graphs(monkeypatch)
    q = torch.from_numpy(db[[5, 77, 1000, 150000, 210000, 250000, 299999, 3]]).to(dev)
    captures = _graph_counts()[0]
    left = []
    for step in ("filled", "reallocated", "tombstoned"):
        if step == "reallocated":
            before = store.device_index.data.data_ptr()
            store.append(db[200000:])
            assert store.device_index.data.data_ptr() != before
        elif step == "tombstoned":
            store.delete([5, 77, 210000])
        idx = store.device_index
        meta, smp = fs.build_row_meta(idx), tscan.build_scan_sample(idx)
        gc.collect()
        assert all(r.expired() for r in left), step      # the last step's, freed
        left = [StorageWeakRef(t.untyped_storage()) for t in (meta, smp.data, smp.meta)]
        if step == "filled":
            left.append(StorageWeakRef(idx.data.untyped_storage()))
        want = fs.fused_cosine_scan_topk(q, idx, meta, k=8)
        for _ in range(3):
            got = tscan.cosine_scan_topk_auto(q, idx, k=8, sample=smp, row_meta=meta)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), step
        captures += 1
        assert _graph_counts()[0] == captures and len(cache) == 1
    assert not bool(torch.isin(got[1], torch.tensor([5, 77, 210000], device=dev)).any())


def test_threads_replaying_one_graph_get_their_own_results(monkeypatch):
    import threading

    dev = _card()
    idx, meta, smp, qs, spec, md = _graph_lib("cosine", dev)
    cache = _fresh_graphs(monkeypatch)
    make = spec[0]
    want = [fs._threshold_scan(make(qs[i]), idx.data, meta, smp, 8, md, None, None, "dist")
            for i in (0, 1)]
    for i in (0, 1):
        fs.threshold_pass(qs[i], spec, idx.data, meta, smp, 8, md)
    assert len(cache) == 1
    wrong, done = [], []

    def worker(i):
        for _ in range(30):
            got = fs.threshold_pass(qs[i], spec, idx.data, meta, smp, 8, md)
            if not all(torch.equal(a, b) for a, b in zip(got, want[i])):
                wrong.append(i)
        done.append(i)

    threads = [threading.Thread(target=worker, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and sorted(done) == [0, 1]
    assert not wrong and len(cache) == 1


def test_capture_beside_a_thread_scanning_eager(monkeypatch):
    """One thread captures graph after graph while another runs exact
    scans (K1b + K1c, not graphed) on the same card: both get the eager
    results, and every launch is counted once, where it ran."""
    import threading

    dev = _card()
    idx, meta, smp, qs, spec, md = _graph_lib("cosine", dev)
    cache = _fresh_graphs(monkeypatch)
    make = spec[0]
    ks = range(4, 12)
    want = {k: _counted(fs._threshold_scan, make(qs[0]), idx.data, meta, smp, k, md, None, None,
                        "dist") for k in ks}
    other_want, other_launches = _counted(fs.fused_cosine_scan_topk, qs[1], idx, meta, 8, md)
    for k in ks:                                         # each key's eager call
        fs.threshold_pass(qs[0], spec, idx.data, meta, smp, k, md)
    stop, other_calls, wrong = threading.Event(), [], []

    def other():
        while not stop.is_set():
            got = fs.fused_cosine_scan_topk(qs[1], idx, meta, 8, md)
            if not all(torch.equal(a, b) for a, b in zip(got, other_want)):
                wrong.append("other")
            other_calls.append(1)

    before = fs.launch_counts()
    t = threading.Thread(target=other)
    t.start()
    try:
        for k in ks:                                     # each captures, then replays
            for _ in range(2):
                got = fs.threshold_pass(qs[0], spec, idx.data, meta, smp, k, md)
                if not all(torch.equal(a, b) for a, b in zip(got, want[k][0])):
                    wrong.append(k)
    finally:
        stop.set()
        t.join(timeout=300)
    torch.cuda.synchronize(dev)
    assert not t.is_alive() and not wrong and len(cache) == len(ks) and other_calls
    added = {n: c - before[n] for n, c in fs.launch_counts().items() if c != before[n]}
    expect = {}
    for k in ks:
        for n, c in want[k][1].items():
            expect[n] = expect.get(n, 0) + 2 * c
    for n, c in other_launches.items():
        expect[n] = expect.get(n, 0) + len(other_calls) * c
    assert added == expect


def test_sharded_threshold_pass_graphed_matches_one_device(monkeypatch):
    from pixelbox_tpu_torch.parallel import sharded_scan as ss
    from pixelbox_tpu_torch.parallel.mesh import make_mesh

    dev = _card()
    idx, meta, smp, qs, spec, md = _graph_lib("cosine", dev, n=4 * 262144)
    cache = _fresh_graphs(monkeypatch)
    mesh = make_mesh(4)
    sh = ss.shard_semantic_index(idx, mesh)
    q = qs[0]
    c0, _ = _graph_counts()
    outs = [ss.sharded_threshold_pass(q, sh, 8, md, fs.CosineQueries.from_u8) for _ in range(3)]
    assert _graph_counts()[0] == c0 + 4 and len(cache) == 4     # a graph a shard
    for out in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(out, outs[0]))
    d, i, proven = outs[-1]
    ed, ei = fs.fused_cosine_scan_topk(q, idx, meta, k=8)
    assert bool(proven.any())
    assert torch.equal(d[proven], ed[proven]) and torch.equal(i[proven], ei[proven])
    for _ in range(3):
        got = ss.sharded_cosine_scan_topk_auto(q, sh, mesh, k=8)
        assert torch.equal(got[0], ed) and torch.equal(got[1], ei)
