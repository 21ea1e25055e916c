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
    assert counts["cosine_threshold_collect"] > 0 and counts["lex_topk_segments"] > 0
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
    assert counts["cosine4_threshold_collect"] > 0 and counts["lex_topk_segments"] > 0
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
    per-shard K1a + K1c and the K1c merge give the one-device results."""
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
    assert counts["cosine_threshold_collect"] >= 8 and counts["lex_topk_segments"] >= 9
    want = tscan.cosine_scan_topk(q, idx, k=50)
    assert torch.equal(got[0].cpu(), want[0].cpu()) and torch.equal(got[1].cpu(), want[1].cpu())
    ph = PackedHammingIndex(idx.data.view(torch.uint8)[:, :32].contiguous(), idx.valid)
    hq = q[:, :32].contiguous()  # u8 rows and queries as 32-byte hashes
    got = ss.sharded_hamming_scan_topk(hq, ss.shard_hamming_index(ph, mesh), mesh, k=20)
    want = hg.hamming_gemm_scan_topk(hq, ph, k=20)
    assert torch.equal(got[0].cpu(), want[0].cpu()) and torch.equal(got[1].cpu(), want[1].cpu())


@pytest.mark.parametrize("rung", ["gemm", "coskey", "epilogue", "chain"])
def test_ladder_rungs_match_plain(rung):
    from pixelbox_tpu_torch.ops.packed import query_moments_from_u8
    from pixelbox_tpu_torch.tools import measure_breakdown as mb

    dev = _card()
    q, idx, meta = mb.ladder_inputs(1 << 16, 128, 40, seed=3, planted=True, device=dev)
    mom = query_moments_from_u8(q[0])
    before = mb.LAUNCHES["breakdown_ladder"]
    out, dsum = mb.ladder(rung, *mom, idx.data, meta, 4096)
    torch.cuda.synchronize()
    assert mb.LAUNCHES["breakdown_ladder"] == before + 1
    pout, psum = mb.ladder_plain(rung, *mom, idx.data, meta, 4096)
    assert torch.equal(out.view(torch.int32), pout.view(torch.int32)) and torch.equal(dsum, psum)
    lanes = out if rung in ("gemm", "chain") else out[:, :1]
    assert bool(torch.isfinite(lanes).all())
