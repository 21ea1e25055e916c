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
from pixelbox_tpu_torch.ops import scan as tscan
from pixelbox_tpu_torch.ops.oracle import quantize_embedding_np
from pixelbox_tpu_torch.ops.packed import PackedSemanticIndex, semantic_rows_from_u8

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
