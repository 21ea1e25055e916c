"""K1c, the top-k by (dist, id) (``fused_scan.lex_topk`` on the select
kernel ``lex_topk_select``, ``pixelbox_tpu_torch/csrc/fused_scan.cu``),
held on the CPU through its plain version.

The kernel itself runs only on the card (``tests/test_torch_port_cuda.py``
and ``chip_smoke.py`` hold it bit-identical to the plain version); here
the plain version (one sort of the int64 (dist, id) keys, the first k)
must equal the first port's re-launch chain (``lex_topk_segments_chain``
on ``lex_topk_segments_plain``) and the JAX package's ``lex_topk`` +
``finalize_topk`` on the same seeded candidates, and ``lex_topk`` must
cut only rows longer than ``SELECT_SLOTS`` into a second call.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelbox_tpu.ops import topk as jtopk
from pixelbox_tpu_torch.ops import fused_scan as fs

#: One query a case: its row, and lens[q] where lens are given.
CASES = ("random", "lens_0", "lens_below_k", "lens_k", "lens_past_m", "all_inf", "negative_ids",
         "plateau")


def _candidates(m, k, seed):
    """[Q, M] candidates (dist >= 0, ids unique in a row), one query per
    case of CASES, and their lens [Q]."""
    rng = np.random.default_rng(seed)
    qn = len(CASES)
    dist = (2 * rng.random((qn, m))).astype(np.float32)
    idx = np.stack([rng.permutation(4 * m)[:m] for _ in range(qn)]).astype(np.int32)
    lens = np.full(qn, m, np.int32)
    dist[0, rng.random(m) < 0.1] = np.inf  # empty slots among the filled ones
    lens[1] = 0
    lens[2] = max(0, k - 1)
    lens[3] = min(k, m)
    lens[4] = m + 7
    dist[5] = np.inf
    neg = rng.random(m) < 0.5
    idx[6, neg] = -1 - rng.integers(0, 100, int(neg.sum()))
    dist[6, rng.random(m) < 0.05] = np.nan
    # A plateau of 2k + 5 equal distances with k // 3 entries below it: the
    # k-th key lies inside the plateau, which only the ids order.
    dist[7] = (0.6 + rng.random(m)).astype(np.float32)
    at = rng.permutation(m)
    n_on, n_below = 2 * k + 5, k // 3
    dist[7, at[:n_on]] = np.float32(0.5)
    dist[7, at[n_on : n_on + n_below]] = (0.4 * rng.random(n_below)).astype(np.float32)
    return dist, idx, lens


def _jax_topk(dist, idx, k, lens):
    """The JAX package's lex_topk + finalize_topk on the same candidates;
    its empty entries (past lens, negative ids) given as +inf first.  One
    sort of the whole row (its segment widened to M: its tree merge of
    16,384-wide segments gives the same result and compiles for seconds)."""
    m = dist.shape[1]
    empty = ~np.isfinite(dist) | (idx < 0)
    if lens is not None:
        empty |= np.arange(m)[None, :] >= lens[:, None]
    d, i = jtopk.lex_topk(jnp.asarray(np.where(empty, np.inf, dist)), jnp.asarray(idx), k,
                          segment=max(m, 16384))
    d, i = jtopk.finalize_topk(d, i)
    return np.asarray(d, np.float32), np.asarray(i, np.int32)


def _same(got, want):
    d, i = (x.numpy() if torch.is_tensor(x) else x for x in got)
    assert np.array_equal(d.view(np.uint32), np.asarray(want[0], np.float32).view(np.uint32))
    assert np.array_equal(i, want[1])


@pytest.mark.parametrize("with_lens", [True, False], ids=["lens", "no_lens"])
@pytest.mark.parametrize(
    "m,k", [(2048, 1), (2048, 20), (4096, 100), (16384, 400), (20000, 100), (20000, 1024)])
def test_select_plain_equals_the_chain_and_jax(m, k, with_lens):
    dist, idx, lens = _candidates(m, k, seed=m + k)
    lens_t = torch.from_numpy(lens) if with_lens else None
    d, i = torch.from_numpy(dist), torch.from_numpy(idx)
    got = fs.lex_topk(d, i, k, lens_t)
    fs.reset_launch_counts()
    _same(got, fs.lex_topk_segments_chain(d, i, k, lens_t))
    _same(got, _jax_topk(dist, idx, k, lens if with_lens else None))
    if m <= fs.SELECT_SLOTS:  # one call: the plain version itself
        one = fs.lex_topk_select_plain(d, i, k, lens_t)
        _same((one[0][:, 0], one[1][:, 0]), _jax_topk(dist, idx, k, lens if with_lens else None))
    assert fs.launch_counts() == {n: 0 for n in fs.LAUNCHES}  # CPU tensors launch nothing
    if with_lens:
        assert bool((got[1][1] == -1).all()) and bool((got[1][5] == -1).all())
        assert int((got[1][2] >= 0).sum()) == k - 1
    pl = got[0][7].numpy()
    if k >= 3:  # the plateau holds the k-th entry; its ids ascend
        on = pl == np.float32(0.5)
        assert on[-1] and np.all(np.diff(got[1][7].numpy()[on]) > 0)


@pytest.mark.parametrize(
    "m,k,calls", [(2048, 20, 1), (16384, 400, 1), (16385, 100, 2), (102400, 100, 2), (409600, 400, 2)])
def test_lex_topk_cuts_only_long_rows(monkeypatch, m, k, calls):
    """One select call for a row of up to SELECT_SLOTS entries; the exact
    scans' chunk partials (1,024 chunks of 1M rows at k = 100 and 400) take
    two, the second over at most SELECT_SLOTS slice results."""
    rng = np.random.default_rng(m)
    d = torch.from_numpy(rng.random((2, m), dtype=np.float32))
    i = torch.from_numpy(np.tile(np.arange(m, dtype=np.int32), (2, 1)))
    seen = []
    select = fs.lex_topk_select

    def spy(dist, idx, kk, lens=None, segment=None):
        seen.append((dist.shape[1], segment))
        return select(dist, idx, kk, lens, segment)

    monkeypatch.setattr(fs, "lex_topk_select", spy)
    got = fs.lex_topk(d, i, k)
    assert len(seen) == calls
    assert seen[-1] == (seen[-1][0], None) and seen[-1][0] <= fs.SELECT_SLOTS
    want = torch.sort(d, dim=1, stable=True)
    assert torch.equal(got[0], want.values[:, :k]) and torch.equal(got[1], want.indices[:, :k].to(torch.int32))


def test_select_refuses_what_the_kernel_cannot_take():
    d = torch.rand(2, 100)
    i = torch.arange(100, dtype=torch.int32).expand(2, -1).contiguous()
    with pytest.raises(ValueError, match="outside the select kernel"):
        fs.lex_topk_select(d, i, fs.MAX_K + 1)
    with pytest.raises(ValueError, match="outside the select kernel"):
        fs.lex_topk_select(d, i, 0)
    with pytest.raises(ValueError, match="outside the select kernel"):
        fs.lex_topk_select(d, i, 5, segment=fs.SELECT_SLOTS + 1)
    with pytest.raises(ValueError, match="int32"):
        fs.lex_topk_select(d, i.long(), 5)
