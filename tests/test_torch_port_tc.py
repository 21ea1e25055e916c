"""The filters of the tensor-core collects (K1a and K2a on int8 wgmma,
``pixelbox_tpu_torch/csrc/tc_scan.cu``), held on the CPU through their
plain versions.

The kernels themselves run only on the card (``tests/test_torch_port_cuda.py``);
what makes their counts exact is arithmetic that a CPU can check; the
kernels compute the filters' per-query values op for op as the functions
held here (``key_bound``, ``hamming_pass_count``):

- K1a keeps a pair when ``fl(dot_c · rr) > key_bound(θ, qr)``, a loosened
  form of the cos key of ``cos_key_threshold``; then it applies the spec
  distance and the strict ``dist < θ`` to the survivors.  On seeded rows
  the bound must keep every ``dist < θ`` row, and the composition must
  select exactly those rows.
- K4a (the int4 kinds, D = 128) builds its A fragment from the packed
  nibbles, k-step by k-step: that dot must equal the JAX package's int4
  dot (its distances bit for bit); its phase-1 centered dot, built from a
  magic-number float (``tc_centered_f32``), must be exactly f32(dot_c) at
  the extreme codes; and K1a's bound on it must keep every ``dist < θ``
  row, so that with the strict θ it selects exactly the JAX rows.
- K2a multiplies the ±1 form of the hashes (zero past the byte limit):
  ``(8·limit − dot) >> 1`` must equal the popcount distance, its integer
  threshold must select exactly ``dist < θ``, and the top-k those
  distances give must equal the JAX package's ``hamming_scan_topk``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelbox_tpu.ops import int4 as jint4
from pixelbox_tpu.ops import scan as jscan
from pixelbox_tpu.ops.packed import PackedHammingIndex as JHIndex
from pixelbox_tpu_torch.ops import fused_scan as fs
from pixelbox_tpu_torch.ops import int4 as tint4
from pixelbox_tpu_torch.ops.oracle import quantize_embedding_np
from pixelbox_tpu_torch.ops.packed import PackedSemanticIndex, semantic_rows_from_u8


def _library(seed=11, n=2048, d=32):
    """Clustered u8 rows with a tie plateau (rows 100..399 copies of row 5)
    and 1% invalid rows; queries 0-1 a perturbed copy of row 5 (the plateau
    sits at one distance), 2-3 exact copies of row 9, then others."""
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((16, d)).astype(np.float32)
    db = quantize_embedding_np(np.tanh(c[rng.integers(0, 16, n)] + 0.35 * rng.standard_normal((n, d))))
    db[100:400] = db[5]
    valid = rng.uniform(size=n) > 0.01
    valid[[5, 9]] = True
    valid[100:400] = True
    q = db[rng.integers(0, n, 8)].copy()
    q[0] = db[5]
    q[0, :3] = np.clip(q[0, :3].astype(int) + 30, 0, 255)
    q[1] = q[0]
    q[2] = q[3] = db[9]
    data, rs, rm = semantic_rows_from_u8(db)
    idx = PackedSemanticIndex(*(torch.from_numpy(x) for x in (data, rs, rm, valid)))
    return idx, torch.from_numpy(q)


def test_key_filter_then_strict_theta_selects_the_dist_rows():
    idx, q = _library()
    meta = fs.build_row_meta(idx)
    qk = fs.CosineQueries.from_u8(q)
    dist, valid = fs._tile_dist(*qk, idx.data, meta)
    d = idx.data.shape[1]
    dot_c = fs._centered("cosine", fs._dot8(qk.q_codes, idx.data), qk.q_sum[:, None], meta[0][None, :], d)
    dc = dot_c.to(torch.float32)  # exact: |dot_c| < 2^24
    rr = meta[2].contiguous().view(torch.float32)
    plateau = dist[0, 5]
    assert bool((dist[0, 100:400] == plateau).all())
    # θ on the plateau (strict: the plateau is out), one value past it (in),
    # 0 (nothing, not even the identical vectors pinned to 0), tiny (only
    # those), the saturation and past it (every valid row), and two mid θ.
    theta = torch.tensor([
        float(plateau), float(torch.nextafter(plateau, torch.tensor(np.inf))), 0.0, 1e-7,
        fs.DIST_SATURATION, 2 * fs.DIST_SATURATION, 0.05, 0.3,
    ], dtype=torch.float32)
    strict = valid & (dist < theta[:, None])
    key = fs.cos_key_threshold(theta)
    spec_key = valid & (-(dc * (qk.qr[:, None] * rr[None, :])) < key[:, None])
    rr_key = torch.where(valid[0], rr, torch.full_like(rr, float("nan")))
    bound = (dc * rr_key[None, :]) > fs.key_bound(theta, qk.qr)[:, None]
    assert bool((strict <= spec_key).all()), "dist < θ escapes the cos key"
    assert bool((spec_key <= bound).all()), "the loosened bound drops a cos-key row"
    assert torch.equal(bound & (dist < theta[:, None]), strict)
    assert not bool(strict[0, 100:400].any()) and bool(strict[1, 100:400].all())
    assert float(dist[2, 9]) == 0.0  # identical vectors, pinned to 0
    assert not bool(strict[2].any()) and bool(strict[3, 9])
    # From the saturation on the key is +inf: the bound admits every valid
    # row, and past it so does θ (at it, the saturated rows stay out).
    assert torch.equal(bound[4], valid[0]) and torch.equal(bound[5], valid[0])
    assert torch.equal(strict[5], valid[0]) and not torch.equal(strict[4], valid[0])
    # The kernel's collect composes exactly this: the plain K1a agrees.
    count, _, _ = fs.cosine_threshold_collect_plain(*qk, theta, idx.data, meta, 4096)
    assert torch.equal(count, strict.sum(dim=1, dtype=torch.int32))


def _library4(mode, seed=13, n=2048, d=128):
    """An int4 index of clustered u8 rows with a tie plateau (rows
    100..399 copies of row 5), 1% invalid rows and the extreme rows (every
    code 15, every code 0) at 500 and 501; queries: 0-1 a perturbed copy
    of row 5, 2 an exact copy of row 9, 3-4 every u8 code 255 / 0 (asym
    codes 127 / -128, sym codes 15 / 0), then others."""
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((16, d)).astype(np.float32)
    db = quantize_embedding_np(np.tanh(c[rng.integers(0, 16, n)] + 0.35 * rng.standard_normal((n, d))))
    db[100:400] = db[5]
    db[500], db[501] = 255, 0
    valid = rng.uniform(size=n) > 0.01
    valid[[5, 9, 500, 501]] = True
    valid[100:400] = True
    q = db[rng.integers(0, n, 8)].copy()
    q[0] = db[5]
    q[0, :3] = np.clip(q[0, :3].astype(int) + 30, 0, 255)
    q[1] = q[0]
    q[2] = db[9]
    q[3], q[4] = 255, 0
    idx = tint4.build_semantic4_index(db, block_rows=n, device="cpu")
    idx = idx._replace(valid=torch.from_numpy(valid))
    return idx, fs.Int4Queries.from_u8(torch.from_numpy(q), mode)


def _nibble_dot8(q_codes: np.ndarray, packed: np.ndarray) -> np.ndarray:
    """The tensor-core K4a's int8 product at D = 128 as its threads build
    it: k-step t takes words 8m + tq (k = 4tq..4tq+3) and 8m + 4 + tq (k =
    16 + 4tq..) of each packed row, m = t % 2, masked (t < 2) or shifted
    by 4 and masked (t >= 2), against query dims 32t..32t+31."""
    words = packed.view("<u4").astype(np.int64)  # [N, 16]
    acc = np.zeros((q_codes.shape[0], packed.shape[0]), np.int64)
    for t in range(4):
        m, sh = t % 2, 4 * (t // 2)
        a = np.empty((packed.shape[0], 32), np.int64)
        for kp in range(32):
            half, tq, e = kp // 16, (kp % 16) // 4, kp % 4
            w = (words[:, 8 * m + 4 * half + tq] >> sh) & 0x0F0F0F0F
            a[:, kp] = (w >> (8 * e)) & 0xFF
        acc += q_codes[:, 32 * t : 32 * t + 32].astype(np.int64) @ a.T
    return acc


def _jax_dist4(qk, idx, max_distance):
    """The JAX package's int4 block distances (``_cosine4a_block_dist`` /
    ``_cosine4_block_dist``) on the same queries and rows."""
    fn = jint4._cosine4_block_dist if qk.sym else jint4._cosine4a_block_dist
    out = fn(
        jnp.asarray(qk.q_codes.numpy()), jnp.asarray(qk.q_sum.numpy()),
        jnp.asarray(qk.q_mag2.numpy().astype(np.float32)[:, None]), jnp.asarray(idx.data.numpy()),
        jnp.asarray(idx.row_sum.numpy()), jnp.asarray(idx.row_mag2.numpy()),
        jnp.asarray(idx.valid.numpy()), max_distance, qk.q_codes.shape[1],
    )
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("mode", ["asym", "sym"])
def test_int4_nibble_dot_matches_jax(mode):
    idx, qk = _library4(mode)
    meta = fs.build_row_meta(idx)
    kind = "cosine4" if qk.sym else "cosine4a"
    dot8 = _nibble_dot8(qk.q_codes.numpy(), idx.data.numpy())
    assert np.array_equal(dot8, fs._dot8(qk.q_codes, fs.unpack_u4(idx.data)).numpy())
    dot_c = fs._centered(kind, torch.from_numpy(dot8).to(torch.int32), qk.q_sum[:, None], meta[0][None, :], 128)
    dist, valid = fs._spec_dist(dot_c, qk.q_mag2, qk.qr, meta)
    dist = torch.where(valid, dist, torch.full_like(dist, float("inf"))).numpy()
    want = _jax_dist4(qk, idx, np.float32(np.inf))
    assert np.array_equal(dist.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("kind", ["cosine", "cosine4a", "cosine4"])
def test_phase1_centered_dot_is_exact_at_the_extremes(kind):
    """The magic-number f32 of phase 1 equals f32(dot_c) for every pair of
    extreme and random codes at D = 128 (u8: codes -128..127 both sides;
    asym: u8 - 128 queries against 4-bit rows; sym: 4-bit both sides)."""
    rng = np.random.default_rng(7)
    d = 128
    q_lo, q_hi = (0, 15) if kind == "cosine4" else (-128, 127)
    r_lo, r_hi = (-128, 127) if kind == "cosine" else (0, 15)
    q = np.concatenate([np.full((1, d), q_lo), np.full((1, d), q_hi),
                        rng.integers(q_lo, q_hi + 1, (30, d))]).astype(np.int64)
    r = np.concatenate([np.full((1, d), r_lo), np.full((1, d), r_hi),
                        np.where(np.arange(d) % 2, r_lo, r_hi)[None, :],
                        rng.integers(r_lo, r_hi + 1, (61, d))]).astype(np.int64)
    dot8 = torch.from_numpy(q @ r.T).to(torch.int32)
    q_sum, row_sum = torch.from_numpy(q.sum(1)), torch.from_numpy(r.sum(1))
    want = fs._centered(kind, dot8, q_sum[:, None].to(torch.int32), row_sum[None, :].to(torch.int32), d)
    assert int(want.abs().max()) >= 8_000_000  # the extremes reach |dot_c| = 255²·128
    got = fs.tc_centered_f32(kind, dot8, q_sum, row_sum, d)
    assert torch.equal(got, want.to(torch.float32))


@pytest.mark.parametrize("mode", ["asym", "sym"])
def test_int4_key_filter_then_strict_theta_selects_the_jax_rows(mode):
    idx, qk = _library4(mode)
    meta = fs.build_row_meta(idx)
    kind = "cosine4" if qk.sym else "cosine4a"
    dist, valid = fs._tile_dist4(*qk[:4], idx.data, meta, qk.sym)
    dot8 = fs._dot8(qk.q_codes, fs.unpack_u4(idx.data))
    dc = fs.tc_centered_f32(kind, dot8, qk.q_sum, meta[0], 128)
    rr = meta[2].contiguous().view(torch.float32)
    plateau = dist[0, 5]
    assert bool((dist[0, 100:400] == plateau).all())
    qn = qk.q_codes.shape[0]
    for theta_of in (
        lambda: torch.full((qn,), float(plateau)),
        lambda: torch.full((qn,), float(torch.nextafter(plateau, torch.tensor(np.inf)))),
        lambda: torch.zeros(qn), lambda: torch.full((qn,), 1e-7),
        lambda: torch.full((qn,), fs.DIST_SATURATION), lambda: torch.full((qn,), 2 * fs.DIST_SATURATION),
        lambda: torch.full((qn,), 0.05), lambda: torch.full((qn,), 0.3),
        lambda: torch.linspace(0.0, 2.0, qn),
    ):
        theta = theta_of().to(torch.float32)
        strict = valid & (dist < theta[:, None])
        rr_key = torch.where(valid[0], rr, torch.full_like(rr, float("nan")))
        bound = (dc * rr_key[None, :]) > fs.key_bound(theta, qk.qr)[:, None]
        assert bool((strict <= bound).all()), f"the bound drops a dist < θ row at θ {theta[:2]}"
        assert torch.equal(bound & (dist < theta[:, None]), strict)
        jax_rows = np.isfinite(_jax_dist4(qk, idx, jnp.asarray(theta.numpy())[:, None]))
        assert np.array_equal(strict.numpy(), jax_rows)
        count, _, _ = fs.cosine4_threshold_collect_plain(*qk[:4], theta, idx.data, meta, qk.sym, 4096)
        assert torch.equal(count, strict.sum(dim=1, dtype=torch.int32))
    # The extreme rows and queries: every code 15 / 0 against u8 255 / 0.
    assert float(dist[3, 500]) < float(dist[3, 501]) and float(dist[4, 501]) <= float(dist[4, 500])


def _pm1(x: np.ndarray, limit: int) -> np.ndarray:
    """u8 hashes [n, h] → ±1 int64 [n, 8h] (k = 8·byte + bit, LSB first),
    0 for the bytes at or past ``limit`` when ``limit`` is given."""
    bits = np.unpackbits(x, axis=1, bitorder="little").astype(np.int64)
    out = 2 * bits - 1
    if limit is not None:
        out[:, 8 * limit :] = 0
    return out


@pytest.mark.parametrize("wrap", [False, True], ids=["plain", "wrap"])
@pytest.mark.parametrize("limit", [18, 24, 32])
def test_pm1_product_gives_the_hamming_distance(limit, wrap):
    rng = np.random.default_rng(limit + 100 * wrap)
    h, n, qn, k = 32, 2048, 6, 20
    base = rng.integers(0, 256, (32, h), dtype=np.uint8)
    noise = rng.integers(0, 256, (n, h), dtype=np.uint8) & rng.integers(0, 256, (n, h), dtype=np.uint8)
    db = base[rng.integers(0, 32, n)] ^ (noise & rng.integers(0, 256, (n, h), dtype=np.uint8))
    db[200:260] = db[3]  # a tie plateau
    q = db[rng.integers(0, n, qn)].copy()
    q[0] = db[3]
    q[1] = ~db[7]  # every bit differs: 8·limit bits, wrapped to 0 at limit 32
    valid = rng.uniform(size=n) > 0.01
    dot = _pm1(q, limit) @ _pm1(db, None).T  # the queries carry the limit
    diff = (8 * limit - dot) >> 1
    qt, rt = torch.from_numpy(q), torch.from_numpy(db)
    assert np.array_equal(diff, fs.hamming_bits(qt, rt, limit).numpy())
    meta = torch.from_numpy(valid.astype(np.uint8))
    dist, _ = fs._hamming_tile_dist(qt, rt, meta, limit, wrap)
    theta = torch.tensor([0.0, float(dist[0, 200]), float(dist[0, 200]) + 1e-3, 0.2, 0.45, 2.0])
    t = fs.hamming_pass_count(theta, limit, wrap).numpy()[:, None]
    hit = ((diff & 255) < t) if wrap else (dot > 8 * limit - 2 * t)
    assert np.array_equal(hit, (dist < theta[:, None]).numpy())
    # The top-k these distances give, by (dist, id) over the valid rows
    # under max_distance, equals the JAX package's exact scan.
    md = np.float32(0.4)
    d = np.where(valid[None, :] & (dist.numpy() < md), dist.numpy(), np.inf)
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    got_d = np.take_along_axis(d, order, 1).astype(np.float32)
    got_i = np.where(np.isfinite(got_d), order, -1)
    want_d, want_i = jscan.hamming_scan_topk(
        jnp.asarray(q), JHIndex(jnp.asarray(db), jnp.asarray(valid)), k=k, max_distance=float(md),
        wrap_u8=wrap, byte_limit=limit,
    )
    np.testing.assert_array_equal(got_i, np.asarray(want_i))
    assert np.array_equal(got_d.view(np.uint32), np.asarray(want_d, np.float32).view(np.uint32))
