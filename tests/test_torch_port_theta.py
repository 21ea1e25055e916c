"""The θ stage of the port (``fused_scan.sample_theta``) on the CPU.

The same numpy-seeded samples and queries go through the JAX package's
``_pallas_sample_theta`` (its Pallas carry kernel in interpret mode, as the
JAX package's own tests run it) and through the port, whose CPU path is
``sample_theta_plain``: θ equal bit for bit for the kinds cosine,
cosine4a, cosine4 and hamming (a byte limit below 32, and the u8 wrap) on
data that overflows neither the JAX round bound nor the port's buffer.
Both fallback branches (fewer than j rows under θ0; more than the buffer)
and a Hamming tie plateau are held against a numpy model of the
definition; a numpy model of the θ kernel's own algorithm
(``csrc/tc_theta.cu``: launch A's parts, their j0-th select and the
last block's merge; launch B's parts, exact counts and the j-th select)
against ``sample_theta_plain`` over several launch plans; and stage 1 at
the widths the θ kernel does not take (the chunk top-k + K1c) against
the plain-torch mini-sample.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pixelbox_tpu.ops import pallas_scan as jps
from pixelbox_tpu.ops.oracle import quantize_embedding_np
from pixelbox_tpu_torch.ops import fused_scan as fs
from pixelbox_tpu_torch.ops import int4 as T
from pixelbox_tpu_torch.ops.packed import PackedSemanticIndex, semantic_rows_from_u8
from pixelbox_tpu_torch.ops.scan import ScanSample

S = 4096  # sample rows: the mini-sample takes every 4th (1,024 rows)


def clustered(rng, n, d, centers=48):
    c = rng.standard_normal((centers, d)).astype(np.float32)
    x = c[rng.integers(0, centers, n)] + 0.35 * rng.standard_normal((n, d)).astype(np.float32)
    return quantize_embedding_np(np.tanh(x))


def phash_rows(rng, n, h, centers=32):
    base = rng.integers(0, 256, (centers, h), dtype=np.uint8)
    flips = (rng.integers(0, 256, (n, h), dtype=np.uint8) & rng.integers(0, 256, (n, h), dtype=np.uint8)
             & rng.integers(0, 256, (n, h), dtype=np.uint8))
    return base[rng.integers(0, centers, n)] ^ flips


def bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def cosine_case(rng, kind, n, d, qn, valid=None):
    """(queries, ScanSample) of a cosine kind over n rows of d dims; int4
    rows are quantized to 4 bits and packed."""
    db = clustered(rng, n, d)
    if valid is None:
        valid = np.ones(n, bool)
    q = db[rng.integers(0, n, qn)].copy()
    q[1:] ^= rng.integers(0, 2, q[1:].shape, dtype=np.uint8) << 2  # perturbed copies
    if kind == "cosine":
        data, rs, rm = semantic_rows_from_u8(db)
        idx = PackedSemanticIndex(*(torch.from_numpy(np.ascontiguousarray(v)) for v in (data, rs, rm, valid)))
        smp = ScanSample(idx.data, fs.build_row_meta(idx))
        return fs.CosineQueries.from_u8(torch.from_numpy(q)), smp
    idx = T.build_semantic4_index(db, block_rows=n, device="cpu")._replace(valid=torch.from_numpy(valid))
    smp = ScanSample(idx.data, T.build_semantic4_meta(idx))
    mode = "sym" if kind == "cosine4" else "asym"
    return fs.Int4Queries.from_u8(torch.from_numpy(q), mode), smp


def hamming_case(rng, n, qn, limit, wrap, valid=None):
    db = phash_rows(rng, n, 32)
    if wrap:  # distances past 255 bits: rows far from every query
        db[: n // 4] = ~db[: n // 4]
    if valid is None:
        valid = np.ones(n, bool)
    q = db[rng.integers(n // 4, n, qn)] ^ (rng.integers(0, 256, (qn, 32), dtype=np.uint8)
                                          & rng.integers(0, 256, (qn, 32), dtype=np.uint8)
                                          & rng.integers(0, 256, (qn, 32), dtype=np.uint8))
    smp = ScanSample(torch.from_numpy(db), torch.from_numpy(valid.astype(np.uint8)))
    return fs.HammingQueries(torch.from_numpy(q), limit, wrap), smp


# --------------------------------------------------------------------- #
# (a) The port's θ against the JAX package's _pallas_sample_theta


def jax_sample_theta(qk, smp, md, j):
    """The JAX θ stage on the same sample, queries prepared by the JAX
    package (padded to 32 rows as its wrappers pad them)."""
    if qk.kind == "hamming":
        lim = qk.byte_limit
        pm1 = lambda x: (np.unpackbits(x[:, :lim], axis=1, bitorder="little").astype(np.int8) * 2 - 1)  # noqa: E731
        q_codes = jnp.asarray(pm1(qk.q.numpy()))
        qr = jnp.zeros((q_codes.shape[0], 1), jnp.float32)
        data = jnp.asarray(pm1(smp.data.numpy()))
        valid = smp.meta.numpy().astype(np.int32)
        meta = jnp.asarray(np.stack([valid] + [np.zeros_like(valid)] * 3))
        dim = 8 * lim
    else:
        q_codes = jnp.asarray(qk.q_codes.numpy())
        qr = jnp.asarray(qk.qr.numpy())[:, None]
        data, meta = jnp.asarray(smp.data.numpy()), jnp.asarray(smp.meta.numpy())
        dim = qk.q_codes.shape[1]
    qn = q_codes.shape[0]
    pad = max(32, -(-qn // 32) * 32)
    q_p = jps._pad_rows(q_codes, qn, pad)
    qr_p = jps._pad_rows(qr, qn, pad)
    with pltpu.force_tpu_interpret_mode():
        th = jps._pallas_sample_theta(
            qk.kind, q_p, qr_p, data, meta, jnp.float32(md), j, dim=dim, tile_rows=512,
            wrap_u8=getattr(qk, "wrap_u8", False),
        )
    return np.asarray(th)[:qn, 0]


@pytest.mark.parametrize(
    "case,md,j",
    [("cosine", 1e3, 20), ("cosine_tombstones", 0.08, 12), ("cosine4a", 1e3, 20),
     ("cosine4", 1e3, 16), ("hamming_limit24", 1e3, 20), ("hamming_wrap", 0.45, 20)],
)
def test_sample_theta_vs_pallas_interpret(case, md, j):
    rng = np.random.default_rng(sum(map(ord, case)))
    qn = 12
    if case.startswith("hamming"):
        qk, smp = hamming_case(rng, S, qn, 24 if case == "hamming_limit24" else 32, case == "hamming_wrap")
    else:
        valid = rng.uniform(size=S) > 0.05 if case == "cosine_tombstones" else None
        kind = "cosine" if case.startswith("cosine_") else case
        qk, smp = cosine_case(rng, kind, S, 64 if kind == "cosine" else 128, qn, valid)
    got = fs.sample_theta(qk, smp, md, j)
    want = jax_sample_theta(qk, smp, md, j)
    # Data that overflows neither side: the port's count stays in its buffer.
    theta0 = fs.mini_sample_theta(qk, smp, md, j)
    count = fs._collect_plain(lambda lo, hi: qk.dist(smp.data[lo:hi], smp.meta[..., lo:hi]),
                              qn, S, theta0, fs.sample_cap(j), S)[0]
    assert int(count.max()) <= fs.sample_cap(j)
    assert np.array_equal(bits(got.numpy()), bits(want))
    assert np.isfinite(got.numpy()).all() and (got.numpy() <= np.float32(md)).all()
    assert (got != theta0).any(), "no query took stage 2's j-th"
    assert torch.equal(got, fs.sample_theta_plain(qk, smp, md, j))
    assert torch.equal(got, fs.sample_theta_chain(qk, smp, md, j))


# --------------------------------------------------------------------- #
# (b) The fallback branches and a tie plateau against the definition


def dists(qk, data, meta):
    d, v = qk.dist(data.contiguous(), meta.contiguous())
    return d.numpy(), np.broadcast_to(v.numpy(), d.shape)


def definition(qk, smp, md, j):
    """θ by its definition (numpy): θ0 the j0-th of the valid mini rows
    under md (md where fewer), count the sample rows under θ0, θ their
    j-th where j <= count <= cap, else θ0.  Returns (θ, θ0, count)."""
    stride, _, j0 = fs.mini_sample_shape(smp.data.shape[0], j)
    md = np.float32(md)
    d0, v0 = dists(qk, smp.data[::stride], smp.meta[..., ::stride])
    d0 = np.sort(np.where(v0 & (d0 < md), d0, np.inf), axis=1)
    theta0 = np.minimum(d0[:, j0 - 1], md).astype(np.float32)
    d, v = dists(qk, smp.data, smp.meta)
    under = v & (d < theta0[:, None])
    count = under.sum(axis=1)
    theta = theta0.copy()
    for q in range(d.shape[0]):
        if j <= count[q] <= fs.sample_cap(j):
            theta[q] = np.sort(d[q][under[q]])[j - 1]
    return theta, theta0, count


def test_fallback_when_fewer_than_j_rows_are_under_theta0(rng):
    qk, smp = cosine_case(rng, "cosine", S, 64, 10)
    md, j = 0.0005, 20  # under md: the query's own copy, if any
    theta, theta0, count = definition(qk, smp, md, j)
    assert (count < j).all() and np.array_equal(theta0, np.full(10, np.float32(md)))
    got = fs.sample_theta(qk, smp, md, j)
    assert np.array_equal(bits(got.numpy()), bits(theta))


def test_fallback_when_the_buffer_overflows(rng):
    """3,000 copies of query 0's row on rows the mini-sample skips: they
    are all under θ0, more than the 2,048-row buffer."""
    n, j = 8192, 20
    qk, smp = cosine_case(rng, "cosine", n, 128, 8)
    q0 = (qk.q_codes[0].to(torch.int16) + 128).to(torch.uint8).numpy()
    rows = np.array([r for r in range(n) if r % 8][:3000])
    data = smp.data.clone()
    data[rows] = qk.q_codes[0]
    d_u8, rs, rm = semantic_rows_from_u8(np.repeat(q0[None], 1, 0))
    meta = smp.meta.clone()
    meta[0, rows], meta[1, rows] = int(rs[0]), int(rm[0])
    meta[2, rows] = fs.rsqrt_spec(torch.tensor([float(rm[0])])).view(torch.int32)
    smp = ScanSample(data, meta)
    theta, theta0, count = definition(qk, smp, 1e3, j)
    assert count[0] > fs.sample_cap(j) and theta[0] == theta0[0]
    assert (count[1:] <= fs.sample_cap(j)).all()
    got = fs.sample_theta(qk, smp, 1e3, j)
    assert np.array_equal(bits(got.numpy()), bits(theta))


def test_hamming_tie_plateau(rng):
    """Every sample row 2 or 3 bits from query 0: θ sits on a plateau."""
    h, j = 32, 20
    q = rng.integers(0, 256, (4, h), dtype=np.uint8)
    db = phash_rows(rng, S, h)
    for r in range(0, S, 2):
        flip = rng.choice(8 * h, 2 + r % 4 // 2, replace=False)
        row = q[0].copy()
        np.bitwise_xor.at(row, flip // 8, (1 << (flip % 8)).astype(np.uint8))
        db[r] = row
    smp = ScanSample(torch.from_numpy(db), torch.ones(S, dtype=torch.uint8))
    qk = fs.HammingQueries(torch.from_numpy(q), h, False)
    theta, _, count = definition(qk, smp, 1e3, j)
    assert theta[0] == np.float32(2 * np.float32(1 / 256))
    got = fs.sample_theta(qk, smp, 1e3, j)
    assert np.array_equal(bits(got.numpy()), bits(theta))


# --------------------------------------------------------------------- #
# (c) A model of the θ kernel's algorithm against sample_theta_plain


def plan_ok(n, parts, tpp):
    """The C entry's check of a launch's plan (csrc/tc_theta.cu)."""
    tiles = -(-n // 64)
    return parts >= 1 and tpp >= 1 and (parts - 1) * tpp < tiles <= parts * tpp


def kernel_model(qk, smp, md, j, plan):
    """θ as ``csrc/tc_theta.cu`` computes it, in numpy, on the plain
    distances.  Launch A: per query tile and part of tpp0 tiles, a part's
    values (+inf where invalid or at/past md) and its published j0: its kk
    smallest (kk = min(j0, rows)), +inf to j0; the last block selects the
    j0-th of the parts' (θ0, at most md).  Launch B: per part the rows
    passing phase 1 (cosine kinds: K1a's key bound of θ0 on the f32
    centered dot · rr, which must keep every row under θ0; Hamming: the
    exact integer threshold) and dist < θ0, appended with an exact count;
    the last block takes the j-th where j <= count <= cap."""
    s = smp.data.shape[0]
    stride, s0, j0 = fs.mini_sample_shape(s, j)
    cap = fs.sample_cap(j)
    (nq0, p0, t0), (nq1, p1, t1) = plan
    assert plan_ok(s0, p0, t0) and plan_ok(s, p1, t1) and nq0 * t0 * 64 <= fs.THETA_VALS
    md = np.float32(md)
    d0, v0 = dists(qk, smp.data[::stride], smp.meta[..., ::stride])
    vals = bits(np.where(v0 & (d0 < md), d0, np.inf))
    qn = vals.shape[0]
    published = np.empty((qn, p0, j0), np.uint32)
    for p in range(p0):
        part = vals[:, p * t0 * 64:(p + 1) * t0 * 64]
        kk = min(j0, part.shape[1])
        published[:, p, :kk] = np.sort(part, axis=1)[:, :kk]
        published[:, p, kk:] = bits(np.inf)
    t0v = np.sort(published.reshape(qn, -1), axis=1)[:, j0 - 1].view(np.float32)
    theta0 = np.where(t0v < md, t0v, md).astype(np.float32)

    d, v = dists(qk, smp.data, smp.meta)
    passing = v & (d < theta0[:, None])
    if qk.kind != "hamming":
        dot8 = fs._dot8(qk.q_codes, smp.data if qk.kind == "cosine" else fs.unpack_u4(smp.data))
        dc = fs.tc_centered_f32(qk.kind, dot8, qk.q_sum, smp.meta[0], qk.q_codes.shape[1])
        rr = smp.meta[2].contiguous().view(torch.float32)
        u = fs.key_bound(torch.from_numpy(theta0), qk.qr)
        key = ((dc * rr[None, :]) > u[:, None]).numpy() & v
    else:
        pass_count = fs.hamming_pass_count(torch.from_numpy(theta0), qk.byte_limit, qk.wrap_u8).numpy()
        diff = fs.hamming_bits(qk.q, smp.data, qk.byte_limit).numpy()
        key = ((diff & 255) if qk.wrap_u8 else diff) < pass_count[:, None]
        key &= v
    assert not (passing & ~key).any(), "phase 1 dropped a row under θ0"
    passing &= key
    theta = theta0.copy()
    for q in range(qn):
        count, cand = 0, []
        for p in range(p1):
            sl = slice(p * t1 * 64, (p + 1) * t1 * 64)
            hit = d[q, sl][passing[q, sl]]
            cand.extend(hit[: max(0, cap - count)])
            count += hit.size
        if j <= count <= cap:
            theta[q] = np.sort(np.asarray(cand, np.float32))[j - 1]
    return theta


@pytest.mark.parametrize("kind", ["cosine", "cosine4a", "cosine4", "hamming"])
def test_kernel_model_matches_plain(rng, kind):
    qn, md, j = 40, 1e3, 24
    if kind == "hamming":
        qk, smp = hamming_case(rng, 8192, qn, 32, False)
    else:
        valid = rng.uniform(size=8192) > 0.02
        qk, smp = cosine_case(rng, kind, 8192, 128 if kind != "cosine" else 32, qn, valid)
    s = smp.data.shape[0]
    _, s0, _ = fs.mini_sample_shape(s, j)
    want = fs.sample_theta_plain(qk, smp, md, j)
    plans = {fs.theta_plan(qn, s, s0, sms) for sms in (1, 5, 132)}
    plans |= {((8, 1, 16), (32, 1, 128)), ((32, 4, 4), (16, 3, 50)), ((8, 3, 7), (8, 19, 7))}
    for plan in sorted(plans):
        got = kernel_model(qk, smp, md, j, plan)
        assert np.array_equal(bits(got), bits(want.numpy())), plan


def test_kernel_model_fallbacks_match_plain(rng):
    """Both fallbacks through the model: md past few rows (fewer than j
    under θ0) and a sample under θ0 past the buffer (j = 8, cap 2048, a
    mini-sample whose θ0 admits most of the sample)."""
    qk, smp = cosine_case(rng, "cosine", S, 64, 6)
    s0 = fs.mini_sample_shape(S, 20)[1]
    for md, j in ((0.0005, 20), (1e3, 700)):
        want = fs.sample_theta_plain(qk, smp, md, j)
        for plan in (fs.theta_plan(6, S, s0, 132), ((8, 1, 16), (8, 1, 64))):
            got = kernel_model(qk, smp, md, j, plan)
            assert np.array_equal(bits(got), bits(want.numpy()))


@pytest.mark.parametrize("qn", [1, 7, 8, 33, 256, 257, 2048])
@pytest.mark.parametrize("s", [1024, 4096, 65536, 100000, 131072])
def test_theta_plan_is_valid(qn, s):
    """Every plan the wrapper makes passes the C entry's checks and uses
    the query tiles the kernel instantiates."""
    _, s0, _ = fs.mini_sample_shape(s, 20)
    for sms in (1, 66, 132):
        (nq0, p0, t0), (nq1, p1, t1) = fs.theta_plan(qn, s, s0, sms)
        assert nq0 in fs.THETA_A_QUERIES and nq1 in fs.THETA_B_QUERIES
        assert plan_ok(s0, p0, t0) and plan_ok(s, p1, t1) and nq0 * t0 * 64 <= fs.THETA_VALS


# --------------------------------------------------------------------- #
# (d) Stage 1 on the hand kernels at the other widths


@pytest.mark.parametrize(
    "kind,width", [("cosine", 36), ("cosine", 8), ("cosine", 128), ("cosine4a", 64),
                   ("cosine4", 64), ("hamming", 18), ("hamming", 32)],
)
def test_chunk_stage1_matches_the_mini_sample(rng, kind, width):
    qn, j = 20, 30
    if kind == "hamming":
        db = phash_rows(rng, S, width)
        smp = ScanSample(torch.from_numpy(db), torch.from_numpy((rng.uniform(size=S) > 0.03).astype(np.uint8)))
        qk = fs.HammingQueries(torch.from_numpy(db[rng.integers(0, S, qn)]), width, False)
    else:
        qk, smp = cosine_case(rng, kind, S, width, qn, rng.uniform(size=S) > 0.03)
    for md in (1e3, 0.05):
        want = fs.mini_sample_theta(qk, smp, md, j)
        got = fs.mini_sample_chunk_theta(qk, smp, md, j)
        assert torch.equal(got, want)
