"""pixelbox_tpu_torch ops vs pixelbox_tpu ops on the CPU: bit-identical.

Same numpy-seeded inputs through the JAX function and its torch
counterpart; every f32 result is compared on its bits (np.array_equal on
the uint32 views) and every id exactly.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pixelbox_tpu.ops import distances as jd
from pixelbox_tpu.ops import packed as jp
from pixelbox_tpu.ops import quantize as jq
from pixelbox_tpu.ops import topk as jt
from pixelbox_tpu_torch.ops import distances as td
from pixelbox_tpu_torch.ops import packed as tp
from pixelbox_tpu_torch.ops import quantize as tq
from pixelbox_tpu_torch.ops import topk as tt


def bits_equal(a, b) -> bool:
    a = np.ascontiguousarray(np.asarray(a, dtype=np.float32))
    b = np.ascontiguousarray(np.asarray(b, dtype=np.float32))
    return a.shape == b.shape and np.array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize(
    "values",
    [
        [1.0, -1.0, 0.0, -0.0, 0.999, -0.999, 0.5, 1.0 / 128, -1.0 / 128, 127.9 / 128],
        [np.nan, np.inf, -np.inf, 3.0, -3.0, 1e30, -1e30, 1.0000001, -1.0000001],
    ],
    ids=["edges", "nan_and_saturation"],
)
def test_quantize_edge_values(values):
    x = np.asarray(values, np.float32)
    got = tq.quantize_embedding(torch.from_numpy(x)).numpy()
    want = np.asarray(jq.quantize_embedding(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)


def test_quantize_random_and_rust_cast_anchors(rng):
    x = rng.uniform(-1.2, 1.2, size=(64, 128)).astype(np.float32)
    np.testing.assert_array_equal(
        tq.quantize_embedding(torch.from_numpy(x)).numpy(),
        np.asarray(jq.quantize_embedding(jnp.asarray(x))),
    )
    anchors = tq.quantize_embedding(torch.tensor([1.0, -1.0, 0.0, 0.999, float("nan")]))
    assert anchors.tolist() == [255, 0, 128, 255, 128]


def test_center_and_dequantize(rng):
    q = rng.integers(0, 256, size=(16, 64), dtype=np.uint8)
    np.testing.assert_array_equal(
        tq.center_u8(torch.from_numpy(q)).numpy(), np.asarray(jq.center_u8(jnp.asarray(q)))
    )
    all_bytes = np.arange(256, dtype=np.uint8)
    assert bits_equal(
        tq.dequantize_embedding(torch.from_numpy(all_bytes)).numpy(),
        jq.dequantize_embedding(jnp.asarray(all_bytes)),
    )


@pytest.mark.parametrize("dim", [8, 32, 128, 256])
def test_packed_moments(rng, dim):
    q = rng.integers(0, 256, size=(33, dim), dtype=np.uint8)
    got = tp.query_moments_from_u8(torch.from_numpy(q))
    want = jp.query_moments_from_u8(jnp.asarray(q))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(tp.semantic_rows_from_u8(q), jp.semantic_rows_from_u8(q)):
        np.testing.assert_array_equal(g, w)


def test_rsqrt_spec_over_the_moment_domain():
    # Every integer magnitude a u8 row of width <= 256 can have, plus 0.
    x = np.concatenate([[0.0], np.arange(1, 256 * 255 * 255 + 1, 37)]).astype(np.float32)
    got = td.rsqrt_spec(torch.from_numpy(x)).numpy()
    want = np.asarray(jd.rsqrt_spec(jnp.asarray(x)))
    assert bits_equal(got, want)
    with np.errstate(divide="ignore"):
        assert bits_equal(got, np.float32(1.0) / np.sqrt(x))


@pytest.mark.parametrize("dim", [8, 32, 128])
def test_cosine_distance_bits(rng, dim):
    a = rng.integers(0, 256, size=(24, dim), dtype=np.uint8)
    b = rng.integers(0, 256, size=(300, dim), dtype=np.uint8)
    b[:5] = a[:5]                  # identical pairs pin to exactly 0
    b[5] = 255 - a[5]              # anti-parallel: saturated distance
    b[6] = a[6] // 2 + 64          # near-parallel
    got = td.cosine_distance(torch.from_numpy(a)[:, None, :], torch.from_numpy(b)[None])
    want = jd.cosine_distance(jnp.asarray(a)[:, None, :], jnp.asarray(b)[None])
    assert bits_equal(got.numpy(), want)
    assert (got.numpy()[np.arange(5), np.arange(5)] == 0.0).all()


def test_byte_and_hamming_distance_bits(rng):
    a = rng.integers(0, 256, size=(12, 32), dtype=np.uint8)
    b = rng.integers(0, 256, size=(200, 32), dtype=np.uint8)
    b[0] = ~a[0]  # 256 differing bits: wraps to 0 under wrap_u8
    ta, tb = torch.from_numpy(a)[:, None, :], torch.from_numpy(b)[None]
    ja, jb = jnp.asarray(a)[:, None, :], jnp.asarray(b)[None]
    assert bits_equal(td.byte_distance(ta, tb).numpy(), jd.byte_distance(ja, jb))
    for wrap in (False, True):
        assert bits_equal(
            td.hamming_distance(ta, tb, wrap_u8=wrap).numpy(),
            jd.hamming_distance(ja, jb, wrap_u8=wrap),
        )


@pytest.mark.parametrize("k", [1, 7, 100, 128])
def test_merge_sorted_topk(rng, k):
    def sorted_list():
        d = np.sort(rng.integers(0, 6, size=(5, k)).astype(np.float32), axis=1)
        d[:, -max(1, k // 4):] = np.inf
        i = np.stack([np.sort(rng.choice(1000, k, replace=False)) for _ in range(5)])
        order = np.lexsort((i, d), axis=1)
        return (np.take_along_axis(d, order, 1),
                np.take_along_axis(i, order, 1).astype(np.int32))

    da, ia = sorted_list()
    db, ib = sorted_list()
    got = tt.merge_sorted_topk(*(torch.from_numpy(x) for x in (da, ia, db, ib)), k)
    want = jt.merge_sorted_topk(*(jnp.asarray(x) for x in (da, ia, db, ib)), k)
    assert bits_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("k", [5, 64, 300])
def test_block_topk_ties_keep_position_order(rng, k):
    # Heavy ties (8 distinct values) and +inf: the order among equal
    # distances must be ascending position, like lax.top_k.
    dist = rng.integers(0, 8, size=(6, 256)).astype(np.float32)
    dist[:, ::7] = np.inf
    idx = np.broadcast_to(np.arange(1000, 1256, dtype=np.int32), dist.shape).copy()
    got = tt.block_topk(torch.from_numpy(dist), torch.from_numpy(idx), k)
    want = jt.block_topk(jnp.asarray(dist), jnp.asarray(idx), k)
    got_f = tt.finalize_topk(*got)
    want_f = jt.finalize_topk(*want)
    assert bits_equal(got_f[0].numpy(), want_f[0])
    np.testing.assert_array_equal(got_f[1].numpy(), np.asarray(want_f[1]))


def test_empty_and_finalize_topk(rng):
    dist = rng.integers(0, 4, size=(3, 50)).astype(np.float32)
    dist[:, ::3] = np.inf
    idx = rng.permutation(50).astype(np.int32)[None].repeat(3, 0)
    got = tt.finalize_topk(torch.from_numpy(dist), torch.from_numpy(idx))
    want = jt.finalize_topk(jnp.asarray(dist), jnp.asarray(idx))
    assert bits_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    ed, ei = tt.empty_topk((2,), 4)
    jd_, ji = jt.empty_topk((2,), 4)
    assert bits_equal(ed.numpy(), jd_)
    np.testing.assert_array_equal(ei.numpy(), np.asarray(ji))
