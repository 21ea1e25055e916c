"""pixelbox_tpu_torch multi-device serving vs pixelbox_tpu on the CPU.

The JAX package runs on its 8 virtual CPU devices (tests/conftest.py),
the port on ``make_mesh(8, device="cpu")``: eight shards, one process.
The same numpy-seeded inputs go through both; the sharded (dist, idx)
outputs must be bit-identical to the JAX package's and to the numpy
oracle, ties by ascending row id included.  The port's per-query proof
flags must be sound (a proven query equals the exact scan); they need
not equal the JAX package's.  Sizes follow tests/test_mesh_serving.py:
16,384 × 32 rows with ``block_rows=256`` puts 2,048 rows on a shard,
past the 4·block_rows gate, so the per-shard threshold pass (row 8)
runs; the default block size takes the small-shard exact path.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fixtures import textured_image
from pixelbox_tpu.ops import int4 as J4
from pixelbox_tpu.ops import oracle
from pixelbox_tpu.ops.packed import PackedHammingIndex as JHIndex
from pixelbox_tpu.ops.packed import PackedSemanticIndex as JSIndex
from pixelbox_tpu.parallel import sharded_scan as jss
from pixelbox_tpu.parallel.mesh import make_mesh as jax_make_mesh
from pixelbox_tpu_torch.ops import fused_scan as fs
from pixelbox_tpu_torch.ops import int4 as T4
from pixelbox_tpu_torch.ops.packed import PackedHammingIndex as THIndex
from pixelbox_tpu_torch.ops.packed import PackedSemanticIndex as TSIndex
from pixelbox_tpu_torch.ops.packed import semantic_rows_from_u8
from pixelbox_tpu_torch.ops.scan import cosine_scan_topk
from pixelbox_tpu_torch.parallel import data_parallel as dp
from pixelbox_tpu_torch.parallel import sharded_scan as ss
from pixelbox_tpu_torch.parallel.mesh import make_mesh

N, D, BLOCK = 16384, 32, 256


@pytest.fixture(scope="module")
def jmesh():
    return jax_make_mesh(8)


@pytest.fixture(scope="module")
def tmesh():
    return make_mesh(8, device="cpu")


def clustered(rng, n, d, centers=64, noise=0.4):
    c = rng.standard_normal((centers, d)).astype(np.float32)
    x = c[rng.integers(0, centers, n)] + noise * rng.standard_normal((n, d)).astype(np.float32)
    return oracle.quantize_embedding_np(np.tanh(x))


def assert_same(got, want):
    gd, gi = (np.asarray(x) for x in got)
    wd, wi = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(gi, wi)
    assert np.array_equal(gd.astype(np.float32).view(np.uint32), wd.astype(np.float32).view(np.uint32))


def u8_indexes(db, valid=None):
    valid = np.ones(len(db), bool) if valid is None else valid
    data, rs, rm = semantic_rows_from_u8(db)
    j = JSIndex(*(jnp.asarray(x) for x in (data, rs, rm, valid)))
    t = TSIndex(*(torch.from_numpy(np.ascontiguousarray(x)) for x in (data, rs, rm, valid)))
    return j, t


def oracle_valid(q, db, valid, k, md=1e3):
    keep = np.nonzero(valid)[0]
    od, oi = oracle.cosine_scan_topk_np(q, db[keep], k=k, max_distance=md)
    return od, np.where(oi >= 0, keep[np.maximum(oi, 0)], -1).astype(np.int32)


# --------------------------------------------------------------------- #
# Meshes


def test_cpu_mesh_has_eight_shards_on_one_device():
    mesh = make_mesh(8, device="cpu")
    assert mesh.shape["data"] == 8 and mesh.axis_names == ("data",)
    assert mesh.axis_devices() == [torch.device("cpu")] * 8
    two = make_mesh(8, axis_names=("data", "model"), shape=(4, 2), device="cpu")
    assert two.shape == {"data": 4, "model": 2} and len(two.axis_devices("data")) == 4


def test_cuda_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        make_mesh(4)
    with pytest.raises(RuntimeError):
        make_mesh(4, device="cuda")


def test_capacity_must_divide_over_the_shards(rng):
    _, t = u8_indexes(rng.integers(0, 256, (1000, D), dtype=np.uint8))
    with pytest.raises(ValueError, match="divide"):
        ss.shard_semantic_index(t, make_mesh(3, device="cpu"))


def test_shards_are_copies_even_on_one_device(rng, tmesh):
    _, t = u8_indexes(rng.integers(0, 256, (1024, D), dtype=np.uint8))
    sh = ss.shard_semantic_index(t, tmesh)
    assert sh.n_shards == 8 and sh.local_rows == 128 and sh.capacity == 1024
    for s, shard in enumerate(sh.shards):
        assert torch.equal(shard.data, t.data[s * 128 : (s + 1) * 128])
        assert shard.data.data_ptr() != t.data[s * 128 :].data_ptr()


# --------------------------------------------------------------------- #
# The sharded scans against JAX and the oracle


@pytest.mark.parametrize("size", ["small_shard", "threshold"])
@pytest.mark.parametrize("variant", ["auto", "exact", "pallas"])
def test_sharded_cosine_matches_jax_and_oracle(rng, jmesh, tmesh, size, variant):
    db = clustered(rng, N, D)
    valid = np.ones(N, bool)
    valid[rng.choice(N, N // 50, replace=False)] = False
    j, t = u8_indexes(db, valid)
    q = db[rng.integers(0, N, 6)].copy()
    q[1] = rng.integers(0, 256, D, dtype=np.uint8)
    br = BLOCK if size == "threshold" else None
    jsh = jss.shard_semantic_index(j, jmesh)
    tsh = ss.shard_semantic_index(t, tmesh)
    if variant == "auto":
        want = jss.sharded_cosine_scan_topk_auto(jnp.asarray(q), jsh, jmesh, k=30, block_rows=br)
        got = ss.sharded_cosine_scan_topk_auto(torch.from_numpy(q), tsh, tmesh, k=30, block_rows=br)
    else:
        want = jss.sharded_cosine_scan_topk(jnp.asarray(q), jsh, jmesh, k=30, block_rows=br)
        got = ss.sharded_cosine_scan_topk(
            torch.from_numpy(q), tsh, tmesh, k=30, block_rows=br, mode=variant
        )
    assert_same(got, want)
    assert_same(got, oracle_valid(q, db, valid, 30))


def test_sharded_threshold_flags_are_sound(rng, tmesh):
    db = clustered(rng, N, D, centers=8)
    db[4000:4600] = db[17]  # a tie plateau across shards 1 and 2
    _, t = u8_indexes(db)
    tsh = ss.shard_semantic_index(t, tmesh)
    q = np.concatenate([db[[17, 5, 9000]], rng.integers(0, 256, (5, D), dtype=np.uint8)])
    d, i, proven = ss.sharded_threshold_pass(
        torch.from_numpy(q), tsh, 40, 1e3, fs.CosineQueries.from_u8
    )
    ed, ei = cosine_scan_topk(torch.from_numpy(q), t, k=40)
    assert not bool(proven[0])  # the plateau (600 ties) defeats the proof
    assert bool(proven.any())
    assert torch.equal(d[proven], ed[proven]) and torch.equal(i[proven], ei[proven])


def test_sharded_tie_flood_is_repaired(rng, jmesh, tmesh, monkeypatch):
    base = rng.integers(0, 256, size=(4, D), dtype=np.uint8)
    db = np.repeat(base, 4096, axis=0)  # 16,384 rows of heavy ties
    j, t = u8_indexes(db)
    repairs = []
    exact = ss.sharded_cosine_scan_topk

    def spy(q, *a, **kw):
        repairs.append((tuple(q.shape), kw.get("mode")))
        return exact(q, *a, **kw)

    monkeypatch.setattr(ss, "sharded_cosine_scan_topk", spy)
    got = ss.sharded_cosine_scan_topk_auto(
        torch.from_numpy(base[:2]), ss.shard_semantic_index(t, tmesh), tmesh, k=20, block_rows=BLOCK
    )
    want = jss.sharded_cosine_scan_topk_auto(
        jnp.asarray(base[:2]), jss.shard_semantic_index(j, jmesh), jmesh, k=20, block_rows=BLOCK
    )
    assert_same(got, want)
    assert_same(got, oracle.cosine_scan_topk_np(base[:2], db, k=20))
    assert repairs == [((8, D), "pallas")]  # one 8-query repair bucket


@pytest.mark.parametrize("query_mode", ["asym", "sym"])
@pytest.mark.parametrize("size", ["small_shard", "threshold"])
def test_sharded_int4_matches_jax_and_oracle(rng, jmesh, tmesh, query_mode, size):
    db = clustered(rng, N, D)
    q = db[rng.integers(0, N, 5)].copy()
    br = BLOCK if size == "threshold" else None
    j = J4.build_semantic4_index(db, block_rows=2048)
    t = T4.build_semantic4_index(db, block_rows=2048, device="cpu")
    jsh, tsh = jss.shard_semantic_index(j, jmesh), ss.shard_semantic_index(t, tmesh)
    want = jss.sharded_cosine4_scan_topk_auto(
        jnp.asarray(q), jsh, jmesh, k=25, block_rows=br, query_mode=query_mode
    )
    for got in (
        ss.sharded_cosine4_scan_topk_auto(torch.from_numpy(q), tsh, tmesh, k=25,
                                          block_rows=br, query_mode=query_mode),
        ss.sharded_cosine4_scan_topk(torch.from_numpy(q), tsh, tmesh, k=25,
                                     query_mode=query_mode, mode="exact"),
        ss.sharded_cosine4_scan_topk(torch.from_numpy(q), tsh, tmesh, k=25,
                                     query_mode=query_mode, mode="pallas"),
    ):
        assert_same(got, want)
    np_scan = J4.cosine4a_scan_topk_np if query_mode == "asym" else J4.cosine4_scan_topk_np
    assert_same(want, np_scan(q, db, k=25))


@pytest.mark.parametrize(
    "case", ["plain", "wrap_u8", "byte_limit_group", "max_distance"]
)
def test_sharded_hamming_matches_jax_and_oracle(rng, jmesh, tmesh, case):
    n, h = 4096, 32
    base = rng.integers(0, 256, (16, h), dtype=np.uint8)
    flips = rng.integers(0, 256, (n, h), dtype=np.uint8) & rng.integers(0, 256, (n, h), dtype=np.uint8)
    db = base[rng.integers(0, 16, n)] ^ flips
    valid = np.ones(n, bool)
    valid[rng.choice(n, 40, replace=False)] = False
    q = np.concatenate([db[[3, 77]], rng.integers(0, 256, (3, h), dtype=np.uint8)])
    kw = {"wrap_u8": case == "wrap_u8"}
    md = 0.3 if case == "max_distance" else 1e3
    mask = None
    if case == "byte_limit_group":
        kw["byte_limit"] = 20
        mask = rng.random(n) < 0.5
        kw["valid_mask"] = mask
    j = JHIndex(jnp.asarray(db), jnp.asarray(valid))
    t = THIndex(torch.from_numpy(db), torch.from_numpy(valid))
    want = jss.sharded_hamming_scan_topk(
        jnp.asarray(q), jss.shard_hamming_index(j, jmesh), jmesh, k=20, max_distance=md, **kw
    )
    got = ss.sharded_hamming_scan_topk(
        torch.from_numpy(q), ss.shard_hamming_index(t, tmesh), tmesh, k=20, max_distance=md, **kw
    )
    assert_same(got, want)
    keep = valid if mask is None else valid & mask
    rows = np.nonzero(keep)[0]
    limit = kw.get("byte_limit", h)  # zip-truncate: the first `limit` bytes
    od, oi = oracle.hamming_scan_topk_np(
        q[:, :limit], db[rows][:, :limit], k=20, max_distance=md, wrap_u8=kw["wrap_u8"]
    )
    assert_same(got, (od, np.where(oi >= 0, rows[np.maximum(oi, 0)], -1)))


@pytest.mark.parametrize("kind", ["semantic", "semantic4", "hamming"])
def test_delta_append_equals_a_full_reshard(rng, tmesh, kind):
    """Rows appended in place into the owning shards (current validity:
    a row tombstoned inside the delta stays out) give the same mirror —
    tensors, meta, samples and scans — as sharding the grown index."""
    from pixelbox_tpu_torch.index.store import VectorStore

    store = VectorStore(dim=D, kind=kind, device="cpu", block_rows=2048)
    rows = clustered(rng, 8000, D)
    store.append(rows[:5000])
    if kind == "hamming":
        shard, append = ss.shard_hamming_index, ss.append_to_sharded_hamming_index
    else:
        shard = ss.shard_semantic_index

        def append(m, r, v, start):
            return ss.append_to_sharded_index(m, r, v, start, kind=kind)

    mirror = shard(store.device_index, tmesh)
    for s in range(mirror.n_shards):
        mirror.meta(s)
        mirror.sample(s)
    struct = store.structural_version
    store.append(rows[5000:])
    store.delete([6001, 7500])  # tombstoned inside the delta
    assert store.device_index.capacity == mirror.capacity
    append(mirror, store._host_rows[5000:8000], store._host_valid[5000:8000], 5000)
    full = shard(store.device_index, tmesh)
    assert struct != store.structural_version  # the engine would reshard; the append must agree
    for s in range(mirror.n_shards):
        for a, b in zip(mirror.shards[s], full.shards[s]):
            assert torch.equal(a, b)
        assert torch.equal(mirror.meta(s), full.meta(s))
        assert all(torch.equal(a, b) for a, b in zip(mirror.sample(s), full.sample(s)))
    q = torch.from_numpy(rows[[6001, 7500, 10]])
    if kind == "hamming":
        got = ss.sharded_hamming_scan_topk(q, mirror, tmesh, k=10)
        want = ss.sharded_hamming_scan_topk(q, full, tmesh, k=10)
    elif kind == "semantic4":
        got = ss.sharded_cosine4_scan_topk(q, mirror, tmesh, k=10)
        want = ss.sharded_cosine4_scan_topk(q, full, tmesh, k=10)
    else:
        got = ss.sharded_cosine_scan_topk(q, mirror, tmesh, k=10)
        want = ss.sharded_cosine_scan_topk(q, full, tmesh, k=10)
    assert_same(got, want)
    assert 6001 not in got[1][0].tolist() and 7500 not in got[1][1].tolist()


# --------------------------------------------------------------------- #
# Data-parallel embedding


def test_shard_batch_pads_and_splits(tmesh):
    parts = dp.shard_batch(np.arange(5 * 6, dtype=np.float32).reshape(5, 2, 3), tmesh)
    assert len(parts) == 8 and all(tuple(p.shape) == (1, 2, 3) for p in parts)
    assert torch.equal(torch.cat(parts)[:5].reshape(5, 6), torch.arange(30.0).reshape(5, 6))
    assert not torch.cat(parts)[5:].any()
    parts = dp.shard_batch(np.zeros((16, 4), np.float32), tmesh)
    assert all(tuple(p.shape) == (2, 4) for p in parts)


def _stub_batch(n):
    return np.stack(
        [np.asarray(textured_image(seed=s, size=(32, 32)), dtype=np.float32) / 255.0 for s in range(n)]
    )


def test_sharded_embed_matches_one_device_and_jax(tmesh):
    from pixelbox_tpu.models import get_embedder as jax_embedder
    from pixelbox_tpu_torch.models import get_embedder

    jemb = jax_embedder("stub", dim=16, input_size=32)
    emb = get_embedder("stub", dim=16, input_size=32, weights=np.asarray(jemb._w), device="cpu")
    batch = _stub_batch(6)
    sharded = dp.embed_batch_sharded(emb, batch, tmesh)
    assert tuple(sharded.shape) == (6, 16)
    # Each shard runs the forward at batch 1: another matmul blocking than
    # batch 6, so ulps may differ (the JAX test's tolerance).
    np.testing.assert_allclose(sharded.numpy(), emb.embed_preprocessed(batch).numpy(), atol=1e-6)
    # Across frameworks: the model contract of ROADMAP.md.
    np.testing.assert_allclose(
        sharded.numpy(), np.asarray(jemb.embed_preprocessed(jnp.asarray(batch))),
        rtol=1e-4, atol=1e-5,
    )


def test_embedder_replica_holds_the_same_weights():
    from pixelbox_tpu_torch.models import get_embedder

    emb = get_embedder("stub", dim=16, input_size=32, device="cpu")
    rep = emb.replica("cpu")
    assert rep is not emb and rep._w is not emb._w and torch.equal(rep._w, emb._w)
    batch = _stub_batch(3)
    assert torch.equal(rep.embed_preprocessed(batch), emb.embed_preprocessed(batch))


def test_engine_ingest_with_mesh_matches_one_device(tmp_path):
    from PIL import Image

    from pixelbox_tpu_torch.engine import Engine

    photos = tmp_path / "photos"
    photos.mkdir()
    for s in range(5):
        Image.fromarray(textured_image(seed=s, size=(40, 40))).save(photos / f"m{s}.png")
    hashes = []
    for name, mesh in (("dp", make_mesh(8, device="cpu")), ("one", None)):
        eng = Engine.new(str(tmp_path / f"{name}.db"), embedder="stub", dim=16, device="cpu")
        eng.mesh = mesh
        eng.add_tracked_folder(str(photos))
        eng.start_indexing(num_workers=2)
        assert eng.wait_for_indexing(timeout=120)
        assert eng.get_num_indexed_images() == 5
        hashes.append({
            eng.catalog.get_image(i)["filename"]: bytes(h)
            for i, h in eng.catalog.iter_hashes("semantic_hashes")
        })
        probe = str(photos / "m3.png")
        eng.query_by_image_hash_from_file(probe)
        assert eng.get_query_results()[0].distance_from_query == 0.0
        eng.close()
    assert hashes[0] == hashes[1]
