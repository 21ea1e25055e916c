"""pixelbox_tpu_torch int4 library vs pixelbox_tpu on the CPU.

The same numpy-seeded rows go through the JAX package (its XLA scans, and
its Pallas int4 kernel in interpret mode as tests/test_int4.py runs it)
and through the port, whose kernel wrappers take their plain PyTorch
versions for CPU tensors.  (dist, idx) outputs are compared bit for bit,
ties by ascending row id included; every query the port flags exact must
equal the exact scan (the flags need not equal the TPU kernel's).  int4
libraries written by either engine open in the other with the same
stored-hash, filtered ``similar:`` and duplicate results, with the exact-u8
rerank on and off; the port's CLI drives ``--precision int4`` end to end.
"""

import io
import json
import os
from contextlib import redirect_stdout

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from PIL import Image

from fixtures import textured_image
from pixelbox_tpu.ops import int4 as J
from pixelbox_tpu.ops import scan as jscan
from pixelbox_tpu.ops.oracle import quantize_embedding_np
from pixelbox_tpu_torch.ops import fused_scan as fs
from pixelbox_tpu_torch.ops import int4 as T
from pixelbox_tpu_torch.ops import scan as tscan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def clustered(rng, n, d, centers=32, noise=0.35):
    """Embedding-like u8 rows: quantized tanh of noisy cluster centres."""
    c = rng.standard_normal((centers, d)).astype(np.float32)
    x = c[rng.integers(0, centers, n)] + noise * rng.standard_normal((n, d)).astype(np.float32)
    return quantize_embedding_np(np.tanh(x))


def assert_same(got, want):
    gd, gi = (np.asarray(x) for x in got)
    wd, wi = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(gi, wi)
    assert np.array_equal(gd.astype(np.float32).view(np.uint32), wd.astype(np.float32).view(np.uint32))


def both_indexes(db, block_rows, valid=None):
    ji = J.build_semantic4_index(db, block_rows=block_rows)
    ti = T.build_semantic4_index(db, block_rows=block_rows, device="cpu")
    if valid is not None:
        pad = np.zeros(ti.capacity, bool)
        pad[: len(valid)] = valid
        ji = ji._replace(valid=jnp.asarray(pad))
        ti = ti._replace(valid=torch.from_numpy(pad))
    return ji, ti


# --------------------------------------------------------------------- #
# Host packing and query moments


def test_packing_and_moments_match_jax(rng):
    every = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(T.quantize_u8_to_u4(every), J.quantize_u8_to_u4(every))
    grid = np.arange(16, dtype=np.uint8)
    np.testing.assert_array_equal(T.dequantize_u4_to_u8(grid), J.dequantize_u4_to_u8(grid))
    rows = rng.integers(0, 256, (300, 64), dtype=np.uint8)
    for a, b in zip(T.semantic4_rows_from_u8(rows), J.semantic4_rows_from_u8(rows)):
        np.testing.assert_array_equal(a, b)
    v4 = T.quantize_u8_to_u4(rows)
    packed = T.pack_u4_rows(v4)
    np.testing.assert_array_equal(packed, J.pack_u4_rows(v4))
    np.testing.assert_array_equal(T.unpack_u4_rows_np(packed), v4)
    np.testing.assert_array_equal(fs.unpack_u4(torch.from_numpy(packed)).numpy(), v4)
    for a, b in zip(T.query4_moments_from_u8(torch.from_numpy(rows)), J.query4_moments_from_u8(jnp.asarray(rows))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ji, ti = both_indexes(rows, 256)
    for a, b in zip(ti, ji):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (ti.dim, ti.capacity) == (ji.dim, ji.capacity) == (64, 512)
    np.testing.assert_array_equal(T.build_semantic4_meta(ti).numpy(), np.asarray(J.build_semantic4_meta(ji)))


# --------------------------------------------------------------------- #
# Scans: the plain exact scans, the fused scans and auto


@pytest.mark.parametrize(
    "case,d",
    [("clustered", 32), ("tombstones", 256), ("plateau", 32), ("tie_flood", 32), ("max_distance", 256)],
)
def test_exact_scans_match_jax_and_oracles(rng, case, d):
    # The tie flood outgrows the collect buffer (4,096), so even the
    # one-ulp-widened θ cannot prove it and the repair must run; the
    # 600-row plateau fits, and the widened θ proves it.
    n, k = (8192 if case == "tie_flood" else 4096), 30
    db = clustered(rng, n, d)
    valid = np.ones(n, bool)
    q = db[rng.integers(0, n, 5)].copy()
    q[1] = db[77]
    md = 1e3
    if case == "tombstones":
        valid[rng.choice(n, n // 100, replace=False)] = False
        valid[77] = False
    elif case == "plateau":
        db[1000:1600] = db[77]
    elif case == "tie_flood":
        db[1000:5300] = db[77]
    elif case == "max_distance":
        md = 0.05
    ji, ti = both_indexes(db, 512, valid)
    keep = np.nonzero(valid)[0]
    qt = torch.from_numpy(q)
    meta = T.build_semantic4_meta(ti)
    smp = tscan.build_scan_sample(ti, sample_rows=1024)
    for mode, jfn, tfn, oracle in (
        ("asym", J.cosine4a_scan_topk, T.cosine4a_scan_topk, J.cosine4a_scan_topk_np),
        ("sym", J.cosine4_scan_topk, T.cosine4_scan_topk, J.cosine4_scan_topk_np),
    ):
        want = jfn(jnp.asarray(q), ji, k=k, max_distance=md, block_rows=512)
        got = tfn(qt, ti, k=k, max_distance=md, block_rows=512)
        assert_same(got, want)
        od, oi = oracle(q, db[keep], k=k, max_distance=md)
        assert_same(got, (od, np.where(oi >= 0, keep[np.maximum(oi, 0)], -1)))
        assert_same(fs.fused_cosine4_scan_topk(qt, ti, meta, k=k, max_distance=md, query_mode=mode), want)
        td, tid, ex = fs.fused_threshold4_scan_topk(qt, ti, meta, smp, k=k, max_distance=md, query_mode=mode)
        ok = ex.numpy()
        assert_same((td.numpy()[ok], tid.numpy()[ok]), (np.asarray(want[0])[ok], np.asarray(want[1])[ok]))
        auto = T.cosine4_scan_topk_auto(qt, ti, k=k, max_distance=md, block_rows=512, sample=smp,
                                        meta=meta, query_mode=mode)
        assert_same(auto, want)
        if case in ("plateau", "tie_flood"):
            assert ok[1] == (case == "plateau"), "only a plateau larger than the buffer defeats the proof"
            assert auto[1][1].tolist() == [77] + list(range(1000, 1000 + k - 1))
        if mode == "sym" and case != "tombstones":
            assert float(auto[0][1, 0]) == 0.0, "a sym query of a stored row reads exactly 0"


@pytest.mark.parametrize("mode", ["asym", "sym"])
def test_threshold_and_repair_vs_pallas_interpret(rng, mode):
    """Port auto (plain K4a/K1c, repair plain K4b/K1c) vs JAX's
    ``pallas_threshold4_scan_topk`` in interpret mode + its repair, at the
    sizes tests/test_int4.py uses (dim 256, capacity a multiple of 2048)."""
    n, k = 4096, 30
    db = rng.integers(0, 256, (n, 256), dtype=np.uint8)
    db[3000:3040] = db[9]
    q = np.concatenate([db[[9, 100]], rng.integers(0, 256, (2, 256), dtype=np.uint8)])
    ji, ti = both_indexes(db, 256)
    exact_fn = J.cosine4a_scan_topk if mode == "asym" else J.cosine4_scan_topk
    with pltpu.force_tpu_interpret_mode():
        jd, jid, jex = J.pallas_threshold4_scan_topk(
            jnp.asarray(q), ji, J.build_semantic4_meta(ji), jscan.build_scan_sample(ji, sample_rows=1024),
            k=k, tile_rows=256, query_mode=mode,
        )
    rd, ri = exact_fn(jnp.asarray(q), ji, k=k, block_rows=256)
    jd, jid = np.asarray(jd).copy(), np.asarray(jid).copy()
    bad = ~np.asarray(jex)
    jd[bad], jid[bad] = np.asarray(rd)[bad], np.asarray(ri)[bad]

    qt = torch.from_numpy(q)
    meta = T.build_semantic4_meta(ti)
    smp = tscan.build_scan_sample(ti, sample_rows=1024)
    td, tid, tex = fs.fused_threshold4_scan_topk(qt, ti, meta, smp, k=k, query_mode=mode)
    ok = tex.numpy()
    assert ok.any()
    assert_same((td.numpy()[ok], tid.numpy()[ok]), (np.asarray(rd)[ok], np.asarray(ri)[ok]))
    got = T.cosine4_scan_topk_auto(qt, ti, k=k, block_rows=256, sample=smp, meta=meta, query_mode=mode)
    assert_same(got, (jd, jid))
    oracle = J.cosine4a_scan_topk_np if mode == "asym" else J.cosine4_scan_topk_np
    assert_same(got, oracle(q, db, k=k))


def test_bad_query_mode_and_shapes_raise(rng):
    db = clustered(rng, 600, 32)
    _, ti = both_indexes(db, 512)
    qt = torch.from_numpy(db[:2])
    with pytest.raises(ValueError, match="query_mode"):
        T.cosine4_scan_topk_auto(qt, ti, k=5, query_mode="int4")
    with pytest.raises(ValueError, match="width"):
        fs.fused_cosine4_scan_topk(qt[:, :30], ti, T.build_semantic4_meta(ti), k=5)
    qk = fs.Int4Queries.from_u8(qt, "sym")
    with pytest.raises(ValueError, match="uint8"):
        fs.cosine4_chunk_topk(qk.q_codes, qk.q_sum, qk.q_mag2, qk.qr, 1e3,
                              ti.data.to(torch.int8), T.build_semantic4_meta(ti), True, 5)


# --------------------------------------------------------------------- #
# The exact-u8 rerank


def test_rerank_matches_jax(rng):
    n, d = 3000, 32
    db = clustered(rng, n, d)
    db[500:520] = db[3]
    q = db[rng.integers(0, n, 40)].copy()
    q[0] = db[3]
    cand = rng.integers(0, n, (40, 400))
    cand[:, -50:] = -1
    cand[0, :25] = np.arange(500, 525)[::-1]
    for md in (1e3, 0.05, np.inf):
        assert_same(T.rerank_candidates_u8(q, cand, db, k=30, max_distance=md),
                    J.rerank_candidates_u8(q, cand, db, k=30, max_distance=md))
    assert_same(T.rerank_candidates_u8(q[0], cand[0], db, k=10),
                J.rerank_candidates_u8(q[0], cand[0], db, k=10))

    ji, ti = both_indexes(db, 1024)
    for n_real in (None, 33):
        got = T.scan_with_u8_rerank(
            lambda c, md: (x.numpy() for x in T.cosine4_scan_topk_auto(torch.from_numpy(q), ti, k=c, max_distance=md)),
            q, db, k=20, max_distance=0.2, n_real=n_real,
        )
        want = J.scan_with_u8_rerank(
            lambda c, md: J.cosine4a_scan_topk(jnp.asarray(q), ji, k=c, max_distance=md),
            q, db, k=20, max_distance=0.2, n_real=n_real,
        )
        assert_same(got, want)
    assert got[1][0].tolist() == [3] + list(range(500, 519))
    assert T.default_rerank_candidates(100) == J.default_rerank_candidates(100) == 400
    assert T.UNBOUNDED_DISTANCE == J.UNBOUNDED_DISTANCE


# --------------------------------------------------------------------- #
# Store


def test_semantic4_store_matches_jax(rng):
    from pixelbox_tpu.index.store import VectorStore as JStore
    from pixelbox_tpu_torch.index.store import VectorStore as TStore

    js = JStore(dim=32, kind="semantic4", block_rows=1024)
    ts = TStore(dim=32, kind="semantic4", block_rows=1024, device="cpu")
    rows = rng.integers(0, 256, (1500, 32), dtype=np.uint8)
    steps = [
        ("append", rows[:1000]), ("append", rows[1000:1020]), ("append", rows[1020:1400]),
        ("delete", [3, 4, 1100]), ("delete", [4]), ("compact", None), ("append", rows[1400:]),
    ]
    for op, arg in steps:
        data_before = ts._device_arrays.data if ts._device_arrays is not None else None
        outs = [getattr(s, op)(*(() if arg is None else (arg,))) for s in (js, ts)]
        if op in ("append", "compact"):
            np.testing.assert_array_equal(outs[1], outs[0])
        assert (ts.n, ts.n_deleted, ts.size) == (js.n, js.n_deleted, js.size), op
        assert (ts.version, ts.structural_version) == (js.version, js.structural_version), op
        np.testing.assert_array_equal(ts._host_rows[: ts.n], js._host_rows[: js.n])
        ti, ji = ts.device_index, js.device_index
        assert ti.dim == 32 and ti.data.shape[1] == 16
        for a, b in zip(ti, ji):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        if (op, len(arg) if arg is not None else 0) == ("append", 20):
            assert ti.data is data_before, "an in-capacity append writes in place"


# --------------------------------------------------------------------- #
# Engine: int4 libraries written by either package


def _records(mod, rows, prefix):
    return [
        mod.IndexedImage(filename=f"{prefix}_{j:05d}.png", path=f"/synthetic/{prefix}_{j:05d}.png",
                         visual_hash=rows[j])
        for j in range(len(rows))
    ]


def _results(eng):
    return [(r.id, r.distance_from_query) for r in eng.get_query_results()]


def _queries(eng, probe_path, probe_hash, ids):
    """Stored-hash, broad- and narrow-filter ``similar:`` queries, rerank on
    and off, and the exact scan mode."""
    from types import SimpleNamespace

    out = {}
    for rerank in (True, False):
        eng.int4_rerank = rerank
        for mode in ("auto", "exact"):
            eng.scan_mode = mode
            for i in ids:
                eng.query_by_image_hash_from_id(i)
                out[("id", i, mode, rerank)] = _results(eng)
        eng.scan_mode = "auto"
        for text in ("syn", "syn_001", "syn_0001"):
            # The sticky similar: image (engine.rs:510-537), seeded from a
            # stored hash so both packages query the same vector.
            eng._cached_image_search = SimpleNamespace(path=probe_path, visual_hash=probe_hash)
            eng.query(f"{text} similar:{probe_path}")
            out[("similar:", text, rerank)] = _results(eng)
    eng.int4_rerank = True
    return out


@pytest.fixture(scope="module")
def int4_library(tmp_path_factory):
    """A 17,000-row int4 library written by the JAX engine (broad filters
    need > 16,384 matching rows) and its query results there."""
    import pixelbox_tpu.records as jrec
    from pixelbox_tpu.engine import Engine as JEngine

    rng = np.random.default_rng(44)
    rows = clustered(rng, 17000, 32, centers=64)
    rows[9000:9010] = rows[12]            # exact copies of row 12: ties at 0
    db = str(tmp_path_factory.mktemp("int4") / "lib.db")
    eng = JEngine.new(db, embedder="stub", dim=32, semantic_precision="int4")
    eng.insert_records_batch(_records(jrec, rows, "syn"))
    assert eng._sem_store.kind == "semantic4"
    ids = [eng._sem_image_ids[r] for r in (12, 4321)]
    want = _queries(eng, "/probe/q.png", rows[12], ids)
    eng.close()
    return {"db": db, "rows": rows, "ids": ids, "want": want}


def test_jax_int4_library_opens_in_port(int4_library):
    from pixelbox_tpu_torch.engine import Engine

    lib = int4_library
    eng = Engine.open(lib["db"], device="cpu")
    try:
        assert eng.semantic_precision == "int4" and eng._sem_store.kind == "semantic4"
        assert eng._sem_store.device_index.data.shape[1] == 16
        got = _queries(eng, "/probe/q.png", lib["rows"][12], lib["ids"])
    finally:
        eng.close()
    assert got.keys() == lib["want"].keys()
    for key, want in lib["want"].items():
        assert got[key] == want, key
    first = got[("id", lib["ids"][0], "auto", True)]
    assert [d for _, d in first[:11]] == [0.0] * 11, "the stored row and its copies rescore to 0.0"
    raw = got[("id", lib["ids"][0], "auto", False)]
    assert 0.0 < raw[0][1] < 0.01, "the asymmetric int4 self-distance is near 0, not 0"
    assert len(got[("similar:", "syn_001", True)]) == 100 and len(got[("similar:", "syn_0001", True)]) == 10


def test_int4_mesh_serving_raises(int4_library):
    """int4 serving on a mesh (ported): the results of one device on a
    mesh whose shards divide the capacity; a mesh whose shards do not
    divide it raises instead of serving a partial index."""
    from pixelbox_tpu_torch.engine import Engine
    from pixelbox_tpu_torch.parallel.mesh import make_mesh

    eng = Engine.open(int4_library["db"], device="cpu")
    try:
        image_id = int4_library["ids"][0]
        eng.query_by_image_hash_from_id(image_id)
        single = [(r.id, r.distance_from_query) for r in eng.get_query_results()]
        pairs = eng.find_duplicate_pairs(by="semantic")
        eng.serve_on_mesh(make_mesh(8, device="cpu"))
        eng.query_by_image_hash_from_id(image_id)
        assert [(r.id, r.distance_from_query) for r in eng.get_query_results()] == single
        assert eng.find_duplicate_pairs(by="semantic") == pairs
        assert eng._sem_mirror.index.n_shards == 8
        eng.serve_on_mesh(make_mesh(3, device="cpu"))
        with pytest.raises(ValueError, match="divide"):
            eng.query_by_image_hash_from_id(image_id)
        with pytest.raises(ValueError, match="divide"):
            eng.find_duplicate_pairs(by="semantic")
    finally:
        eng.close()


def test_lex_topk_past_max_k_in_rounds():
    """k past the select kernel's MAX_K (half the first port's segment) is
    selected in rounds, each above the last key the round before took: the
    result equals ``torch.sort``'s first k, at k = SEGMENT // 2 + 1 and k =
    SEGMENT // 2, on a row past SELECT_SLOTS (sliced) and on a shorter one."""
    for m in (5000, fs.SELECT_SLOTS + 3000):
        d = torch.rand(2, m)
        i = torch.arange(m, dtype=torch.int32).expand(2, -1).contiguous()
        want = torch.sort(d, dim=1, stable=True)
        for k in (fs.SEGMENT // 2 + 1, fs.SEGMENT // 2):
            got = fs.lex_topk(d, i, k)
            assert torch.equal(got[0], want.values[:, :k])
            assert torch.equal(got[1], want.indices[:, :k].to(torch.int32))


@pytest.fixture(scope="module")
def dup_library(tmp_path_factory):
    """A 1,200-row int4 library written by the PORT's engine, with planted
    near-duplicates."""
    import pixelbox_tpu_torch.records as trec
    from pixelbox_tpu_torch.engine import Engine

    rng = np.random.default_rng(45)
    rows = clustered(rng, 1200, 32, centers=16, noise=0.6)
    near = rows[:40].astype(np.int32)
    near[:, :3] = np.clip(near[:, :3] + rng.integers(-3, 4, (40, 3)), 0, 255)
    rows[600:640] = near.astype(np.uint8)
    rows[700:705] = rows[5]
    db = str(tmp_path_factory.mktemp("int4dup") / "dup.db")
    eng = Engine.new(db, embedder="stub", dim=32, semantic_precision="int4", device="cpu")
    eng.insert_records_batch(_records(trec, rows, "dup"))
    eng.close()
    return db


def _dups(eng):
    out = {}
    for rerank in (True, False):
        eng.int4_rerank = rerank
        out[rerank] = eng.find_duplicate_pairs(max_distance=0.05, by="semantic")
    eng.int4_rerank = True
    return out


def test_duplicates_and_port_written_library_in_jax(dup_library):
    from pixelbox_tpu.engine import Engine as JEngine
    from pixelbox_tpu_torch.engine import Engine

    jeng = JEngine.open(dup_library)
    try:
        assert jeng.semantic_precision == "int4" and jeng._sem_store.kind == "semantic4"
        want = _dups(jeng)
        jeng.query_by_image_hash_from_id(jeng._sem_image_ids[5])
        want_q = _results(jeng)
    finally:
        jeng.close()
    eng = Engine.open(dup_library, device="cpu")
    try:
        got = _dups(eng)
        eng.query_by_image_hash_from_id(eng._sem_image_ids[5])
        got_q = _results(eng)
    finally:
        eng.close()
    assert got == want
    assert got_q == want_q and got_q[0][1] == 0.0
    assert len(want[True]) >= 45 and {d for *_, d in want[True][:15]} == {0.0}


def test_precision_persists_overrides_and_warns(tmp_path, capsys):
    from pixelbox_tpu_torch.engine import Engine
    from pixelbox_tpu_torch.records import IndexedImage

    db = str(tmp_path / "p.db")
    Engine.new(db, embedder="stub", dim=32, semantic_precision="int4", device="cpu").close()
    assert "int4_rerank disabled" not in capsys.readouterr().err
    eng = Engine.open(db, int4_rerank=False, device="cpu")
    assert eng.semantic_precision == "int4"
    assert "int4_rerank disabled" in capsys.readouterr().err
    eng.close()
    eng = Engine.open(db, semantic_precision="int8", device="cpu")
    eng.insert_records_batch([IndexedImage(filename="a.png", path="/a.png",
                                           visual_hash=np.arange(32, dtype=np.uint8))])
    assert eng._sem_store.kind == "semantic"
    eng.close()
    eng = Engine.open(db, device="cpu")
    assert eng.semantic_precision == "int8"
    eng.close()
    with pytest.raises(ValueError, match="semantic_precision"):
        Engine.open(db, semantic_precision="int2", device="cpu")
    odd = Engine.new(str(tmp_path / "odd.db"), embedder="stub", dim=33, semantic_precision="int4",
                     device="cpu")
    with pytest.raises(ValueError, match="even embedding dim"):
        odd.insert_records_batch([IndexedImage(filename="b.png", path="/b.png",
                                               visual_hash=np.zeros(33, np.uint8))])
    odd.close()


# --------------------------------------------------------------------- #
# CLI


def _cli(argv):
    from pixelbox_tpu_torch.cli import main

    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv + ["--device", "cpu"])
    return rc, buf.getvalue()


def test_cli_int4_recipe_on_cpu(tmp_path):
    photos = tmp_path / "photos"
    (photos / "sub").mkdir(parents=True)
    for i in range(5):
        Image.fromarray(textured_image(seed=60 + i, size=(64, 64))).save(photos / f"img{i}.png")
    Image.fromarray(textured_image(seed=60, size=(64, 64))).save(photos / "sub" / "img0_copy.png")
    db = str(tmp_path / "lib.db")
    assert _cli(["init", db, "--dim", "32", "--precision", "int4"])[0] == 0
    assert _cli(["add-folder", db, str(photos)])[0] == 0
    rc, out = _cli(["index", db])
    assert rc == 0 and "Indexed images: 6" in out
    rc, out = _cli(["stats", db])
    assert rc == 0 and json.loads(out)["semantic_precision"] == "int4"
    probe = os.path.realpath(photos / "img0.png")
    copy = os.path.realpath(photos / "sub" / "img0_copy.png")
    rc, out = _cli(["similar", db, probe, "--json"])
    res = json.loads(out)
    assert rc == 0 and len(res) >= 2
    assert {(r["path"], r["distance"]) for r in res[:2]} == {(probe, 0.0), (copy, 0.0)}
    rc, out = _cli(["similar", db, probe, "--json", "--no-int4-rerank"])
    raw = json.loads(out)
    assert rc == 0 and {r["path"] for r in raw[:2]} == {probe, copy}
    assert 0.0 < raw[0]["distance"] == raw[1]["distance"] < 0.01
    rc, out = _cli(["duplicates", db, "--by", "semantic", "--json"])
    pairs = json.loads(out)
    assert rc == 0 and len(pairs) == 1 and pairs[0]["distance"] == 0.0


def test_int4_module_stands_alone():
    from test_torch_port_phash import _faults

    path = os.path.join(REPO, "pixelbox_tpu_torch", "ops", "int4.py")
    with open(path, encoding="utf-8") as fh:
        assert _faults(path, fh.read()) == []
