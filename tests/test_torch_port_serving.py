"""pixelbox_tpu_torch's cos-key scans, batching service and web server vs
pixelbox_tpu on the CPU.

The cos-key main pass (``epilogue="cos"``: plain K1d/K4d keys, plain K1e
rescore, K1c) after repair is held bit for bit against the JAX carry scans
with ``pallas_scan._EPILOGUE`` set to "cos" (interpret mode, as
tests/test_pallas_threshold.py runs them) after their repair, against the
port's dist path and against the numpy oracle.  The service coalesces
threaded requests into the direct auto scan's results and sees in-place
store mutations; the port's server answers a library indexed by the JAX
engine with the same JSON as JAX ``serve.py``.
"""

import io
import json
import sqlite3
import sys
import threading
import time
import urllib.error
import urllib.request
from contextlib import redirect_stdout
from http.server import ThreadingHTTPServer

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from PIL import Image

from fixtures import textured_image
from pixelbox_tpu.ops import int4 as J
from pixelbox_tpu.ops import oracle
from pixelbox_tpu.ops import pallas_scan as jps
from pixelbox_tpu.ops import scan as jscan
from pixelbox_tpu.ops.packed import PackedSemanticIndex as JIndex
from pixelbox_tpu_torch.ops import fused_scan as fs
from pixelbox_tpu_torch.ops import int4 as T
from pixelbox_tpu_torch.ops import scan as tscan
from pixelbox_tpu_torch.ops.packed import PackedSemanticIndex as TIndex
from pixelbox_tpu_torch.ops.packed import semantic_rows_from_u8


def clustered(rng, n, d, centers=32, noise=0.35):
    c = rng.standard_normal((centers, d)).astype(np.float32)
    x = c[rng.integers(0, centers, n)] + noise * rng.standard_normal((n, d)).astype(np.float32)
    return oracle.quantize_embedding_np(np.tanh(x))


def assert_same(got, want):
    gd, gi = (np.asarray(x) for x in got)
    wd, wi = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(gi, wi)
    assert np.array_equal(gd.astype(np.float32).view(np.uint32), wd.astype(np.float32).view(np.uint32))


def u8_indexes(db):
    data, rs, rm = semantic_rows_from_u8(db)
    valid = np.ones(len(db), bool)
    j = JIndex(*(jnp.asarray(x) for x in (data, rs, rm, valid)))
    t = TIndex(*(torch.from_numpy(np.ascontiguousarray(x)) for x in (data, rs, rm, valid)))
    return j, t


# --------------------------------------------------------------------- #
# The cos-key scans vs JAX's epilogue="cos"


@pytest.fixture
def cos_epilogue(monkeypatch):
    """JAX's carry scans with the cos-key epilogue: the module global is
    read at trace time, so the jitted wrappers' caches are cleared on the
    way in and out."""
    monkeypatch.setattr(jps, "_EPILOGUE", "cos")
    jps.pallas_threshold_scan_topk_v2.clear_cache()
    J.pallas_threshold4_scan_topk.clear_cache()
    yield
    jps.pallas_threshold_scan_topk_v2.clear_cache()
    J.pallas_threshold4_scan_topk.clear_cache()


def _case(rng, case, d):
    """(db rows, queries, k, max_distance) of one of the four cases."""
    if case == "tie_plateau":
        base = rng.integers(0, 256, size=(4, d), dtype=np.uint8)
        return np.repeat(base, 1024, axis=0), base[:2], 20, 1e3
    db = clustered(rng, 4096, d)
    if case == "self_match":
        return db, db[[7]], 3, 1e3
    q = db[rng.integers(0, 4096, 6)].copy()
    q[:, :4] = rng.integers(0, 256, (6, 4), dtype=np.uint8)
    return db, q, (50 if case == "saturated" else 25), (0.05 if case == "saturated" else 1e3)


@pytest.mark.parametrize("case", ["plain", "tie_plateau", "saturated", "self_match"])
@pytest.mark.parametrize("kind,d", [("cosine", 32), ("cosine4a", 128), ("cosine4", 128)])
def test_coskey_scan_vs_jax_dist_and_oracle(rng, cos_epilogue, kind, d, case):
    db, q, k, md = _case(rng, case, d)
    qt, qj = torch.from_numpy(q), jnp.asarray(q)
    if kind == "cosine":
        ji, ti = u8_indexes(db)
        jmeta, tmeta = jps.build_row_meta(ji), fs.build_row_meta(ti)
        with pltpu.force_tpu_interpret_mode():
            jd, jid, jex = jps.pallas_threshold_scan_topk_v2(
                qj, ji, jmeta, jscan.build_scan_sample(ji, sample_rows=1024),
                k=k, max_distance=md, tile_rows=256,
            )
        rd, ri = jscan.cosine_scan_topk(qj, ji, k=k, max_distance=md, block_rows=1024)
        want = oracle.cosine_scan_topk_np(q, db, k=k, max_distance=md)

        def scan(epilogue):
            return fs.fused_threshold_scan_topk(
                qt, ti, tmeta, tscan.build_scan_sample(ti, sample_rows=1024),
                k=k, max_distance=md, epilogue=epilogue,
            )

        def exact_scan(rq):
            return fs.fused_cosine_scan_topk(rq, ti, tmeta, k=k, max_distance=md)
    else:
        mode = "sym" if kind == "cosine4" else "asym"
        ji = J.build_semantic4_index(db, block_rows=256)
        ti = T.build_semantic4_index(db, block_rows=256, device="cpu")
        tmeta = T.build_semantic4_meta(ti)
        with pltpu.force_tpu_interpret_mode():
            jd, jid, jex = J.pallas_threshold4_scan_topk(
                qj, ji, J.build_semantic4_meta(ji), jscan.build_scan_sample(ji, sample_rows=1024),
                k=k, max_distance=md, tile_rows=256, query_mode=mode,
            )
        jexact = J.cosine4_scan_topk if mode == "sym" else J.cosine4a_scan_topk
        rd, ri = jexact(qj, ji, k=k, max_distance=md, block_rows=256)
        want = (J.cosine4_scan_topk_np if mode == "sym" else J.cosine4a_scan_topk_np)(
            q, db, k=k, max_distance=md
        )

        def scan(epilogue):
            return fs.fused_threshold4_scan_topk(
                qt, ti, tmeta, tscan.build_scan_sample(ti, sample_rows=1024),
                k=k, max_distance=md, query_mode=mode, epilogue=epilogue,
            )

        def exact_scan(rq):
            return fs.fused_cosine4_scan_topk(rq, ti, tmeta, k=k, max_distance=md, query_mode=mode)

    jd, jid = np.asarray(jd).copy(), np.asarray(jid).copy()
    bad = ~np.asarray(jex)
    jd[bad], jid[bad] = np.asarray(rd)[bad], np.asarray(ri)[bad]
    ed, ei = exact_scan(qt)
    repaired = {}
    for epilogue in ("cos", "dist"):
        d_, i_, ex = scan(epilogue)
        assert_same((d_[ex], i_[ex]), (ed[ex], ei[ex]))  # the flags are sound
        repaired[epilogue] = tscan.repair_unproven(qt, d_, i_, ex, exact_scan)
    assert_same(repaired["cos"], (jd, jid))
    assert_same(repaired["cos"], repaired["dist"])
    assert_same(repaired["cos"], want)
    if case == "self_match":
        assert int(repaired["cos"][1][0, 0]) == 7
        if kind != "cosine4a":  # the asymmetric int4 self-distance is near 0, not 0
            assert float(repaired["cos"][0][0, 0]) == 0.0


@pytest.mark.parametrize("kind", ["cosine", "cosine4a", "cosine4"])
def test_coskey_exact_flags_are_sound(rng, kind):
    """Every query flagged exact equals the exact scan (a 301-row tie
    plateau included); a collect buffer too small for the key-passing
    rows leaves every query unproven."""
    db = clustered(rng, 8192, 32)
    db[2000:2300] = db[5]
    q = db[rng.integers(0, 8192, 12)].copy()
    q[0] = db[5]
    qt = torch.from_numpy(q)
    if kind == "cosine":
        _, ti = u8_indexes(db)
        meta = fs.build_row_meta(ti)
        smp = tscan.build_scan_sample(ti, sample_rows=2048)
        run = lambda **kw: fs.fused_threshold_scan_topk(qt, ti, meta, smp, k=20, epilogue="cos", **kw)  # noqa: E731
        exact = fs.fused_cosine_scan_topk(qt, ti, meta, k=20)
    else:
        mode = "sym" if kind == "cosine4" else "asym"
        ti = T.build_semantic4_index(db, block_rows=1024, device="cpu")
        meta = T.build_semantic4_meta(ti)
        smp = tscan.build_scan_sample(ti, sample_rows=2048)
        run = lambda **kw: fs.fused_threshold4_scan_topk(  # noqa: E731
            qt, ti, meta, smp, k=20, query_mode=mode, epilogue="cos", **kw
        )
        exact = fs.fused_cosine4_scan_topk(qt, ti, meta, k=20, query_mode=mode)
    d, i, ex = run()
    assert_same((d[ex], i[ex]), (exact[0][ex], exact[1][ex]))
    assert bool(ex[1:].any())
    # ~2,000 key-passing rows a query against a 64-slot buffer: none proven.
    assert not bool(run(cap=64, target_count=2000)[2].any())


def test_plain_key_collect_is_a_superset_of_the_dist_collect(rng):
    """For every θ — 0, tiny, typical, at and past the cos-floor
    saturation, below −1 — the key filter keeps every row the distance
    filter keeps; K1e's rescore gives those rows their K1a distance
    bit for bit and every other collected row +inf."""
    db = clustered(rng, 4096, 32)
    db[100:110] = db[3]
    _, ti = u8_indexes(db)
    meta = fs.build_row_meta(ti)
    q = db[[3, 50, 999, 2000, 4000, 17, 18, 19]].copy()
    q[5:, :8] = 255 - q[5:, :8]
    qk = fs.CosineQueries.from_u8(torch.from_numpy(q))
    theta = torch.tensor(
        [0.0, 1e-7, 0.05, 0.6, fs.DIST_SATURATION, 2e6, -3.0, 1e3], dtype=torch.float32
    )
    cap = 4096
    cd, dd, di = qk.collect(theta, ti.data, meta, cap)
    ck, kk, ki = qk.coskey_collect(fs.cos_key_threshold(theta), ti.data, meta, cap)
    lens = torch.clamp(ck, max=cap)
    rescored = qk.rescore(theta, ti.data, meta, lens, ki)
    assert bool((ck >= cd).all())
    assert int(ck[4]) == int(ck[5]) == 4096 and int(cd[6]) == 0
    for r in range(len(q)):
        dist_rows = dict(zip(di[r, : cd[r]].tolist(), dd[r, : cd[r]].tolist()))
        key_rows = ki[r, : ck[r]].tolist()
        assert set(dist_rows) <= set(key_rows)
        for slot, row in enumerate(key_rows):
            got = float(rescored[r, slot])
            assert got == dist_rows[row] if row in dist_rows else got == float("inf")
        assert bool(torch.isinf(rescored[r, ck[r]:]).all())
    keys = kk[0, : ck[0]]
    assert bool((keys < fs.cos_key_threshold(theta)[0]).all())


def test_epilogue_is_checked():
    db = np.zeros((16, 32), np.uint8)
    db[:, ::2] = 200
    _, ti = u8_indexes(db)
    smp = tscan.build_scan_sample(ti, sample_rows=16)
    with pytest.raises(ValueError, match="epilogue"):
        fs.fused_threshold_scan_topk(torch.from_numpy(db[:1]), ti, fs.build_row_meta(ti), smp, k=2, epilogue="key")
    t4 = T.build_semantic4_index(db, device="cpu")
    with pytest.raises(ValueError, match="epilogue"):
        fs.fused_threshold4_scan_topk(torch.from_numpy(db[:1]), t4, T.build_semantic4_meta(t4),
                                      tscan.build_scan_sample(t4, sample_rows=16), k=2, epilogue="key")
    hq = fs.HammingQueries(torch.from_numpy(db[:1]), 32, False)
    meta = torch.ones(16, dtype=torch.uint8)
    with pytest.raises(ValueError, match="no cos key"):
        fs._threshold_scan(hq, ti.data.view(torch.uint8), meta, tscan.ScanSample(ti.data.view(torch.uint8), meta),
                           2, 1e3, None, None, "cos")
    with pytest.raises(ValueError, match="no cos key"):
        fs.coskey_rescore(*fs.CosineQueries.from_u8(torch.from_numpy(db[:1])), torch.ones(1), ti.data,
                          fs.build_row_meta(ti), "hamming", torch.zeros(1, dtype=torch.int32),
                          torch.zeros((1, 8), dtype=torch.int32))


# --------------------------------------------------------------------- #
# The batching service


def _records(rows, prefix, phashes=None):
    from pixelbox_tpu_torch.records import IndexedImage

    return [
        IndexedImage(
            filename=f"{prefix}_{j:05d}.png", path=f"/synthetic/{prefix}_{j:05d}.png",
            visual_hash=rows[j], phash=None if phashes is None else phashes[j],
        )
        for j in range(len(rows))
    ]


def _hash_engine(tmp_path, name, rows, phashes=None, **kw):
    from pixelbox_tpu_torch.engine import Engine

    eng = Engine.new(str(tmp_path / f"{name}.db"), embedder="none", device="cpu", **kw)
    eng.insert_records_batch(_records(rows, name, phashes))
    return eng


def _burst(service, queries, kind="semantic"):
    out = [None] * len(queries)
    start = threading.Barrier(len(queries))

    def one(j):
        start.wait(timeout=30)
        out[j] = service.submit(queries[j], kind=kind, timeout=60)

    threads = [threading.Thread(target=one, args=(j,)) for j in range(len(queries))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    return out


@pytest.mark.parametrize("n_queries", [24, 256])
def test_service_coalesces_into_the_direct_scan(rng, tmp_path, n_queries):
    """24 or 256 threads (more than the cores here), the interpreter
    switching threads every 10 µs: every caller gets its own query's
    results and the counters lose no update."""
    from pixelbox_tpu_torch.serving import BatchingScanService

    rows = clustered(rng, 16384, 128)
    eng = _hash_engine(tmp_path, "sem", rows)
    svc = BatchingScanService(eng.semantic_scan_inputs, k=30, max_wait_ms=200)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        q = rows[rng.integers(0, len(rows), n_queries)]
        got = _burst(svc, q)
        want = tscan.cosine_scan_topk_auto(torch.from_numpy(q), eng._sem_store.device_index, k=30)
        for j, (d, i) in enumerate(got):
            assert_same((d, i), (want[0][j], want[1][j]))
        assert svc.queries_served == n_queries and svc.batches_run < n_queries
    finally:
        sys.setswitchinterval(interval)
        svc.close()
        eng.close()


@pytest.mark.parametrize("precision", ["int8", "int4"])
def test_service_picks_the_epilogue_by_bucket(rng, tmp_path, monkeypatch, precision):
    """Every batch's threshold pass selects on the distance (K1a for u8,
    K4a for int4), a full bucket as well as the bucket below it (the
    tensor-core collects filter on the cos key inside their one launch);
    the results are the same."""
    from pixelbox_tpu_torch.serving import BatchingScanService
    from pixelbox_tpu_torch.serving import service as service_mod

    rows = clustered(rng, 4096, 32)
    eng = _hash_engine(tmp_path, "pick", rows, semantic_precision=precision)
    name = "cosine4_scan_topk_auto" if precision == "int4" else "cosine_scan_topk_auto"
    auto = getattr(service_mod, name)
    seen = []

    def spy(*args, **kw):
        seen.append(kw.get("epilogue", "dist"))  # the auto scans' default
        return auto(*args, **kw)

    monkeypatch.setattr(service_mod, name, spy)
    svc = BatchingScanService(eng.semantic_scan_inputs, k=20)
    try:
        q = rows[rng.integers(0, len(rows), service_mod._BUCKETS[-1])]
        full = svc._semantic_scan(q)
        below = svc._semantic_scan(q[: service_mod._BUCKETS[-2]])
        assert seen == ["dist", "dist"]
        assert_same((full[0][: len(below[0])], full[1][: len(below[0])]), below)
    finally:
        svc.close()
        eng.close()


def test_concurrent_first_uploads_build_one_embedder(tmp_path, monkeypatch):
    """The lazy embedder is built once however many request threads ask
    for it first (a burst of uploads to a fresh server)."""
    import time

    import pixelbox_tpu_torch.engine as engine_mod

    built = []

    def slow_embedder(name, **kw):
        time.sleep(0.05)
        built.append(name)
        return object()

    eng = engine_mod.Engine.new(str(tmp_path / "e.db"), dim=32, device="cpu")
    monkeypatch.setattr(engine_mod, "get_embedder", slow_embedder)
    seen = []
    threads = [threading.Thread(target=lambda: seen.append(eng.embedder)) for _ in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(built) == 1 and len({id(x) for x in seen}) == 1
    eng.close()


def test_phash_uniform_flag_follows_the_store(rng, tmp_path):
    rows = clustered(rng, 64, 32)
    ph = rng.integers(0, 256, (64, 32), dtype=np.uint8)
    eng = _hash_engine(tmp_path, "phu", rows, ph)
    try:
        assert eng.phash_store_uniform()
        short = _records(rows[:1], "short", [ph[0, :24].copy()])
        eng.insert_records_batch(short)
        assert not eng.phash_store_uniform()
        with pytest.raises(ValueError, match="mixed-width"):
            eng.phash_scan_batched(ph[:2], 5, 1e3)
        eng.query_by_phash(ph[0, :24])
        top = [(r.path, r.distance_from_query) for r in eng.get_query_results()[:2]]
        assert top == [("/synthetic/phu_00000.png", 0.0), ("/synthetic/short_00000.png", 0.0)]
        assert eng.remove_image(eng._ph_image_ids[-1])
        eng.compact()
        assert eng.phash_store_uniform()
    finally:
        eng.close()


def test_service_int4_rerank_trims_to_n_real(rng, tmp_path):
    from pixelbox_tpu_torch.serve import build_scan_service

    rows = clustered(rng, 4096, 32)
    eng = _hash_engine(tmp_path, "i4", rows, semantic_precision="int4")
    svc = build_scan_service(eng)
    try:
        q = np.zeros((256, 32), np.uint8)  # the full bucket: the cos-key pass
        q[:5] = rows[[1, 2, 3, 500, 4000]]
        d, i = svc._semantic_scan(q, n_real=5)
        assert d.shape == (5, 100) and i.shape == (5, 100)
        got = _burst(svc, q[:5])
        for j in range(5):
            eng.query_by_image_hash_from_id(eng._sem_image_ids[[1, 2, 3, 500, 4000][j]])
            direct = [(r.id, r.distance_from_query) for r in eng.get_query_results()]
            dj, ij = got[j]
            keep = ij >= 0
            assert [(eng._sem_image_ids[int(r)], float(x)) for r, x in zip(ij[keep], dj[keep])] == direct
            assert_same((d[j], i[j]), got[j])
            assert direct[0][1] == 0.0
    finally:
        svc.close()
        eng.close()


def test_service_phash_kind_and_errors_reach_submit(rng, tmp_path):
    from pixelbox_tpu_torch.serve import build_scan_service

    rows = clustered(rng, 2048, 32)
    ph = rng.integers(0, 256, (2048, 32), dtype=np.uint8)
    eng = _hash_engine(tmp_path, "ph", rows, ph)
    svc = build_scan_service(eng)
    try:
        assert svc.kinds == ("semantic", "ivf", "phash")  # ivf registers always, as in the JAX engine
        got = _burst(svc, ph[[3, 4, 5, 6]], kind="phash")
        for j, r in enumerate((3, 4, 5, 6)):
            eng.query_by_phash(ph[r])
            direct = [(x.id, x.distance_from_query) for x in eng.get_query_results()]
            d, i = got[j]
            keep = i >= 0
            assert list(zip(eng.phash_ids_for_rows(i[keep]), d[keep].tolist())) == direct
            assert direct[0] == (eng._ph_image_ids[r], 0.0)

        def boom(q, k, md):
            raise RuntimeError("scan failed on purpose")

        svc.register_kind("boom", boom)
        with pytest.raises(RuntimeError, match="on purpose"):
            svc.submit(rows[0], kind="boom")
        with pytest.raises(KeyError):
            svc.submit(rows[0], kind="face")
    finally:
        svc.close()
        eng.close()


def test_phash_submit_completes_with_a_writer_waiting(rng, tmp_path):
    """A request holds the index read lock across submit → assemble; a
    writer (a removal, a compaction, an append) parks on the lock while the
    request waits on the collector.  The collector's scan takes no new
    read, so the request completes and the write then goes through."""
    from pixelbox_tpu_torch.serve import build_scan_service

    rows = clustered(rng, 256, 32)
    ph = rng.integers(0, 256, (256, 32), dtype=np.uint8)
    eng = _hash_engine(tmp_path, "lock", rows, ph)
    svc = build_scan_service(eng)
    lock = eng.index_rwlock

    def scan_once_a_writer_waits(q, k, md):
        deadline = time.monotonic() + 30
        while not lock._writers_waiting and time.monotonic() < deadline:
            time.sleep(0.001)
        return eng.phash_scan_batched(q, k, md)

    svc.register_kind("phash", scan_once_a_writer_waits)
    out = {}

    def request():
        with lock.read_locked():
            out["result"] = svc.submit(ph[5], kind="phash", timeout=20)

    def write():
        with lock.write_locked():
            out["wrote"] = "result" in out

    try:
        reader = threading.Thread(target=request, daemon=True)
        reader.start()
        while not lock._readers:
            time.sleep(0.001)
        writer = threading.Thread(target=write, daemon=True)
        writer.start()
        reader.join(60)
        writer.join(60)
        assert not reader.is_alive() and not writer.is_alive()
        d, i = out["result"]
        assert (int(i[0]), float(d[0])) == (5, 0.0)
        assert out["wrote"]  # after the request had its results
    finally:
        svc.close()
        eng.close()


def test_served_phash_checks_widths_under_the_read_lock(rng, tmp_path):
    """The server's phash path reads the store's width list only under the
    index read lock (an append bumps the version before it extends the
    list), and a batched upload answers with the stored image first."""
    from pixelbox_tpu_torch.serve import build_scan_service, make_server

    img = io.BytesIO()
    Image.fromarray(textured_image(seed=5, size=(64, 64))).save(img, format="PNG")
    eng = _hash_engine(tmp_path, "srvlock", clustered(rng, 64, 32),
                       rng.integers(0, 256, (64, 32), dtype=np.uint8))
    eng.insert_records_batch([eng.load_image_from_memory(img.getvalue(), "up.png", "/synthetic/up.png")])
    check = eng.phash_store_uniform
    held = []
    # Readers in the lock: the request thread's own read, or on the
    # collector thread the read of the request it scans for.
    eng.phash_store_uniform = lambda: held.append(eng.index_rwlock._readers) or check()
    svc = build_scan_service(eng)
    srv = make_server(eng, "127.0.0.1", 0, svc)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        held.clear()
        status, out = _http(f"http://127.0.0.1:{srv.server_address[1]}", "/api/phash-similar", img.getvalue())
        assert status == 200 and out[0]["path"] == "/synthetic/up.png" and out[0]["distance"] == 0.0
        assert len(held) == 2 and all(held) and svc.queries_served == 1
    finally:
        srv.shutdown()
        srv.server_close()
        svc.close()
        eng.close()


def test_service_sees_in_place_appends_and_deletes(rng, tmp_path):
    """The store appends and tombstones in place (the tensor survives
    the mutation); the next batch must see both."""
    from pixelbox_tpu_torch.serving import BatchingScanService

    rows = clustered(rng, 1000, 32)
    eng = _hash_engine(tmp_path, "mut", rows)
    svc = BatchingScanService(eng.semantic_scan_inputs, k=10)
    try:
        q = rows[17].copy()
        q[:3] = 255 - q[:3]
        before = svc.submit(q)
        data = eng._sem_store.device_index.data
        new_id = eng.insert_records_batch(_records(q[None], "copy"))[0]
        assert eng._sem_store.device_index.data is data, "the append was in place"
        d, i = svc.submit(q)
        assert float(d[0]) == 0.0 and eng._sem_image_ids[int(i[0])] == new_id
        victim = eng._sem_image_ids[int(before[1][0])]
        assert eng.remove_image(victim)
        assert eng._sem_store.device_index.data is data, "the tombstone was in place"
        d, i = svc.submit(q)
        ids = [eng._sem_image_ids[int(r)] for r in i if r >= 0]
        assert ids[0] == new_id and victim not in ids
        want = tscan.cosine_scan_topk(torch.from_numpy(q), eng._sem_store.device_index, k=10)
        assert_same((d, i), want)
    finally:
        svc.close()
        eng.close()


# --------------------------------------------------------------------- #
# The web server vs JAX serve.py on one library


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A library indexed by the JAX engine, copied twice: one copy served
    by JAX ``serve.py`` (unbatched), one by the port's server (batched,
    ``device="cpu"``).  Yields the two base URLs and the image files."""
    from pixelbox_tpu.engine import Engine as JEngine
    from pixelbox_tpu.serve import make_handler as jax_handler
    from pixelbox_tpu_torch.engine import Engine
    from pixelbox_tpu_torch.serve import build_scan_service, make_server

    root = tmp_path_factory.mktemp("served")
    photos = root / "photos"
    photos.mkdir()
    files = []
    for i in range(10):
        p = photos / f"cat_{i}.png"
        Image.fromarray(textured_image(seed=300 + i % 7, size=(64, 64))).save(p)
        files.append(str(p))
    db = str(root / "jax.db")
    eng = JEngine.new(db, embedder="stub", dim=32)
    eng.add_tracked_folder(str(photos))
    eng.start_indexing(num_workers=2)
    assert eng.wait_for_indexing(timeout=300)
    eng.close()
    port_db = str(root / "port.db")
    src, dst = sqlite3.connect(db), sqlite3.connect(port_db)
    with dst:
        src.backup(dst)  # the write-ahead log included
    src.close()
    dst.close()
    jeng = JEngine.open(db)
    teng = Engine.open(port_db, device="cpu")
    svc = build_scan_service(teng)
    servers = [
        ThreadingHTTPServer(("127.0.0.1", 0), jax_handler(jeng, threading.Lock(), None)),
        make_server(teng, "127.0.0.1", 0, svc),
    ]
    threads = [threading.Thread(target=s.serve_forever, daemon=True) for s in servers]
    for t in threads:
        t.start()
    yield [f"http://127.0.0.1:{s.server_address[1]}" for s in servers], files, svc
    for s in servers:
        s.shutdown()
        s.server_close()
    svc.close()
    jeng.close()
    teng.close()


def _http(base, path, body=None):
    req = urllib.request.Request(base + path, data=body, method="POST" if body is not None else "GET")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_server_json_equals_jax_serve(served):
    (jax_url, port_url), files, svc = served

    def both(path, body=None):
        got = _http(port_url, path, body)
        assert got == _http(jax_url, path, body), path
        assert got[0] == 200, got
        return got[1]

    for q in ("/api/search?q=cat", "/api/search?q=cat_3&limit=5", "/api/similar?id=2",
              "/api/similar?id=7", "/api/results?offset=2&limit=3"):
        both(q)
    res = both("/api/phash-similar", open(files[4], "rb").read())
    assert res[0]["path"] == files[4] and res[0]["distance"] == 0.0
    assert both("/api/tag", json.dumps({"id": 3, "name": "mood", "value": "sunny"}).encode()) == {
        "tags": {"mood": "sunny"}
    }
    assert [r["id"] for r in both("/api/search?q=tag:sunny")] == [3]
    top = both("/api/similar?id=1")
    victim = top[1]["id"]
    assert both("/api/remove", json.dumps({"id": victim}).encode()) == {"removed": victim}
    after = both("/api/similar?id=1")
    assert victim not in [r["id"] for r in after]
    status = _http(port_url, "/api/status")[1]
    assert status["scan_batches"] >= 1 and status["scan_queries"] >= 3
    # The recorder's aggregates beside them: each batch a span with each
    # request's queue wait; and its counters (a CPU server syncs no card).
    spans = status["spans"]
    assert spans["serving.batch.semantic"]["count"] >= 1
    assert spans["serving.queue_wait"]["count"] >= status["scan_queries"]
    assert spans["serving.batch.semantic"]["max_ms"] >= spans["serving.batch.semantic"]["mean_ms"]
    assert set(status["counters"]) == {
        "host_syncs", "repaired_queries", "scan_graph_captures", "scan_graph_replays",
    }


def test_server_refuses_what_is_not_ported(served):
    (_, port_url), files, _ = served
    assert _http(port_url, "/api/faces?id=1")[0] == 501
    assert _http(port_url, "/api/face-similar", open(files[0], "rb").read())[0] == 501
    code, body = _http(port_url, "/api/search?q=text:cat")
    assert code == 501 and "not yet ported" in body["error"]
    # The ivf scan mode is ported: accepted, served, then set back.
    assert _http(port_url, "/api/settings", json.dumps({"scan_mode": "ivf"}).encode())[0] == 200
    code, res = _http(port_url, "/api/similar?id=2")
    assert code == 200 and res[0]["id"] == 2 and res[0]["distance"] == 0.0
    assert _http(port_url, "/api/status")[1]["ivf_nprobe_effective"] is not None
    assert _http(port_url, "/api/settings", json.dumps({"scan_mode": "auto"}).encode())[0] == 200
    assert _http(port_url, "/api/settings", json.dumps({"max_distance": "x"}).encode())[0] == 400
    assert _http(port_url, "/api/similar?id=999")[0] == 404
    assert _http(port_url, "/api/similar?id=abc")[0] == 500


# --------------------------------------------------------------------- #
# The CLI's new commands


def _cli(argv):
    from pixelbox_tpu_torch.cli import main

    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv + ["--device", "cpu"])
    return rc, buf.getvalue()


def test_cli_removal_tag_and_similar_id(tmp_path):
    photos = tmp_path / "photos"
    (photos / "sub").mkdir(parents=True)
    for i in range(4):
        Image.fromarray(textured_image(seed=50 + i, size=(48, 48))).save(photos / f"p{i}.png")
    Image.fromarray(textured_image(seed=50, size=(48, 48))).save(photos / "sub" / "copy.png")
    db = str(tmp_path / "lib.db")
    assert _cli(["init", db, "--dim", "32"])[0] == 0
    assert _cli(["add-folder", db, str(photos)])[0] == 0
    # one decode worker: ids follow the crawl, so id 2 is never sub/copy.png
    assert _cli(["index", db, "--workers", "1"])[1].splitlines()[-1] == "Indexed images: 5"
    assert _cli(["folders", db])[1].split() == [str(photos)]
    rc, out = _cli(["similar-id", db, "1", "--json", "--max-distance", "1e7"])
    res = json.loads(out)
    assert rc == 0 and res[0]["id"] == 1 and res[0]["distance"] == 0.0
    assert _cli(["tag", db, "2", "mood", "sunny"])[0] == 0
    assert [r["id"] for r in json.loads(_cli(["search", db, "tag:sunny", "--json"])[1])] == [2]
    assert _cli(["untag", db, "2", "mood"])[0] == 0
    assert _cli(["untag", db, "2", "mood"])[0] == 1
    assert _cli(["remove-image", db, "2"])[0] == 0
    assert _cli(["remove-image", db, "2"])[0] == 1
    assert _cli(["compact", db])[0] == 0
    rc, out = _cli(["remove-folder", db, str(photos / "sub"), "--purge"])
    assert rc == 0 and out.strip().endswith("removed 1 images")
    ids = [r["id"] for r in json.loads(_cli(["similar-id", db, "1", "--json", "--max-distance", "1e7"])[1])]
    assert 2 not in ids and len(ids) == 3
