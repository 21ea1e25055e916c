"""pixelbox_tpu_torch's engine in ``scan_mode="ivf"`` (serving/ivf.py) vs
pixelbox_tpu's on the CPU, the ``<db>.ivf.npz`` sidecar shared by both,
the CLI flags, the web server's settings and the batching service's
``ivf`` kind.

A library written by the JAX engine opens in the port: the port reads the
JAX engine's sidecar (no k-means), so both probe the same centroids and
``similar`` gives the same (id, distance) list; the other way round, the
JAX engine reads the port's sidecar.  The cases that mirror
``tests/test_engine_ivf.py`` run on port-only libraries of stub-embedded
images.
"""

import io
import json
import os
import threading
import urllib.request
from contextlib import redirect_stdout

import numpy as np
import pytest
from PIL import Image

from fixtures import textured_image
from pixelbox_tpu_torch.utils.timing import get_stats as get_spans, reset_stats as reset_spans


def _write(d, names_seeds):
    for name, seed in names_seeds:
        Image.fromarray(textured_image(seed=seed, size=(48, 48))).save(d / name)


@pytest.fixture()
def ivf_engine(tmp_path):
    from pixelbox_tpu_torch.engine import Engine

    d = tmp_path / "photos"
    d.mkdir()
    _write(d, [(f"s{s}.png", s) for s in range(10)])
    eng = Engine.new(str(tmp_path / "ivf.db"), embedder="stub", embedder_kwargs={"dim": 32},
                     device="cpu")
    eng.max_distance_from_query = 1e7
    for s in range(10):
        eng.insert_image_from_path(str(d / f"s{s}.png"))
    eng.scan_mode = "ivf"
    eng.ivf_clusters = 3
    eng.ivf_nprobe = 3  # exhaustive at this size -> equal to the exact scan
    yield eng, d
    eng.close()


def _results(eng):
    return [(r.id, float(r.distance_from_query)) for r in eng.get_query_results()]


def _exact(eng, rec):
    eng.scan_mode = "exact"
    eng.query_by_image_hash_from_image(rec)
    eng.scan_mode = "ivf"
    return _results(eng)


def _by_id(eng, image_id):
    eng.query_by_image_hash_from_id(image_id)
    return _results(eng)


def test_sidecar_shared_with_jax_engine(tmp_path):
    """JAX engine trains and saves; the port reads it without k-means and
    answers identically at a partial nprobe; then the port trains a new
    cluster count, saves, and the JAX engine reads the port's sidecar."""
    from pixelbox_tpu.engine import Engine as JEngine
    from pixelbox_tpu_torch.engine import Engine

    rng = np.random.default_rng(31)
    centers = rng.normal(size=(6, 32)) * 40.0
    rows = np.clip(centers[rng.integers(0, 6, 240)] + rng.normal(size=(240, 32)) * 8 + 128, 0, 255)
    rows = rows.astype(np.uint8)
    db = str(tmp_path / "shared.db")
    jeng = JEngine.new(db, embedder="none")
    for j, h in enumerate(rows):
        jeng.catalog.insert_image(filename=f"r{j}.png", path=f"/syn/r{j}.png", width=1, height=1,
                                  semantic_hash=h.tobytes())
    jeng.close()

    def run(engine_cls, clusters, nprobe, **kw):
        eng = engine_cls.open(db, **kw)
        eng.max_distance_from_query = 1e7
        eng.scan_mode = "ivf"
        eng.ivf_clusters = clusters
        eng.ivf_nprobe = nprobe
        out = [_by_id(eng, i) for i in (1, 77, 200)]
        cents, gen = np.array(eng._ivf_centroids), eng._ivf_centroid_gen
        eng.close()
        return out, cents, gen

    want, jc, _ = run(JEngine, 8, 2)
    assert os.path.exists(db + ".ivf.npz")
    reset_spans()
    got, tc, gen = run(Engine, 8, 2, device="cpu")
    assert "engine.ivf_train" not in get_spans() and gen == 0
    assert np.array_equal(tc, jc)
    assert got == want
    assert all(r[0][1] == 0.0 for r in got)

    got, tc, gen = run(Engine, 5, 2, device="cpu")  # a new knob: the port retrains
    assert gen == 1 and tc.shape[0] == 5
    want, jc, _ = run(JEngine, 5, 2)
    assert np.array_equal(jc, tc)
    assert got == want


def test_ivf_query_matches_exact(ivf_engine):
    eng, d = ivf_engine
    rec = eng.load_image(str(d / "s4.png"))
    eng.query_by_image_hash_from_image(rec)
    got = _results(eng)
    assert got == _exact(eng, rec)
    assert got[0][1] == 0.0


def test_append_extends_spill_without_bucket_repack(ivf_engine):
    eng, d = ivf_engine
    rec = eng.load_image(str(d / "s6.png"))
    eng.query_by_image_hash_from_image(rec)
    bd0, packed_n = eng._ivf.bucket_data, eng._ivf_packed_n
    _write(d, [("a70.png", 70), ("a71.png", 71)])
    reset_spans()
    for s in (70, 71):
        eng.insert_image_from_path(str(d / f"a{s}.png"))
        eng.query_by_image_hash_from_file(str(d / f"a{s}.png"))
        top = eng.get_query_results()[0]
        assert top.path.endswith(f"a{s}.png") and float(top.distance_from_query) == 0.0
    spans = get_spans()
    assert "engine.ivf_extend" in spans and "engine.ivf_build" not in spans
    assert eng._ivf.bucket_data is bd0 and eng._ivf_packed_n == packed_n
    ids = eng._ivf.spill_rows.numpy()
    assert len(ids[ids >= 0]) == len(np.unique(ids[ids >= 0]))
    eng.query_by_image_hash_from_image(rec)
    assert _results(eng) == _exact(eng, rec)


def test_ivf_skips_removed_images(ivf_engine):
    eng, d = ivf_engine
    rec = eng.load_image(str(d / "s2.png"))
    eng.query_by_image_hash_from_image(rec)
    removed = eng.get_query_results()[0].id
    eng.remove_image(removed)
    eng.query_by_image_hash_from_image(rec)
    assert all(r.id != removed for r in eng.get_query_results())


def test_centroids_retrain_on_doubling_and_knob(ivf_engine):
    eng, d = ivf_engine
    rec = eng.load_image(str(d / "s0.png"))
    eng.query_by_image_hash_from_image(rec)
    trained_at, c0 = eng._ivf_trained_n, eng._ivf_centroids
    _write(d, [("one.png", 50)])
    eng.insert_image_from_path(str(d / "one.png"))
    eng.query_by_image_hash_from_image(rec)
    assert eng._ivf_trained_n == trained_at and eng._ivf_centroids is c0
    _write(d, [(f"x{s}.png", s) for s in range(60, 60 + 2 * trained_at)])
    for s in range(60, 60 + 2 * trained_at):
        eng.insert_image_from_path(str(d / f"x{s}.png"))
    eng.query_by_image_hash_from_image(rec)
    assert eng._ivf_trained_n > trained_at
    # A new cluster count retrains with no store mutation in between.
    eng.ivf_clusters = 2
    eng.ivf_nprobe = 2
    eng.query_by_image_hash_from_image(rec)
    assert eng._ivf_centroids.shape[0] == 2
    assert _results(eng) == _exact(eng, rec)


def test_sidecar_from_other_library_rejected_and_reopen_restores(tmp_path):
    from pixelbox_tpu_torch.engine import Engine

    d = tmp_path / "photos"
    d.mkdir()
    _write(d, [(f"s{s}.png", s) for s in range(8)] + [(f"n{s}.png", s) for s in range(20, 25)])
    db = str(tmp_path / "re.db")

    def library(names):
        eng = Engine.new(db, embedder="stub", embedder_kwargs={"dim": 32}, device="cpu")
        eng.max_distance_from_query = 1e7
        for n in names:
            eng.insert_image_from_path(str(d / n))
        eng.scan_mode = "ivf"
        eng.ivf_clusters = 2
        return eng

    eng = library([f"s{s}.png" for s in range(8)])
    eng.query_by_image_hash_from_file(str(d / "s0.png"))
    c_trained = np.array(eng._ivf_centroids)
    eng.close()
    eng = Engine.open(db, device="cpu")  # a reopen restores the centroids
    eng.max_distance_from_query = 1e7
    eng.scan_mode = "ivf"
    reset_spans()
    eng.query_by_image_hash_from_file(str(d / "s0.png"))
    assert "engine.ivf_train" not in get_spans()
    assert np.array_equal(np.array(eng._ivf_centroids), c_trained)
    assert eng.get_query_results()[0].path.endswith("s0.png")
    eng.close()
    os.remove(db)  # rebuilt in place: the stale sidecar stays behind
    eng = library([f"n{s}.png" for s in range(20, 25)])
    eng.query_by_image_hash_from_file(str(d / "n20.png"))
    assert eng._ivf_trained_n == 5
    assert eng.get_query_results()[0].path.endswith("n20.png")
    eng.close()


def test_int4_library_ivf_matches_flat_with_rerank(tmp_path):
    from pixelbox_tpu_torch.engine import Engine

    d = tmp_path / "photos"
    d.mkdir()
    _write(d, [(f"s{s}.png", s) for s in range(10)])
    eng = Engine.new(str(tmp_path / "i4.db"), embedder="stub", embedder_kwargs={"dim": 32},
                     semantic_precision="int4", device="cpu")
    eng.max_distance_from_query = 1e7
    try:
        for s in range(10):
            eng.insert_image_from_path(str(d / f"s{s}.png"))
        rec = eng.load_image(str(d / "s2.png"))
        eng.scan_mode = "auto"
        eng.query_by_image_hash_from_image(rec)
        want = _results(eng)
        assert want[0][1] == 0.0
        eng.scan_mode = "ivf"
        eng.ivf_clusters = 3
        eng.ivf_nprobe = 3
        eng.query_by_image_hash_from_image(rec)
        assert eng._ivf.kind == "cosine4a"
        assert _results(eng) == want
        eng.int4_rerank = False
        eng.query_by_image_hash_from_image(rec)
        assert _results(eng) == _exact(eng, rec)
    finally:
        eng.close()


def test_cli_ivf_flags(tmp_path):
    from pixelbox_tpu_torch.cli import main

    d = tmp_path / "photos"
    d.mkdir()
    _write(d, [(f"s{s}.png", s) for s in range(4)])
    db = str(tmp_path / "c.db")
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert main(["init", db, "--dim", "32", "--device", "cpu"]) == 0
        assert main(["add-folder", db, str(d), "--device", "cpu"]) == 0
        assert main(["index", db, "--device", "cpu"]) == 0
        buf.truncate(0)
        assert main(["similar", db, str(d / "s1.png"), "--json", "--device", "cpu",
                     "--scan-mode", "ivf", "--nprobe", "2", "--ivf-clusters", "2",
                     "--ivf-target-recall", "0.5"]) == 0
    res = json.loads(buf.getvalue()[buf.getvalue().index("["):])
    assert res[0]["path"].endswith("s1.png") and res[0]["distance"] == 0.0
    assert os.path.exists(db + ".ivf.npz")


def test_concurrent_queries_train_once(ivf_engine):
    eng, d = ivf_engine
    rec = eng.load_image(str(d / "s3.png"))
    reset_spans()
    errs = []

    def worker():
        try:
            for _ in range(3):
                eng.query_by_image_hash_from_image(rec)
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    ts = [threading.Thread(target=worker) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errs
    assert get_spans()["engine.ivf_train"]["count"] == 1
    assert get_spans()["engine.ivf_build"]["count"] == 1


def test_service_ivf_kind_and_server_settings(ivf_engine):
    from pixelbox_tpu_torch.serve import build_scan_service, make_server

    eng, d = ivf_engine
    svc = build_scan_service(eng)  # warms the ivf kind: trains and packs
    server = make_server(eng, "127.0.0.1", 0, svc)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}"

    def http(path, body=None):
        req = urllib.request.Request(url + path, data=body, method="POST" if body else "GET")
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())

    try:
        assert "ivf" in svc.kinds and eng._ivf is not None
        hashes = eng._sem_store._host_rows[:4]
        got = [svc.submit(h, kind="ivf") for h in hashes]
        want = eng.ivf_scan_batched(hashes, svc.k, svc.max_distance)
        for j, (dj, ij) in enumerate(got):
            assert np.array_equal(ij, want[1][j]) and np.array_equal(dj, want[0][j])
        st = http("/api/status")
        assert st["scan_mode"] == "ivf" and st["ivf_nprobe"] == 3 and st["ivf_nprobe_effective"] == 3
        assert http("/api/settings", json.dumps({"ivf_nprobe": 0, "ivf_clusters": 2}).encode())["ok"]
        assert eng.ivf_nprobe is None and eng.ivf_clusters == 2
        res = http("/api/similar?id=3")
        assert res[0]["id"] == 3 and res[0]["distance"] == 0.0
        st = http("/api/status")
        assert st["ivf_nprobe"] is None and st["ivf_clusters"] == 2
        assert st["ivf_nprobe_effective"] == 2  # the 2% policy's floor, clamped to 2 clusters
    finally:
        server.shutdown()
        server.server_close()
        svc.close()


def test_mesh_serves_the_sharded_ivf(ivf_engine):
    """``serve_on_mesh`` + ivf: the sharded index (per-shard buckets, the
    shared centroids) answers as one device at full nprobe; an append
    extends the per-shard spills; a tuned nprobe re-derives on it."""
    from pixelbox_tpu_torch.parallel import make_mesh

    eng, d = ivf_engine
    ids = [1, 4, 7]
    want = [_by_id(eng, i) for i in ids]
    eng.serve_on_mesh(make_mesh(3, device="cpu"))
    assert [_by_id(eng, i) for i in ids] == want
    assert eng._ivf_sharded is not None and eng._ivf_sharded.n_shards == 3
    _write(d, [("m80.png", 80)])
    eng.insert_image_from_path(str(d / "m80.png"))
    reset_spans()
    eng.query_by_image_hash_from_file(str(d / "m80.png"))
    assert "engine.ivf_extend" in get_spans() and "engine.ivf_build" not in get_spans()
    top = eng.get_query_results()[0]
    assert top.path.endswith("m80.png") and float(top.distance_from_query) == 0.0
    got = [_by_id(eng, i) for i in ids]
    eng.scan_mesh = None
    assert got == [_by_id(eng, i) for i in ids]
    eng.serve_on_mesh(make_mesh(3, device="cpu"))
    eng.ivf_nprobe, eng.ivf_target_recall = None, 0.5
    eng.query_by_image_hash_from_id(1)
    assert eng._ivf_tuned_nprobe is not None and eng.get_query_results()[0].id == 1
