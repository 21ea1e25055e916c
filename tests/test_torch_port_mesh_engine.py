"""pixelbox_tpu_torch's engine under ``serve_on_mesh`` vs pixelbox_tpu on
the CPU.

Hash-only libraries are written by the JAX engine and copied for the
port; the JAX engine serves them from its 8 virtual CPU devices
(tests/conftest.py), the port from ``make_mesh(8, device="cpu")`` and
from one device.  ``similar`` in every scan mode, phash search at one and
at mixed widths, int4 with and without the exact-u8 rerank, a filtered
``similar:`` query and the duplicate passes must give the same results
in all three; appends sync the mirrors as deltas and removals reshard.
"""

import sqlite3
import zlib

import numpy as np
import pytest

from pixelbox_tpu.parallel.mesh import make_mesh as jax_make_mesh
from pixelbox_tpu_torch.parallel.mesh import make_mesh
from test_torch_port_mesh import D, clustered

LIB = 20000  # > 16,384 rows: a filter matching them takes the masked scan


def _records(cls, rows, phashes, prefix):
    return [
        cls(
            filename=f"{prefix}_{j:05d}.png", path=f"/synthetic/{prefix}_{j:05d}.png",
            visual_hash=rows[j], phash=None if phashes is None else phashes[j],
        )
        for j in range(len(rows))
    ]


def _copy_db(src_path, dst_path):
    src, dst = sqlite3.connect(src_path), sqlite3.connect(dst_path)
    with dst:
        src.backup(dst)
    src.close()
    dst.close()


def _library(tmp_path_factory, name, precision, phash_widths=None, n=LIB):
    """A hash-only library written by the JAX engine and a copy for the
    port; returns (jax engine on its mesh, port engine on its mesh, port
    engine on one device, semantic rows)."""
    from pixelbox_tpu.engine import Engine as JEngine
    from pixelbox_tpu.records import IndexedImage as JRecord
    from pixelbox_tpu_torch.engine import Engine

    rng = np.random.default_rng(zlib.crc32(name.encode()))
    root = tmp_path_factory.mktemp(name)
    rows = clustered(rng, n, D)
    rows[1::997] = rows[0::997][: len(rows[1::997])]  # exact duplicates
    ph = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    ph[1::997] = ph[0::997][: len(ph[1::997])]
    phashes = [p for p in ph]
    if phash_widths is not None:  # rows 2j and 2j + 1 share a width
        phashes = [p[: phash_widths[j // 2 % len(phash_widths)]] for j, p in enumerate(ph)]
    jdb = str(root / "jax.db")
    jeng = JEngine.new(jdb, embedder="none", semantic_precision=precision)
    jeng.insert_records_batch(_records(JRecord, rows, phashes, "cat"))
    jeng.close()
    pdb = str(root / "port.db")
    _copy_db(jdb, pdb)
    sdb = str(root / "single.db")
    _copy_db(jdb, sdb)
    jeng = JEngine.open(jdb)
    jeng.serve_on_mesh(jax_make_mesh(8))
    teng = Engine.open(pdb, device="cpu")
    teng.serve_on_mesh(make_mesh(8, device="cpu"))
    single = Engine.open(sdb, device="cpu")
    for e in (jeng, teng, single):
        e.max_distance_from_query = 1e7
    return jeng, teng, single, rows


def _results(eng):
    return [(r.id, r.distance_from_query) for r in eng.get_query_results()]


@pytest.fixture(scope="module")
def u8_lib(tmp_path_factory):
    engines = _library(tmp_path_factory, "mesh_u8", "int8")
    yield engines
    for e in engines[:3]:
        e.close()


@pytest.fixture(scope="module")
def small_lib(tmp_path_factory):
    """A 1,024-row library (4 query batches of 256): the whole-index passes."""
    engines = _library(tmp_path_factory, "mesh_small", "int8", n=1024)
    yield engines
    for e in engines[:3]:
        e.close()


@pytest.mark.parametrize("mode", ["auto", "exact", "pallas", "fast"])
def test_engine_similar_on_mesh_matches_jax_and_one_device(u8_lib, mode):
    jeng, teng, single, _ = u8_lib
    for e in (jeng, teng, single):
        e.scan_mode = mode
    try:
        for image_id in (1, 998, 12345):
            got = []
            for e in (jeng, teng, single):
                e.query_by_image_hash_from_id(image_id)
                got.append(_results(e))
            assert got[0][0] == (image_id, 0.0) and len(got[0]) == 100
            assert got[1] == got[0] and got[2] == got[0], (mode, image_id)
        assert teng._sem_mirror.index is not None and single._sem_mirror.index is None
    finally:
        for e in (jeng, teng, single):
            e.scan_mode = "auto"


def test_engine_phash_on_mesh_matches_jax_and_one_device(u8_lib):
    jeng, teng, single, _ = u8_lib
    ph = np.frombuffer(teng.catalog.get_hash("phashes", 998), dtype=np.uint8)
    got = []
    for e in (jeng, teng, single):
        e.query_by_phash(ph)
        got.append(_results(e))
    assert got[0][:2] == [(998, 0.0), (999, 0.0)]  # rows 997 and 998 are copies
    assert got[1] == got[0] and got[2] == got[0]
    assert teng._ph_mirror.index is not None


def test_engine_filtered_similar_on_mesh(u8_lib):
    """A broad ``similar:`` filter (every row matches ``cat``): the masked
    exact scan over the sharded mirror's validity."""
    from pixelbox_tpu.records import IndexedImage as JRecord
    from pixelbox_tpu_torch.records import IndexedImage

    jeng, teng, single, rows = u8_lib
    probe = "/synthetic/probe.png"
    got = []
    for e, cls in ((jeng, JRecord), (teng, IndexedImage), (single, IndexedImage)):
        e._cached_image_search = cls(filename="probe.png", path=probe, visual_hash=rows[4242])
        e.query(f"cat similar:{probe}")
        got.append(_results(e))
    assert got[0][0] == (4243, 0.0) and len(got[0]) == 100
    assert got[1] == got[0] and got[2] == got[0]


@pytest.mark.parametrize("by,md", [("phash", 0.2), ("semantic", 0.02)])
def test_engine_duplicates_on_mesh(small_lib, by, md):
    jeng, teng, single, _ = small_lib
    pairs = [e.find_duplicate_pairs(max_distance=md, by=by) for e in (jeng, teng, single)]
    assert len(pairs[0]) >= 1024 // 997
    assert pairs[1] == pairs[0] and pairs[2] == pairs[0]


def test_engine_int4_rerank_on_mesh(tmp_path_factory):
    jeng, teng, single, _ = _library(tmp_path_factory, "mesh_int4", "int4", n=1024)
    try:
        assert teng._sem_store.kind == "semantic4"
        for rerank in (True, False):
            for mode in ("auto", "exact"):
                got = []
                for e in (jeng, teng, single):
                    e.int4_rerank, e.scan_mode = rerank, mode
                    e.query_by_image_hash_from_id(998)
                    got.append(_results(e))
                assert got[1] == got[0] and got[2] == got[0], (rerank, mode)
                if rerank:
                    assert got[0][:2] == [(998, 0.0), (999, 0.0)]
        for e in (jeng, teng, single):
            e.int4_rerank, e.scan_mode = True, "auto"
        pairs = [e.find_duplicate_pairs(max_distance=0.02, by="semantic") for e in (jeng, teng, single)]
        assert pairs[0] and pairs[1] == pairs[0] and pairs[2] == pairs[0]
    finally:
        for e in (jeng, teng, single):
            e.close()


def test_engine_mixed_width_phash_on_mesh(tmp_path_factory):
    jeng, teng, single, _ = _library(tmp_path_factory, "mesh_mixed", "int8",
                                     phash_widths=(32, 24, 18), n=1024)
    try:
        assert len(set(teng._ph_widths)) == 3
        for image_id in (1, 998):
            ph = np.frombuffer(teng.catalog.get_hash("phashes", image_id), dtype=np.uint8)
            got = []
            for e in (jeng, teng, single):
                e.query_by_phash(ph)
                got.append(_results(e))
            assert got[0][0][1] == 0.0
            assert got[1] == got[0] and got[2] == got[0]
        assert teng._ph_mirror.index is not None
        pairs = [e.find_duplicate_pairs(max_distance=0.2, by="phash") for e in (jeng, teng, single)]
        assert pairs[0] and pairs[1] == pairs[0] and pairs[2] == pairs[0]
    finally:
        for e in (jeng, teng, single):
            e.close()


def test_engine_lazy_reshard_after_insert_and_removal(tmp_path):
    """Appends sync as deltas, a removal reshards once, and a row removed
    before a later delta is not brought back by it — for the semantic
    and the phash mirrors."""
    from pixelbox_tpu_torch.engine import Engine
    from pixelbox_tpu_torch.records import IndexedImage

    rng = np.random.default_rng(7)
    rows = clustered(rng, 3000, D)
    ph = rng.integers(0, 256, (3000, 32), dtype=np.uint8)
    eng = Engine.new(str(tmp_path / "lazy.db"), embedder="none", device="cpu")
    eng.max_distance_from_query = 1e7
    eng.insert_records_batch(_records(IndexedImage, rows[:2000], ph[:2000], "a"))
    eng.serve_on_mesh(make_mesh(8, device="cpu"))
    try:
        eng.query_by_image_hash_from_id(5)
        eng.query_by_phash(ph[4])
        assert (eng._sharded_full_reshards, eng._ph_mirror.full_reshards) == (1, 1)

        def insert(j):
            return eng.insert_records_batch(_records(IndexedImage, rows[j : j + 1], ph[j : j + 1], f"b{j}"))[0]

        new_id = insert(2000)
        eng.query_by_image_hash_from_id(new_id)
        assert _results(eng)[0] == (new_id, 0.0)
        eng.query_by_phash(ph[2000])
        assert _results(eng)[0] == (new_id, 0.0)
        assert (eng._sharded_full_reshards, eng._ph_mirror.full_reshards) == (1, 1)

        assert eng.remove_image(new_id)
        eng.query_by_image_hash_from_id(5)
        eng.query_by_phash(ph[2000])
        assert all(i != new_id for i, _ in _results(eng))
        assert (eng._sharded_full_reshards, eng._ph_mirror.full_reshards) == (2, 2)

        later = insert(2001)
        eng.query_by_phash(ph[2000])
        assert all(i != new_id for i, _ in _results(eng))
        eng.query_by_image_hash_from_id(later)
        assert _results(eng)[0] == (later, 0.0)
        assert all(i != new_id for i, _ in _results(eng))
        assert (eng._sharded_full_reshards, eng._ph_mirror.full_reshards) == (2, 2)

        eng.compact()
        eng.query_by_image_hash_from_id(later)
        assert _results(eng)[0] == (later, 0.0)
        assert eng._sharded_full_reshards == 3
    finally:
        eng.close()
