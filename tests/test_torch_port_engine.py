"""pixelbox_tpu_torch Engine / ingest / CLI vs pixelbox_tpu on the CPU.

One seeded folder is indexed by each package with EfficientNet-B0 (input
64, dim 32) from the same ``.npz`` checkpoint: the stored semantic hashes
per path are equal and ``similar`` gives the same paths and distances.
A library written by the JAX package opens in the port with identical
``similar`` and ``search`` results.
"""

import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from fixtures import textured_image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """Seeded photos + one B0 checkpoint in the JAX package's format."""
    from pixelbox_tpu_torch.models.efficientnet import save_params, seeded_state_dict

    root = tmp_path_factory.mktemp("port_engine")
    photos = root / "photos"
    (photos / "sub").mkdir(parents=True)
    for i in range(6):
        img = textured_image(seed=100 + i, size=(96, 80 + 8 * i))
        Image.fromarray(img).save(photos / f"cat_{i}.png")
    Image.fromarray(textured_image(seed=100, size=(96, 80))).save(photos / "sub" / "cat_copy.png")
    Image.fromarray(textured_image(seed=200, size=(72, 72))).save(photos / "dog.jpg", quality=95)
    ckpt = root / "b0.npz"
    save_params(seeded_state_dict(32, seed=7, input_size=64), str(ckpt))
    return {"root": root, "photos": str(photos), "ckpt": str(ckpt)}


def _index(engine_cls, db, shared, **kw):
    eng = engine_cls.new(
        db, embedder="efficientnet", dim=32,
        embedder_kwargs={"checkpoint_path": shared["ckpt"], "input_size": 64}, **kw,
    )
    eng.add_tracked_folder(shared["photos"])
    eng.start_indexing(num_workers=2)
    assert eng.wait_for_indexing(timeout=300)
    return eng


def _hashes(eng):
    return {
        eng.catalog.get_image(i)["path"]: bytes(h)
        for i, h in eng.catalog.iter_hashes("semantic_hashes")
    }


def _similar(eng, path):
    eng.query_by_image_hash_from_file(path)
    return [(r.path, r.distance_from_query) for r in eng.get_query_results()]


def _search(eng, q):
    eng.query(q)
    return [(r.path, r.distance_from_query) for r in eng.get_query_results()]


@pytest.fixture(scope="module")
def jax_library(shared):
    from pixelbox_tpu.engine import Engine as JEngine

    db = str(shared["root"] / "jax_lib.db")
    eng = _index(JEngine, db, shared)
    probe = os.path.join(shared["photos"], "cat_2.png")
    out = {
        "db": db,
        "hashes": _hashes(eng),
        "similar": _similar(eng, probe),
        "search": _search(eng, "cat"),
        "search_similar": _search(eng, f"cat similar:{probe}"),
    }
    eng.close()
    return out


def test_ingest_hashes_and_similar_match_jax(shared, jax_library):
    from pixelbox_tpu_torch.engine import Engine

    eng = _index(Engine, str(shared["root"] / "torch_lib.db"), shared, device="cpu")
    try:
        assert eng.get_num_indexed_images() == 8
        assert _hashes(eng) == jax_library["hashes"]
        probe = os.path.join(shared["photos"], "cat_2.png")
        got = _similar(eng, probe)
        assert got == jax_library["similar"]
        assert got[0] == (os.path.realpath(probe), 0.0)
    finally:
        eng.close()


def test_jax_library_opens_in_port(shared, jax_library):
    from pixelbox_tpu_torch.engine import Engine

    eng = Engine.open(jax_library["db"], device="cpu")
    try:
        assert eng._embedder_name == "efficientnet"
        probe = os.path.join(shared["photos"], "cat_2.png")
        assert _similar(eng, probe) == jax_library["similar"]
        assert _search(eng, "cat") == jax_library["search"]
        assert _search(eng, f"cat similar:{probe}") == jax_library["search_similar"]
        for mode in ("exact", "pallas", "fast"):
            eng.scan_mode = mode
            assert _similar(eng, probe) == jax_library["similar"], mode
    finally:
        eng.close()


def test_self_match_is_exactly_zero_and_copy_ties(shared, tmp_path):
    from pixelbox_tpu_torch.engine import Engine

    eng = _index(Engine, str(tmp_path / "lib.db"), shared, device="cpu")
    try:
        probe = os.path.realpath(os.path.join(shared["photos"], "cat_0.png"))
        copy = os.path.realpath(os.path.join(shared["photos"], "sub", "cat_copy.png"))
        res = _similar(eng, probe)
        assert res[0] == (probe, 0.0) and res[1] == (copy, 0.0)
        eng.max_distance_from_query = 1e-9
        assert [p for p, _ in _similar(eng, probe)] == [probe, copy]
    finally:
        eng.close()


def test_store_appends_in_place_deletes_and_compacts():
    from pixelbox_tpu_torch.index.store import VectorStore

    rng = np.random.default_rng(0)
    rows = rng.integers(0, 256, (1500, 16), dtype=np.uint8)
    s = VectorStore(dim=16, block_rows=1024, device="cpu")
    s.append(rows[:1000])
    data_before = s.device_index.data
    s.append(rows[1000:1020])
    assert s.device_index.data is data_before  # within capacity: in place
    assert s.device_index.capacity == 1024
    s.append(rows[1020:])                      # grows (doubling, block aligned)
    assert s.device_index.capacity == 2048 and s.n == 1500
    s.delete([3, 4])
    assert s.size == 1498 and not bool(s.device_index.valid[3])
    mapping = s.compact()
    assert mapping[3] == -1 and mapping[5] == 3 and s.n == 1498
    np.testing.assert_array_equal(s.get_rows([3]), rows[[5]])


def test_normalize_frames_matches_jax_for_every_byte():
    from pixelbox_tpu.ingest.pipeline import _normalize_frames as jnorm
    from pixelbox_tpu_torch.ingest.pipeline import _normalize_frames as tnorm

    x = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1)
    got = tnorm(torch.from_numpy(x)).numpy()
    want = np.asarray(jnorm(jnp.asarray(x)))
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert np.array_equal(got, x.astype(np.float32) * np.float32(1 / 255))


def test_cli_recipe_on_cpu(shared, tmp_path):
    db = str(tmp_path / "cli.db")
    photos = shared["photos"]

    def cli(*args):
        return subprocess.run(
            [sys.executable, "-m", "pixelbox_tpu_torch.cli", *args, "--device", "cpu"],
            capture_output=True, text=True, cwd=REPO, timeout=300,
        )

    assert cli("init", db, "--dim", "32").returncode == 0
    assert cli("add-folder", db, photos).returncode == 0
    r = cli("index", db)
    assert r.returncode == 0 and "Indexed images: 8" in r.stdout
    r = cli("similar", db, os.path.join(photos, "cat_1.png"), "--json")
    assert r.returncode == 0
    import json

    res = json.loads(r.stdout)
    assert res[0]["path"] == os.path.realpath(os.path.join(photos, "cat_1.png"))
    assert res[0]["distance"] == 0.0
    r = cli("search", db, "cat_3")
    assert r.returncode == 0 and "cat_3.png" in r.stdout
    r = cli("similar", db, os.path.join(photos, "dog.jpg"), "--scan-mode", "ivf")
    assert r.returncode == 1 and "not yet ported" in r.stderr
    r = cli("show", db, "1")
    assert r.returncode == 0 and '"filename"' in r.stdout
    r = cli("stats", db)
    assert r.returncode == 0 and '"images": 8' in r.stdout


def test_port_never_imports_jax():
    code = (
        "import pkgutil, importlib, sys\n"
        "import pixelbox_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(pixelbox_tpu_torch.__path__, "
        "'pixelbox_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert len(mods) > 30, mods\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'flax', 'pixelbox_tpu.'))"
        " or m == 'pixelbox_tpu']\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr
