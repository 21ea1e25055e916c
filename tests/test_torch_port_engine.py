"""pixelbox_tpu_torch Engine / ingest / CLI vs pixelbox_tpu on the CPU.

One seeded folder is indexed by each package with EfficientNet-B0 (input
64, dim 32) from the same ``.npz`` checkpoint: the stored semantic hashes
per path are equal — but for a byte whose f32 latent lies within 2e-5 of
a quantization edge in both packages, the model contract of ROADMAP.md —
and ``similar`` gives the same paths and distances.  A library written by
the JAX package opens in the port with identical ``similar`` and
``search`` results.

B0's f32 latents on the CPU move by a few ulps with the thread count
(PyTorch: 2, 3, 8 and 16 threads against 1, 4 and 6; XLA: the size of
its CPU thread pool, set by the cores the process sees) and with the
batch size.  So the port ingests with one thread;
the JAX package's pool is fixed when the backend starts, which is why a
flipped byte is held to the contract instead of to equality.
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
    # One decode worker: rows are appended in crawl order, so row ids — the
    # tie-break of equal distances — agree between the two libraries.
    eng.start_indexing(num_workers=1)
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


#: The model contract (ROADMAP.md): a u8 byte may differ between the
#: packages only where its f32 latent lies within this of a quantization
#: edge (the reference truncates f·128, so the edges are k/128).
EDGE = 2e-5


def _latents(paths, shared, package):
    """Each image's B0 latent through ``package``'s own decode, resize and
    forward, at the ingest batch shape (zero-padded 64, the image first),
    as the engines' query replay computes it."""
    if package == "jax":
        from pixelbox_tpu.ingest.decode import decode_image_file
        from pixelbox_tpu.ingest.pipeline import DEFAULT_BATCH_SIZE, _normalize_frames
        from pixelbox_tpu.models import get_embedder
        from pixelbox_tpu.ops.preprocess import fill_resize_u8

        emb = get_embedder("efficientnet", dim=32, input_size=64, checkpoint_path=shared["ckpt"])

        def forward(frames):
            return np.asarray(emb.embed_preprocessed(_normalize_frames(jnp.asarray(frames))))
    else:
        from pixelbox_tpu_torch.ingest.decode import decode_image_file
        from pixelbox_tpu_torch.ingest.pipeline import DEFAULT_BATCH_SIZE, _normalize_frames
        from pixelbox_tpu_torch.models import get_embedder
        from pixelbox_tpu_torch.ops.preprocess import fill_resize_u8

        emb = get_embedder("efficientnet", dim=32, input_size=64,
                           checkpoint_path=shared["ckpt"], device="cpu")

        def forward(frames):
            return emb.embed_preprocessed(_normalize_frames(torch.from_numpy(frames))).numpy()

    out = {}
    for p in paths:
        frames = np.zeros((DEFAULT_BATCH_SIZE, 64, 64, 3), np.uint8)
        frames[0] = fill_resize_u8(decode_image_file(p).rgb, 64)
        out[p] = forward(frames)[0]
    return out


def _near_edge(x):
    scaled = np.float64(x) * 128.0
    return abs(scaled - np.round(scaled)) <= EDGE * 128.0


def test_ingest_hashes_and_similar_match_jax(shared, jax_library):
    from pixelbox_tpu_torch.engine import Engine
    from pixelbox_tpu_torch.ops.oracle import cosine_distance_np

    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # B0's latents move with the thread count
    try:
        eng = _index(Engine, str(shared["root"] / "torch_lib.db"), shared, device="cpu")
        try:
            assert eng.get_num_indexed_images() == 8
            hashes, want = _hashes(eng), jax_library["hashes"]
            assert hashes.keys() == want.keys()
            flipped = {p for p in hashes if hashes[p] != want[p]}
            if flipped:
                mine, theirs = _latents(flipped, shared, "torch"), _latents(flipped, shared, "jax")
                for p in flipped:
                    a, b = np.frombuffer(hashes[p], np.uint8), np.frombuffer(want[p], np.uint8)
                    for j in np.nonzero(a != b)[0]:
                        assert abs(int(a[j]) - int(b[j])) == 1, (p, j)
                        assert _near_edge(mine[p][j]) and _near_edge(theirs[p][j]), (
                            p, j, mine[p][j], theirs[p][j])
            probe = os.path.join(shared["photos"], "cat_2.png")
            got = _similar(eng, probe)
            assert got[0] == (os.path.realpath(probe), 0.0)
            if not flipped:
                assert got == jax_library["similar"]
            else:
                # A byte within the contract moves distances; the scan must
                # still rank the port's own hashes as the numpy spec does.
                q = np.frombuffer(hashes[os.path.realpath(probe)], np.uint8)
                dist = {p: float(cosine_distance_np(q, np.frombuffer(h, np.uint8)))
                        for p, h in hashes.items()}
                assert got == sorted(((p, d) for p, d in dist.items() if d < 1e3),
                                     key=lambda t: (t[1], eng.catalog.get_image_by_path(t[0])["id"]))
        finally:
            eng.close()
    finally:
        torch.set_num_threads(threads)


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
    r = cli("similar", db, os.path.join(photos, "dog.jpg"), "--scan-mode", "ivf", "--json")
    assert r.returncode == 0
    res = json.loads(r.stdout)
    assert res[0]["path"] == os.path.realpath(os.path.join(photos, "dog.jpg"))
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
        "new = {'pixelbox_tpu_torch.ops.ivf', 'pixelbox_tpu_torch.ops.ivf_build',\n"
        "       'pixelbox_tpu_torch.serving.ivf', 'pixelbox_tpu_torch.parallel.sharded_ivf'}\n"
        "assert new <= set(mods), new - set(mods)\n"
        "import pixelbox_tpu_torch.ops.ivf as ivf\n"
        "assert callable(ivf.load_ivf_kernels) and ivf._IVF_SOURCES == ('ivf_probe.cu',)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'flax', 'pixelbox_tpu.'))"
        " or m == 'pixelbox_tpu']\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr
