"""pixelbox_tpu_torch phash search and duplicates vs pixelbox_tpu on the CPU.

The same numpy-seeded hashes go through the JAX package (its XLA scans,
and its Pallas Hamming kernels in interpret mode as
tests/test_hamming_threshold.py runs them) and through the port, whose
kernel wrappers take their plain PyTorch versions for CPU tensors.
Final (dist, idx) outputs are compared bit for bit, ties by ascending
row id included; every query the port flags exact must equal the exact
scan (the flags need not equal the TPU kernels').  Libraries indexed by
the JAX engine open in the port with the same phash search, duplicate
pairs and groups, and byte-identical CLI output.  The last tests hold the
port's sources to standing alone: no jax, nothing of the JAX package.
"""

import io
import os
import re
import tokenize
from contextlib import redirect_stdout

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from PIL import Image

from fixtures import textured_image
from pixelbox_tpu.ops import oracle
from pixelbox_tpu.ops import pallas_scan as jps
from pixelbox_tpu.ops import scan as jscan
from pixelbox_tpu.ops.hamming_gemm import (
    build_hamming_gemm_index,
    build_hamming_scan_sample as jax_hamming_sample,
    hamming_gemm_scan_topk as jax_hamming_gemm_exact,
)
from pixelbox_tpu.ops.packed import PackedHammingIndex as JHIndex
from pixelbox_tpu.ops.packed import PackedSemanticIndex as JSIndex
from pixelbox_tpu_torch.ops import fused_scan as fs
from pixelbox_tpu_torch.ops import hamming_gemm as thg
from pixelbox_tpu_torch.ops import scan as tscan
from pixelbox_tpu_torch.ops.packed import PackedHammingIndex as THIndex
from pixelbox_tpu_torch.ops.packed import PackedSemanticIndex as TSIndex
from pixelbox_tpu_torch.ops.packed import semantic_rows_from_u8

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def phash_rows(rng, n, h, centers=64):
    """Clustered phash-like rows: bit flips off a few bases."""
    base = rng.integers(0, 256, (centers, h), dtype=np.uint8)
    flips = (
        rng.integers(0, 256, (n, h), dtype=np.uint8)
        & rng.integers(0, 256, (n, h), dtype=np.uint8)
        & rng.integers(0, 256, (n, h), dtype=np.uint8)
    )
    return base[rng.integers(0, centers, n)] ^ flips


def both_hamming(db, valid):
    j = JHIndex(jnp.asarray(db), jnp.asarray(valid))
    t = THIndex(torch.from_numpy(np.ascontiguousarray(db)), torch.from_numpy(valid.copy()))
    return j, t


def assert_same(got, want):
    gd, gi = (np.asarray(x) for x in got)
    wd, wi = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(gi, wi)
    assert np.array_equal(gd.view(np.uint32), wd.astype(np.float32).view(np.uint32))


# --------------------------------------------------------------------- #
# Scans: exact, threshold + repair, mixed widths, wrap, masks, ties


EXACT_CASES = [
    "exact", "byte_limit_18", "byte_limit_24", "wrap_u8", "group_mask",
    "tombstones_1pct", "tie_flood", "max_distance_0.1",
]


@pytest.mark.parametrize("case", EXACT_CASES)
def test_hamming_scans_vs_jax(rng, case):
    # The tie flood outgrows the collect buffer (4,096), so even the
    # widened θ cannot prove it and the repair must run.
    n, h, k = (8192 if case == "tie_flood" else 4096), 32, 30
    db = phash_rows(rng, n, h)
    valid = np.ones(n, bool)
    q = db[rng.integers(0, n, 6)].copy()
    q[1] = db[77]
    limit, wrap, md = None, False, 1e3
    if case.startswith("byte_limit"):
        limit = int(case.rsplit("_", 1)[1])
    elif case == "wrap_u8":
        wrap = True
        q[2] = ~db[5]          # 256 differing bits: wraps to 0
        q[3] = ~db[9] ^ 1      # 255 bits: stays 255
    elif case == "group_mask":
        valid &= np.arange(n) % 3 != 1
    elif case == "tombstones_1pct":
        valid[rng.choice(n, n // 100, replace=False)] = False
        valid[77] = False      # the exact copy's row is a tombstone
    elif case == "tie_flood":
        db[1000:5300] = db[77]
    elif case == "max_distance_0.1":
        md = 0.1
    ji, ti = both_hamming(db, valid)
    want = jscan.hamming_scan_topk(
        jnp.asarray(q), ji, k=k, max_distance=md, block_rows=1024, wrap_u8=wrap,
        byte_limit=limit,
    )
    qt = torch.from_numpy(q)
    got = tscan.hamming_scan_topk(
        qt, ti, k=k, max_distance=md, block_rows=1024, wrap_u8=wrap, byte_limit=limit
    )
    assert_same(got, want)
    eff = h if limit is None else limit
    keep = np.nonzero(valid)[0]
    od, oi = oracle.hamming_scan_topk_np(
        q[:, :eff], db[keep][:, :eff], k=k, max_distance=md, wrap_u8=wrap
    )
    assert_same(got, (od, np.where(oi >= 0, keep[np.maximum(oi, 0)], -1)))

    meta = fs.build_hamming_meta(ti)
    assert_same(
        thg.hamming_gemm_scan_topk(qt, ti, k=k, max_distance=md, wrap_u8=wrap,
                                   meta=meta, byte_limit=limit),
        want,
    )
    smp = thg.build_hamming_scan_sample(ti, meta, sample_rows=1024)
    td, tid, tex = fs.fused_hamming_threshold_scan_topk(
        qt, ti, meta, smp, k=k, max_distance=md, wrap_u8=wrap, byte_limit=limit
    )
    ok = tex.numpy()
    assert_same((td.numpy()[ok], tid.numpy()[ok]), (np.asarray(want[0])[ok], np.asarray(want[1])[ok]))
    auto = thg.hamming_gemm_scan_topk_auto(
        qt, ti, k=k, max_distance=md, block_rows=512, wrap_u8=wrap, sample=smp,
        meta=meta, byte_limit=limit,
    )
    assert_same(auto, want)
    if case == "tie_flood":
        assert not ok[1], "the tie flood must defeat the proof"
        assert auto[1][1].tolist() == [77] + list(range(1000, 1000 + k - 1))
    if case == "wrap_u8":
        assert auto[0][2, 0].item() == 0.0 and auto[1][2, 0].item() == 5


@pytest.mark.parametrize("case", ["v2_plain", "v2_tie_flood", "buffer_max_distance"])
def test_threshold_and_repair_vs_pallas_interpret(case):
    """Port auto (plain K2a/K1c, repair plain K2b/K1c) vs the JAX Pallas
    Hamming kernels in interpret mode + the JAX exact repair, at the
    sizes tests/test_hamming_threshold.py uses (4096 rows × 16 B, tile
    256)."""
    rng = np.random.default_rng(13)
    n, h, k = 4096, 16, 20
    db = phash_rows(rng, n, h)
    md = 0.1 if case == "buffer_max_distance" else 1e3
    q = np.concatenate([db[rng.integers(0, n, 4)], rng.integers(0, 256, (2, h), dtype=np.uint8)])
    if case == "v2_tie_flood":
        db[2000:2300] = db[11]
        q[0] = db[11]
    valid = np.ones(n, bool)
    ji, ti = both_hamming(db, valid)
    gi = build_hamming_gemm_index(ji)
    jsmp = jax_hamming_sample(gi, sample_rows=1024)
    jmeta = jps.build_hamming_meta(gi)
    kernel = (jps.pallas_hamming_threshold_scan_topk if case.startswith("buffer")
              else jps.pallas_hamming_threshold_scan_topk_v2)
    with pltpu.force_tpu_interpret_mode():
        jd, jid, jex = kernel(
            jnp.asarray(q), gi, jmeta, jsmp.data, jsmp.valid, k=k, max_distance=md,
            tile_rows=256,
        )
    rd, ri = jax_hamming_gemm_exact(jnp.asarray(q), gi, k=k, max_distance=md, block_rows=256)
    jd, jid = np.asarray(jd).copy(), np.asarray(jid).copy()
    bad = ~np.asarray(jex)
    jd[bad], jid[bad] = np.asarray(rd)[bad], np.asarray(ri)[bad]

    qt = torch.from_numpy(q)
    meta = fs.build_hamming_meta(ti)
    smp = thg.build_hamming_scan_sample(ti, meta, sample_rows=1024)
    td, tid, tex = fs.fused_hamming_threshold_scan_topk(qt, ti, meta, smp, k=k, max_distance=md)
    ok = tex.numpy()
    assert_same((td.numpy()[ok], tid.numpy()[ok]), (np.asarray(rd)[ok], np.asarray(ri)[ok]))
    got = thg.hamming_gemm_scan_topk_auto(qt, ti, k=k, max_distance=md, block_rows=256, sample=smp, meta=meta)
    assert_same(got, (jd, jid))
    assert_same(got, oracle.hamming_scan_topk_np(q, db, k=k, max_distance=md))
    if case == "v2_tie_flood":
        # The widened θ collects the whole 301-row plateau: proven.
        assert ok[0]
        assert got[1][0].tolist() == [11] + list(range(2000, 2000 + k - 1))


def test_plateau_widening_raises_the_proof_rate(rng):
    """θ bumped to the next distance value proves queries whose sample
    θ sits on a tie plateau (sound either way)."""
    n, h, k = 8192, 32, 20
    db = phash_rows(rng, n, h, centers=8)
    _, ti = both_hamming(db, np.ones(n, bool))
    q = torch.from_numpy(db[rng.integers(0, n, 16)])
    meta = fs.build_hamming_meta(ti)
    smp = thg.build_hamming_scan_sample(ti, meta, sample_rows=2048)
    qk = fs.HammingQueries(q, h, False)
    theta = fs.sample_theta(qk, smp, 1e3, 5)
    wide = qk.widen(theta)
    bits = torch.round(theta.double() * 8 * h)
    assert torch.equal(wide, ((bits + 1).float() * np.float32(1 / (8 * h))))
    d, i, ex = fs.fused_hamming_threshold_scan_topk(q, ti, meta, smp, k=k)
    ed, ei = tscan.hamming_scan_topk(q, ti, k=k, block_rows=1024)
    assert bool(ex.all())
    assert_same((d, i), (ed, ei))


def test_cosine_row4_q1056_vs_pallas_buffer_interpret(rng):
    """Row 4: the port's cosine auto at Q = 1,056 (K1a's exact-count buffer
    at every batch size) vs JAX's buffer-select ``pallas_threshold_scan_topk``
    in interpret mode, repaired by the JAX exact scan."""
    n, k = 2048, 10
    c = rng.standard_normal((64, 128)).astype(np.float32)
    x = c[rng.integers(0, 64, n)] + 0.35 * rng.standard_normal((n, 128)).astype(np.float32)
    db = oracle.quantize_embedding_np(np.tanh(x))
    data, rs, rm = semantic_rows_from_u8(db)
    valid = np.ones(n, bool)
    ji = JSIndex(jnp.asarray(data), jnp.asarray(rs), jnp.asarray(rm), jnp.asarray(valid))
    ti = TSIndex(*(torch.from_numpy(np.ascontiguousarray(v)) for v in (data, rs, rm, valid)))
    q = db[rng.integers(0, n, 1056)]
    jsmp = jscan.build_scan_sample(ji, sample_rows=1024)
    with pltpu.force_tpu_interpret_mode():
        # A small target keeps every tile within the kernel's round bound,
        # so its buffer proves most queries.
        jd, jid, jex = jps.pallas_threshold_scan_topk(
            jnp.asarray(q), ji, jps.build_row_meta(ji), jsmp, k=k, cap=1024,
            tile_rows=2048, target_count=32,
        )
    assert np.asarray(jex).mean() > 0.5
    rd, ri = jscan.cosine_scan_topk(jnp.asarray(q), ji, k=k, block_rows=1024)
    jd, jid = np.asarray(jd).copy(), np.asarray(jid).copy()
    bad = ~np.asarray(jex)
    jd[bad], jid[bad] = np.asarray(rd)[bad], np.asarray(ri)[bad]
    got = tscan.cosine_scan_topk_auto(
        torch.from_numpy(q), ti, k=k, block_rows=256,
        sample=tscan.build_scan_sample(ti, sample_rows=1024),
    )
    assert_same(got, (jd, jid))
    assert_same(got, (rd, ri))


# --------------------------------------------------------------------- #
# Store


def test_hamming_store_matches_jax(rng):
    from pixelbox_tpu.index.store import VectorStore as JStore
    from pixelbox_tpu_torch.index.store import VectorStore as TStore

    js = JStore(dim=16, kind="hamming", block_rows=1024)
    ts = TStore(dim=16, kind="hamming", block_rows=1024, device="cpu")
    rows = rng.integers(0, 256, (1500, 18), dtype=np.uint8)
    steps = [
        ("append", rows[:1000, :16]), ("append", rows[1000:1020, :16]),
        ("grow_dim", 18), ("append", rows[1020:, :18]), ("delete", [3, 4, 1100]),
        ("delete", [4]), ("compact", None), ("grow_dim", 17), ("append", rows[:5, :18]),
    ]
    for op, arg in steps:
        outs = [getattr(s, op)(*(() if arg is None else (arg,))) for s in (js, ts)]
        if op in ("append", "compact"):
            np.testing.assert_array_equal(outs[1], outs[0])
        assert (ts.n, ts.n_deleted, ts.dim, ts.size) == (js.n, js.n_deleted, js.dim, js.size), op
        assert (ts.version, ts.structural_version) == (js.version, js.structural_version), op
        np.testing.assert_array_equal(ts._host_rows[: ts.n], js._host_rows[: js.n])
        np.testing.assert_array_equal(ts._host_valid[: ts.n], js._host_valid[: js.n])
        ti, ji = ts.device_index, js.device_index
        np.testing.assert_array_equal(ti.data.numpy(), np.asarray(ji.data))
        np.testing.assert_array_equal(ti.valid.numpy(), np.asarray(ji.valid))


def test_hamming_store_appends_in_place():
    from pixelbox_tpu_torch.index.store import VectorStore

    s = VectorStore(dim=32, kind="hamming", block_rows=1024, device="cpu")
    s.append(np.zeros((10, 32), np.uint8))
    data, sv = s.device_index.data, s.structural_version
    s.append(np.full((5, 32), 7, np.uint8))
    assert s.device_index.data is data and s.structural_version == sv
    assert int(s.device_index.data[12, 0]) == 7 and bool(s.device_index.valid[14])
    s.grow_dim(40)
    assert s.device_index.dim == 40 and s.structural_version == sv + 1


# --------------------------------------------------------------------- #
# Engine and CLI on libraries the JAX engine indexed


def _write_photos(folder, mixed):
    os.makedirs(folder, exist_ok=True)
    sizes = [(96, 96)] * 6 if not mixed else [(96, 96), (64, 112), (112, 64), (72, 128), (96, 96), (128, 72)]
    for i, size in enumerate(sizes):
        Image.fromarray(textured_image(seed=300 + i, size=size)).save(os.path.join(folder, f"p{i}.png"))
    # An exact copy and a JPEG re-encode of p0, and a copy of p2.
    Image.fromarray(textured_image(seed=300, size=sizes[0])).save(os.path.join(folder, "p0_copy.png"))
    Image.fromarray(textured_image(seed=300, size=sizes[0])).save(os.path.join(folder, "p0.jpg"), quality=70)
    Image.fromarray(textured_image(seed=302, size=sizes[2])).save(os.path.join(folder, "p2_copy.png"))


@pytest.fixture(scope="module", params=[False, True], ids=["uniform", "compat_mixed"])
def jax_phash_library(request, tmp_path_factory):
    from pixelbox_tpu.engine import Engine as JEngine

    compat = request.param
    root = tmp_path_factory.mktemp("phash_" + ("compat" if compat else "uniform"))
    photos = str(root / "photos")
    _write_photos(photos, mixed=compat)
    db = str(root / "lib.db")
    eng = JEngine.new(db, embedder="stub", dim=16, phash_compat=compat)
    eng.add_tracked_folder(photos)
    eng.start_indexing(num_workers=2)
    assert eng.wait_for_indexing(timeout=300)
    widths = sorted(set(eng._ph_widths))
    out = {"db": db, "photos": photos, "compat": compat, "widths": widths, "queries": {}}
    for name in ("p0.png", "p2.png", "p3.png"):
        path = os.path.join(photos, name)
        from pixelbox_tpu.ingest.decode import decode_image_file
        from pixelbox_tpu.ops.phash import phash

        ph = phash(decode_image_file(path).rgb, aspect_preserving=compat)
        eng.query_by_phash(ph)
        out["queries"][name] = (ph, [(r.id, r.distance_from_query) for r in eng.get_query_results()])
    out["pairs"] = {
        by: eng.find_duplicate_pairs(max_distance=md, by=by)
        for by, md in (("phash", 0.2), ("semantic", 0.05))
    }
    out["groups"] = eng.find_duplicate_groups(max_distance=0.2, by="phash")
    eng.close()
    return out


def test_engine_phash_and_duplicates_match_jax(jax_phash_library):
    from pixelbox_tpu_torch.engine import Engine

    lib = jax_phash_library
    if lib["compat"]:
        assert len(lib["widths"]) > 1, "the compat library must hold mixed widths"
    eng = Engine.open(lib["db"], device="cpu")
    try:
        assert sorted(set(eng._ph_widths)) == lib["widths"]
        for name, (ph, want) in lib["queries"].items():
            eng.query_by_phash(ph)
            got = [(r.id, r.distance_from_query) for r in eng.get_query_results()]
            assert got == want, name
            assert got[0][1] == 0.0
        for by in ("phash", "semantic"):
            md = 0.2 if by == "phash" else 0.05
            assert eng.find_duplicate_pairs(max_distance=md, by=by) == lib["pairs"][by], by
        assert lib["pairs"]["phash"], "expected near-duplicate pairs"
        assert eng.find_duplicate_groups(max_distance=0.2, by="phash") == lib["groups"]
    finally:
        eng.close()


def test_port_ingest_without_compat_hashes_the_full_image(tmp_path):
    """With ``phash_compat=False`` the port stores ``phash(rgb,
    aspect_preserving=False)`` of the full decoded image — the JAX turbo
    ingest hashes the 224² embed frame instead, which its own
    ``phash_batch_tpu`` docstring says it must not — and every image's
    stored phash finds the image itself at 0.0."""
    from pixelbox_tpu_torch.engine import Engine
    from pixelbox_tpu_torch.ingest.decode import decode_image_file
    from pixelbox_tpu_torch.ops.phash import phash

    photos = str(tmp_path / "photos")
    _write_photos(photos, mixed=True)  # square and non-square images
    eng = Engine.new(str(tmp_path / "lib.db"), embedder="stub", dim=16, phash_compat=False,
                     device="cpu")
    try:
        eng.add_tracked_folder(photos)
        eng.start_indexing(num_workers=1)
        assert eng.wait_for_indexing(timeout=300)
        stored = dict(eng.catalog.iter_hashes("phashes"))
        assert len(stored) == 9
        for image_id, h in stored.items():
            rgb = decode_image_file(eng.catalog.get_image(image_id)["path"]).rgb
            assert bytes(h) == np.asarray(phash(rgb, aspect_preserving=False), np.uint8).tobytes()
            eng.query_by_phash(np.frombuffer(h, np.uint8).copy())
            hits = [(r.id, r.distance_from_query) for r in eng.get_query_results()]
            assert hits[0][1] == 0.0 and (image_id, 0.0) in hits
    finally:
        eng.close()


def _cli_out(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


@pytest.mark.parametrize(
    "argv",
    [
        ["phash-similar", "{db}", "{photos}/p0.png"],
        ["phash-similar", "{db}", "{photos}/p3.png", "--json", "--limit", "4"],
        ["duplicates", "{db}", "--max-distance", "0.2"],
        ["duplicates", "{db}", "--max-distance", "0.2", "--json"],
        ["duplicates", "{db}", "--max-distance", "0.2", "--groups"],
        ["duplicates", "{db}", "--by", "semantic", "--groups", "--json"],
    ],
    ids=["phash_text", "phash_json", "pairs_text", "pairs_json", "groups_text", "semantic_groups_json"],
)
def test_cli_output_is_byte_identical(jax_phash_library, argv):
    from pixelbox_tpu.cli import main as jax_main
    from pixelbox_tpu_torch.cli import main as torch_main

    lib = jax_phash_library
    argv = [a.format(db=lib["db"], photos=lib["photos"]) for a in argv]
    want = _cli_out(jax_main, argv)
    got = _cli_out(torch_main, argv + ["--device", "cpu"])
    assert want[0] == 0 and got == want
    assert want[1].strip()


# --------------------------------------------------------------------- #
# The port stands alone: no jax, nothing of the JAX package


def _code_lines(text: str) -> str:
    """Python source without comments and docstrings."""
    out, prev = [], tokenize.NEWLINE
    for tok in tokenize.generate_tokens(io.StringIO(text).readline):
        if tok.type == tokenize.COMMENT:
            continue
        if tok.type == tokenize.STRING and prev in (tokenize.NEWLINE, tokenize.INDENT,
                                                    tokenize.DEDENT, tokenize.NL):
            prev = tok.type
            continue  # a docstring (an expression statement of one string)
        if tok.type not in (tokenize.NL,):
            prev = tok.type
        out.append(tok)
    return tokenize.untokenize(out)


_IMPORT_JAX = re.compile(r"^\s*(import\s+(jax|flax)\b|from\s+(jax|flax)\b)", re.M)
_IMPORT_JAX_PKG = re.compile(r"^\s*(import|from)\s+pixelbox_tpu\b", re.M)
_STRING = re.compile(r"""(?:[rRbBuUfF]{0,2})("[^"\n]*"|'[^'\n]*')""")


def _faults(path: str, text: str) -> list:
    """What ties a port source to the JAX package: a jax/flax import, an
    import of pixelbox_tpu, or a path built from "pixelbox_tpu" (a string
    that names the package or a file in it — a ``file:line`` label of the
    kernel a port replaces is not a path)."""
    if path.endswith(".py"):
        code = _code_lines(text)
    else:  # C/C++: drop // and /* */ comments
        code = re.sub(r"/\*.*?\*/|//[^\n]*", "", text, flags=re.S)
    faults = [m.group(0).strip() for m in _IMPORT_JAX.finditer(code)]
    faults += [m.group(0).strip() for m in _IMPORT_JAX_PKG.finditer(code)]
    for m in _STRING.finditer(code):
        s = m.group(1)[1:-1]
        if s == "pixelbox_tpu" or s.startswith("pixelbox_tpu.") or (
            s.startswith("pixelbox_tpu/") and not re.search(r":\d+(-\d+)?$", s)
        ):
            faults.append(m.group(0))
    return faults


@pytest.mark.parametrize(
    "snippet,bad",
    [
        ("import jax\n", True),
        ("from jax import numpy as jnp\n", True),
        ("import pixelbox_tpu.ops.scan\n", True),
        ("from pixelbox_tpu.native import load_native\n", True),
        ("p = root / 'pixelbox_tpu' / 'native'\n", True),
        ("open('pixelbox_tpu/native/qoi.cpp')\n", True),
        ("importlib.import_module('pixelbox_tpu.ops')\n", True),
        ("from pixelbox_tpu_torch.ops import scan\n", False),
        ("'''Replaces pixelbox_tpu/ops/scan.py; import jax there.'''\nx = 1\n", False),
        ("x = 1  # import jax\n", False),
        ("REPLACES = 'pixelbox_tpu/ops/pallas_scan.py:192'\n", False),
    ],
)
def test_stand_alone_check_flags_what_it_should(snippet, bad):
    assert bool(_faults("x.py", snippet)) == bad


def _port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for d, dirs, names in os.walk(os.path.join(REPO, "pixelbox_tpu_torch")):
        dirs[:] = [x for x in dirs if x not in ("_build", "__pycache__")]
        files += [os.path.join(d, n) for n in names if n.endswith((".py", ".cu", ".cuh", ".cpp", ".h"))]
    return files


def test_stand_alone_check_covers_the_mesh_the_tools_and_the_kernels():
    rel = {os.path.relpath(f, os.path.join(REPO, "pixelbox_tpu_torch")) for f in _port_sources()}
    for want in (
        "parallel/__init__.py", "parallel/mesh.py", "parallel/sharded_scan.py",
        "parallel/data_parallel.py", "tools/measure_breakdown.py",
        "csrc/fused_scan.cu", "csrc/breakdown.cu", "csrc/scan_device.cuh",
        "csrc/tc_scan.cu", "csrc/wgmma_s8.cuh",
    ):
        assert want in rel, want


def test_kernel_builds_read_the_ports_own_sources():
    """Every nvcc build compiles files of the port's csrc/ into the port's
    build directory — nothing of the JAX package."""
    from pixelbox_tpu_torch.ops import fused_scan

    csrc = os.path.realpath(os.path.join(REPO, "pixelbox_tpu_torch", "csrc"))
    assert os.path.realpath(str(fused_scan._CSRC)) == csrc
    for name in (*fused_scan._SOURCES, *fused_scan._TC_SOURCES, "breakdown.cu"):
        assert os.path.isfile(os.path.join(csrc, name)), name
    for src in ("breakdown.cu", *fused_scan._TC_SOURCES):
        for inc in re.findall(r'#include "([^"]+)"', open(os.path.join(csrc, src)).read()):
            assert os.path.isfile(os.path.join(csrc, inc)), inc
    build = os.path.realpath(str(fused_scan._build_dir()))
    assert build.startswith(os.path.realpath(os.path.join(REPO, "pixelbox_tpu_torch")) + os.sep) or \
        "PIXELBOX_TPU_TORCH_BUILD_DIR" in os.environ


def test_port_modules_import_without_jax():
    """Importing the port — the mesh and the tools included — pulls in no
    jax and nothing of the JAX package."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "sys.modules['jax'] = None; sys.modules['pixelbox_tpu'] = None\n"
        "import pixelbox_tpu_torch.engine, pixelbox_tpu_torch.parallel, pixelbox_tpu_torch.serve\n"
        "import pixelbox_tpu_torch.parallel.data_parallel, pixelbox_tpu_torch.tools.measure_breakdown\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'pixelbox_tpu')\n"
        "       and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr


def test_port_sources_stand_alone():
    files = _port_sources()
    assert len(files) > 40
    faults = {}
    for f in files:
        with open(f, encoding="utf-8") as fh:
            bad = _faults(f, fh.read())
        if bad:
            faults[os.path.relpath(f, REPO)] = bad
    assert not faults, faults


def test_native_sources_are_the_ports_own():
    from pixelbox_tpu_torch import native

    here = os.path.join(REPO, "pixelbox_tpu_torch", "native")
    assert os.path.realpath(str(native._SRC_DIR)) == os.path.realpath(here)
    for name in ("qoi.cpp", "cpu_scan.cpp", "image_decode.cpp"):
        with open(os.path.join(here, name), "rb") as a, \
                open(os.path.join(REPO, "pixelbox_tpu", "native", name), "rb") as b:
            assert a.read() == b.read(), f"{name} is not an unchanged copy"
