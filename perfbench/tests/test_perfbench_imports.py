"""Nothing the benchmark loads is JAX or the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), the
reference loads nothing of the program, and the harness reads none of
the JAX package's benchmark files."""

import json
import os
import subprocess
import sys

from perfbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "pixelbox_tpu"}


def _top_level_after(code: str) -> set:
    env = dict(os.environ, PYTHONPATH=harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         capture_output=True, text=True, check=True, env=env, cwd=harness.ROOT,
                         timeout=600)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    code = (
        "from perfbench import harness, control, spans\n"
        "cfg = {'rows': 2048, 'semantic': {'centres': 8, 'noise': 0.35, 'planted_bytes': 3,"
        " 'planted_step': 60}, 'phash': {'centres': 256, 'noise_ands': 3, 'planted_bits': 4},"
        " 'planted_every': 100}\n"
        "spec = harness.load_spec()\n"
        "for m in spec['per_layer']: harness.metric_reader(m['name'])\n"
        "for cell in ('photos-1M.dedup-semantic', 'photos-1M.dedup-phash'):\n"
        "    mix = {'check_rows': 64}\n"
        "    r, n = harness.run_cell(cell, 7, 0.3, False, device='cpu',"
        " overrides={'config': cfg, 'mix': mix})\n"
        "    assert r['correct'], n\n"
    )
    names = _top_level_after(code)
    assert "pixelbox_tpu_torch" in names
    assert not names & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    names = _top_level_after("import perfbench.reference.scan")
    assert not names & (FORBIDDEN | {"pixelbox_tpu_torch"})


def test_forbidden_names_are_compared_whole():
    import pixelbox_tpu_torch  # noqa: F401 — its name begins with the JAX package's

    assert "pixelbox_tpu" not in harness.forbidden_modules()


def test_harness_reads_no_jax_benchmark_files():
    bench = os.path.join(harness.ROOT, "perfbench")
    for dirpath, _dirs, files in os.walk(bench):
        if os.path.basename(dirpath) == "tests":
            continue
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    text = fh.read()
                for word in ("BENCH_", "benchmarks/", "bench.py", "BASELINE"):
                    assert word not in text, (f, word)
