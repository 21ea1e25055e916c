"""One run of one cell of ``BENCHMARK.json``.

Everything is found by name: the cell in ``BENCHMARK.json``, its
configuration in the file that the configuration's entry names, its mix
in ``perfbench/traffic/<traffic>.json``, the mix's runner in
``perfbench/runners/<runner>.py`` and each per-layer metric's reader in
``perfbench/metrics/<metric>.py``.  Adding a cell, a mix or a metric adds
files and entries and edits none.

A run: make the library on the card from the seed, fill the program's
engine through its own append, warm every shape the mix uses (all of it
set-up, ``setup_s``), measure the window, close the program, then decide
``correct`` against the plain reference (``perfbench/reference``) and
print one JSON line.  With ``--trace 1`` the scan calls are wrapped and a
short stretch after the window is profiled, and the line carries the
per-layer metrics instead of the end-to-end ones.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: Top-level module names that no run may hold once its window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "pixelbox_tpu")
#: Seconds of the profiled stretch after the window of a traced run.
PROFILE_SECONDS = 2.0


@dataclass
class Context:
    cell: dict
    config: dict
    mix: dict
    seed: int
    device: str
    library: object = None
    engine: object = None


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _load_json(root: str, rel: str) -> dict:
    with open(os.path.join(root, rel)) as f:
        return json.load(f)


def resolve(spec: dict, name: str, root: str = ROOT):
    """(cell, configuration, mix) of a cell, found by name."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = _load_json(root, entry["file"])
    mix = _load_json(root, os.path.join("perfbench", "traffic", cell["traffic"] + ".json"))
    return cell, config, mix


def cell_metrics(spec: dict, cell_name: str):
    """(end-to-end, per-layer) metric entries that the cell reports."""
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or cell_name in m["workloads"]]
    reported = {m["name"] for m in e2e}
    per = [m for m in spec["per_layer"]
           if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return e2e, per


def metric_reader(name: str, root: str = ROOT) -> Callable:
    """``read(trace) -> value or None`` of ``perfbench/metrics/<name>.py``."""
    path = os.path.join(root, "perfbench", "metrics", name + ".py")
    mod_name = "perfbench_metric_" + "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def runner_of(mix: dict):
    return importlib.import_module("perfbench.runners." + mix["runner"])


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             t0: Optional[float] = None, root: str = ROOT, overrides: Optional[dict] = None,
             engine_kwargs: Optional[dict] = None, patch: Optional[Callable] = None):
    """Run a cell once; returns (result line as a dict, compared numbers
    {name: (value, limit or None)}).

    ``overrides`` ({"config": {...}, "mix": {...}}) and ``device="cpu"``
    serve the tests (small libraries on the CPU, the kernels' plain
    versions); ``engine_kwargs`` and ``patch(ctx)`` (called once the
    engine is filled, before the warm-up) serve the control and the
    fault checks.  A benchmark run passes none of them."""
    import torch

    from perfbench import data, program
    from perfbench.spans import Recorder, Trace

    t0 = time.perf_counter() if t0 is None else t0
    spec = load_spec(root)
    cell, config, mix = resolve(spec, name, root)
    for key, part in (overrides or {}).items():
        {"config": config, "mix": mix}[key].update(part)
    e2e_specs, per_specs = cell_metrics(spec, name)
    ctx = Context(cell, config, mix, int(seed), device)
    runner = runner_of(mix)
    on_card = device.startswith("cuda")

    # The kernels build (first run) or load while the card makes the rows.
    builds = ThreadPoolExecutor(1, thread_name_prefix="perfbench-build")
    loaded = builds.submit(program.load_kernels) if on_card else None
    builds.shutdown(wait=False)
    stages = [("imports", time.perf_counter())]
    ctx.library = data.make_library(config, seed, device)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    workdir = tempfile.mkdtemp(prefix="perfbench-")
    recorder = undo = None
    try:
        ctx.engine = program.new_engine(config, os.path.join(workdir, "library.db"), device,
                                        **(engine_kwargs or {}))
        stages.append(("library made", time.perf_counter()))
        program.append_library(ctx.engine, ctx.library.semantic.numpy(),
                               ctx.library.phash.numpy())
        stages.append(("engine filled", time.perf_counter()))
        if loaded is not None:
            loaded.result()
        stages.append(("kernels loaded", time.perf_counter()))
        undo = patch(ctx) if patch else None
        st = runner.prepare(ctx)
        stages.append(("warmed up", time.perf_counter()))
        if trace:
            n = int(config["rows"])
            recorder = Recorder({"cosine": n, "hamming": n}, PROFILE_SECONDS)
            recorder.install()
        start = runner.run(ctx, st, seconds, recorder, PROFILE_SECONDS if trace else 0.0)
        setup_s = start - t0
        for (what, t), (_, before) in zip(stages, [("", t0)] + stages):
            print(f"setup {what} {t - before:.3f} s", file=sys.stderr)
        lo, hi = runner.window(st)
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        if recorder is not None:
            recorder.uninstall()
        runner.close(st)
        values = runner.end_to_end(ctx, st)
        values["setup_s"] = setup_s
        attempted, failed = runner.attempted_failed(st)
        ctx.engine.close()
        ctx.engine = None
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        numbers = runner.check(ctx, st, device)
    finally:
        if recorder is not None:
            recorder.uninstall()
        if undo is not None:
            undo()
        shutil.rmtree(workdir, ignore_errors=True)

    correct = all(v <= lim for v, lim in numbers.values() if lim is not None)
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": {}}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    if not trace:
        for m in e2e_specs:
            if m["name"] not in values:
                raise RuntimeError(f"{name}: the run gave no {m['name']}")
            result["metrics"][m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        calls = [c for c in recorder.calls if lo <= c.t0 <= hi]
        passes = [p[:2] for p in getattr(st, "passes", [])]
        tr = Trace(hi - lo, calls, passes, recorder.profile())
        if tr.profile is None:
            raise RuntimeError("the profiler recorded no device activity")
        for m in per_specs:
            v = metric_reader(m["name"], root)(tr)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        dev["busy_s"], dev["window_s"] = tr.profile.busy_s, tr.profile.window_s
        result["breakdown"] = {"device_ops": tr.profile.device_ops,
                               "idle_gaps": tr.profile.idle_gaps}
    result["device"] = dev
    result["check"] = {k: {"value": v, "limit": lim} for k, (v, lim) in numbers.items()
                       if lim is not None}
    return result, numbers


def main(argv=None, t0: Optional[float] = None) -> int:
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    spec = load_spec()
    cell, _config, _mix = resolve(spec, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, numbers = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t0=t0)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {', '.join(bad)}; the benchmark runs the port alone",
              file=sys.stderr)
        return 3
    for k, (v, lim) in numbers.items():
        if lim is None:
            print(f"{k} {v}", file=sys.stderr)
    for k, (v, lim) in numbers.items():
        if lim is not None:
            print(f"{k} {v} limit {lim}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
