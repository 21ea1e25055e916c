"""Whole-library duplicates passes, back to back
(``Engine.find_duplicate_pairs``, the CLI's ``duplicates``).

A pass that starts inside the window runs to its end; the window ends
with the last pass.  End-to-end quantity: ``dedup_rows_per_s``, the live
rows times the whole passes over the wall time of those passes.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field

import torch

from perfbench import data, program
from perfbench.reference import scan as ref


@dataclass
class State:
    rows: int                                   # live rows a pass scans
    passes: list = field(default_factory=list)  # (t0, t1, pairs) of the window's passes


def _args(ctx):
    m = ctx.mix
    return dict(max_distance=float(m["max_distance"]), k=int(m["k"]),
                batch=int(m["batch"]), by=m["by"])


def prepare(ctx) -> State:
    """Warm the pass's own scan at its batch shape: the kernels load and
    the scan's cached sample and meta fill before the window."""
    a = _args(ctx)
    with ctx.engine.index_rwlock.read_locked():
        store, rows, scan = program.duplicate_scan(ctx.engine, a["by"], a["k"], a["max_distance"])
        for _ in range(2):
            scan(store.get_rows(rows[: a["batch"]]))
    return State(rows=int(store.size))


def run(ctx, st: State, seconds: float, recorder=None, profile_seconds: float = 0.0):
    a = _args(ctx)
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        t0 = time.perf_counter()
        pairs = ctx.engine.find_duplicate_pairs(**a)
        st.passes.append((t0, time.perf_counter(), pairs))
    print("pass seconds " + " ".join(f"{t1 - t0:.3f}" for t0, t1, _ in st.passes),
          file=sys.stderr)
    if recorder is not None and profile_seconds > 0:
        # One more pass, its first stretch profiled.
        recorder.start_profile_at(time.perf_counter())
        ctx.engine.find_duplicate_pairs(**a)
        recorder.stop_profile()
    return start


def window(st: State):
    return st.passes[0][0], st.passes[-1][1]


def close(st: State) -> None:
    pass


def end_to_end(ctx, st: State) -> dict:
    lo, hi = window(st)
    return {"dedup_rows_per_s": st.rows * len(st.passes) / (hi - lo)}


def attempted_failed(st: State):
    """A pass that fails ends the run, so every pass counted succeeded."""
    return len(st.passes), 0


def _program_pairs(pairs):
    return {(a, b): d for a, b, d in pairs}


def check(ctx, st: State, device) -> dict:
    """The first pass's whole pair list against the reference's pairs of
    the checked rows: every row that the list names, every planted
    near-duplicate and its predecessor, and a sample of rows drawn from
    the seed.  Every pair of the list must be the reference's, with its
    distance; every reference pair of a checked row must be in the list;
    the list is sorted by (dist, id_a, id_b) with id_a < id_b; every later
    pass gives the same list."""
    a = _args(ctx)
    first = st.passes[0][2]
    n = int(ctx.config["rows"])
    g = data.generator(ctx.seed, "sample", "cpu")
    sample = torch.randperm(n, generator=g)[: int(ctx.mix["check_rows"])]
    planted = ctx.library.planted
    rows = {r - 1 for p in first for r in p[:2]}     # image id = row + 1
    rows |= set(sample.tolist()) | set(planted.tolist()) | set((planted - 1).tolist())
    rows = sorted(rows)

    lib = getattr(ctx.library, "phash" if a["by"] == "phash" else "semantic").to(device)
    scan_rows = ref.HammingRows(lib) if a["by"] == "phash" else ref.CosineRows(lib)
    want = ref.duplicate_pairs(scan_rows, lib, rows, a["k"], a["max_distance"],
                               image_id=lambda r: r + 1)
    got = _program_pairs(first)
    wrong = sum(1 for key, d in got.items() if want.get(key) != d)
    wrong += len(first) - len(got)                            # a pair listed twice
    wrong += sum(1 for p in first if not p[0] < p[1])
    wrong += first != sorted(first, key=lambda p: (p[2], p[0], p[1]))
    missing = sum(1 for key in want if key not in got)
    differ = sum(1 for p in st.passes[1:] if p[2] != first)
    return {
        "checked_rows": (len(rows), None),
        "pairs": (len(first), None),
        "wrong_pairs": (wrong, 0),
        "missing_pairs": (missing, 0),
        "passes_differ": (differ, 0),
    }
