"""The program's own spans and counters, as the per-layer readers read them.

The port's recorder (``pixelbox_tpu_torch/utils/timing.py``) keeps an
aggregate of every span name and its counters, always on, so the readers
in ``perfbench/metrics/`` read them after the run, in the run's process.
They cover the whole run: the warm-up, the window and the profiled pass
after it.  :func:`scan_split` is None where the program has no such
spans or counters.

Run as a script, it runs a cell once as ``run.py`` does and prints one
JSON line: the result line; the split over the whole run and up to the
profiled pass (``split``, ``split_before_profile``; an untraced run's
split too); and the host-blocking CUDA runtime calls inside the profiled
``dedup.scan`` ranges (:func:`blocking_calls`), which
``host_syncs_per_scan.dedup`` should match.  ``--record 1`` keeps whole
spans meanwhile, which is what recording costs.

    python3 perfbench/program_spans.py --workload <cell> --seed <n> --seconds <s> --trace 1 [--record 1]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

#: A duplicates pass's scan call, and its pair loop (``serving/duplicates.py``).
SCAN, PAIRS = "dedup.scan", "dedup.pairs"


def scan_split(stats: Optional[dict] = None, counts: Optional[dict] = None) -> Optional[dict]:
    """The pass's split from the program's aggregates (``timing.get_stats()``)
    and counters (``timing.counters()``), read now where not given:

    - ``dedup_pairs_ms_per_batch``: Σ ``dedup.pairs`` / its count;
    - ``scan_wait_ms.dedup``: Σ the ``scan.*`` wait spans / the ``dedup.scan`` count;
    - ``scan_issue_ms.dedup``: Σ ``dedup.scan`` less those waits, / its count;
    - ``host_syncs_per_scan.dedup``, ``repaired_queries_per_scan.dedup``:
      the counters / the ``dedup.scan`` count."""
    if stats is None or counts is None:
        try:
            from pixelbox_tpu_torch.utils import timing
        except ImportError:
            return None
        if not hasattr(timing, "counters"):
            return None
        stats, counts = timing.get_stats(), timing.counters()
    scan, pairs = stats.get(SCAN), stats.get(PAIRS)
    if not scan or not pairs or not scan["count"] or not pairs["count"]:
        return None
    n = scan["count"]
    wait_s = sum(v["total_s"] for k, v in stats.items() if k.startswith("scan.") and v.get("wait"))
    return {
        "dedup_pairs_ms_per_batch": pairs["total_s"] / pairs["count"] * 1e3,
        "scan_issue_ms.dedup": (scan["total_s"] - wait_s) / n * 1e3,
        "scan_wait_ms.dedup": wait_s / n * 1e3,
        "host_syncs_per_scan.dedup": counts.get("host_syncs", 0) / n,
        "repaired_queries_per_scan.dedup": counts.get("repaired_queries", 0) / n,
    }


def read(metric: str):
    """One value of :func:`scan_split`, or None."""
    split = scan_split()
    return None if split is None else split[metric]


def blocking_calls(events) -> dict:
    """Host-blocking CUDA runtime calls (``cudaStreamSynchronize`` and the
    like; every blocking copy in torch ends in one) inside the profiled
    ``dedup.scan`` ranges of a chrome trace, per range, and the copies'
    runtime calls beside them."""
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e and "dur" in e]
    scans = sorted((e["ts"], e["ts"] + e["dur"]) for e in xs
                   if e.get("cat") in ("cpu_op", "user_annotation") and e.get("name") == SCAN)
    runtime = [e for e in xs if e.get("cat") == "cuda_runtime"]
    if not scans:
        return {}

    def per_scan(pred):
        hits = [e for e in runtime if pred(e.get("name", ""))
                and any(lo <= e["ts"] <= hi for lo, hi in scans)]
        return len(hits) / len(scans)

    return {"scans": len(scans),
            "synchronize_per_scan": per_scan(lambda n: "Synchronize" in n),
            "memcpy_per_scan": per_scan(lambda n: n.startswith("cudaMemcpy"))}


def main(argv=None) -> int:
    import torch

    from perfbench import harness, spans as bench_spans
    from pixelbox_tpu_torch.utils import timing

    p = argparse.ArgumentParser(description="Run one cell; count the blocking calls of its scans.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=1)
    p.add_argument("--record", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2

    kept: dict = {}
    reduce, start_at = bench_spans.reduce_profile, bench_spans.Recorder.start_profile_at

    def keep_events(events, *a, **kw):
        kept["events"] = events
        return reduce(events, *a, **kw)

    def split_then_profile(self, t):
        kept["before_profile"] = scan_split()
        return start_at(self, t)

    bench_spans.reduce_profile = keep_events
    bench_spans.Recorder.start_profile_at = split_then_profile
    try:
        result, _numbers = harness.run_cell(
            args.workload, args.seed, args.seconds, bool(args.trace),
            patch=(lambda ctx: timing.start_recording()) if args.record else None,
        )
    finally:
        bench_spans.reduce_profile, bench_spans.Recorder.start_profile_at = reduce, start_at
        timing.stop_recording()
    out = {"workload": args.workload, "seed": args.seed, "trace": args.trace,
           "record": args.record, "card": torch.cuda.get_device_name(0), "result": result,
           "split": scan_split(), "split_before_profile": kept.get("before_profile")}
    if "events" in kept:
        out["profiled"] = blocking_calls(kept["events"])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, ROOT)
    os.environ["PIXELBOX_TPU_TORCH_BUILD_DIR"] = os.path.join(ROOT, "pixelbox_tpu_torch", "_build")
    sys.exit(main())
