"""The control of ``correct``: each cell run with its scan one precision
below the configuration's, which the comparison must judge not correct.

- The semantic cell (u8 rows): the program's own int4 path
  (``semantic_precision="int4"``) with its exact-u8 rerank off, so the
  distances it returns are the int4 metric's.
- The phash cell: the plain reference put in the program's place, over
  half of each hash's bits (a 16-byte phash), the step below the 32-byte
  hash as int4 is below int8.

The benchmark's own runs never run it.  Run on the card, a few seeds in
one process:

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 --seconds 3
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench import harness  # noqa: E402


def half_bit_phash(ctx):
    """Put the reference's Hamming scan over the first half of each hash's
    bytes in the place of the program's Hamming scan; returns the undo."""
    import torch

    from perfbench.reference import scan as ref

    mod = importlib.import_module("pixelbox_tpu_torch.ops.hamming_gemm")
    orig = mod.hamming_gemm_scan_topk_auto
    lib = ctx.library.phash.to(ctx.device)
    rows = ref.HammingRows(lib, byte_limit=lib.shape[1] // 2)

    def scan(query_u8, index, k=100, max_distance=1e3, **_):
        d, i = ref.topk(rows, torch.as_tensor(query_u8).to(ctx.device), k, max_distance)
        return d, i.to(torch.int32)

    mod.hamming_gemm_scan_topk_auto = scan
    return lambda: setattr(mod, "hamming_gemm_scan_topk_auto", orig)


def control_args(mix: dict) -> dict:
    """run_cell's keyword arguments that put the cell's control in place."""
    if mix.get("by") == "phash":
        return {"patch": half_bit_phash}
    return {"engine_kwargs": {"precision": "int4", "int4_rerank": False}}


def run_control(name: str, seed: int, seconds: float, **kwargs):
    spec = harness.load_spec(kwargs.get("root", harness.ROOT))
    _cell, _config, mix = harness.resolve(spec, name, kwargs.get("root", harness.ROOT))
    mix = dict(mix, **kwargs.get("overrides", {}).get("mix", {}))
    return harness.run_cell(name, seed, seconds, False, **control_args(mix), **kwargs)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Run a cell's control on a few seeds.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        result, numbers = run_control(args.workload, seed, args.seconds)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": True,
                          "correct": result["correct"],
                          "numbers": {k: v for k, (v, _lim) in numbers.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
