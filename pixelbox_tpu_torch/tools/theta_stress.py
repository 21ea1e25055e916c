"""Repeat the θ kernel against its plain version on the card.

    python -m pixelbox_tpu_torch.tools.theta_stress --seconds 120
    python -m pixelbox_tpu_torch.tools.theta_stress --first-launch 10

The θ stage (``fused_scan.sample_theta`` on ``csrc/tc_theta.cu``) over the
sample of a seeded, clustered 1,048,576 × 128 u8 library (the shape and
kind of ``chip_smoke.py`` phase 3: k = 100, so j = 20 of a 65,536-row
sample, max_distance 1e3), at Q ∈ {1, 8, 256, 2048}, each output held
``torch.equal`` to ``fused_scan.sample_theta_plain`` on the same inputs.

``--seconds``: one process repeats the kernel for that long, the
caching allocator's free blocks filled in turns with 0xFF and with random
bytes before a call (a read of memory the kernel did not write would
show).  ``--first-launch N``: N fresh processes each make the library,
then launch the kernel once per Q, the first of them being the process's
first launch of the θ kernel (the order of Q alternates).  Prints one
JSON line: calls, mismatches, the first few mismatching queries (kernel
and plain θ, plain θ0, the kernel run again), and the card's
``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from pixelbox_tpu_torch.ops import fused_scan as fs
from pixelbox_tpu_torch.ops import scan
from pixelbox_tpu_torch.ops.oracle import quantize_embedding_np
from pixelbox_tpu_torch.ops.packed import PackedSemanticIndex, semantic_rows_from_u8
from pixelbox_tpu_torch.utils.device import hold_exact_numerics

N_ROWS = 1 << 20
DIM = 128
QS = (1, 8, 256, 2048)
J = 20  # k = 100 over a 65,536-row sample of 1,048,576 rows
SEED = 20261016


def library(seed: int = SEED):
    """The scan sample of a clustered u8 library on the card, and its
    queries (perturbed stored rows, query 1 an exact copy)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((4096, DIM), dtype=np.float32)
    rows = np.empty((N_ROWS, DIM), np.uint8)
    for s in range(0, N_ROWS, 1 << 18):
        x = centers[rng.integers(0, 4096, 1 << 18)]
        rows[s : s + (1 << 18)] = quantize_embedding_np(
            np.tanh(x + 0.35 * rng.standard_normal(x.shape, dtype=np.float32))
        )
    q = rows[rng.integers(0, N_ROWS, max(QS))].astype(np.int32)
    for r in range(q.shape[0]):
        cols = rng.choice(DIM, 6, replace=False)
        q[r, cols] = np.clip(q[r, cols] + rng.integers(-60, 61, 6), 0, 255)
    q = q.astype(np.uint8)
    q[1] = rows[4242]
    dev = torch.device("cuda")
    data, rsum, rmag2 = semantic_rows_from_u8(rows)
    valid = np.ones(N_ROWS, bool)
    idx = PackedSemanticIndex(*(torch.from_numpy(x).to(dev) for x in (data, rsum, rmag2, valid)))
    return scan.build_scan_sample(idx), torch.from_numpy(q).to(dev)


def check(qk, smp, got, plain, qn, out):
    """Count a call; keep the first few mismatching queries."""
    out["calls"] += 1
    bad = (got != plain).nonzero().flatten()
    if bad.numel():
        out["mismatches"] += 1
        if len(out["examples"]) < 8:
            b = bad[:4]
            out["examples"].append({
                "Q": qn, "queries": b.tolist(), "of": int(bad.numel()),
                "kernel": got[b].tolist(), "plain": plain[b].tolist(),
                "plain_theta0": fs.mini_sample_theta(qk, smp, 1e3, J)[b].tolist(),
                "kernel_again": fs.sample_theta(qk, smp, 1e3, J)[b].tolist(),
            })


def warm(seconds: float) -> dict:
    smp, q = library()
    out = {"mode": "warm", "calls": 0, "mismatches": 0, "examples": []}
    qks = {qn: fs.CosineQueries(*fs._prep(q[:qn])) for qn in QS}
    plain = {qn: fs.sample_theta_plain(qk, smp, 1e3, J) for qn, qk in qks.items()}
    end = time.monotonic() + seconds
    turn = 0
    while time.monotonic() < end:
        for qn, qk in qks.items():
            if turn % 3:
                # Blocks of the allocator's small pool (up to 1 MB) and of
                # its large one, filled, then free for the call's buffers.
                fills = [torch.empty(1 << 19, dtype=torch.uint8, device=q.device) for _ in range(32)]
                fills.append(torch.empty(1 << 26, dtype=torch.uint8, device=q.device))
                for f in fills:
                    if turn % 3 == 1:
                        f.fill_(0xFF)
                    else:
                        f.random_(0, 256)
                del fills
            check(qk, smp, fs.sample_theta(qk, smp, 1e3, J), plain[qn], qn, out)
        turn += 1
    return out


def first_launch_child(order) -> dict:
    smp, q = library()
    out = {"calls": 0, "mismatches": 0, "examples": []}
    got = {}
    for qn in order:  # the first of these is the process's first θ launch
        qk = fs.CosineQueries(*fs._prep(q[:qn]))
        got[qn] = (qk, fs.sample_theta(qk, smp, 1e3, J))
    torch.cuda.synchronize()
    for qn, (qk, g) in got.items():
        check(qk, smp, g, fs.sample_theta_plain(qk, smp, 1e3, J), qn, out)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--first-launch", type=int, default=0)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("theta_stress needs a CUDA card", file=sys.stderr)
        return 2
    hold_exact_numerics()
    if args.child:
        print(json.dumps(first_launch_child([int(x) for x in args.child.split(",")])))
        return 0
    fs.load_theta_kernels()  # built once; the children load it
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    if args.seconds > 0:
        print(json.dumps({**warm(args.seconds), "seconds": args.seconds, "card": smi}), flush=True)
    if args.first_launch > 0:
        out = {"mode": "first_launch", "processes": args.first_launch, "calls": 0, "mismatches": 0,
               "examples": []}
        for p in range(args.first_launch):
            order = QS if p % 2 else QS[::-1]
            run = subprocess.run([sys.executable, "-m", __spec__.name, "--child", ",".join(map(str, order))],
                                 capture_output=True, text=True, timeout=600, check=True)
            child = json.loads(run.stdout.strip().splitlines()[-1])
            out["calls"] += child["calls"]
            out["mismatches"] += child["mismatches"]
            out["examples"] += child["examples"][: 8 - len(out["examples"])]
        print(json.dumps({**out, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
