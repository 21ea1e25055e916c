"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for.  The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last the compared numbers under ``check``); the
compared numbers and their limits are also the last lines of standard
error.  Exits non-zero, printing no result, without enough CUDA cards,
without the program, or if the run loaded JAX or the JAX package.
"""

import time

T0 = time.perf_counter()  # set-up is timed from here, before any import

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# The program builds its kernels into this fixed directory of the
# checkout, so that only a checkout's first run compiles.
os.environ["PIXELBOX_TPU_TORCH_BUILD_DIR"] = os.path.join(ROOT, "pixelbox_tpu_torch", "_build")
os.environ["USE_FLAX"] = "0"

from perfbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], t0=T0))
