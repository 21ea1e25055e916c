"""Mean host time of a duplicates pass's pair loop a batch: the program's
``dedup.pairs`` span
(pixelbox_tpu_torch/utils/timing.py, read by
:func:`perfbench.program_spans.scan_split`).  The whole run, warm-up
included; None where the program has no such span."""

from perfbench.program_spans import read as _read


def read(trace):
    return _read("dedup_pairs_ms_per_batch")
