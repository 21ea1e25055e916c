"""Host syncs a duplicates pass's scan call makes: the program's
``host_syncs`` counter over its ``dedup.scan`` count
(pixelbox_tpu_torch/utils/timing.py, read by
:func:`perfbench.program_spans.scan_split`).  The whole run, warm-up
included; None where the program has no such span."""

from perfbench.program_spans import read as _read


def read(trace):
    return _read("host_syncs_per_scan.dedup")
