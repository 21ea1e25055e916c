"""Time a duplicates pass's scan call blocks the host on the card: the
program's ``scan.*`` wait spans (upload, proof, download), a ``dedup.scan``
(pixelbox_tpu_torch/utils/timing.py, read by
:func:`perfbench.program_spans.scan_split`).  The whole run, warm-up
included; None where the program has no such span."""

from perfbench.program_spans import read as _read


def read(trace):
    return _read("scan_wait_ms.dedup")
