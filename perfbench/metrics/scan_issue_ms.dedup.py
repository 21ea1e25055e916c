"""Host time a duplicates pass's scan call spends issuing work: the
program's ``dedup.scan`` span less the ``scan.*`` wait spans, a call
(pixelbox_tpu_torch/utils/timing.py, read by
:func:`perfbench.program_spans.scan_split`).  The whole run, warm-up
included; None where the program has no such span."""

from perfbench.program_spans import read as _read


def read(trace):
    return _read("scan_issue_ms.dedup")
