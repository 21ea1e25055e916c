"""Hand-kernel launches a scan call: the program's launch counters
(``ops/fused_scan.LAUNCHES``, all of them) across each call, over the
window's calls.  Torch operations between the hand kernels are not
counted."""


def read(trace):
    if not trace.calls:
        return None
    return sum(c.launches for c in trace.calls) / len(trace.calls)
