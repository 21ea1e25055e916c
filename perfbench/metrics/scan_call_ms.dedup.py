"""Mean host wall time of a scan call in the window (the wrapped call into
the scan orchestration, its own syncs and the copy of its results to the
host included)."""


def read(trace):
    if not trace.calls:
        return None
    return sum(c.t1 - c.t0 for c in trace.calls) / len(trace.calls) * 1e3
