"""The duplicates pass's own host time a batch: the window's pass wall
time less the time inside the wrapped scan calls, over the batches (scan
calls) — the row gathers, the pair loop, the dedupe and the sort."""


def read(trace):
    if not trace.passes or not trace.calls:
        return None
    wall = sum(t1 - t0 for t0, t1 in trace.passes)
    inside = sum(c.t1 - c.t0 for c in trace.calls)
    return (wall - inside) / len(trace.calls) * 1e3
