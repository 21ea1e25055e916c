"""The whole step's share of the card's peak, in percent: the least time
the card could take for every scan call of the window
(``perfbench/roofline.py``, from each call's shapes, at the published
peaks) over the window's wall time.  It bounds any kernel's gain."""

from perfbench.roofline import bound_s


def read(trace):
    if not trace.calls or trace.window_s <= 0:
        return None
    return 100.0 * sum(bound_s(c.work)[0] for c in trace.calls) / trace.window_s
