"""The scan calls' kernels against their roofline, in percent: the least
time the card could take for the profiled calls' needed work
(``perfbench/roofline.py``, from each call's shapes) over the device time
of the kernels that ran inside those calls (``torch.profiler``)."""


def read(trace):
    p = trace.profile
    if p is None or p.call_kernel_s <= 0 or p.call_bound_s <= 0:
        return None
    return 100.0 * p.call_bound_s / p.call_kernel_s
