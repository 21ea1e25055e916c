"""CUDA graph replays a duplicates pass's scan call makes: the program's
``scan_graph_replays`` counter over its ``dedup.scan`` count
(pixelbox_tpu_torch/utils/timing.py).  The whole run, warm-up included
(the warm-up's second call captures and replays once, outside
``dedup.scan``); None where the program has no such counter or span."""


def read(trace):
    try:
        from pixelbox_tpu_torch.utils import timing
    except ImportError:
        return None
    if not hasattr(timing, "counters"):
        return None
    replays = timing.counters().get("scan_graph_replays")
    scan = timing.get_stats().get("dedup.scan")
    if replays is None or not scan or not scan["count"]:
        return None
    return replays / scan["count"]
