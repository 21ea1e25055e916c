"""Seconds of the run's store append, ``Engine._append_hashes`` filling
the library at set-up: the program's own ``engine.append`` span
(``pixelbox_tpu_torch/utils/timing.py``, always on), read from its
aggregate.  None where the program has no such span."""


def read(trace):
    from pixelbox_tpu_torch.utils import timing

    stats = timing.get_stats().get("engine.append")
    return stats["total_s"] if stats else None
