"""Shared helpers for the per-modality serving mixins."""

from __future__ import annotations


def _read_locked(fn):
    """Hold the engine's index read lock for the duration of a query
    entry point: scan-row → image-id mapping must not interleave with a
    compaction renumbering (utils/rwlock.py; reader-preference makes
    nested entry points safe)."""
    import functools

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self.index_rwlock.read_locked():
            return fn(self, *args, **kwargs)

    return wrapper
