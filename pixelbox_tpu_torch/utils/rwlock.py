"""Readers/writer lock with writer progress and re-entrant reads.

Guards the row↔image-id mappings against device-store mutation: many
concurrent query flows (engine entry points, the serving layer's
scan→assemble composites) read under the lock; store APPENDS and
TOMBSTONES (which donate the old device buffer to XLA — freeing it under
a concurrent scan) and ``compact()`` (which renumbers rows) write.

Semantics:
- A waiting writer blocks NEW top-level readers (so a continuous query
  loop cannot starve ingest/compaction)…
- …but a thread that already holds a read may re-acquire (query entry
  points nest), tracked per-thread, so nesting never deadlocks against a
  waiting writer.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager


class RWLock:
    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0
        self._local = threading.local()

    def _held(self) -> int:
        return getattr(self._local, "count", 0)

    def acquire_read(self) -> None:
        held = self._held()
        with self._cond:
            if held:
                # Re-entrant: we already hold a read, so no writer can be
                # ACTIVE; don't yield to waiting writers mid-operation.
                self._readers += 1
            else:
                while self._writer or self._writers_waiting:
                    self._cond.wait()
                self._readers += 1
        self._local.count = held + 1

    def release_read(self) -> None:
        self._local.count = self._held() - 1
        with self._cond:
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    def acquire_write(self) -> None:
        with self._cond:
            self._writers_waiting += 1
            try:
                while self._writer or self._readers > 0:
                    self._cond.wait()
                self._writer = True
            finally:
                self._writers_waiting -= 1

    def release_write(self) -> None:
        with self._cond:
            self._writer = False
            self._cond.notify_all()

    @contextmanager
    def read_locked(self):
        self.acquire_read()
        try:
            yield
        finally:
            self.release_read()

    @contextmanager
    def write_locked(self):
        self.acquire_write()
        try:
            yield
        finally:
            self.release_write()
