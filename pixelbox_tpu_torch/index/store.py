"""Device-resident vector store with streaming append (torch port of
``index/store.py``, ``kind="semantic"``).

Vectors live packed on the device (see ``ops.packed``); the host keeps a
uint8 mirror for re-packing and result assembly.  Capacity grows by
doubling in block-aligned steps (the JAX package's ``_target_capacity``
rule); appends within capacity WRITE IN PLACE into the device tensors
(``data[start:end] = …``) — where the JAX package donated the old buffer
to a dynamic-update-slice.  An in-place write is visible to any scan
still reading the tensors, so callers hold the engine's index write lock
across appends and deletes (Engine.insert_records_batch), exactly as the
donation required.  The validity mask gates padded/deleted rows out of
every scan.

Deletes are tombstones (valid=False), compacted away by
:meth:`VectorStore.compact`.  The ``semantic4`` (int4) and ``hamming``
kinds wait (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np
import torch

from pixelbox_tpu_torch.ops.packed import PackedSemanticIndex, semantic_rows_from_u8
from pixelbox_tpu_torch.utils.device import resolve_device

DEFAULT_BLOCK_ROWS = 32768
_MIN_CAPACITY = 1024


class VectorStore:
    """A growable device-resident u8 vector index.

    Parameters
    ----------
    dim: vector width in bytes (the embedding dim).
    kind: "semantic" (the only kind ported so far).
    device: where the packed tensors live ("cuda", "cpu", a torch.device).
    """

    def __init__(
        self,
        dim: int,
        kind: str = "semantic",
        block_rows: int = DEFAULT_BLOCK_ROWS,
        device="cuda",
    ):
        if kind != "semantic":
            raise NotImplementedError(
                f"VectorStore kind {kind!r} is not yet ported to pixelbox_tpu_torch"
            )
        self.dim = int(dim)
        self.kind = kind
        self.block_rows = int(block_rows)
        self.device = resolve_device(device)
        self.n = 0  # live row count (including tombstones)
        self.n_deleted = 0
        #: Mutation counter: bumps on every append/delete/compact/grow.
        #: Derived layouts (row meta, the scan sample) key their caches on
        #: this — NOT on ``n``, which does not change on tombstone deletes.
        self.version = 0
        # Host mirrors (uint8 raw rows; authoritative for repacking).
        self._host_rows = np.zeros((0, self.dim), dtype=np.uint8)
        self._host_valid = np.zeros((0,), dtype=bool)
        self._capacity = 0
        self._device_arrays = None  # PackedSemanticIndex

    # ------------------------------------------------------------------ #
    # Capacity management

    def _target_capacity(self, n: int) -> int:
        cap = max(_MIN_CAPACITY, self.block_rows)
        while cap < n:
            cap *= 2
        # Keep capacity block-aligned for the blocked scans.
        return -(-cap // self.block_rows) * self.block_rows

    def _alloc(self, capacity: int):
        """(Re)allocate device tensors at ``capacity`` and repack live rows."""
        self._capacity = capacity
        n = self.n
        rows = np.zeros((capacity, self.dim), dtype=np.uint8)
        rows[:n] = self._host_rows[:n]
        valid = np.zeros((capacity,), dtype=bool)
        valid[:n] = self._host_valid[:n]
        data, row_sum, row_mag2 = semantic_rows_from_u8(rows)
        self._device_arrays = PackedSemanticIndex(
            self._put(data), self._put(row_sum), self._put(row_mag2), self._put(valid)
        )

    def _put(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    # ------------------------------------------------------------------ #
    # Mutation

    def append(self, rows_u8: np.ndarray) -> np.ndarray:
        """Append u8 rows [m, dim]; returns their assigned row ids [m].

        Row ids are stable for the life of the store (until :meth:`compact`).
        """
        rows_u8 = np.ascontiguousarray(rows_u8, dtype=np.uint8)
        if rows_u8.ndim == 1:
            rows_u8 = rows_u8[None, :]
        m, d = rows_u8.shape
        assert d == self.dim, (d, self.dim)
        start = self.n
        new_n = start + m

        # Host mirror grows amortized-doubling too.
        if new_n > self._host_rows.shape[0]:
            new_cap = max(_MIN_CAPACITY, 2 * self._host_rows.shape[0])
            while new_cap < new_n:
                new_cap *= 2
            grown = np.zeros((new_cap, self.dim), dtype=np.uint8)
            grown[: self.n] = self._host_rows[: self.n]
            self._host_rows = grown
            grown_v = np.zeros((new_cap,), dtype=bool)
            grown_v[: self.n] = self._host_valid[: self.n]
            self._host_valid = grown_v
        self._host_rows[start:new_n] = rows_u8
        self._host_valid[start:new_n] = True
        self.n = new_n
        self.version += 1

        if self._device_arrays is None or new_n > self._capacity:
            self._alloc(self._target_capacity(new_n))
        else:
            self._write_device_rows(rows_u8, start)
        return np.arange(start, new_n, dtype=np.int64)

    def _write_device_rows(self, rows_u8: np.ndarray, start: int):
        """In-place write of appended rows (caller holds the write lock)."""
        end = start + rows_u8.shape[0]
        data, row_sum, row_mag2 = semantic_rows_from_u8(rows_u8)
        a = self._device_arrays
        a.data[start:end] = self._put(data)
        a.row_sum[start:end] = self._put(row_sum)
        a.row_mag2[start:end] = self._put(row_mag2)
        a.valid[start:end] = True

    def delete(self, row_ids) -> None:
        """Tombstone rows (they stop appearing in scans; ids stay stable)."""
        row_ids = np.atleast_1d(np.asarray(row_ids, dtype=np.int64))
        fresh = self._host_valid[row_ids]
        self._host_valid[row_ids] = False
        self.n_deleted += int(np.count_nonzero(fresh))
        self.version += 1
        if self._device_arrays is not None:
            self._device_arrays.valid[torch.from_numpy(row_ids).to(self.device)] = False

    def compact(self) -> np.ndarray:
        """Drop tombstones; returns old→new row-id mapping (−1 = deleted)."""
        old_n = self.n
        live = self._host_valid[:old_n]
        mapping = np.full(old_n, -1, dtype=np.int64)
        keep = np.nonzero(live)[0]
        mapping[keep] = np.arange(len(keep), dtype=np.int64)
        self._host_rows = np.ascontiguousarray(self._host_rows[:old_n][live])
        self._host_valid = np.ones(len(keep), dtype=bool)
        self.n = len(keep)
        self.n_deleted = 0
        self.version += 1
        self._alloc(self._target_capacity(max(self.n, 1)))
        return mapping

    # ------------------------------------------------------------------ #
    # Access

    @property
    def device_index(self) -> PackedSemanticIndex:
        """The packed device tensors for the scans (padded/masked)."""
        if self._device_arrays is None:
            self._alloc(self._target_capacity(1))
        return self._device_arrays

    @property
    def size(self) -> int:
        """Number of live (non-deleted) rows."""
        return self.n - self.n_deleted

    def get_rows(self, row_ids) -> np.ndarray:
        return self._host_rows[np.asarray(row_ids, dtype=np.int64)]
