"""The yardstick of a scan call: the work it needs and the least time the
card could take for it.

Copied from the arithmetic of the repository's smoke run (``work_of``,
``bound_of``) and kept here, where a change to the program cannot move it.
The work follows from the call's shapes alone, whatever kernels run: each
live row and its meta read once, the queries read once, the [Q, k]
(dist, id) result written once; operations as the int8 products of the
dot (the Hamming kind: the ±1 product of its 8·H bits).  Q counts a
batch's real queries, not a bucket's zero padding.
"""

from __future__ import annotations

from dataclasses import dataclass

#: Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
#: its 700 W limit): HBM bytes/s and int8 tensor-core operations/s.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12

#: Bytes of kernel meta a row: the cosine kinds' [4, N] int32 meta (row
#: sum, moment, reciprocal root; a fourth word of padding is not counted)
#: and the Hamming kind's one-byte row mask.
META_BYTES = {"cosine": 12, "hamming": 1}
#: Bytes of one result entry: an f32 distance and an int32 row id.
RESULT_BYTES = 8


@dataclass(frozen=True)
class ScanWork:
    kind: str        # "cosine" (u8 rows) or "hamming"
    queries: int     # real queries of the call
    rows: int        # live rows scanned
    capacity: int    # rows the store holds room for (meta covers them all)
    row_bytes: int   # bytes a row: D for cosine, H for Hamming
    k: int

    @property
    def nbytes(self) -> int:
        return (self.rows * self.row_bytes + META_BYTES[self.kind] * self.capacity
                + self.queries * self.row_bytes + self.queries * self.k * RESULT_BYTES)

    @property
    def ops(self) -> int:
        width = self.row_bytes if self.kind == "cosine" else 8 * self.row_bytes
        return 2 * self.queries * self.rows * width


def bound_s(work: ScanWork):
    """(least seconds, what bounds it): bytes at the HBM rate against
    operations at the int8 tensor-core rate."""
    by_bytes = work.nbytes / HBM_BYTES_PER_S
    by_ops = work.ops / INT8_OPS_PER_S
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"
