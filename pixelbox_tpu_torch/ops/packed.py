"""Packed device-resident index representation (torch port of
``ops/packed.py``).

- ``data``: for semantic hashes, int8 ``[N_pad, D]`` storing ``q - 128``
  (centered so the scan kernels run int8 dot products); for phashes,
  uint8 ``[N_pad, H]`` raw bytes (xor/popcount scan);
- ``row_sum`` int32 ``[N_pad]``: sum of the centered int8 row — the affine
  correction recovering the exact u8 dot product from the int8 one;
- ``row_mag2`` int32 ``[N_pad]``: exact squared magnitude of the centered
  (2q-255) row — the per-row cosine normalizer;
- ``valid`` bool ``[N_pad]``: live-row mask (padding and deleted rows are
  False and can never appear in results).

The row index into these tensors is the stable join key back into the
host-side catalog.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class PackedSemanticIndex(NamedTuple):
    """Device tensors for the semantic (embedding) index."""

    data: torch.Tensor      # int8 [N_pad, D], centered q-128
    row_sum: torch.Tensor   # int32 [N_pad]
    row_mag2: torch.Tensor  # int32 [N_pad]
    valid: torch.Tensor     # bool [N_pad]

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    @property
    def dim(self) -> int:
        return self.data.shape[1]

    @property
    def device(self) -> torch.device:
        return self.data.device


class PackedHammingIndex(NamedTuple):
    """Device tensors for the perceptual-hash (Hamming) index."""

    data: torch.Tensor   # uint8 [N_pad, H]
    valid: torch.Tensor  # bool [N_pad]

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    @property
    def dim(self) -> int:
        return self.data.shape[1]

    @property
    def device(self) -> torch.device:
        return self.data.device


def semantic_rows_from_u8(q_u8: np.ndarray):
    """Host-side precompute for appending u8 embedding rows.

    q_u8: uint8 [n, D] → (data_i8 [n, D], row_sum [n], row_mag2 [n]).
    """
    q = np.asarray(q_u8, dtype=np.int32)
    data = (q - 128).astype(np.int8)
    row_sum = np.sum(q - 128, axis=-1, dtype=np.int32)
    centered = 2 * q - 255
    row_mag2 = np.sum(centered * centered, axis=-1, dtype=np.int32)
    return data, row_sum, row_mag2


def query_moments_from_u8(q_u8: torch.Tensor):
    """Device-side query precompute: u8 [Q, D] → (q_i8, q_sum, q_mag2)."""
    q = torch.as_tensor(q_u8).to(torch.int32)
    q_i8 = (q - 128).to(torch.int8)
    q_sum = torch.sum(q - 128, dim=-1, dtype=torch.int32)
    centered = 2 * q - 255
    q_mag2 = torch.sum(centered * centered, dim=-1, dtype=torch.int32)
    return q_i8, q_sum, q_mag2


def query4_moments_from_u8(q_u8: torch.Tensor):
    """The int4 twin (``ops/int4.py``'s symmetric metric): u8 [Q, D] →
    (4-bit codes v4 = round(15·q/255) as int8, Σ v4, Σ (34·v4 − 255)²)."""
    v = (torch.as_tensor(q_u8).to(torch.int32) * 15 + 127) // 255
    q_sum = torch.sum(v, dim=-1, dtype=torch.int32)
    c = 34 * v - 255
    q_mag2 = torch.sum(c * c, dim=-1, dtype=torch.int32)
    return v.to(torch.int8), q_sum, q_mag2
