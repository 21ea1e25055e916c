"""Reference-parity distance functions over u8 hash vectors (torch port of
``ops/distances.py``).

The reference defines three distances over opaque u8 blobs
(src/engine.rs:572-604).  Every function accepts ``a`` of shape
``[..., D]`` and ``b`` of shape ``[..., D]`` with normal broadcasting.

Exactness strategy: the dot product and squared magnitudes are computed
**exactly in integers** on centered values ``2q - 255`` and only the final
divide/sqrt runs in f32, with every f32 op correctly rounded — so the
values are bit-identical to the JAX package on the CPU (fast-math off) and
to the numpy oracle.

- ``cosine_distance`` (engine.rs:572-588): dist = 1/max(cos, 1e-6) - 1
  (reciprocal form, NOT 1-cos); 0.0 when a magnitude is zero.
- ``byte_distance`` (engine.rs:590-592): L1 / (255 * D).
- ``hamming_distance`` (engine.rs:594-604): popcount(xor) / (8 * D);
  ``wrap_u8=True`` replicates the reference's u8 accumulator overflow.
"""

from __future__ import annotations

import numpy as np
import torch

from pixelbox_tpu_torch.ops.quantize import center_u8

# The reference's guards (engine.rs:582-587).
_COSINE_FLOOR = 1e-6


def _f32(value, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim f32 tensor on ``like``'s device holding ``np.float32(value)``
    — constants enter the arithmetic already rounded to f32, exactly as
    the JAX package's ``np.float32`` / ``jnp.float32`` literals do.  Made
    by a fill on the device, not a copy from the host: a host-to-card copy
    waits for the card's queue, which would stall the scan between its
    stages."""
    return torch.full((), float(np.float32(value)), dtype=torch.float32, device=like.device)


def rsqrt_spec(x: torch.Tensor) -> torch.Tensor:
    """Canonical reciprocal square root: ``fl(1.0 / fl(sqrt(x)))``.

    Both ops must be correctly rounded for every implementation to agree
    bit-for-bit.  PyTorch's f32 ``sqrt`` on the CPU is not (its vector
    math library is ~1 ulp: 1,268 mismatches vs numpy over 1..2e5), so
    the root is taken in f64 and rounded once to f32 — correctly rounded
    for any f32 input, because f64 carries more than 2·24+2 bits and a
    square root of an f32 value never falls that close to an f32 rounding
    midpoint.  The division is an IEEE f32 divide on both the CPU and the
    card.  Never ``torch.rsqrt`` (an approximation on the card) and never
    under ``torch.compile``, which may fuse the pair into one — the JAX
    package needs an ``optimization_barrier`` against XLA's identical
    rewrite.
    """
    s = torch.sqrt(x.to(torch.float64)).to(torch.float32)
    return torch.ones_like(s) / s


def _cosine_distance_from_moments(
    dot_c: torch.Tensor, mag2_a_c: torch.Tensor, mag2_b_c: torch.Tensor
) -> torch.Tensor:
    """Finalize the reciprocal cosine distance from centered-integer moments
    (canonical rounding spec v2, separable magnitudes)::

        cos  = fl(dot_c · fl(rsqrt_spec(m2a) · rsqrt_spec(m2b)))
        dist = fl(1 / max(cos, 1e-6)) − 1

    Arguments are f32 copies of the exact integer moments.  Rounding
    guards (part of the spec): negative dist (cos > 1 rounding noise) is
    clamped to 0; IDENTICAL vectors (dot == m2a == m2b on the f32 moment
    copies) score exactly 0; a zero magnitude scores 0 (engine.rs:582-584).
    """
    inv = rsqrt_spec(mag2_a_c) * rsqrt_spec(mag2_b_c)
    cos = dot_c * inv
    g = torch.maximum(cos, _f32(_COSINE_FLOOR, cos))
    dist = torch.ones_like(g) / g - _f32(1.0, g)
    dist = torch.maximum(dist, _f32(0.0, dist))
    ident = (dot_c == mag2_a_c) & (mag2_a_c == mag2_b_c)
    zero = (mag2_a_c == 0.0) | (mag2_b_c == 0.0)
    return torch.where(ident | zero, _f32(0.0, dist), dist)


def cosine_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Reciprocal cosine distance over u8 vectors (engine.rs:572-588).

    Shapes broadcast over leading dims; reduces the last axis."""
    ca = center_u8(a).to(torch.int64)
    cb = center_u8(b).to(torch.int64)
    dot = torch.sum(ca * cb, dim=-1)
    mag2_a = torch.sum(ca * ca, dim=-1)
    mag2_b = torch.sum(cb * cb, dim=-1)
    return _cosine_distance_from_moments(
        dot.to(torch.float32), mag2_a.to(torch.float32), mag2_b.to(torch.float32)
    )


def byte_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Normalized L1 distance: sum |a-b| / (255 * D) (engine.rs:590-592)."""
    a = torch.as_tensor(a)
    b = torch.as_tensor(b)
    d = a.shape[-1]
    l1 = torch.sum(torch.abs(a.to(torch.int32) - b.to(torch.int32)), dim=-1)
    # Multiply-by-reciprocal is the canonical constant-scale spec.
    lf = l1.to(torch.float32)
    return lf * _f32(1.0 / (255.0 * d), lf)


def popcount_u8(x: torch.Tensor) -> torch.Tensor:
    """Per-byte popcount of a u8 tensor, as int32 (SWAR nibble trick)."""
    x = x.to(torch.int32)
    x = x - ((x >> 1) & 0x55)
    x = (x & 0x33) + ((x >> 2) & 0x33)
    return (x + (x >> 4)) & 0x0F


def hamming_distance(
    a: torch.Tensor, b: torch.Tensor, *, wrap_u8: bool = False
) -> torch.Tensor:
    """Normalized Hamming distance: popcount(a^b) / (8*D) (engine.rs:594-604).

    ``wrap_u8=True`` replicates the reference's u8 accumulator overflow
    (engine.rs:603 wraps mod 256 when hashes differ in more than 255 bits).
    """
    a = torch.as_tensor(a)
    b = torch.as_tensor(b)
    d = a.shape[-1]
    bits = torch.sum(popcount_u8(torch.bitwise_xor(a, b)), dim=-1)
    if wrap_u8:
        bits = bits % 256
    bf = bits.to(torch.float32)
    return bf * _f32(1.0 / (8.0 * d), bf)
