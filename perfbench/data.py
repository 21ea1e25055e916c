"""Seeded photo-library data, made on the device from ``--seed``.

Rewritten for the device from the generators of the repository's smoke
run (``clustered_hashes``, ``clustered_phashes``, ``perturb``,
``flip_bits``): the same distributions, drawn with one ``torch.Generator``
on the target device in a few large calls.  The same seed on the card
gives the same rows, the same planted pairs and the same query pool (on
the CPU too, with one thread: with several, its vectorised tanh rounds
chunk tails apart from run to run).

- Semantic rows: u8 hashes of 128 bytes, the quantized ``tanh`` of noisy
  cluster centres (embedding-like: each row lies near its centre).
- Phash rows: 32-byte hashes, random centres with each bit flipped with
  probability 1/8 (the AND of three random bytes).
- Planted near-duplicates: every ``planted_every``-th row is its
  predecessor with a few bytes moved (semantic) or a few bits flipped
  (phash), so every library holds pairs that a duplicates pass must find.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

#: Sub-streams of one seed, so that adding a draw to one part never
#: shifts another part's numbers.
_STREAM = {"semantic": 1, "phash": 2, "sample": 6}


def generator(seed: int, stream: str, device) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, stream); ``seed`` is any
    whole number below 2**62."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 8 + _STREAM[stream]) % (1 << 63))
    return g


def quantize(x: torch.Tensor) -> torch.Tensor:
    """f32 → u8 as the reference's ``as i8`` cast then +128."""
    scaled = torch.clamp(x * 128.0, -128.0, 128.0)
    return (torch.clamp(torch.trunc(scaled), -128.0, 127.0) + 128.0).to(torch.uint8)


def move_bytes(g, rows: torch.Tensor, n_bytes: int, step: int) -> torch.Tensor:
    """``rows`` with ``n_bytes`` distinct bytes of each row moved by a
    uniform step in [-step, step], clipped to u8 (``perturb``)."""
    m, d = rows.shape
    cols = torch.rand((m, d), generator=g, device=rows.device).argsort(dim=1)[:, :n_bytes]
    delta = torch.randint(-step, step + 1, (m, n_bytes), generator=g, device=rows.device)
    out = rows.to(torch.int32)
    moved = torch.clamp(out.gather(1, cols) + delta.to(torch.int32), 0, 255)
    return out.scatter(1, cols, moved).to(torch.uint8)


def flip_bits(g, rows: torch.Tensor, n_bits: int) -> torch.Tensor:
    """``rows`` with ``n_bits`` distinct bits of each row flipped."""
    m, h = rows.shape
    bits = torch.rand((m, 8 * h), generator=g, device=rows.device).argsort(dim=1)[:, :n_bits]
    mask = torch.zeros((m, h), dtype=torch.int64, device=rows.device)
    shifts = torch.bitwise_left_shift(torch.ones_like(bits), bits % 8)
    # Distinct bits of one byte add without carries: a sum is their OR.
    mask.scatter_add_(1, bits // 8, shifts)
    return torch.bitwise_xor(rows, mask.to(torch.uint8))


def semantic_rows(g, n: int, d: int, centres: int, noise: float) -> torch.Tensor:
    """Embedding-like u8 rows [n, d]: quantized tanh of noisy centres."""
    c = torch.randn((centres, d), generator=g, device=g.device)
    pick = torch.randint(0, centres, (n,), generator=g, device=g.device)
    x = c[pick] + noise * torch.randn((n, d), generator=g, device=g.device)
    return quantize(torch.tanh(x))


def phash_rows(g, n: int, h: int, centres: int, noise_ands: int) -> torch.Tensor:
    """phash-like u8 rows [n, h]: random centres, each bit flipped with
    probability 2**-noise_ands (the AND of that many random bytes)."""
    c = torch.randint(0, 256, (centres, h), generator=g, device=g.device, dtype=torch.uint8)
    out = c[torch.randint(0, centres, (n,), generator=g, device=g.device)]
    noise = torch.randint(0, 256, (n, h), generator=g, device=g.device, dtype=torch.uint8)
    for _ in range(noise_ands - 1):
        noise &= torch.randint(0, 256, (n, h), generator=g, device=g.device, dtype=torch.uint8)
    return out ^ noise


def planted_rows(n: int, every: int) -> torch.Tensor:
    """Rows that are near-duplicates of their predecessor: every
    ``every``-th row, counted from row ``every - 1``."""
    return torch.arange(every - 1, n, every)


@dataclass
class Library:
    """One library's rows, as the benchmark made them (host copies: the
    program gets them through its own append, the reference reads them
    once the window has closed)."""

    semantic: torch.Tensor   # u8 [n, dim]
    phash: torch.Tensor      # u8 [n, phash_bytes]
    planted: torch.Tensor    # int64 row ids that copy their predecessor


def make_library(config: dict, seed: int, device) -> Library:
    """The configuration's library from ``seed``: made on ``device``,
    returned on the host."""
    n, sem, ph = int(config["rows"]), config["semantic"], config["phash"]
    g = generator(seed, "semantic", device)
    s = semantic_rows(g, n, int(config["dim"]), int(sem["centres"]), float(sem["noise"]))
    planted = planted_rows(n, int(config["planted_every"])).to(device)
    s[planted] = move_bytes(g, s[planted - 1], int(sem["planted_bytes"]), int(sem["planted_step"]))
    g = generator(seed, "phash", device)
    p = phash_rows(g, n, int(config["phash_bytes"]), int(ph["centres"]), int(ph["noise_ands"]))
    p[planted] = flip_bits(g, p[planted - 1], int(ph["planted_bits"]))
    return Library(s.cpu(), p.cpu(), planted.cpu())
