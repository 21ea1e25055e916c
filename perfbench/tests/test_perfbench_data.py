"""The seeded generators repeat per seed and plant what they promise."""

import pytest
import torch

from perfbench import data

CONFIG = {"rows": 3000, "dim": 128, "phash_bytes": 32, "planted_every": 1000,
          "semantic": {"centres": 8, "noise": 0.35, "planted_bytes": 3, "planted_step": 60},
          "phash": {"centres": 64, "noise_ands": 3, "planted_bits": 4}}
BIG_SEED = 2**31 + 12345


@pytest.fixture(autouse=True)
def one_thread():
    """One CPU thread: with several, the CPU's vectorised tanh rounds the
    tails of its chunks differently from run to run (the card's kernels
    do not), so a row at a quantization edge can move."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_same_seed_same_library_other_seed_other():
    a = data.make_library(CONFIG, BIG_SEED, "cpu")
    b = data.make_library(CONFIG, BIG_SEED, "cpu")
    c = data.make_library(CONFIG, BIG_SEED + 1, "cpu")
    assert torch.equal(a.semantic, b.semantic) and torch.equal(a.phash, b.phash)
    assert not torch.equal(a.semantic, c.semantic) and not torch.equal(a.phash, c.phash)
    assert a.semantic.dtype == torch.uint8 and a.semantic.shape == (3000, 128)


def test_planted_pairs():
    lib = data.make_library(CONFIG, BIG_SEED, "cpu")
    assert lib.planted.tolist() == [999, 1999, 2999]
    s = lib.semantic.to(torch.int32)
    moved = (s[lib.planted] != s[lib.planted - 1]).sum(dim=1)
    assert bool((moved <= 3).all())
    x = torch.bitwise_xor(lib.phash[lib.planted], lib.phash[lib.planted - 1])
    bits = sum(((x >> b) & 1).sum(dim=1) for b in range(8))
    assert bits.tolist() == [4, 4, 4]
