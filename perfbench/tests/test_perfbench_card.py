"""On the card: a sound run at a test size through the hand kernels is
correct, and the control is not.  Skips without a card."""

import pytest

from perfbench import control, harness

CONFIG = {"rows": 262144, "planted_every": 1000,
          "semantic": {"centres": 1024, "noise": 0.35, "planted_bytes": 3, "planted_step": 60},
          "phash": {"centres": 65536, "noise_ands": 3, "planted_bits": 4}}
MIXES = {"photos-1M.dedup-phash": {"check_rows": 1024},
         "photos-1M.dedup-semantic": {"check_rows": 1024}}


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the scan kernels have no CPU mode")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(MIXES))
def test_sound_run_on_the_card(card, cell):
    result, numbers = harness.run_cell(cell, 2**31 + 5, 1.0, False, device=card,
                                       overrides={"config": CONFIG, "mix": MIXES[cell]})
    assert result["correct"], numbers
    assert result["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(MIXES))
def test_control_on_the_card(card, cell):
    result, numbers = control.run_control(cell, 2**31 + 6, 1.0, device=card,
                                          overrides={"config": CONFIG, "mix": MIXES[cell]})
    assert not result["correct"], numbers
