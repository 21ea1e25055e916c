"""A run with the timed path broken underneath comes out not correct, and
so does each cell's control; a sound run comes out correct.

These drive the rest of a run on the CPU at a test size (the kernels'
plain versions; the harness's look for a card is skipped): a library of
4,096 rows (capacity 32,768, the exact path).  The faults
are planted in the program's scan calls, where the answers are produced:
an answer altered, half of the batch left out (its answers copied from
the other half), and a step that returns the state it returned before.
No cell spans chips, so the exchange between chips has no fault here."""

import importlib

import pytest
import torch

from perfbench import control, harness, program

CONFIG = {"rows": 4096, "planted_every": 100,
          "semantic": {"centres": 16, "noise": 0.35, "planted_bytes": 3, "planted_step": 60},
          "phash": {"centres": 1024, "noise_ands": 3, "planted_bits": 4}}
MIXES = {"photos-1M.dedup-phash": {"check_rows": 256},
         "photos-1M.dedup-semantic": {"check_rows": 256}}
SEED = 2**31 + 99


def _run(cell, **kwargs):
    return harness.run_cell(cell, SEED, 0.5, False, device="cpu",
                            overrides={"config": CONFIG, "mix": MIXES[cell]}, **kwargs)


def _altered(orig):
    def scan(*a, **kw):
        d, i = orig(*a, **kw)
        i = i.clone()
        i[0, 0] = (i[0, 0] + 1) % CONFIG["rows"]
        return d, i
    return scan


def _half_left_out(orig):
    def scan(query_u8, *a, **kw):
        q = torch.as_tensor(query_u8)
        half = max(1, q.shape[0] // 2)
        d, i = orig(q[:half].contiguous(), *a, **kw)
        take = torch.arange(q.shape[0]) % half
        return d[take], i[take]
    return scan


def _stale(orig):
    last = {}

    def scan(*a, **kw):
        d, i = orig(*a, **kw)
        key = tuple(d.shape)
        out = last.get(key, (d, i))
        last[key] = (d, i)
        return out
    return scan


FAULTS = {"altered": _altered, "half_left_out": _half_left_out, "stale": _stale}


def _plant(fault):
    def patch(ctx):
        undo = []
        for mod_name, attr, _kind in program.SCAN_CALLS:
            mod = importlib.import_module(mod_name)
            orig = getattr(mod, attr)
            setattr(mod, attr, FAULTS[fault](orig))
            undo.append((mod, attr, orig))
        return lambda: [setattr(m, a, o) for m, a, o in undo]
    return patch


@pytest.mark.parametrize("cell", sorted(MIXES))
def test_sound_run_is_correct(cell):
    result, numbers = _run(cell)
    assert result["correct"], numbers
    assert all(v == 0 for v, lim in numbers.values() if lim is not None)


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", sorted(MIXES))
def test_fault_is_not_correct(cell, fault):
    result, numbers = _run(cell, patch=_plant(fault))
    assert not result["correct"], numbers


@pytest.mark.parametrize("cell", sorted(MIXES))
def test_control_is_not_correct(cell):
    result, numbers = control.run_control(
        cell, SEED, 0.5, device="cpu", overrides={"config": CONFIG, "mix": MIXES[cell]})
    assert not result["correct"], numbers
