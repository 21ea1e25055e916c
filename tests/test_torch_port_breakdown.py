"""The breakdown ladder's plain version (pixelbox_tpu_torch.tools.
measure_breakdown) against the JAX package's ``_ablate_kernel`` on the
CPU.

The JAX kernel is loaded from ``scripts/measure_breakdown.py`` and run
through ``pl.pallas_call(..., interpret=True)`` with that script's
BlockSpecs at Q = 8, N = 4,096, D = 128, TILE = 1,024 (grid order is the
sequential tile order).  Rows are perturbed copies of the queries, so the
coskey and epilogue rungs and the chain give finite, varied outputs (on
uniform rows they would be +inf and the comparison vacuous).  Outputs
must be bit-identical; the gemm rung's [Q] dot sum is held against numpy.
"""

import importlib.util
import os
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from pixelbox_tpu.ops.packed import PackedSemanticIndex as JIndex
from pixelbox_tpu.ops.packed import query_moments_from_u8 as jax_moments
from pixelbox_tpu.ops.pallas_scan import build_row_meta as jax_row_meta
from pixelbox_tpu_torch.ops.packed import query_moments_from_u8
from pixelbox_tpu_torch.tools import measure_breakdown as mb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QN, N, D, TILE = 8, 4096, 128, 1024


@pytest.fixture(scope="module")
def jax_ladder():
    """``scripts/measure_breakdown.py`` as a module.  Importing it turns on
    the persistent compile cache; it is pointed inside the checkout and
    the test suite's own cache directory is restored afterwards."""
    cache = jax.config.jax_compilation_cache_dir
    old = os.environ.get("PIXELBOX_TPU_CACHE_DIR")
    os.environ["PIXELBOX_TPU_CACHE_DIR"] = os.path.join(REPO, ".jax_cache")
    try:
        spec = importlib.util.spec_from_file_location(
            "jax_measure_breakdown", os.path.join(REPO, "scripts", "measure_breakdown.py")
        )
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", cache)
        if old is None:
            os.environ.pop("PIXELBOX_TPU_CACHE_DIR", None)
        else:
            os.environ["PIXELBOX_TPU_CACHE_DIR"] = old
    return mod


@pytest.fixture(scope="module")
def inputs():
    q_u8, index, meta = mb.ladder_inputs(N, D, QN, seed=5, planted=True)
    return q_u8[0], index, meta


def _run_jax(mod, stage, q_u8, index):
    jidx = JIndex(*(jnp.asarray(t.numpy()) for t in index))
    meta = jax_row_meta(jidx)
    q_i8, _, _ = jax_moments(jnp.asarray(q_u8.numpy()))
    kernel = partial(mod._ablate_kernel, tile_rows=TILE, dim=D, stage=stage)
    out = pl.pallas_call(
        kernel,
        grid=(N // TILE,),
        in_specs=[
            pl.BlockSpec((QN, D), lambda i: (0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((TILE, D), lambda i: (i, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((4, TILE), lambda i: (0, i), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((QN, 128), lambda i: (0, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((QN, 128), jnp.float32),
        interpret=True,
    )(q_i8, jidx.data, meta)
    return np.asarray(out), np.asarray(meta)


@pytest.mark.parametrize("rung", mb.RUNGS)
def test_rung_matches_jax_ablate_kernel(jax_ladder, inputs, rung):
    q_u8, index, meta = inputs
    want, jmeta = _run_jax(jax_ladder, rung, q_u8, index)
    assert np.array_equal(jmeta, meta.numpy())
    out, dot_sum = mb.ladder(rung, *query_moments_from_u8(q_u8), index.data, meta, TILE)
    got = out.numpy()
    assert got.shape == (QN, 128) and got.dtype == np.float32
    # Not vacuous: the compared lanes are finite and take many values.
    lanes = got if rung in ("gemm", "chain") else got[:, :1]
    assert np.isfinite(lanes).all(), rung
    assert len(np.unique(lanes)) >= (QN * 64 if rung in ("gemm", "chain") else QN), rung
    if rung in ("coskey", "epilogue"):
        assert not got[:, 1:].any()
    assert np.array_equal(got.view(np.int32), want.view(np.int32)), rung
    if rung == "gemm":
        codes = q_u8.numpy().astype(np.int64) - 128
        rows = index.data.numpy().astype(np.int64)
        assert np.array_equal(dot_sum.numpy(), (codes @ rows.T).sum(axis=1))
    else:
        assert not dot_sum.any()


def test_uniform_rows_make_the_epilogue_rungs_vacuous():
    """Why the rows are planted: on the JAX script's uniform rows nothing
    passes θ = 0.02 or the key −0.5."""
    q_u8, index, meta = mb.ladder_inputs(N, D, QN, seed=5)
    mom = query_moments_from_u8(q_u8[0])
    for rung in ("coskey", "epilogue", "chain"):
        out, _ = mb.ladder(rung, *mom, index.data, meta, TILE)
        lanes = out if rung == "chain" else out[:, :1]
        assert torch.isinf(lanes).all(), rung


@pytest.mark.parametrize(
    "tile,rows,err",
    [(1000, 4000, "tile_rows"), (128, 4096, "tile_rows"), (1024, 4000, "multiple")],
)
def test_ladder_refuses_shapes_the_kernel_does_not_take(inputs, tile, rows, err):
    q_u8, index, meta = inputs
    with pytest.raises(ValueError, match=err):
        mb.ladder("gemm", *query_moments_from_u8(q_u8), index.data[:rows],
                  meta[:, :rows].contiguous(), tile)


def test_timed_driver_needs_the_card():
    with pytest.raises(RuntimeError):
        mb.run(n=4096, q=8, tile_rows=1024, iters=2, device="cpu")
