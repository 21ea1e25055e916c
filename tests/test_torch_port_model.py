"""pixelbox_tpu_torch embedders vs pixelbox_tpu embedders on the CPU.

EfficientNet-B0: the JAX package's Flax variables go through
``params_from_jax`` (and its ``.npz`` checkpoint through ``load_params``);
the same seeded NHWC batch goes through both towers.  Latents agree
within rtol=1e-4, atol=1e-5 (the tolerance of tests/test_torch_numerical.py:
the two frameworks sum convolutions in other orders); the u8 hashes are
equal except where an f32 latent lies within 2e-5 of a quantization edge,
and the count of such bytes is reported (expected 0).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pixelbox_tpu.models import efficientnet as jeff
from pixelbox_tpu.models.stub import StubEmbedder as JStub
from pixelbox_tpu.ops.quantize import quantize_embedding as jquant
from pixelbox_tpu_torch.models import efficientnet as teff
from pixelbox_tpu_torch.models.stub import StubEmbedder as TStub
from pixelbox_tpu_torch.ops.quantize import quantize_embedding as tquant


def near_edge(latents: np.ndarray, tol: float = 2e-5) -> np.ndarray:
    """Bytes whose f32 latent is within ``tol`` of a u8 bin edge
    (multiples of 1/128 inside (-1, 1))."""
    scaled = latents.astype(np.float64) * 128.0
    return (np.abs(scaled - np.round(scaled)) < tol * 128.0) & (np.abs(latents) < 1.0)


def image_batch(seed, batch, size):
    """Seeded NHWC images from smooth to pixel noise (the calibration
    family of ``seeded_state_dict``), in [0, 1]."""
    rng = np.random.default_rng(seed)
    grids = [4, 16, size] * batch
    imgs = [
        torch.nn.functional.interpolate(
            torch.from_numpy(rng.uniform(0, 1, (1, 3, g, g)).astype(np.float32)),
            size=(size, size), mode="bilinear", align_corners=False,
        )[0].permute(1, 2, 0).numpy()
        for g in grids[:batch]
    ]
    return np.ascontiguousarray(np.stack(imgs))


def compare_towers(size, latent, batch, seed):
    sd = teff.seeded_state_dict(latent, seed=seed, input_size=size)
    jvars = jeff.params_from_torch_state_dict(
        {("0." + k[len("features."):] if k.startswith("features.") else k): v
         for k, v in sd.items() if not k.endswith("num_batches_tracked")}
        | {"3.weight": sd["linear.weight"], "3.bias": sd["linear.bias"]},
        latent_dim=latent,
    )
    emb = teff.EfficientNetEmbedder(
        dim=latent, input_size=size,
        params=teff.params_from_jax(jax.tree_util.tree_map(np.asarray, jvars)),
        device="cpu",
    )
    img = image_batch(seed + 1, batch, size)
    want = np.asarray(jeff.EfficientNetEmbedderModule(latent_dim=latent).apply(jvars, jnp.asarray(img)))
    got = emb.embed_preprocessed(img).numpy()
    return got, want


@pytest.mark.parametrize(
    "size,latent,batch", [(64, 8, 3), (224, 128, 2)], ids=["64px_latent8", "full_geometry"]
)
def test_b0_params_from_jax(size, latent, batch):
    got, want = compare_towers(size, latent, batch, seed=11)
    assert got.shape == (batch, latent) and np.isfinite(got).all()
    assert (np.abs(want) < 0.999).mean() > 0.5 and want.std() > 0.05, "degenerate latents"
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    gh = tquant(torch.from_numpy(got)).numpy()
    wh = np.asarray(jquant(jnp.asarray(want)))
    edge = near_edge(want) | near_edge(got)
    print(f"bytes within 2e-5 of a quantization edge: {int(edge.sum())} of {edge.size}")
    np.testing.assert_array_equal(gh[~edge], wh[~edge])


def test_b0_npz_checkpoint_round_trip(tmp_path):
    """The port writes the JAX checkpoint format; both packages load it."""
    sd = teff.seeded_state_dict(16, seed=5, input_size=64)
    path = str(tmp_path / "b0.npz")
    teff.save_params(sd, path)
    jvars = jeff.load_params(path)
    back = teff.load_params(path)
    for k, v in sd.items():
        np.testing.assert_array_equal(np.asarray(back[k]), np.asarray(v))
    again = teff.params_from_jax(jax.tree_util.tree_map(np.asarray, jvars))
    assert set(again) == set(sd)
    emb = teff.EfficientNetEmbedder(dim=16, input_size=64, checkpoint_path=path, device="cpu")
    img = image_batch(1, 2, 64)
    want = np.asarray(jeff.EfficientNetEmbedder(dim=16, input_size=64, checkpoint_path=path)
                      .embed_preprocessed(jnp.asarray(img)))
    np.testing.assert_allclose(emb.embed_preprocessed(img).numpy(), want, rtol=1e-4, atol=1e-5)


def test_b0_torch_state_dict_layouts():
    sd = teff.seeded_state_dict(8, seed=2, input_size=64)
    reference_layout = {
        ("0." + k[len("features."):]): v for k, v in sd.items() if k.startswith("features.")
    }
    reference_layout["3.weight"] = sd["linear.weight"]
    reference_layout["3.bias"] = sd["linear.bias"]
    for layout in (reference_layout, sd):
        out = teff.params_from_torch_state_dict(layout, latent_dim=8)
        for k, v in sd.items():
            np.testing.assert_array_equal(np.asarray(out[k]), v)
    # No trained head: drawn like the JAX importer (numpy seed 0).
    bare = teff.params_from_torch_state_dict(
        {k: v for k, v in sd.items() if k.startswith("features.")}, latent_dim=8
    )
    jbare = jeff.params_from_torch_state_dict(
        {k: v for k, v in sd.items()
         if k.startswith("features.") and not k.endswith("num_batches_tracked")},
        latent_dim=8,
    )
    np.testing.assert_array_equal(
        bare["linear.weight"], np.asarray(jbare["params"]["linear"]["kernel"]).T
    )


def test_stub_with_shared_matrix_hashes_equal():
    jstub = JStub(dim=64, input_size=64, seed=3)
    w = np.asarray(jstub._w)
    tstub = TStub(dim=64, input_size=64, weights=w, device="cpu")
    img = np.random.default_rng(3).uniform(0, 1, (4, 64, 64, 3)).astype(np.float32)
    got = tstub.embed_preprocessed(img).numpy()
    want = np.asarray(jstub.embed_preprocessed(jnp.asarray(img)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        tquant(torch.from_numpy(got)).numpy(), np.asarray(jquant(jnp.asarray(want)))
    )


def test_seeded_torch_init_is_deterministic():
    a = TStub(dim=8, input_size=32, seed=9, device="cpu")._w
    b = TStub(dim=8, input_size=32, seed=9, device="cpu")._w
    assert torch.equal(a, b)
    e1 = teff.EfficientNetEmbedder(dim=8, input_size=32, seed=4, device="cpu")
    e2 = teff.EfficientNetEmbedder(dim=8, input_size=32, seed=4, device="cpu")
    for (k, v), (_, w) in zip(e1.module.state_dict().items(), e2.module.state_dict().items()):
        assert torch.equal(v, w), k


def test_cuda_device_is_never_a_silent_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="cuda"):
        TStub(dim=8, input_size=32, device="cuda")
