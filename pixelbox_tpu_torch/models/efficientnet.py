"""EfficientNet-B0 embedder in PyTorch — the reference's flagship model.

``torchvision.efficientnet_b0().features`` + AdaptiveAvgPool2d + Flatten +
Linear(1280→latent) + Tanh (reference resources/train.py:30-46), at
224×224 (src/image_hashes/efficientnet.rs:6-8).  The modules follow
torchvision's layout, so a torchvision/reference ``state_dict`` loads
with a key rename only (:func:`params_from_torch_state_dict`); the JAX
package's Flax variables and ``.npz`` checkpoints load through
:func:`params_from_jax` / :func:`load_params`, with numpy alone.

``embed_preprocessed`` keeps the JAX layout (NHWC f32 in, [B, dim] out)
and converts to NCHW internally.  The convolutions are plain
``torch.nn.functional.conv2d`` (cuDNN on the card) — the JAX package left
them to XLA too.  On the card, TF32 must be off and cuDNN deterministic
(utils/device.hold_exact_numerics) for the exact-0.0 self-match.

Blocks (torchvision B0): stem conv3x3 s2 →
MBConv[t,c,n,s,k]: (1,16,1,1,3) (6,24,2,2,3) (6,40,2,2,5) (6,80,3,2,3)
(6,112,3,1,5) (6,192,4,2,5) (6,320,1,1,3) → head conv1x1 1280.
Squeeze-excitation reduces to max(1, block_input_channels//4).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from pixelbox_tpu_torch.models.base import Embedder
from pixelbox_tpu_torch.models.registry import register_embedder
from pixelbox_tpu_torch.utils.device import resolve_device

# (expand_ratio, out_channels, num_blocks, stride, kernel)
B0_CONFIG: Sequence[Tuple[int, int, int, int, int]] = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)
STEM_CHANNELS = 32
HEAD_CHANNELS = 1280
BN_EPS = 1e-3  # torchvision BatchNorm2d eps for EfficientNet


class ConvBNAct(nn.Sequential):
    """conv (no bias, symmetric k//2 padding) → BatchNorm → SiLU."""

    def __init__(self, cin, cout, kernel=3, stride=1, groups=1, act=True):
        layers = [
            nn.Conv2d(cin, cout, kernel, stride, kernel // 2, groups=groups, bias=False),
            nn.BatchNorm2d(cout, eps=BN_EPS),
        ]
        if act:
            layers.append(nn.SiLU())
        super().__init__(*layers)


class SqueezeExcite(nn.Module):
    def __init__(self, channels: int, squeeze_channels: int):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, squeeze_channels, 1)
        self.fc2 = nn.Conv2d(squeeze_channels, channels, 1)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        s = torch.sigmoid(self.fc2(nn.functional.silu(self.fc1(s))))
        return x * s


class MBConv(nn.Module):
    def __init__(self, cin, cout, expand_ratio, stride, kernel):
        super().__init__()
        expanded = cin * expand_ratio
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNAct(cin, expanded, kernel=1))
        layers.append(
            ConvBNAct(expanded, expanded, kernel=kernel, stride=stride, groups=expanded)
        )
        layers.append(SqueezeExcite(expanded, max(1, cin // 4)))
        layers.append(ConvBNAct(expanded, cout, kernel=1, act=False))
        self.block = nn.Sequential(*layers)
        self.residual = stride == 1 and cin == cout

    def forward(self, x):
        # Stochastic depth is identity at inference.
        y = self.block(x)
        return y + x if self.residual else y


def _features() -> nn.Sequential:
    """The `features` tower (train.py:31-36), torchvision indices 0..8."""
    layers = [ConvBNAct(3, STEM_CHANNELS, kernel=3, stride=2)]
    in_ch = STEM_CHANNELS
    for t, c, n, s, k in B0_CONFIG:
        blocks = []
        for block_idx in range(n):
            blocks.append(MBConv(in_ch, c, t, s if block_idx == 0 else 1, k))
            in_ch = c
        layers.append(nn.Sequential(*blocks))
    layers.append(ConvBNAct(in_ch, HEAD_CHANNELS, kernel=1))
    return nn.Sequential(*layers)


class EfficientNetEmbedderModule(nn.Module):
    """features → global avg pool → Linear(1280, latent) → tanh
    (train.py:37-46).  NCHW in."""

    def __init__(self, latent_dim: int = 8):
        super().__init__()
        self.features = _features()
        self.linear = nn.Linear(HEAD_CHANNELS, latent_dim)

    def forward(self, x):
        x = self.features(x)
        x = x.mean(dim=(2, 3))  # AdaptiveAvgPool2d(1) + Flatten
        return torch.tanh(self.linear(x))


def _seeded_init(module: nn.Module, seed: int) -> None:
    """Seeded init from a ``torch.Generator`` (fan-in normal weights, unit
    BN scales, zero biases).  Not the JAX package's init: the two
    frameworks draw different numbers from one seed, so only checkpointed
    weights are interchangeable between the packages."""
    g = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.ndim > 1:
                fan_in = math.prod(p.shape[1:])
                p.copy_(torch.randn(p.shape, generator=g) / math.sqrt(fan_in))
            elif name.endswith("weight"):
                p.fill_(1.0)
            else:
                p.zero_()


@register_embedder("efficientnet")
class EfficientNetEmbedder(Embedder):
    """Batched EfficientNet-B0 embedder.

    ``params`` is a state_dict of this module's layout; without it,
    ``checkpoint_path`` (a JAX-package ``.npz``) is loaded, and without
    that the weights are seeded from ``seed``.
    """

    def __init__(
        self,
        dim: int = 8,
        input_size: int = 224,
        params: Optional[dict] = None,
        seed: int = 0,
        checkpoint_path: Optional[str] = None,
        device="cuda",
    ):
        self.dim = int(dim)
        self.input_size = int(input_size)
        self.device = resolve_device(device)
        self.module = EfficientNetEmbedderModule(latent_dim=self.dim)
        if params is None and checkpoint_path:
            if checkpoint_path.endswith(".onnx"):
                raise NotImplementedError(
                    "ONNX checkpoints are not yet ported to pixelbox_tpu_torch; "
                    "convert with pixelbox_tpu.models.efficientnet.save_params"
                )
            params = load_params(checkpoint_path)
        if params is None:
            _seeded_init(self.module, seed)
        else:
            self.module.load_state_dict(
                {k: torch.as_tensor(np.array(v)) for k, v in params.items()}
            )
        self.module.eval().to(self.device)

    @torch.no_grad()
    def embed_preprocessed(self, batch) -> torch.Tensor:
        x = torch.as_tensor(batch, dtype=torch.float32, device=self.device)
        return self.module(x.permute(0, 3, 1, 2).contiguous())


# --------------------------------------------------------------------- #
# Weight import: JAX package (Flax variables / .npz) and torch layouts


def _bn_entries(prefix: str, scale, bias, mean, var) -> dict:
    return {
        f"{prefix}.weight": np.asarray(scale, np.float32),
        f"{prefix}.bias": np.asarray(bias, np.float32),
        f"{prefix}.running_mean": np.asarray(mean, np.float32),
        f"{prefix}.running_var": np.asarray(var, np.float32),
        f"{prefix}.num_batches_tracked": np.zeros((), np.int64),
    }


def _hwio_to_oihw(k) -> np.ndarray:
    # Flax conv kernels are HWIO (depthwise: (k, k, 1, C)); torch wants
    # OIHW (depthwise: (C, 1, k, k)) — the same transpose for both.
    return np.ascontiguousarray(np.transpose(np.asarray(k, np.float32), (3, 2, 0, 1)))


def params_from_jax(variables) -> dict:
    """The JAX package's Flax variables (nested dicts of arrays, as
    ``pixelbox_tpu.models.efficientnet`` builds them) → this module's
    ``state_dict`` (numpy values): HWIO → OIHW, depthwise (k,k,1,C) →
    (C,1,k,k), Dense (1280, d) → (d, 1280), BN scale/bias/mean/var."""
    p = variables["params"]
    bs = variables["batch_stats"]
    sd: dict = {}

    def convbn(src_p, src_s, dst):
        sd[f"{dst}.0.weight"] = _hwio_to_oihw(src_p["conv"]["kernel"])
        sd.update(_bn_entries(
            f"{dst}.1", src_p["bn"]["scale"], src_p["bn"]["bias"],
            src_s["bn"]["mean"], src_s["bn"]["var"],
        ))

    fp, fs = p["features"], bs["features"]
    convbn(fp["stem"], fs["stem"], "features.0")
    for stage_idx, (t, c, n, s, k) in enumerate(B0_CONFIG):
        for block_idx in range(n):
            name = f"stage{stage_idx}_block{block_idx}"
            bp, bst = fp[name], fs[name]
            dst = f"features.{stage_idx + 1}.{block_idx}.block"
            layer = 0
            if t != 1:
                convbn(bp["expand"], bst["expand"], f"{dst}.{layer}")
                layer += 1
            convbn(bp["depthwise"], bst["depthwise"], f"{dst}.{layer}")
            layer += 1
            for fc in ("fc1", "fc2"):
                sd[f"{dst}.{layer}.{fc}.weight"] = _hwio_to_oihw(bp["se"][fc]["kernel"])
                sd[f"{dst}.{layer}.{fc}.bias"] = np.asarray(bp["se"][fc]["bias"], np.float32)
            layer += 1
            convbn(bp["project"], bst["project"], f"{dst}.{layer}")
    convbn(fp["head"], fs["head"], "features.8")
    sd["linear.weight"] = np.ascontiguousarray(np.asarray(p["linear"]["kernel"], np.float32).T)
    sd["linear.bias"] = np.asarray(p["linear"]["bias"], np.float32)
    return sd


def load_params(path: str) -> dict:
    """Read the JAX package's ``.npz`` checkpoint (``save_params``: flattened
    ``params/...`` and ``batch_stats/...`` keys) with numpy alone → this
    module's state_dict."""
    nested: dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = nested
            *parts, leaf = key.split("/")
            for part in parts:
                node = node.setdefault(part, {})
            node[leaf] = np.asarray(z[key])
    return params_from_jax(nested)


def seeded_state_dict(latent_dim: int = 8, seed: int = 0, input_size: int = 64) -> dict:
    """Seeded weights in this module's (torchvision) layout, drawn with
    numpy so both packages can load the same tensors: fan-in normal
    conv/linear weights and small random SE/head biases.  The BN running
    statistics are then calibrated on one seeded batch of random
    ``input_size``² images, from smooth to pixel noise (one train-mode
    forward on the CPU), which keeps the activations of an untrained
    16-block tower at unit scale instead of vanishing or exploding.  For
    tests and smoke runs at full B0 geometry; no trained weights ship
    with the repository."""
    rng = np.random.default_rng(seed)
    module = EfficientNetEmbedderModule(latent_dim=latent_dim)
    sd: dict = {}
    for name, t in module.state_dict().items():
        shape = tuple(t.shape)
        if name.endswith("num_batches_tracked"):
            sd[name] = np.zeros((), np.int64)
        elif name.endswith("running_var") or (len(shape) == 1 and ".1.weight" in name):
            sd[name] = np.ones(shape, np.float32)
        elif len(shape) > 1:
            fan_in = math.prod(shape[1:])
            sd[name] = (rng.normal(size=shape) / math.sqrt(fan_in)).astype(np.float32)
        elif ".fc" in name or name.startswith("linear"):
            sd[name] = (0.1 * rng.normal(size=shape)).astype(np.float32)
        else:
            sd[name] = np.zeros(shape, np.float32)
    module.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    for m in module.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.momentum = None  # cumulative: one batch → its statistics
    calib = torch.cat([
        nn.functional.interpolate(
            torch.from_numpy(rng.uniform(0, 1, size=(2, 3, g, g)).astype(np.float32)),
            size=(input_size, input_size), mode="bilinear", align_corners=False,
        )
        for g in (4, 16, input_size)
    ])
    module.train()
    with torch.no_grad():
        module(calib)
    return {
        k: (np.zeros((), np.int64) if k.endswith("num_batches_tracked") else v.numpy().copy())
        for k, v in module.state_dict().items()
    }


def save_params(state_dict, path: str) -> None:
    """Write this module's state_dict as the JAX package's ``.npz``
    checkpoint (the inverse of :func:`load_params`), so one file loads in
    both packages."""
    sd = {k: np.asarray(v) for k, v in state_dict.items()}
    flat: dict = {}

    def convbn(src, dst):
        flat[f"params/{dst}/conv/kernel"] = np.transpose(sd[f"{src}.0.weight"], (2, 3, 1, 0))
        flat[f"params/{dst}/bn/scale"] = sd[f"{src}.1.weight"]
        flat[f"params/{dst}/bn/bias"] = sd[f"{src}.1.bias"]
        flat[f"batch_stats/{dst}/bn/mean"] = sd[f"{src}.1.running_mean"]
        flat[f"batch_stats/{dst}/bn/var"] = sd[f"{src}.1.running_var"]

    convbn("features.0", "features/stem")
    for stage_idx, (t, c, n, s, k) in enumerate(B0_CONFIG):
        for block_idx in range(n):
            src = f"features.{stage_idx + 1}.{block_idx}.block"
            dst = f"features/stage{stage_idx}_block{block_idx}"
            layer = 0
            if t != 1:
                convbn(f"{src}.{layer}", f"{dst}/expand")
                layer += 1
            convbn(f"{src}.{layer}", f"{dst}/depthwise")
            layer += 1
            for fc in ("fc1", "fc2"):
                flat[f"params/{dst}/se/{fc}/kernel"] = np.transpose(
                    sd[f"{src}.{layer}.{fc}.weight"], (2, 3, 1, 0)
                )
                flat[f"params/{dst}/se/{fc}/bias"] = sd[f"{src}.{layer}.{fc}.bias"]
            layer += 1
            convbn(f"{src}.{layer}", f"{dst}/project")
    convbn("features.8", "features/head")
    flat["params/linear/kernel"] = np.transpose(sd["linear.weight"])
    flat["params/linear/bias"] = sd["linear.bias"]
    np.savez_compressed(path, **{k: np.ascontiguousarray(v) for k, v in flat.items()})


def params_from_torch_state_dict(state_dict, latent_dim: int = 8) -> dict:
    """A torch state_dict of the reference's model (train.py:30-46:
    Sequential[features, pool, flatten, linear, tanh], features at ``0.``
    and the linear head at ``3.``), of torchvision's ``efficientnet_b0()``
    (``features.``), or of this module → this module's state_dict.

    Without a trained head (a bare torchvision checkpoint) the head is
    drawn like the JAX importer does: normal(0, 0.02) from numpy seed 0.
    """
    sd = {
        k: np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v)
        for k, v in state_dict.items()
    }
    out: dict = {}
    for k, v in sd.items():
        if k.startswith("features."):
            out[k] = v
        elif k.startswith("0."):
            out["features." + k[2:]] = v
    for k in list(out):
        if k.endswith(".running_var"):
            out.setdefault(k[: -len("running_var")] + "num_batches_tracked",
                           np.zeros((), np.int64))
    if "3.weight" in sd:
        out["linear.weight"] = sd["3.weight"]
        out["linear.bias"] = sd["3.bias"]
    elif "linear.weight" in sd:  # this module's own layout
        out["linear.weight"] = sd["linear.weight"]
        out["linear.bias"] = sd["linear.bias"]
    elif "classifier.1.weight" in sd and sd["classifier.1.weight"].shape[0] == latent_dim:
        out["linear.weight"] = sd["classifier.1.weight"]
        out["linear.bias"] = sd["classifier.1.bias"]
    else:
        rng = np.random.default_rng(0)
        kernel = rng.normal(0, 0.02, (HEAD_CHANNELS, latent_dim)).astype(np.float32)
        out["linear.weight"] = np.ascontiguousarray(kernel.T)
        out["linear.bias"] = np.zeros(latent_dim, np.float32)
    return out
