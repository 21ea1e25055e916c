"""Embedder registry: name → constructor."""

from __future__ import annotations

from typing import Callable, Dict

_REGISTRY: Dict[str, Callable] = {}


def register_embedder(name: str):
    def wrap(ctor):
        _REGISTRY[name] = ctor
        return ctor

    return wrap


def get_embedder(name: str, **kwargs):
    """Instantiate a registered embedder ('stub', 'efficientnet')."""
    # Import lazily so heavy models only load when requested.
    if name not in _REGISTRY:
        if name == "stub":
            import pixelbox_tpu_torch.models.stub  # noqa: F401
        elif name == "efficientnet":
            import pixelbox_tpu_torch.models.efficientnet  # noqa: F401
        elif name in ("blip", "onnx", "nomic"):
            raise NotImplementedError(
                f"embedder {name!r} is not yet ported to pixelbox_tpu_torch "
                "(ROADMAP.md, queue 1)"
            )
    if name not in _REGISTRY:
        raise KeyError(
            f"Unknown embedder {name!r}; known: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name](**kwargs)
