"""pixelbox_tpu_torch — the PyTorch + CUDA port of pixelbox_tpu.

The JAX package (``pixelbox_tpu``) stays the reference; this package keeps
its module names so every counterpart sits at the same relative path, and
its results are held bit-identical to the reference's on the CPU
(``tests/test_torch_port_*.py``).  It imports ``torch`` and never ``jax``.

The main path is the reference's core loop:

    decode → 224² cover-resize → EfficientNet-B0 → tanh → u8 quantize →
    packed index → guaranteed-exact cosine top-k → Engine.index / similar

Host-only modules (catalog, query language, decode, thumbnail, resample,
oracle) are copies of the reference's with renamed imports, so a library
written by either package opens in the other.  The scan kernels live in
``csrc/`` (CUDA C++ for Hopper) behind ``ops/fused_scan.py``; every
kernel has a plain PyTorch version in the same module, used for CPU
tensors.  Devices are explicit: ``Engine(device=...)``,
``VectorStore(device=...)``, the embedders' ``device=``, and the CLI's
``--device`` (default ``cuda``).
"""

from pixelbox_tpu_torch.version import __version__


def __getattr__(name):
    # Lazy: Engine pulls in sqlite3/ingest machinery.
    if name == "Engine":
        from pixelbox_tpu_torch.engine import Engine

        return Engine
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["__version__", "Engine"]
