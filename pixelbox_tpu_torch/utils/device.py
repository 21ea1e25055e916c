"""Device selection and the numerics the port holds on the card.

The port never picks the CPU silently: a caller names its device, and
asking for ``cuda`` where no card is visible raises.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``"cuda"`` / ``"cuda:1"`` / ``"cpu"`` / a torch.device → torch.device.

    Raises RuntimeError for a CUDA device when no card is visible."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but torch.cuda.is_available() "
                "is False (pass --device cpu / device='cpu' to run on the CPU)"
            )
        hold_exact_numerics()
    return dev


def hold_exact_numerics() -> None:
    """Full-f32 matmuls and convolutions with deterministic algorithm
    choice.  cuDNN's TF32 is on by default and keeps ~3 decimal digits;
    benchmark mode may pick a different algorithm for the ingest batch
    and for the query's replay of that batch shape, which would break the
    exact-0.0 self-match (Engine._embed_query_ingest_exact)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
