"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``, a CUDA one with its index
    (``"cuda"`` is the current card).  A CUDA device without a usable GPU
    raises instead of quietly running on the CPU."""
    d = torch.device(device)
    if d.type != "cuda":
        return d
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(d)!r} requested but no CUDA GPU is available; "
            "pass device='cpu' to run on the CPU")
    return d if d.index is not None \
        else torch.device("cuda", torch.cuda.current_device())
