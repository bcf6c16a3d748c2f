"""The port's device rule: CUDA unless the caller names another device."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means CUDA. Raises when CUDA is
    asked for (explicitly or by default) and no CUDA device is present —
    the port never drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "lighthouse_tpu_torch: CUDA is not available; pass device='cpu' "
            "to run on the CPU explicitly"
        )
    return dev
