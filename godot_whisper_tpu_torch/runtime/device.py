"""Device choice of the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; a missing card raises, never falls back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("godot_whisper_tpu_torch runs on a CUDA device; "
                           "none is available (pass device='cpu' to run the "
                           "plain PyTorch versions of the kernels)")
    return dev
