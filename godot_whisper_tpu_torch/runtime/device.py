"""Device choice of the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; a missing card raises, never falls back.
    A CUDA device without an index gets the current one, so that the
    tensors a context makes from another thread (the streaming scheduler,
    the server's threads) land on the context's card; the kernel wrappers
    launch on their tensors' card (``ops/kernels.py::launch``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "godot_whisper_tpu_torch runs on a CUDA device; none is "
                "available (pass device='cpu' to run the plain PyTorch "
                "versions of the kernels)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev

