"""godot_whisper_tpu_torch — the PyTorch / CUDA port of godot_whisper_tpu.

The JAX package beside it is the reference; this package keeps its module
names and public layouts, imports neither JAX nor the JAX package, and
runs its hot kernels as hand-written CUDA for Hopper (``csrc/``, built with
``nvcc`` at first use).  Entry points run on the card (``cuda``) unless the
caller passes ``device="cpu"``; on the CPU every kernel wrapper takes its
plain PyTorch version.

Quick start::

    import godot_whisper_tpu_torch as gwt
    ctx = gwt.WhisperContext.synthetic("tiny.en", seed=0)   # on cuda
    segments = ctx.full(gwt.TranscribeParams(), samples)
    print(ctx.text())

Quantized decoding: ``synthetic(..., quantize="int8" | "int4" |
"int8_embed")`` (or ``from_params``) stores the decoder weights in 8 or 4
bits, and ``TranscribeParams(cross_kv_int8=True)`` the cross-attention K/V
in 8 bits.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .audio.mel import mel_filterbank
from .audio.tokenizer import Tokenizer, synthetic_vocab
from .decode.loop import Segment, TokenData, WhisperPipeline
from .decode.params import SamplingStrategy, TranscribeParams
from .models.config import (CONFIGS, MAX_DECODERS, SAMPLE_RATE, WhisperConfig,
                            get_config)
from .models.params import init_params
from .runtime.device import resolve_device

__version__ = "0.1.0"

__all__ = [
    "WhisperContext", "WhisperConfig", "TranscribeParams",
    "SamplingStrategy", "Segment", "TokenData", "get_config", "CONFIGS",
    "init_params", "SAMPLE_RATE", "MAX_DECODERS",
]


class WhisperContext:
    """A loaded model + decode state (``whisper_context`` + its default
    ``whisper_state``)."""

    def __init__(self, pipeline: WhisperPipeline):
        self._p = pipeline

    # ------------------------------------------------------------ constructors
    @classmethod
    def from_params(cls, config: WhisperConfig, params, *, device=None,
                    tokenizer: Optional[Tokenizer] = None,
                    mel_filters: Optional[np.ndarray] = None,
                    n_loaded: int = 1,
                    quantize: Optional[str] = None) -> "WhisperContext":
        """Wrap a parameter tree (``models.params`` layout) in a context on
        ``device``, its decoder quantized as ``quantize`` asks (see
        ``_quantize``).  The tokenizer defaults to the synthetic vocab and
        the filterbank to the Slaney mel filters."""
        dev = resolve_device(device)
        params = cls._quantize({k: _to_device(v, dev)
                                for k, v in params.items()}, quantize)
        tok = tokenizer or Tokenizer(config, synthetic_vocab(config))
        filters = (mel_filters if mel_filters is not None
                   else mel_filterbank(config.n_mels))
        return cls(WhisperPipeline(config, params, tok, filters,
                                   n_loaded=n_loaded, device=dev))

    @classmethod
    def synthetic(cls, name: str = "tiny.en", *, seed: int = 0,
                  compute_dtype=torch.bfloat16, device=None,
                  quantize: Optional[str] = None) -> "WhisperContext":
        """Random-weight model (the JAX package's ``init_params`` weights
        for the same seed) for benches and tests; no checkpoint needed."""
        dev = resolve_device(device)
        config = get_config(name)
        params = init_params(config, seed=seed, compute_dtype=compute_dtype,
                             device=dev)
        return cls.from_params(config, params, device=dev, quantize=quantize)

    @staticmethod
    def _quantize(params, quantize: Optional[str]):
        """The JAX package's modes: "int8" (decoder weights and token
        embedding int8), "int4" (decoder weights int4, embedding int8),
        "int8_embed" (the token embedding only); None keeps the tree."""
        if quantize in (None, "", "none"):
            return params
        from .models import quant
        if quantize in ("int8", "q8", "q8_0"):
            return quant.quantize_decoder_int8(params)
        if quantize in ("int4", "q4", "q4_0"):
            return quant.quantize_decoder_int4(params)
        if quantize in ("int8_embed", "q8_embed"):
            return quant.quantize_embed_int8(params)
        raise ValueError(f"unknown quantize mode {quantize!r} "
                         "(supported: 'int8', 'int4', 'int8_embed')")

    # ----------------------------------------------------------------- basics
    @property
    def config(self) -> WhisperConfig:
        return self._p.config

    @property
    def pipeline(self) -> WhisperPipeline:
        return self._p

    @property
    def timings(self):
        return self._p.timings

    # ------------------------------------------------------------ transcription
    def full(self, params: Optional[TranscribeParams],
             samples: np.ndarray) -> List[Segment]:
        """Mel + decode + segments (whisper_full, whisper.h:564-570)."""
        return self._p.full(params or TranscribeParams(), samples)

    def text(self) -> str:
        """Concatenated transcript of all segments."""
        return "".join(s.text for s in self._p.segments)


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev)  # a tensor or a QuantTensor / Quant4Tensor
