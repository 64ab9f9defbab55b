"""godot_whisper_tpu_torch — the PyTorch / CUDA port of godot_whisper_tpu.

The JAX package beside it is the reference; this package keeps its module
names and public layouts, imports neither JAX nor the JAX package, and
runs its hot kernels as hand-written CUDA for Hopper (``csrc/``, built with
``nvcc`` at first use).  Entry points run on the card (``cuda``) unless the
caller passes ``device="cpu"``; on the CPU every kernel wrapper takes its
plain PyTorch version.

Quick start::

    import godot_whisper_tpu_torch as gwt
    ctx = gwt.WhisperContext.from_file("ggml-tiny.en.bin")   # on cuda
    segments = ctx.full(gwt.TranscribeParams(), samples)
    print(ctx.text())

``from_file`` / ``from_buffer`` read a ggml checkpoint, ``from_hf`` a local
HuggingFace snapshot, ``synthetic`` makes random weights; every constructor
takes ``device=`` ("cpu" runs the plain versions).  The file CLI is
``python -m godot_whisper_tpu_torch.cli.main``.

Quantized decoding: ``synthetic(..., quantize="int8" | "int4" |
"int8_embed")`` (or ``from_params``) stores the decoder weights in 8 or 4
bits, and ``TranscribeParams(cross_kv_int8=True)`` the cross-attention K/V
in 8 bits.

Multiple devices: every constructor takes ``mesh=`` (a ``parallel.sharding.
Mesh`` from ``parallel.dist.stream_mesh`` after ``parallel.dist.
initialize``, one process per device); the context then holds this rank's
tensor-parallel slices and every rank of the tp group runs the same calls.
``parallel.dist.MultiHostBatchTranscriber`` batches clips data-parallel
across processes, and ``models.training.train_step(..., mesh=)`` trains on
a dp x tp mesh.

Serving: ``parallel.batch.BatchTranscriber`` decodes many clips as one
batch of streams, ``full_parallel`` splits one clip into chunks decoded
together, ``runtime.streaming.StreamingTranscriber`` transcribes audio
pushed in real time, and ``runtime.speech_to_text.SpeechToText`` is the
Godot node's surface; the CLIs are ``cli.main``, ``cli.batch``,
``cli.serve`` and ``cli.stream``.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from .audio.mel import mel_filterbank
from .audio.tokenizer import Tokenizer, synthetic_vocab
from .decode.language import lang_id, lang_max_id, lang_str, lang_str_full
from .decode.loop import Segment, TokenData, WhisperPipeline
from .decode.params import (SamplingStrategy, TranscribeParams, beam_params,
                            greedy_params)
from .models import loader_ggml
from .models.config import (CONFIGS, MAX_DECODERS, SAMPLE_RATE, WhisperConfig,
                            get_config)
from .models.params import init_params, params_from_raw
from .runtime.device import resolve_device

__version__ = "0.1.0"

__all__ = [
    "WhisperContext", "WhisperConfig", "TranscribeParams",
    "SamplingStrategy", "Segment", "TokenData", "get_config", "CONFIGS",
    "init_params", "greedy_params", "beam_params", "lang_id", "lang_str",
    "lang_str_full", "lang_max_id", "SAMPLE_RATE", "MAX_DECODERS",
]


class WhisperContext:
    """A loaded model + decode state (``whisper_context`` + its default
    ``whisper_state``)."""

    def __init__(self, pipeline: WhisperPipeline):
        self._p = pipeline
        self._decode_state = None  # (KVCache, n_past) of ``decode``

    # ------------------------------------------------------------ constructors
    @classmethod
    def from_params(cls, config: WhisperConfig, params, *, device=None,
                    tokenizer: Optional[Tokenizer] = None,
                    mel_filters: Optional[np.ndarray] = None,
                    n_loaded: int = 1,
                    quantize: Optional[str] = None,
                    mesh=None) -> "WhisperContext":
        """Wrap a parameter tree (``models.params`` layout) in a context on
        ``device``, its decoder quantized as ``quantize`` asks (see
        ``_quantize``).  The tokenizer defaults to the synthetic vocab and
        the filterbank to the Slaney mel filters.  With a ``mesh`` the full
        tree is quantized, then sharded to this rank's slices
        (``parallel.sharding.shard_params``) on the mesh's device."""
        dev = _mesh_device(device, mesh)
        params = cls._quantize({k: _to_device(v, dev)
                                for k, v in params.items()}, quantize)
        tp = None
        if mesh is not None:
            from .parallel.sharding import shard_params
            params = shard_params(params, mesh, config)
            tp = mesh.tp_group
        tok = tokenizer or Tokenizer(config, synthetic_vocab(config))
        filters = (mel_filters if mel_filters is not None
                   else mel_filterbank(config.n_mels))
        return cls(WhisperPipeline(config, params, tok, filters,
                                   n_loaded=n_loaded, device=dev, tp=tp))

    @classmethod
    def from_file(cls, path: str, *, compute_dtype=None,
                  quantize: Optional[str] = None,
                  device=None, mesh=None) -> "WhisperContext":
        """Load a ggml .bin checkpoint (whisper_init_from_file) onto
        ``device`` in ``compute_dtype``, quantized as ``quantize`` asks
        (sharded over ``mesh``, see ``from_params``)."""
        return cls._from_raw(loader_ggml.read_checkpoint(path),
                             compute_dtype, quantize, device, mesh)

    @classmethod
    def from_buffer(cls, buf: bytes, *, compute_dtype=None,
                    quantize: Optional[str] = None,
                    device=None, mesh=None) -> "WhisperContext":
        """Load an in-memory ggml model (whisper_init_from_buffer), the path
        godot-whisper takes for Godot resources."""
        return cls._from_raw(loader_ggml.read_checkpoint(bytes(buf)),
                             compute_dtype, quantize, device, mesh)

    @classmethod
    def _from_raw(cls, raw: loader_ggml.RawCheckpoint, compute_dtype,
                  quantize: Optional[str], device,
                  mesh=None) -> "WhisperContext":
        t0 = time.perf_counter()
        dev = _mesh_device(device, mesh)
        params = params_from_raw(raw, compute_dtype=_dtype(compute_dtype),
                                device=dev)
        ctx = cls.from_params(raw.config, params, device=dev,
                              tokenizer=Tokenizer(raw.config,
                                                  raw.vocab_tokens),
                              mel_filters=raw.mel_filters,
                              n_loaded=raw.n_loaded, quantize=quantize,
                              mesh=mesh)
        ctx.timings.t_load_us = int((time.perf_counter() - t0) * 1e6)
        return ctx

    @classmethod
    def from_hf(cls, path: str, *, compute_dtype=None,
                quantize: Optional[str] = None,
                device=None, mesh=None) -> "WhisperContext":
        """Load a local HuggingFace Whisper snapshot directory (synthetic
        vocab and Slaney filterbank, as the JAX package does)."""
        from .models.loader_hf import load_hf_checkpoint
        dev = _mesh_device(device, mesh)
        config, params = load_hf_checkpoint(
            path, compute_dtype=_dtype(compute_dtype), device=dev)
        return cls.from_params(config, params, device=dev, quantize=quantize,
                               mesh=mesh)

    @classmethod
    def synthetic(cls, name: str = "tiny.en", *, seed: int = 0,
                  compute_dtype=None, device=None,
                  quantize: Optional[str] = None,
                  mesh=None) -> "WhisperContext":
        """Random-weight model (the JAX package's ``init_params`` weights
        for the same seed) for benches and tests; no checkpoint needed."""
        dev = _mesh_device(device, mesh)
        config = get_config(name)
        params = init_params(config, seed=seed,
                             compute_dtype=_dtype(compute_dtype), device=dev)
        return cls.from_params(config, params, device=dev, quantize=quantize,
                               mesh=mesh)

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

    @property
    def tokenizer(self) -> Tokenizer:
        return self._p.tokenizer

    def is_multilingual(self) -> bool:
        return self._p.config.is_multilingual

    # ------------------------------------------------------------ transcription
    def full(self, params: Optional[TranscribeParams],
             samples: Optional[np.ndarray]) -> List[Segment]:
        """Mel + language detection + decode + segments (whisper_full,
        whisper.h:564-570); ``samples=None`` decodes the mel set last
        (``set_mel``, or the pipeline's ``set_mel_device``)."""
        return self._p.full(params or TranscribeParams(), samples)

    def full_parallel(self, params: Optional[TranscribeParams],
                      samples: np.ndarray, n_processors: int) -> List[Segment]:
        """Chunked transcription (whisper_full_parallel,
        whisper.cpp:5817-5930): the chunks decode as one batch of streams
        (``parallel/chunked.py``)."""
        from .parallel.chunked import full_parallel
        return full_parallel(self._p, params or TranscribeParams(), samples,
                             n_processors)

    # ------------------------------------------------------------ result access
    def full_n_segments(self) -> int:
        return len(self._p.segments)

    def full_get_segment(self, i: int) -> Segment:
        return self._p.segments[i]

    def full_get_segment_text(self, i: int) -> str:
        return self._p.segments[i].text

    def full_get_segment_t0(self, i: int) -> int:
        return self._p.segments[i].t0

    def full_get_segment_t1(self, i: int) -> int:
        return self._p.segments[i].t1

    def full_n_tokens(self, i: int) -> int:
        return len(self._p.segments[i].tokens)

    def full_get_token_data(self, i: int, j: int) -> TokenData:
        return self._p.segments[i].tokens[j]

    def full_get_token_text(self, i: int, j: int) -> str:
        return self._p.tokenizer.token_str(self._p.segments[i].tokens[j].id)

    def text(self) -> str:
        """Concatenated transcript of all segments."""
        return "".join(s.text for s in self._p.segments)

    def full_lang_id(self) -> Optional[int]:
        return self._p.lang_id_detected

    # ----------------------------------------------------------------- stages
    def pcm_to_mel(self, samples: np.ndarray) -> np.ndarray:
        """Set the audio and return its mel (n_mels, n_len) on the host
        (whisper_pcm_to_mel)."""
        self._p.set_audio(samples)
        return self._p.mel_host()

    def set_mel(self, mel: np.ndarray) -> None:
        """Decode from an external mel (n_mels, n_len) (whisper_set_mel)."""
        self._p.set_mel(mel)

    def encode(self, seek: int = 0, audio_ctx: int = 0) -> torch.Tensor:
        """Stage-level encode (whisper_encode): the encoder output (1, T, S)
        of the window at ``seek``."""
        enc, _ = self._p.encode_window(seek, audio_ctx)
        return enc

    def lang_auto_detect(self, seek: int = 0):
        """(lang_id, probs) over the language set, from the audio set by the
        last ``full`` (whisper_lang_auto_detect)."""
        return self._p.detect_language(seek)

    def decode(self, tokens: Sequence[int], n_past: int = 0,
               seek: int = 0) -> np.ndarray:
        """Stage-level decode (whisper_decode, whisper.h:286-297): the
        decoder over ``tokens`` against the encoder output at ``seek``;
        returns the logits of the last token.  Needs audio or a mel set.

        The KV cache persists across calls as the reference's whisper_state
        does: ``decode(a, 0)`` then ``decode(b, len(a))`` equals
        ``decode(a + b, 0)``.  ``n_past=0`` starts a new cache; an
        ``n_past`` that does not continue the cached history raises."""
        from .models.model import (decoder_dense, init_kv_cache,
                                   param_compute_dtype)
        p = self._p
        _, xkv = p.encode_window(seek)
        toks = list(tokens)
        if n_past == 0 or self._decode_state is None:
            if n_past != 0:
                raise ValueError(
                    f"decode(n_past={n_past}) with no cached history: "
                    "start a sequence with n_past=0")
            kv = init_kv_cache(p.config, 1,
                               dtype=param_compute_dtype(p.params),
                               device=p.device, tp=p.tp)
        else:
            kv, cached_past = self._decode_state
            if cached_past != n_past:
                raise ValueError(
                    f"decode(n_past={n_past}) does not continue the "
                    f"cached history of {cached_past} tokens")
        T = len(toks)
        arr = torch.tensor([toks], dtype=torch.int32, device=p.device)
        positions = torch.arange(n_past, n_past + T, dtype=torch.int32,
                                 device=p.device)[None]
        logits, kv = decoder_dense(
            p.params, p.config, arr, positions, kv, xkv,
            n_valid=torch.full((1,), T, dtype=torch.int32, device=p.device),
            start=n_past, tp=p.tp)
        self._decode_state = (kv, n_past + T)
        return logits[0, -1].float().cpu().numpy()

    # ---------------------------------------------------------------- tokenize
    def tokenize(self, text: str) -> List[int]:
        return self._p.tokenizer.encode(text)

    def token_to_str(self, tid: int) -> str:
        return self._p.tokenizer.token_str(tid)

    # ----------------------------------------------------------------- timing
    def print_timings(self) -> None:
        print(self._p.timings.report())

    def reset_timings(self) -> None:
        self._p.timings.reset()


def _mesh_device(device, mesh) -> torch.device:
    """``device``, else the mesh's device, else the card."""
    return resolve_device(device if device is not None or mesh is None
                          else mesh.device)


def _dtype(compute_dtype):
    """The JAX package's rule: no compute dtype means bf16."""
    return torch.bfloat16 if compute_dtype is None else compute_dtype


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev)  # a tensor or a QuantTensor / Quant4Tensor
