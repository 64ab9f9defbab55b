"""Whisper model configuration registry.

Shapes mirror the hparams of the reference implementation
(whisper.cpp:522-550 ``whisper_hparams``
defaults; model-size inference from ``n_audio_layer`` at whisper.cpp:1142-1164;
large-v3 detection via ``n_vocab == 51866`` at whisper.cpp:1161-1163).

The registry is the explicit replacement for the reference's implicit
"infer model type from layer count" scheme: every known OpenAI Whisper
checkpoint family gets an explicit, immutable config.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

SAMPLE_RATE = 16_000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_SECONDS = 30
CHUNK_FRAMES = CHUNK_SECONDS * SAMPLE_RATE // HOP_LENGTH  # 3000 mel frames / window
N_AUDIO_CTX = 1500  # CHUNK_FRAMES / 2 (conv stem stride 2)
N_TEXT_CTX = 448

# Maximum number of concurrently live decode hypotheses (greedy best_of or
# beam width).  Mirrors WHISPER_MAX_DECODERS (whisper.cpp:148).
MAX_DECODERS = 8


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    """Static hyper-parameters of one Whisper checkpoint."""

    name: str
    n_vocab: int
    n_audio_ctx: int
    n_audio_state: int
    n_audio_head: int
    n_audio_layer: int
    n_text_ctx: int
    n_text_state: int
    n_text_head: int
    n_text_layer: int
    n_mels: int

    @property
    def is_multilingual(self) -> bool:
        # whisper.cpp:387-389
        return self.n_vocab >= 51865

    @property
    def num_languages(self) -> int:
        # whisper.cpp:391-393
        return self.n_vocab - 51765 - (1 if self.is_multilingual else 0)

    @property
    def head_dim(self) -> int:
        return self.n_audio_state // self.n_audio_head

    # ---- special token ids (whisper.cpp:365-394 + multilingual offset
    # shifting at whisper.cpp:1242-1256) -------------------------------------
    @property
    def token_eot(self) -> int:
        return 50256 + (1 if self.is_multilingual else 0)

    @property
    def token_sot(self) -> int:
        return 50257 + (1 if self.is_multilingual else 0)

    @property
    def _dt(self) -> int:
        return self.num_languages - 98 if self.is_multilingual else 0

    @property
    def token_translate(self) -> int:
        return 50357 + self._dt

    @property
    def token_transcribe(self) -> int:
        return 50358 + self._dt

    @property
    def token_solm(self) -> int:
        return 50359 + self._dt

    @property
    def token_prev(self) -> int:
        return 50360 + self._dt

    @property
    def token_nosp(self) -> int:
        return 50361 + self._dt

    @property
    def token_not(self) -> int:
        return 50362 + self._dt

    @property
    def token_beg(self) -> int:
        return 50363 + self._dt

    def token_lang(self, lang_id: int) -> int:
        """Token id for a language token (whisper.cpp:3667-3669)."""
        return self.token_sot + 1 + lang_id

    @property
    def is_distil(self) -> bool:
        # Distilled models require no_timestamps (whisper.cpp:5119-5125).
        return self.n_text_layer == 2

    def replace(self, **kw) -> "WhisperConfig":
        return dataclasses.replace(self, **kw)


def _cfg(name, state, head, layer, *, n_vocab=51865, n_mels=80,
         text_layer=None) -> WhisperConfig:
    return WhisperConfig(
        name=name,
        n_vocab=n_vocab,
        n_audio_ctx=N_AUDIO_CTX,
        n_audio_state=state,
        n_audio_head=head,
        n_audio_layer=layer,
        n_text_ctx=N_TEXT_CTX,
        n_text_state=state,
        n_text_head=head,
        n_text_layer=layer if text_layer is None else text_layer,
        n_mels=n_mels,
    )


# The canonical family (shapes per whisper.cpp:537-550 and the OpenAI
# Whisper release).  ".en" variants are English-only (n_vocab 51864).
CONFIGS = {
    "tiny": _cfg("tiny", 384, 6, 4),
    "tiny.en": _cfg("tiny.en", 384, 6, 4, n_vocab=51864),
    "base": _cfg("base", 512, 8, 6),
    "base.en": _cfg("base.en", 512, 8, 6, n_vocab=51864),
    "small": _cfg("small", 768, 12, 12),
    "small.en": _cfg("small.en", 768, 12, 12, n_vocab=51864),
    "medium": _cfg("medium", 1024, 16, 24),
    "medium.en": _cfg("medium.en", 1024, 16, 24, n_vocab=51864),
    "large": _cfg("large", 1280, 20, 32),
    "large-v1": _cfg("large-v1", 1280, 20, 32),
    "large-v2": _cfg("large-v2", 1280, 20, 32),
    "large-v3": _cfg("large-v3", 1280, 20, 32, n_vocab=51866, n_mels=128),
    "large-v3-turbo": _cfg("large-v3-turbo", 1280, 20, 32, n_vocab=51866,
                           n_mels=128, text_layer=4),
    "distil-large-v3": _cfg("distil-large-v3", 1280, 20, 32, n_vocab=51866,
                            n_mels=128, text_layer=2),
}


def get_config(name: str) -> WhisperConfig:
    try:
        return CONFIGS[name]
    except KeyError:
        raise ValueError(
            f"unknown model {name!r}; known: {sorted(CONFIGS)}") from None


def config_from_hparams(
    n_vocab: int,
    n_audio_ctx: int,
    n_audio_state: int,
    n_audio_head: int,
    n_audio_layer: int,
    n_text_ctx: int,
    n_text_state: int,
    n_text_head: int,
    n_text_layer: int,
    n_mels: int,
) -> WhisperConfig:
    """Build a config from raw checkpoint hparams (whisper.cpp:1126-1164).

    Model name is inferred from n_audio_layer (4/6/12/24/32) with the v3
    refinement via n_vocab == 51866, matching the reference's detection.
    """
    size = {4: "tiny", 6: "base", 12: "small", 24: "medium", 32: "large"}.get(
        n_audio_layer, "custom")
    if size == "large" and n_vocab == 51866:
        size = "large-v3"
    if n_vocab == 51864 and size not in ("custom",):
        size = size + ".en"
    return WhisperConfig(
        name=size,
        n_vocab=n_vocab,
        n_audio_ctx=n_audio_ctx,
        n_audio_state=n_audio_state,
        n_audio_head=n_audio_head,
        n_audio_layer=n_audio_layer,
        n_text_ctx=n_text_ctx,
        n_text_state=n_text_state,
        n_text_head=n_text_head,
        n_text_layer=n_text_layer,
        n_mels=n_mels,
    )
