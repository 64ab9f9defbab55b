"""Transcription parameters, mirroring ``whisper_full_params``.

Field-for-field port of the 40+-field params struct and its canonical
defaults (whisper.h:433-526, defaults
at whisper.cpp:4311-4410).  Callback fields keep their roles; thread-count
fields are dropped (the device runtime owns scheduling).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, List, Optional, Sequence


class SamplingStrategy(enum.Enum):
    GREEDY = 0        # WHISPER_SAMPLING_GREEDY
    BEAM_SEARCH = 1   # WHISPER_SAMPLING_BEAM_SEARCH


@dataclasses.dataclass
class TranscribeParams:
    """Defaults follow whisper_full_default_params (whisper.cpp:4311-4410)."""

    strategy: SamplingStrategy = SamplingStrategy.GREEDY

    n_max_text_ctx: int = 16384
    offset_ms: int = 0
    duration_ms: int = 0

    translate: bool = False
    no_context: bool = True
    no_timestamps: bool = False
    single_segment: bool = False
    print_special: bool = False
    print_progress: bool = False
    print_realtime: bool = False
    print_timestamps: bool = True

    # token-level timestamps (whisper.cpp:6315-6599)
    token_timestamps: bool = False
    thold_pt: float = 0.01
    thold_ptsum: float = 0.01
    max_len: int = 0
    split_on_word: bool = False
    max_tokens: int = 0

    audio_ctx: int = 0  # 0 = full n_audio_ctx; reduced for streaming speed

    # int8-quantized cross-attention KV (bandwidth optimization for
    # large models; see models/model.py QuantCrossKV).  Opt-in.
    cross_kv_int8: bool = False

    tdrz_enable: bool = False

    initial_prompt: Optional[str] = None
    prompt_tokens: Optional[Sequence[int]] = None

    language: Optional[str] = "en"
    detect_language: bool = False

    suppress_blank: bool = True
    suppress_non_speech_tokens: bool = False

    temperature: float = 0.0
    max_initial_ts: float = 1.0
    length_penalty: float = -1.0

    temperature_inc: float = 0.2
    entropy_thold: float = 2.4
    logprob_thold: float = -1.0
    no_speech_thold: float = 0.6  # reserved (not implemented upstream either)

    best_of: int = 5       # greedy.best_of
    beam_size: int = 5     # beam_search.beam_size
    patience: float = -1.0  # reserved, matching upstream

    # decode determinism: seeds the in-jit sampler (the reference seeds
    # per-decoder std::mt19937 with 0, whisper.cpp:3064,5066)
    seed: int = 0

    # callbacks
    new_segment_callback: Optional[Callable] = None
    progress_callback: Optional[Callable] = None
    encoder_begin_callback: Optional[Callable] = None
    abort_callback: Optional[Callable] = None
    logits_filter_callback: Optional[Callable] = None

    # grammar constraints (whisper.cpp:3875-4301)
    grammar_rules: Optional[object] = None
    i_start_rule: int = 0
    grammar_penalty: float = 100.0

    def temperatures(self) -> List[float]:
        """The fallback ladder [t0, t0+inc, ..., <= 1.0]
        (whisper.cpp:5023-5032)."""
        if self.temperature_inc > 0:
            out, t = [], self.temperature
            while t < 1.0 + 1e-6:
                out.append(round(t, 6))
                t += self.temperature_inc
            return out
        return [self.temperature]

    def n_decoders(self) -> int:
        """Max live decoders (whisper.cpp:5035-5048)."""
        if self.strategy == SamplingStrategy.GREEDY:
            n = self.best_of
        else:
            n = max(self.best_of, self.beam_size)
        return max(1, n)

    def n_decoders_at(self, temperature: float) -> int:
        """Live decoders at a given ladder temperature
        (whisper.cpp:5187-5206)."""
        if self.strategy == SamplingStrategy.GREEDY:
            n = self.best_of if temperature > 0 else 1
        else:
            n = self.best_of if temperature > 0 else self.beam_size
        return max(1, n)


def greedy_params(**kw) -> TranscribeParams:
    return TranscribeParams(strategy=SamplingStrategy.GREEDY, **kw)


def beam_params(**kw) -> TranscribeParams:
    return TranscribeParams(strategy=SamplingStrategy.BEAM_SEARCH, **kw)
