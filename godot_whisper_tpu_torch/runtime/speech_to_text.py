"""SpeechToText: the Godot node's surface, port of the JAX package's
``runtime/speech_to_text.py``.

The reference's ``SpeechToText : Node`` (godot-whisper
src/speech_to_text.h:103-168) is the app-facing object: language selection,
model loading, ``resample``, ``voice_activity_detection`` and
``transcribe(buffer, initial_prompt, audio_ctx)`` returning
``[full_text, token_dict...]``.  This class has that surface (Python types
instead of Godot Variants) on the port's pipeline, so a godot-whisper user
maps their node calls one to one.
"""

from __future__ import annotations

from typing import Any, List

import numpy as np

from ..audio.resample import Interpolator, mixdown, resample
from ..audio.vad import vad_simple
from ..decode.params import TranscribeParams
from ..models.config import SAMPLE_RATE
from .settings import get_setting


class SpeechToText:
    """Facade with the glue node's methods (src/speech_to_text.h:161-167)."""

    # interpolator enum re-export (src/speech_to_text.h:151-157)
    SRC_SINC_BEST_QUALITY = 0
    SRC_SINC_MEDIUM_QUALITY = 1
    SRC_SINC_FASTEST = 2
    SRC_ZERO_ORDER_HOLD = 3
    SRC_LINEAR = 4

    SPEECH_SETTING_SAMPLE_RATE = SAMPLE_RATE

    def __init__(self, ctx=None, *, mix_rate: int = 44100):
        self._ctx = ctx
        self.language = "en"
        self.mix_rate = mix_rate

    # ------------------------------------------------------------- language
    def set_language(self, language) -> None:
        """Accepts a code ("en") or the node's enum index."""
        if isinstance(language, int):
            from ..decode.language import lang_str
            self.language = lang_str(language) or "en"
        else:
            self.language = str(language)

    def get_language(self):
        return self.language

    # ---------------------------------------------------------------- model
    def set_language_model(self, model) -> None:
        """Load a model: path, bytes buffer, or an existing context
        (mirrors _load_model, src/speech_to_text.cpp:326-351)."""
        import godot_whisper_tpu_torch as gwt
        from .logging import log_info, system_info

        if isinstance(model, (bytes, bytearray)):
            self._ctx = gwt.WhisperContext.from_buffer(bytes(model))
        elif isinstance(model, str):
            self._ctx = gwt.WhisperContext.from_file(model)
        else:
            self._ctx = model
        log_info("system_info: %s", system_info())

    def get_language_model(self):
        return self._ctx

    # ---------------------------------------------------------------- audio
    def resample(self, buffer: np.ndarray,
                 interpolator: int = SRC_SINC_FASTEST) -> np.ndarray:
        """Stereo mixdown + mix_rate -> 16 kHz
        (SpeechToText::resample, src/speech_to_text.cpp:353-376)."""
        mono = mixdown(np.asarray(buffer, dtype=np.float32))
        if self.mix_rate == SAMPLE_RATE:
            return mono
        return resample(mono, self.mix_rate, SAMPLE_RATE,
                        Interpolator(interpolator))

    def voice_activity_detection(self, buffer: np.ndarray) -> bool:
        """(src/speech_to_text.cpp:378-399)."""
        return vad_simple(
            np.asarray(buffer, dtype=np.float32), SAMPLE_RATE, 1000,
            vad_thold=float(get_setting(
                "audio.input.transcribe.vad_threshold")),
            freq_thold=float(get_setting(
                "audio.input.transcribe.freq_threshold")))

    # ------------------------------------------------------------ transcribe
    def transcribe(self, buffer: np.ndarray, initial_prompt: str = "",
                   audio_ctx: int = 0) -> List[Any]:
        """Returns [full_text, token_dict, ...] exactly like the node
        (src/speech_to_text.cpp:401-450): greedy, single_segment,
        token_timestamps, split_on_word, suppress_non_speech, settings-fed
        max_tokens / entropy threshold."""
        if self._ctx is None:
            raise RuntimeError("no language model loaded")
        tparams = TranscribeParams(
            language=self.language,
            audio_ctx=min(audio_ctx, self._ctx.config.n_audio_ctx),
            split_on_word=True,
            token_timestamps=True,
            suppress_non_speech_tokens=True,
            single_segment=True,
            max_tokens=int(get_setting("audio.input.transcribe.max_tokens")),
            entropy_thold=float(get_setting(
                "audio.input.transcribe.entropy_threshold")),
            initial_prompt=initial_prompt or None,
            print_progress=False,
        )
        segments = self._ctx.full(tparams, np.asarray(buffer,
                                                      dtype=np.float32))
        out: List[Any] = []
        full_text = ""
        for seg in segments:
            full_text += seg.text
            for j, td in enumerate(seg.tokens):
                out.append({
                    "text": self._ctx.tokenizer.token_str(td.id),
                    "id": td.id, "p": td.p, "plog": td.plog,
                    "pt": td.pt, "ptsum": td.ptsum,
                    "t0": td.t0, "t1": td.t1, "tid": td.tid,
                    "vlen": td.vlen,
                })
        out.insert(0, full_text)
        return out
