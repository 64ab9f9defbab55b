"""The transcription orchestrator -- equivalent of ``whisper_full_with_state``
(whisper.cpp:4960-5807), port of the JAX package's ``decode/loop.py``.

This slice carries the whole-clip path (``decode/clip.py``): mel, the seek
loop with the temperature ladder and best_of decoders, sequence ranking
with entropy / logprob gates, prompt_past conditioning and segment
emission.  What the JAX package serves through its host-stepped decoder
(grammar, logit-filter and progress / encoder-begin / abort callbacks),
language auto-detection, beam search, token-level timestamps, injected
mels and int8 cross-KV wait for later slices; ``full`` raises
NotImplementedError for them instead of ignoring them.

Timestamps are in the reference's centisecond units (t0/t1 are 10 ms ticks,
token_beg + n <-> n * 20 ms).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np

from ..audio.mel import MelFrontend, frame_counts
from ..audio.tokenizer import Tokenizer
from ..models.config import MAX_DECODERS, WhisperConfig
from ..runtime.metrics import Timings
from ..runtime.trace import tracer
from .clip import ClipDecoder, ClipStatics
from .filters import build_filter_context
from .language import lang_id
from .params import SamplingStrategy, TranscribeParams
from .window import WindowResult


@dataclasses.dataclass
class TokenData:
    """Mirror of whisper_token_data (whisper.h:78-98)."""
    id: int
    tid: int
    p: float
    plog: float
    pt: float
    ptsum: float
    t0: int = -1
    t1: int = -1
    vlen: float = 0.0


@dataclasses.dataclass
class Segment:
    """Mirror of whisper_segment (whisper.cpp:396-405)."""
    t0: int
    t1: int
    text: str
    tokens: List[TokenData]
    speaker_turn_next: bool = False


def _unsupported(tparams: TranscribeParams, config: WhisperConfig,
                 temperatures) -> Optional[str]:
    """Why this slice cannot run ``tparams`` (None when it can)."""
    if config.is_multilingual and (tparams.language in (None, "auto")
                                   or tparams.detect_language):
        return "language auto-detection"
    if tparams.strategy == SamplingStrategy.BEAM_SEARCH:
        return "beam search"
    if tparams.grammar_rules is not None:
        return "grammar-constrained decoding"
    for name in ("logits_filter_callback", "progress_callback",
                 "encoder_begin_callback", "abort_callback"):
        if getattr(tparams, name) is not None:
            return name
    if tparams.token_timestamps:
        return "token-level timestamps"
    if tparams.cross_kv_int8:
        return "int8 cross-attention KV"
    counts = [tparams.n_decoders_at(t) for t in temperatures]
    if not all(c in (1, max(counts)) for c in counts):
        return "ladders whose rungs mix decoder counts"
    return None


class WhisperPipeline:
    """One loaded model + decode state (context + state in reference terms)."""

    def __init__(self, config: WhisperConfig, params, tokenizer: Tokenizer,
                 mel_filters: np.ndarray, *, device, n_loaded: int = -1):
        self.config = config
        self.params = params
        self.tokenizer = tokenizer
        self.device = device
        self.mel = MelFrontend(mel_filters, device=device)
        # n_loaded == 0 => weightless stub => test fast path
        self.n_loaded = n_loaded
        self.timings = Timings()
        self._clip_decoders = {}
        self._mel_device = None
        self._mel_n_len = 0
        self._n_len_org = 0
        self._prompt_past: List[int] = []
        self.segments: List[Segment] = []

    # ------------------------------------------------------------------ mel
    def set_audio(self, samples: np.ndarray) -> None:
        t0 = time.perf_counter()
        with tracer.span("mel", n_samples=len(samples)):
            self._mel_device, self._mel_n_len = self.mel.device(samples)
            _, self._n_len_org = frame_counts(len(samples))
        self.timings.t_mel_us += int((time.perf_counter() - t0) * 1e6)

    # ------------------------------------------------------------------ full
    def full(self, tparams: TranscribeParams,
             samples: Optional[np.ndarray]) -> List[Segment]:
        config = self.config
        self.segments = []
        temperatures = tparams.temperatures()
        why = _unsupported(tparams, config, temperatures)
        if why is not None:
            raise NotImplementedError(
                f"{why} is not ported to godot_whisper_tpu_torch yet")

        if samples is not None and len(samples) > 0:
            self.set_audio(samples)
        if self._mel_device is None:
            raise ValueError("no audio set")

        language = tparams.language if config.is_multilingual else "en"
        seek_start = tparams.offset_ms // 10
        seek_end = (self._n_len_org if tparams.duration_ms == 0
                    else seek_start + tparams.duration_ms // 10)
        # < 1 s of input: nothing to do (whisper.cpp:5015-5021)
        if seek_end < seek_start + 100:
            return []

        if tparams.n_decoders() > MAX_DECODERS:
            raise ValueError(f"too many decoders ({tparams.n_decoders()} > "
                             f"{MAX_DECODERS})")

        # prompt_past persists across full() calls unless no_context
        # (whisper.cpp:5069-5094); an initial prompt goes to its front
        if tparams.no_context:
            self._prompt_past = []
        prompt_past = self._prompt_past
        new_tokens = (list(tparams.prompt_tokens) if tparams.prompt_tokens
                      else self.tokenizer.encode(tparams.initial_prompt)
                      if tparams.initial_prompt else [])
        if new_tokens:
            prompt_past[:0] = new_tokens

        # task prefix (whisper.cpp:5104-5129)
        prompt_init = [config.token_sot]
        if config.is_multilingual:
            prompt_init.append(config.token_lang(lang_id(language)))
            prompt_init.append(config.token_translate if tparams.translate
                               else config.token_transcribe)
        no_timestamps = tparams.no_timestamps
        if config.is_distil and not no_timestamps:
            no_timestamps = True  # whisper.cpp:5118-5125
        if no_timestamps:
            prompt_init.append(config.token_not)

        return self._full_device(tparams, temperatures, prompt_init,
                                 prompt_past, seek_start, seek_end,
                                 no_timestamps)

    # ------------------------------------------------------ whole-clip loop
    def clip_decoder(self, tparams: TranscribeParams, temperatures,
                     prompt_init, no_timestamps: bool) -> ClipDecoder:
        statics = ClipStatics(
            config=self.config, batch=1, audio_ctx=tparams.audio_ctx,
            temps=tuple(temperatures),
            use_past=tparams.n_max_text_ctx > 0, n_init=len(prompt_init),
            n_max_text_ctx=tparams.n_max_text_ctx,
            length_penalty=tparams.length_penalty,
            entropy_thold=tparams.entropy_thold,
            logprob_thold=tparams.logprob_thold,
            suppress_blank=tparams.suppress_blank,
            no_timestamps=no_timestamps,
            single_segment=tparams.single_segment,
            max_tokens=tparams.max_tokens,
            test_mode=(self.n_loaded == 0), seed=tparams.seed,
            n_dec=max(tparams.n_decoders_at(t) for t in temperatures))
        key = (statics, tparams.suppress_non_speech_tokens,
               tparams.tdrz_enable, round(tparams.max_initial_ts, 6),
               tuple(prompt_init))
        cd = self._clip_decoders.get(key)
        if cd is None:
            fctx = build_filter_context(
                self.config, self.tokenizer,
                suppress_non_speech=tparams.suppress_non_speech_tokens,
                tdrz_enable=tparams.tdrz_enable,
                max_initial_ts=tparams.max_initial_ts, device=self.device)
            cd = ClipDecoder(self.config, fctx, statics, prompt_init)
            self._clip_decoders[key] = cd
        return cd

    def _full_device(self, tparams: TranscribeParams, temperatures,
                     prompt_init, prompt_past, seek_start: int,
                     seek_end: int, no_timestamps: bool) -> List[Segment]:
        t0 = time.perf_counter()
        with tracer.span("decode_clip", seek=seek_start, seek_end=seek_end):
            cd = self.clip_decoder(tparams, temperatures, prompt_init,
                                   no_timestamps)
            outs = cd.run(self.params, self._mel_device[None],
                          [self._mel_n_len], [seek_start], [seek_end],
                          past_init=[list(prompt_past)])
            self.timings.n_encode += int(outs.w[0])  # one encode per window
            for k in range(int(outs.w[0])):
                self.timings.n_decode += int(outs.steps[0, k])
                if bool(outs.emitted[0, k]):
                    self._emit_segments(outs.window_result(0, k),
                                        int(outs.seek[0, k]), tparams)
                else:
                    self.timings.n_fail_p += 1
            self._prompt_past = [int(x) for x in
                                 outs.past_buf[0][:int(outs.past_cnt[0])]]
        self.timings.t_decode_us += int((time.perf_counter() - t0) * 1e6)
        return self.segments

    # ------------------------------------------------------------- segments
    def _emit_segments(self, res: WindowResult, seek: int,
                       tparams: TranscribeParams) -> None:
        """Segment emission of one decoded window (whisper.cpp:5694-5797);
        the clip loop keeps prompt_past itself."""
        config = self.config
        tok = self.tokenizer
        beg, eot = config.token_beg, config.token_eot
        seek_delta = int(res.seek_delta[0])
        tokens_cur = [
            TokenData(id=int(res.tokens[0, t]), tid=int(res.tok_tid[0, t]),
                      p=float(res.tok_p[0, t]), plog=float(res.tok_plog[0, t]),
                      pt=float(res.tok_pt[0, t]),
                      ptsum=float(res.tok_ptsum[0, t]))
            for t in range(int(res.result_len[0]))
        ]
        if not tokens_cur or self.n_loaded == 0:
            return

        i0 = 0
        t0 = seek + 2 * (tokens_cur[0].tid - beg)
        text = ""
        speaker_turn_next = False
        i = 0
        while i < len(tokens_cur):
            td = tokens_cur[i]
            if tparams.print_special or td.id < eot:
                text += tok.token_str(td.id)
            if tparams.tdrz_enable and td.id == config.token_solm:
                speaker_turn_next = True
            if td.id > beg and not tparams.single_segment:
                t1 = seek + 2 * (td.tid - beg)
                if text:
                    self._push_segment(t0, t1, text, tokens_cur[i0:i + 1],
                                       speaker_turn_next, tparams)
                text = ""
                while i < len(tokens_cur) and tokens_cur[i].id > beg:
                    i += 1
                i -= 1
                t0 = t1
                i0 = i + 1
                speaker_turn_next = False
            i += 1

        if text:
            t1 = seek + seek_delta
            self._push_segment(t0, t1, text, tokens_cur[i0:],
                               speaker_turn_next, tparams)

    def _push_segment(self, t0: int, t1: int, text: str,
                      tokens: List[TokenData], speaker_turn: bool,
                      tparams: TranscribeParams) -> None:
        self.segments.append(Segment(t0=t0, t1=t1, text=text,
                                     tokens=list(tokens),
                                     speaker_turn_next=speaker_turn))
        if tparams.new_segment_callback:
            tparams.new_segment_callback(self, 1)
