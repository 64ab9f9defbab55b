"""The transcription orchestrator -- equivalent of ``whisper_full_with_state``
(whisper.cpp:4960-5807), port of the JAX package's ``decode/loop.py``.

Two paths, chosen as the JAX package chooses them:

- the whole-clip path (``decode/clip.py``): mel, the seek loop with the
  temperature ladder (beam search or argmax rows on rung 0, best_of
  samplers above), sequence ranking with entropy / logprob gates,
  prompt_past conditioning and segment emission;
- the per-window path (``_full_windows``) for ladders whose rungs mix
  decoder counts (e.g. beam_size 8 with best_of 5), for the progress,
  encoder-begin and abort callbacks, and for grammar rules and the
  logit-filter callback: one encode and one ``WindowDecoder`` (or
  ``HostWindowDecoder``) call per (window, rung), each rung at its own
  width.

``TranscribeParams.cross_kv_int8`` quantizes each window's cross-KV to int8
right after it is projected (``models.model.quantize_cross_kv``) on both
paths.  A multilingual model with ``language="auto"`` (or None) or
``detect_language`` first runs ``detect_language`` (one encode, one [sot]
decode, a softmax over the language tokens); ``token_timestamps`` fills each
token's t0/t1 from the kept samples' energy and ``max_len`` re-splits
segments (``decode/timestamps.py``).  A mel set from outside (``set_mel``,
or the streaming path's ``set_mel_device``) decodes through the whole-clip
path as the pipeline's own does.  Grammar rules and the logit-filter
callback take the per-window path with the host-stepped decoder
(``decode/host_loop.py``): one greedy or sampled row, one token at a time,
the grammar re-initialised for every attempt.

Timestamps are in the reference's centisecond units (t0/t1 are 10 ms ticks,
token_beg + n <-> n * 20 ms).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..audio.mel import MelFrontend, frame_counts
from ..audio.tokenizer import Tokenizer
from ..models.config import MAX_DECODERS, WhisperConfig
from ..models.model import (cross_kv, decoder_dense, encoder_forward,
                            init_kv_cache, param_compute_dtype,
                            quantize_cross_kv)
from ..parallel.collectives import tp_size
from ..runtime.metrics import Timings
from ..runtime.trace import tracer
from .clip import ClipDecoder, ClipStatics, mel_windows
from .filters import build_filter_context
from .grammar import Grammar, grammar_from_gbnf
from .host_loop import HostWindowDecoder
from .language import detect_language_from_logits, lang_id, lang_str
from .params import SamplingStrategy, TranscribeParams
from .sequence import score_sequence
from .window import StepGraphs, WindowDecoder, WindowResult


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


def _device_loop_eligible(tparams: TranscribeParams, temperatures) -> bool:
    """The whole-clip path runs a static n_dec rows per stream: every rung's
    decoder count must be 1 (padded to n_dec identical argmax rows, the
    same result) or n_dec = max(counts); mixed widths, grammar rules, the
    logit-filter callback and the per-window callbacks take the per-window
    path (the JAX package's rule)."""
    counts = [tparams.n_decoders_at(t) for t in temperatures]
    return (all(c in (1, max(counts)) for c in counts)
            and tparams.grammar_rules is None
            and tparams.logits_filter_callback is None
            and tparams.progress_callback is None
            and tparams.encoder_begin_callback is None
            and tparams.abort_callback is None)


def _make_grammar(tparams: TranscribeParams) -> Optional[Grammar]:
    """Fresh grammar state per decode attempt."""
    rules = tparams.grammar_rules
    if rules is None:
        return None
    if isinstance(rules, str):
        return grammar_from_gbnf(rules)
    if isinstance(rules, Grammar):
        # re-init from the same rule set
        return Grammar(rules.rules, tparams.i_start_rule)
    return Grammar(list(rules), tparams.i_start_rule)


def _strategy(tparams: TranscribeParams) -> str:
    return ("beam" if tparams.strategy == SamplingStrategy.BEAM_SEARCH
            else "greedy")


class WhisperPipeline:
    """One loaded model + decode state (context + state in reference terms).

    ``tp`` is the mesh's tp group when ``params`` hold one rank's slices
    (``parallel/sharding.py``); every rank of the group runs the same
    calls, and every forward pass takes it."""

    def __init__(self, config: WhisperConfig, params, tokenizer: Tokenizer,
                 mel_filters: np.ndarray, *, device, n_loaded: int = -1,
                 tp=None):
        self.config = config
        self.params = params
        self.tp = tp
        self.tokenizer = tokenizer
        self.device = device
        self.mel = MelFrontend(mel_filters, device=device)
        # n_loaded == 0 => weightless stub => test fast path
        self.n_loaded = n_loaded
        self.lang_id_detected: Optional[int] = None
        self.timings = Timings()
        self._clip_decoders = {}
        self._window_decoders = {}
        self._step_graphs = StepGraphs()   # shared by the decoders
        self._mel_device = None
        self._mel_n_len = 0
        self._n_len_org = 0
        self._prompt_past: List[int] = []
        # token-level timestamps: the samples' energy and the anchors that
        # persist across segments (whisper_state t_beg / t_last / tid_last)
        self._samples: Optional[np.ndarray] = None
        self._energy: Optional[np.ndarray] = None
        self._ts_state = {"t_beg": 0, "t_last": 0, "tid_last": 0}
        self.segments: List[Segment] = []

    def set_params(self, params, tp=None) -> None:
        """Swap the weights (one rank's slices under ``tp``); the decoders
        built for the old ones are dropped."""
        self.params, self.tp = params, tp
        self._clip_decoders.clear()
        self._window_decoders.clear()
        self._step_graphs.clear()

    # ------------------------------------------------------------------ mel
    def set_audio(self, samples: np.ndarray) -> None:
        t0 = time.perf_counter()
        with tracer.span("gwt.mel", device=self.mel.torch_device,
                         clips=1) as sp:
            self._samples = np.asarray(samples, dtype=np.float32)
            self._mel_device, self._mel_n_len = self.mel.device(samples,
                                                                span=sp)
            _, self._n_len_org = frame_counts(len(samples))
        self.timings.t_mel_us += int((time.perf_counter() - t0) * 1e6)

    def mel_host(self) -> Optional[np.ndarray]:
        """Host copy of the current mel (n_mels, n_len)."""
        if self._mel_device is None:
            return None
        return self._mel_device[:, :self._mel_n_len].float().cpu().numpy()

    def set_mel(self, mel: np.ndarray, n_len_org: Optional[int] = None):
        """External mel (n_mels, n_len) (whisper_set_mel, whisper.h:262-270).
        It goes to the device with 2 * n_audio_ctx zero frames behind it, so
        a window starting anywhere inside it reads the mel and then zeros, as
        the JAX package's host window copy does."""
        mel = np.asarray(mel, dtype=np.float32)
        n_len = mel.shape[1]
        buf = torch.zeros((mel.shape[0], n_len + 2 * self.config.n_audio_ctx),
                          dtype=torch.float32, device=self.device)
        buf[:, :n_len] = torch.from_numpy(mel).to(self.device)
        self._mel_device, self._mel_n_len = buf, n_len
        self._n_len_org = n_len_org or n_len

    def set_mel_device(self, mel_dev: torch.Tensor, n_len: int,
                       n_len_org: int,
                       samples: Optional[np.ndarray] = None) -> None:
        """Decode from a normalized mel (n_mels, F) already on the device:
        the incremental streaming path feeds new frames only and normalizes
        on the device (runtime/streaming.py)."""
        self._mel_device = mel_dev
        self._mel_n_len = int(n_len)
        self._n_len_org = int(n_len_org)
        self._samples = (np.asarray(samples, dtype=np.float32)
                         if samples is not None else None)
        self._energy = None

    # -------------------------------------------------------------- language
    def detect_language(self, seek: int = 0,
                        audio_ctx: int = 0) -> Tuple[int, np.ndarray]:
        """Encode + one [sot] decode + softmax over the language tokens
        (whisper_lang_auto_detect_with_state, whisper.cpp:3569-3642)."""
        _, xkv = self.encode_window(seek, audio_ctx)
        config = self.config
        dev = self.device
        kv = init_kv_cache(config, 1, dtype=param_compute_dtype(self.params),
                           device=dev, tp=self.tp)
        tokens = torch.full((1, 1), config.token_sot, dtype=torch.int32,
                            device=dev)
        positions = torch.zeros((1, 1), dtype=torch.int32, device=dev)
        logits, _ = decoder_dense(self.params, config, tokens, positions, kv,
                                  xkv, n_valid=torch.ones(1, dtype=torch.int32,
                                                          device=dev),
                                  tp=self.tp)
        return detect_language_from_logits(
            logits[0, 0].float().cpu().numpy(), config)

    # ------------------------------------------------------------------ full
    def full(self, tparams: TranscribeParams,
             samples: Optional[np.ndarray]) -> List[Segment]:
        config = self.config
        self.segments = []
        temperatures = tparams.temperatures()

        if samples is not None and len(samples) > 0:
            self.set_audio(samples)
        if self._mel_device is None:
            raise ValueError("no audio or mel set")

        # language auto-detect (whisper.cpp:4985-5001)
        language = tparams.language
        if config.is_multilingual and (language in (None, "auto")
                                       or tparams.detect_language):
            lid, _ = self.detect_language(0, tparams.audio_ctx)
            self.lang_id_detected = lid
            language = lang_str(lid)
            if tparams.detect_language:
                return []
        elif not config.is_multilingual:
            language = "en"

        # token-timestamp state (whisper.cpp:5003-5010)
        if tparams.token_timestamps:
            self._ts_state = {"t_beg": 0, "t_last": 0, "tid_last": 0}
            if self._samples is not None and len(self._samples) > 0:
                from .timestamps import signal_energy
                self._energy = signal_energy(self._samples, 32)

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
            self.lang_id_detected = lang_id(language or "en")
            prompt_init.append(config.token_lang(self.lang_id_detected))
            prompt_init.append(config.token_translate if tparams.translate
                               else config.token_transcribe)
        no_timestamps = tparams.no_timestamps
        if config.is_distil and not no_timestamps:
            no_timestamps = True  # whisper.cpp:5118-5125
        if no_timestamps:
            prompt_init.append(config.token_not)

        if _device_loop_eligible(tparams, temperatures):
            return self._full_device(tparams, temperatures, prompt_init,
                                     prompt_past, seek_start, seek_end,
                                     no_timestamps)
        return self._full_windows(tparams, temperatures, prompt_init,
                                  prompt_past, seek_start, seek_end,
                                  no_timestamps)

    # ------------------------------------------------------ whole-clip loop
    def _fctx(self, tparams: TranscribeParams):
        return build_filter_context(
            self.config, self.tokenizer,
            suppress_non_speech=tparams.suppress_non_speech_tokens,
            tdrz_enable=tparams.tdrz_enable,
            max_initial_ts=tparams.max_initial_ts, device=self.device)

    def clip_decoder(self, tparams: TranscribeParams, temperatures,
                     prompt_init, no_timestamps: bool,
                     batch: int = 1) -> ClipDecoder:
        """The whole-clip decoder of ``batch`` streams for these params,
        cached per statics, filter settings and task prefix."""
        statics = ClipStatics(
            config=self.config, batch=batch, audio_ctx=tparams.audio_ctx,
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
            n_dec=max(tparams.n_decoders_at(t) for t in temperatures),
            strategy=_strategy(tparams), cross_int8=tparams.cross_kv_int8)
        key = (statics, tparams.suppress_non_speech_tokens,
               tparams.tdrz_enable, round(tparams.max_initial_ts, 6),
               tuple(prompt_init))
        cd = self._clip_decoders.get(key)
        if cd is None:
            cd = ClipDecoder(self.config, self._fctx(tparams), statics,
                             prompt_init, tp=self.tp,
                             graphs=self._step_graphs)
            self._clip_decoders[key] = cd
        return cd

    def _full_device(self, tparams: TranscribeParams, temperatures,
                     prompt_init, prompt_past, seek_start: int,
                     seek_end: int, no_timestamps: bool) -> List[Segment]:
        t0 = time.perf_counter()
        cd = self.clip_decoder(tparams, temperatures, prompt_init,
                               no_timestamps)
        outs = cd.run(self.params, self._mel_device[None],
                      [self._mel_n_len], [seek_start], [seek_end],
                      past_init=[list(prompt_past)])
        with tracer.span("gwt.emit", windows=int(outs.w[0])):
            self.timings.n_encode += int(outs.w[0])  # one encode per window
            for k in range(int(outs.w[0])):
                self.timings.n_decode += int(outs.steps[0, k])
                if bool(outs.emitted[0, k]):
                    self._emit_segments(outs.window_result(0, k), 0, [],
                                        prompt_init, int(outs.seek[0, k]),
                                        tparams)
                else:
                    self.timings.n_fail_p += 1
            self._prompt_past = [int(x) for x in
                                 outs.past_buf[0][:int(outs.past_cnt[0])]]
        self.timings.t_decode_us += int((time.perf_counter() - t0) * 1e6)
        return self.segments

    # ---------------------------------------------------- per-window path
    def window_decoder(self, tparams: TranscribeParams) -> WindowDecoder:
        key = (tparams.suppress_non_speech_tokens, tparams.tdrz_enable,
               round(tparams.max_initial_ts, 6))
        wd = self._window_decoders.get(key)
        if wd is None:
            wd = WindowDecoder(self.config, self._fctx(tparams), tp=self.tp,
                               graphs=self._step_graphs)
            self._window_decoders[key] = wd
        return wd

    def host_decoder(self, tparams: TranscribeParams) -> HostWindowDecoder:
        """The host-stepped decoder on the window decoder's FilterContext."""
        key = ("host", tparams.suppress_non_speech_tokens,
               tparams.tdrz_enable, round(tparams.max_initial_ts, 6))
        hd = self._window_decoders.get(key)
        if hd is None:
            hd = HostWindowDecoder(self.config,
                                   self.window_decoder(tparams).fctx,
                                   self.tokenizer, tp=self.tp)
            self._window_decoders[key] = hd
        return hd

    def encode_window(self, seek: int, audio_ctx: int = 0,
                      quant_kv: bool = False):
        """Encode mel[seek : seek + 2 * n_ctx] -> (enc_out, CrossKV), the
        cross-KV int8 (QuantCrossKV) with ``quant_kv``
        (whisper_encode_internal's window slice, whisper.cpp:1697-1706).
        The cross-KV is the pipeline's buffer (``StepGraphs.cross_kv``),
        which the next call overwrites."""
        n_ctx = audio_ctx or self.config.n_audio_ctx
        t0 = time.perf_counter()
        dev = self._mel_device.device
        with tracer.span("gwt.encode", device=dev, rows=1):
            wins = mel_windows(self._mel_device[None], np.asarray([seek]),
                               np.asarray([self._mel_n_len]), n_ctx)
            enc = encoder_forward(self.params, self.config, wins,
                                  audio_ctx=audio_ctx or None, tp=self.tp)
        with tracer.span("gwt.cross_kv", device=dev, rows=1):
            # into the buffer that the token loop's graph reads
            xkv = self._step_graphs.cross_kv(self.params, self.config, enc,
                                             quant_kv, tp=self.tp)
        self.timings.t_encode_us += int((time.perf_counter() - t0) * 1e6)
        self.timings.n_encode += 1
        return enc, xkv

    def _full_windows(self, tparams: TranscribeParams, temperatures,
                      prompt_init, prompt_past, seek_start: int,
                      seek_end: int, no_timestamps: bool) -> List[Segment]:
        """The JAX package's per-window loop (its ``full`` after the clip
        path declines): per window one encode, then the ladder, each rung
        one ``WindowDecoder`` call at that rung's decoder count; beam search
        on a t = 0 rung of more than one decoder, as the clip path runs
        it, and best_of sampling above.  Grammar rules or the logit-filter
        callback put every rung on the host-stepped decoder, one row."""
        config = self.config
        strategy = _strategy(tparams)
        host_mode = (tparams.grammar_rules is not None
                     or tparams.logits_filter_callback is not None)
        wd = (self.host_decoder(tparams) if host_mode
              else self.window_decoder(tparams))
        seek = seek_start
        while True:
            if tparams.progress_callback:
                tparams.progress_callback(
                    self, (100 * (seek - seek_start))
                    // max(1, seek_end - seek_start))
            if seek + 100 >= seek_end:
                break
            if (tparams.encoder_begin_callback
                    and not tparams.encoder_begin_callback(self)):
                break
            _, xkv = self.encode_window(seek, tparams.audio_ctx,
                                        tparams.cross_kv_int8)

            # drop stale context near the end (whisper.cpp:5176-5180)
            if seek > seek_start and seek + 500 >= seek_end:
                prompt_past = []

            best = None
            for it, t_cur in enumerate(temperatures):
                n_dec = 1 if host_mode else tparams.n_decoders_at(t_cur)
                # build prompt (whisper.cpp:5237-5249)
                prompt: List[int] = []
                if (prompt_past and t_cur < 0.5
                        and tparams.n_max_text_ctx > 0):
                    n_take = min(tparams.n_max_text_ctx,
                                 config.n_text_ctx // 2, len(prompt_past))
                    prompt = [config.token_prev] + prompt_past[-n_take:]
                prompt += prompt_init
                beam = strategy == "beam" and n_dec > 1 and t_cur < 1e-6
                t0 = time.perf_counter()
                with tracer.span("gwt.window", rung=it, rows=n_dec):
                    if host_mode:
                        # the grammar re-inited per attempt
                        # (whisper.cpp:5228-5232)
                        res = wd.decode(
                            self.params, xkv, np.asarray(prompt, np.int32),
                            temperature=t_cur, seek=seek, seek_end=seek_end,
                            suppress_blank=tparams.suppress_blank,
                            no_timestamps=no_timestamps,
                            single_segment=tparams.single_segment,
                            max_tokens=tparams.max_tokens,
                            grammar=_make_grammar(tparams),
                            grammar_penalty=tparams.grammar_penalty,
                            logits_filter_callback=(
                                tparams.logits_filter_callback),
                            seed=tparams.seed + it)
                    else:
                        res = wd.decode(
                            self.params, xkv, np.asarray(prompt, np.int32),
                            n_decoders=n_dec, temperature=t_cur,
                            strategy="beam" if beam else "greedy",
                            beam_size=n_dec if beam else 1, seek=seek,
                            seek_end=seek_end,
                            suppress_blank=tparams.suppress_blank,
                            no_timestamps=no_timestamps,
                            single_segment=tparams.single_segment,
                            max_tokens=tparams.max_tokens,
                            test_mode=(self.n_loaded == 0),
                            seed=tparams.seed + it)
                self.timings.t_decode_us += int(
                    (time.perf_counter() - t0) * 1e6)
                self.timings.n_decode += res.n_steps * n_dec

                # rank sequences (whisper.cpp:5611-5645)
                best_j, best_score, scores = -1, -np.inf, []
                for j in range(n_dec):
                    if res.failed[j]:
                        scores.append(None)
                        continue
                    rl = int(res.result_len[j])
                    sc = score_sequence(res.tokens[j, :rl].tolist(),
                                        res.tok_plog[j, :rl],
                                        tparams.length_penalty)
                    # entropy gate (whisper.cpp:5628-5636)
                    if rl > 32 and sc.entropy < tparams.entropy_thold:
                        scores.append(None)
                        self.timings.n_fail_h += 1
                        continue
                    scores.append(sc)
                    if sc.score > best_score:
                        best_score, best_j = sc.score, j

                success = True
                if it != len(temperatures) - 1:
                    if best_j < 0 or (scores[best_j].avg_logprobs
                                      < tparams.logprob_thold):
                        success = False
                        self.timings.n_fail_p += 1
                if best_j >= 0:
                    best = {"res": res, "j": best_j}
                if success and best is not None:
                    break

            if best is None:
                # every temperature failed: advance a full window
                seek += 3000
                continue
            # the prompt of the last rung tried, as whisper.cpp:5684-5692
            seek_delta, prompt_past = self._emit_segments(
                best["res"], best["j"], prompt, prompt_init, seek, tparams)
            self._prompt_past = prompt_past
            seek += seek_delta
            if tparams.abort_callback and tparams.abort_callback(self):
                break
        return self.segments

    # ------------------------------------------------------------- segments
    def _emit_segments(self, res: WindowResult, j: int, prompt: List[int],
                       prompt_init: List[int], seek: int,
                       tparams: TranscribeParams) -> Tuple[int, List[int]]:
        """Segment emission of decoder row j of one window
        (whisper.cpp:5694-5797) and the prompt_past update
        (whisper.cpp:5684-5692).  Returns (seek_delta, new prompt_past);
        the clip loop keeps prompt_past itself and ignores it."""
        config = self.config
        tok = self.tokenizer
        beg, eot = config.token_beg, config.token_eot
        seek_delta = int(res.seek_delta[j])
        tokens_cur = [
            TokenData(id=int(res.tokens[j, t]), tid=int(res.tok_tid[j, t]),
                      p=float(res.tok_p[j, t]), plog=float(res.tok_plog[j, t]),
                      pt=float(res.tok_pt[j, t]),
                      ptsum=float(res.tok_ptsum[j, t]))
            for t in range(int(res.result_len[j]))
        ]
        prompt_past: List[int] = []
        if prompt and prompt[0] == config.token_prev:
            prompt_past = prompt[1:len(prompt) - len(prompt_init)]
        prompt_past += [t.id for t in tokens_cur]
        if not tokens_cur or self.n_loaded == 0:
            return seek_delta, prompt_past

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
        return seek_delta, prompt_past

    def _push_segment(self, t0: int, t1: int, text: str,
                      tokens: List[TokenData], speaker_turn: bool,
                      tparams: TranscribeParams) -> None:
        self.segments.append(Segment(t0=t0, t1=t1, text=text,
                                     tokens=list(tokens),
                                     speaker_turn_next=speaker_turn))
        n_new = 1
        if tparams.token_timestamps:
            from .timestamps import compute_token_level_timestamps, wrap_segment
            compute_token_level_timestamps(self, len(self.segments) - 1,
                                           tparams.thold_pt,
                                           tparams.thold_ptsum)
            if tparams.max_len > 0:
                n_new = wrap_segment(self, tparams.max_len,
                                     tparams.split_on_word)
        if tparams.new_segment_callback:
            tparams.new_segment_callback(self, n_new)
