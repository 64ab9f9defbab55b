"""Real-time chunked streaming transcription, port of the JAX package's
``runtime/streaming.py``.

The re-design of the reference's two streaming schedulers:

- ``CaptureStreamToText.transcribe_thread``
  (godot-whisper bin/addons/godot_whisper/capture_stream_to_text.gd:69-120):
  accumulate -> resample -> VAD -> dynamic audio_ctx -> transcribe ->
  sentence-finalization heuristics -> keep the last 0.2 s -> emit the
  signal -> sleep the rest of transcribe_interval;
- ``SpeechToText::transcribe``'s parameter recipe
  (src/speech_to_text.cpp:401-413): greedy, single_segment,
  token_timestamps, split_on_word, suppress_non_speech, dynamic audio_ctx,
  max_tokens / entropy threshold from the settings.

The scheduler is a plain object driven by ``process_once()`` calls (a game
tick, an event loop) or by its own ``start()`` thread.  With
``incremental_mel`` the mel of the accumulated audio lives on the card
(``IncrementalMel``): each interval computes only the new audio's frames.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from ..audio.mel import frame_counts, log_mel_frames_raw, pad_audio
from ..audio.resample import Interpolator, mixdown, resample
from ..audio.vad import vad_simple
from ..decode.params import TranscribeParams
from ..models.config import CHUNK_SECONDS, HOP_LENGTH, N_FFT, SAMPLE_RATE
from .settings import get_setting


class IncrementalMel:
    """Rolling mel on the card for streaming: each feed computes only the
    NEW audio's frames (on the host, ``log_mel_frames_raw``) and writes them
    into a device buffer, so the mel work of an interval is O(delta), not
    O(sentence).

    The reference recomputes the mel of the whole accumulated buffer every
    interval (capture_stream_to_text.gd:86 -> whisper.cpp:2793).  Here the
    buffer holds RAW log10 mel (each frame depends only on its own 400
    samples); the clip-global max-8 clamp and (x+4)/4 normalization, which
    depend on the whole clip, run on the device over the written frames at
    decode time (``normalized``), so the result equals the one-shot host mel
    (``log_mel_host``) of the same audio.

    Boundaries: a sample reaches ceil(400/160) = 3 frames, so the last up
    to 3 frames (computed against the implicit zero tail) are recomputed on
    the next feed.  Unfilled frames hold log10(1e-10), the value zero audio
    gives.  Each feed writes exactly the frames it computed; the JAX
    package pads the write to 32 frames to bound its jit retraces, which
    writes the same floor values past the end.
    """

    _FLOOR = -10.0  # log10(1e-10)

    def __init__(self, pipe, cap_frames: Optional[int] = None):
        self.pipe = pipe
        chunk = CHUNK_SECONDS * SAMPLE_RATE
        self.cap = (cap_frames if cap_frames is not None
                    else (2 * chunk - N_FFT) // HOP_LENGTH + 1)
        self.n_mels = pipe.config.n_mels
        self.reset()

    def reset(self, keep_samples: Optional[np.ndarray] = None) -> None:
        self.buf = torch.full((self.n_mels, self.cap), self._FLOOR,
                              dtype=torch.float32, device=self.pipe.device)
        self._padded = np.zeros(0, np.float32)  # reflect head + samples
        self.n_samples = 0
        self.n_frames_final = 0    # frames that can never change again
        self.n_frames_written = 0  # incl. recomputable boundary frames
        if keep_samples is not None and len(keep_samples):
            self.feed(keep_samples)

    def feed(self, new_samples: np.ndarray) -> int:
        """Append audio; compute and write only the frames it changes.
        Returns the number of frames written."""
        new_samples = np.asarray(new_samples, dtype=np.float32)
        if self.n_samples <= 200:
            # the reflect-200 head (whisper.cpp:2814) depends on
            # samples[1:201]; until those exist, rebuild it from all the
            # audio so far and recompute the first frames
            raw = (np.concatenate([self._padded[200:], new_samples])
                   if self.n_samples else new_samples)
            self._padded = pad_audio(raw)[:200 + len(raw)]
            self.n_frames_final = 0
        else:
            self._padded = np.concatenate([self._padded, new_samples])
        self.n_samples += len(new_samples)

        # frames inside the real data are final; frames that touch a real
        # sample and the zero tail are recomputed next feed; frames past
        # them are pure zeros, the floor value
        n_pad = len(self._padded)
        n_final = max((n_pad - N_FFT) // HOP_LENGTH + 1, 0)
        i0 = self.n_frames_final
        i1 = min(-(-n_pad // HOP_LENGTH), self.cap)
        if i1 <= i0:
            return 0
        tail_pad = np.concatenate(
            [self._padded, np.zeros(N_FFT + (i1 - i0) * HOP_LENGTH,
                                    np.float32)])
        frames = log_mel_frames_raw(tail_pad, self.pipe.mel.filters, i0, i1)
        self.buf[:, i0:i1] = torch.from_numpy(frames).to(self.buf.device)
        self.n_frames_final = min(n_final, self.cap)
        self.n_frames_written = max(self.n_frames_written, i1)
        return i1 - i0

    def normalized(self):
        """(normalized mel on the device (n_mels, cap), n_len, n_len_org)
        for the decoder.  The max-8 clamp reads every frame that holds real
        data, the recomputable boundary frames included (a burst in the last
        < 400 samples must drive the clip max, as in the one-shot mel)."""
        n_len, n_len_org = frame_counts(self.n_samples)
        valid = self.buf[:, :self.n_frames_written]
        mmax = (valid.max() if valid.numel()
                else torch.tensor(self._FLOOR, device=self.buf.device)) - 8.0
        mel = (torch.maximum(self.buf, mmax) + 4.0) / 4.0
        return mel, min(n_len, self.cap), min(n_len_org, self.cap)


def remove_special_characters(message: str) -> str:
    """Strip [..], <..>, ♪..♪ spans and the ". you." hallucination
    (audio_stream_to_text.gd:66-81)."""
    for start, end in (("[", "]"), ("<", ">"), ("♪", "♪")):
        while start in message:
            b = message.find(start)
            e = message.find(end, b + 1 if start == end else 0)
            if e == -1:
                break
            message = message[:b] + message[e + 1:]
    while ". you." in message:
        b = message.find(". you.")
        message = message[:b] + message[b + len(". you.") + 1:]
    return message


def has_terminating_characters(message: str, characters: str) -> bool:
    return any(c in message for c in characters)


@dataclasses.dataclass
class StreamingConfig:
    """Mirror of CaptureStreamToText's exported properties
    (capture_stream_to_text.gd:10-45)."""
    initial_prompt: str = ""
    transcribe_interval: float = 0.3
    use_dynamic_audio_context: bool = True
    minimum_sentence_time: float = 3.0
    maximum_sentence_time: float = 15.0
    hallucinating_count: int = 1
    punctuation_characters: str = ".!?;。；？！"
    keep_seconds: float = 0.2          # finalize keep-back (gd:111-113)
    vad_last_ms: int = 1000
    language: str = "en"
    interpolator: Interpolator = Interpolator.SINC_FASTEST
    # the dynamic audio_ctx rounds UP to a multiple of this (0 = exact).
    # The JAX package rounds to bound its encoder compiles; rounding up
    # adds context and so changes results, and the port keeps it to give
    # the same transcripts.
    audio_ctx_bucket: int = 128
    # incremental: keep a rolling mel on the card and compute only the NEW
    # frames each interval (IncrementalMel) instead of the whole
    # accumulated buffer as the reference does.  Off when the source rate
    # needs resampling (chunked sinc resampling would change boundary
    # samples).
    incremental_mel: bool = True


class StreamingTranscriber:
    """Push audio in, get (is_partial, text) callbacks out.

    ``on_transcription(is_partial: bool, text: str)`` mirrors the
    ``transcribed_msg`` signal (capture_stream_to_text.gd:5).
    """

    def __init__(self, ctx, config: Optional[StreamingConfig] = None,
                 on_transcription: Optional[Callable[[bool, str], None]] = None,
                 source_rate: int = SAMPLE_RATE):
        self.ctx = ctx
        self.cfg = config or StreamingConfig()
        self.on_transcription = on_transcription
        self.source_rate = source_rate
        self._buffer = np.zeros(0, dtype=np.float32)  # source-rate samples
        self._last_token_count = 0
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._recording = False
        self.partial_text = ""
        self.finalized_texts: List[str] = []
        self._inc: Optional[IncrementalMel] = None
        self._inc_fed = 0  # buffer samples already fed to IncrementalMel
        self._inc_stale = False  # buffer trimmed since the last feed

    # ------------------------------------------------------------------- feed
    def push_audio(self, frames: np.ndarray) -> None:
        """Append captured frames (mono float32 or stereo (N,2)) at the
        source rate — the AudioEffectCapture.get_buffer handoff."""
        mono = mixdown(np.asarray(frames, dtype=np.float32))
        with self._lock:
            self._buffer = np.concatenate([self._buffer, mono])

    def process_once(self) -> Optional[dict]:
        """One scheduler iteration (transcribe_thread body, gd:69-120).

        Returns a report dict or None when there was nothing to do.
        """
        cfg = self.cfg
        t_start = time.perf_counter()

        with self._lock:
            buf = self._buffer.copy()
        if len(buf) == 0:
            return None

        resampled = (resample(buf, self.source_rate, SAMPLE_RATE,
                              cfg.interpolator)
                     if self.source_rate != SAMPLE_RATE else buf)

        no_activity = vad_simple(
            resampled, SAMPLE_RATE, cfg.vad_last_ms,
            vad_thold=float(get_setting(
                "audio.input.transcribe.vad_threshold")),
            freq_thold=float(get_setting(
                "audio.input.transcribe.freq_threshold")))

        total_time = len(resampled) / SAMPLE_RATE
        # dynamic audio_ctx formula (gd:84), rounded up to the bucket
        audio_ctx = int(total_time * 1500 / 30 + 128)
        if cfg.audio_ctx_bucket > 0:
            b = cfg.audio_ctx_bucket
            audio_ctx = -(-audio_ctx // b) * b
        if not cfg.use_dynamic_audio_context:
            audio_ctx = 0
        audio_ctx = min(audio_ctx, self.ctx.config.n_audio_ctx)

        # transcribe with the glue's parameter recipe
        # (src/speech_to_text.cpp:403-413)
        tparams = TranscribeParams(
            language=cfg.language,
            audio_ctx=audio_ctx,
            split_on_word=True,
            token_timestamps=True,
            suppress_non_speech_tokens=True,
            single_segment=True,
            max_tokens=int(get_setting("audio.input.transcribe.max_tokens")),
            entropy_thold=float(get_setting(
                "audio.input.transcribe.entropy_threshold")),
            initial_prompt=cfg.initial_prompt or None,
            print_progress=False,
        )
        use_inc = (cfg.incremental_mel
                   and self.source_rate == SAMPLE_RATE)
        if use_inc:
            # feed ONLY samples not yet seen; decode from the rolling
            # device mel (O(delta) mel work per interval)
            if self._inc is None:
                self._inc = IncrementalMel(self.ctx.pipeline)
            if self._inc_stale or self._inc_fed > len(buf):
                # buffer was trimmed (sentence finalize keep-back): the
                # resident mel belongs to the previous sentence's audio,
                # regardless of whether the buffer has regrown past its
                # old length — rebuild from the current buffer
                self._inc.reset(resampled)
                self._inc_stale = False
            elif len(buf) > self._inc_fed:
                self._inc.feed(buf[self._inc_fed:])
            self._inc_fed = len(buf)
            mel_norm, n_len, n_len_org = self._inc.normalized()
            self.ctx.pipeline.set_mel_device(mel_norm, n_len, n_len_org,
                                             samples=resampled)
            segments = self.ctx.full(tparams, None)
        else:
            segments = self.ctx.full(tparams, resampled)
        n_tokens = sum(len(s.tokens) for s in segments)
        full_text = "".join(s.text for s in segments)

        # sentence finalization heuristics (gd:86-106)
        finish_sentence = total_time > cfg.maximum_sentence_time
        text = remove_special_characters(full_text)
        if (has_terminating_characters(text, cfg.punctuation_characters)
                or no_activity):
            finish_sentence = True
        if (total_time < cfg.minimum_sentence_time
                or abs(n_tokens - self._last_token_count)
                > cfg.hallucinating_count):
            finish_sentence = False

        elapsed = time.perf_counter() - t_start
        if no_activity:
            return {"text": None, "partial": True, "elapsed": elapsed,
                    "no_activity": True}

        if finish_sentence:
            # keep the trailing keep_seconds of source audio (gd:111-113)
            keep = int(cfg.keep_seconds * self.source_rate)
            with self._lock:
                self._buffer = self._buffer[max(0, len(self._buffer) - keep):]
            self._inc_stale = True
            self.finalized_texts.append(text)
            self.partial_text = ""
        else:
            self.partial_text = text

        self._last_token_count = n_tokens
        if self.on_transcription:
            self.on_transcription(not finish_sentence, full_text)

        return {"text": full_text, "partial": not finish_sentence,
                "elapsed": elapsed, "no_activity": False,
                "audio_ctx": audio_ctx, "n_tokens": n_tokens}

    # ------------------------------------------------------------- run thread
    @property
    def recording(self) -> bool:
        return self._recording

    def start(self) -> None:
        """Spawn the scheduler thread (the _ready() + Thread.start path)."""
        if self._thread and self._thread.is_alive():
            self.stop()
        self._recording = True
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._recording = False
        if self._thread:
            self._thread.join()
            self._thread = None

    def _run(self) -> None:
        cfg = self.cfg
        while self._recording:
            t0 = time.perf_counter()
            self.process_once()
            # sleep the remainder of the interval (gd:118-120)
            remaining = cfg.transcribe_interval - (time.perf_counter() - t0)
            if remaining > 0:
                time.sleep(remaining)

    def text(self) -> str:
        return "".join(self.finalized_texts) + self.partial_text
