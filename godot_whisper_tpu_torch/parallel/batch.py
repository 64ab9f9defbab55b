"""Batched multi-stream transcription, port of the JAX package's
``parallel/batch.py``.

The reference's only data parallelism is one host thread and one state per
audio chunk (whisper_full_parallel, whisper.cpp:5817-5930).  On one card
the streams share the kernels instead: ``BatchTranscriber`` runs N
independent clips through the whole-clip decoder (``decode/clip.py``) as one
batch of streams.  The mel of every clip is one K1 launch
(``MelFrontend.device_batch``); each wave encodes every stream's current
window at once and decodes n_dec rows per stream (5 * B rows by default, the
rows of a stream sharing its cross-K/V row through kv_group), and each
stream advances by its own seek_delta with its own prompt context.

Semantics are the single-stream clip path's: the temperature ladder with
the entropy / logprob gates and per-stream decoder rows (beam search at
t = 0, best_of samplers above).  The JAX package splits a batch into a
dispatch half (``_prepare``) and a drain half (``_finish``), with drain /
``reset_windows`` rounds, because its device loop holds a fixed number of
window slots; the port's ``ClipDecoder.run`` returns every window of every
stream at once, so emission is one pass.  At t > 0 a row's sampling noise
hashes in its row index, so a stream that settles on a sampling rung may
differ from its single-stream result; on the t = 0 rung the batch equals
``full()`` stream for stream.  Token-level timestamps run as the usual host
post-pass per stream (whisper.cpp:6315-6599).  Grammar, the logit-filter
callback, the per-window callbacks, language detection and ladders that mix
decoder widths fall back to sequential per-stream ``full()``.

The batch's ``Timings`` count one encode and the wave's decode steps per
wave (a step advances every stream's rows at once), and one n_fail_p per
stream window that emitted nothing.
"""

from __future__ import annotations

import time
from typing import Iterable, Iterator, List, Optional

import numpy as np

from ..audio.mel import frame_counts
from ..decode.clip import ClipDecoder, ClipOutputs
from ..decode.language import lang_id
from ..decode.loop import Segment, WhisperPipeline
from ..decode.params import TranscribeParams
from ..runtime.trace import tracer


class BatchTranscriber:
    """Transcribe many clips concurrently on one card."""

    def __init__(self, ctx):
        self.ctx = ctx

    # --------------------------------------------------------------- helpers
    @staticmethod
    def _eligible(tparams: TranscribeParams) -> bool:
        counts = [tparams.n_decoders_at(t) for t in tparams.temperatures()]
        uniform = all(c in (1, max(counts)) for c in counts)
        return (uniform
                and tparams.grammar_rules is None
                and tparams.logits_filter_callback is None
                and tparams.encoder_begin_callback is None
                and tparams.progress_callback is None
                and tparams.abort_callback is None
                and not tparams.detect_language)

    def _clip_decoder(self, tparams: TranscribeParams, B: int,
                      prompt_init: List[int],
                      no_timestamps: bool) -> ClipDecoder:
        """The pipeline's clip decoder at B streams (cached there per
        statics, filter settings and task prefix)."""
        return self.ctx.pipeline.clip_decoder(
            tparams, tparams.temperatures(), prompt_init, no_timestamps,
            batch=B)

    def _prompt_init(self, tparams: TranscribeParams):
        """Task prefix shared by every stream (whisper.cpp:5104-5129)."""
        config = self.ctx.pipeline.config
        prompt_init = [config.token_sot]
        if config.is_multilingual:
            prompt_init.append(config.token_lang(
                lang_id(tparams.language or "en")))
            prompt_init.append(config.token_translate if tparams.translate
                               else config.token_transcribe)
        no_timestamps = tparams.no_timestamps or config.is_distil
        if no_timestamps:
            prompt_init.append(config.token_not)
        return prompt_init, no_timestamps

    # ------------------------------------------------------------ transcribe
    def transcribe(self, clips: List[np.ndarray],
                   tparams: Optional[TranscribeParams] = None
                   ) -> List[List[Segment]]:
        """Segments of every clip, in order."""
        tparams = tparams or TranscribeParams()
        if getattr(self.ctx, "family", "whisper") != "whisper":
            # a decoder-only audio LM (decode/omni.py) runs its own batch
            return self.ctx.transcribe_batch(clips, tparams)
        pipe: WhisperPipeline = self.ctx.pipeline
        if not clips:
            return []
        if not self._eligible(tparams):
            # the same semantics, one stream at a time
            out = []
            for clip in clips:
                pipe.segments = []
                pipe._prompt_past = []
                out.append(list(pipe.full(tparams, clip)))
            return out

        with tracer.span("gwt.batch", clips=len(clips)):
            prompt_init, no_timestamps = self._prompt_init(tparams)
            t0 = time.perf_counter()
            with tracer.span("gwt.mel", device=pipe.mel.torch_device,
                             clips=len(clips)) as sp:
                mel, n_lens = pipe.mel.device_batch(clips, span=sp)
            t1 = time.perf_counter()
            pipe.timings.t_mel_us += int((t1 - t0) * 1e6)

            if tparams.initial_prompt:
                init_tokens = pipe.tokenizer.encode(tparams.initial_prompt)
            else:
                init_tokens = list(tparams.prompt_tokens or [])
            s0 = tparams.offset_ms // 10
            seek_ends = [frame_counts(len(c))[1] if tparams.duration_ms == 0
                         else s0 + tparams.duration_ms // 10 for c in clips]
            cd = self._clip_decoder(tparams, len(clips), prompt_init,
                                    no_timestamps)
            outs = cd.run(pipe.params, mel, n_lens, [s0] * len(clips),
                          seek_ends,
                          past_init=[list(init_tokens) for _ in clips])
            segments = self._emit(outs, clips, prompt_init, tparams)
            pipe.timings.t_decode_us += int((time.perf_counter() - t1) * 1e6)
        return segments

    def transcribe_many(self, batches: Iterable[List[np.ndarray]],
                        tparams: Optional[TranscribeParams] = None
                        ) -> Iterator[List[List[Segment]]]:
        """Yield one segment list per batch, in order.  The host drives the
        eager decode loop, so batch k + 1 starts when batch k is done:
        nothing overlaps."""
        for clips in batches:
            yield self.transcribe(clips, tparams)

    # -------------------------------------------------------------- emission
    def _emit(self, outs: ClipOutputs, clips, prompt_init,
              tparams: TranscribeParams) -> List[List[Segment]]:
        """Segment emission per (stream, window) through the pipeline's
        emitter; token-level timestamps from each stream's own samples and
        anchors.  Also counts the batch's waves in the pipeline's
        Timings."""
        pipe: WhisperPipeline = self.ctx.pipeline
        with tracer.span("gwt.emit", windows=int(outs.w.sum())):
            tm = pipe.timings
            for k in range(int(outs.w.max(initial=0))):
                b = int(np.flatnonzero(outs.w > k)[0])  # a stream in wave k
                tm.n_encode += 1
                tm.n_decode += int(outs.steps[b, k])
            segments: List[List[Segment]] = [[] for _ in clips]
            saved = (pipe.segments, pipe._samples, pipe._energy,
                     pipe._ts_state)
            try:
                for b in range(len(clips)):
                    pipe.segments = segments[b]
                    pipe._ts_state = {"t_beg": 0, "t_last": 0,
                                      "tid_last": 0}
                    if tparams.token_timestamps:
                        from ..decode.timestamps import signal_energy
                        pipe._samples = np.asarray(clips[b],
                                                   dtype=np.float32)
                        pipe._energy = signal_energy(pipe._samples, 32)
                    else:
                        pipe._samples = pipe._energy = None
                    for k in range(int(outs.w[b])):
                        if bool(outs.emitted[b, k]):
                            pipe._emit_segments(
                                outs.window_result(b, k), 0, [], prompt_init,
                                int(outs.seek[b, k]), tparams)
                        else:
                            tm.n_fail_p += 1
            finally:
                (pipe.segments, pipe._samples, pipe._energy,
                 pipe._ts_state) = saved
        return segments
