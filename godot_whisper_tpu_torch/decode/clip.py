"""Whole-clip decode: the seek loop, temperature ladder and token loop.

Port of the JAX package's ``decode/clip.py`` (``ClipDecoder._build``) as
eager Python with the same semantics:

    while any stream can progress:            # seek loop (whisper.cpp:5150)
        encode current windows (all streams, batched)
        rung 0, then rungs while any stream is unsettled   # ladder (:5184)
            build prompts from prompt_past    # (:5237-5260)
            prompt pass + token loop          # window.run_decode_loop
            per-stream ranking + entropy / logprob gates   # (:5611-5671)
        record window outputs, update prompt_past, advance seeks

Every stream runs ``n_dec`` decoder rows (5 by default: best_of samplers on
the t > 0 rungs; on the t = 0 rung identical argmax rows, or with
``strategy="beam"`` one group of n_dec beams); the rows of a stream share
ONE cross-KV row through ``kv_group = n_dec``.  Streams
advance in lockstep waves, each by its own seek_delta, settling at its own
ladder temperature.  The JAX package's donated state machine and
``while_loop``s become host loops over numpy state; window outputs are kept
in growing lists instead of fixed window slots.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.config import WhisperConfig
from ..models.model import encoder_forward
from ..runtime.trace import tracer
from .filters import FilterContext
from .window import (SEEK_DELTA_FULL, StepGraphs, WindowResult,
                     WindowStatics, run_decode_loop)


@dataclasses.dataclass(frozen=True)
class ClipStatics:
    """Static configuration of one clip decoder."""
    config: WhisperConfig
    batch: int
    audio_ctx: int             # 0 => full n_audio_ctx
    temps: Tuple[float, ...]   # the temperature ladder
    use_past: bool             # prompt_past conditioning enabled at all
    n_init: int                # task-prefix token count
    n_max_text_ctx: int
    length_penalty: float
    entropy_thold: float
    logprob_thold: float
    suppress_blank: bool
    no_timestamps: bool
    single_segment: bool
    max_tokens: int
    test_mode: bool
    seed: int
    n_dec: int = 1             # decoder rows per stream (beam/best_of)
    strategy: str = "greedy"   # "greedy" | "beam" (beam on the t=0 rung)
    cross_int8: bool = False   # int8-quantize the cross-KV per window


class ClipOutputs(NamedTuple):
    """Per-window results of every stream, padded to (B, W, N_MAX)."""
    tokens: np.ndarray     # (B, W, N_MAX) int32
    p: np.ndarray
    plog: np.ndarray
    pt: np.ndarray
    ptsum: np.ndarray
    tid: np.ndarray
    rl: np.ndarray         # (B, W)
    seek: np.ndarray
    delta: np.ndarray
    emitted: np.ndarray
    temp: np.ndarray
    steps: np.ndarray      # (B, W) decode steps spent (all ladder attempts)
    w: np.ndarray          # (B,) windows used
    done: np.ndarray       # (B,)
    past_buf: np.ndarray   # (B, PAST_CAP)
    past_cnt: np.ndarray   # (B,)

    def window_result(self, b: int, k: int) -> WindowResult:
        """Window k of stream b as a 1-row WindowResult for the segment
        emitter (loop.py ``_emit_segments``)."""
        return WindowResult(
            tokens=self.tokens[b, k][None], tok_p=self.p[b, k][None],
            tok_plog=self.plog[b, k][None], tok_pt=self.pt[b, k][None],
            tok_ptsum=self.ptsum[b, k][None], tok_tid=self.tid[b, k][None],
            completed=np.asarray([True]), failed=np.asarray([False]),
            has_ts=np.asarray([True]), seek_delta=self.delta[b, k][None],
            result_len=self.rl[b, k][None],
            sum_logprobs_all=np.zeros(1, np.float32),
            n_steps=int(self.rl[b, k]))


def mel_windows(mel: torch.Tensor, seek: np.ndarray, n_len: np.ndarray,
                n_ctx: int) -> torch.Tensor:
    """Each stream's encoder input (B, 2 * n_ctx, n_mels) from its mel
    (B, n_mels, F) at its seek.  A window starting past the buffer is
    clamped into it, as lax.dynamic_slice does; frames >= n_len are zeroed
    (whisper.cpp:1695)."""
    B, _, F = mel.shape
    dev = mel.device
    start = np.clip(seek, 0, max(F - 2 * n_ctx, 0))
    idx = torch.as_tensor(np.asarray(seek)[:, None]
                          + np.arange(2 * n_ctx)[None], device=dev)
    wins = torch.stack([mel[b, :, int(start[b]):int(start[b]) + 2 * n_ctx]
                        for b in range(B)])
    keep = idx < torch.as_tensor(np.asarray(n_len)[:, None], device=dev)
    return torch.where(keep[:, None, :], wins,
                       torch.zeros((), device=dev)).transpose(1, 2)


def _entropy_last32(tokens: np.ndarray, rl: np.ndarray,
                    n_max: int) -> np.ndarray:
    """Token-histogram entropy of the final 32 tokens per row
    (whisper_sequence_score, whisper.cpp:4936-4957); read only where
    rl > 32."""
    idx = np.clip(rl[:, None] - 32 + np.arange(32)[None, :], 0, n_max - 1)
    vals = np.take_along_axis(tokens, idx, axis=1)             # (B, 32)
    cj = np.sum(vals[:, :, None] == vals[:, None, :], axis=2
                ).astype(np.float32)
    return -np.mean(np.log(cj / np.float32(32.0)), axis=1, dtype=np.float32)


class ClipDecoder:
    """Drives the whole-clip decode of a batch of streams."""

    def __init__(self, config: WhisperConfig, fctx: FilterContext,
                 statics: ClipStatics, init_tokens: List[int], tp=None,
                 graphs: Optional[StepGraphs] = None):
        if len(init_tokens) != statics.n_init:
            raise ValueError("init_tokens length != statics.n_init")
        self.config = config
        self.fctx = fctx
        self.tp = tp  # the mesh's tp group (models/model.py)
        # the token loop's captured steps (decode/window.py)
        self.graphs = graphs if graphs is not None else StepGraphs()
        self.statics = statics
        self.init_tokens = np.asarray(init_tokens, np.int32)
        self.past_cap = config.n_text_ctx // 2
        self.n_max = config.n_text_ctx // 2 - 4
        if statics.use_past:
            p = min(self.past_cap, max(statics.n_max_text_ctx, 0)) \
                + statics.n_init + 1
        else:
            p = statics.n_init
        self.prompt_pad = -(-max(p, 8) // 8) * 8

    def _wst(self, t_idx: int) -> WindowStatics:
        """Rung t_idx: beam search on rung 0 when the strategy asks for it,
        at t = 0 and with more than one row; argmax rows at t = 0
        otherwise; best_of samplers above (whisper.cpp:5035-5067)."""
        s = self.statics
        argmax = s.temps[t_idx] < 1e-6
        beam = (t_idx == 0 and s.strategy == "beam" and s.n_dec > 1
                and argmax)
        return WindowStatics(
            config=self.config, batch=s.batch * s.n_dec, n_max=self.n_max,
            prompt_pad=self.prompt_pad, greedy_argmax=argmax and not beam,
            suppress_blank=s.suppress_blank, no_timestamps=s.no_timestamps,
            single_segment=s.single_segment, max_tokens=s.max_tokens,
            test_mode=s.test_mode, kv_group=s.n_dec,
            strategy="beam" if beam else "greedy", beam_size=s.n_dec,
            tp=self.tp)

    def _build_prompt(self, past_buf, past_cnt, use_past_t: bool):
        """[prev] + past tail + task prefix per stream (whisper.cpp:5237)."""
        s = self.statics
        B, P, cap = s.batch, self.prompt_pad, self.past_cap
        take_cap = min(s.n_max_text_ctx, cap)
        if s.use_past:
            use_past = use_past_t & (past_cnt > 0)
        else:
            use_past = np.zeros(B, bool)
        n_take = np.where(use_past, np.minimum(past_cnt, take_cap), 0)
        off = np.where(use_past, 1 + n_take, 0)
        i = np.arange(P)[None, :]
        g = np.clip(past_cnt[:, None] - n_take[:, None] + i - 1, 0, cap - 1)
        tok_past = np.take_along_axis(past_buf, g, axis=1)
        tok_init = self.init_tokens[np.clip(i - off[:, None], 0,
                                            s.n_init - 1)]
        prompt = np.where(
            (i == 0) & use_past[:, None], self.config.token_prev,
            np.where(i < off[:, None], tok_past,
                     np.where(i < (off + s.n_init)[:, None], tok_init, 0)))
        return (prompt.astype(np.int32), (off + s.n_init).astype(np.int32),
                n_take.astype(np.int32), use_past)

    def run(self, params, mel: torch.Tensor, n_lens, seeks, seek_ends,
            past_init: Optional[List[List[int]]] = None) -> ClipOutputs:
        """Decode every stream of ``mel`` (B, n_mels, F) from its seek to
        its seek_end."""
        s, config = self.statics, self.config
        B, ND, N_MAX, CAP = s.batch, s.n_dec, self.n_max, self.past_cap
        n_ctx = s.audio_ctx or config.n_audio_ctx
        n_temps = len(s.temps)
        dev = mel.device
        rows = np.arange(B)
        n_len = np.asarray(n_lens, np.int32)
        seek = np.asarray(seeks, np.int32).copy()
        seek_start = seek.copy()
        seek_end = np.asarray(seek_ends, np.int32)
        done = np.zeros(B, bool)
        past_buf = np.zeros((B, CAP), np.int32)
        past_cnt = np.zeros(B, np.int32)
        for b, toks in enumerate(past_init or []):
            tail = list(toks)[-CAP:]
            past_buf[b, :len(tail)] = tail
            past_cnt[b] = len(tail)
        windows = [[] for _ in range(B)]

        def rep(x):
            return np.repeat(x, ND, axis=0)

        with tracer.span("gwt.clip", streams=B):
            while True:
                active = ~done & (seek + 100 < seek_end)
                if not active.any():
                    break

                # ---- batched encode of every stream's current window
                with tracer.span("gwt.encode", device=dev, rows=B):
                    enc = encoder_forward(
                        params, config, mel_windows(mel, seek, n_len, n_ctx),
                        audio_ctx=s.audio_ctx or None, tp=self.tp)
                with tracer.span("gwt.cross_kv", device=dev, rows=B):
                    # into the buffer that the step's graph reads
                    xkv = self.graphs.cross_kv(params, config, enc,
                                               s.cross_int8, tp=self.tp)

                # stale context near the end of audio (whisper.cpp:5176-5180)
                cnt = np.where(active & (seek > seek_start)
                               & (seek + 500 >= seek_end), 0, past_cnt)

                settled = ~active
                has_best = np.zeros(B, bool)
                bt = {"tokens": np.zeros((B, N_MAX), np.int32),
                      "p": np.zeros((B, N_MAX), np.float32),
                      "plog": np.zeros((B, N_MAX), np.float32),
                      "pt": np.zeros((B, N_MAX), np.float32),
                      "ptsum": np.zeros((B, N_MAX), np.float32),
                      "tid": np.zeros((B, N_MAX), np.int32)}
                bt_rl = np.zeros(B, np.int32)
                bt_delta = np.full(B, SEEK_DELTA_FULL, np.int32)
                bt_take = np.zeros(B, np.int32)
                bt_temp = np.zeros(B, np.float32)
                steps = 0

                t_idx = 0
                while t_idx < n_temps and (t_idx == 0 or not settled.all()):
                    temp = float(np.float32(s.temps[t_idx]))
                    prompt, n_prompt, n_take, used_past = self._build_prompt(
                        past_buf, cnt, s.temps[t_idx] < 0.5)
                    # sampling rungs seed each attempt with seed + rung index
                    ls = run_decode_loop(
                        params, config, self.fctx, self._wst(t_idx),
                        self.graphs, xkv, torch.from_numpy(prompt).to(dev),
                        n_prompt, temp, rep(seek), rep(seek_end),
                        s.seed + t_idx, rung=t_idx)

                    # ---- per-stream ranking + gates (whisper.cpp:5611-5671)
                    with tracer.span("gwt.gates"):
                        rl_r = ls.result_len
                        tmask = np.arange(N_MAX)[None, :] < rl_r[:, None]
                        total_r = np.sum(ls.tok_plog * tmask, axis=1,
                                         dtype=np.float32)
                        if s.length_penalty > 0:
                            pen_r = (((5.0 + rl_r) / 6.0)
                                     ** s.length_penalty).astype(np.float32)
                        else:
                            pen_r = np.maximum(rl_r, 1).astype(np.float32)
                        entropy_r = _entropy_last32(ls.tokens, rl_r, N_MAX)
                        fail_h = (rl_r > 32) & (entropy_r < s.entropy_thold)
                        valid_r = ~ls.failed & ~fail_h & (rl_r > 0)
                        score_r = np.where(valid_r, total_r / pen_r, -np.inf)

                        best_j = np.argmax(score_r.reshape(B, ND), axis=1)
                        bidx = rows * ND + best_j
                        valid = valid_r.reshape(B, ND).any(axis=1)
                        avg = total_r[bidx] / np.maximum(
                            rl_r[bidx], 1).astype(np.float32)
                        is_last = t_idx == n_temps - 1
                        success = valid & (is_last
                                           | (avg >= s.logprob_thold))
                        upd = ~settled & valid

                        for key, src in (("tokens", ls.tokens),
                                         ("p", ls.tok_p),
                                         ("plog", ls.tok_plog),
                                         ("pt", ls.tok_pt),
                                         ("ptsum", ls.tok_ptsum),
                                         ("tid", ls.tok_tid)):
                            bt[key] = np.where(upd[:, None], src[bidx],
                                               bt[key])
                        bt_rl = np.where(upd, rl_r[bidx], bt_rl)
                        bt_delta = np.where(upd, ls.seek_delta[bidx],
                                            bt_delta)
                        bt_take = np.where(
                            upd, np.where(used_past, n_take, 0), bt_take)
                        bt_temp = np.where(upd, np.float32(temp), bt_temp)
                        settled = settled | (~settled & success)
                        has_best = has_best | upd
                    steps += ls.n_steps
                    t_idx += 1

                with tracer.span("gwt.gates"):
                    emitted = has_best & active
                    delta = np.where(has_best, bt_delta, SEEK_DELTA_FULL)
                    for b in np.flatnonzero(active):
                        windows[b].append({
                            "tokens": bt["tokens"][b], "p": bt["p"][b],
                            "plog": bt["plog"][b], "pt": bt["pt"][b],
                            "ptsum": bt["ptsum"][b], "tid": bt["tid"][b],
                            "rl": int(bt_rl[b]) if emitted[b] else 0,
                            "seek": int(seek[b]), "delta": int(delta[b]),
                            "emitted": bool(emitted[b]),
                            "temp": float(bt_temp[b]), "steps": steps})

                    # ---- prompt_past <- kept prompt tail + new tokens
                    # (whisper.cpp:5684-5692)
                    kept = np.where(emitted, bt_take, 0)
                    rl_eff = np.where(emitted, bt_rl, 0)
                    total_len = kept + rl_eff
                    keep_n = np.minimum(total_len, CAP)
                    j = (total_len - keep_n)[:, None] + np.arange(CAP)[None]
                    from_past = j < kept[:, None]
                    pidx = np.clip(cnt[:, None] - kept[:, None] + j, 0,
                                   CAP - 1)
                    tidx = np.clip(j - kept[:, None], 0, N_MAX - 1)
                    newbuf = np.where(
                        from_past, np.take_along_axis(past_buf, pidx, axis=1),
                        np.take_along_axis(bt["tokens"], tidx, axis=1))
                    newbuf = np.where(
                        np.arange(CAP)[None, :] < keep_n[:, None], newbuf, 0)
                    upd_past = active & emitted
                    past_buf = np.where(upd_past[:, None], newbuf,
                                        past_buf).astype(np.int32)
                    past_cnt = np.where(upd_past, keep_n,
                                        cnt).astype(np.int32)

                    seek = np.where(active, seek + delta,
                                    seek).astype(np.int32)
                    done = done | (active & (seek + 100 >= seek_end))

            return self._outputs(windows, done, past_buf, past_cnt)

    def _outputs(self, windows, done, past_buf, past_cnt):
        B, N = self.statics.batch, self.n_max
        W = max(1, max(len(w) for w in windows))

        def grid(key, dtype, per_token):
            shape = (B, W, N) if per_token else (B, W)
            out = np.zeros(shape, dtype)
            for b, ws in enumerate(windows):
                for k, rec in enumerate(ws):
                    out[b, k] = rec[key]
            return out

        return ClipOutputs(
            tokens=grid("tokens", np.int32, True),
            p=grid("p", np.float32, True), plog=grid("plog", np.float32, True),
            pt=grid("pt", np.float32, True),
            ptsum=grid("ptsum", np.float32, True),
            tid=grid("tid", np.int32, True), rl=grid("rl", np.int32, False),
            seek=grid("seek", np.int32, False),
            delta=grid("delta", np.int32, False),
            emitted=grid("emitted", bool, False),
            temp=grid("temp", np.float32, False),
            steps=grid("steps", np.int32, False),
            w=np.asarray([len(ws) for ws in windows], np.int32),
            done=done, past_buf=past_buf, past_cnt=past_cnt)
