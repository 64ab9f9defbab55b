"""Autoregressive greedy / temperature decode of one 30 s window.

Port of the JAX package's ``decode/window.py`` (greedy and sampling
paths; beam search is a later slice).  The JAX package runs the whole loop
as one ``lax.while_loop``; here it is a Python loop over device tensors:

- each step runs the fused filter + sampler kernel (K5) on the raw logits,
  copies its per-row outputs to the host in ONE transfer (the step's only
  synchronisation, which also tests "all rows done"), advances the decoder
  state machine in numpy, and runs ``decoder_step`` for the next logits;
- the state machine is the JAX package's step for step: completed /
  failed / has_ts / seek_delta / result_len, the timestamp window advance
  and "back in time" failure, EOT / max_tokens / end-of-audio completion
  with the result_len == 0 rescue, the weightless-stub fast path and the
  final-step repetition failure (whisper.cpp:5421-5507);
- the JAX loop's unconditional extra decoder step after the last token
  (an XLA workaround) is skipped.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.config import WhisperConfig
from ..models.model import (CrossKV, KVCache, decoder_dense, decoder_step,
                            init_kv_cache, param_compute_dtype)
from ..ops.filter_sample import fused_filter_sample
from .filters import FilterContext

SEEK_DELTA_FULL = 3000  # 100 * WHISPER_CHUNK_SIZE (whisper.cpp:5222)


class WindowResult(NamedTuple):
    """Host-side (numpy) state of one window decode after its loop; the
    JAX package's LoopState minus the device-only fields."""
    tokens: np.ndarray
    tok_p: np.ndarray
    tok_plog: np.ndarray
    tok_pt: np.ndarray
    tok_ptsum: np.ndarray
    tok_tid: np.ndarray
    completed: np.ndarray
    failed: np.ndarray
    has_ts: np.ndarray
    seek_delta: np.ndarray
    result_len: np.ndarray
    sum_logprobs_all: np.ndarray
    n_steps: int


@dataclasses.dataclass(frozen=True)
class WindowStatics:
    """Static configuration of one window decode."""
    config: WhisperConfig
    batch: int
    n_max: int
    prompt_pad: int
    greedy_argmax: bool     # temperature == 0: argmax, else Gumbel sampling
    suppress_blank: bool
    no_timestamps: bool
    single_segment: bool
    max_tokens: int
    test_mode: bool         # weightless stub model fast path
    # consecutive groups of kv_group rows (the decoders of one stream)
    # share one cross-KV row
    kv_group: int = 1


def prompt_pass_per_stream(params, config: WhisperConfig,
                           prompt: torch.Tensor, n_prompt: np.ndarray,
                           xkv: CrossKV, n_max: Optional[int] = None):
    """Per-stream prompt decode: each row its own prompt (B, P) with its
    own length.  The cache holds P + n_max slots; the padded prompt
    capacity P is the decode loop's ``split``.  Returns (last_logits
    (B, V) f32, kv)."""
    B, P = prompt.shape
    dev = prompt.device
    kv0 = init_kv_cache(config, B,
                        cache_len=P + (n_max if n_max is not None
                                       else config.n_text_ctx // 2 - 4),
                        dtype=param_compute_dtype(params), device=dev)
    positions = torch.arange(P, dtype=torch.int32, device=dev).expand(B, P)
    n_prompt_t = torch.as_tensor(np.asarray(n_prompt, np.int64).reshape(B),
                                 device=dev)
    logits, kv = decoder_dense(params, config, prompt, positions, kv0, xkv,
                               n_valid=n_prompt_t,
                               logit_rows=n_prompt_t - 1)
    return logits[:, 0], kv


def prompt_pass_grouped(params, config: WhisperConfig, prompt: torch.Tensor,
                        n_prompt: np.ndarray, xkv: CrossKV, n_dec: int,
                        n_max: Optional[int] = None):
    """Grouped prompt pass: G streams decode their prompts ONCE, then the
    logits and self-KV repeat to each stream's n_dec decoder rows
    (kv_cache_seq_cp 0 -> j per stream, whisper.cpp:5277)."""
    last, kv = prompt_pass_per_stream(params, config, prompt, n_prompt, xkv,
                                      n_max=n_max)
    if n_dec == 1:
        return last, kv
    return (last.repeat_interleave(n_dec, dim=0),
            KVCache(k=kv.k.repeat_interleave(n_dec, dim=1),
                    v=kv.v.repeat_interleave(n_dec, dim=1)))


def _attempt_seed(rng_seed: int, step: int) -> int:
    """Per-step seed of the sampler's counter hash (rows are hashed in)."""
    return (1000003 * step + 7919 * rng_seed) & 0xFFFFFFFF


def run_decode_loop(params, config: WhisperConfig, fctx: FilterContext,
                    statics: WindowStatics, xkv: CrossKV, kv: KVCache,
                    last_logits: torch.Tensor, n_prompt, temperature: float,
                    seek, seek_end, rng_seed: int) -> WindowResult:
    """The autoregressive window loop given a finished prompt pass.
    ``n_prompt``, ``seek`` and ``seek_end`` are per row (or scalars)."""
    B, N_MAX = statics.batch, statics.n_max
    eot, beg = fctx.token_eot, fctx.token_beg
    dev = last_logits.device
    n_prompt = np.broadcast_to(np.asarray(n_prompt, np.int32), (B,))
    seek = np.broadcast_to(np.asarray(seek, np.int32), (B,))
    seek_end = np.broadcast_to(np.asarray(seek_end, np.int32), (B,))
    lo = torch.as_tensor(n_prompt.copy(), device=dev)

    tokens = np.zeros((B, N_MAX), np.int32)
    tok_p = np.zeros((B, N_MAX), np.float32)
    tok_plog = np.zeros((B, N_MAX), np.float32)
    tok_pt = np.zeros((B, N_MAX), np.float32)
    tok_ptsum = np.zeros((B, N_MAX), np.float32)
    tok_tid = np.zeros((B, N_MAX), np.int32)
    completed = np.zeros(B, bool)
    failed = np.zeros(B, bool)
    has_ts = np.zeros(B, bool)
    seek_delta = np.full(B, SEEK_DELTA_FULL, np.int32)
    result_len = np.zeros(B, np.int32)
    sum_lp = np.zeros(B, np.float32)
    argmax_flag = int(statics.greedy_argmax)

    logits = last_logits.float().contiguous()
    for i in range(N_MAX):
        last = tokens[:, i - 1] if i > 0 else np.full(B, -1, np.int32)
        penult = tokens[:, i - 2] if i > 1 else np.full(B, -1, np.int32)
        state = np.stack([np.full(B, int(i == 0)), last, penult,
                          np.full(B, i), has_ts, seek_delta,
                          np.full(B, argmax_flag)], axis=1).astype(np.int32)
        out = fused_filter_sample(
            logits, fctx.static_suppress, torch.from_numpy(state).to(dev),
            temperature=temperature, seed=_attempt_seed(rng_seed, i),
            eot=eot, beg=beg, space_id=fctx.space_id,
            max_initial_tid=fctx.max_initial_tid,
            suppress_blank=statics.suppress_blank,
            no_timestamps=statics.no_timestamps)
        # ONE device -> host transfer of the step's six outputs (int32 rows
        # ride bit-exactly as float32 views)
        packed = torch.stack([out.token.view(torch.float32), out.p,
                              out.plog, out.pt, out.ptsum,
                              out.tid.view(torch.float32)]).cpu().numpy()
        ids = packed[0].view(np.int32)
        p, plog, pt, ptsum = packed[1], packed[2], packed[3], packed[4]
        tid = packed[5].view(np.int32)

        was_done = completed | failed
        live = ~was_done
        tokens[live, i] = ids[live]
        tok_p[live, i] = p[live]
        tok_plog[live, i] = plog[live]
        tok_pt[live, i] = pt[live]
        tok_ptsum[live, i] = ptsum[live]
        tok_tid[live, i] = tid[live]
        sum_lp = np.where(live, sum_lp + plog, sum_lp).astype(np.float32)

        # ---- decoder state machine (whisper.cpp:5421-5507)
        is_ts_tok = ids > beg
        sd_new = (2 * (ids - beg)).astype(np.int32)
        back_in_time = has_ts & (seek_delta > sd_new) & (result_len < i)
        fail_ts = live & is_ts_tok & back_in_time
        take_ts = live & is_ts_tok & ~back_in_time
        seek_delta = np.where(take_ts, sd_new, seek_delta)
        result_len = np.where(take_ts, i + 1, result_len).astype(np.int32)
        has_ts = has_ts | take_ts
        failed = failed | fail_ts

        alive = live & ~fail_ts
        end_of_text = ids == eot
        max_tok = statics.max_tokens > 0 and i >= statics.max_tokens
        end_of_audio = has_ts & (seek + seek_delta + 100 >= seek_end)
        wants_end = alive & (end_of_text | max_tok | end_of_audio)

        zero_res = result_len == 0
        rescue = seek + seek_delta + 100 >= seek_end
        fail_zero = wants_end & zero_res & ~rescue
        result_len = np.where(wants_end & zero_res & rescue, i + 1,
                              result_len).astype(np.int32)
        failed = failed | fail_zero
        complete_now = wants_end & ~(zero_res & ~rescue)
        if statics.single_segment:
            result_len = np.where(complete_now, i + 1,
                                  result_len).astype(np.int32)
            seek_delta = np.where(complete_now, SEEK_DELTA_FULL, seek_delta)
        completed = completed | complete_now

        if statics.test_mode:
            # stub checkpoint: complete immediately (whisper.cpp:5492-5497)
            still = alive & ~complete_now & ~fail_zero
            seek_delta = np.where(still, SEEK_DELTA_FULL, seek_delta)
            completed = completed | still

        # repetition-loop failure on the final step (whisper.cpp:5500-5506)
        if i == N_MAX - 1:
            rep = (result_len == 0) | (seek_delta < SEEK_DELTA_FULL // 2)
            failed = failed | (alive & ~complete_now & rep)
        seek_delta = seek_delta.astype(np.int32)

        if i == N_MAX - 1 or np.all(completed | failed):
            break
        # ---- next-step logits; the cache slot is the batch-uniform
        # prompt_pad + i, the true position n_prompt + i drives the
        # positional embedding
        logits, kv = decoder_step(
            params, config, torch.from_numpy(tokens[:, i].copy()).to(dev),
            torch.from_numpy((n_prompt + i).astype(np.int32)).to(dev),
            kv, xkv, lo=lo, slot=statics.prompt_pad + i,
            split=statics.prompt_pad, kv_group=statics.kv_group)

    return WindowResult(
        tokens=tokens, tok_p=tok_p, tok_plog=tok_plog, tok_pt=tok_pt,
        tok_ptsum=tok_ptsum, tok_tid=tok_tid, completed=completed,
        failed=failed, has_ts=has_ts, seek_delta=seek_delta,
        result_len=result_len, sum_logprobs_all=sum_lp, n_steps=i + 1)


class WindowDecoder:
    """Greedy / sampling decode of one window for ``n_decoders`` rows that
    share one prompt."""

    def __init__(self, config: WhisperConfig, fctx: FilterContext):
        self.config = config
        self.fctx = fctx

    def decode(self, params, xkv: CrossKV, prompt_tokens: np.ndarray, *,
               n_decoders: int, temperature: float, seek: int, seek_end: int,
               suppress_blank: bool, no_timestamps: bool,
               single_segment: bool, max_tokens: int, test_mode: bool,
               seed: int = 0) -> WindowResult:
        config = self.config
        n_max = config.n_text_ctx // 2 - 4  # whisper.cpp:5288
        P = int(len(prompt_tokens))
        pad = 8  # prompt capacity bucketed as in the JAX package
        while pad < P:
            pad *= 2
        pad = min(pad, config.n_text_ctx // 2 + 8)
        statics = WindowStatics(
            config=config, batch=n_decoders, n_max=n_max, prompt_pad=pad,
            greedy_argmax=temperature < 1e-6,
            suppress_blank=suppress_blank, no_timestamps=no_timestamps,
            single_segment=single_segment, max_tokens=max_tokens,
            test_mode=test_mode, kv_group=n_decoders)
        prompt = np.zeros((1, pad), np.int32)
        prompt[0, :P] = prompt_tokens
        dev = xkv.k.device
        last, kv = prompt_pass_grouped(
            params, config, torch.from_numpy(prompt).to(dev),
            np.asarray([P]), xkv, n_decoders, n_max=n_max)
        return run_decode_loop(params, config, self.fctx, statics, xkv, kv,
                               last, P, temperature, seek, seek_end, seed)
