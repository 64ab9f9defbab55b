"""Host-stepped window decode — the slow path for host-interactive
constraints, port of the JAX package's ``decode/host_loop.py``.

Used only when decoding needs per-token host interaction: GBNF grammar
constraints (an unbounded pushdown automaton, whisper.cpp:4221-4265) and
user ``logits_filter_callback`` hooks (whisper.h:414-421).  Per-token
structure mirrors the reference's own loop (whisper.cpp:5288-5609):

- one ``decoder_step`` per token on one row, over a contiguous cache
  (slot == position, ``split=0``: the decode-attention kernel sees one
  region [0, slot]);
- the unfused filter stack (``filters.process_logits``) on the device, as
  the JAX host path runs its plain filters and never the fused sampler;
- ONE copy of the filtered logits, logprobs and probs to the host, then
  the callback, the grammar penalty, the timestamp statistics and the
  argmax (or numpy's categorical draw at t > 0) in numpy, and the state
  machine of the window loop.

Greedy, single decoder.  Everything else uses window.WindowDecoder.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from ..models.config import WhisperConfig
from ..models.model import (CrossKV, decoder_dense, decoder_step,
                            init_kv_cache, param_compute_dtype)
from .filters import FilterContext, process_logits, timestamp_stats
from .grammar import Grammar
from .window import SEEK_DELTA_FULL, WindowResult


class HostWindowDecoder:
    """Token-at-a-time decode with host-side logit post-processing.

    ``stage_s`` accumulates the host's seconds per stage over every
    ``decode``: once an attempt, "prompt" (row 0 of the cross-KV, the
    cache's allocation and the prompt pass's enqueue); once a token,
    "step" (the decoder step's enqueue and the state machine),
    "filters_pull" (the filter stack and the copy to the host, which waits
    for the device to finish the step), "callback", "grammar" (rejection
    and acceptance) and "sample" (the statistics and the draw).
    ``n_attempts`` and ``n_tokens`` count what they cover."""

    def __init__(self, config: WhisperConfig, fctx: FilterContext,
                 tokenizer, tp=None):
        self.config = config
        self.fctx = fctx
        self.tokenizer = tokenizer
        self.tp = tp  # the mesh's tp group (models/model.py)
        self.reset_stats()

    def reset_stats(self) -> None:
        self.stage_s = collections.Counter()
        self.n_attempts = 0
        self.n_tokens = 0

    def decode(
        self,
        params,
        xkv: CrossKV,
        prompt_tokens: np.ndarray,
        *,
        temperature: float,
        seek: int,
        seek_end: int,
        suppress_blank: bool,
        no_timestamps: bool,
        single_segment: bool,
        max_tokens: int,
        grammar: Optional[Grammar] = None,
        grammar_penalty: float = 100.0,
        logits_filter_callback: Optional[Callable] = None,
        seed: int = 0,
    ) -> WindowResult:
        config = self.config
        fctx = self.fctx
        beg, eot = fctx.token_beg, fctx.token_eot
        n_max = config.n_text_ctx // 2 - 4
        V = config.n_vocab
        rng = np.random.default_rng(seed)
        xkv1 = _xkv1(xkv)
        dev = xkv1.device
        mark = [time.perf_counter()]

        def lap(name):
            """Add the host's seconds since the last lap to ``name``."""
            now = time.perf_counter()
            self.stage_s[name] += now - mark[0]
            mark[0] = now

        P = len(prompt_tokens)
        pad = 8
        while pad < P:
            pad *= 2
        prompt_arr = np.zeros(pad, dtype=np.int64)
        prompt_arr[:P] = prompt_tokens

        kv = init_kv_cache(config, 1, dtype=param_compute_dtype(params),
                           device=dev, tp=self.tp)
        positions = torch.arange(pad, dtype=torch.int32, device=dev)[None]
        n_prompt = torch.tensor([P], dtype=torch.int32, device=dev)
        raw_logits, kv = decoder_dense(
            params, config, torch.from_numpy(prompt_arr).to(dev)[None],
            positions, kv, xkv1, n_valid=n_prompt, logit_rows=n_prompt - 1,
            tp=self.tp)
        lap("prompt")
        self.n_attempts += 1
        lo = torch.zeros(1, dtype=torch.int32, device=dev)

        tokens: List[int] = []
        tok_data = {k: [] for k in ("p", "plog", "pt", "ptsum", "tid")}
        has_ts = False
        failed = completed = False
        seek_delta = SEEK_DELTA_FULL
        result_len = 0
        sum_logprobs = 0.0

        for i in range(n_max):
            # filters on the device on the (1, V) row, then one pull
            last = tokens[-1] if tokens else -1
            penult = tokens[-2] if len(tokens) >= 2 else -1
            state = torch.tensor(
                [not tokens, last, penult, len(tokens), has_ts, seek_delta],
                dtype=torch.int32).to(dev)
            rows = process_logits(
                raw_logits.reshape(1, V), fctx=fctx, temperature=temperature,
                is_initial=state[0:1].bool(), last_token=state[1:2],
                penult_token=state[2:3], n_tokens=state[3:4],
                has_ts=state[4:5].bool(), seek_delta=state[5:6],
                suppress_blank=suppress_blank, no_timestamps=no_timestamps)
            host = torch.cat(rows).cpu().numpy()
            logits, logprobs, probs = host[0].copy(), host[1], host[2]
            lap("filters_pull")

            if logits_filter_callback is not None:
                logits_filter_callback(tokens, logits)
                logprobs, probs = _renormalize(logits)
            lap("callback")

            # grammar penalty when no timestamp was forced
            # (whisper.cpp:4684-4707)
            if grammar is not None and probs[:beg].sum() > 0:
                rejected = grammar.reject_tokens(
                    self.tokenizer.id_to_token, eot)
                if rejected:
                    logits[rejected] -= grammar_penalty
                    logprobs, probs = _renormalize(logits)
            lap("grammar")

            # timestamp stats + sample
            pt_a, ptsum_a, tid_a = timestamp_stats(
                torch.from_numpy(probs).reshape(1, V), beg)
            pt, ptsum, tid = (float(pt_a[0]), float(ptsum_a[0]),
                              int(tid_a[0]))
            if temperature < 1e-6:
                tok_id = int(np.argmax(probs))
            else:
                p = probs / probs.sum()
                tok_id = int(rng.choice(V, p=p))
            if tok_id >= beg:
                tid, pt = tok_id, float(probs[tok_id])

            tokens.append(tok_id)
            tok_data["p"].append(float(probs[tok_id]))
            tok_data["plog"].append(float(logprobs[tok_id]))
            tok_data["pt"].append(pt)
            tok_data["ptsum"].append(ptsum)
            tok_data["tid"].append(tid)
            sum_logprobs += float(logprobs[tok_id])
            lap("sample")

            if grammar is not None:
                grammar.accept_token(self.tokenizer.id_to_token[tok_id])
            lap("grammar")
            self.n_tokens += 1

            # state machine (whisper.cpp:5421-5507)
            if tok_id > beg:
                sd_new = 2 * (tok_id - beg)
                if has_ts and seek_delta > sd_new and result_len < i:
                    failed = True
                    break
                seek_delta = sd_new
                result_len = i + 1
                has_ts = True

            if (tok_id == eot or (max_tokens > 0 and i >= max_tokens)
                    or (has_ts and seek + seek_delta + 100 >= seek_end)):
                if result_len == 0:
                    if seek + seek_delta + 100 >= seek_end:
                        result_len = i + 1
                    else:
                        failed = True
                        break
                if single_segment:
                    result_len = i + 1
                    seek_delta = SEEK_DELTA_FULL
                completed = True
                break

            if i == n_max - 1 and (result_len == 0
                                   or seek_delta < SEEK_DELTA_FULL // 2):
                failed = True
                break

            # contiguous incremental cache: slot == position, window
            # [0, P + i] (split=0 collapses the gap)
            step_in = torch.tensor([tok_id, P + i], dtype=torch.int32).to(dev)
            raw_logits, kv = decoder_step(
                params, config, step_in[0:1], step_in[1:2], kv, xkv1, lo=lo,
                slot=P + i, split=0, tp=self.tp)
            lap("step")

        n = len(tokens)
        pad_to = max(n, 1)

        def arr(vals, dtype):
            out = np.zeros((1, pad_to), dtype=dtype)
            out[0, :n] = vals
            return out

        return WindowResult(
            tokens=arr(tokens, np.int32),
            tok_p=arr(tok_data["p"], np.float32),
            tok_plog=arr(tok_data["plog"], np.float32),
            tok_pt=arr(tok_data["pt"], np.float32),
            tok_ptsum=arr(tok_data["ptsum"], np.float32),
            tok_tid=arr(tok_data["tid"], np.int32),
            completed=np.asarray([completed]),
            failed=np.asarray([failed]),
            has_ts=np.asarray([has_ts]),
            seek_delta=np.asarray([seek_delta], dtype=np.int32),
            result_len=np.asarray([result_len], dtype=np.int32),
            sum_logprobs_all=np.asarray([sum_logprobs], dtype=np.float32),
            n_steps=n)


def _xkv1(xkv) -> CrossKV:
    """Row 0 of the cross-KV.  The JAX package's ``_xkv1`` reads ``.k`` and
    fails on an int8 cross-KV; so does this path, with a message."""
    if not isinstance(xkv, CrossKV):
        raise NotImplementedError(
            "host-stepped decode (grammar_rules / logits_filter_callback) "
            "does not serve an int8 cross-KV (cross_kv_int8=True), as in "
            "the JAX package")
    return CrossKV(k=xkv.k[:, :1].contiguous(), v=xkv.v[:, :1].contiguous(),
                   t_valid=xkv.t_valid)


def _renormalize(logits: np.ndarray):
    """log_softmax + probs over possibly -inf logits."""
    finite = np.isfinite(logits)
    mx = logits[finite].max() if finite.any() else 0.0
    ex = np.where(finite, np.exp(logits - mx), 0.0)
    lse = np.log(ex.sum()) + mx
    logprobs = np.where(finite, logits - lse, -np.inf)
    probs = np.where(finite, np.exp(logprobs), 0.0)
    return logprobs, probs
