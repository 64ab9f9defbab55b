"""Vectorized logit-filter stack -- the port of the JAX package's
``decode/filters.py`` (``whisper_process_logits``, whisper.cpp:4489-4775).

The decode loop runs the fused filter + sampler (kernel K5,
ops/filter_sample.py); ``process_logits`` and ``timestamp_stats`` are the
unfused reference stack with -inf masking, kept for parity tests against
the JAX package.

Rule inventory (reference line cites):
 1. temperature scaling                      whisper.cpp:4516-4520
 2. suppress blank at start                  :4530-4537
 3. suppress <|notimestamps|>; no_timestamps :4539-4546
 4. suppress sot/nosp (+solm unless tdrz)    :4548-4555
 5. suppress task/lang/prev tokens           :4557-4568
 6. optional non-speech suppression          :4574-4593
 7. timestamp pairing rules                  :4595-4614
 8. max_initial_ts cap                       :4616-4625
 9. monotonic timestamps per decoder         :4627-4635
10. log_softmax                              :4637-4655
11. "sum of ts probs beats max text" rule    :4657-4709
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

_NEG_INF = float("-inf")


class FilterContext(NamedTuple):
    """Static data of the filter stack."""

    static_suppress: torch.Tensor  # (V,) bool -- rules 3 (first half), 4, 5, 6
    token_eot: int
    token_beg: int
    space_id: int                  # id of " " (rule 2)
    max_initial_tid: int           # rule 8: round(max_initial_ts / precision)
    n_vocab: int


def build_filter_context(config, tokenizer, *,
                         suppress_non_speech: bool = False,
                         tdrz_enable: bool = False,
                         max_initial_ts: float = 1.0,
                         extra_suppress: Sequence[int] = (),
                         device) -> FilterContext:
    """Precompute the static suppression mask on the host and place it on
    ``device`` (once per model / params combination)."""
    V = config.n_vocab
    mask = np.zeros(V, dtype=bool)
    mask[config.token_not] = True          # rule 3 (always)
    mask[config.token_sot] = True          # rule 4
    mask[config.token_nosp] = True
    if not tdrz_enable:
        mask[config.token_solm] = True
    mask[config.token_translate] = True    # rule 5
    mask[config.token_transcribe] = True
    mask[config.token_prev] = True
    if config.is_multilingual:
        from .language import LANGUAGES
        for i in range(min(len(LANGUAGES), config.num_languages)):
            mask[config.token_lang(i)] = True
    if suppress_non_speech and tokenizer is not None:
        for tid in tokenizer.non_speech_token_ids():  # rule 6
            mask[tid] = True
    for tid in extra_suppress:
        mask[tid] = True

    # rule 8: precision = CHUNK_SIZE / n_audio_ctx seconds per ts token
    # (upstream uses the model's full n_audio_ctx even when it is reduced)
    precision = 30.0 / config.n_audio_ctx
    max_initial_tid = int(round(max_initial_ts / precision)) \
        if max_initial_ts > 0 else (V - config.token_beg)

    space_id = -1
    if tokenizer is not None and tokenizer.space_token_id is not None:
        space_id = tokenizer.space_token_id

    return FilterContext(
        static_suppress=torch.from_numpy(mask).to(device),
        token_eot=config.token_eot,
        token_beg=config.token_beg,
        space_id=space_id,
        max_initial_tid=max_initial_tid,
        n_vocab=V,
    )


def _masked_log_softmax(logits: torch.Tensor) -> torch.Tensor:
    """log_softmax treating -inf as excluded (whisper.cpp:4637-4655)."""
    mx = logits.max(dim=-1, keepdim=True).values
    shifted = logits - mx
    fin = torch.isfinite(logits)
    sumexp = torch.where(fin, torch.exp(shifted),
                         torch.zeros_like(shifted)).sum(dim=-1, keepdim=True)
    return torch.where(fin, shifted - torch.log(sumexp),
                       torch.full_like(shifted, _NEG_INF))


def process_logits(logits: torch.Tensor, *, fctx: FilterContext,
                   temperature: float, is_initial: torch.Tensor,
                   last_token: torch.Tensor, penult_token: torch.Tensor,
                   n_tokens: torch.Tensor, has_ts: torch.Tensor,
                   seek_delta: torch.Tensor, suppress_blank: bool = True,
                   no_timestamps: bool = False):
    """Returns (logits, logprobs, probs), all (B, V) float32; ``probs`` is
    exp(logprob) with exact 0 for suppressed entries."""
    B, V = logits.shape
    beg, eot = fctx.token_beg, fctx.token_eot
    dev = logits.device
    ids = torch.arange(V, device=dev)[None, :]
    ninf = torch.full((), _NEG_INF, device=dev)

    logits = logits.float()
    temp = torch.tensor(temperature, dtype=torch.float32)
    if temp > 0:                                                  # rule 1
        logits = logits / torch.clamp(temp, min=1e-8).to(dev)
    logits = torch.where(fctx.static_suppress.to(dev)[None, :], ninf, logits)
    if suppress_blank:                                            # rule 2
        blank = (ids == eot) | (ids == fctx.space_id)
        logits = torch.where(is_initial[:, None] & blank, ninf, logits)
    if no_timestamps:                                             # rule 3b
        logits = torch.where(ids >= beg, ninf, logits)
    last_was_ts = (n_tokens > 0) & (last_token >= beg)            # rule 7
    penult_was_ts = (n_tokens < 2) | (penult_token >= beg)
    both = (last_was_ts & penult_was_ts)[:, None]
    only_last = (last_was_ts & ~penult_was_ts)[:, None]
    logits = torch.where(both & (ids >= beg), ninf, logits)
    logits = torch.where(only_last & (ids < eot), ninf, logits)
    cap = ids > beg + fctx.max_initial_tid                        # rule 8
    logits = torch.where(is_initial[:, None] & cap, ninf, logits)
    tid0 = torch.div(seek_delta, 2, rounding_mode="floor")[:, None]  # rule 9
    mono = (ids >= beg) & (ids < beg + tid0)
    logits = torch.where(has_ts[:, None] & mono, ninf, logits)

    logprobs = _masked_log_softmax(logits)                        # rule 10

    ts_lp = logprobs[:, beg:]                                     # rule 11
    ts_max = ts_lp.max(dim=-1, keepdim=True).values
    ts_sum = torch.where(torch.isfinite(ts_lp), torch.exp(ts_lp - ts_max),
                         torch.zeros_like(ts_lp)).sum(dim=-1, keepdim=True)
    ts_logprob = torch.where(ts_sum > 0, torch.log(ts_sum) + ts_max, ninf)
    max_text = logprobs[:, :beg].max(dim=-1, keepdim=True).values
    kill_text = (ts_logprob > max_text) & (ids < beg)
    logits = torch.where(kill_text, ninf, logits)
    logprobs = torch.where(kill_text, ninf, logprobs)

    probs = torch.where(torch.isfinite(logprobs), torch.exp(logprobs),
                        torch.zeros_like(logprobs))
    return logits, logprobs, probs


def timestamp_stats(probs: torch.Tensor, beg: int):
    """(pt, ptsum, tid) per row: max/sum of timestamp-token probabilities
    (whisper_sample_token's ts bookkeeping, whisper.cpp:4792-4810)."""
    ts = probs[:, beg:]
    sum_ts = ts.sum(dim=-1)
    max_ts = ts.max(dim=-1).values
    tid = beg + torch.argmax(ts, dim=-1)
    pt = max_ts / (sum_ts + 1e-10)
    return pt, sum_ts, tid.to(torch.int32)
