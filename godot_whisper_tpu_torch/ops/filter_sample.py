"""K5: fused logit filter + sampler, and K6: fused logit filter + top-K
beam expansion (both csrc/filter_sample.cu), with their plain versions.

Counterparts of the JAX package's ``ops/filter_sample.py`` entries:

- ``fused_filter_sample`` (TPU kernel ``_kernel`` with ``_filter_lp``):
  temperature, the suppression rules, masked log-softmax with the -1e30
  sentinel, the timestamp-mass rule, then argmax over probabilities or
  Gumbel-max sampling per row, and the timestamp statistics;
- ``fused_filter_topk`` (TPU kernel ``_topk_kernel``): the same filter
  stage, then the K largest filtered log-probs per row (lowest index first
  on ties, the ``lax.top_k`` order), the probability at each, and the
  pre-merge timestamp statistics -- the beam loop's whole pre-merge stage.

Per-row decode state rides in one ``(B, 7)`` int32 tensor, as in the JAX
kernel: ``[is_initial, last, penult, n_tokens, has_ts, seek_delta,
argmax_flag]``.  The Gumbel noise is a counter hash of (seed, row, id) that
both versions compute, so they agree at t > 0 as well.

On the card each row runs on one thread-block cluster whose CTAs take
slices of the vocabulary (``filter_plan``), each thread holding its ids in
registers.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import kernels

_NEG = -1e30
_MASK32 = 0xFFFFFFFF
FILTER_THREADS = 256      # threads of one CTA
MAX_FILTER_CLUSTER = 16   # CTAs of a row's cluster (not portable past 8)
MAX_VOCAB = 56000         # ids a row may have: 16 x 256 x 14 slots
WIDE_VOCAB = 155648       # K5 alone: 16 x 256 x 38 slots (an LM's ids)
MAX_TOPK = 32             # K6's candidates per row


def filter_plan(B: int, V: int, max_vocab: int = MAX_VOCAB
                ) -> Tuple[int, int]:
    """K5 / K6's cluster size C and slice width W for rows of V ids: grid
    (C, B), CTA r takes ids [r W, min(r W + W, V)), thread t of it ids
    r W + i 256 + t.  W is a whole number of 256-id steps (a warp's 32 ids
    of one step are consecutive) and C the fewest CTAs that cover V with at
    most 16 CTAs; at V 51864 or 51866: (16, 3328), 13 ids a thread.  V
    alone decides, never the row's state, so every call and graph replay
    has one grid.  Raises past V ``max_vocab``: 56000 (14 ids a thread),
    or for K5 ``WIDE_VOCAB`` (38 ids a thread; at V 152064: (16, 9728))."""
    if B < 1 or not 1 <= V <= max_vocab:
        raise ValueError(f"filter_plan: {B} rows of {V} ids "
                         f"(1 <= V <= {max_vocab})")
    step = MAX_FILTER_CLUSTER * FILTER_THREADS
    width = -(-V // step) * FILTER_THREADS
    return -(-V // width), width


class SampleOut(NamedTuple):
    token: torch.Tensor   # (B,) int32
    p: torch.Tensor       # (B,) f32
    plog: torch.Tensor    # (B,) f32
    pt: torch.Tensor      # (B,) f32
    ptsum: torch.Tensor   # (B,) f32
    tid: torch.Tensor     # (B,) int32


class TopKOut(NamedTuple):
    plog: torch.Tensor    # (B, K) f32 top-K filtered log-probs, descending
    ids: torch.Tensor     # (B, K) int32
    p: torch.Tensor       # (B, K) f32 probabilities at those ids
    pt: torch.Tensor      # (B,) f32 pre-merge timestamp statistics
    ptsum: torch.Tensor   # (B,) f32
    tid: torch.Tensor     # (B,) int32


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32) without int64 overflow."""
    lo, hi = x & 0xFFFF, x >> 16
    return ((((hi * c) & 0xFFFF) << 16) + lo * c) & _MASK32


def gumbel_hash_noise(seed: int, b: int, v: int, device) -> torch.Tensor:
    """(b, v) f32 Gumbel noise from the kernel's counter hash of
    (seed, row, id) -> 24-bit uniform -> -log(-log(max(u, 1e-12)))."""
    row = torch.arange(b, device=device, dtype=torch.int64)[:, None]
    col = torch.arange(v, device=device, dtype=torch.int64)[None, :]
    x = (col + _mul32(row + 1, 0x9E3779B9)
         + _mul32(torch.tensor(seed & _MASK32, device=device), 0x632BE5AB)
         ) & _MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    u = (x & 0xFFFFFF).to(torch.float32) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(torch.clamp(u, min=1e-12)))


def _filtered_logprobs(logits, suppress, state, *, temperature: float,
                       eot: int, beg: int, space_id: int,
                       max_initial_tid: int, suppress_blank: bool,
                       no_timestamps: bool):
    """The filter stage that K5 and K6 share (the TPU's ``_filter_lp``):
    temperature, the suppression rules, the masked log-softmax and the
    timestamp-mass rule.  Returns (lp, probs, live, ts): (B, V) log-probs
    with -1e30 at every filtered id, their probabilities (exact 0 there),
    the unfiltered mask and the timestamp-id mask."""
    B, V = logits.shape
    dev = logits.device
    neg = torch.tensor(_NEG, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    st = state.to(torch.int64)
    is_initial = st[:, 0:1] != 0
    last, penult, n_tokens = st[:, 1:2], st[:, 2:3], st[:, 3:4]
    has_ts, seek_delta = st[:, 4:5] != 0, st[:, 5:6]

    l = logits.float()
    temp = torch.tensor(temperature, dtype=torch.float32)
    if temp > 0:
        l = l / torch.clamp(temp, min=1e-8).to(dev)
    ids = torch.arange(V, device=dev)[None, :]
    sup = suppress.to(dev, torch.bool)[None, :].expand(B, V)
    if suppress_blank:
        sup = sup | (is_initial & ((ids == eot) | (ids == space_id)))
    if no_timestamps:
        sup = sup | (ids >= beg)
    last_was_ts = (n_tokens > 0) & (last >= beg)
    penult_was_ts = (n_tokens < 2) | (penult >= beg)
    sup = sup | (last_was_ts & penult_was_ts & (ids >= beg))
    sup = sup | (last_was_ts & ~penult_was_ts & (ids < eot))
    sup = sup | (is_initial & (ids > beg + max_initial_tid))
    sup = sup | (has_ts & (ids >= beg)
                 & (ids < beg + torch.div(seek_delta, 2,
                                          rounding_mode="floor")))
    l = torch.where(sup, neg, l)

    m = l.max(dim=1, keepdim=True).values
    se = torch.where(sup, zero, torch.exp(l - m)).sum(dim=1, keepdim=True)
    lp = torch.where(sup, neg, l - (torch.log(se) + m))

    ts = ids >= beg
    ts_m = torch.where(ts, lp, neg).max(dim=1, keepdim=True).values
    ts_se = torch.where(ts & ~sup, torch.exp(lp - ts_m), zero).sum(
        dim=1, keepdim=True)
    ts_lp = torch.where(ts_se > 0, torch.log(ts_se) + ts_m, neg)
    text_m = torch.where(ts, neg, lp).max(dim=1, keepdim=True).values
    lp = torch.where((ts_lp > text_m) & ~ts, neg, lp)
    live = lp > _NEG * 0.5
    probs = torch.where(live, torch.exp(lp), zero)
    return lp, probs, live, ts


def _timestamp_stats(probs, ts):
    """(pt, ptsum, tid) of the filtered distribution: max / sum of the
    timestamp probabilities and the first timestamp id with the max."""
    ts_probs = torch.where(ts, probs, torch.zeros((), device=probs.device))
    sum_ts = ts_probs.sum(dim=1)
    pt = ts_probs.max(dim=1).values / (sum_ts + 1e-10)
    tid = torch.argmax(torch.where(ts, probs, -torch.ones_like(probs)), dim=1)
    return pt, sum_ts, tid


def fused_filter_sample_plain(logits, suppress, state, *, temperature: float,
                              seed: int, eot: int, beg: int, space_id: int,
                              max_initial_tid: int, suppress_blank: bool,
                              no_timestamps: bool) -> SampleOut:
    B, V = logits.shape
    dev = logits.device
    lp, probs, live, ts = _filtered_logprobs(
        logits, suppress, state, temperature=temperature, eot=eot, beg=beg,
        space_id=space_id, max_initial_tid=max_initial_tid,
        suppress_blank=suppress_blank, no_timestamps=no_timestamps)
    flag = state[:, 6] != 0
    if bool(flag.all()):
        choice = probs
    else:
        g = gumbel_hash_noise(seed, B, V, dev)
        choice = torch.where(flag[:, None], probs,
                             torch.where(live, lp + g,
                                         torch.full_like(lp, _NEG)))
    tok = torch.argmax(choice, dim=1)
    rows = torch.arange(B, device=dev)
    p_sel = probs[rows, tok]
    lp_sel = lp[rows, tok]

    pt, sum_ts, tid = _timestamp_stats(probs, ts)
    is_ts_tok = tok >= beg
    tid = torch.where(is_ts_tok, tok, tid)
    pt = torch.where(is_ts_tok, p_sel, pt)
    return SampleOut(token=tok.to(torch.int32), p=p_sel, plog=lp_sel, pt=pt,
                     ptsum=sum_ts, tid=tid.to(torch.int32))


def fused_filter_sample(logits: torch.Tensor, suppress: torch.Tensor,
                        state: torch.Tensor, *, temperature: float, seed: int,
                        eot: int, beg: int, space_id: int,
                        max_initial_tid: int, suppress_blank: bool,
                        no_timestamps: bool) -> SampleOut:
    """Kernel wrapper.  logits (B, V) f32 raw; suppress (V,) bool static
    mask; state (B, 7) int32 (columns as in the module docstring).  CUDA
    tensors launch csrc/filter_sample.cu, CPU tensors take the plain
    version."""
    kw = dict(temperature=temperature, seed=seed, eot=eot, beg=beg,
              space_id=space_id, max_initial_tid=max_initial_tid,
              suppress_blank=suppress_blank, no_timestamps=no_timestamps)
    if logits.device.type == "cpu":
        return fused_filter_sample_plain(logits, suppress, state, **kw)
    kernels.require_cuda("fused_filter_sample", logits, suppress, state)
    B, V = logits.shape
    if (logits.dtype != torch.float32
            or suppress.dtype not in (torch.bool, torch.uint8)
            or tuple(suppress.shape) != (V,) or state.dtype != torch.int32
            or tuple(state.shape) != (B, 7)):
        raise ValueError("fused_filter_sample: logits (B, V) f32, "
                         "suppress (V,) bool, state (B, 7) int32")
    C, width = filter_plan(B, V, WIDE_VOCAB)
    dev = logits.device
    tok = torch.empty(B, dtype=torch.int32, device=dev)
    tid = torch.empty(B, dtype=torch.int32, device=dev)
    p, plog, pt, ptsum = (torch.empty(B, dtype=torch.float32, device=dev)
                          for _ in range(4))
    k = kernels
    fn = k.entry("filter_sample", "gwt_filter_sample",
                 (k.P,) * 9 + (k.I,) * 10 + (k.F, k.U, k.P))
    k.launch(fn, "gwt_filter_sample", dev,
             logits.data_ptr(), suppress.data_ptr(),
             state.data_ptr(), tok.data_ptr(), p.data_ptr(), plog.data_ptr(),
             pt.data_ptr(), ptsum.data_ptr(), tid.data_ptr(), B, V, C,
             width // FILTER_THREADS, eot, beg, space_id, max_initial_tid,
             int(suppress_blank), int(no_timestamps), float(temperature),
             seed & _MASK32)
    fused_filter_sample.launches += 1
    return SampleOut(token=tok, p=p, plog=plog, pt=pt, ptsum=ptsum, tid=tid)


fused_filter_sample.launches = 0


def fused_filter_topk_plain(logits, suppress, state, *, K: int,
                            temperature: float, eot: int, beg: int,
                            space_id: int, max_initial_tid: int,
                            suppress_blank: bool,
                            no_timestamps: bool) -> TopKOut:
    B = logits.shape[0]
    lp, probs, _, ts = _filtered_logprobs(
        logits, suppress, state, temperature=temperature, eot=eot, beg=beg,
        space_id=space_id, max_initial_tid=max_initial_tid,
        suppress_blank=suppress_blank, no_timestamps=no_timestamps)
    pt, ptsum, tid = _timestamp_stats(probs, ts)
    rows = torch.arange(B, device=lp.device)
    work = lp.clone()
    ids = []
    for _ in range(K):   # argmax + mask passes: lowest index wins ties
        j = torch.argmax(work, dim=1)
        ids.append(j)
        work[rows, j] = _NEG
    ids = torch.stack(ids, dim=1)
    plog = torch.gather(lp, 1, ids)
    p = torch.gather(probs, 1, ids)
    return TopKOut(plog=plog, ids=ids.to(torch.int32), p=p, pt=pt,
                   ptsum=ptsum, tid=tid.to(torch.int32))


def fused_filter_topk(logits: torch.Tensor, suppress: torch.Tensor,
                      state: torch.Tensor, *, K: int, temperature: float,
                      eot: int, beg: int, space_id: int, max_initial_tid: int,
                      suppress_blank: bool, no_timestamps: bool) -> TopKOut:
    """Kernel wrapper.  logits (B, V) f32 raw; suppress (V,) bool; state
    (B, 7) int32 as for ``fused_filter_sample`` (column 6 is not read).
    CUDA tensors launch csrc/filter_sample.cu's top-K kernel (K <= 32),
    CPU tensors take the plain version.  Past the row's last id above
    -1e30 every slot takes id 0, as K argmax-and-mask passes do."""
    kw = dict(K=K, temperature=temperature, eot=eot, beg=beg,
              space_id=space_id, max_initial_tid=max_initial_tid,
              suppress_blank=suppress_blank, no_timestamps=no_timestamps)
    if logits.device.type == "cpu":
        return fused_filter_topk_plain(logits, suppress, state, **kw)
    kernels.require_cuda("fused_filter_topk", logits, suppress, state)
    B, V = logits.shape
    if (logits.dtype != torch.float32
            or suppress.dtype not in (torch.bool, torch.uint8)
            or tuple(suppress.shape) != (V,) or state.dtype != torch.int32
            or tuple(state.shape) != (B, 7)
            or not 1 <= K <= min(V, MAX_TOPK)):
        raise ValueError("fused_filter_topk: logits (B, V) f32, suppress "
                         "(V,) bool, state (B, 7) int32, "
                         f"1 <= K <= {MAX_TOPK}")
    C, width = filter_plan(B, V)
    dev = logits.device
    plog = torch.empty((B, K), dtype=torch.float32, device=dev)
    ids = torch.empty((B, K), dtype=torch.int32, device=dev)
    p = torch.empty((B, K), dtype=torch.float32, device=dev)
    pt, ptsum = (torch.empty(B, dtype=torch.float32, device=dev)
                 for _ in range(2))
    tid = torch.empty(B, dtype=torch.int32, device=dev)
    k = kernels
    fn = k.entry("filter_sample", "gwt_filter_topk",
                 (k.P,) * 9 + (k.I,) * 11 + (k.F, k.P))
    k.launch(fn, "gwt_filter_topk", dev,
             logits.data_ptr(), suppress.data_ptr(),
             state.data_ptr(), plog.data_ptr(), ids.data_ptr(), p.data_ptr(),
             pt.data_ptr(), ptsum.data_ptr(), tid.data_ptr(), B, V, C,
             width // FILTER_THREADS, K, eot, beg, space_id, max_initial_tid,
             int(suppress_blank), int(no_timestamps), float(temperature))
    fused_filter_topk.launches += 1
    return TopKOut(plog=plog, ids=ids, p=p, pt=pt, ptsum=ptsum, tid=tid)


fused_filter_topk.launches = 0
