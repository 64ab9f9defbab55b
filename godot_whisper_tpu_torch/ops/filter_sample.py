"""K5: fused logit filter + sampler (csrc/filter_sample.cu) and its plain
version.

Counterpart of the JAX package's ``ops/filter_sample.py`` entry
``fused_filter_sample`` (TPU kernel ``_kernel`` with ``_filter_lp``):
temperature, the suppression rules, masked log-softmax with the -1e30
sentinel, the timestamp-mass rule, then argmax over probabilities or
Gumbel-max sampling per row, and the timestamp statistics.

Per-row decode state rides in one ``(B, 7)`` int32 tensor, as in the JAX
kernel: ``[is_initial, last, penult, n_tokens, has_ts, seek_delta,
argmax_flag]``.  The Gumbel noise is a counter hash of (seed, row, id) that
both versions compute, so they agree at t > 0 as well.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import kernels as K

_NEG = -1e30
_MASK32 = 0xFFFFFFFF


class SampleOut(NamedTuple):
    token: torch.Tensor   # (B,) int32
    p: torch.Tensor       # (B,) f32
    plog: torch.Tensor    # (B,) f32
    pt: torch.Tensor      # (B,) f32
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


def fused_filter_sample_plain(logits, suppress, state, *, temperature: float,
                              seed: int, eot: int, beg: int, space_id: int,
                              max_initial_tid: int, suppress_blank: bool,
                              no_timestamps: bool) -> SampleOut:
    B, V = logits.shape
    dev = logits.device
    neg = torch.tensor(_NEG, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    st = state.to(torch.int64)
    is_initial = st[:, 0:1] != 0
    last, penult, n_tokens = st[:, 1:2], st[:, 2:3], st[:, 3:4]
    has_ts, seek_delta = st[:, 4:5] != 0, st[:, 5:6]
    flag = st[:, 6] != 0

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

    if bool(flag.all()):
        choice = probs
    else:
        g = gumbel_hash_noise(seed, B, V, dev)
        choice = torch.where(flag[:, None], probs,
                             torch.where(live, lp + g, neg))
    tok = torch.argmax(choice, dim=1)
    rows = torch.arange(B, device=dev)
    p_sel = probs[rows, tok]
    lp_sel = lp[rows, tok]

    ts_probs = torch.where(ts, probs, zero)
    sum_ts = ts_probs.sum(dim=1)
    max_ts = ts_probs.max(dim=1).values
    tid = torch.argmax(torch.where(ts, probs, -torch.ones_like(probs)), dim=1)
    pt = max_ts / (sum_ts + 1e-10)
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
    K.require_cuda("fused_filter_sample", logits, suppress, state)
    B, V = logits.shape
    if (logits.dtype != torch.float32
            or suppress.dtype not in (torch.bool, torch.uint8)
            or tuple(suppress.shape) != (V,) or state.dtype != torch.int32
            or tuple(state.shape) != (B, 7) or V > 56000):
        raise ValueError("fused_filter_sample: logits (B, V<=56000) f32, "
                         "suppress (V,) bool, state (B, 7) int32")
    dev = logits.device
    tok = torch.empty(B, dtype=torch.int32, device=dev)
    tid = torch.empty(B, dtype=torch.int32, device=dev)
    p, plog, pt, ptsum = (torch.empty(B, dtype=torch.float32, device=dev)
                          for _ in range(4))
    fn = K.entry("filter_sample", "gwt_filter_sample",
                 (K.P,) * 9 + (K.I,) * 8 + (K.F, K.U, K.P))
    K.launch(fn, "gwt_filter_sample", logits.data_ptr(), suppress.data_ptr(),
             state.data_ptr(), tok.data_ptr(), p.data_ptr(), plog.data_ptr(),
             pt.data_ptr(), ptsum.data_ptr(), tid.data_ptr(), B, V, eot, beg,
             space_id, max_initial_tid, int(suppress_blank),
             int(no_timestamps), float(temperature), seed & _MASK32,
             K.stream_ptr(dev))
    fused_filter_sample.launches += 1
    return SampleOut(token=tok, p=p, plog=plog, pt=pt, ptsum=ptsum, tid=tid)


fused_filter_sample.launches = 0
