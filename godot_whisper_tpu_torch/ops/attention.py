"""Encoder self-attention: K2 (csrc/enc_attn.cu), K13 (csrc/enc_attn_long.cu)
and their plain versions.

Counterpart of the JAX package's ``ops/attention.py`` entry
``flash_attention_bh``: head-major ``(BH, T, D)`` q/k/v, softmax(q k^T /
sqrt(D)) v with key columns >= ``t_valid`` masked at -1e30.  On the card
the route is the JAX package's ``_flash_bthd`` choice: a T whose 512-padded
length is at most 1536 (every registry model, n_audio_ctx 1500) takes K2,
the single-pass ``_flash_sp_kernel``; a longer one (a checkpoint whose
header says n_audio_ctx > 1536) takes K13, the blockwise ``_flash_kernel``,
whose 512-key blocks are rounding points of its function.

The three functions differ only where bf16 rounds: ``attention_bh_plain``
(the JAX package's ``_einsum_attention``), ``attention_bh_sp_plain`` (K2's
function) and ``attention_bh_blocked_plain`` (K13's).  On the CPU,
``flash_attention_bh`` takes the einsum at every T, as the JAX package does
off the TPU; on the card K2 computes the single-pass function and K13 the
blocked one, and the card checks hold each to its plain version.  bf16
inputs run both kernels on the tensor cores (``wgmma``,
csrc/enc_attn_tc.cuh); f32 inputs run their CUDA-core FMA kernels in full
f32.

Under autograd (training, models/training.py) both kernels still compute
the forward; ``RecomputeAttention`` gives their output a gradient by
recomputing the kernel's plain function in the backward.
"""

from __future__ import annotations

import collections

from typing import Optional

import torch

from ..runtime.trace import tracer
from . import kernels as K

_NEG = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BLOCK_K = 512      # K13's softmax block (the TPU kernel's _BLOCK_K)
SP_MAX_T = 1536    # largest padded T of the single-pass route (_SP_MAX_T)


def attention_bh_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       t_valid: Optional[int] = None) -> torch.Tensor:
    """The JAX package's ``_einsum_attention``: f32 scores, softmax, probs
    cast to v's dtype for the p @ v product, output in q's dtype."""
    t, d = k.shape[1], q.shape[-1]
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * (d ** -0.5)
    if t_valid is not None and t_valid < t:
        keep = torch.arange(t, device=q.device) < t_valid
        s = torch.where(keep, s, torch.full_like(s, _NEG))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype), v).to(q.dtype)


def attention_bh_sp_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          t_valid: Optional[int] = None) -> torch.Tensor:
    """K2's function in torch, with ``_flash_sp_kernel``'s rounding points:
    q' = q * scale rounded to q's dtype (the scale rounded to it first), s
    = q' k^T in f32 with masked keys at -1e30, one row max m over all keys,
    p = exp(s - m) rounded to bf16 when the inputs are bf16, l = the sum of
    those p in f32, out = (p . v) / max(l, 1e-30) in q's dtype."""
    t, d = k.shape[1], q.shape[-1]
    tv = t if t_valid is None else int(t_valid)
    pdt = torch.bfloat16 if q.dtype == torch.bfloat16 else torch.float32
    scale = torch.tensor(float(1.0 / (d ** 0.5))).to(q.dtype).float()
    qs = (q.float() * scale).to(q.dtype).float()
    s = torch.matmul(qs, k.float().transpose(1, 2))
    if tv < t:
        keep = torch.arange(t, device=q.device) < tv
        s = torch.where(keep, s, torch.full_like(s, _NEG))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)).to(pdt).float()
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p, v.float())
    return (acc / torch.clamp_min(l, 1e-30)).to(q.dtype)


def attention_bh_blocked_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor,
                               t_valid: Optional[int] = None) -> torch.Tensor:
    """K13's function in torch: an online softmax over 512-key blocks with
    the TPU kernel's rounding points.  Per block, s = (q k^T in f32) *
    scale with masked keys at -1e30, m_new = max(m, rowmax s), p = exp(s -
    m_new) in f32, l = l * exp(m - m_new) + sum(p) from the f32 p, acc =
    acc * exp(m - m_new) + p . v with p rounded to bf16 when the inputs are
    bf16; then acc / max(l, 1e-30) in q's dtype.  A T that is not a
    multiple of 512 ends in a shorter block, which equals padding it with
    masked keys (they add exact zeros)."""
    bh, t, d = q.shape
    tv = t if t_valid is None else int(t_valid)
    pdt = torch.bfloat16 if q.dtype == torch.bfloat16 else torch.float32
    scale = float(1.0 / (d ** 0.5))
    qf = q.float()
    acc = torch.zeros(bh, t, d, dtype=torch.float32, device=q.device)
    m = torch.full((bh, t, 1), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((bh, t, 1), dtype=torch.float32, device=q.device)
    for k0 in range(0, t, BLOCK_K):
        kb = k[:, k0:k0 + BLOCK_K].float()
        vb = v[:, k0:k0 + BLOCK_K].float()
        s = torch.matmul(qf, kb.transpose(1, 2)) * scale
        col = k0 + torch.arange(kb.shape[1], device=q.device)
        s = torch.where(col < tv, s, torch.full_like(s, _NEG))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.matmul(p.to(pdt).float(), vb)
        m = m_new
    return (acc / torch.clamp_min(l, 1e-30)).to(q.dtype)


def _check(what: str, q, k, v, tv: int) -> None:
    K.require_cuda(what, q, k, v)
    t, d = q.shape[1], q.shape[2]
    if (q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype
            or k.shape != q.shape or v.shape != q.shape or d not in (32, 64)
            or not 1 <= tv <= t):
        raise ValueError(f"{what}: q/k/v (BH, T, 32|64) of one dtype "
                         "(f32/bf16), 1 <= t_valid <= T")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError(f"{what}: q/k/v must start on 16-byte boundaries "
                         "(the bf16 kernels copy 16-byte rows)")


class RecomputeAttention(torch.autograd.Function):
    """Encoder attention under autograd: the forward is a kernel's launch,
    exactly as without autograd; the backward recomputes that kernel's
    plain function (``attention_bh_sp_plain`` for K2,
    ``attention_bh_blocked_plain`` for K13) from the saved q, k and v and
    differentiates it, so the gradient is that of the function the forward
    computed, with the same ``t_valid`` masking.  The backward launches no
    kernel: the JAX package has no gradient for its Pallas kernels, so
    there is no backward kernel to port.

    ``apply(q, k, v, t_valid, forward, plain)``: ``forward(q, k, v,
    t_valid)`` computes the output (a kernel's launch on the card; the
    tests pass the plain function on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, t_valid, forward, plain):
        ctx.save_for_backward(q, k, v)
        ctx.t_valid, ctx.plain = t_valid, plain
        return forward(q, k, v, t_valid)

    @staticmethod
    def backward(ctx, grad_out):
        saved = [x.detach().requires_grad_(True) for x in ctx.saved_tensors]
        with torch.enable_grad(), tracer.span(
                "gwt.attn_recompute", device=grad_out.device,
                rows=saved[0].shape[0]):
            out = ctx.plain(*saved, ctx.t_valid)
            grads = torch.autograd.grad(out, saved, grad_out)
        return (*grads, None, None, None)


def _needs_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def flash_attention_bh(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       t_valid: Optional[int] = None) -> torch.Tensor:
    """Encoder attention: (BH, T, D) q/k/v (f32 or bf16, D 32 or 64) ->
    (BH, T, D) in q's dtype.  CPU tensors take the einsum,
    ``attention_bh_plain``, at every T, as the JAX package does off the
    TPU.  On the card a 512-padded T above 1536 goes to K13
    (``flash_attention_long``); a shorter one launches K2
    (csrc/enc_attn.cu: single-pass function, ``attention_bh_sp_plain``),
    through ``RecomputeAttention`` when a gradient is asked for."""
    t = q.shape[1]
    if q.device.type == "cpu":
        return attention_bh_plain(q, k, v, t_valid)
    if -(-t // BLOCK_K) * BLOCK_K > SP_MAX_T:
        return flash_attention_long(q, k, v, t_valid)
    if _needs_grad(q, k, v):
        return RecomputeAttention.apply(q, k, v, t_valid, _enc_attn,
                                        attention_bh_sp_plain)
    return _enc_attn(q, k, v, t_valid)


def _enc_attn(q, k, v, t_valid) -> torch.Tensor:
    """Launch K2 (csrc/enc_attn.cu) on CUDA tensors."""
    bh, t, d = q.shape
    tv = t if t_valid is None else int(t_valid)
    _check("flash_attention_bh", q, k, v, tv)
    out = torch.empty_like(q)
    fn = K.entry("enc_attn", "gwt_enc_attn",
                 (K.P, K.P, K.P, K.P, K.I, K.I, K.I, K.I, K.F, K.I, K.P))
    K.launch(fn, "gwt_enc_attn", q.device,
             q.data_ptr(), k.data_ptr(), v.data_ptr(),
             out.data_ptr(), bh, t, d, tv, float(d ** -0.5), _DTYPES[q.dtype])
    flash_attention_bh.launches += 1
    flash_attention_bh.ctx_launches[tv] += 1
    return out


def flash_attention_long(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         t_valid: Optional[int] = None) -> torch.Tensor:
    """K13 wrapper: (BH, T, D) q/k/v (f32 or bf16, D 32 or 64), any T, keys
    >= ``t_valid`` masked -> (BH, T, D) in q's dtype.  CUDA tensors launch
    csrc/enc_attn_long.cu (through ``RecomputeAttention`` when a gradient
    is asked for), CPU tensors take ``attention_bh_blocked_plain``."""
    if q.device.type == "cpu":
        return attention_bh_blocked_plain(q, k, v, t_valid)
    if _needs_grad(q, k, v):
        return RecomputeAttention.apply(q, k, v, t_valid, _enc_attn_long,
                                        attention_bh_blocked_plain)
    return _enc_attn_long(q, k, v, t_valid)


def _enc_attn_long(q, k, v, t_valid) -> torch.Tensor:
    """Launch K13 (csrc/enc_attn_long.cu) on CUDA tensors."""
    bh, t, d = q.shape
    tv = t if t_valid is None else int(t_valid)
    _check("flash_attention_long", q, k, v, tv)
    out = torch.empty_like(q)
    fn = K.entry("enc_attn_long", "gwt_enc_attn_long",
                 (K.P, K.P, K.P, K.P, K.I, K.I, K.I, K.I, K.F, K.I, K.P))
    K.launch(fn, "gwt_enc_attn_long", q.device, q.data_ptr(), k.data_ptr(),
             v.data_ptr(), out.data_ptr(), bh, t, d, tv, float(d ** -0.5),
             _DTYPES[q.dtype])
    flash_attention_long.launches += 1
    return out


flash_attention_bh.launches = 0
# K2 launches by the valid sequence length (the encoder's audio_ctx)
flash_attention_bh.ctx_launches = collections.Counter()
flash_attention_long.launches = 0
