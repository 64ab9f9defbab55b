"""K2: encoder self-attention (csrc/enc_attn.cu) and its plain version.

Counterpart of the JAX package's ``ops/attention.py`` entry
``flash_attention_bh`` (TPU kernel ``_flash_sp_kernel``): head-major
``(BH, T, D)`` q/k/v, softmax(q k^T / sqrt(D)) v with key columns >=
``t_valid`` masked at -1e30.  The kernel handles any T itself.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import kernels as K

_NEG = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


def flash_attention_bh(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       t_valid: Optional[int] = None) -> torch.Tensor:
    """Kernel wrapper: (BH, T, D) q/k/v (f32 or bf16, D 32 or 64) ->
    (BH, T, D) in q's dtype.  CUDA tensors launch csrc/enc_attn.cu, CPU
    tensors take the plain version."""
    if q.device.type == "cpu":
        return attention_bh_plain(q, k, v, t_valid)
    K.require_cuda("flash_attention_bh", q, k, v)
    bh, t, d = q.shape
    tv = t if t_valid is None else int(t_valid)
    if (q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype
            or k.shape != q.shape or v.shape != q.shape or d not in (32, 64)
            or not 1 <= tv <= t):
        raise ValueError("flash_attention_bh: q/k/v (BH, T, 32|64) of one "
                         "dtype (f32/bf16), 1 <= t_valid <= T")
    out = torch.empty_like(q)
    fn = K.entry("enc_attn", "gwt_enc_attn",
                 (K.P, K.P, K.P, K.P, K.I, K.I, K.I, K.I, K.F, K.I, K.P))
    K.launch(fn, "gwt_enc_attn", q.data_ptr(), k.data_ptr(), v.data_ptr(),
             out.data_ptr(), bh, t, d, tv, float(d ** -0.5), _DTYPES[q.dtype],
             K.stream_ptr(q.device))
    flash_attention_bh.launches += 1
    return out


flash_attention_bh.launches = 0
