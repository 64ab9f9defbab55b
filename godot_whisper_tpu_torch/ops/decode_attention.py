"""K3/K4: single-query decode attention over merged-head caches
(csrc/decode_attn.cu) and its plain version.

Counterpart of the JAX package's ``ops/decode_attention.py`` entry
``decode_attention``.  Its two TPU kernels -- ``_decode_attn_kernel`` (one
K/V row per query row) and ``_decode_attn_group_packed_kernel`` (``kv_group``
query rows, the best_of decoders of one stream, sharing one K/V row) --
compute one function, so the port has one kernel for both.

Slot c of row b is valid iff ``c < lo[b]`` or ``split <= c < hi``:

- self-attention: lo = per-row prompt length, split = padded prompt
  capacity, hi = split + step + 1;
- cross-attention: lo = valid audio positions, split = C, hi = 0.

The caches enter as the full stacked ``(L, B // kv_group, C, S)`` tensors
with ``layer`` selecting the layer: the kernel reads it by pointer offset,
so no per-layer copy is ever made.
"""

from __future__ import annotations

import collections

import torch

from . import kernels as K

_NEG = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_KV_GROUP = 8  # MAX_DECODERS


def decode_attention_plain(q, k, v, lo, hi: int, *, split: int, n_head: int,
                           kv_group: int = 1, layer: int = 0):
    """The JAX package's ``_fallback``: heads split out, f32 masked
    softmax.  Returns (B, S) f32."""
    k, v = k[layer], v[layer]
    b, s = q.shape
    c = k.shape[1]
    d = s // n_head
    if kv_group > 1:
        k = k.repeat_interleave(kv_group, dim=0)
        v = v.repeat_interleave(kv_group, dim=0)
    qh = q.reshape(b, n_head, d).float() * (d ** -0.5)
    kh = k.reshape(b, c, n_head, d).float()
    vh = v.reshape(b, c, n_head, d).float()
    scores = torch.einsum("bhd,bchd->bhc", qh, kh)
    slot = torch.arange(c, device=q.device)[None, None, :]
    ok = (slot < lo.reshape(b, 1, 1)) | ((slot >= split) & (slot < hi))
    scores = torch.where(ok, scores, torch.full_like(scores, _NEG))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhc,bchd->bhd", p, vh).reshape(b, s)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lo: torch.Tensor, hi: int, *, split: int, n_head: int,
                     kv_group: int = 1, layer: int = 0) -> torch.Tensor:
    """Kernel wrapper.  q (B, S); k/v (L, B // kv_group, C, S); lo (B,)
    int32; hi, split, layer host ints.
    CUDA tensors launch csrc/decode_attn.cu, CPU tensors take the plain
    version.  Returns (B, S) f32."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, lo, hi, split=split,
                                      n_head=n_head, kv_group=kv_group,
                                      layer=layer)
    K.require_cuda("decode_attention", q, k, v, lo)
    b, s = q.shape
    n_layer, g, c, s_k = k.shape
    if (q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype
            or v.shape != k.shape or s_k != s or s % n_head
            or s // n_head not in (32, 64)
            or not 1 <= kv_group <= MAX_KV_GROUP or g * kv_group != b
            or not 0 <= layer < n_layer or lo.dtype != torch.int32
            or tuple(lo.shape) != (b,)):
        raise ValueError("decode_attention: q (B, S), k/v (L, B/kv_group, C, "
                         "S) of q's dtype (f32/bf16), head dim 32|64, "
                         "kv_group <= 8, lo (B,) int32")
    out = torch.empty((b, s), dtype=torch.float32, device=q.device)
    fn = K.entry("decode_attn", "gwt_decode_attn",
                 (K.P, K.P, K.P, K.P, K.P, K.I, K.I, K.I, K.I, K.I, K.I, K.I,
                  K.I, K.F, K.I, K.P))
    K.launch(fn, "gwt_decode_attn", q.data_ptr(), k.data_ptr(), v.data_ptr(),
             lo.data_ptr(), out.data_ptr(), int(layer), g, c, s, n_head,
             kv_group, int(split), int(hi), float((s // n_head) ** -0.5),
             _DTYPES[q.dtype], K.stream_ptr(q.device))
    decode_attention.launches += 1
    decode_attention.group_launches[kv_group] += 1
    return out


decode_attention.launches = 0
# launches split by kv_group: 1 is the TPU's K3 case, > 1 its K4 case
decode_attention.group_launches = collections.Counter()
