"""K7: beam self-attention over a split prompt / live cache
(csrc/split_attn.cu) and its plain version.

Counterpart of the JAX package's ``ops/split_attention.py`` entry
``split_beam_attention`` (TPU kernel ``_split_beam_kernel``).  Beam decode
stores the prompt K/V once per beam group, ``(L, G, CP, S)``, and the
autoregressive K/V per beam, ``(L, B, NL, S)`` with ``B = G * kv_group``,
written at live slot i.  The beam merge moves no cache bytes: it permutes a
``(B, NL)`` row map, and beam b's live slot t is read from row
``group_base + rowmap[b, t]`` (the reference's kv_cache_seq_cp re-tag,
whisper.cpp:5402-5418).  Prompt slot c of beam b is valid iff
``c < lo[b]``; live slot t iff ``t < hi_live``.
"""

from __future__ import annotations

import torch

from . import kernels as K
from .decode_attention import decode_attention_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_KV_GROUP = 8  # MAX_DECODERS


def split_beam_attention_plain(q, kp, vp, kl, vl, lo, hi_live: int, *,
                               n_head: int, kv_group: int, layer: int,
                               rowmap):
    """The JAX package's CPU branch: gather each beam's live history through
    the row map, append it to the group's prompt repeated per beam, and run
    the merged-cache attention with ``split = CP``.  Returns (B, S) f32."""
    b, s = q.shape
    nl = kl.shape[2]
    g = b // kv_group
    kpl, vpl, kll, vll = kp[layer], vp[layer], kl[layer], vl[layer]
    idx = rowmap.to(kl.device, torch.int64).reshape(g, kv_group, nl, 1)
    idx = idx.expand(g, kv_group, nl, s)
    kll = torch.gather(kll.reshape(g, kv_group, nl, s), 1, idx).reshape(
        b, nl, s)
    vll = torch.gather(vll.reshape(g, kv_group, nl, s), 1, idx).reshape(
        b, nl, s)
    kfull = torch.cat([kpl.repeat_interleave(kv_group, dim=0), kll], dim=1)
    vfull = torch.cat([vpl.repeat_interleave(kv_group, dim=0), vll], dim=1)
    cp = kpl.shape[1]
    return decode_attention_plain(q, kfull[None], vfull[None], lo,
                                  cp + int(hi_live), split=cp, n_head=n_head)


def split_beam_attention(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                         kl: torch.Tensor, vl: torch.Tensor, lo: torch.Tensor,
                         hi_live: int, *, n_head: int, kv_group: int,
                         layer: int, rowmap: torch.Tensor) -> torch.Tensor:
    """Kernel wrapper.  q (B, S); kp/vp (L, G, CP, S); kl/vl (L, B, NL, S)
    of q's dtype; lo (B,) int32; rowmap (B, NL) int32 with values in
    [0, kv_group); hi_live and layer host ints.  CUDA tensors launch
    csrc/split_attn.cu, CPU tensors take the plain version.  Returns
    (B, S) f32."""
    if q.device.type == "cpu":
        return split_beam_attention_plain(q, kp, vp, kl, vl, lo, hi_live,
                                          n_head=n_head, kv_group=kv_group,
                                          layer=layer, rowmap=rowmap)
    K.require_cuda("split_beam_attention", q, kp, vp, kl, vl, lo, rowmap)
    b, s = q.shape
    n_layer, g, cp, s_k = kp.shape
    nl = kl.shape[2]
    if (q.dtype not in _DTYPES
            or any(t.dtype != q.dtype for t in (kp, vp, kl, vl))
            or vp.shape != kp.shape or vl.shape != kl.shape
            or tuple(kl.shape) != (n_layer, b, nl, s) or s_k != s
            or s % n_head or s // n_head not in (32, 64)
            or not 1 <= kv_group <= MAX_KV_GROUP or g * kv_group != b
            or not 0 <= layer < n_layer or not 0 <= hi_live <= nl
            or lo.dtype != torch.int32 or tuple(lo.shape) != (b,)
            or rowmap.dtype != torch.int32
            or tuple(rowmap.shape) != (b, nl)):
        raise ValueError("split_beam_attention: q (B, S), kp/vp (L, B/kv_group"
                         ", CP, S), kl/vl (L, B, NL, S) of q's dtype (f32/bf16"
                         "), head dim 32|64, kv_group <= 8, lo (B,) int32, "
                         "rowmap (B, NL) int32, 0 <= hi_live <= NL")
    out = torch.empty((b, s), dtype=torch.float32, device=q.device)
    fn = K.entry("split_attn", "gwt_split_beam_attn",
                 (K.P,) * 8 + (K.I,) * 8 + (K.F, K.I, K.P))
    K.launch(fn, "gwt_split_beam_attn", q.data_ptr(), kp.data_ptr(),
             vp.data_ptr(), kl.data_ptr(), vl.data_ptr(), lo.data_ptr(),
             rowmap.data_ptr(), out.data_ptr(), int(layer), g, cp, nl, s,
             n_head, kv_group, int(hi_live), float((s // n_head) ** -0.5),
             _DTYPES[q.dtype], K.stream_ptr(q.device))
    split_beam_attention.launches += 1
    return out


split_beam_attention.launches = 0
