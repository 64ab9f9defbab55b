"""K11/K12: single-query cross-attention over an int8 merged-head cache
(csrc/cross_attn.cu) and its plain version.

Counterpart of the JAX package's ``ops/cross_attention.py`` entry
``cross_attention_quant``.  The cache is ``models.model.QuantCrossKV``: k_q,
v_q (L, G, T, S) int8, k_s (L, G, T, 128) bf16 (one scale per slot and head,
head axis padded to 128), v_s (L, G, 128) f32 (one per head).  Rows
``g * kv_group .. g * kv_group + kv_group - 1`` share K/V row g.

Dispatch follows the JAX package (``cross_attention.py:286-303``):

- ``kv_group * n_head <= 128`` (kv_group 1 included): K12, the packed
  kernel, softmax blocks of 512 slots when T % 512 == 0 (else 256), in W8A8
  mode by default or exact mode;
- otherwise K11, exact mode, softmax blocks of 256 slots.

Both run one kernel template on the card: a thread-block cluster of CTAs
per (group, head), each taking 64 slots of every block (``cluster_plan``,
``wide_cluster_plan``), which share the block's running max and add their
P.V partials in rank order.  K11 is that template's exact mode with
256-slot blocks under its own entry and launch counter.

The plain version repeats the kernels' arithmetic block by block (the
online-softmax running max decides where p is rounded), so it agrees with
the TPU kernels' interpret mode and with the CUDA kernel; the JAX package's
own CPU branch instead dequantizes and keeps f32 probabilities.
"""

from __future__ import annotations

import collections
import os
from typing import Optional, Tuple

import torch

from . import kernels as K

_NEG = -1e30
H_PAD = 128
MAX_KV_GROUP = 8  # MAX_DECODERS


def w8a8_default() -> bool:
    """The packed kernel's W8A8 mode is the default; ``GWT_XATTN_EXACT=1``
    selects the exact mode (the JAX package's switch, both modes run the
    kernel)."""
    return os.environ.get("GWT_XATTN_EXACT") != "1"


def is_packed(n_head: int, kv_group: int) -> bool:
    """K12 (packed) when a group's rows times heads fit one 128-lane tile."""
    return kv_group * n_head <= H_PAD


def softmax_block(t_pad: int, packed: bool) -> int:
    return 512 if packed and t_pad % 512 == 0 else 256


CLUSTER_SLICE = 64  # slots of each softmax block one K12 CTA takes
MAX_CLUSTER = 8     # CTAs of a portable thread-block cluster


def cluster_plan(g: int, n_head: int, t_pad: int) -> Tuple[int, int]:
    """K12's slice and cluster size: (64, blk / 64) for the softmax block
    ``blk`` of ``t_pad`` slots, 8 CTAs per (group, head) for blocks of 512
    and 4 for 256; grid (cluster, n_head, g).  CTA r of a cluster takes
    slots [64 r, 64 r + 64) of every block.  Shapes decide, never the
    valid lengths, so every call and graph replay has the same grid."""
    return _plan("cluster_plan", g, n_head, softmax_block(t_pad, True),
                 t_pad)


def wide_cluster_plan(g: int, n_head: int, t_pad: int) -> Tuple[int, int]:
    """K11's slice and cluster size: (64, 4), its 256-slot softmax block
    over a cluster of 4 CTAs per (group, head); grid (4, n_head, g), for
    large-v3 widths at beam 8 and one stream 80 CTAs.  Up to 8 rows of a
    group share each CTA, so the plan does not depend on kv_group; shapes
    decide, never the valid lengths."""
    return _plan("wide_cluster_plan", g, n_head, softmax_block(t_pad, False),
                 t_pad)


def _plan(what: str, g: int, n_head: int, blk: int,
          t_pad: int) -> Tuple[int, int]:
    if g < 1 or not 1 <= n_head <= H_PAD or t_pad % blk:
        raise ValueError(f"{what}: {g} groups, {n_head} heads, "
                         f"{t_pad} slots")
    return CLUSTER_SLICE, blk // CLUSTER_SLICE


def cross_attention_quant_plain(q, k_q, k_s, v_q, v_s, t_valid, *,
                                n_head: int, kv_group: int = 1,
                                layer: int = 0,
                                w8a8: bool = True) -> torch.Tensor:
    """The kernels' math in PyTorch: per softmax block the running max, p
    rounded to bf16 (exact) or to round(127 p) (W8A8, packed only), f32
    sums of the unrounded p.  Returns (B, S) f32."""
    kql, ksl, vql, vsl = k_q[layer], k_s[layer], v_q[layer], v_s[layer]
    b, s = q.shape
    d = s // n_head
    g, t_pad = kql.shape[0], kql.shape[1]
    R = kv_group
    packed = is_packed(n_head, kv_group)
    w8a8 = w8a8 and packed
    blk = softmax_block(t_pad, packed)
    lo = t_valid.reshape(g, R, 1, 1).to(kql.device)
    n_blocks = max(-(-int(t_valid.max()) // blk), 1)
    scale = (s // n_head) ** -0.5

    qh = q.to(torch.bfloat16).float().reshape(g, R, n_head, d)
    if w8a8:
        # XLA compiles the TPU kernel's ``/ 127.0`` to ``* f32(1/127)``
        qs = torch.clamp_min(qh.abs().amax(dim=-1, keepdim=True),
                             1e-20) * (1.0 / 127.0)
        qh = torch.round(qh / qs)
        qss = qs[..., 0] * scale                              # (g, R, H)
    kh = kql.reshape(g, t_pad, n_head, d)
    vh = vql.reshape(g, t_pad, n_head, d)
    ks = ksl[..., :n_head].float()                            # (g, T, H)
    m = torch.full((g, R, n_head), _NEG, device=q.device)
    l = torch.zeros((g, R, n_head), device=q.device)
    acc = torch.zeros((g, R, n_head, d), device=q.device)
    for c in range(n_blocks):
        sl = slice(c * blk, (c + 1) * blk)
        sc = torch.einsum("grhd,gchd->grhc", qh, kh[:, sl].float())
        sc = sc * qss[..., None] if w8a8 else sc * scale
        sc = sc * ks[:, sl].permute(0, 2, 1)[:, None]
        slot = torch.arange(c * blk, (c + 1) * blk, device=q.device)
        sc = torch.where(slot < lo, sc, torch.full_like(sc, _NEG))
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        m = m_new
        pr = (torch.round(p * 127.0) if w8a8
              else p.to(torch.bfloat16).float())
        pv = torch.einsum("grhc,gchd->grhd", pr, vh[:, sl].float())
        acc = acc * corr[..., None] + (pv * (1.0 / 127.0) if w8a8 else pv)
    out = acc / torch.clamp_min(l, 1e-30)[..., None] \
        * vsl[:, :n_head].float()[:, None, :, None]
    return out.reshape(b, s)


def w8a8_flip_limit(q, k_q, k_s, v_s, t_valid, *, n_head: int,
                    kv_group: int = 1, layer: int = 0) -> torch.Tensor:
    """How far one flipped rounding of 127 p moves a W8A8 output element,
    the limit for comparing two W8A8 implementations whose exp() differ in
    the last bit.  A flip moves P.V by at most max|v_q| = 127 units of
    1/127, so output (row, head) moves by at most v_s[h] / l, l the softmax
    denominator sum_c exp(s_c - max s) over the valid slots (float scores
    of the dequantized K).  Returns (B, S) f32."""
    kql, ksl, vsl = k_q[layer], k_s[layer], v_s[layer]
    b, s = q.shape
    d = s // n_head
    g, t = kql.shape[0], kql.shape[1]
    qh = q.float().reshape(g, kv_group, n_head, d)
    kf = kql.float().reshape(g, t, n_head, d) \
        * ksl[..., :n_head].float()[..., None]
    sc = torch.einsum("grhd,gthd->grht", qh, kf) * d ** -0.5
    valid = (torch.arange(t, device=sc.device)
             < t_valid.to(sc.device).reshape(g, kv_group, 1, 1))
    sc = torch.where(valid, sc, torch.full_like(sc, float("-inf")))
    denom = torch.exp(sc - sc.amax(dim=-1, keepdim=True)).sum(dim=-1)
    lim = vsl[:, :n_head].float()[:, None] / denom             # (g, R, H)
    return lim.reshape(b, n_head, 1).expand(b, n_head, d).reshape(b, s)


def _check(fn_name: str, q, k_q, k_s, v_q, v_s, lo, *, n_head: int,
           kv_group: int, layer: int, blk: int):
    """Validate a K11 / K12 call; returns q as contiguous bf16 on a 4-byte
    boundary (the kernel reads it by words)."""
    qb = q.to(torch.bfloat16).contiguous()
    if qb.data_ptr() % 4:
        qb = qb.clone()
    K.require_cuda(fn_name, qb, k_q, k_s, v_q, v_s, lo)
    b, s = qb.shape
    n_layer, g, t_pad, s_k = k_q.shape
    if (k_q.dtype != torch.int8 or v_q.dtype != torch.int8
            or v_q.shape != k_q.shape or s_k != s
            or k_s.dtype != torch.bfloat16
            or tuple(k_s.shape) != (n_layer, g, t_pad, H_PAD)
            or v_s.dtype != torch.float32
            or tuple(v_s.shape) != (n_layer, g, H_PAD)
            or s % n_head or s // n_head not in (16, 32, 64)
            or not 1 <= kv_group <= MAX_KV_GROUP or g * kv_group != b
            or not 0 <= layer < n_layer or t_pad % blk
            or lo.dtype != torch.int32 or tuple(lo.shape) != (b,)
            or k_q.data_ptr() % 16 or v_q.data_ptr() % 16
            or k_s.data_ptr() % 4):
        raise ValueError(f"{fn_name}: q (B, S), k_q/v_q (L, B/kv_group, T, S) "
                         "int8, k_s (L, G, T, 128) bf16, v_s (L, G, 128) f32, "
                         "head dim 16|32|64, kv_group <= 8, T a multiple of "
                         "the softmax block, t_valid (B,) int32, k_q / v_q "
                         "16-byte aligned")
    return qb


def xattn_q_wide(q, k_q, k_s, v_q, v_s, lo, *, n_head: int, kv_group: int,
                 layer: int) -> torch.Tensor:
    """K11 on the card: exact mode, softmax blocks of 256 slots, a cluster
    of CTAs per (group, head) (``wide_cluster_plan``)."""
    sl, nc = wide_cluster_plan(k_q.shape[1], n_head, k_q.shape[2])
    qb = _check("xattn_q_wide", q, k_q, k_s, v_q, v_s, lo, n_head=n_head,
                kv_group=kv_group, layer=layer, blk=sl * nc)
    b, s = qb.shape
    out = torch.empty((b, s), dtype=torch.float32, device=q.device)
    fn = K.entry("cross_attn", "gwt_xattn_q", (K.P,) * 7 + (K.I,) * 7
                 + (K.F, K.P))
    K.launch(fn, "xattn_q_wide", q.device, qb.data_ptr(), k_q.data_ptr(),
             k_s.data_ptr(), v_q.data_ptr(), v_s.data_ptr(), lo.data_ptr(),
             out.data_ptr(), int(layer), k_q.shape[1], k_q.shape[2], s,
             n_head, kv_group, sl * nc, float((s // n_head) ** -0.5))
    K.count(xattn_q_wide)
    return out


def xattn_q_packed(q, k_q, k_s, v_q, v_s, lo, *, n_head: int, kv_group: int,
                   layer: int, w8a8: bool) -> torch.Tensor:
    """K12 on the card: W8A8 or exact mode, softmax blocks of 512 slots
    when T % 512 == 0, a cluster of CTAs per (group, head)
    (``cluster_plan``)."""
    sl, nc = cluster_plan(k_q.shape[1], n_head, k_q.shape[2])
    qb = _check("xattn_q_packed", q, k_q, k_s, v_q, v_s, lo, n_head=n_head,
                kv_group=kv_group, layer=layer, blk=sl * nc)
    b, s = qb.shape
    out = torch.empty((b, s), dtype=torch.float32, device=q.device)
    fn = K.entry("cross_attn", "gwt_xattn_packed", (K.P,) * 7 + (K.I,) * 8
                 + (K.F, K.P))
    K.launch(fn, "xattn_q_packed", q.device, qb.data_ptr(), k_q.data_ptr(),
             k_s.data_ptr(), v_q.data_ptr(), v_s.data_ptr(), lo.data_ptr(),
             out.data_ptr(), int(layer), k_q.shape[1], k_q.shape[2], s,
             n_head, kv_group, sl * nc, int(w8a8),
             float((s // n_head) ** -0.5))
    K.count(xattn_q_packed,
            (xattn_q_packed.mode_launches, "w8a8" if w8a8 else "exact"))
    return out


def cross_attention_quant(q: torch.Tensor, k_q: torch.Tensor,
                          k_s: torch.Tensor, v_q: torch.Tensor,
                          v_s: torch.Tensor, *, n_head: int,
                          t_valid: torch.Tensor, kv_group: int = 1,
                          layer: int = 0,
                          w8a8: Optional[bool] = None) -> torch.Tensor:
    """Single-query cross-attention against int8 merged-head K/V.

    q (B, S); k_q/v_q (L, B // kv_group, T, S) int8 with ``layer`` a host
    int; k_s (L, B // kv_group, T, 128) bf16; v_s (L, B // kv_group, 128)
    f32; t_valid (B,) int32.  ``w8a8`` None reads ``w8a8_default()``; it
    applies to the packed kernel only.  CUDA tensors launch
    csrc/cross_attn.cu (K12 when kv_group * n_head <= 128, else K11), CPU
    tensors take the plain version.  Returns (B, S) f32."""
    w8a8 = w8a8_default() if w8a8 is None else w8a8
    if q.device.type == "cpu":
        return cross_attention_quant_plain(q, k_q, k_s, v_q, v_s, t_valid,
                                           n_head=n_head, kv_group=kv_group,
                                           layer=layer, w8a8=w8a8)
    lo = t_valid.to(q.device, torch.int32).contiguous()
    if is_packed(n_head, kv_group):
        return xattn_q_packed(q, k_q, k_s, v_q, v_s, lo, n_head=n_head,
                              kv_group=kv_group, layer=layer, w8a8=w8a8)
    return xattn_q_wide(q, k_q, k_s, v_q, v_s, lo, n_head=n_head,
                        kv_group=kv_group, layer=layer)


xattn_q_wide.launches = 0
xattn_q_packed.launches = 0
xattn_q_packed.mode_launches = collections.Counter()
