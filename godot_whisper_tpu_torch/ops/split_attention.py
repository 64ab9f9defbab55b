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

The kernel splits both caches across CTAs (csrc/decode_split.cuh): prompt
slices score all beams of a group, live slices one beam each, and the last
CTA of a (group, head) pair merges each beam's partials in split order.
``split_beam_attention_split_plain`` follows that slicing in torch for the
CPU tests; the wrapper never calls it.
"""

from __future__ import annotations

import torch

from . import kernels as K
from .decode_attention import (H100_SMS, decode_attention_plain,
                               merge_partials, slice_partial, split_plan)

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


def split_beam_attention_split_plain(q, kp, vp, kl, vl, lo, hi_live: int, *,
                                     n_head: int, kv_group: int, layer: int,
                                     rowmap, n_sms: int = H100_SMS):
    """The kernel's slicing and ordered merge in torch: the same function as
    ``split_beam_attention_plain`` with the f32 sums taken per slice of
    ``split_plan``'s length (prompt slices over all beams of a group, then
    each beam's live slices over its gathered rows) and merged in split
    order; slices past max(lo) or hi_live are skipped, as the kernel never
    loads them.  For the CPU tests only.  Returns (B, S) f32."""
    b, s = q.shape
    R = kv_group
    g, cp = kp.shape[1], kp.shape[2]
    nl = kl.shape[2]
    d = s // n_head
    sl, (n_p, n_l) = split_plan(((cp, 1), (nl, R)), g * n_head, n_sms)
    kpl, vpl, kll, vll = (x[layer].float() for x in (kp, vp, kl, vl))
    rm = rowmap.to(torch.int64)
    slot = torch.arange(cp, device=q.device)
    out = torch.empty((b, s), dtype=torch.float32, device=q.device)
    for gi in range(g):
        rows = range(gi * R, (gi + 1) * R)
        qh = q[gi * R:(gi + 1) * R].reshape(R, n_head, d).float()
        lo_g = lo[gi * R:(gi + 1) * R].long()
        lo_max = min(int(lo_g.max()), cp)
        ok = slot[None] < lo_g[:, None]
        kh = kpl[gi].reshape(cp, n_head, d)
        vh = vpl[gi].reshape(cp, n_head, d)
        prompt = [slice_partial(qh, kh[a:a + sl], vh[a:a + sl],
                                ok[:, a:a + sl])
                  for a in range(0, n_p * sl, sl) if a < lo_max]
        for r, bq in enumerate(rows):
            live = []
            for a in range(0, n_l * sl, sl):
                e = min(a + sl, nl, hi_live)
                if a >= e:
                    continue
                t = torch.arange(a, e, device=q.device)
                src = gi * R + rm[bq, a:e]
                kt = kll[src, t].reshape(e - a, n_head, d)
                vt = vll[src, t].reshape(e - a, n_head, d)
                live.append(slice_partial(
                    qh[r:r + 1], kt, vt,
                    torch.ones((1, e - a), dtype=torch.bool,
                               device=q.device)))
            parts = [(m[r:r + 1], l[r:r + 1], acc[r:r + 1])
                     for m, l, acc in prompt] + live
            out[bq] = (merge_partials(parts).reshape(s) if parts
                       else torch.zeros(s, device=q.device))
    return out


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
            or tuple(rowmap.shape) != (b, nl)
            or (s * kp.element_size()) % 16
            or any(t.data_ptr() % 16 for t in (kp, vp, kl, vl))):
        raise ValueError("split_beam_attention: q (B, S), kp/vp (L, B/kv_group"
                         ", CP, S), kl/vl (L, B, NL, S) of q's dtype (f32/bf16"
                         ") on 16-byte boundaries with 16-byte rows, head dim "
                         "32|64, kv_group <= 8, lo (B,) int32, rowmap (B, NL) "
                         "int32, 0 <= hi_live <= NL")
    d = s // n_head
    sl, (n_p, n_l) = split_plan(((cp, 1), (nl, kv_group)), g * n_head,
                                K.sm_count(q.device.index))
    n_split = n_p + kv_group * n_l
    # one allocation: the output, then the partials (m, l, acc[D]) of every
    # (group, head, split, beam)
    buf = torch.empty(b * s + g * n_head * n_split * kv_group * (d + 2),
                      dtype=torch.float32, device=q.device)
    out = buf[:b * s].view(b, s)
    fn = K.entry("split_attn", "gwt_split_beam_attn",
                 (K.P,) * 10 + (K.I,) * 8 + (K.F, K.I, K.I, K.I, K.I, K.P))
    K.launch(fn, "gwt_split_beam_attn", q.device, q.data_ptr(), kp.data_ptr(),
             vp.data_ptr(), kl.data_ptr(), vl.data_ptr(), lo.data_ptr(),
             rowmap.data_ptr(), out.data_ptr(), buf[b * s:].data_ptr(),
             K.tickets(q.device, g * n_head).data_ptr(), int(layer), g, cp,
             nl, s, n_head, kv_group, int(hi_live), float(d ** -0.5), sl, n_p,
             n_l, _DTYPES[q.dtype])
    split_beam_attention.launches += 1
    return out


split_beam_attention.launches = 0
