"""K3/K4: single-query decode attention over merged-head caches
(csrc/decode_attn.cu) and its plain versions.

Counterpart of the JAX package's ``ops/decode_attention.py`` entry
``decode_attention``.  Its two TPU kernels -- ``_decode_attn_kernel`` (one
K/V row per query row) and ``_decode_attn_group_packed_kernel`` (``kv_group``
query rows, the best_of decoders of one stream, sharing one K/V row) --
compute one function, so the port has one kernel for both.

Slot c of row b is valid iff ``c < lo[b]`` or ``split <= c < hi``:

- self-attention: lo = per-row prompt length, split = padded prompt
  capacity, hi = split + step + 1;
- cross-attention: lo = valid audio positions, split = C, hi = 0.

``hi`` is a host int, or a (1,) int32 tensor on q's device that the kernel
reads there (the token loop's CUDA graph replays one step with the step's
slot written on the device, ``decode/window.py``).

The caches enter as the full stacked ``(L, B // kv_group, C, S)`` tensors
with ``layer`` selecting the layer: the kernel reads it by pointer offset,
so no per-layer copy is ever made.

The kernel splits the cache axis across CTAs (csrc/decode_split.cuh):
``split_plan`` picks the slices from the cache capacity and the SM count,
each CTA writes a partial softmax state, and the last CTA of a (group,
head) pair merges them in split order.  ``decode_attention_split_plain``
follows that slicing and merge in torch; the CPU tests hold it against the
JAX package, and the wrapper never calls it.
"""

from __future__ import annotations

import collections
from typing import Sequence, Tuple

import torch

from . import kernels as K

_NEG = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_KV_GROUP = 8  # MAX_DECODERS
CHUNK = 64        # slots per chunk of a CTA's online softmax
MAX_SPLIT = 128   # most partials one (group, head) pair merges
H100_SMS = 132


def split_plan(regions: Sequence[Tuple[int, int]], pairs: int,
               n_sms: int = H100_SMS) -> Tuple[int, Tuple[int, ...]]:
    """Slice length and per-region slice counts of the split-cache kernels.

    ``regions`` lists (capacity in slots, copies): each region is cut into
    slices of one length, one CTA per slice and copy, for each of ``pairs``
    (group, head) pairs.  Slices start at 64 slots and double while the
    grid would still fill every SM at twice the length, or while a pair has
    more than MAX_SPLIT of them.  Only capacities enter, never the step, so
    the grid is the same at every step."""
    def total(length):
        return sum(n * -(-cap // length) for cap, n in regions)
    longest = max(cap for cap, _ in regions)
    sl = CHUNK
    while sl < longest and (pairs * total(2 * sl) >= n_sms
                            or total(sl) > MAX_SPLIT):
        sl *= 2
    return sl, tuple(-(-cap // sl) for cap, _ in regions)


def slice_live(a: int, b: int, lo_max: int, split: int, hi: int) -> bool:
    """Slots [a, b) hold one that some row may attend (c < max lo, or
    split <= c < hi); the kernels never load a slice or chunk without one."""
    return a < b and (a < lo_max or max(a, split) < min(b, hi))


def decode_attention_plain(q, k, v, lo, hi, *, split: int, n_head: int,
                           kv_group: int = 1, layer: int = 0):
    """The JAX package's ``_fallback``: heads split out, f32 masked
    softmax (``hi`` an int or a (1,) tensor).  Returns (B, S) f32."""
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


def slice_partial(qh, kh, vh, ok):
    """One CTA's partial over a slice, in chunks of 64 slots: qh (R, H, D)
    f32, kh / vh (n, H, D) f32, ok (R, n) bool.  Returns (m, l) (R, H) and
    acc (R, H, D): the online softmax's running max, sum of p and p . V,
    with masked slots at exactly 0."""
    r, h, d = qh.shape
    m = torch.full((r, h), _NEG, dtype=torch.float32, device=qh.device)
    l = torch.zeros((r, h), dtype=torch.float32, device=qh.device)
    acc = torch.zeros((r, h, d), dtype=torch.float32, device=qh.device)
    for c0 in range(0, kh.shape[0], CHUNK):
        okc = ok[:, None, c0:c0 + CHUNK]
        s = torch.einsum("rhd,chd->rhc", qh, kh[c0:c0 + CHUNK]) * d ** -0.5
        s = torch.where(okc, s, torch.full_like(s, _NEG))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(okc, torch.exp(s - m_new[..., None]),
                        torch.zeros_like(s))
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("rhc,chd->rhd", p,
                                                   vh[c0:c0 + CHUNK])
        m = m_new
    return m, l, acc


def merge_partials(parts):
    """The last CTA's merge of a pair's partials, in split order: partials
    with l = 0 attended no slot and are skipped; the rest are rescaled to
    the largest m and summed one after another.  ``parts`` is a list of (m,
    l, acc) as ``slice_partial`` returns them.  Returns acc / max(l,
    1e-30)."""
    m_tot = torch.full_like(parts[0][0], _NEG)
    for m, l, _ in parts:
        m_tot = torch.where(l > 0, torch.maximum(m_tot, m), m_tot)
    l_tot = torch.zeros_like(m_tot)
    acc_tot = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        w = torch.where(l > 0, torch.exp(m - m_tot), torch.zeros_like(m))
        l_tot = l_tot + l * w
        acc_tot = acc_tot + w[..., None] * acc
    return acc_tot / torch.clamp_min(l_tot, 1e-30)[..., None]


def decode_attention_split_plain(q, k, v, lo, hi, *, split: int,
                                 n_head: int, kv_group: int = 1,
                                 layer: int = 0, n_sms: int = H100_SMS):
    """The kernel's slicing and ordered merge in torch: the same function as
    ``decode_attention_plain`` with the f32 sums taken per slice of
    ``split_plan``'s length and merged in split order; slices without a
    slot any row of the group may attend are skipped, as the kernel never
    loads them.  For the CPU tests only.  Returns (B, S) f32."""
    hi = int(hi)
    k, v = k[layer], v[layer]
    b, s = q.shape
    g, c = k.shape[0], k.shape[1]
    d = s // n_head
    sl, (n_split,) = split_plan(((c, 1),), g * n_head, n_sms)
    lo_r = lo.reshape(g, kv_group).long()
    slot = torch.arange(c, device=q.device)
    out = torch.empty((b, s), dtype=torch.float32, device=q.device)
    for gi in range(g):
        rows = slice(gi * kv_group, (gi + 1) * kv_group)
        qh = q[rows].reshape(kv_group, n_head, d).float()
        kh = k[gi].reshape(c, n_head, d).float()
        vh = v[gi].reshape(c, n_head, d).float()
        ok = ((slot[None] < lo_r[gi][:, None])
              | ((slot[None] >= split) & (slot[None] < hi)))
        lo_max = int(lo_r[gi].max())
        parts = []
        for i in range(n_split):
            a, e = i * sl, min((i + 1) * sl, c)
            if slice_live(a, e, lo_max, split, hi):
                parts.append(slice_partial(qh, kh[a:e], vh[a:e], ok[:, a:e]))
        if not parts:
            out[rows] = 0.0
            continue
        out[rows] = merge_partials(parts).reshape(kv_group, s)
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lo: torch.Tensor, hi, *, split: int, n_head: int,
                     kv_group: int = 1, layer: int = 0) -> torch.Tensor:
    """Kernel wrapper.  q (B, S); k/v (L, B // kv_group, C, S); lo (B,)
    int32; hi a host int or a (1,) int32 tensor on q's device; split,
    layer host ints.
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
            or tuple(lo.shape) != (b,)
            or (s * k.element_size()) % 16
            or k.data_ptr() % 16 or v.data_ptr() % 16):
        raise ValueError("decode_attention: q (B, S), k/v (L, B/kv_group, C, "
                         "S) of q's dtype (f32/bf16) on 16-byte boundaries "
                         "with 16-byte rows, head dim 32|64, kv_group <= 8, "
                         "lo (B,) int32")
    hi_ptr = 0
    if isinstance(hi, torch.Tensor):
        if (hi.device != q.device or hi.dtype != torch.int32
                or tuple(hi.shape) != (1,)):
            raise ValueError("decode_attention: a tensor hi is (1,) int32 "
                             "on q's device")
        hi, hi_ptr = 0, hi.data_ptr()
    d = s // n_head
    sl, (n_split,) = split_plan(((c, 1),), g * n_head, K.sm_count(
        q.device.index))
    # one allocation: the output, then the partials (m, l, acc[D]) of every
    # (group, head, split, row)
    buf = torch.empty(b * s + g * n_head * n_split * kv_group * (d + 2),
                      dtype=torch.float32, device=q.device)
    out = buf[:b * s].view(b, s)
    fn = K.entry("decode_attn", "gwt_decode_attn",
                 (K.P,) * 7 + (K.I,) * 8 + (K.P, K.F, K.I, K.I, K.I, K.P))
    K.launch(fn, "gwt_decode_attn", q.device,
             q.data_ptr(), k.data_ptr(), v.data_ptr(),
             lo.data_ptr(), out.data_ptr(), buf[b * s:].data_ptr(),
             K.tickets(q.device, g * n_head).data_ptr(), int(layer), g, c, s,
             n_head, kv_group, int(split), int(hi), hi_ptr, float(d ** -0.5),
             sl, n_split, _DTYPES[q.dtype])
    K.count(decode_attention, (decode_attention.group_launches, kv_group),
            (decode_attention.rows_launches, (kv_group, b)))
    return out


decode_attention.launches = 0
# launches split by kv_group: 1 is the TPU's K3 case, > 1 its K4 case
decode_attention.group_launches = collections.Counter()
# launches by (kv_group, query rows): a batch of B streams gives 5 * B rows
decode_attention.rows_launches = collections.Counter()


# ----------------------------------------------------------------- K14: GQA
GQA_HEAD_DIMS = (128,)


def gqa_decode_attention_plain(q, k, v, hi, *, n_head: int, n_kv_head: int,
                               layer: int = 0):
    """One query token a row over a grouped-query cache: q (B, H D); k / v
    (L, B, C, Hkv D); slot c is valid iff c < hi (an int or a (1,)
    tensor); query head j reads K/V head j // (H / Hkv).  f32 masked
    softmax.  Returns (B, H D) f32."""
    k, v = k[layer], v[layer]
    b, c = k.shape[0], k.shape[1]
    d = q.shape[1] // n_head
    g = n_head // n_kv_head
    qh = q.reshape(b, n_kv_head, g, d).float() * (d ** -0.5)
    kh = k.reshape(b, c, n_kv_head, d).float()
    vh = v.reshape(b, c, n_kv_head, d).float()
    scores = torch.einsum("bhgd,bchd->bhgc", qh, kh)
    ok = torch.arange(c, device=q.device) < hi
    scores = torch.where(ok, scores, torch.full_like(scores, _NEG))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhgc,bchd->bhgd", p, vh).reshape(b, n_head * d)


def gqa_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         hi, *, n_head: int, n_kv_head: int,
                         layer: int = 0) -> torch.Tensor:
    """K14, kernel wrapper (csrc/decode_attn.cu, ``gqa_decode_kernel``):
    q (B, H D) bf16; k / v (L, B, C, Hkv D) bf16; hi a host int or a (1,)
    int32 tensor on q's device (every slot below it is valid); head dim
    128, H / Hkv <= 8.  The split-cache design of K3 / K4 with the H / Hkv
    query heads that read one K/V head as the rows of a group, so each K/V
    byte is read once a step.  CPU tensors take the plain version.  Returns
    (B, H D) f32."""
    if q.device.type == "cpu":
        return gqa_decode_attention_plain(q, k, v, hi, n_head=n_head,
                                          n_kv_head=n_kv_head, layer=layer)
    K.require_cuda("gqa_decode_attention", q, k, v)
    b, sq = q.shape
    n_layer, bk, c, skv = k.shape
    g, d = n_head // n_kv_head, sq // n_head
    if (q.dtype != torch.bfloat16 or k.dtype != q.dtype
            or v.dtype != q.dtype or v.shape != k.shape or bk != b
            or n_head % n_kv_head or sq != n_head * d or d not in GQA_HEAD_DIMS
            or skv != n_kv_head * d or not 1 <= g <= MAX_KV_GROUP
            or not 0 <= layer < n_layer
            or k.data_ptr() % 16 or v.data_ptr() % 16 or q.data_ptr() % 16):
        raise ValueError("gqa_decode_attention: q (B, H D) bf16, k/v (L, B, "
                         "C, Hkv D) bf16 on 16-byte boundaries, head dim "
                         "128, H / Hkv <= 8")
    hi_ptr = 0
    if isinstance(hi, torch.Tensor):
        if (hi.device != q.device or hi.dtype != torch.int32
                or tuple(hi.shape) != (1,)):
            raise ValueError("gqa_decode_attention: a tensor hi is (1,) "
                             "int32 on q's device")
        hi, hi_ptr = 0, hi.data_ptr()
    sl, (n_split,) = split_plan(((c, 1),), b * n_kv_head, K.sm_count(
        q.device.index))
    buf = torch.empty(b * sq + b * n_kv_head * n_split * g * (d + 2),
                      dtype=torch.float32, device=q.device)
    out = buf[:b * sq].view(b, sq)
    fn = K.entry("decode_attn", "gwt_gqa_decode_attn",
                 (K.P,) * 6 + (K.I,) * 6 + (K.P, K.F, K.I, K.I, K.P))
    K.launch(fn, "gwt_gqa_decode_attn", q.device,
             q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             buf[b * sq:].data_ptr(),
             K.tickets(q.device, b * n_kv_head).data_ptr(), int(layer), b, c,
             n_kv_head, g, int(hi), hi_ptr, float(d ** -0.5), sl, n_split)
    K.count(gqa_decode_attention)
    return out


gqa_decode_attention.launches = 0
