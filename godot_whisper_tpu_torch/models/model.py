"""Whisper forward passes: conv stem + encoder, cross-KV precompute, decoder.

PyTorch port of the JAX package's ``models/model.py`` (same semantics and
the same public layouts):

- conv stem: two conv1d(k=3, pad=1) + exact-erf GELU, second stride 2;
- encoder: pre-LN blocks, the K projection has no bias, 4x GELU MLP,
  final ln_post; positional embedding sliced to ``audio_ctx``;
- cross-KV: K/V of every decoder layer projected once per window, kept
  merged-head ``(L, B, T_pad, S)`` with ``t_valid``, optionally int8 with
  per-(slot, head) K scales and per-head V scales (``QuantCrossKV``);
- decoder: token + position embedding, self-attention over a merged-head
  KV cache ``(L, B, C, S)`` (in beam search, over a prompt cache per
  group plus a live cache per beam), cross-attention, logits against the
  token embedding.

A quantized decoder (models/quant.py) carries ``QuantTensor`` /
``Quant4Tensor`` weights: its projections run K9/K10 (f32 result, f32 bias,
one rounding to bf16), the self q/k/v projections are one fused ``wqkv``,
and the embedding gather and logits read the int8 token embedding.

bf16 rounding points follow the JAX package as XLA compiles it: every
projection accumulates in f32, adds its f32 bias and rounds once to the
compute dtype; LayerNorm and softmax run in f32, a LayerNorm inside a
layer reads the unrounded f32 residual sum (``_residual``), and each GELU
of the conv stem reads the convolution's unrounded f32 sum
(``conv_stem``).

Where the JAX package returns a fresh cache, ``decoder_dense`` and
``decoder_step`` write the new K/V rows INTO the cache they are given (a
slot write instead of a copy of the whole cache every token) and return it.

Tensor parallelism (``tp``, the mesh's tp group from
``parallel/sharding.py``, or None): the weights hold this rank's slices
(``shard_params``) and every function runs this rank's heads.  The conv
stem and the token embedding are sharded on features and gathered;
q / k / v, ``w0`` and the cross K / V are column-parallel on the local heads
(caches of width S / tp); ``wo`` and ``w1`` are row-parallel, their f32
partial products all-reduced before the bias and the rounding
(``_row_proj``); the logits take x's local feature slice against the local
embedding columns and are all-reduced, so every rank samples from the same
(B, V) f32 logits.  The collectives are ``parallel/collectives.py``'s
autograd functions, so a training step's backward is right too.  With
``tp=None`` the code is the single-device path, with its launches.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as Fn

from ..ops.attention import flash_attention_bh
from ..ops.cross_attention import H_PAD, cross_attention_quant
from ..ops.decode_attention import decode_attention
from ..ops.qmatmul import (QUANT_TYPES, QuantTensor, qlayer, quant_matmul,
                           quant_matmul4)
from ..ops.split_attention import split_beam_attention
from ..parallel.collectives import (copy_to_tp, gather_from_tp,
                                    reduce_from_tp, tp_size)
from .config import WhisperConfig

Params = Dict[str, Any]

_NEG = -1e30
_BLOCK_C = 256  # cache-slot granularity (the decode-attention block)


def param_compute_dtype(params: Params) -> torch.dtype:
    """Matmul compute dtype: bf16 for a quantized decoder."""
    te = params["decoder"]["token_embed"]
    return torch.bfloat16 if isinstance(te, QuantTensor) else te.dtype


def layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Float32 LayerNorm (population variance) regardless of input dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    return (xf - mean) * torch.rsqrt(var + eps) * g + b


class _MatmulF32(torch.autograd.Function):
    """2-D x @ w of low-precision operands with an f32 result, under
    autograd (``torch.mm(..., out_dtype=float32)`` has no derivative).  The
    backward is JAX's transpose of a ``preferred_element_type=float32``
    dot: the f32 cotangent times the other operand widened to f32, each
    gradient rounded once to its operand's dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.float()
        return ((g @ w.float().t()).to(x.dtype),
                (x.float().t() @ g).to(w.dtype))


def _matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with f32 accumulation and an f32 result (the JAX package's
    ``preferred_element_type=float32``)."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return torch.matmul(x, w)
    if x.is_cuda:
        x2 = x.reshape(-1, x.shape[-1])
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            y = _MatmulF32.apply(x2, w)
        else:
            y = torch.mm(x2, w, out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(x.float(), w.float())


def _product(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w in f32 (K9 / K10 for a quantized weight)."""
    if isinstance(w, QUANT_TYPES):
        return (quant_matmul(x, w, layout="io") if isinstance(w, QuantTensor)
                else quant_matmul4(x, w))
    return _matmul_f32(x, w)


def _finish(y: torch.Tensor, w, b: Optional[torch.Tensor],
            out_dtype) -> torch.Tensor:
    """The f32 product plus its f32 bias, rounded once."""
    if b is not None:
        y = y + b
    if out_dtype is None:
        out_dtype = torch.bfloat16 if isinstance(w, QUANT_TYPES) else w.dtype
    return y.to(out_dtype)


def _proj(x: torch.Tensor, w, b: Optional[torch.Tensor] = None,
          out_dtype=None) -> torch.Tensor:
    return _finish(_product(x, w), w, b, out_dtype)


def _row_proj(x: torch.Tensor, w, b: Optional[torch.Tensor], out_dtype,
              tp) -> torch.Tensor:
    """A row-parallel projection (``wo``, ``w1``) of this rank's slice x:
    the f32 partial product is all-reduced in f32, then the bias is added
    and the sum rounded.  A leaf kept whole on every rank (an int4 weight
    whose shard would split a quantization group, ``shard_params``) takes
    the gathered input instead and needs no reduce."""
    if tp is None:
        return _proj(x, w, b, out_dtype)
    if w.shape[-2] != x.shape[-1]:
        return _proj(gather_from_tp(x, tp), w, b, out_dtype)
    return _finish(reduce_from_tp(_product(x, w), tp), w, b, out_dtype)


def _self_qkv(h: torch.Tensor, attn) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """Self-attention q/k/v projections; a quantized decoder carries one
    fused (S, 3S) ``wqkv`` (one launch, the same numbers); its q comes out
    contiguous for the attention kernels, k and v are written into the
    caches."""
    if "wqkv" in attn:
        y = _proj(h, attn["wqkv"], attn["bqkv"])
        s = y.shape[-1] // 3
        return y[..., :s].contiguous(), y[..., s:2 * s], y[..., 2 * s:]
    return (_proj(h, attn["wq"], attn["bq"]), _proj(h, attn["wk"]),
            _proj(h, attn["wv"], attn["bv"]))


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU.  On bf16 input, the rounding of the JAX package's
    compiled ``jax.nn.gelu``: erfc(-x * bf16(sqrt(1/2))) in f32, rounded to
    bf16, times 0.5 x, rounded to bf16 (torch's one rounding of the f32
    result differs in about a quarter of the elements by one bf16 ulp)."""
    if x.dtype == torch.bfloat16:
        e = torch.special.erfc(x.float() * -0.70703125).to(torch.bfloat16)
        return (0.5 * x) * e
    return Fn.gelu(x, approximate="none")


def _residual(x: torch.Tensor, p: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x + p where a LayerNorm reads the sum: (the residual stream rounded
    to x's dtype, the f32 sum for the LayerNorm).  The JAX package's
    compiled layer hands its LayerNorm the unrounded f32 sum (XLA keeps
    the excess precision of a bf16 add that feeds an f32 upcast) while the
    residual stream it carries on is the rounded one."""
    s = x.float() + p
    return s.to(x.dtype), s


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked attention for the dense decoder passes.  q (B, Tq, H, D);
    k/v (B, Tk, H, D); additive f32 mask broadcastable to (B, H, Tq, Tk).
    Returns (B, Tq, H, D) f32.  Probabilities are rounded to v's dtype
    before the p @ v product, as in the JAX package."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(),
                        v.float())


# ================================================================== encoder ==
def conv_stem(enc: Params, mel_window: torch.Tensor,
              tp=None) -> torch.Tensor:
    """(B, 2T, n_mels) mel -> (B, T, S) f32: two conv1d (k=3, pad=1, the
    second stride 2), each + bias + GELU.  The convolutions take
    compute-dtype values and keep their f32 sums, so each GELU reads the
    unrounded sum, as the JAX package's jitted window encode computes it
    (XLA's excess precision drops the bf16 rounding of the conv output);
    the first GELU's output is rounded to the compute dtype.  f32 must not
    drop to TF32 in cuDNN; the flags hold for this forward only, so a
    backward through the stem sets them again (``models/training.py``
    takes its gradients inside the same flags).  Under ``tp`` each
    convolution computes this rank's output channels, gathered before the
    next layer reads them."""
    cdtype = enc["conv1"]["w"].dtype
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        x = mel_window.to(cdtype).transpose(1, 2)              # (B, M, 2T)
        x = Fn.conv1d(x.float(), enc["conv1"]["w"].float(), padding=1)
        x = _gelu(x + enc["conv1"]["b"][:, None]).to(cdtype)
        x = copy_to_tp(gather_from_tp(x, tp, dim=1), tp)
        x = Fn.conv1d(x.float(), enc["conv2"]["w"].float(), stride=2,
                      padding=1)
    x = gather_from_tp(_gelu(x + enc["conv2"]["b"][:, None]), tp, dim=1)
    return x.transpose(1, 2)


def encoder_forward(params: Params, config: WhisperConfig,
                    mel_window: torch.Tensor,
                    audio_ctx: Optional[int] = None,
                    tp=None) -> torch.Tensor:
    """Conv stem + transformer encoder.

    mel_window: (B, 2 * audio_ctx, n_mels) float32.  Returns (B, audio_ctx,
    n_state) in the compute dtype.  On a CUDA device the residual stream
    runs pad-native: T is padded ONCE to a 512 multiple (1500 -> 1536), key
    columns >= T are masked inside the attention kernel, and the pad is
    sliced off at the end.  On the CPU it runs at T.
    """
    enc = params["encoder"]
    n_ctx = audio_ctx or config.n_audio_ctx
    n_head = config.n_audio_head // tp_size(tp)               # local heads
    cdtype = enc["conv1"]["w"].dtype

    x = conv_stem(enc, mel_window, tp)
    x = (x + enc["pos_embed"][:n_ctx]).to(cdtype)              # (B, T, S)

    b_sz, t_real, _ = x.shape
    d = config.n_audio_state // config.n_audio_head
    c = n_head * d                                             # local width
    t_pad = -(-t_real // 512) * 512
    pad_native = (x.is_cuda and t_pad != t_real
                  and (t_pad - t_real) * 10 <= t_real)
    if pad_native:
        x = Fn.pad(x, (0, 0, 0, t_pad - t_real))
    t = x.shape[1]

    def to_bh(z):   # (B, T, S) -> (B*H, T, D)
        return z.reshape(b_sz, t, n_head, d).transpose(1, 2).reshape(
            b_sz * n_head, t, d).contiguous()

    blocks = enc["blocks"]
    for li in range(config.n_audio_layer):
        ln0 = {k: v[li] for k, v in blocks["attn_ln"].items()}
        attn = {k: v[li] for k, v in blocks["attn"].items()}
        ln1 = {k: v[li] for k, v in blocks["mlp_ln"].items()}
        mlp = {k: v[li] for k, v in blocks["mlp"].items()}

        h = copy_to_tp(layer_norm(x, ln0["g"], ln0["b"]).to(cdtype), tp)
        q = to_bh(_proj(h, attn["wq"], attn["bq"]))
        k = to_bh(_proj(h, attn["wk"]))
        v = to_bh(_proj(h, attn["wv"], attn["bv"]))
        o = flash_attention_bh(q, k, v,
                               t_valid=t_real if pad_native else None)
        o = o.reshape(b_sz, n_head, t, d).transpose(1, 2).reshape(b_sz, t, c)
        x, xs = _residual(x, _row_proj(o.to(cdtype), attn["wo"], attn["bo"],
                                       cdtype, tp))

        h = copy_to_tp(layer_norm(xs, ln1["g"], ln1["b"]).to(cdtype), tp)
        h = _gelu(_proj(h, mlp["w0"], mlp["b0"]))
        h = _row_proj(h.to(cdtype), mlp["w1"], mlp["b1"], cdtype, tp)
        x = (x + h).to(cdtype)

    if pad_native:
        x = x[:, :t_real]
    x = layer_norm(x, enc["ln_post"]["g"], enc["ln_post"]["b"])
    return x.to(cdtype)


# ================================================================= cross-KV ==
def round_cache_len(n: int) -> int:
    """Round a cache capacity up to the decode-attention block size."""
    return max(-(-n // _BLOCK_C) * _BLOCK_C, _BLOCK_C)


class CrossKV(NamedTuple):
    """Merged-head cross-attention KV: k/v (L, B, T_pad, S), positions >=
    t_valid are zero padding and masked out of every attention."""
    k: torch.Tensor
    v: torch.Tensor
    t_valid: int

    @property
    def t_pad(self) -> int:
        return self.k.shape[2]

    @property
    def device(self) -> torch.device:
        return self.k.device


class QuantCrossKV(NamedTuple):
    """Int8 cross-attention KV, merged-head: K keeps one scale per (slot,
    head), which factors out of the score contraction; V one per head,
    which factors out of the probability-weighted sum.  Scales ride padded
    to the 128-lane head tile of the kernels (zeros beyond n_head)."""
    k_q: torch.Tensor   # (L, B, T_pad, S) int8
    k_s: torch.Tensor   # (L, B, T_pad, 128) bf16
    v_q: torch.Tensor   # (L, B, T_pad, S) int8
    v_s: torch.Tensor   # (L, B, 128) f32
    t_valid: int

    @property
    def t_pad(self) -> int:
        return self.k_q.shape[2]

    @property
    def device(self) -> torch.device:
        return self.k_q.device


def quantize_cross_kv(xkv: CrossKV, n_head: int,
                      out: Optional[QuantCrossKV] = None) -> QuantCrossKV:
    """The JAX package's rounding points as its jitted window encode
    computes them: absmax scales in f32 (XLA compiles ``/ 127.0`` to
    ``* f32(1/127)``); q = round(x / max(scale, 1e-9)) clipped to
    [-127, 127]; then k_s padded to 128 lanes and rounded to bf16, v_s kept
    f32.  ``out``: tensors of the result's shapes whose scale lanes past
    n_head are 0, written in place (the token loop's CUDA graph reads
    them); None writes new ones."""
    l, b, t, s = xkv.k.shape
    d = s // n_head
    if out is None:
        dev = xkv.k.device
        out = QuantCrossKV(
            k_q=torch.empty((l, b, t, s), dtype=torch.int8, device=dev),
            k_s=torch.zeros((l, b, t, H_PAD), dtype=torch.bfloat16,
                            device=dev),
            v_q=torch.empty((l, b, t, s), dtype=torch.int8, device=dev),
            v_s=torch.zeros((l, b, H_PAD), dtype=torch.float32, device=dev),
            t_valid=xkv.t_valid)
    kf = xkv.k.float().reshape(l, b, t, n_head, d)
    vf = xkv.v.float().reshape(l, b, t, n_head, d)
    k_s = kf.abs().amax(dim=-1) * (1.0 / 127.0)                # (L, B, T, H)
    out.k_q.view(l, b, t, n_head, d).copy_(torch.clamp(torch.round(
        kf / torch.clamp_min(k_s[..., None], 1e-9)), -127, 127))
    v_s = vf.abs().amax(dim=(2, 4)) * (1.0 / 127.0)            # (L, B, H)
    out.v_q.view(l, b, t, n_head, d).copy_(torch.clamp(torch.round(
        vf / torch.clamp_min(v_s[:, :, None, :, None], 1e-9)), -127, 127))
    out.k_s[..., :n_head].copy_(k_s)
    out.v_s[..., :n_head].copy_(v_s)
    return out._replace(t_valid=xkv.t_valid)


def cross_kv(params: Params, config: WhisperConfig,
             enc_out: torch.Tensor, tp=None,
             out: Optional[CrossKV] = None) -> CrossKV:
    """Project the encoder output to every decoder layer's cross K/V (this
    rank's heads under ``tp``), padded on T to the decode-attention block
    size, one layer's projection at a time into ``out``: a CrossKV of the
    result's shape whose padding is 0 (the token loop's CUDA graph reads
    it), or None for a new one.  Where autograd records the projections,
    a new result is stacked and padded instead: the backward of a write
    into one tensor a layer would copy the whole gradient once a layer."""
    ca = params["decoder"]["blocks"]["cross_attn"]
    enc_out = copy_to_tp(enc_out, tp)
    t, n_layer = enc_out.shape[1], config.n_text_layer

    def project(li):
        return (_proj(enc_out, qlayer(ca["wk"], li)),
                _proj(enc_out, qlayer(ca["wv"], li), ca["bv"][li]))

    k, v = project(0)
    if out is None and (k.requires_grad or v.requires_grad):
        kvs = [(k, v)] + [project(li) for li in range(1, n_layer)]
        pad = (0, 0, 0, round_cache_len(t) - t)
        return CrossKV(k=Fn.pad(torch.stack([a for a, _ in kvs]), pad),
                       v=Fn.pad(torch.stack([b for _, b in kvs]), pad),
                       t_valid=t)
    if out is None:
        shape = (n_layer, k.shape[0], round_cache_len(t), k.shape[2])
        out = CrossKV(k=k.new_zeros(shape), v=v.new_zeros(shape), t_valid=t)
    for li in range(n_layer):
        if li:
            k, v = project(li)
        out.k[li, :, :t] = k
        out.v[li, :, :t] = v
    return out._replace(t_valid=t)


# ================================================================== decoder ==
class KVCache(NamedTuple):
    k: torch.Tensor  # (L, B, C, S) merged-head, C = cache capacity
    v: torch.Tensor

    @property
    def cache_len(self) -> int:
        return self.k.shape[2]


def init_kv_cache(config: WhisperConfig, batch: int,
                  cache_len: Optional[int] = None, dtype=torch.bfloat16,
                  *, device, tp=None, out: Optional[KVCache] = None
                  ) -> KVCache:
    """Fresh zero cache, capacity rounded up to the kernel block; width
    n_text_state / tp (this rank's heads).  ``out``: a cache of that shape
    and dtype, zeroed in place instead."""
    c = round_cache_len(cache_len if cache_len is not None
                        else config.n_text_ctx)
    shape = (config.n_text_layer, batch, c,
             config.n_text_state // tp_size(tp))
    if out is not None:
        if tuple(out.k.shape) != shape or out.k.dtype != dtype:
            raise ValueError(f"init_kv_cache: out is {tuple(out.k.shape)} "
                             f"{out.k.dtype}, the cache {shape} {dtype}")
        out.k.zero_()
        out.v.zero_()
        return out
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def _embed(dec, tokens: torch.Tensor, positions: torch.Tensor, cdtype,
           tp=None):
    """Token rows (this rank's feature slice under ``tp``, gathered) plus
    the positional embedding."""
    te = dec["token_embed"]
    t = tokens.long()
    if isinstance(te, QuantTensor):
        # int8 rows times their per-row scales
        x = te.q[t].float() * te.s[t][..., None]
    else:
        x = te[t].float()
    x = gather_from_tp(x, tp)
    return (x + dec["pos_embed"][positions.long()]).to(cdtype)


def _logits(dec, x: torch.Tensor, tp=None) -> torch.Tensor:
    """x (..., S) -> (..., V) f32 against the token embedding (the int8
    one through K9's ``oi`` layout).  Under ``tp``, x's local feature slice
    against the local embedding columns, all-reduced."""
    te = dec["token_embed"]
    if tp is not None:
        n = te.shape[-1]
        x = copy_to_tp(x, tp)[..., tp.rank * n:(tp.rank + 1) * n]
    if isinstance(te, QuantTensor):
        y = quant_matmul(x, te, layout="oi")
    else:
        y = _matmul_f32(x, te.t())
    return reduce_from_tp(y, tp)


def _layer(blocks, li: int):
    return {name: {k: qlayer(v, li) for k, v in sub.items()}
            for name, sub in blocks.items()}


def _dequant_xkv_layer(xkv: QuantCrossKV, li: int, n_head: int):
    """Layer li of an int8 cross-KV -> bf16 (B, T, S) k/v (the dense prompt
    pass attends through ``mha``)."""
    k_q, k_s, v_q, v_s = (xkv.k_q[li], xkv.k_s[li], xkv.v_q[li],
                          xkv.v_s[li])
    b, t, s = k_q.shape
    d = s // n_head
    k = (k_q.float().reshape(b, t, n_head, d)
         * k_s[..., :n_head].float()[..., None]).reshape(b, t, s)
    v = (v_q.float().reshape(b, t, n_head, d)
         * v_s[:, None, :n_head, None]).reshape(b, t, s)
    return k.to(torch.bfloat16), v.to(torch.bfloat16)


def decoder_dense(params: Params, config: WhisperConfig,
                  tokens: torch.Tensor, positions: torch.Tensor,
                  kv: KVCache, xkv, n_valid: torch.Tensor,
                  logit_rows: Optional[torch.Tensor] = None,
                  start: int = 0, tp=None) -> Tuple[torch.Tensor, KVCache]:
    """Decoder over T new tokens written at cache slots [start, start + T):
    the prompt pass (start 0) and the stage-level ``decode``.  Slot c is
    visible to query t iff c <= start + t and it is history (c < start) or
    a real row of this call (c - start < n_valid[b]).  ``logit_rows`` (B,)
    keeps only those positions' logits.  Attention here
    is the plain masked product (``mha``), as the JAX package leaves it to
    XLA; an int8 ``xkv`` (QuantCrossKV) is dequantized per layer to bf16
    first.  Writes into ``kv`` in place and returns (logits, kv)."""
    dec = params["decoder"]
    n_head = config.n_text_head // tp_size(tp)                # local heads
    cdtype = param_compute_dtype(params)
    B, T = tokens.shape
    C = kv.cache_len
    dev = tokens.device

    x = _embed(dec, tokens, positions, cdtype, tp)
    nv = n_valid.reshape(-1, 1, 1, 1).to(dev)
    c_pos = torch.arange(C, device=dev)[None, None, None, :]
    q_idx = torch.arange(T, device=dev)[None, None, :, None]
    ok = (c_pos <= start + q_idx) & ((c_pos < start) | (c_pos - start < nv))
    zero = torch.zeros((), device=dev)
    self_mask = torch.where(ok, zero, torch.full((), _NEG, device=dev))
    quant_xkv = isinstance(xkv, QuantCrossKV)
    xok = torch.arange(xkv.t_pad, device=dev) < xkv.t_valid
    cross_mask = torch.where(xok, zero, torch.full((), _NEG, device=dev))

    def heads4(z):
        return z.reshape(*z.shape[:-1], n_head, z.shape[-1] // n_head)

    def attend(q, k, v, mask):
        o = mha(heads4(q), heads4(k), heads4(v), mask)
        return o.reshape(*o.shape[:-2], -1)

    for li in range(config.n_text_layer):
        layer = _layer(dec["blocks"], li)
        ln0, attn = layer["attn_ln"], layer["attn"]
        h = copy_to_tp(layer_norm(x, ln0["g"], ln0["b"]).to(cdtype), tp)
        q, k_new, v_new = _self_qkv(h, attn)
        kv.k[li, :, start:start + T] = k_new.to(kv.k.dtype)
        kv.v[li, :, start:start + T] = v_new.to(kv.v.dtype)
        o = attend(q, kv.k[li], kv.v[li], self_mask)
        x, xs = _residual(x, _row_proj(o.to(cdtype), attn["wo"], attn["bo"],
                                       cdtype, tp))

        lnc, cattn = layer["cross_attn_ln"], layer["cross_attn"]
        h = copy_to_tp(layer_norm(xs, lnc["g"], lnc["b"]).to(cdtype), tp)
        qc = _proj(h, cattn["wq"], cattn["bq"])
        xk, xv = (_dequant_xkv_layer(xkv, li, n_head) if quant_xkv
                  else (xkv.k[li], xkv.v[li]))
        oc = attend(qc, xk, xv, cross_mask)
        x, xs = _residual(x, _row_proj(oc.to(cdtype), cattn["wo"],
                                       cattn["bo"], cdtype, tp))

        ln1, mlp = layer["mlp_ln"], layer["mlp"]
        h = copy_to_tp(layer_norm(xs, ln1["g"], ln1["b"]).to(cdtype), tp)
        h = _gelu(_proj(h, mlp["w0"], mlp["b0"]))
        h = _row_proj(h.to(cdtype), mlp["w1"], mlp["b1"], cdtype, tp)
        x = (x + h).to(cdtype)

    x = layer_norm(x, dec["ln"]["g"], dec["ln"]["b"]).to(cdtype)
    if logit_rows is not None:
        x = x[torch.arange(B, device=dev), logit_rows.to(dev)][:, None]
    return _logits(dec, x, tp), kv


def decoder_step(params: Params, config: WhisperConfig,
                 token: torch.Tensor, pos: torch.Tensor, kv: KVCache,
                 xkv, lo: torch.Tensor, slot, split: int,
                 kv_group: int = 1, kv_prompt: Optional[KVCache] = None,
                 rowmap: Optional[torch.Tensor] = None, tp=None
                 ) -> Tuple[torch.Tensor, KVCache]:
    """The autoregressive hot step: one token per row.

    ``pos`` (= n_prompt + i) drives the positional embedding; the cache
    slot is the batch-uniform ``slot`` (= split + i), so per-row prompt
    lengths are mask parameters (``lo``), never per-row write offsets.
    Self- and cross-attention run the decode-attention kernel over the
    full stacked caches with the layer as an index; ``kv_group`` rows share
    one cross-KV row.  An int8 ``xkv`` (QuantCrossKV) goes through
    ``cross_attention_quant`` (K12 when kv_group * n_head <= 128, else K11).

    Split-cache beam mode (``kv_prompt`` given): the prompt K/V is stored
    once per beam group, ``kv_prompt`` (L, G, CP, S), and ``kv`` is the
    per-beam LIVE cache (L, B, NL, S); ``slot`` is the live slot (= i, no
    prompt offset, ``split`` unused), the new K/V goes to the beam's own
    row, and self-attention runs the split kernel, which reads beam b's
    live slot t from row ``rowmap[b, t]`` of its group (``rowmap[:, slot]``
    must be each beam's own row).

    ``slot`` is a host int, or a (1,) int32 tensor on the device (not in
    split-cache mode): the new K/V row is then written by ``index_copy_``
    and the attention kernel reads hi = slot + 1 on the device, so the
    step holds no host value that changes from step to step and one CUDA
    graph replays every step of a window (``decode/window.py``).

    Writes the new K/V into ``kv`` in place and returns (logits (B, V) f32,
    kv)."""
    dec = params["decoder"]
    n_head = config.n_text_head // tp_size(tp)                # local heads
    cdtype = param_compute_dtype(params)
    B = token.shape[0]
    quant_xkv = isinstance(xkv, QuantCrossKV)
    cross_lo = torch.full((B,), xkv.t_valid, dtype=torch.int32,
                          device=token.device)
    beam_group = B // kv_prompt.k.shape[1] if kv_prompt is not None else 1
    on_device = isinstance(slot, torch.Tensor)
    if on_device and kv_prompt is not None:
        raise ValueError("decoder_step: the split-cache beam step takes a "
                         "host int slot")
    if on_device:
        at, hi = slot.long(), slot + 1
    else:
        hi = slot + 1

    x = _embed(dec, token, pos, cdtype, tp)                    # (B, S)
    for li in range(config.n_text_layer):
        layer = _layer(dec["blocks"], li)
        ln0, attn = layer["attn_ln"], layer["attn"]
        h = copy_to_tp(layer_norm(x, ln0["g"], ln0["b"]).to(cdtype), tp)
        q, k_new, v_new = _self_qkv(h, attn)
        if on_device:
            kv.k[li].index_copy_(1, at, k_new.to(kv.k.dtype)[:, None])
            kv.v[li].index_copy_(1, at, v_new.to(kv.v.dtype)[:, None])
        else:
            kv.k[li, :, slot] = k_new.to(kv.k.dtype)
            kv.v[li, :, slot] = v_new.to(kv.v.dtype)
        if kv_prompt is not None:
            o = split_beam_attention(q, kv_prompt.k, kv_prompt.v, kv.k, kv.v,
                                     lo, hi, n_head=n_head,
                                     kv_group=beam_group, layer=li,
                                     rowmap=rowmap)
        else:
            o = decode_attention(q, kv.k, kv.v, lo, hi, split=split,
                                 n_head=n_head, layer=li)
        x, xs = _residual(x, _row_proj(o.to(cdtype), attn["wo"], attn["bo"],
                                       cdtype, tp))

        lnc, cattn = layer["cross_attn_ln"], layer["cross_attn"]
        h = copy_to_tp(layer_norm(xs, lnc["g"], lnc["b"]).to(cdtype), tp)
        qc = _proj(h, cattn["wq"], cattn["bq"])
        if quant_xkv:
            oc = cross_attention_quant(qc, xkv.k_q, xkv.k_s, xkv.v_q,
                                       xkv.v_s, n_head=n_head,
                                       t_valid=cross_lo, kv_group=kv_group,
                                       layer=li)
        else:
            oc = decode_attention(qc, xkv.k, xkv.v, cross_lo, 0,
                                  split=xkv.t_pad, n_head=n_head,
                                  kv_group=kv_group, layer=li)
        x, xs = _residual(x, _row_proj(oc.to(cdtype), cattn["wo"],
                                       cattn["bo"], cdtype, tp))

        ln1, mlp = layer["mlp_ln"], layer["mlp"]
        h = copy_to_tp(layer_norm(xs, ln1["g"], ln1["b"]).to(cdtype), tp)
        h = _gelu(_proj(h, mlp["w0"], mlp["b0"]))
        h = _row_proj(h.to(cdtype), mlp["w1"], mlp["b1"], cdtype, tp)
        x = (x + h).to(cdtype)

    x = layer_norm(x, dec["ln"]["g"], dec["ln"]["b"]).to(cdtype)
    return _logits(dec, x, tp), kv
