"""Uni-MoE-2.0-Omni's speech-to-text path: a Whisper encoder, a linear
audio connector, and a decoder-only language model (the LM) whose every
MLP is a mixture of shared, routed and null experts under top-p routing.

Published sizes (HIT-TMG/Uni-MoE-2.0-Omni, ``config.json``): the LM has 28
layers at width 3584; grouped-query attention, 28 query heads over 4 K/V
heads of 128, with q/k/v biases and rotary positions at theta 1e6;
RMSNorm at eps 1e-6; untied logits over 152064 ids.  Each layer's MLP:

- ``mlp_fixed_expert_num`` 2 shared SiLU-gated experts of width 2368,
  run for every token, their outputs added;
- ``mlp_dynamic_expert_num`` 4 routed SiLU-gated experts of width 18944
  and ``mlp_dynamic_null_expert_num`` 1 null expert, which computes
  nothing and adds zero;
- a float32 router (``fp32_gate``) over the 5 outputs whose softmax picks,
  in order of falling probability (ties to the lower index), experts
  until their summed probability reaches ``mlp_dynamic_top_p`` 0.7, never
  more than ``mlp_dynamic_top_k`` 2; a chosen routed expert's output is
  weighted by its probability (``token_drop`` false: no token is dropped).

The audio tower is Whisper-large-v3's encoder (``encoder_forward``, K1 and
K2).  Each 20 s chunk (``whisper_audio_time``) is padded to Whisper's 30 s
window and encoded to 1500 frames; the first 1000 are mean-pooled in
groups of 5 and mapped 1280 -> 3584 with a bias: 200 audio tokens
(``whisper_query_tokens_size``), a prefix in the LM between the prompt's
head and tail.  Audio and text tokens take sequential positions with the
three M-RoPE sections equal, which is 1-D RoPE exactly.

Parameter layout (one tree, the benchmark's tensors as they are drawn):
per-layer leaves stacked on a leading layer axis; matrices ``(in, out)``
for ``x @ W`` in the compute dtype; norms, biases and the router in f32.

- ``encoder``: Whisper's encoder leaves (``models/params.py``);
- ``connector``: ``w`` (1280, S), ``b`` (S,);
- ``embed`` (V, S); ``norm`` (S,); ``head`` (S, V);
- ``blocks``: ``attn_norm`` / ``mlp_norm`` (L, S); ``wqkv`` (L, S,
  (H + 2 Hkv) D) with ``bqkv``, q then k then v columns; ``wo`` (L, H D,
  S), no bias; ``router`` (L, S, E + N), the null expert last;
  ``shared_in`` (L, NS, S, 2 Fs) and ``expert_in`` (L, E, S, 2 F), the gate
  columns then the up columns; ``shared_out`` (L, NS, Fs, S) and
  ``expert_out`` (L, E, F, S).

Rounding: every projection accumulates in f32 (``_matmul_f32``), the
residual stream, the norms, the rotary positions and the router stay in
f32; each matrix product's input is rounded once to the compute dtype
(an expert's gated activation included); the experts' outputs are f32,
weighted and summed in f32.

The expert layer has two forms of one function: ``static`` runs every
routed expert over every row with weight 0 where a row did not choose it
(its shapes do not depend on the routing, so a decode step is one CUDA
graph; at a decode batch the weights are read either way), and the
gathered form runs each routed expert over the rows that chose it (the
prefill, where it saves most of the FLOPs).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as Fn

from ..ops.decode_attention import gqa_decode_attention
from .config import WhisperConfig
from .model import KVCache, _matmul_f32

Params = Dict[str, Any]

_NEG = -1e30


@dataclasses.dataclass(frozen=True)
class UniMoEConfig:
    """Static sizes of the speech path (published key in the comment)."""
    name: str
    n_vocab: int            # vocab_size
    n_state: int            # hidden_size
    n_layer: int            # num_hidden_layers
    n_head: int             # num_attention_heads
    n_kv_head: int          # num_key_value_heads
    head_dim: int           # hidden_size / num_attention_heads
    n_shared: int           # mlp_fixed_expert_num
    shared_ffn: int         # shared_intermediate_size
    n_routed: int           # mlp_dynamic_expert_num
    n_null: int             # mlp_dynamic_null_expert_num
    routed_ffn: int         # dynamic_intermediate_size
    top_p: float            # mlp_dynamic_top_p
    top_k: int              # mlp_dynamic_top_k
    audio: WhisperConfig    # the encoder's widths (its text fields unused)
    rope_theta: float = 1e6           # rope_theta
    rms_eps: float = 1e-6             # rms_norm_eps
    audio_frames: int = 1000          # whisper_audio_time 20 s of frames
    audio_tokens: int = 200           # whisper_query_tokens_size
    token_eot: int = 151645           # <|im_end|>

    family = "unimoe"

    @property
    def n_choices(self) -> int:
        return self.n_routed + self.n_null

    @property
    def q_width(self) -> int:
        return self.n_head * self.head_dim

    @property
    def kv_width(self) -> int:
        return self.n_kv_head * self.head_dim

    @property
    def pool(self) -> int:
        return self.audio_frames // self.audio_tokens


def param_shapes(cfg: UniMoEConfig) -> Dict[tuple, tuple]:
    """Leaf path -> shape of the LM and the connector (the encoder's leaves
    are Whisper's)."""
    S, L, V = cfg.n_state, cfg.n_layer, cfg.n_vocab
    W = cfg.q_width + 2 * cfg.kv_width
    blk = {"attn_norm": (L, S), "wqkv": (L, S, W), "bqkv": (L, W),
           "wo": (L, cfg.q_width, S), "mlp_norm": (L, S),
           "router": (L, S, cfg.n_choices),
           "shared_in": (L, cfg.n_shared, S, 2 * cfg.shared_ffn),
           "shared_out": (L, cfg.n_shared, cfg.shared_ffn, S),
           "expert_in": (L, cfg.n_routed, S, 2 * cfg.routed_ffn),
           "expert_out": (L, cfg.n_routed, cfg.routed_ffn, S)}
    out = {("connector", "w"): (cfg.audio.n_audio_state, S),
           ("connector", "b"): (S,), ("embed",): (V, S), ("norm",): (S,),
           ("head",): (S, V)}
    out.update({("blocks", k): s for k, s in blk.items()})
    return out


F32_LEAVES = {"b", "bqkv", "attn_norm", "mlp_norm", "router", "norm"}


def init_params(cfg: UniMoEConfig, *, seed: int = 0,
                compute_dtype=torch.float32, scale: float = 0.02,
                device="cpu") -> Params:
    """Random-normal weights (norm gains 1 + noise) for tests; the encoder
    from ``models/params.py::init_params`` at the audio widths."""
    from .params import init_params as whisper_init
    gen = torch.Generator().manual_seed(seed)
    tree: Params = {"encoder": whisper_init(
        cfg.audio, seed=seed, compute_dtype=compute_dtype,
        device=device)["encoder"]}
    for path, shape in param_shapes(cfg).items():
        f32 = path[-1] in F32_LEAVES
        t = torch.randn(shape, generator=gen) * scale
        if path[-1] in ("attn_norm", "mlp_norm", "norm"):
            t += 1.0
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t.to(device=device, dtype=torch.float32 if f32
                              else compute_dtype)
    return tree


def compute_dtype_of(params: Params) -> torch.dtype:
    return params["embed"].dtype


# ================================================================ pieces ==
def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    return xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps) * g


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """cos, sin (..., D) f32 of integer positions: frequencies theta^(-2i/D)
    repeated over both halves of the head (the rotate-half convention)."""
    inv = 1.0 / theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                       device=positions.device) / head_dim)
    f = positions.float()[..., None] * inv
    f = torch.cat([f, f], dim=-1)
    return torch.cos(f), torch.sin(f)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x (..., H, D) f32 rotated by cos / sin (..., D)."""
    h = x.shape[-1] // 2
    rot = torch.cat([-x[..., h:], x[..., :h]], dim=-1)
    return x * cos[..., None, :] + rot * sin[..., None, :]


def _proj(x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = _matmul_f32(x, w)
    return y if b is None else y + b


def _bmm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (N, K) against a stack w (E, K, M) -> (E, N, M) with f32
    accumulation and an f32 result (one batched product on the card)."""
    xe = x.expand(w.shape[0], *x.shape)
    if x.is_cuda and w.dtype != torch.float32:
        return torch.bmm(xe, w, out_dtype=torch.float32)
    return torch.bmm(xe.float(), w.float())


def _mlps(h: torch.Tensor, w_in: torch.Tensor,
          w_out: torch.Tensor) -> torch.Tensor:
    """SiLU-gated MLPs: h (N, S) in the compute dtype against stacks w_in
    (E, S, 2F) / w_out (E, F, S): (E, N, S) f32.  Both products accumulate
    in f32; the gated activation is rounded once to the compute dtype."""
    f = w_out.shape[-2]
    y = _bmm_f32(h, w_in)
    a = (Fn.silu(y[..., :f]) * y[..., f:]).to(w_out.dtype)
    if a.is_cuda and w_out.dtype != torch.float32:
        return torch.bmm(a, w_out, out_dtype=torch.float32)
    return torch.bmm(a.float(), w_out.float())


class Routing(NamedTuple):
    probs: torch.Tensor     # (N, E + N_null) f32 softmax of the router
    chosen: torch.Tensor    # (N, E + N_null) bool, the top-p set
    weights: torch.Tensor   # (N, E) f32: a routed expert's probability
    #                         where chosen, else 0


def top_p_set(probs: torch.Tensor, top_p: float, top_k: int) -> torch.Tensor:
    """The chosen set of each row of ``probs``: experts in order of falling
    probability (ties to the lower index) while the probability summed
    over those before is below ``top_p``, at most ``top_k``; the first is
    always chosen.  Returns a bool mask of probs' shape."""
    sp, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    before = torch.cat([torch.zeros_like(sp[..., :1]),
                        torch.cumsum(sp, dim=-1)[..., :-1]], dim=-1)
    rank = torch.arange(sp.shape[-1], device=sp.device)
    keep = (before < top_p) & (rank < top_k)
    return torch.zeros_like(keep).scatter(-1, idx, keep)


def route(h: torch.Tensor, router: torch.Tensor,
          cfg: UniMoEConfig) -> Routing:
    """The float32 router over h (N, S) (the compute-dtype input widened)."""
    probs = torch.softmax(h.float() @ router, dim=-1)
    chosen = top_p_set(probs, cfg.top_p, cfg.top_k)
    e = cfg.n_routed
    weights = torch.where(chosen[:, :e], probs[:, :e],
                          torch.zeros((), device=probs.device))
    return Routing(probs, chosen, weights)


def moe(h: torch.Tensor, blk: Params, li: int, cfg: UniMoEConfig,
        static: bool):
    """The expert layer over h (N, S) in the compute dtype: the shared
    experts' sum, then each routed expert's weighted output added in
    expert order, in f32.  ``static``: every routed expert over every row
    (weight 0 where not chosen); else each over the rows that chose it.
    Returns (out (N, S) f32, Routing)."""
    shared = _mlps(h, blk["shared_in"][li], blk["shared_out"][li])
    acc = shared[0]
    for s in range(1, shared.shape[0]):
        acc = acc + shared[s]
    r = route(h, blk["router"][li], cfg)
    if static:
        out = _mlps(h, blk["expert_in"][li], blk["expert_out"][li])
        for e in range(cfg.n_routed):
            acc = acc + r.weights[:, e:e + 1] * out[e]
        return acc, r
    for e in range(cfg.n_routed):
        rows = torch.nonzero(r.chosen[:, e]).squeeze(1)
        if rows.numel():
            z = _mlps(h[rows], blk["expert_in"][li, e:e + 1],
                      blk["expert_out"][li, e:e + 1])[0]
            acc.index_add_(0, rows, r.weights[rows, e:e + 1] * z)
    return acc, r


def connector(params: Params, cfg: UniMoEConfig,
              enc: torch.Tensor) -> torch.Tensor:
    """Encoder output (B, 1500, A) -> audio tokens (B, 200, S) f32: the
    first ``audio_frames`` frames mean-pooled in groups of ``pool``, then
    the linear map with its bias."""
    b, _, a = enc.shape
    pooled = enc[:, :cfg.audio_frames].float().reshape(
        b, cfg.audio_tokens, cfg.pool, a).mean(2)
    c = params["connector"]
    return _proj(pooled.to(c["w"].dtype), c["w"], c["b"])


def embed_prompt(params: Params, head: torch.Tensor, audio: torch.Tensor,
                 tail: torch.Tensor) -> torch.Tensor:
    """[head ids | audio tokens | tail ids] -> (B, T, S) f32; head / tail
    (B, n) int."""
    e = params["embed"]
    return torch.cat([e[head.long()].float(), audio,
                      e[tail.long()].float()], dim=1)


def _attend_prefill(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Causal grouped-query attention: q (B, T, H, D), k / v (B, T, Hkv,
    D) in the compute dtype; f32 scores and softmax, probabilities
    rounded to v's dtype.  Query head j reads K/V head j // (H / Hkv).
    Returns (B, T, H D) f32."""
    b, t, h, d = q.shape
    hk = k.shape[2]
    qf = q.float().reshape(b, t, hk, h // hk, d).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    s = torch.matmul(qf, kf.transpose(-1, -2)) * d ** -0.5
    mask = torch.ones(t, t, dtype=torch.bool, device=q.device).triu(1)
    s = s.masked_fill(mask, _NEG)
    p = torch.softmax(s, dim=-1).to(v.dtype).float()
    o = torch.matmul(p, vf)                                # (B, Hk, G, T, D)
    return o.permute(0, 3, 1, 2, 4).reshape(b, t, h * d)


def _qkv(h: torch.Tensor, blk: Params, li: int, cfg: UniMoEConfig,
         cos: torch.Tensor, sin: torch.Tensor):
    """q, k, v (..., heads, D) in the compute dtype, q and k rotated."""
    cd = h.dtype
    y = _proj(h, blk["wqkv"][li], blk["bqkv"][li])
    qw, kw = cfg.q_width, cfg.kv_width
    lead = y.shape[:-1]
    q = y[..., :qw].reshape(*lead, cfg.n_head, cfg.head_dim)
    k = y[..., qw:qw + kw].reshape(*lead, cfg.n_kv_head, cfg.head_dim)
    v = y[..., qw + kw:].reshape(*lead, cfg.n_kv_head, cfg.head_dim)
    return (apply_rope(q, cos, sin).to(cd), apply_rope(k, cos, sin).to(cd),
            v.to(cd))


def init_cache(cfg: UniMoEConfig, batch: int, capacity: int, dtype, *,
               device) -> KVCache:
    """The self-attention cache (L, B, C, Hkv D), zeros."""
    shape = (cfg.n_layer, batch, capacity, cfg.kv_width)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def prefill(params: Params, cfg: UniMoEConfig, x: torch.Tensor,
            cache: KVCache, routing: Optional[list] = None) -> torch.Tensor:
    """The prompt (B, T, S) f32 through the LM, writing cache slots
    [0, T); every row has T tokens at positions 0..T-1.  The routed
    experts run gathered.  ``routing``: a list that receives each layer's
    chosen set (B T, E + N).  Returns the last position's logits (B, V)
    f32."""
    blk = params["blocks"]
    cd = compute_dtype_of(params)
    b, t, s = x.shape
    cos, sin = rope_tables(torch.arange(t, device=x.device), cfg.head_dim,
                           cfg.rope_theta)
    for li in range(cfg.n_layer):
        h = rms_norm(x, blk["attn_norm"][li], cfg.rms_eps).to(cd)
        q, k, v = _qkv(h, blk, li, cfg, cos, sin)
        cache.k[li, :, :t] = k.reshape(b, t, cfg.kv_width)
        cache.v[li, :, :t] = v.reshape(b, t, cfg.kv_width)
        o = _attend_prefill(q, k, v)
        x = x + _proj(o.to(cd), blk["wo"][li])
        h = rms_norm(x, blk["mlp_norm"][li], cfg.rms_eps).to(cd)
        y, r = moe(h.reshape(b * t, s), blk, li, cfg, static=False)
        if routing is not None:
            routing.append(r.chosen)
        x = x + y.reshape(b, t, s)
    return logits(params, cfg, x[:, -1])


def logits(params: Params, cfg: UniMoEConfig, x: torch.Tensor
           ) -> torch.Tensor:
    """Final norm and the untied head: x (..., S) f32 -> (..., V) f32."""
    cd = compute_dtype_of(params)
    return _matmul_f32(rms_norm(x, params["norm"], cfg.rms_eps).to(cd),
                       params["head"])


def tally(chosen: torch.Tensor, n_routed: int) -> torch.Tensor:
    """Routing counts of a step's chosen sets (L, B, E + N): token-layers,
    routed experts run, null picks, and routed experts that at least one
    row chose (summed over layers), as int32 (4,) on the device."""
    routed = chosen[..., :n_routed]
    return torch.stack([
        chosen.new_full((), chosen.shape[0] * chosen.shape[1],
                        dtype=torch.int64),
        routed.sum(), chosen[..., n_routed:].sum(),
        routed.any(dim=1).sum()]).to(torch.int32)


def lm_step(params: Params, cfg: UniMoEConfig, tokens: torch.Tensor,
            positions: torch.Tensor, cache: KVCache, slot,
            counts: Optional[torch.Tensor] = None,
            routes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One token a row through the LM, the routed experts in the static
    form.  ``slot``: the cache slot of every row's new K/V, a host int or
    a (1,) int32 tensor on the device (written by ``index_copy_``; the
    attention kernel reads hi = slot + 1 there), so a CUDA graph replays
    every step.  ``counts``: an int32 (4,) device tensor that the step's
    routing counts (``tally``) are added to.  ``routes``: a bool (C, L, B,
    E + N) tensor whose entry at ``slot`` receives the step's chosen sets.
    Returns logits (B, V) f32."""
    blk = params["blocks"]
    cd = compute_dtype_of(params)
    x = params["embed"][tokens.long()].float()
    cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    on_device = isinstance(slot, torch.Tensor)
    at = slot.long() if on_device else None
    hi = slot + 1
    chosen = []
    for li in range(cfg.n_layer):
        h = rms_norm(x, blk["attn_norm"][li], cfg.rms_eps).to(cd)
        q, k, v = _qkv(h, blk, li, cfg, cos, sin)
        k = k.reshape(k.shape[0], cfg.kv_width)
        v = v.reshape(v.shape[0], cfg.kv_width)
        if on_device:
            cache.k[li].index_copy_(1, at, k[:, None])
            cache.v[li].index_copy_(1, at, v[:, None])
        else:
            cache.k[li, :, slot] = k
            cache.v[li, :, slot] = v
        o = gqa_decode_attention(q.reshape(q.shape[0], cfg.q_width),
                                 cache.k, cache.v, hi, n_head=cfg.n_head,
                                 n_kv_head=cfg.n_kv_head, layer=li)
        x = x + _proj(o.to(cd), blk["wo"][li])
        h = rms_norm(x, blk["mlp_norm"][li], cfg.rms_eps).to(cd)
        y, r = moe(h, blk, li, cfg, static=True)
        chosen.append(r.chosen)
        x = x + y
    chosen = torch.stack(chosen)
    if counts is not None:
        counts.add_(tally(chosen, cfg.n_routed))
    if routes is not None:
        if on_device:
            routes.index_copy_(0, at, chosen[None])
        else:
            routes[slot] = chosen
    return logits(params, cfg, x)
