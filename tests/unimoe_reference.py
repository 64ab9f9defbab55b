"""Plain reference of Uni-MoE-2.0-Omni's speech-to-text path: the Whisper
encoder, the audio connector and the language model (the LM) with its
router, in float32 PyTorch with TF32 off.  No cache, no batching of
rows, no graph; it imports no kernel of the port.  The tests hold
``godot_whisper_tpu_torch/models/unimoe.py`` to it.

It follows the published description (HIT-TMG/Uni-MoE-2.0-Omni,
``config.json``):

- the LM: pre-RMSNorm blocks (eps ``rms_eps``) of grouped-query attention
  (query head j reads K/V head j // (H / Hkv)) with q/k/v biases, no output
  bias, rotary positions at ``rope_theta`` (rotate-half), causal; then the
  expert MLP; a final RMSNorm and an untied head;
- the expert MLP: the shared SiLU-gated experts, always run, their outputs
  added unweighted; a float32 router over the routed experts and the null
  expert (last); the experts in order of falling softmax probability (ties
  to the lower index) while the probability summed over those before is
  below ``top_p``, at most ``top_k``; each chosen routed expert's output
  times its probability; a chosen null expert adds zero.

Choices the published config does not state, made alike here and in the
program:

- pooling: each 20 s chunk padded to Whisper's 30 s window and encoded to
  1500 frames; the first ``audio_frames`` (1000) mean-pooled in groups of
  ``audio_frames / audio_tokens`` (5), then the linear map with a bias;
- positions: audio and text tokens take sequential positions, the three
  M-RoPE sections equal, which is 1-D RoPE;
- the encoder is Whisper-large-v3's (128 mels) at the configuration's
  ``audio`` widths;
- routed weights are the router's probabilities over all outputs, not
  renormalised over the chosen set;
- the shared experts' outputs are added unweighted.

Departures: the weights are the program's tensors in its layout (gate and
up columns of an expert in one matrix, q / k / v in one); the log-mel is
Whisper's (the caller gives the mel window).  Each layer's weights are
read in f32 one layer at a time.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def f32():
    """TF32 off in matmuls and convolutions, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# ------------------------------------------------------------------ encoder
def _ln(x, g, b):
    return F.layer_norm(x, (x.shape[-1],), g.float(), b.float(), 1e-5)


def _mha(q, k, v, n_head, causal=False):
    b, tq, s = q.shape
    tk = k.shape[1]
    d = s // n_head
    qh = q.reshape(b, tq, n_head, d).transpose(1, 2)
    kh = k.reshape(b, tk, n_head, d).transpose(1, 2)
    vh = v.reshape(b, tk, n_head, d).transpose(1, 2)
    sc = qh @ kh.transpose(-1, -2) * d ** -0.5
    if causal:
        sc = sc.masked_fill(torch.ones(tq, tk, dtype=torch.bool,
                                       device=q.device).triu(1),
                            float("-inf"))
    return (torch.softmax(sc, -1) @ vh).transpose(1, 2).reshape(b, tq, s)


def encode(enc, audio_cfg, mel_window: torch.Tensor) -> torch.Tensor:
    """Whisper's encoder: mel (B, 3000, n_mels) -> (B, 1500, A) f32."""
    x = mel_window.float().transpose(1, 2)
    x = F.gelu(F.conv1d(x, enc["conv1"]["w"].float(), padding=1)
               + enc["conv1"]["b"].float()[:, None])
    x = F.gelu(F.conv1d(x, enc["conv2"]["w"].float(), stride=2, padding=1)
               + enc["conv2"]["b"].float()[:, None])
    x = x.transpose(1, 2) + enc["pos_embed"][:x.shape[2]].float()
    blk = enc["blocks"]
    for i in range(audio_cfg.n_audio_layer):
        a, m = blk["attn"], blk["mlp"]
        h = _ln(x, blk["attn_ln"]["g"][i], blk["attn_ln"]["b"][i])
        o = _mha(h @ a["wq"][i].float() + a["bq"][i].float(),
                 h @ a["wk"][i].float(),
                 h @ a["wv"][i].float() + a["bv"][i].float(),
                 audio_cfg.n_audio_head)
        x = x + o @ a["wo"][i].float() + a["bo"][i].float()
        h = _ln(x, blk["mlp_ln"]["g"][i], blk["mlp_ln"]["b"][i])
        h = F.gelu(h @ m["w0"][i].float() + m["b0"][i].float())
        x = x + h @ m["w1"][i].float() + m["b1"][i].float()
    return _ln(x, enc["ln_post"]["g"], enc["ln_post"]["b"])


def audio_tokens(params, cfg, enc: torch.Tensor) -> torch.Tensor:
    """Mean-pool the first audio_frames frames in groups, then the linear
    map: (B, 1500, A) -> (B, audio_tokens, S)."""
    b, _, a = enc.shape
    pool = cfg.audio_frames // cfg.audio_tokens
    x = enc[:, :cfg.audio_frames].reshape(b, cfg.audio_tokens, pool,
                                          a).mean(2)
    c = params["connector"]
    return x @ c["w"].float() + c["b"].float()


# ----------------------------------------------------------------------- LM
def _rms(x, g, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * g.float()


def _rope(x, pos, theta):
    """x (T, H, D) rotated at positions pos (T,)."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                       device=x.device) / d)
    f = pos.float()[:, None] * inv
    f = torch.cat([f, f], -1)
    cos, sin = torch.cos(f)[:, None], torch.sin(f)[:, None]
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], -1)
    return x * cos + rot * sin


def chosen_set(probs: torch.Tensor, top_p: float, top_k: int
               ) -> torch.Tensor:
    """The top-p set of each row, written out row by row."""
    out = torch.zeros_like(probs, dtype=torch.bool)
    p = probs.detach().float().cpu()
    limit = torch.tensor(top_p, dtype=torch.float32)
    for n in range(p.shape[0]):
        order = sorted(range(p.shape[1]), key=lambda e: (-float(p[n, e]), e))
        total = torch.zeros((), dtype=torch.float32)    # summed in f32
        for rank, e in enumerate(order):
            if rank >= top_k or total >= limit:
                break
            out[n, e] = True
            total = total + p[n, e]
    return out


def _expert(h, w_in, w_out):
    f = w_out.shape[0]
    y = h @ w_in.float()
    return (F.silu(y[:, :f]) * y[:, f:]) @ w_out.float()


def expert_layer(h, blk, li, cfg, record: Optional[list] = None):
    """h (T, S) f32 -> (T, S): shared experts plus the routed experts of
    each token's top-p set, weighted by their probabilities."""
    out = torch.zeros_like(h)
    for s in range(cfg.n_shared):
        out = out + _expert(h, blk["shared_in"][li, s],
                            blk["shared_out"][li, s])
    probs = torch.softmax(h @ blk["router"][li].float(), -1)
    chosen = chosen_set(probs, cfg.top_p, cfg.top_k)
    if record is not None:
        record.append(chosen)
    for e in range(cfg.n_routed):
        rows = torch.nonzero(chosen[:, e]).squeeze(1)
        if rows.numel():
            out[rows] += probs[rows, e:e + 1] * _expert(
                h[rows], blk["expert_in"][li, e], blk["expert_out"][li, e])
    return out


def lm_logits(params, cfg, x: torch.Tensor,
              record: Optional[list] = None) -> torch.Tensor:
    """One row's sequence of embeddings x (T, S) f32 through the LM ->
    logits (T, V) f32.  ``record`` receives each layer's chosen sets."""
    blk = params["blocks"]
    t = x.shape[0]
    pos = torch.arange(t, device=x.device)
    H, Hk, D = cfg.n_head, cfg.n_kv_head, cfg.head_dim
    for li in range(cfg.n_layer):
        h = _rms(x, blk["attn_norm"][li], cfg.rms_eps)
        y = h @ blk["wqkv"][li].float() + blk["bqkv"][li].float()
        q = _rope(y[:, :H * D].reshape(t, H, D), pos, cfg.rope_theta)
        k = _rope(y[:, H * D:(H + Hk) * D].reshape(t, Hk, D), pos,
                  cfg.rope_theta)
        v = y[:, (H + Hk) * D:].reshape(t, Hk, D)
        k = k.repeat_interleave(H // Hk, dim=1)
        v = v.repeat_interleave(H // Hk, dim=1)
        o = _mha(q.reshape(1, t, H * D), k.reshape(1, t, H * D),
                 v.reshape(1, t, H * D), H, causal=True)[0]
        x = x + o @ blk["wo"][li].float()
        h = _rms(x, blk["mlp_norm"][li], cfg.rms_eps)
        x = x + expert_layer(h, blk, li, cfg, record)
    return _rms(x, params["norm"], cfg.rms_eps) @ params["head"].float()


def served_logits(params, cfg, mel_window: torch.Tensor,
                  head: Sequence[int], tail: Sequence[int],
                  served: Sequence[Sequence[int]],
                  record: Optional[List[list]] = None) -> List[torch.Tensor]:
    """For each row: teacher-forced over [head | audio | tail | served],
    the logits that predict each served token (n_served, V) f32.
    ``mel_window`` (B, 3000, n_mels)."""
    with f32():
        enc = encode(params["encoder"], cfg.audio, mel_window)
        aud = audio_tokens(params, cfg, enc)
        e = params["embed"]
        dev = aud.device
        out = []
        for b, toks in enumerate(served):
            ids = lambda z: e[torch.tensor(list(z), dtype=torch.long,  # noqa
                                           device=dev)].float()
            x = torch.cat([ids(head), aud[b], ids(tail),
                           ids(toks) if len(toks) else aud[b, :0]])
            rec = [] if record is not None else None
            lg = lm_logits(params, cfg, x, rec)
            if record is not None:
                record.append(rec)
            p = len(head) + aud.shape[1] + len(tail)
            out.append(lg[p - 1:p - 1 + len(toks)])
        return out
