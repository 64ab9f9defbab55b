"""The plain reference of the Uni-MoE-2.0-Omni cell: the speech path as
published, in plain PyTorch, float32 with TF32 off.  It imports nothing of
the program and takes nothing the program made: from the benchmark's PCM,
filterbank, weights and the served tokens it works out the log-mel and
the encoder (``reference.py``'s Whisper), the audio tokens, and the
language model's (the LM's) logits teacher-forced over each request's
prompt and served tokens, one layer's weights read in f32 at a time, the
rows in blocks.  No cache, no graph.

Published (HIT-TMG/Uni-MoE-2.0-Omni, ``config.json``): pre-RMSNorm blocks
(``rms_norm_eps``); grouped-query attention, query head j on K/V head
j // (H / Hkv), q/k/v biases, rotate-half rotary at ``rope_theta``,
causal; the expert MLP: ``mlp_fixed_expert_num`` shared SiLU-gated
experts always run, a float32 router (``fp32_gate``) over the routed
experts and the null expert, the experts in order of falling probability
(ties to the lower index) while the probability summed over those before
is below ``mlp_dynamic_top_p``, at most ``mlp_dynamic_top_k``; a chosen
routed expert's output times its probability, a chosen null expert adds
zero; a final RMSNorm and the untied head.

The configuration's ``assumed`` choices, made here as in the program:
each 20 s chunk padded to a 30 s window and encoded, the first 1000
frames mean-pooled in fives and mapped with the linear projector;
sequential positions (the three M-RoPE sections equal: 1-D RoPE); the
encoder Whisper-large-v3's; routed weights the probabilities over all
five outputs, not renormalised; the shared experts added unweighted; the
null expert the router's last output.  Departure: the weights are in the
program's layout (``weights_unimoe.py``).

``mode`` "fp8" rounds every matmul operand to float8 e4m3 with a
per-tensor scale (``reference.Reference._round``), the control of a
bfloat16 configuration.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from . import reference
from .weights_unimoe import dims, encoder_config


class ReferenceLM:
    def __init__(self, params, cfg: dict, mode: str = "f32"):
        self.p, self.cfg, self.mode = params, cfg, mode
        self.d = dims(cfg)
        self.enc = reference.Reference(params, encoder_config(cfg), mode)

    def mm(self, x, w):
        return self.enc.mm(x, w)

    def rms(self, x, g):
        eps = float(self.cfg["rms_norm_eps"])
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) \
            * g.float()

    def rope(self, x, pos):
        """x (B, T, H, D) rotated at positions pos (T,)."""
        dd = x.shape[-1]
        inv = 1.0 / float(self.cfg["rope_theta"]) ** (
            torch.arange(0, dd, 2, dtype=torch.float32, device=x.device) / dd)
        f = pos.float()[:, None] * inv
        f = torch.cat([f, f], -1)
        cos, sin = torch.cos(f)[:, None], torch.sin(f)[:, None]
        rot = torch.cat([-x[..., dd // 2:], x[..., :dd // 2]], -1)
        return x * cos + rot * sin

    # ------------------------------------------------------------ audio
    def audio_tokens(self, mel: torch.Tensor) -> torch.Tensor:
        """mel windows (B, n_mels, 3000) -> audio tokens (B, 200, S)."""
        enc = self.enc.encode(mel)
        b, _, a = enc.shape
        n, t = int(self.cfg["audio_frames"]), int(
            self.cfg["whisper_query_tokens_size"])
        x = enc[:, :n].reshape(b, t, n // t, a).mean(2)
        c = self.p["connector"]
        return self.mm(x, c["w"]) + c["b"].float()

    # ----------------------------------------------------------------- LM
    def chosen(self, probs: torch.Tensor) -> torch.Tensor:
        """The top-p sets of rows of probabilities: a stable sort (ties to
        the lower index), the f32 sum over the experts ranked before each,
        kept while below top-p and the rank below top-k."""
        sp, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        cs = torch.cumsum(sp, -1)
        before = torch.cat([torch.zeros_like(cs[..., :1]), cs[..., :-1]], -1)
        rank = torch.arange(sp.shape[-1], device=sp.device)
        keep = (before < float(self.cfg["mlp_dynamic_top_p"])) & (
            rank < int(self.cfg["mlp_dynamic_top_k"]))
        return torch.zeros_like(keep).scatter(-1, idx, keep)

    def expert(self, h, w_in, w_out):
        f = w_out.shape[0]
        y = self.mm(h, w_in)
        return self.mm(F.silu(y[:, :f]) * y[:, f:], w_out)

    def expert_layer(self, h, li: int, record: Optional[list],
                     forced: Optional[torch.Tensor] = None):
        """h (N, S) -> (N, S); ``forced`` (N, E + N) the chosen sets to use
        in place of the router's own; ``record`` receives (sets used,
        router probabilities)."""
        blk, d = self.p["blocks"], self.d
        out = torch.zeros_like(h)
        for s in range(d["NS"]):
            out = out + self.expert(h, blk["shared_in"][li, s],
                                    blk["shared_out"][li, s])
        probs = torch.softmax(self.mm(h, blk["router"][li]), -1)
        chosen = self.chosen(probs) if forced is None else forced
        if record is not None:
            record.append((chosen, probs))
        for e in range(d["E"]):
            rows = torch.nonzero(chosen[:, e]).squeeze(1)
            if rows.numel():
                out.index_add_(0, rows, probs[rows, e:e + 1] * self.expert(
                    h[rows], blk["expert_in"][li, e],
                    blk["expert_out"][li, e]))
        return out

    def logits(self, x: torch.Tensor, record: Optional[list] = None,
               forced: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        """Rows of one length x (B, T, S) f32 through the LM -> (B, T, V)
        f32.  ``forced``: each layer's chosen sets (B T, E + N) to use;
        ``record`` receives each layer's (sets, probabilities)."""
        blk, d = self.p["blocks"], self.d
        b, t, s = x.shape
        H, Hk, D = d["H"], d["Hk"], d["D"]
        pos = torch.arange(t, device=x.device)
        causal = torch.ones(t, t, dtype=torch.bool, device=x.device).triu(1)
        for li in range(d["L"]):
            h = self.rms(x, blk["attn_norm"][li])
            y = self.mm(h, blk["wqkv"][li]) + blk["bqkv"][li].float()
            q = self.rope(y[..., :H * D].reshape(b, t, H, D), pos)
            k = self.rope(y[..., H * D:(H + Hk) * D].reshape(b, t, Hk, D),
                          pos)
            v = y[..., (H + Hk) * D:].reshape(b, t, Hk, D)
            k = k.repeat_interleave(H // Hk, 2).transpose(1, 2)
            v = v.repeat_interleave(H // Hk, 2).transpose(1, 2)
            sc = self.mm(q.transpose(1, 2), k.transpose(-1, -2)) * D ** -0.5
            p = torch.softmax(sc.masked_fill(causal, float("-inf")), -1)
            o = self.mm(p, v).transpose(1, 2).reshape(b, t, H * D)
            x = x + self.mm(o, blk["wo"][li])
            h = self.rms(x, blk["mlp_norm"][li])
            x = x + self.expert_layer(
                h.reshape(b * t, s), li, record,
                None if forced is None else forced[li]).reshape(b, t, s)
        return self.mm(self.rms(x, self.p["norm"]), self.p["head"])


def served_logprobs(ref: ReferenceLM, mels: torch.Tensor,
                    head: Sequence[int], tail: Sequence[int],
                    served: Sequence[List[int]], block: int = 4,
                    forced: Optional[Sequence[np.ndarray]] = None,
                    record: Optional[list] = None) -> List[torch.Tensor]:
    """For each request: teacher-forced over [head | audio | tail | served
    tokens but the last], the log-softmax at every served position
    (n_served, V) f32.  Rows of one served length go through in blocks of
    ``block``.  ``forced``: per request, the chosen sets (positions,
    layers, E + N) to route by; ``record``: per request, a (positions,
    layers, E + N) pair of the sets used and the router's probabilities."""
    out: List[Optional[torch.Tensor]] = [None] * len(served)
    dev = mels.device
    e = ref.p["embed"]
    if record is not None:
        record.extend([None] * len(served))
    for n_tok in sorted({len(t) for t in served if len(t)}):
        rows = [j for j, t in enumerate(served) if len(t) == n_tok]
        for s in range(0, len(rows), block):
            part = rows[s:s + block]
            n = len(part)
            aud = ref.audio_tokens(mels[part])
            ids = torch.tensor([list(head) + [0] * (aud.shape[1]) + list(tail)
                                + list(served[j][:-1]) for j in part],
                               dtype=torch.long, device=dev)
            x = e[ids].float()
            x[:, len(head):len(head) + aud.shape[1]] = aud
            t = x.shape[1]
            fl = None
            if forced is not None:
                f = torch.as_tensor(np.stack([forced[j][:t] for j in part]),
                                    device=dev)            # (n, T, L, E+N)
                fl = [f[:, :, li].reshape(n * t, -1) for li in
                      range(f.shape[2])]
            rec = [] if record is not None else None
            p = len(head) + aud.shape[1] + len(tail)
            lg = ref.logits(x, rec, fl)[:, p - 1:]
            for i, j in enumerate(part):
                out[j] = torch.log_softmax(lg[i], -1)
                if record is not None:
                    record[j] = tuple(
                        torch.stack([r[k].reshape(n, t, -1)[i] for r in rec],
                                    1).cpu().numpy() for k in (0, 1))
            del aud, x, lg
    for j, toks in enumerate(served):
        if not len(toks):
            out[j] = torch.empty(0, int(ref.cfg["vocab_size"]), device=dev)
    return out


def route_numbers(sets: np.ndarray, probs: np.ndarray, top_p: float,
                  top_k: int) -> np.ndarray:
    """How far each chosen set (..., E + N) lies from being the top-p set
    of the reference's probabilities: 0 where it is one, else the least
    change of probability that would make it one: the set's weakest member
    below the best expert left out, or a lone expert below top-p, or two
    where the first alone reaches it (a set of another size: 1)."""
    p = probs.astype(np.float64)
    s = sets.astype(bool)
    n = s.sum(-1)
    inside = np.where(s, p, np.inf).min(-1)
    outside = np.where(s, -np.inf, p).max(-1)
    top = np.where(s, p, -np.inf).max(-1)
    rank = np.maximum(outside - inside, 0.0)
    size = np.where(n == 1, np.maximum(top_p - top, 0.0),
                    np.maximum(top - top_p, 0.0))
    far = np.maximum(rank, size)
    return np.where((n >= 1) & (n <= top_k), far, 1.0)
