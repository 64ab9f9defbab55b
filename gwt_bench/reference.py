"""The plain reference: Whisper as published, in plain PyTorch.

It imports nothing of the program and takes nothing the program made.  It
gets the benchmark's own inputs (the PCM, the mel filterbank, the weights
the benchmark drew from the seed, the tokens) and works out the rest
itself: the log-mel, the encoder output, the cross-attention K/V, the
logits, the loss, the gradients and the AdamW state.

Precision: float32 with TF32 off (``precision("f32")``), unless a caller
asks for a lower one as the control of a comparison: ``"tf32"`` (TF32 on
in matmuls and convolutions) or ``"fp8"`` (every matmul operand rounded to
float8 e4m3 with a per-tensor scale, the products summed in f32).

Weights come in the layout the benchmark draws them in (``weights.py``):
per-layer leaves stacked on a leading axis, matrices (in, out) for
``x @ W``, convolution kernels (out, in, width).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16000
N_FFT = 400
HOP = 160
PAD = N_FFT // 2
CHUNK = 30 * SAMPLE_RATE
WINDOW_FRAMES = 3000


@contextlib.contextmanager
def precision(mode: str = "f32"):
    """TF32 off for "f32" and "fp8", on for "tf32", restored after."""
    if mode not in ("f32", "tf32", "fp8"):
        raise ValueError(f"unknown reference precision {mode!r}")
    on = mode == "tf32"
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# ------------------------------------------------------------------ log-mel
def slaney_filterbank(n_mels: int) -> np.ndarray:
    """librosa.filters.mel(sr=16000, n_fft=400, n_mels, norm="slaney",
    htk=False), the filterbank OpenAI ships with Whisper: (n_mels, 201)."""
    n_bins = N_FFT // 2 + 1
    fft_freqs = np.linspace(0.0, SAMPLE_RATE / 2, n_bins)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0

    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        return np.where(f >= min_log_hz,
                        min_log_mel + np.log(np.maximum(f, 1e-10)
                                             / min_log_hz) / logstep,
                        f / f_sp)

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        return np.where(m >= min_log_mel,
                        min_log_hz * np.exp(logstep * (m - min_log_mel)),
                        m * f_sp)

    pts = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(SAMPLE_RATE / 2),
                                n_mels + 2))
    ramps = pts[:, None] - fft_freqs[None, :]
    fdiff = np.diff(pts)
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    w = np.maximum(0.0, np.minimum(lower, upper))
    w *= (2.0 / (pts[2:] - pts[:-2]))[:, None]
    return w.astype(np.float32)


def log_mel(pcm: np.ndarray, filters: np.ndarray, device) -> torch.Tensor:
    """Whisper's log-mel of one clip in float64: reflect 200 samples at the
    head, 30 s of zeros and 200 more at the tail, a periodic Hann window,
    |rfft|^2 of 400 samples every 160, the filterbank, log10 with a 1e-10
    floor, the clip's max - 8 clamp and (x + 4) / 4.  Returns (n_mels,
    n_frames) float32, n_frames = (len + 30 s) / 160."""
    x = torch.as_tensor(np.asarray(pcm, np.float32), device=device
                        ).double()
    n = x.shape[0]
    head = torch.flip(x[1:PAD + 1], [0])
    if head.shape[0] < PAD:
        head = F.pad(head, (0, PAD - head.shape[0]))
    padded = torch.cat([head, x, x.new_zeros(CHUNK + PAD)])
    n_frames = (padded.shape[0] - N_FFT) // HOP
    frames = padded.unfold(0, N_FFT, HOP)[:n_frames]
    i = torch.arange(N_FFT, device=device, dtype=torch.float64)
    window = 0.5 * (1.0 - torch.cos(2.0 * math.pi * i / N_FFT))
    spec = torch.fft.rfft(frames * window, n=N_FFT, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2                  # (F, 201)
    fb = torch.as_tensor(filters, device=device).double()
    mel = torch.log10(torch.clamp_min(power @ fb.T, 1e-10))  # (F, M)
    mel = torch.maximum(mel, mel.max() - 8.0)
    return ((mel + 4.0) / 4.0).T.float()


def mel_window(pcm: np.ndarray, filters: np.ndarray, device) -> torch.Tensor:
    """The first 30 s window of a clip's log-mel: (n_mels, 3000)."""
    return log_mel(pcm, filters, device)[:, :WINDOW_FRAMES]


# -------------------------------------------------------------- the model
class Reference:
    """Whisper's forward pass, loss and AdamW over the benchmark's weights
    (``params``, read in f32), with the shapes of ``cfg`` (a config file:
    Hugging Face key names)."""

    def __init__(self, params: Dict, cfg: dict, mode: str = "f32"):
        self.p = params
        self.cfg = cfg
        self.mode = mode
        self.S = int(cfg["d_model"])
        self.enc_heads = int(cfg["encoder_attention_heads"])
        self.dec_heads = int(cfg["decoder_attention_heads"])

    # ---------------------------------------------------------- arithmetic
    def _round(self, t: torch.Tensor) -> torch.Tensor:
        """An fp8 (e4m3) copy of t with a per-tensor scale, in f32."""
        s = t.detach().abs().amax().clamp_min(1e-30) / 448.0
        return (t / s).to(torch.float8_e4m3fn).float() * s

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        x, w = x.float(), w.float()
        if self.mode == "fp8":
            x, w = self._round(x), self._round(w)
        return x @ w

    def lin(self, x, w, b=None):
        y = self.mm(x, w)
        return y if b is None else y + b.float()

    @staticmethod
    def ln(x, g, b):
        return F.layer_norm(x, (x.shape[-1],), g.float(), b.float(), 1e-5)

    def attend(self, q, k, v, n_head: int, causal: bool = False):
        """Multi-head attention: q (B, Tq, S), k / v (B, Tk, S)."""
        b, tq, s = q.shape
        tk = k.shape[1]
        d = s // n_head
        qh = q.reshape(b, tq, n_head, d).transpose(1, 2)
        kh = k.reshape(b, tk, n_head, d).transpose(1, 2)
        vh = v.reshape(b, tk, n_head, d).transpose(1, 2)
        scores = self.mm(qh, kh.transpose(-1, -2)) * d ** -0.5
        if causal:
            mask = torch.ones(tq, tk, dtype=torch.bool, device=q.device
                              ).triu(1 + tk - tq)
            scores = scores.masked_fill(mask, float("-inf"))
        o = self.mm(torch.softmax(scores, dim=-1), vh)
        return o.transpose(1, 2).reshape(b, tq, s)

    # ------------------------------------------------------------ encoder
    def encode(self, mel: torch.Tensor) -> torch.Tensor:
        """mel (B, n_mels, 3000) -> encoder output (B, 1500, S) f32."""
        e = self.p["encoder"]
        c1, c2 = e["conv1"], e["conv2"]
        if self.mode == "fp8":
            conv = lambda x, w, **kw: F.conv1d(  # noqa: E731
                self._round(x), self._round(w.float()), **kw)
        else:
            conv = lambda x, w, **kw: F.conv1d(x, w.float(), **kw)  # noqa
        x = F.gelu(conv(mel.float(), c1["w"], padding=1)
                   + c1["b"].float()[:, None])
        x = F.gelu(conv(x, c2["w"], stride=2, padding=1)
                   + c2["b"].float()[:, None])
        x = x.transpose(1, 2)
        x = x + e["pos_embed"][:x.shape[1]].float()
        blk = e["blocks"]
        for i in range(int(self.cfg["encoder_layers"])):
            a, m = blk["attn"], blk["mlp"]
            h = self.ln(x, blk["attn_ln"]["g"][i], blk["attn_ln"]["b"][i])
            o = self.attend(self.lin(h, a["wq"][i], a["bq"][i]),
                            self.lin(h, a["wk"][i]),
                            self.lin(h, a["wv"][i], a["bv"][i]),
                            self.enc_heads)
            x = x + self.lin(o, a["wo"][i], a["bo"][i])
            h = self.ln(x, blk["mlp_ln"]["g"][i], blk["mlp_ln"]["b"][i])
            h = F.gelu(self.lin(h, m["w0"][i], m["b0"][i]))
            x = x + self.lin(h, m["w1"][i], m["b1"][i])
        return self.ln(x, e["ln_post"]["g"], e["ln_post"]["b"])

    # ------------------------------------------------------------ decoder
    def logits(self, enc: torch.Tensor, tokens: torch.Tensor
               ) -> torch.Tensor:
        """Teacher-forced decoder: enc (B, 1500, S), tokens (B, T) ->
        logits (B, T, V) f32 against the token embedding."""
        d = self.p["decoder"]
        te = d["token_embed"]
        t = tokens.shape[1]
        x = te[tokens.long()].float() + d["pos_embed"][:t].float()
        blk = d["blocks"]
        for i in range(int(self.cfg["decoder_layers"])):
            a, c, m = blk["attn"], blk["cross_attn"], blk["mlp"]
            h = self.ln(x, blk["attn_ln"]["g"][i], blk["attn_ln"]["b"][i])
            o = self.attend(self.lin(h, a["wq"][i], a["bq"][i]),
                            self.lin(h, a["wk"][i]),
                            self.lin(h, a["wv"][i], a["bv"][i]),
                            self.dec_heads, causal=True)
            x = x + self.lin(o, a["wo"][i], a["bo"][i])
            h = self.ln(x, blk["cross_attn_ln"]["g"][i],
                        blk["cross_attn_ln"]["b"][i])
            o = self.attend(self.lin(h, c["wq"][i], c["bq"][i]),
                            self.lin(enc, c["wk"][i]),
                            self.lin(enc, c["wv"][i], c["bv"][i]),
                            self.dec_heads)
            x = x + self.lin(o, c["wo"][i], c["bo"][i])
            h = self.ln(x, blk["mlp_ln"]["g"][i], blk["mlp_ln"]["b"][i])
            h = F.gelu(self.lin(h, m["w0"][i], m["b0"][i]))
            x = x + self.lin(h, m["w1"][i], m["b1"][i])
        x = self.ln(x, d["ln"]["g"], d["ln"]["b"])
        return self.mm(x, te.T)

    def masked_nll_sum(self, mel, tokens, targets, mask) -> torch.Tensor:
        """sum over rows and positions of -log p(target) * mask."""
        lp = torch.log_softmax(self.logits(self.encode(mel), tokens), -1)
        nll = -torch.gather(lp, -1, targets.long()[..., None])[..., 0]
        return (nll * mask.float()).sum()


# ------------------------------------------------------------ served tokens
def allowed_mask(cfg: dict, n_vocab: int, first: bool, space_id: int,
                 device) -> torch.Tensor:
    """Tokens greedy decoding may emit without timestamps: every id up to
    and including end-of-text (the task, language and timestamp tokens
    above it are suppressed); at the first position neither end-of-text
    nor the blank (the vocabulary's " ")."""
    eot = int(cfg["eos_token_id"])
    ok = torch.arange(n_vocab, device=device) <= eot
    if first:
        ok[eot] = False
        if space_id >= 0:
            ok[space_id] = False
    return ok


def served_logprobs(ref: Reference, mels: torch.Tensor,
                    prompts: Sequence[List[int]],
                    served: Sequence[List[int]], space_id: int,
                    block: int = 4) -> List[torch.Tensor]:
    """For each request, teacher-forced over its prompt and served tokens:
    the log-softmax over the allowed tokens at every served position,
    (n_served, V) f32 (-inf where a token is not allowed).  ``mels`` (N,
    n_mels, 3000)."""
    out: List[torch.Tensor] = []
    dev = mels.device
    for s in range(0, len(prompts), block):
        e = slice(s, s + block)
        enc = ref.encode(mels[e])
        for j, (prompt, toks) in enumerate(zip(prompts[e], served[e])):
            if not len(toks):
                out.append(torch.empty(0, int(ref.cfg["vocab_size"]),
                                       device=dev))
                continue
            seq = torch.tensor(list(prompt) + list(toks), device=dev)
            n_p = len(prompt)
            rows = ref.logits(enc[j:j + 1], seq[None])[
                0, n_p - 1:n_p - 1 + len(toks)]         # row i predicts toks[i]
            ok = torch.stack([allowed_mask(ref.cfg, rows.shape[-1], i == 0,
                                           space_id, dev)
                              for i in range(len(toks))])
            out.append(torch.log_softmax(
                rows.masked_fill(~ok, float("-inf")), dim=-1))
        del enc
    return out


def token_numbers(lp: torch.Tensor, tokens: Sequence[int]):
    """(gap of each token below the row's best, log-prob of each token)
    of masked log-softmax rows ``lp``; inf / -inf where not allowed."""
    idx = torch.as_tensor(list(tokens), device=lp.device).long()
    at = lp[torch.arange(len(idx), device=lp.device), idx]
    return ((lp.max(-1).values - at).double().cpu().numpy(),
            at.double().cpu().numpy())


# ---------------------------------------------------------------- training
class AdamW:
    """optax's ``adamw`` (b1 0.9, b2 0.999, eps 1e-8, no eps_root, decay on
    every leaf) in f32: mu, nu, bias corrections, u = mu_hat /
    (sqrt(nu_hat) + eps) + wd p, p - lr u."""

    def __init__(self, lr: float, weight_decay: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.wd, self.b1, self.b2, self.eps = (lr, weight_decay,
                                                        b1, b2, eps)

    def init(self, params: Dict[str, torch.Tensor]):
        return {"count": 0,
                "mu": {k: torch.zeros_like(v) for k, v in params.items()},
                "nu": {k: torch.zeros_like(v) for k, v in params.items()}}

    def step(self, params, grads, state):
        count = state["count"] + 1
        bc1 = 1.0 - self.b1 ** count
        bc2 = 1.0 - self.b2 ** count
        new_p, mu, nu = {}, {}, {}
        for k, p in params.items():
            g = grads[k]
            mu[k] = self.b1 * state["mu"][k] + (1 - self.b1) * g
            nu[k] = self.b2 * state["nu"][k] + (1 - self.b2) * g * g
            u = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + self.eps)
            new_p[k] = p - self.lr * (u + self.wd * p)
        return new_p, {"count": count, "mu": mu, "nu": nu}


def flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """{"encoder/blocks/attn/wq": tensor, ...} of a nested dict."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten(v, key))
        else:
            out[key] = v
    return out


def unflatten(flat: Dict[str, torch.Tensor]) -> Dict:
    tree: Dict = {}
    for key, v in flat.items():
        node = tree
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v
    return tree


def loss_and_grads(flat: Dict[str, torch.Tensor], cfg: dict, mode: str,
                   mel, tokens, targets, mask, rows: int = 4):
    """The masked-mean cross-entropy of a batch and its gradient per leaf,
    in blocks of ``rows`` rows (each block's share of the global mean)."""
    count = torch.clamp_min(mask.float().sum(), 1.0)
    total = torch.zeros((), device=mel.device)
    grads = {k: torch.zeros_like(v) for k, v in flat.items()}
    keys = list(flat)
    for s in range(0, mel.shape[0], rows):
        e = slice(s, s + rows)
        leaves = {k: v.detach().requires_grad_(True) for k, v in flat.items()}
        ref = Reference(unflatten(leaves), cfg, mode)
        with torch.enable_grad():
            part = ref.masked_nll_sum(mel[e], tokens[e], targets[e],
                                      mask[e]) / count
            gs = torch.autograd.grad(part, [leaves[k] for k in keys])
        for k, g in zip(keys, gs):
            grads[k] += g
        total += part.detach()
    return total, grads


def train_steps(params: Dict, cfg: dict, batches: Sequence[Dict], lr: float,
                weight_decay: float, mode: str = "f32"):
    """The reference's first len(batches) AdamW steps from ``params`` (read
    in f32).  Each batch: ``pcm`` (list of clips), ``filters``, ``tokens``,
    ``targets``, ``mask``.  Returns (losses, first gradients, params after
    the last step), the latter two flat by leaf path."""
    flat = {k: v.detach().float().clone() for k, v in flatten(params).items()}
    opt = AdamW(lr, weight_decay)
    state = opt.init(flat)
    losses, first = [], None
    with precision(mode):
        for b in batches:
            dev = b["tokens"].device
            mel = torch.stack([mel_window(c, b["filters"], dev)
                               for c in b["pcm"]])
            loss, grads = loss_and_grads(flat, cfg, mode, mel, b["tokens"],
                                         b["targets"], b["mask"])
            losses.append(float(loss))
            if first is None:
                first = grads
            flat, state = opt.step(flat, grads, state)
    return losses, first, flat
