"""The benchmark's model inputs, drawn from the seed: weights, vocabulary,
mel filterbank.

The weights are drawn on the device with one ``torch.Generator`` in two
large calls (one buffer in the compute dtype for the matrices, one f32
buffer for the vectors), then each leaf's view is scaled in place.  The
layout is the one the program takes (``models/params.py``): per-layer
leaves stacked on a leading axis, matrices (in, out), convolution kernels
(out, in, width), matrices and the token embedding in the compute dtype,
norms, biases and positional embeddings in f32.  The reference reads the
same tensors.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from .reference import slaney_filterbank

# every matrix ~ N(0, 0.02^2) (the published init_std of both configs);
# biases, LayerNorm shifts and positional embeddings ~ N(0, 0.02^2);
# LayerNorm gains 1 + N(0, 0.02^2)
STD = 0.02

_F32 = {"g", "b", "bq", "bv", "bo", "b0", "b1", "pos_embed"}


def shapes(cfg: dict) -> Dict[Tuple[str, ...], Tuple[int, ...]]:
    """Leaf path -> shape, in the program's layout."""
    S, M, V = int(cfg["d_model"]), int(cfg["num_mel_bins"]), \
        int(cfg["vocab_size"])
    fe, fd = int(cfg["encoder_ffn_dim"]), int(cfg["decoder_ffn_dim"])
    la, lt = int(cfg["encoder_layers"]), int(cfg["decoder_layers"])
    out: Dict[Tuple[str, ...], Tuple[int, ...]] = {}

    def ln(prefix, L):
        out[prefix + ("g",)] = (L, S) if L else (S,)
        out[prefix + ("b",)] = (L, S) if L else (S,)

    def attn(prefix, L):
        for w in ("wq", "wk", "wv", "wo"):
            out[prefix + (w,)] = (L, S, S)
        for b in ("bq", "bv", "bo"):
            out[prefix + (b,)] = (L, S)

    def blocks(prefix, L, ffn, cross):
        ln(prefix + ("attn_ln",), L)
        attn(prefix + ("attn",), L)
        if cross:
            ln(prefix + ("cross_attn_ln",), L)
            attn(prefix + ("cross_attn",), L)
        ln(prefix + ("mlp_ln",), L)
        out[prefix + ("mlp", "w0")] = (L, S, ffn)
        out[prefix + ("mlp", "b0")] = (L, ffn)
        out[prefix + ("mlp", "w1")] = (L, ffn, S)
        out[prefix + ("mlp", "b1")] = (L, S)

    out[("encoder", "pos_embed")] = (int(cfg["max_source_positions"]), S)
    out[("encoder", "conv1", "w")] = (S, M, 3)
    out[("encoder", "conv1", "b")] = (S,)
    out[("encoder", "conv2", "w")] = (S, S, 3)
    out[("encoder", "conv2", "b")] = (S,)
    ln(("encoder", "ln_post"), 0)
    blocks(("encoder", "blocks"), la, fe, cross=False)
    out[("decoder", "pos_embed")] = (int(cfg["max_target_positions"]), S)
    out[("decoder", "token_embed")] = (V, S)
    ln(("decoder", "ln"), 0)
    blocks(("decoder", "blocks"), lt, fd, cross=True)
    return out


def compute_dtype(cfg: dict) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[cfg["compute_dtype"]]


def draw(cfg: dict, seed: int, device, eot_embed_scale: float = 1.0
         ) -> Dict:
    """The weight tree for ``seed`` on ``device``."""
    dtype = compute_dtype(cfg)
    leaves = shapes(cfg)
    is_f32 = {p: p[-1] in _F32 for p in leaves}
    sizes = {p: int(torch.Size(s).numel()) for p, s in leaves.items()}
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    n_mat = sum(n for p, n in sizes.items() if not is_f32[p])
    n_vec = sum(n for p, n in sizes.items() if is_f32[p])
    mats = torch.randn(n_mat, generator=gen, device=device, dtype=dtype)
    vecs = torch.randn(n_vec, generator=gen, device=device,
                       dtype=torch.float32)
    tree: Dict = {}
    offs = {False: 0, True: 0}
    with torch.no_grad():
        for path, shape in leaves.items():
            f32 = is_f32[path]
            buf = vecs if f32 else mats
            t = buf[offs[f32]:offs[f32] + sizes[path]].view(shape)
            offs[f32] += sizes[path]
            t.mul_(float(cfg.get("decoder_pos_embed_std", STD))
                   if path == ("decoder", "pos_embed") else STD)
            if path[-1] == "g":
                t.add_(1.0)
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = t
        if eot_embed_scale != 1.0:
            tree["decoder"]["token_embed"][int(cfg["eos_token_id"])].mul_(
                eot_embed_scale)
    return tree


def vocabulary(cfg: dict) -> List[bytes]:
    """The regular tokens below end-of-text: the 256 bytes, then one
    placeholder word per id (no tokenizer files ship with the benchmark)."""
    eot = int(cfg["eos_token_id"])
    return [bytes([i]) for i in range(256)] + [
        f"<tok{i}>".encode() for i in range(256, eot)]


def space_id(vocab: List[bytes]) -> int:
    return vocab.index(b" ") if b" " in vocab else -1


def filterbank(cfg: dict):
    return slaney_filterbank(int(cfg["num_mel_bins"]))
