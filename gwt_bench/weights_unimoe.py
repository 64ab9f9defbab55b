"""The weights of the Uni-MoE-2.0-Omni cell, drawn from the seed on the
device: one buffer in the compute dtype for every matrix (53.6 GB in
bfloat16 at the published widths) and one f32 buffer for the vectors and
the router, each leaf a view, scaled in place.  The program serves from
these tensors and the reference reads them, so one copy is on the card.

Layout (the program's, ``models/unimoe.py``): per-layer leaves stacked on
a leading layer axis, matrices (in, out); ``wqkv`` holds q, k, v columns;
an expert's ``*_in`` holds its gate columns then its up columns; the
router's last output is the null expert; the head is (S, V).  The encoder
is Whisper's, as ``weights.py`` lays it out.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .weights import STD, compute_dtype, shapes as whisper_shapes

_F32 = {"g", "b", "bq", "bv", "bo", "b0", "b1", "pos_embed", "bqkv",
        "attn_norm", "mlp_norm", "router", "norm"}
_GAINS = {"g", "attn_norm", "mlp_norm", "norm"}


def encoder_config(cfg: dict) -> dict:
    """The audio encoder's widths in the Whisper cells' keys."""
    a = cfg["audio_encoder"]
    return {"d_model": a["d_model"], "encoder_layers": a["encoder_layers"],
            "encoder_attention_heads": a["encoder_attention_heads"],
            "encoder_ffn_dim": a["encoder_ffn_dim"],
            "num_mel_bins": a["num_mel_bins"],
            "max_source_positions": a["max_source_positions"],
            "decoder_layers": 0, "decoder_ffn_dim": 1,
            "decoder_attention_heads": a["encoder_attention_heads"],
            "vocab_size": 1, "max_target_positions": 1,
            "compute_dtype": cfg["compute_dtype"]}


def dims(cfg: dict) -> dict:
    S = int(cfg["hidden_size"])
    H, Hk = int(cfg["num_attention_heads"]), int(cfg["num_key_value_heads"])
    D = int(cfg["head_dim"])
    return {"S": S, "L": int(cfg["num_hidden_layers"]),
            "V": int(cfg["vocab_size"]), "H": H, "Hk": Hk, "D": D,
            "E": int(cfg["mlp_dynamic_expert_num"]),
            "N": int(cfg["mlp_dynamic_null_expert_num"]),
            "NS": int(cfg["mlp_fixed_expert_num"]),
            "F": int(cfg["dynamic_intermediate_size"]),
            "Fs": int(cfg["shared_intermediate_size"]),
            "A": int(cfg["whisper_hidden_size"])}


def shapes(cfg: dict) -> Dict[Tuple[str, ...], Tuple[int, ...]]:
    """Leaf path -> shape, in the program's layout."""
    d = dims(cfg)
    S, L, V, D = d["S"], d["L"], d["V"], d["D"]
    W = (d["H"] + 2 * d["Hk"]) * D
    out = {p: s for p, s in whisper_shapes(encoder_config(cfg)).items()
           if p[0] == "encoder"}
    out.update({
        ("connector", "w"): (d["A"], S), ("connector", "b"): (S,),
        ("embed",): (V, S), ("norm",): (S,), ("head",): (S, V),
        ("blocks", "attn_norm"): (L, S), ("blocks", "wqkv"): (L, S, W),
        ("blocks", "bqkv"): (L, W), ("blocks", "wo"): (L, d["H"] * D, S),
        ("blocks", "mlp_norm"): (L, S),
        ("blocks", "router"): (L, S, d["E"] + d["N"]),
        ("blocks", "shared_in"): (L, d["NS"], S, 2 * d["Fs"]),
        ("blocks", "shared_out"): (L, d["NS"], d["Fs"], S),
        ("blocks", "expert_in"): (L, d["E"], S, 2 * d["F"]),
        ("blocks", "expert_out"): (L, d["E"], d["F"], S)})
    return out


def draw(cfg: dict, seed: int, device, eot_head_scale: float = 1.0) -> Dict:
    """The weight tree for ``seed`` on ``device``."""
    dtype = compute_dtype(cfg)
    leaves = shapes(cfg)
    is_f32 = {p: p[-1] in _F32 for p in leaves}
    sizes = {p: int(torch.Size(s).numel()) for p, s in leaves.items()}
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    mats = torch.randn(sum(n for p, n in sizes.items() if not is_f32[p]),
                       generator=gen, device=device, dtype=dtype)
    vecs = torch.randn(sum(n for p, n in sizes.items() if is_f32[p]),
                       generator=gen, device=device, dtype=torch.float32)
    tree: Dict = {}
    offs = {False: 0, True: 0}
    with torch.no_grad():
        for path, shape in leaves.items():
            f32 = is_f32[path]
            buf = vecs if f32 else mats
            t = buf[offs[f32]:offs[f32] + sizes[path]].view(shape)
            offs[f32] += sizes[path]
            t.mul_(float(cfg.get("router_std", STD))
                   if path[-1] == "router" else STD)
            if path[-1] in _GAINS:
                t.add_(1.0)
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = t
        if eot_head_scale != 1.0:
            tree["head"][:, int(cfg["eot_token_id"])].mul_(eot_head_scale)
    return tree
