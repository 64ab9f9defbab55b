"""The yardstick's arithmetic for the Uni-MoE-2.0-Omni cell: the bytes
and operations of the language model's (the LM's) decode steps and of its
grouped-query decode attention, counted from the configuration's shapes
and the program's routing counts (``work.py`` has the peaks and the
roofline bound).

Counts are of the work the traffic needs: a step reads every LM weight
but the routed experts once (attention, router, shared experts, norms, the
head, and the rows of the embedding its tokens look up), each routed
expert that at least one row chose (``experts_hit``, summed over steps
and layers), and every live K/V slot once a layer; operations are two a
multiply-add of the weights a row runs (its routed experts from
``routed_pairs``) and of attention over its live slots.
"""

from __future__ import annotations

from typing import Dict

from .weights_unimoe import dims

BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def _b(cfg: dict) -> int:
    return BYTES[cfg["compute_dtype"]]


def expert_params(cfg: dict) -> int:
    """One routed expert of one layer: gate, up and down."""
    d = dims(cfg)
    return 3 * d["S"] * d["F"]


def dense_params(cfg: dict) -> Dict[str, int]:
    """Matrix parameters a step reads whatever the routing: per layer
    (attention, shared experts) and once (the head)."""
    d = dims(cfg)
    S, D = d["S"], d["D"]
    attn = S * (d["H"] + 2 * d["Hk"]) * D + d["H"] * D * S
    shared = d["NS"] * 3 * S * d["Fs"]
    return {"layer": attn + shared, "head": S * d["V"]}


def vector_bytes(cfg: dict) -> int:
    """f32 leaves a step reads: norms, q/k/v biases, the router."""
    d = dims(cfg)
    W = (d["H"] + 2 * d["Hk"]) * d["D"]
    return 4 * (d["L"] * (2 * d["S"] + W + d["S"] * (d["E"] + d["N"]))
                + d["S"])


def live_slots(prompt: int, forwards: int) -> int:
    """Slots the forwards attend, summed: forward i of a row reads its
    prompt and i + 1 decoded tokens."""
    return sum(prompt + i + 1 for i in range(forwards))


def gqa_attention(cfg: dict, rows: int, prompt: int, forwards: int
                  ) -> Dict[str, float]:
    """The decode attention of ``forwards`` steps of ``rows`` rows: every
    live K and V slot read once a layer (Hkv D values each), the queries
    read and the f32 outputs written; 4 operations a live slot and query
    width."""
    d = dims(cfg)
    slots = live_slots(prompt, forwards)
    kvw, qw = d["Hk"] * d["D"], d["H"] * d["D"]
    per_q = qw * (_b(cfg) + 4)
    return {"ops": 4.0 * slots * qw * d["L"] * rows,
            "bytes": (2.0 * slots * kvw * _b(cfg) + forwards * per_q)
            * d["L"] * rows}


def decode_steps(cfg: dict, rows: int, prompt: int, forwards: int,
                 experts_hit: int, routed_pairs: int) -> Dict[str, float]:
    """``forwards`` LM steps of ``rows`` rows: bytes of the weights read
    (the routed experts as hit), the embedding rows and the live K/V;
    operations of the weights each row runs and of attention."""
    d = dims(cfg)
    b = _b(cfg)
    dense = dense_params(cfg)
    w_bytes = (forwards * ((d["L"] * dense["layer"] + dense["head"]) * b
                           + vector_bytes(cfg) + rows * d["S"] * b)
               + experts_hit * expert_params(cfg) * b)
    att = gqa_attention(cfg, rows, prompt, forwards)
    ops = (2.0 * forwards * rows * (d["L"] * dense["layer"] + dense["head"])
           + 2.0 * routed_pairs * expert_params(cfg) + att["ops"])
    return {"ops": ops, "bytes": w_bytes + att["bytes"]}
