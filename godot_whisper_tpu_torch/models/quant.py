"""Decoder weight quantization: int8 or int4 weights with in-kernel dequant.

Port of the JAX package's ``models/quant.py``.  Decode reads every decoder
weight once per step, so its bytes bound the step; these transforms store
the DECODER's matmul weights in 8 or 4 bits (ops/qmatmul.py) after load:

- the encoder stays in its compute dtype: it is compute-bound at batch and
  feeds the cross-KV;
- the token embedding quantizes per vocab row (V, S): one int8 buffer serves
  the embedding gather and the logits contraction (K9's ``oi`` layout);
- the self-attention q/k/v projections fuse into one (L, S, 3S) weight with
  a (L, 3S) bias whose K third is zero (K has no bias): per-output-channel
  scales make quantize(concat) == concat(quantize), so one launch replaces
  three with the same numbers.

Inference only.  Each transform is idempotent.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..ops.qmatmul import (QUANT_TYPES, Quant4Tensor, QuantTensor,
                           quantize_tensor, quantize_tensor4)
from ..runtime.logging import log_warn

Params = Dict[str, Any]

# matmul-weight keys inside decoder blocks, all stored (L, S_in, O_out):
# per-output-channel scales -> reduce over axis 1
_BLOCK_WEIGHT_KEYS = ("wq", "wk", "wv", "wo", "w0", "w1")


def _int8(w: torch.Tensor) -> QuantTensor:
    return quantize_tensor(w, reduce_axis=1)


def _fuse_self_qkv(attn: Dict[str, Any], quantize_fn) -> Dict[str, Any]:
    """(L, S, 3S) ``wqkv`` quantized by ``quantize_fn`` and (L, 3S) ``bqkv``
    with a zero K bias."""
    wqkv = torch.cat([attn["wq"], attn["wk"], attn["wv"]], dim=-1)
    bqkv = torch.cat([attn["bq"], torch.zeros_like(attn["bq"]), attn["bv"]],
                     dim=-1)
    return {"wqkv": quantize_fn(wqkv), "bqkv": bqkv}


def _with_decoder(params: Params, blocks, token_embed) -> Params:
    dec = dict(params["decoder"])
    dec["blocks"] = blocks
    dec["token_embed"] = token_embed
    return {"encoder": params["encoder"], "decoder": dec}


def _embed_int8(te):
    return te if isinstance(te, QuantTensor) else _int8(te)  # per vocab row


def quantize_decoder_int8(params: Params) -> Params:
    """Decoder matmul weights and the token embedding as int8
    ``QuantTensor``s, self q/k/v fused."""
    blocks: Dict[str, Any] = {}
    for group, sub in params["decoder"]["blocks"].items():
        new = {k: (_int8(v) if k in _BLOCK_WEIGHT_KEYS
                   and not isinstance(v, QUANT_TYPES) else v)
               for k, v in sub.items()}
        if group == "attn" and "wq" in sub and not isinstance(
                sub["wq"], QUANT_TYPES):
            for k in ("wq", "wk", "wv", "bq", "bv"):
                new.pop(k, None)
            new.update(_fuse_self_qkv(sub, _int8))
        blocks[group] = new
    return _with_decoder(params, blocks,
                         _embed_int8(params["decoder"]["token_embed"]))


def quantize_decoder_int4(params: Params, *, group: int = 128) -> Params:
    """Int4 decoder weights (``group``-row scales along the contraction
    axis); a weight whose contraction dim ``group`` does not divide stays
    int8, with a warning.  The token embedding stays int8: it feeds the
    logits, where 4-bit per-row error lands on the token distribution."""
    blocks: Dict[str, Any] = {}
    int8_fallbacks = []

    def q4(w, name):
        if w.shape[-2] % group == 0:
            return quantize_tensor4(w, group=group)
        int8_fallbacks.append(name)
        return _int8(w)

    for grp, sub in params["decoder"]["blocks"].items():
        new = {k: (q4(v, f"{grp}.{k}") if k in _BLOCK_WEIGHT_KEYS
                   and not isinstance(v, QUANT_TYPES) else v)
               for k, v in sub.items()}
        if grp == "attn" and "wq" in sub and not isinstance(
                sub["wq"], QUANT_TYPES):
            for k in ("wq", "wk", "wv", "bq", "bv"):
                new.pop(k, None)
            new.update(_fuse_self_qkv(sub, lambda w: q4(w, f"{grp}.wqkv")))
        blocks[grp] = new
    if int8_fallbacks:
        log_warn("quantize_decoder_int4: contraction dim not divisible by "
                 f"group={group} for {int8_fallbacks}; those weights kept "
                 "int8 (check quant_mode() for the landed precision)")
    return _with_decoder(params, blocks,
                         _embed_int8(params["decoder"]["token_embed"]))


def quantize_embed_int8(params: Params) -> Params:
    """int8-quantize ONLY the token embedding (the logits read, the largest
    per-step weight read at small batch); every other weight stays as it
    is."""
    te = params["decoder"]["token_embed"]
    if isinstance(te, QuantTensor):
        return params
    return _with_decoder(params, params["decoder"]["blocks"], _int8(te))


def is_quantized(params: Params) -> bool:
    return isinstance(params["decoder"]["token_embed"], QuantTensor)


def quant_mode(params: Params) -> Dict[str, str]:
    """Which precision landed per decoder weight key: {"blocks.<group>.
    <key>": "int4" | "int8" | dtype name, "token_embed": ...}."""
    def kind(v) -> str:
        if isinstance(v, Quant4Tensor):
            return "int4"
        if isinstance(v, QuantTensor):
            return "int8"
        return str(v.dtype).replace("torch.", "")

    out = {"token_embed": kind(params["decoder"]["token_embed"])}
    for grp, sub in params["decoder"]["blocks"].items():
        for k, v in sub.items():
            if k in _BLOCK_WEIGHT_KEYS or k == "wqkv":
                out[f"blocks.{grp}.{k}"] = kind(v)
    return out
