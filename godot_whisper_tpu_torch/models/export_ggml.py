"""Export a parameter tree back to a ggml ``.bin`` checkpoint.

The inverse of ``params_from_raw``: the port's tree goes out in the
reference's tensor names and orientation (whisper.cpp:1354-1510), so a model
made or changed here loads in every ggml consumer (and in the JAX package).
Port of the JAX package's ``models/export_ggml.py``; ``chip_smoke.py`` uses
it to make checkpoints without JAX.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from . import loader_ggml
from .config import WhisperConfig
from .params import params_to_numpy


def _t(x: np.ndarray) -> np.ndarray:
    """(in, out) tree orientation -> ggml's torch-style (out, in)."""
    return np.ascontiguousarray(x.T)


def params_to_tensors(params, config: WhisperConfig,
                      ttype: int = loader_ggml.GGML_TYPE_F16
                      ) -> Dict[str, Tuple[np.ndarray, int]]:
    """The port's tree (float leaves, any device) -> {ggml name: (float32
    array, ggml type)}: matrices and conv kernels in ``ttype``, norms,
    biases and positional embeddings in F32."""
    F32 = loader_ggml.GGML_TYPE_F32
    tree = params_to_numpy(params)   # the JAX package's layout, float32
    out: Dict[str, Tuple[np.ndarray, int]] = {}
    enc, dec = tree["encoder"], tree["decoder"]

    out["encoder.positional_embedding"] = (enc["pos_embed"], F32)
    for name in ("conv1", "conv2"):
        out[f"encoder.{name}.weight"] = (
            enc[name]["w"].transpose(2, 1, 0), ttype)
        out[f"encoder.{name}.bias"] = (enc[name]["b"].reshape(-1, 1), F32)
    out["encoder.ln_post.weight"] = (enc["ln_post"]["g"], F32)
    out["encoder.ln_post.bias"] = (enc["ln_post"]["b"], F32)

    def emit_attn(prefix: str, a, i: int) -> None:
        out[f"{prefix}.query.weight"] = (_t(a["wq"][i]), ttype)
        out[f"{prefix}.query.bias"] = (a["bq"][i], F32)
        out[f"{prefix}.key.weight"] = (_t(a["wk"][i]), ttype)
        out[f"{prefix}.value.weight"] = (_t(a["wv"][i]), ttype)
        out[f"{prefix}.value.bias"] = (a["bv"][i], F32)
        out[f"{prefix}.out.weight"] = (_t(a["wo"][i]), ttype)
        out[f"{prefix}.out.bias"] = (a["bo"][i], F32)

    def emit_ln(name: str, ln, i: int) -> None:
        out[f"{name}.weight"] = (ln["g"][i], F32)
        out[f"{name}.bias"] = (ln["b"][i], F32)

    def emit_blocks(side: str, blocks, n_layer: int, cross: bool) -> None:
        # the JAX package's record order, so both write the same bytes
        for i in range(n_layer):
            p = f"{side}.blocks.{i}"
            emit_ln(f"{p}.attn_ln", blocks["attn_ln"], i)
            emit_attn(f"{p}.attn", blocks["attn"], i)
            if cross:
                emit_ln(f"{p}.cross_attn_ln", blocks["cross_attn_ln"], i)
                emit_attn(f"{p}.cross_attn", blocks["cross_attn"], i)
            emit_ln(f"{p}.mlp_ln", blocks["mlp_ln"], i)
            out[f"{p}.mlp.0.weight"] = (_t(blocks["mlp"]["w0"][i]), ttype)
            out[f"{p}.mlp.0.bias"] = (blocks["mlp"]["b0"][i], F32)
            out[f"{p}.mlp.2.weight"] = (_t(blocks["mlp"]["w1"][i]), ttype)
            out[f"{p}.mlp.2.bias"] = (blocks["mlp"]["b1"][i], F32)

    emit_blocks("encoder", enc["blocks"], config.n_audio_layer, False)
    emit_blocks("decoder", dec["blocks"], config.n_text_layer, True)

    out["decoder.positional_embedding"] = (dec["pos_embed"], F32)
    out["decoder.token_embedding.weight"] = (dec["token_embed"], ttype)
    out["decoder.ln.weight"] = (dec["ln"]["g"], F32)
    out["decoder.ln.bias"] = (dec["ln"]["b"], F32)
    return out


def export_checkpoint(path: str, params, config: WhisperConfig,
                      mel_filters: np.ndarray, vocab_tokens: List[bytes], *,
                      ttype: Optional[int] = None) -> None:
    """Write a loadable ggml .bin from a parameter tree (F16 matrices by
    default)."""
    ttype = loader_ggml.GGML_TYPE_F16 if ttype is None else ttype
    ftype = {loader_ggml.GGML_TYPE_F32: 0,
             loader_ggml.GGML_TYPE_F16: 1}.get(ttype, 1)
    tensors = params_to_tensors(params, config, ttype)
    loader_ggml.write_checkpoint(path, config, mel_filters, vocab_tokens,
                                 tensors, ftype=ftype)
