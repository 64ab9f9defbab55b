"""HuggingFace Whisper checkpoint conversion.

Port of the JAX package's ``models/loader_hf.py``: a transformers Whisper
state dict (``openai/whisper-*`` layout, with or without the ``model.``
prefix) becomes the port's parameter tree.  Only local snapshot directories
are read; nothing is fetched.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping

import numpy as np
import torch

from .config import WhisperConfig, config_from_hparams
from .params import Params, _tree_to_device


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _t(x) -> np.ndarray:
    return np.ascontiguousarray(_np(x).T)


def _config(n_vocab, max_source_positions, d_model, encoder_attention_heads,
            encoder_layers, max_target_positions, decoder_attention_heads,
            decoder_layers, num_mel_bins) -> WhisperConfig:
    return config_from_hparams(
        n_vocab=n_vocab, n_audio_ctx=max_source_positions,
        n_audio_state=d_model, n_audio_head=encoder_attention_heads,
        n_audio_layer=encoder_layers, n_text_ctx=max_target_positions,
        n_text_state=d_model, n_text_head=decoder_attention_heads,
        n_text_layer=decoder_layers, n_mels=num_mel_bins)


def config_from_hf(hf_config) -> WhisperConfig:
    """A WhisperConfig from a transformers WhisperConfig (or any object
    with its attribute names)."""
    return _config(hf_config.vocab_size, hf_config.max_source_positions,
                   hf_config.d_model, hf_config.encoder_attention_heads,
                   hf_config.encoder_layers, hf_config.max_target_positions,
                   hf_config.decoder_attention_heads,
                   hf_config.decoder_layers, hf_config.num_mel_bins)


def params_from_hf_state_dict(sd: Mapping[str, Any], config: WhisperConfig,
                              *, compute_dtype=torch.bfloat16,
                              prefix: str = "model.", device=None) -> Params:
    """An HF Whisper state dict -> the port's tree on ``device`` (None is
    the card)."""
    if not any(k.startswith(prefix) for k in sd):
        prefix = ""

    def g(name: str) -> np.ndarray:
        return _np(sd[prefix + name])

    def gt(name: str) -> np.ndarray:
        return _t(sd[prefix + name])

    def attn_stack(side: str, kind: str, n_layer: int) -> Dict[str, Any]:
        out = {k: [] for k in ("wq", "bq", "wk", "wv", "bv", "wo", "bo")}
        for i in range(n_layer):
            p = f"{side}.layers.{i}.{kind}"
            out["wq"].append(gt(f"{p}.q_proj.weight"))
            out["bq"].append(g(f"{p}.q_proj.bias"))
            out["wk"].append(gt(f"{p}.k_proj.weight"))
            out["wv"].append(gt(f"{p}.v_proj.weight"))
            out["bv"].append(g(f"{p}.v_proj.bias"))
            out["wo"].append(gt(f"{p}.out_proj.weight"))
            out["bo"].append(g(f"{p}.out_proj.bias"))
        return {k: np.stack(v) for k, v in out.items()}

    def ln_stack(side: str, name: str, n_layer: int) -> Dict[str, Any]:
        return {"g": np.stack([g(f"{side}.layers.{i}.{name}.weight")
                               for i in range(n_layer)]),
                "b": np.stack([g(f"{side}.layers.{i}.{name}.bias")
                               for i in range(n_layer)])}

    def mlp_stack(side: str, n_layer: int) -> Dict[str, Any]:
        def st(fn, name):
            return np.stack([fn(f"{side}.layers.{i}.{name}")
                             for i in range(n_layer)])
        return {"w0": st(gt, "fc1.weight"), "b0": st(g, "fc1.bias"),
                "w1": st(gt, "fc2.weight"), "b1": st(g, "fc2.bias")}

    La, Lt = config.n_audio_layer, config.n_text_layer
    # the JAX package's layout (conv (width, in, out)); _tree_to_device
    # turns it into the port's
    tree = {
        "encoder": {
            "pos_embed": g("encoder.embed_positions.weight"),
            "conv1": {"w": g("encoder.conv1.weight").transpose(2, 1, 0),
                      "b": g("encoder.conv1.bias")},
            "conv2": {"w": g("encoder.conv2.weight").transpose(2, 1, 0),
                      "b": g("encoder.conv2.bias")},
            "ln_post": {"g": g("encoder.layer_norm.weight"),
                        "b": g("encoder.layer_norm.bias")},
            "blocks": {
                "attn_ln": ln_stack("encoder", "self_attn_layer_norm", La),
                "attn": attn_stack("encoder", "self_attn", La),
                "mlp_ln": ln_stack("encoder", "final_layer_norm", La),
                "mlp": mlp_stack("encoder", La),
            },
        },
        "decoder": {
            "pos_embed": g("decoder.embed_positions.weight"),
            "token_embed": g("decoder.embed_tokens.weight"),
            "ln": {"g": g("decoder.layer_norm.weight"),
                   "b": g("decoder.layer_norm.bias")},
            "blocks": {
                "attn_ln": ln_stack("decoder", "self_attn_layer_norm", Lt),
                "attn": attn_stack("decoder", "self_attn", Lt),
                "cross_attn_ln": ln_stack("decoder",
                                          "encoder_attn_layer_norm", Lt),
                "cross_attn": attn_stack("decoder", "encoder_attn", Lt),
                "mlp_ln": ln_stack("decoder", "final_layer_norm", Lt),
                "mlp": mlp_stack("decoder", Lt),
            },
        },
    }
    return _tree_to_device(tree, compute_dtype, device)


def load_hf_checkpoint(path: str, *, compute_dtype=torch.bfloat16,
                       device=None):
    """A local HF Whisper snapshot directory (``config.json`` plus
    ``model.safetensors`` or ``pytorch_model.bin``) -> (config, params).
    ``model.safetensors`` needs the ``safetensors`` package (ImportError
    without it, as in the JAX package); ``pytorch_model.bin`` is read with
    ``torch.load(weights_only=True)``."""
    cfg_json = os.path.join(path, "config.json")
    if not os.path.exists(cfg_json):
        raise FileNotFoundError(f"{path} is not a local HF checkpoint "
                                "directory")
    with open(cfg_json) as f:
        hf = json.load(f)
    config = _config(hf["vocab_size"], hf["max_source_positions"],
                     hf["d_model"], hf["encoder_attention_heads"],
                     hf["encoder_layers"], hf["max_target_positions"],
                     hf["decoder_attention_heads"], hf["decoder_layers"],
                     hf["num_mel_bins"])

    st_path = os.path.join(path, "model.safetensors")
    pt_path = os.path.join(path, "pytorch_model.bin")
    if os.path.exists(st_path):
        from safetensors.numpy import load_file
        sd = load_file(st_path)
    elif os.path.exists(pt_path):
        sd = torch.load(pt_path, map_location="cpu", weights_only=True)
    else:
        raise FileNotFoundError(f"no weights found under {path}")
    return config, params_from_hf_state_dict(sd, config,
                                             compute_dtype=compute_dtype,
                                             device=device)
