"""Parameter trees: layout, dtype policy, random init, conversion from a
ggml checkpoint (``params_from_raw``) and from the JAX package.

The layout is the JAX package's, so tests compare like with like:

- per-layer weights are stacked on a leading layer axis;
- matmul weights are ``(in, out)`` for ``x @ W``, in the compute dtype;
- LayerNorm scales and biases, biases and positional embeddings stay f32;
- a quantized decoder (models/quant.py) holds ``QuantTensor`` /
  ``Quant4Tensor`` leaves (int8 or packed uint8 ``q``, f32 ``s``), which the
  converters carry across bit for bit.

One difference: conv stem kernels are PyTorch's ``(out, in, width)``
(``torch.nn.functional.conv1d``), where the JAX package keeps ``(width, in,
out)`` for its NWC/WIO convolution.  ``params_from_jax`` and
``params_to_numpy`` transpose them.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..ops.qmatmul import QUANT_TYPES, Quant4Tensor, QuantTensor
from ..runtime.device import resolve_device
from .config import WhisperConfig
from .loader_ggml import RawCheckpoint

Params = Dict[str, Any]

# Leaf keys that stay float32 under any compute dtype.
_F32_KEYS = {"g", "b", "bq", "bv", "bo", "b0", "b1", "bqkv", "pos_embed"}
_CONV_KEYS = {("encoder", "conv1", "w"), ("encoder", "conv2", "w")}


def tree_map(fn, *trees, path=()):
    """``fn(path, *leaves)`` over nested dicts of one structure, into a
    tree of that structure; ``path`` is the tuple of keys to the leaf."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees), path=path + (k,))
                for k in trees[0]}
    return fn(path, *trees)


def tree_leaves(tree) -> list:
    """``[(path, leaf), ...]`` in the tree's order."""
    out = []
    tree_map(lambda path, x: out.append((path, x)), tree)
    return out


def cast_params(params: Params, compute_dtype) -> Params:
    """Matmul weights -> compute_dtype; norms, biases and positional
    embeddings -> float32; quantized weights stay as they are."""
    return tree_map(lambda path, t: t if isinstance(t, QUANT_TYPES)
                    else t.to(torch.float32 if path[-1] in _F32_KEYS
                              else compute_dtype), params)


def _numpy_to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes: carry the bits across
        return torch.from_numpy(
            np.ascontiguousarray(a).view(np.int16).copy()).view(
                torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def params_from_jax(tree: Params) -> Params:
    """Convert the JAX package's parameter tree (leaves as numpy arrays,
    e.g. ``jax.tree_util.tree_map(np.asarray, params)``) into the port's
    tree of CPU tensors, bit for bit: dtypes are kept, conv kernels
    transposed from ``(width, in, out)`` to ``(out, in, width)``, and the
    JAX package's quantized leaves (NamedTuples ``(q, s)``) become
    ``QuantTensor`` (int8 ``q``) or ``Quant4Tensor`` (uint8 ``q``)."""
    def leaf(path, a):
        if getattr(a, "_fields", None) == ("q", "s"):
            q, s = _numpy_to_torch(a.q), _numpy_to_torch(a.s)
            return (Quant4Tensor if q.dtype == torch.uint8
                    else QuantTensor)(q, s)
        t = _numpy_to_torch(a)
        if path in _CONV_KEYS:
            t = t.permute(2, 1, 0).contiguous()
        return t
    return tree_map(leaf, tree)


def params_to_numpy(params: Params) -> Params:
    """The port's tree back in the JAX package's layout as numpy arrays
    (bf16 leaves widened to float32, which is exact; quantized leaves as
    their container type holding numpy ``q`` and ``s``)."""
    def leaf(path, t):
        if isinstance(t, QUANT_TYPES):
            return type(t)(*(x.detach().cpu().contiguous().numpy()
                             for x in t))
        if path in _CONV_KEYS:
            t = t.permute(2, 1, 0)
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.detach().cpu().contiguous().numpy()
    return tree_map(leaf, params)


def init_params(config: WhisperConfig, *, seed: int = 0,
                compute_dtype=torch.bfloat16, scale: float = 0.02,
                device=None) -> Params:
    """Random-normal parameters: the same numpy generator, draw order and
    dtype policy as the JAX package's ``init_params``, so both packages
    hold identical weights for one seed.  ``device`` None is the card."""
    rng = np.random.default_rng(seed)
    c = config
    S, V, M = c.n_audio_state, c.n_vocab, c.n_mels
    La, Lt = c.n_audio_layer, c.n_text_layer

    def w(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * scale

    def ones(*shape):
        return np.ones(shape, dtype=np.float32)

    def zeros(*shape):
        return np.zeros(shape, dtype=np.float32)

    def attn(L):
        return {"wq": w(L, S, S), "bq": zeros(L, S), "wk": w(L, S, S),
                "wv": w(L, S, S), "bv": zeros(L, S), "wo": w(L, S, S),
                "bo": zeros(L, S)}

    def blocks(L, cross: bool):
        b = {
            "attn_ln": {"g": ones(L, S), "b": zeros(L, S)},
            "attn": attn(L),
            "mlp_ln": {"g": ones(L, S), "b": zeros(L, S)},
            "mlp": {"w0": w(L, S, 4 * S), "b0": zeros(L, 4 * S),
                    "w1": w(L, 4 * S, S), "b1": zeros(L, S)},
        }
        if cross:
            b["cross_attn_ln"] = {"g": ones(L, S), "b": zeros(L, S)}
            b["cross_attn"] = attn(L)
        return b

    tree = {
        "encoder": {
            "pos_embed": w(c.n_audio_ctx, S),
            "conv1": {"w": w(3, M, S), "b": zeros(S)},
            "conv2": {"w": w(3, S, S), "b": zeros(S)},
            "ln_post": {"g": ones(S), "b": zeros(S)},
            "blocks": blocks(La, cross=False),
        },
        "decoder": {
            "pos_embed": w(c.n_text_ctx, S),
            "token_embed": w(V, S),
            "ln": {"g": ones(S), "b": zeros(S)},
            "blocks": blocks(Lt, cross=True),
        },
    }
    return _tree_to_device(tree, compute_dtype, device)


def _tree_to_device(tree, compute_dtype, device) -> Params:
    """A float32 numpy tree in the JAX package's layout -> the port's tree
    in the dtype policy on ``device`` (None is the card)."""
    dev = resolve_device(device)
    params = cast_params(params_from_jax(tree), compute_dtype)
    return tree_map(lambda _, t: t.to(dev), params)


def _attn_block_names(prefix: str) -> Dict[str, str]:
    return {
        "wq": f"{prefix}.query.weight", "bq": f"{prefix}.query.bias",
        "wk": f"{prefix}.key.weight",                      # K has no bias
        "wv": f"{prefix}.value.weight", "bv": f"{prefix}.value.bias",
        "wo": f"{prefix}.out.weight", "bo": f"{prefix}.out.bias",
    }


def params_from_raw(raw: RawCheckpoint, *, compute_dtype=torch.bfloat16,
                    device=None) -> Params:
    """A ``RawCheckpoint`` (models/loader_ggml.py) -> the port's tree on
    ``device`` (None is the card) in ``compute_dtype``: the JAX package's
    ``params_from_raw`` table, ggml's (out, in) matrices transposed to (in,
    out), conv kernels kept in ggml's (out, in, width).  Missing tensors
    (stub checkpoints) are zero-filled; the pipeline sees ``n_loaded == 0``
    and takes the test fast path (whisper.cpp:5492-5497)."""
    c = raw.config
    t = raw.tensors
    S, V, M = c.n_audio_state, c.n_vocab, c.n_mels
    La, Lt = c.n_audio_layer, c.n_text_layer

    def get(name: str, shape) -> np.ndarray:
        arr = t.get(name)
        if arr is None:
            return np.zeros(shape, dtype=np.float32)
        return arr.astype(np.float32)

    def tr(a: np.ndarray) -> np.ndarray:
        return np.ascontiguousarray(a.T)

    def stack(fmt: str, n_layer: int, shape, transform=None) -> np.ndarray:
        outs = [get(fmt.format(i), shape) for i in range(n_layer)]
        return np.stack([transform(a) if transform else a for a in outs])

    def attn_stack(prefix_fmt: str, n_layer: int) -> Dict[str, np.ndarray]:
        out = {}
        for key, suffix in _attn_block_names("{p}").items():
            fmt = prefix_fmt + suffix[3:]  # strip "{p}"
            out[key] = (stack(fmt, n_layer, (S, S), tr) if key.startswith("w")
                        else stack(fmt, n_layer, (S,)))
        return out

    def ln(fmt: str, n_layer: int) -> Dict[str, np.ndarray]:
        return {"g": stack(fmt + ".weight", n_layer, (S,)),
                "b": stack(fmt + ".bias", n_layer, (S,))}

    def mlp(side: str, n_layer: int) -> Dict[str, np.ndarray]:
        p = side + ".blocks.{}.mlp"
        return {"w0": stack(p + ".0.weight", n_layer, (4 * S, S), tr),
                "b0": stack(p + ".0.bias", n_layer, (4 * S,)),
                "w1": stack(p + ".2.weight", n_layer, (S, 4 * S), tr),
                "b1": stack(p + ".2.bias", n_layer, (S,))}

    # built in the JAX package's layout (conv (width, in, out)), which
    # ``params_from_jax`` turns into the port's
    tree = {
        "encoder": {
            "pos_embed": get("encoder.positional_embedding",
                             (c.n_audio_ctx, S)),
            "conv1": {"w": get("encoder.conv1.weight", (S, M, 3)
                               ).transpose(2, 1, 0),
                      "b": get("encoder.conv1.bias", (S, 1)).reshape(S)},
            "conv2": {"w": get("encoder.conv2.weight", (S, S, 3)
                               ).transpose(2, 1, 0),
                      "b": get("encoder.conv2.bias", (S, 1)).reshape(S)},
            "ln_post": {"g": get("encoder.ln_post.weight", (S,)),
                        "b": get("encoder.ln_post.bias", (S,))},
            "blocks": {
                "attn_ln": ln("encoder.blocks.{}.attn_ln", La),
                "attn": attn_stack("encoder.blocks.{}.attn", La),
                "mlp_ln": ln("encoder.blocks.{}.mlp_ln", La),
                "mlp": mlp("encoder", La),
            },
        },
        "decoder": {
            "pos_embed": get("decoder.positional_embedding", (c.n_text_ctx, S)),
            "token_embed": get("decoder.token_embedding.weight", (V, S)),
            "ln": {"g": get("decoder.ln.weight", (S,)),
                   "b": get("decoder.ln.bias", (S,))},
            "blocks": {
                "attn_ln": ln("decoder.blocks.{}.attn_ln", Lt),
                "attn": attn_stack("decoder.blocks.{}.attn", Lt),
                "cross_attn_ln": ln("decoder.blocks.{}.cross_attn_ln", Lt),
                "cross_attn": attn_stack("decoder.blocks.{}.cross_attn", Lt),
                "mlp_ln": ln("decoder.blocks.{}.mlp_ln", Lt),
                "mlp": mlp("decoder", Lt),
            },
        },
    }
    return _tree_to_device(tree, compute_dtype, device)
