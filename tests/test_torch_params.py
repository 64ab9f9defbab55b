"""Port weights vs the JAX package's: init_params bit for bit, the converter
and its round trip, and the copied config registry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from godot_whisper_tpu.models.config import CONFIGS as JAX_CONFIGS
from godot_whisper_tpu.models.params import init_params as jax_init_params
from godot_whisper_tpu_torch.models.config import CONFIGS, get_config
from godot_whisper_tpu_torch.models.params import (init_params,
                                                   params_from_jax,
                                                   params_to_numpy)


def _nano(base="tiny.en"):
    return get_config(base).replace(
        n_audio_layer=2, n_text_layer=2, n_audio_state=128,
        n_audio_head=4, n_text_state=128, n_text_head=4, name="nano")


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy().view(np.int32)


def _jax_bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a.view(np.int32)


def test_registry_matches_jax():
    assert {k: v.__dict__ for k, v in CONFIGS.items()} == \
        {k: v.__dict__ for k, v in JAX_CONFIGS.items()}
    cfg = CONFIGS["large-v3"]
    jcfg = JAX_CONFIGS["large-v3"]
    for tok in ("token_eot", "token_sot", "token_beg", "token_translate",
                "token_transcribe", "token_not", "token_prev"):
        assert getattr(cfg, tok) == getattr(jcfg, tok)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_bit_exact(dtype):
    """Same seed -> identical weights in both packages (conv kernels
    transposed to PyTorch's (out, in, width))."""
    cfg = _nano()
    ours = init_params(cfg, seed=3, compute_dtype=getattr(torch, dtype),
                       device="cpu")
    ref = jax_init_params(cfg, seed=3, compute_dtype=getattr(jnp, dtype))
    ref_leaves = dict(_leaves(ref))
    our_leaves = dict(_leaves(ours))
    assert our_leaves.keys() == ref_leaves.keys()
    for path, want in ref_leaves.items():
        got = our_leaves[path]
        if path[-1] == "w" and path[1].startswith("conv"):
            got = got.permute(2, 1, 0).contiguous()
        assert str(got.dtype).split(".")[-1] == str(want.dtype), path
        assert tuple(got.shape) == want.shape, path
        np.testing.assert_array_equal(_bits(got), _jax_bits(want),
                                      err_msg=str(path))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_converter_round_trip(dtype):
    cfg = _nano()
    ref = jax_init_params(cfg, seed=5, compute_dtype=getattr(jnp, dtype))
    ref_np = jax.tree_util.tree_map(np.asarray, ref)
    ours = params_from_jax(ref_np)
    assert ours["encoder"]["conv1"]["w"].shape == (128, cfg.n_mels, 3)
    back = params_to_numpy(ours)
    for (path, want), (path2, got) in zip(_leaves(ref_np), _leaves(back)):
        assert path == path2
        np.testing.assert_array_equal(got, np.asarray(want, np.float32),
                                      err_msg=str(path))
    again = params_from_jax(back)
    for (path, a), (_, b) in zip(_leaves(ours), _leaves(again)):
        assert torch.equal(a.float(), b.float()), path
