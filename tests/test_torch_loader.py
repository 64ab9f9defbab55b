"""Checkpoints in the port against the JAX package on the CPU: the ggml
reader bit for bit on files of every GGML type, both writing directions,
``params_from_raw``, ``from_file`` / ``from_buffer``, the weightless stub's
test fast path and the HuggingFace snapshot loader."""

import json
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import godot_whisper_tpu as jgwt
import godot_whisper_tpu_torch as gt
from godot_whisper_tpu.audio.mel import mel_filterbank as jmel_filterbank
from godot_whisper_tpu.audio.tokenizer import synthetic_vocab as jvocab
from godot_whisper_tpu.models import export_ggml as jexport
from godot_whisper_tpu.models import loader_ggml as jloader
from godot_whisper_tpu.models import loader_hf as jhf
from godot_whisper_tpu.models.params import init_params as jax_init_params
from godot_whisper_tpu.models.params import params_from_raw as jparams_raw
from godot_whisper_tpu_torch.models import export_ggml as texport
from godot_whisper_tpu_torch.models import loader_ggml as tloader
from godot_whisper_tpu_torch.models import loader_hf as thf
from godot_whisper_tpu_torch.models.params import (params_from_jax,
                                                   params_from_raw)

L = jloader
# every GGML type the reader takes (ggml.h:325-341)
TYPES = {"F32": L.GGML_TYPE_F32, "F16": L.GGML_TYPE_F16,
         "Q4_0": L.GGML_TYPE_Q4_0, "Q4_1": L.GGML_TYPE_Q4_1,
         "Q5_0": L.GGML_TYPE_Q5_0, "Q5_1": L.GGML_TYPE_Q5_1,
         "Q8_0": L.GGML_TYPE_Q8_0, "Q2_K": L.GGML_TYPE_Q2_K,
         "Q3_K": L.GGML_TYPE_Q3_K, "Q4_K": L.GGML_TYPE_Q4_K,
         "Q5_K": L.GGML_TYPE_Q5_K, "Q6_K": L.GGML_TYPE_Q6_K}
# the two types ``quantize_blocks`` does not encode: blocks made here
RAW_ONLY = {"Q5_0": 22, "Q5_1": 24}
GATES_OPEN = dict(entropy_thold=-1e9, logprob_thold=-1e9)


def _cfg(pkg, n_text_layer=1):
    return pkg.get_config("tiny.en").replace(
        n_audio_layer=1, n_text_layer=n_text_layer, n_audio_state=64,
        n_audio_head=2, n_text_state=64, n_text_head=2, name="pico")


@pytest.fixture(scope="module")
def pico_jax():
    cfg = _cfg(jgwt)
    return cfg, jax_init_params(cfg, seed=0, compute_dtype=jnp.float32)


def _raw_blocks(rec_bytes: int, n_blocks: int, seed: int) -> bytes:
    """Q5_0 / Q5_1 blocks: random payloads with finite f16 d (and m)."""
    rng = np.random.default_rng(seed)
    rec = rng.integers(0, 256, (n_blocks, rec_bytes), dtype=np.uint8)
    n_f16 = 2 if rec_bytes == 24 else 1
    rec[:, :2 * n_f16] = (rng.standard_normal((n_blocks, n_f16)) * 0.01
                          ).astype("<f2").view(np.uint8)
    return rec.tobytes()


def _append_record(path: str, name: str, ne, ttype: int, payload: bytes):
    """One tensor record after the header (the reader reads to EOF)."""
    name_b = name.encode()
    with open(path, "ab") as f:
        f.write(struct.pack("<iii", len(ne), len(name_b), ttype))
        for d in ne:
            f.write(struct.pack("<i", d))
        f.write(name_b)
        f.write(payload)


def _assert_raw_equal(a, b):
    assert a.config == b.config or vars(a.config) == vars(b.config)
    assert (a.ftype, a.qnt_version) == (b.ftype, b.qnt_version)
    assert np.array_equal(a.mel_filters, b.mel_filters)
    assert a.vocab_tokens == b.vocab_tokens
    assert a.tensors.keys() == b.tensors.keys()
    for k in a.tensors:
        assert a.tensors[k].shape == b.tensors[k].shape, k
        assert np.array_equal(a.tensors[k], b.tensors[k]), k


@pytest.mark.parametrize("tname", list(TYPES))
def test_read_checkpoint_matches_jax(tname, pico_jax, tmp_path):
    """A file written by the JAX exporter reads bit for bit the same in
    both packages; the port's exporter writes the same bytes from the same
    weights, and the JAX reader reads them back as the port does.  Q5_0 /
    Q5_1 (no encoder in either package) are records of random blocks
    appended to a stub file."""
    cfg, jp = pico_jax
    filt, vocab = jmel_filterbank(80), jvocab(cfg)
    j_path, t_path = str(tmp_path / "j.bin"), str(tmp_path / "t.bin")
    ttype = TYPES[tname]
    if tname in RAW_ONLY:
        for path, write in ((j_path, jloader.write_stub_checkpoint),
                            (t_path, tloader.write_stub_checkpoint)):
            write(path, cfg, filt, vocab)
            for i, ne in enumerate([(64, 64), (256, 32)]):
                _append_record(path, f"t{i}", ne, ttype,
                               _raw_blocks(RAW_ONLY[tname],
                                           ne[0] * ne[1] // 32, i))
    else:
        jexport.export_checkpoint(j_path, jp, cfg, filt, vocab, ttype=ttype)
        texport.export_checkpoint(
            t_path, params_from_jax(jax.tree_util.tree_map(np.asarray, jp)),
            cfg, filt, vocab, ttype=ttype)
    assert open(t_path, "rb").read() == open(j_path, "rb").read()
    want = jloader.read_checkpoint(j_path)
    got = tloader.read_checkpoint(j_path)
    assert want.n_loaded > 0
    _assert_raw_equal(got, want)
    _assert_raw_equal(jloader.read_checkpoint(t_path),
                      tloader.read_checkpoint(t_path))
    # the other two sources: a file object and bytes
    with open(j_path, "rb") as f:
        _assert_raw_equal(tloader.read_checkpoint(f), want)
    _assert_raw_equal(tloader.read_checkpoint(open(j_path, "rb").read()),
                      want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_raw_matches_jax(dtype, pico_jax, tmp_path):
    """The port's tree of a checkpoint is the JAX package's, converted
    (conv kernels to (out, in, width)), bit for bit."""
    cfg, jp = pico_jax
    path = str(tmp_path / "p.bin")
    jexport.export_checkpoint(path, jp, cfg, jmel_filterbank(80),
                              jvocab(cfg), ttype=L.GGML_TYPE_F16)
    raw = tloader.read_checkpoint(path)
    want = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jparams_raw(jloader.read_checkpoint(path),
                                compute_dtype=getattr(jnp, dtype))))
    got = params_from_raw(raw, compute_dtype=getattr(torch, dtype),
                          device="cpu")
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(flat_w) == len(flat_g)
    for path_, w in flat_w:
        g = flat_g[path_]
        assert g.dtype == w.dtype and g.shape == w.shape, path_
        assert torch.equal(g, w), path_


def _audio(seconds):
    t = np.arange(int(seconds * 16000)) / 16000.0
    return (0.3 * np.sin(2 * np.pi * (220.0 + 60 * np.sin(
        2 * np.pi * 0.07 * t)) * t)
        + 0.2 * np.sin(2 * np.pi * 447.0 * t)).astype(np.float32)


def _view(segs):
    return [(s.text, s.t0, s.t1, [t.id for t in s.tokens]) for s in segs]


def test_from_file_and_from_buffer_match_jax(tmp_path):
    """from_file and from_buffer load the same model: the same tree, and
    ``full`` gives the JAX package's from_file segments (f32, gates
    open)."""
    cfg = _cfg(jgwt, n_text_layer=3)
    path = str(tmp_path / "pico3.bin")
    jexport.export_checkpoint(
        path, jax_init_params(cfg, seed=1, compute_dtype=jnp.float32), cfg,
        jmel_filterbank(80), jvocab(cfg), ttype=L.GGML_TYPE_F32)
    a = gt.WhisperContext.from_file(path, compute_dtype=torch.float32,
                                    device="cpu")
    b = gt.WhisperContext.from_buffer(open(path, "rb").read(),
                                      compute_dtype=torch.float32,
                                      device="cpu")
    for x, y in zip(jax.tree_util.tree_leaves(a.pipeline.params),
                    jax.tree_util.tree_leaves(b.pipeline.params)):
        assert torch.equal(x, y)
    assert a.timings.t_load_us > 0 and a.pipeline.n_loaded > 0
    jctx = jgwt.WhisperContext.from_file(path, compute_dtype=jnp.float32)
    audio = _audio(12.5)
    want = _view(jctx.full(jgwt.TranscribeParams(
        best_of=1, temperature_inc=0.0, **GATES_OPEN), audio))
    assert len(want) > 1
    assert _view(a.full(gt.TranscribeParams(**GATES_OPEN), audio)) == want
    assert a.full_n_segments() == len(want)
    assert a.full_get_segment_text(0) == want[0][0]
    assert (a.full_get_segment_t0(0), a.full_get_segment_t1(0)) == want[0][1:3]
    assert [a.full_get_token_data(0, j).id
            for j in range(a.full_n_tokens(0))] == want[0][3]
    assert a.full_get_token_text(0, 0) == jctx.full_get_token_text(0, 0)
    assert a.tokenize(" hello") == jctx.tokenize(" hello")


def test_stub_checkpoint_takes_test_fast_path(tmp_path):
    """A weightless stub (n_loaded == 0) runs the pipeline in test mode and
    emits no segment, as in the JAX package."""
    cfg = _cfg(gt)
    path = str(tmp_path / "stub.bin")
    tloader.write_stub_checkpoint(path, cfg, gt.audio.mel.mel_filterbank(80),
                                  gt.audio.tokenizer.synthetic_vocab(cfg))
    audio = np.zeros(16000 * 2, np.float32)
    audio[::160] = 0.5
    tp = dict(best_of=1, temperature_inc=0.0)
    jctx = jgwt.WhisperContext.from_file(path)
    ctx = gt.WhisperContext.from_file(path, device="cpu")
    assert ctx.pipeline.n_loaded == 0
    want = jctx.full(jgwt.TranscribeParams(**tp), audio)
    got = ctx.full(gt.TranscribeParams(**tp), audio)
    assert got == want == []
    assert ctx.timings.n_encode == jctx.timings.n_encode >= 1


def _hf_state_dict(tree, n_audio: int, n_text: int):
    """The JAX package's numpy tree in transformers' Whisper key layout."""
    sd = {}

    def put(name, a, t=False):
        a = np.array(a, np.float32)
        sd["model." + name] = torch.from_numpy(
            np.ascontiguousarray(a.T) if t else a)

    enc, dec = tree["encoder"], tree["decoder"]
    put("encoder.embed_positions.weight", enc["pos_embed"])
    for c in ("conv1", "conv2"):
        put(f"encoder.{c}.weight", enc[c]["w"].transpose(2, 1, 0))
        put(f"encoder.{c}.bias", enc[c]["b"])
    put("encoder.layer_norm.weight", enc["ln_post"]["g"])
    put("encoder.layer_norm.bias", enc["ln_post"]["b"])
    put("decoder.embed_positions.weight", dec["pos_embed"])
    put("decoder.embed_tokens.weight", dec["token_embed"])
    put("decoder.layer_norm.weight", dec["ln"]["g"])
    put("decoder.layer_norm.bias", dec["ln"]["b"])
    attn = {"wq": "q_proj.weight", "bq": "q_proj.bias", "wk": "k_proj.weight",
            "wv": "v_proj.weight", "bv": "v_proj.bias",
            "wo": "out_proj.weight", "bo": "out_proj.bias"}
    lns = {"attn_ln": "self_attn_layer_norm", "mlp_ln": "final_layer_norm",
           "cross_attn_ln": "encoder_attn_layer_norm"}
    for side, blocks, n in (("encoder", enc["blocks"], n_audio),
                            ("decoder", dec["blocks"], n_text)):
        for i in range(n):
            p = f"{side}.layers.{i}"
            for kind, hf in (("attn", "self_attn"),
                             ("cross_attn", "encoder_attn")):
                if kind not in blocks:
                    continue
                for k, name in attn.items():
                    put(f"{p}.{hf}.{name}", blocks[kind][k][i],
                        t=k.startswith("w"))
            for k, name in lns.items():
                if k in blocks:
                    put(f"{p}.{name}.weight", blocks[k]["g"][i])
                    put(f"{p}.{name}.bias", blocks[k]["b"][i])
            mlp = blocks["mlp"]
            put(f"{p}.fc1.weight", mlp["w0"][i], t=True)
            put(f"{p}.fc1.bias", mlp["b0"][i])
            put(f"{p}.fc2.weight", mlp["w1"][i], t=True)
            put(f"{p}.fc2.bias", mlp["b1"][i])
    return sd


def test_from_hf_matches_jax(pico_jax, tmp_path):
    """A local snapshot (config.json + pytorch_model.bin) loads to the JAX
    loader's tree, and ``from_hf`` builds a context on it."""
    cfg, jp = pico_jax
    tree = jax.tree_util.tree_map(np.asarray, jp)
    torch.save(_hf_state_dict(tree, cfg.n_audio_layer, cfg.n_text_layer),
               tmp_path / "pytorch_model.bin")
    (tmp_path / "config.json").write_text(json.dumps({
        "vocab_size": cfg.n_vocab, "max_source_positions": cfg.n_audio_ctx,
        "d_model": cfg.n_audio_state,
        "encoder_attention_heads": cfg.n_audio_head,
        "encoder_layers": cfg.n_audio_layer,
        "max_target_positions": cfg.n_text_ctx,
        "decoder_attention_heads": cfg.n_text_head,
        "decoder_layers": cfg.n_text_layer, "num_mel_bins": cfg.n_mels}))
    jcfg, jtree = jhf.load_hf_checkpoint(str(tmp_path),
                                         compute_dtype=jnp.float32)
    tcfg, ttree = thf.load_hf_checkpoint(str(tmp_path),
                                         compute_dtype=torch.float32,
                                         device="cpu")
    assert vars(tcfg) == vars(jcfg)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jtree))
    for (pw, w), (pg, g) in zip(jax.tree_util.tree_leaves_with_path(want),
                                jax.tree_util.tree_leaves_with_path(ttree)):
        assert pw == pg and torch.equal(w, g), pw
    ctx = gt.WhisperContext.from_hf(str(tmp_path), device="cpu")
    assert ctx.config.n_audio_state == 64
    assert ctx.pipeline.params["decoder"]["token_embed"].dtype == \
        torch.bfloat16


def test_file_constructors_default_to_cuda(tmp_path):
    """No device means the card; without one from_file, from_buffer and
    from_hf raise, never falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = _cfg(gt)
    path = str(tmp_path / "stub.bin")
    tloader.write_stub_checkpoint(path, cfg, gt.audio.mel.mel_filterbank(80),
                                  gt.audio.tokenizer.synthetic_vocab(cfg))
    with pytest.raises(RuntimeError, match="CUDA"):
        gt.WhisperContext.from_file(path)
    with pytest.raises(RuntimeError, match="CUDA"):
        gt.WhisperContext.from_buffer(open(path, "rb").read())
    with pytest.raises(RuntimeError, match="CUDA"):
        gt.WhisperContext.from_hf(str(tmp_path))
