"""Beam search in the port end to end on the CPU (every kernel's plain
version): the checked-in beam-5 golden window (tests/golden/, made with the
JAX package's init_params(nano, seed=3)) through both cache layouts, and
``WhisperContext.full`` segment parity with the JAX package through the
whole-clip path and the per-window path."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import godot_whisper_tpu as jgwt
import godot_whisper_tpu_torch as gt
from godot_whisper_tpu_torch.decode.filters import build_filter_context
from godot_whisper_tpu_torch.decode.window import WindowDecoder
from godot_whisper_tpu_torch.models.model import cross_kv, encoder_forward

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
GATES_OPEN = dict(entropy_thold=-1e9, logprob_thold=-1e9)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Single-threaded torch: these tests share the CPU with other workers,
    and oversubscribed intra-op threads slow a decode loop's many small ops
    by two orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small_cfg(pkg, name):
    """nano: the goldens' config; pico: the JAX suite's 1 + 1 layer, width
    64 config (tests/test_filter_sample.py), with 3 text layers here and in
    nano-3, since 2 mark a model distilled and force no_timestamps."""
    dims = {"nano": (2, 2, 128, 4), "nano-3": (2, 3, 128, 4),
            "pico": (1, 1, 64, 2)}[name]
    return pkg.get_config("tiny.en").replace(
        n_audio_layer=dims[0], n_text_layer=dims[1], n_audio_state=dims[2],
        n_audio_head=dims[3], n_text_state=dims[2], n_text_head=dims[3],
        name=name)


def _audio(seconds, five_s_golden=False):
    t = np.arange(int(seconds * 16000)) / 16000.0
    if five_s_golden:
        x = (0.3 * np.sin(2 * np.pi * 220.0 * t)
             + 0.2 * np.sin(2 * np.pi * 447.0 * t)
             * (0.5 + 0.5 * np.sin(2 * np.pi * 1.7 * t)))
    else:
        x = (0.3 * np.sin(2 * np.pi * (220.0 + 60 * np.sin(
            2 * np.pi * 0.07 * t)) * t)
            + 0.2 * np.sin(2 * np.pi * 447.0 * t)
            * (0.5 + 0.5 * np.sin(2 * np.pi * 1.7 * t)))
    return x.astype(np.float32)


@pytest.mark.parametrize("merged", [False, True],
                         ids=["split_cache", "merged_cache"])
def test_window_beam5_golden(merged, monkeypatch):
    """WindowDecoder.decode(strategy="beam", beam_size=5) on nano (seed 3,
    f32) reproduces nano_decode.json["beam5"] exactly: through the split
    cache (nano's 4 heads x 5 beams <= 128: K7's path), and with the merged
    cache forced (the wide configurations' path: K8 reorders it)."""
    if merged:
        from godot_whisper_tpu_torch.decode import window
        monkeypatch.setattr(window, "use_split_cache", lambda st: False)
    cfg = _small_cfg(gt, "nano")
    ctx = gt.WhisperContext.from_params(
        cfg, gt.init_params(cfg, seed=3, compute_dtype=torch.float32,
                            device="cpu"), device="cpu")
    pipe = ctx.pipeline
    mel, _ = pipe.mel.device(_audio(5.0, five_s_golden=True))
    xkv = cross_kv(pipe.params, cfg,
                   encoder_forward(pipe.params, cfg, mel[:, :3000].T[None]))
    wd = WindowDecoder(cfg, build_filter_context(cfg, pipe.tokenizer,
                                                 device="cpu"))
    res = wd.decode(pipe.params, xkv, np.asarray([cfg.token_sot], np.int32),
                    n_decoders=5, temperature=0.0, strategy="beam",
                    beam_size=5, seek=0, seek_end=500, suppress_blank=True,
                    no_timestamps=False, single_segment=False, max_tokens=0,
                    test_mode=False)
    n = min(res.n_steps, 48)
    got = {"n_steps": res.n_steps,
           "tokens": [[int(x) for x in r[:n]] for r in res.tokens],
           "tid": [[int(x) for x in r[:n]] for r in res.tok_tid],
           "result_len": [int(x) for x in res.result_len],
           "seek_delta": [int(x) for x in res.seek_delta],
           "completed": [bool(x) for x in res.completed],
           "failed": [bool(x) for x in res.failed],
           "sum_logprobs": [round(float(x), 3)
                            for x in res.sum_logprobs_all]}
    with open(os.path.join(GOLDEN, "nano_decode.json")) as f:
        assert got == json.load(f)["beam5"]


def _contexts(name):
    from godot_whisper_tpu.audio.mel import mel_filterbank as jmf
    from godot_whisper_tpu.audio.tokenizer import Tokenizer as JT
    from godot_whisper_tpu.audio.tokenizer import synthetic_vocab as jsv
    from godot_whisper_tpu.decode.loop import WhisperPipeline as JP
    from godot_whisper_tpu.models.params import init_params as jip
    jcfg, cfg = _small_cfg(jgwt, name), _small_cfg(gt, name)
    jctx = jgwt.WhisperContext(JP(jcfg, jip(jcfg, seed=3,
                                            compute_dtype=jnp.float32),
                                  JT(jcfg, jsv(jcfg)), jmf(80), n_loaded=1))
    ctx = gt.WhisperContext.from_params(
        cfg, gt.init_params(cfg, seed=3, compute_dtype=torch.float32,
                            device="cpu"), device="cpu")
    return jctx, ctx


def _view(segs):
    return [(s.text, s.t0, s.t1, [t.id for t in s.tokens]) for s in segs]


@pytest.mark.parametrize("path,kw", [
    ("clip", dict(beam_size=3, best_of=3, temperature_inc=0.0)),
    # rungs of 3 beams then 2 samplers: the per-window path in both
    # packages; the gates are open, so the beam rung settles every window
    ("windows", dict(beam_size=3, best_of=2)),
])
def test_full_beam_segments_match_jax(path, kw):
    """Gates open, 34 s (two windows): ``full`` with beam search gives the
    JAX package's segments (text, t0, t1, token ids) on the same weights."""
    jctx, ctx = _contexts("pico")
    audio = _audio(34.0)
    want = jctx.full(jgwt.TranscribeParams(
        strategy=jgwt.SamplingStrategy.BEAM_SEARCH, **kw, **GATES_OPEN),
        audio)
    got = ctx.full(gt.TranscribeParams(
        strategy=gt.SamplingStrategy.BEAM_SEARCH, **kw, **GATES_OPEN), audio)
    assert len(want) > 0
    assert _view(got) == _view(want)
    # one encode per window; the per-window path encodes per call
    assert ctx.timings.n_encode == 2
    assert (ctx.pipeline._window_decoders != {}) == (path == "windows")


def test_per_window_callbacks_match_the_clip_path():
    """Progress / encoder-begin / abort callbacks take the per-window path;
    with them the default greedy ladder gives the whole-clip path's
    segments, and each callback fires once per window."""
    _, ctx = _contexts("nano-3")
    audio = _audio(34.0)
    want = _view(ctx.full(gt.TranscribeParams(**GATES_OPEN), audio))
    calls = {"progress": [], "begin": 0, "abort": 0}

    def begin(_):
        calls["begin"] += 1
        return True

    def abort(_):
        calls["abort"] += 1
        return False

    got = ctx.full(gt.TranscribeParams(
        progress_callback=lambda _, p: calls["progress"].append(p),
        encoder_begin_callback=begin, abort_callback=abort, **GATES_OPEN),
        audio)
    assert len(want) > 0 and _view(got) == want
    assert calls["begin"] == calls["abort"] == 2
    assert calls["progress"][0] == 0 and len(calls["progress"]) == 3
