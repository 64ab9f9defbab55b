"""The port's slice end to end on the nano config: the checked-in golden
transcripts (tests/golden/, made with the JAX package's
init_params(nano, seed=3)) and segment parity with the JAX WhisperContext.
The CPU runs every kernel's plain version; tests/test_torch_cuda.py runs
the goldens through the kernels on the card."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import godot_whisper_tpu as jgwt
import godot_whisper_tpu_torch as gt
from godot_whisper_tpu_torch.decode.filters import build_filter_context
from godot_whisper_tpu_torch.decode.language import lang_id
from godot_whisper_tpu_torch.decode.window import WindowDecoder
from godot_whisper_tpu_torch.models.model import cross_kv, encoder_forward

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch single-threaded here: these tests share the CPU with other
    test workers, and oversubscribed intra-op threads slow the many small
    ops of a decode loop by two orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nano_cfg(base):
    return gt.get_config(base).replace(
        n_audio_layer=2, n_text_layer=2, n_audio_state=128, n_audio_head=4,
        n_text_state=128, n_text_head=4, name="nano")


def _ctx(base="tiny.en", device="cpu"):
    cfg = _nano_cfg(base)
    params = gt.init_params(cfg, seed=3, compute_dtype=torch.float32,
                            device="cpu")
    return gt.WhisperContext.from_params(cfg, params, device=device)


def _frozen_audio():
    t = np.arange(5 * 16000) / 16000.0
    x = (0.3 * np.sin(2 * np.pi * 220.0 * t)
         + 0.2 * np.sin(2 * np.pi * 447.0 * t)
         * (0.5 + 0.5 * np.sin(2 * np.pi * 1.7 * t)))
    return x.astype(np.float32)


def _multi_audio(seconds):
    t = np.arange(int(seconds * 16000)) / 16000.0
    x = (0.3 * np.sin(2 * np.pi * (220.0 + 60 * np.sin(
        2 * np.pi * 0.07 * t)) * t)
        + 0.2 * np.sin(2 * np.pi * 447.0 * t)
        * (0.5 + 0.5 * np.sin(2 * np.pi * 1.7 * t)))
    return x.astype(np.float32)


def _greedy_raw(ctx):
    pipe, cfg = ctx.pipeline, ctx.config
    mel, _ = pipe.mel.device(_frozen_audio())
    enc = encoder_forward(pipe.params, cfg, mel[:, :3000].T[None])
    xkv = cross_kv(pipe.params, cfg, enc)
    wd = WindowDecoder(cfg, build_filter_context(cfg, pipe.tokenizer,
                                                 device=pipe.device))
    res = wd.decode(pipe.params, xkv, np.asarray([cfg.token_sot], np.int32),
                    n_decoders=1, temperature=0.0, seek=0, seek_end=500,
                    suppress_blank=True, no_timestamps=False,
                    single_segment=False, max_tokens=0, test_mode=False)
    n = min(res.n_steps, 48)
    return {"n_steps": res.n_steps,
            "tokens": [[int(x) for x in r[:n]] for r in res.tokens],
            "tid": [[int(x) for x in r[:n]] for r in res.tok_tid],
            "result_len": [int(x) for x in res.result_len],
            "seek_delta": [int(x) for x in res.seek_delta],
            "completed": [bool(x) for x in res.completed],
            "failed": [bool(x) for x in res.failed],
            "sum_logprobs": [round(float(x), 3)
                             for x in res.sum_logprobs_all]}


def _clip_scenario(ctx, audio, tparams, prompt_init, temps):
    pipe = ctx.pipeline
    pipe.set_audio(audio)
    cd = pipe.clip_decoder(tparams, temps, prompt_init, False)
    outs = cd.run(pipe.params, pipe._mel_device[None], [pipe._mel_n_len],
                  [0], [pipe._n_len_org], past_init=[[]])
    W = int(outs.w[0])
    return {"w": W, "done": bool(outs.done[0]),
            "past_cnt": int(outs.past_cnt[0]),
            "windows": [{
                "seek": int(outs.seek[0, k]), "delta": int(outs.delta[0, k]),
                "rl": int(outs.rl[0, k]),
                "emitted": bool(outs.emitted[0, k]),
                "temp": round(float(outs.temp[0, k]), 3),
                "tokens": [int(x) for x in outs.tokens[
                    0, k, :min(int(outs.rl[0, k]), 24)]],
            } for k in range(W)]}


P_OPEN = dict(entropy_thold=-1e9, logprob_thold=-1e9, best_of=1,
              temperature_inc=0.0)


def _want(name):
    with open(os.path.join(GOLDEN, name)) as f:
        return json.load(f)


def test_window_greedy_golden():
    assert _greedy_raw(_ctx()) == _want("nano_decode.json")["greedy"]


@pytest.mark.parametrize("scenario", ["multiwindow", "translate"])
def test_clip_scenario_golden(scenario):
    if scenario == "multiwindow":
        ctx = _ctx()
        got = _clip_scenario(ctx, _multi_audio(34.0),
                             gt.TranscribeParams(**P_OPEN),
                             [ctx.config.token_sot], [0.0])
    else:
        ctx = _ctx("tiny")
        c = ctx.config
        got = _clip_scenario(ctx, _multi_audio(5.0),
                             gt.TranscribeParams(**P_OPEN),
                             [c.token_sot, c.token_lang(lang_id("de")),
                              c.token_translate], [0.0])
    assert got == _want("nano_clip_scenarios.json")[scenario]


def test_clip_ladder_rejects_rung0_and_settles_on_sampling_rung():
    """The "ladder" golden settles through jax.random, which the port's
    sampler does not reproduce; its rung logic must hold: the entropy gate
    rejects the t = 0 rung and the window settles on a t > 0 rung."""
    ctx = _ctx()
    tp = gt.TranscribeParams(temperature=0.0, best_of=1,
                             temperature_inc=0.2)
    got = _clip_scenario(ctx, _multi_audio(5.0), tp,
                         [ctx.config.token_sot], [0.0, 0.2, 0.4])
    want = _want("nano_clip_scenarios.json")["ladder"]
    assert got["w"] == want["w"] == 1 and got["done"]
    win = got["windows"][0]
    assert win["emitted"] and win["temp"] in (0.2, 0.4)
    # rung 0 alone fails the same gates
    got0 = _clip_scenario(ctx, _multi_audio(5.0), tp,
                          [ctx.config.token_sot], [0.0, 0.2])
    assert got0["windows"][0]["temp"] != 0.0 or not got0["windows"][0][
        "emitted"]


def test_full_segments_match_jax():
    """Gates open: WhisperContext.full segments (text, t0, t1, token ids)
    equal the JAX package's WhisperContext on the same weights.  Three text
    layers, because two mark a distilled model, which forces no_timestamps.
    The port runs the default ladder (5 decoder rows per stream, identical
    argmax rows on the t = 0 rung, which settles with the gates open); the
    JAX side runs its 1-row ladder, which must give the same segments and
    compiles far faster on the CPU."""
    from godot_whisper_tpu.audio.mel import mel_filterbank as jmf
    from godot_whisper_tpu.audio.tokenizer import Tokenizer as JT
    from godot_whisper_tpu.audio.tokenizer import synthetic_vocab as jsv
    from godot_whisper_tpu.decode.loop import WhisperPipeline as JP
    from godot_whisper_tpu.models.params import init_params as jip

    cfg = _nano_cfg("tiny.en").replace(n_text_layer=3)
    jctx = jgwt.WhisperContext(JP(cfg, jip(cfg, seed=3,
                                           compute_dtype=jnp.float32),
                                  JT(cfg, jsv(cfg)), jmf(80), n_loaded=1))
    ctx = gt.WhisperContext.from_params(
        cfg, gt.init_params(cfg, seed=3, compute_dtype=torch.float32,
                            device="cpu"),
        device="cpu")
    audio = _multi_audio(34.0)
    gates = dict(entropy_thold=-1e9, logprob_thold=-1e9)
    want = jctx.full(jgwt.TranscribeParams(best_of=1, temperature_inc=0.0,
                                           **gates), audio)
    got = ctx.full(gt.TranscribeParams(**gates), audio)

    def view(segs):
        return [(s.text, s.t0, s.t1, [t.id for t in s.tokens]) for s in segs]

    assert len(want) > 0
    assert view(got) == view(want)
    assert ctx.timings.n_encode == 2


def test_synthetic_defaults_to_cuda():
    """No device means the card; without one it raises, never falls back
    to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        gt.WhisperContext.synthetic("tiny.en")
    with pytest.raises(RuntimeError, match="CUDA"):
        gt.init_params(gt.get_config("tiny.en"))


def test_pipeline_helpers_need_a_device():
    """The pipeline and the helpers it builds have no CPU default."""
    from godot_whisper_tpu_torch.audio.mel import MelFrontend
    from godot_whisper_tpu_torch.models.model import init_kv_cache
    cfg = _nano_cfg("tiny.en")
    with pytest.raises(TypeError, match="device"):
        gt.WhisperPipeline(cfg, {}, None, np.zeros((80, 201), np.float32))
    with pytest.raises(TypeError, match="device"):
        MelFrontend(np.zeros((80, 201), np.float32))
    with pytest.raises(TypeError, match="device"):
        build_filter_context(cfg, None)
    with pytest.raises(TypeError, match="device"):
        init_kv_cache(cfg, 1, 32)
