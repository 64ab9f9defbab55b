"""Token-level timestamps, segment wrapping and language detection in the
port against the JAX package on the CPU (nano-3 f32: the goldens' nano with
3 text layers, since 2 mark a model distilled and force no_timestamps)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import godot_whisper_tpu as jgwt
import godot_whisper_tpu_torch as gt
from godot_whisper_tpu.audio.mel import mel_filterbank as jmf
from godot_whisper_tpu.audio.tokenizer import Tokenizer as JT
from godot_whisper_tpu.audio.tokenizer import synthetic_vocab as jsv
from godot_whisper_tpu.decode.loop import WhisperPipeline as JP
from godot_whisper_tpu.models.params import init_params as jax_init_params

# gates open and one decoder row per stream in both packages: every window
# settles on the t = 0 rung (the port's 5-row ladder is held to JAX in
# tests/test_torch_decode.py)
GREEDY = dict(entropy_thold=-1e9, logprob_thold=-1e9, best_of=1,
              temperature_inc=0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Single-threaded torch: the CPU is shared with other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(pkg, base):
    return pkg.get_config(base).replace(
        n_audio_layer=2, n_text_layer=3, n_audio_state=128, n_audio_head=4,
        n_text_state=128, n_text_head=4, name="nano-3")


def _contexts(base):
    jcfg, cfg = _cfg(jgwt, base), _cfg(gt, base)
    jctx = jgwt.WhisperContext(JP(jcfg, jax_init_params(
        jcfg, seed=3, compute_dtype=jnp.float32), JT(jcfg, jsv(jcfg)),
        jmf(80), n_loaded=1))
    ctx = gt.WhisperContext.from_params(
        cfg, gt.init_params(cfg, seed=3, compute_dtype=torch.float32,
                            device="cpu"), device="cpu")
    return jctx, ctx


@pytest.fixture(scope="module")
def english():
    return _contexts("tiny.en")


@pytest.fixture(scope="module")
def multilingual():
    return _contexts("tiny")


def _audio(seconds):
    t = np.arange(int(seconds * 16000)) / 16000.0
    return (0.3 * np.sin(2 * np.pi * (220.0 + 60 * np.sin(
        2 * np.pi * 0.07 * t)) * t)
        + 0.2 * np.sin(2 * np.pi * 447.0 * t)
        * (0.5 + 0.5 * np.sin(2 * np.pi * 1.7 * t))).astype(np.float32)


def _view(segs):
    return [(s.text, s.t0, s.t1, s.speaker_turn_next,
             [(t.id, t.t0, t.t1, round(t.vlen, 6)) for t in s.tokens])
            for s in segs]


@pytest.mark.parametrize("max_len,split_on_word", [(0, False), (16, True)])
def test_token_timestamps_and_wrap_match_jax(english, max_len,
                                             split_on_word):
    """token_timestamps fills every token's t0/t1 (the energy heuristic over
    the kept samples); max_len re-splits each segment: the same segments,
    tokens and token times as the JAX package, and new_segment_callback
    told of the same counts."""
    jctx, ctx = english
    audio = _audio(20.0)
    kw = dict(token_timestamps=True, max_len=max_len,
              split_on_word=split_on_word, **GREEDY)
    jn, tn = [], []
    want = jctx.full(jgwt.TranscribeParams(
        new_segment_callback=lambda _, n: jn.append(n), **kw), audio)
    got = ctx.full(gt.TranscribeParams(
        new_segment_callback=lambda _, n: tn.append(n), **kw), audio)
    assert len(want) > 1
    assert all(t.t0 >= 0 and t.t1 >= t.t0 for s in got for t in s.tokens)
    assert _view(got) == _view(want)
    assert tn == jn and sum(tn) == len(got)


@pytest.mark.parametrize("split_on_word", [False, True])
def test_timestamps_and_wrap_of_a_long_segment_match_jax(english,
                                                         split_on_word):
    """A segment of many one-byte text tokens (random weights emit one text
    token per segment, which never wraps): token times from the energy of
    real samples, then wrapping at 7 bytes, through each package's
    ``decode/timestamps.py`` on its own Segment / TokenData."""
    import types

    from godot_whisper_tpu.decode import loop as jloop
    from godot_whisper_tpu.decode import timestamps as jts
    from godot_whisper_tpu_torch.decode import loop as tloop
    from godot_whisper_tpu_torch.decode import timestamps as tts

    jctx, ctx = english
    cfg = ctx.config
    text = b" the quick brown fox jumps"
    rng = np.random.default_rng(5)
    ids = list(text) + [cfg.token_beg + 150]
    tids = [cfg.token_beg + int(x) for x in np.sort(rng.integers(
        0, 150, len(ids)))]
    pts = rng.uniform(0.0, 0.05, len(ids))
    audio = _audio(5.0) * (np.arange(80000) % 16000 < 9000)
    views = []
    for pkg_ctx, loop, ts in ((jctx, jloop, jts), (ctx, tloop, tts)):
        toks = [loop.TokenData(id=i, tid=t, p=0.5, plog=-0.7, pt=float(p),
                               ptsum=float(p) + 0.01)
                for i, t, p in zip(ids, tids, pts)]
        pipe = types.SimpleNamespace(
            config=pkg_ctx.config, tokenizer=pkg_ctx.tokenizer,
            segments=[loop.Segment(t0=12, t1=300, text=text.decode(),
                                   tokens=toks)],
            _energy=ts.signal_energy(audio, 32),
            _ts_state={"t_beg": 0, "t_last": 0, "tid_last": 0})
        ts.compute_token_level_timestamps(pipe, 0, 0.01, 0.01)
        n = ts.wrap_segment(pipe, 7, split_on_word)
        views.append((n, _view(pipe.segments), dict(pipe._ts_state)))
    assert views[1] == views[0]
    assert views[1][0] > 2


def test_detect_language_matches_jax(multilingual):
    """lang_auto_detect: encode, one [sot] decode, softmax over the language
    tokens: the same id and probabilities within 1e-5."""
    jctx, ctx = multilingual
    audio = _audio(5.0)
    jctx.pipeline.set_audio(audio)
    ctx.pipeline.set_audio(audio)
    jid, jprobs = jctx.lang_auto_detect()
    tid, tprobs = ctx.lang_auto_detect()
    assert tid == jid
    assert tprobs.shape == jprobs.shape
    np.testing.assert_allclose(tprobs, jprobs, atol=1e-5, rtol=0)


def test_language_auto_matches_jax(multilingual):
    """language="auto": the detected language prefixes the prompt; the same
    segments and the same full_lang_id as the JAX package."""
    jctx, ctx = multilingual
    audio = _audio(20.0)
    want = jctx.full(jgwt.TranscribeParams(language="auto", **GREEDY), audio)
    got = ctx.full(gt.TranscribeParams(language="auto", **GREEDY), audio)
    assert len(want) > 0
    assert _view(got) == _view(want)
    assert ctx.full_lang_id() == jctx.full_lang_id() is not None


def test_detect_language_only_returns_no_segments(multilingual):
    """detect_language=True stops after the detection: [] and the same
    full_lang_id as the JAX package."""
    jctx, ctx = multilingual
    audio = _audio(5.0)
    want = jctx.full(jgwt.TranscribeParams(detect_language=True), audio)
    got = ctx.full(gt.TranscribeParams(detect_language=True), audio)
    assert got == want == []
    assert ctx.full_lang_id() == jctx.full_lang_id() is not None
    assert gt.lang_str(ctx.full_lang_id()) is not None
