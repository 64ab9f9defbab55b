"""The port's host-stepped decode (``decode/host_loop.py``) against the JAX
package's on the CPU: grammar-constrained decoding and the logit-filter
callback through ``WhisperContext.full``, ``BatchTranscriber``'s fallback
to ``full`` for them, and the int8 cross-KV that neither package serves on
this path.

Weights: the pico config of tests/test_grammar.py (1 + 1 layers, width 64,
f32), JAX ``init_params(seed=0)`` carried across with ``params_from_jax``.
Both packages draw the t > 0 rung's tokens from numpy's
``default_rng(seed + rung)`` on the host, so tokens must be equal at t = 0
and at t > 0; logprobs within 1e-5 (f32 filter stacks whose sums run in
another order).  The grammar walks the whole 51864-token vocabulary in
Python at every step (about 0.6 s here), so grammar runs stop at
``max_tokens``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import godot_whisper_tpu as jgwt
import godot_whisper_tpu_torch as gt
from godot_whisper_tpu.audio.mel import mel_filterbank as jax_mel_filterbank
from godot_whisper_tpu.audio.tokenizer import Tokenizer as JT
from godot_whisper_tpu.audio.tokenizer import synthetic_vocab as jsv
from godot_whisper_tpu.decode.loop import WhisperPipeline as JP
from godot_whisper_tpu.models.params import init_params as jax_init_params
from godot_whisper_tpu_torch.decode.host_loop import HostWindowDecoder
from godot_whisper_tpu_torch.models.params import params_from_jax
from godot_whisper_tpu_torch.ops import filter_sample as FS
from godot_whisper_tpu_torch.parallel.batch import BatchTranscriber

GRAMMAR = "root ::= [a-z ]+\n"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Single-threaded torch: the CPU is shared with other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pico(pkg):
    return pkg.get_config("tiny.en").replace(
        n_audio_layer=1, n_text_layer=1, n_audio_state=64, n_audio_head=2,
        n_text_state=64, n_text_head=2, name="pico")


@pytest.fixture(scope="module")
def contexts():
    jcfg = _pico(jgwt)
    jparams = jax_init_params(jcfg, seed=0, compute_dtype=jnp.float32)
    jctx = jgwt.WhisperContext(JP(jcfg, jparams, JT(jcfg, jsv(jcfg)),
                                  jax_mel_filterbank(80), n_loaded=1))
    ctx = gt.WhisperContext.from_params(
        _pico(gt), params_from_jax(jax.device_get(jparams)), device="cpu")
    return jctx, ctx


def _audio(seconds=2.0, seed=0):
    rng = np.random.default_rng(seed)
    return (0.2 * rng.standard_normal(int(seconds * 16000))).astype(
        np.float32)


def _tokens(segs):
    return [[t.id for t in s.tokens] for s in segs]


def _plogs(segs):
    return np.asarray([t.plog for s in segs for t in s.tokens], np.float64)


def _identity(tokens, logits):
    return None


def _ban(tid):
    def cb(tokens, logits):
        logits[tid] = -np.inf
    return cb


def _first_token(ctx, temperature):
    """The first token the identity callback run emits (the ban target)."""
    segs = ctx.full(gt.TranscribeParams(
        best_of=1, temperature=temperature, temperature_inc=0.0,
        logits_filter_callback=_identity), _audio())
    return segs[0].tokens[0].id


def _ban_specials(tokens, logits):
    """Mask what the grammar cannot judge: the special ids between
    end-of-text and the first timestamp (tokens that start with "[_" bypass
    it, and random weights favour them) and the synthetic vocabulary's NUL
    byte token (code point 0 ends a string in the grammar engine, as in
    the reference's C strings, so it is never rejected)."""
    logits[0] = -np.inf
    logits[50256:50363] = -np.inf


@pytest.mark.parametrize("temperature", [0.0, 0.4], ids=["t0", "t0.4"])
@pytest.mark.parametrize("mode", ["grammar", "grammar+callback", "identity",
                                  "ban"])
def test_host_decode_matches_jax(contexts, mode, temperature):
    """Segments of the two packages' host-stepped decoders: tokens equal,
    logprobs within 1e-5.  The grammar alone lets the specials through
    (print_special shows them); with the specials masked by the callback
    the grammar keeps the text to [a-z ]."""
    jctx, ctx = contexts
    kw = dict(best_of=1, temperature=temperature, temperature_inc=0.0)
    if mode.startswith("grammar"):
        kw.update(grammar_rules=GRAMMAR, no_timestamps=True, max_tokens=2)
    if mode == "grammar":
        kw.update(print_special=True)
    elif mode == "grammar+callback":
        kw.update(logits_filter_callback=_ban_specials)
    elif mode == "identity":
        kw.update(logits_filter_callback=_identity)
    else:
        banned = _first_token(ctx, temperature)
        kw.update(logits_filter_callback=_ban(banned))
    audio = _audio()
    want = jctx.full(jgwt.TranscribeParams(**kw), audio)
    got = ctx.full(gt.TranscribeParams(**kw), audio)
    assert want and _tokens(got) == _tokens(want)
    assert np.abs(_plogs(got) - _plogs(want)).max() < 1e-5
    assert [s.text for s in got] == [s.text for s in want]
    if mode == "grammar+callback":
        assert all(ch.islower() or ch == " " for s in got for ch in s.text)
    if mode == "ban":
        assert banned not in sum(_tokens(got), [])


def test_host_decode_runs_the_plain_filters_one_row(contexts):
    """The host path never runs the fused sampler, and its stage clocks
    advance."""
    _, ctx = contexts
    before = FS.fused_filter_sample.launches
    ctx.full(gt.TranscribeParams(best_of=1, temperature_inc=0.0,
                                 logits_filter_callback=_identity), _audio())
    assert FS.fused_filter_sample.launches == before
    hd = next(d for d in ctx.pipeline._window_decoders.values()
              if isinstance(d, HostWindowDecoder))
    assert hd.n_tokens > 0 and hd.n_attempts > 0
    assert set(hd.stage_s) >= {"prompt", "step", "filters_pull", "callback",
                               "sample"}


def test_identity_callback_equals_the_clip_path(contexts):
    """An identity callback changes the path (host-stepped, one row), not
    the tokens: t = 0, gates open."""
    _, ctx = contexts
    kw = dict(best_of=1, temperature_inc=0.0, entropy_thold=-1e9,
              logprob_thold=-1e9)
    audio = _audio(seconds=3.0, seed=1)
    plain = ctx.full(gt.TranscribeParams(**kw), audio)
    hooked = ctx.full(gt.TranscribeParams(logits_filter_callback=_identity,
                                          **kw), audio)
    assert plain and _tokens(hooked) == _tokens(plain)


def test_batch_with_grammar_equals_per_clip_full(contexts):
    _, ctx = contexts
    p = gt.TranscribeParams(best_of=1, temperature_inc=0.0,
                            grammar_rules=GRAMMAR, no_timestamps=True,
                            max_tokens=1, logits_filter_callback=_ban_specials)
    clips = [_audio(2.0, seed=2), _audio(2.5, seed=3)]
    batched = BatchTranscriber(ctx).transcribe(clips, p)
    single = []
    for clip in clips:
        ctx.pipeline._prompt_past = []
        single.append(ctx.full(p, clip))
    assert any(batched)
    assert [_tokens(s) for s in batched] == [_tokens(s) for s in single]


def test_int8_cross_kv_fails_on_the_host_path_in_both(contexts):
    jctx, ctx = contexts
    kw = dict(best_of=1, temperature_inc=0.0, cross_kv_int8=True,
              logits_filter_callback=_identity)
    with pytest.raises(AttributeError):
        jctx.full(jgwt.TranscribeParams(**kw), _audio())
    with pytest.raises(NotImplementedError, match="int8 cross-KV"):
        ctx.full(gt.TranscribeParams(**kw), _audio())
