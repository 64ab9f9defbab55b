"""Batched serving in the port against the JAX package on the CPU:
BatchTranscriber, full_parallel, the batched mel, the WhisperContext stage
API (pcm_to_mel, set_mel, encode, decode) and the compute_dtype=None rule.

Weights: the nano-3 config (nano with 3 text layers: 2 mark a model
distilled, which forces no_timestamps) at f32 from init_params(seed=3),
the same bits in both packages.  Gates open and one decoder row per stream
(GREEDY): every window settles on the t = 0 rung, where the two packages
must agree token for token and timestamp for timestamp; token
probabilities within 1e-3, since the JAX clip loop drains them through
float16."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import godot_whisper_tpu as jgwt
import godot_whisper_tpu_torch as gt
from godot_whisper_tpu.audio import mel as jax_mel
from godot_whisper_tpu.audio.tokenizer import Tokenizer as JT
from godot_whisper_tpu.audio.tokenizer import synthetic_vocab as jsv
from godot_whisper_tpu.decode.loop import WhisperPipeline as JP
from godot_whisper_tpu.models import loader_ggml
from godot_whisper_tpu.models.export_ggml import export_checkpoint
from godot_whisper_tpu.models.params import init_params as jax_init_params
from godot_whisper_tpu.parallel.batch import BatchTranscriber as JaxBatch
from godot_whisper_tpu_torch.audio import mel as port_mel
from godot_whisper_tpu_torch.parallel.batch import BatchTranscriber

GREEDY = dict(entropy_thold=-1e9, logprob_thold=-1e9, best_of=1,
              temperature_inc=0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Single-threaded torch: the CPU is shared with other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(pkg):
    return pkg.get_config("tiny.en").replace(
        n_audio_layer=2, n_text_layer=3, n_audio_state=128, n_audio_head=4,
        n_text_state=128, n_text_head=4, name="nano-3")


@pytest.fixture(scope="module")
def contexts():
    jcfg, cfg = _cfg(jgwt), _cfg(gt)
    jctx = jgwt.WhisperContext(JP(jcfg, jax_init_params(
        jcfg, seed=3, compute_dtype=jnp.float32), JT(jcfg, jsv(jcfg)),
        jax_mel.mel_filterbank(80), n_loaded=1))
    ctx = gt.WhisperContext.from_params(
        cfg, gt.init_params(cfg, seed=3, compute_dtype=torch.float32,
                            device="cpu"), device="cpu")
    return jctx, ctx


def _clip(seconds, f0=220.0):
    t = np.arange(int(seconds * 16000)) / 16000.0
    return (0.3 * np.sin(2 * np.pi * (f0 + 60 * np.sin(
        2 * np.pi * 0.07 * t)) * t)
        + 0.2 * np.sin(2 * np.pi * 447.0 * t)
        * (0.5 + 0.5 * np.sin(2 * np.pi * 1.7 * t))).astype(np.float32)


def _view(segs):
    return [(s.text, s.t0, s.t1, s.speaker_turn_next,
             [(t.id, t.tid, t.t0, t.t1) for t in s.tokens]) for s in segs]


def _probs(segs):
    return np.asarray([t.p for s in segs for t in s.tokens], np.float64)


def _same(got, want):
    assert _view(got) == _view(want)
    np.testing.assert_allclose(_probs(got), _probs(want), atol=1e-3, rtol=0)


def _single(ctx, clip, **kw):
    ctx.pipeline._prompt_past = []
    return list(ctx.full(gt.TranscribeParams(no_context=True, **kw), clip))


@pytest.mark.parametrize("token_timestamps", [False, True])
def test_batch_ragged_streams_match_jax_and_single(contexts,
                                                   token_timestamps):
    """Three ragged streams (2.0, 3.0 and 2.5 s): the same segments, token
    ids and timestamps as the JAX BatchTranscriber, and each stream the
    same as the port's own single-stream full()."""
    jctx, ctx = contexts
    clips = [_clip(2.0, 220.0), _clip(3.0, 300.0), _clip(2.5, 180.0)]
    kw = dict(token_timestamps=token_timestamps, **GREEDY)
    want = JaxBatch(jctx).transcribe(clips, jgwt.TranscribeParams(**kw))
    got = BatchTranscriber(ctx).transcribe(clips, gt.TranscribeParams(**kw))
    assert len(got) == 3 and sum(len(s) for s in got) >= 3
    for g, w, clip in zip(got, want, clips):
        _same(g, w)
        _same(g, _single(ctx, clip, **kw))


def test_batch_streams_of_different_window_counts(contexts):
    """Streams that take 2, 1 and 1 windows (40, 2.5 and 23 s; longer
    than the other tests' clips, as a second window needs a seek past the
    first 30 s): the finished streams ride along in the second wave's
    batched encode, the long stream keeps its own seek and prompt_past
    (its first window hits the 220-token cap), and the outputs pad the
    short streams' windows.  The JAX BatchTranscriber's segments, and each
    stream's own single-stream full()."""
    jctx, ctx = contexts
    clips = [_clip(40.0, 300.0), _clip(2.5, 220.0), _clip(23.0, 180.0)]
    want = JaxBatch(jctx).transcribe(clips, jgwt.TranscribeParams(**GREEDY))
    bt = BatchTranscriber(ctx)
    windows = []
    emit = bt._emit

    def spy(outs, *args):
        windows.append(outs.w.tolist())
        return emit(outs, *args)

    bt._emit = spy
    got = bt.transcribe(clips, gt.TranscribeParams(**GREEDY))
    assert windows == [[2, 1, 1]]
    for g, w, clip in zip(got, want, clips):
        _same(g, w)
        _same(g, _single(ctx, clip, **GREEDY))


def test_batch_short_clip_skipped(contexts):
    """A clip under 1 s gives no segments; the stream beside it is
    unchanged."""
    _, ctx = contexts
    clip = _clip(2.0)
    res = BatchTranscriber(ctx).transcribe(
        [np.zeros(4000, np.float32), clip], gt.TranscribeParams(**GREEDY))
    assert res[0] == []
    _same(res[1], _single(ctx, clip, **GREEDY))


def test_batch_timings_count_waves(contexts):
    """One encode and the wave's steps per wave, not per stream."""
    _, ctx = contexts
    ctx.reset_timings()
    bt = BatchTranscriber(ctx)
    res = bt.transcribe([_clip(2.0), _clip(2.2, 260.0)],
                        gt.TranscribeParams(**GREEDY))
    tm = ctx.timings
    assert tm.n_encode == 1 and tm.n_decode > 0 and tm.t_decode_us > 0
    assert all(res)


def test_batch_ineligible_falls_back_to_full(contexts):
    """A progress callback makes the batch sequential full() calls."""
    _, ctx = contexts
    clips = [_clip(2.0), _clip(1.6, 300.0)]
    seen = []
    kw = dict(progress_callback=lambda _, p: seen.append(p), **GREEDY)
    got = BatchTranscriber(ctx).transcribe(clips, gt.TranscribeParams(**kw))
    assert seen
    for g, clip in zip(got, clips):
        _same(g, _single(ctx, clip, **GREEDY))


def test_transcribe_many_yields_each_batch_in_order(contexts):
    _, ctx = contexts
    bt = BatchTranscriber(ctx)
    p = gt.TranscribeParams(**GREEDY)
    a, b, c = _clip(2.0), _clip(1.5, 300.0), _clip(1.8, 250.0)
    out = list(bt.transcribe_many([[a, b], [c]], p))
    assert [len(x) for x in out] == [2, 1]
    _same(out[1][0], bt.transcribe([c], p)[0])
    assert bt.transcribe([], p) == []


def test_full_parallel_matches_jax(contexts):
    """full_parallel with two chunks of 2 s: the JAX package's merged
    segments, each chunk's times offset by its start."""
    jctx, ctx = contexts
    audio = _clip(4.0)
    want = jctx.full_parallel(jgwt.TranscribeParams(**GREEDY), audio, 2)
    got = ctx.full_parallel(gt.TranscribeParams(**GREEDY), audio, 2)
    assert len(got) >= 2 and max(s.t0 for s in got) >= 150
    _same(got, want)
    assert ctx.full_n_segments() == len(got)


def test_decode_carries_the_cache(contexts):
    """decode(a) then decode(b, len(a)) equals decode(a + b), and both equal
    the JAX package's decode within 1e-4; an n_past that does not continue
    the cache raises as in JAX."""
    jctx, ctx = contexts
    audio = _clip(2.0)
    cfg = ctx.config
    a = [cfg.token_sot, cfg.token_beg]
    b = [1000, 2000, 3000]
    ctx.pcm_to_mel(audio)
    jctx.pcm_to_mel(audio)
    whole = ctx.decode(a + b, 0)
    ctx.decode(a, 0)
    split = ctx.decode(b, len(a))
    np.testing.assert_allclose(split, whole, atol=1e-5, rtol=0)
    np.testing.assert_allclose(whole, jctx.decode(a + b, 0), atol=1e-4,
                               rtol=0)
    with pytest.raises(ValueError, match="does not continue"):
        ctx.decode(b, 1)
    ctx._decode_state = None
    with pytest.raises(ValueError, match="no cached history"):
        ctx.decode(b, 2)


def _noise(seconds, seed):
    rng = np.random.default_rng(seed)
    return (0.2 * rng.standard_normal(int(seconds * 16000))).astype(
        np.float32)


def test_stage_api_matches_jax(contexts):
    """pcm_to_mel is the pipeline's mel cut to n_len, bit for bit, and the
    JAX package's within 1e-4 (f32 sums in another order, the limit of
    tests/test_torch_mel.py; on noise, which has no near-empty bins where
    cancellation in the DFT sums leaves only rounding); encode within 1e-4
    of JAX's; a mel set through set_mel decodes as it does in JAX;
    is_multilingual."""
    jctx, ctx = contexts
    x = _noise(2.5, 7)
    mel = ctx.pcm_to_mel(x)
    dev, n_len = ctx.pipeline.mel.device(x)
    np.testing.assert_array_equal(mel, dev[:, :n_len].numpy())
    jmel = jctx.pcm_to_mel(x)
    assert mel.shape == jmel.shape
    np.testing.assert_allclose(mel, jmel, atol=1e-4, rtol=0)
    np.testing.assert_allclose(ctx.encode(0).numpy(),
                               np.asarray(jctx.encode(0)), atol=1e-4, rtol=0)
    assert ctx.is_multilingual() == jctx.is_multilingual() is False

    # an external mel of 2.5 s (frames past it read as zeros): the JAX
    # package decodes it on its per-window path, the port on its clip path
    audio = _clip(2.5)
    mel = ctx.pcm_to_mel(audio)[:, :port_mel.frame_counts(len(audio))[1]]
    jctx.set_mel(mel)
    want = jctx.full(jgwt.TranscribeParams(no_context=True, **GREEDY), None)
    ctx.set_mel(mel)
    got = ctx.full(gt.TranscribeParams(no_context=True, **GREEDY), None)
    assert want
    _same(got, want)


def test_device_batch_is_each_clip_mel(contexts):
    """The batched mel (one K1 launch over ragged clips, each normalized by
    its own maximum) equals each clip's own mel bit for bit and the JAX
    package's batched mel within 1e-4 (as in test_stage_api_matches_jax);
    the host mels are the JAX package's numpy functions bit for bit."""
    _, ctx = contexts
    front = ctx.pipeline.mel
    clips = [_noise(2.0, 1), _noise(31.0, 2), np.zeros(900, np.float32)]
    mel, n_lens = front.device_batch(clips)
    jmel, jn = jax_mel.MelFrontend(front.filters).device_batch(clips)
    assert n_lens == jn and tuple(mel.shape) == tuple(jmel.shape)
    np.testing.assert_allclose(mel.numpy(), np.asarray(jmel), atol=1e-4,
                               rtol=0)
    for i, clip in enumerate(clips):
        one, n_one = front.device(clip)
        assert n_one == n_lens[i]
        np.testing.assert_array_equal(mel[i, :, :n_one].numpy(),
                                      one[:, :n_one].numpy())
    host = front.precompute_host_mels(clips)
    for h, clip in zip(host, clips):
        np.testing.assert_array_equal(h, jax_mel.log_mel_host(
            clip, front.filters, n_frames=mel.shape[2]))

    x = _clip(0.3)
    np.testing.assert_array_equal(port_mel.log_mel_np(x, front.filters),
                                  jax_mel.log_mel_np(x, front.filters))
    padded = port_mel.pad_audio(x)
    np.testing.assert_array_equal(
        port_mel.log_mel_frames_raw(padded, front.filters, 3, 20),
        jax_mel.log_mel_frames_raw(padded, front.filters, 3, 20))
    assert front.mel_len(len(x)) == port_mel.frame_counts(len(x))


def _dtypes(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_dtypes(tree[k], path + (k,)))
        return out
    return {path: str(tree.dtype).split(".")[-1]}


def test_compute_dtype_none_is_bf16_as_in_jax(tmp_path):
    """compute_dtype=None gives the JAX package's parameter dtypes, leaf by
    leaf: bf16 matmul weights, f32 norms, biases and positional
    embeddings.  synthetic("tiny.en") and a nano ggml file written by the
    JAX exporter."""
    ours = gt.WhisperContext.synthetic("tiny.en", compute_dtype=None,
                                       device="cpu").pipeline.params
    want = jgwt.WhisperContext.synthetic(
        "tiny.en", compute_dtype=None).pipeline.params
    assert _dtypes(ours) == _dtypes(want)
    assert _dtypes(ours)[("decoder", "token_embed")] == "bfloat16"

    jcfg = _cfg(jgwt)
    path = str(tmp_path / "nano.bin")
    export_checkpoint(path, jax_init_params(jcfg, seed=1,
                                            compute_dtype=jnp.float32),
                      jcfg, jax_mel.mel_filterbank(80), jsv(jcfg),
                      ttype=loader_ggml.GGML_TYPE_F32)
    for load in ("from_file", "from_buffer"):
        arg = path if load == "from_file" else open(path, "rb").read()
        got = getattr(gt.WhisperContext, load)(arg, compute_dtype=None,
                                               device="cpu").pipeline.params
        ref = getattr(jgwt.WhisperContext, load)(
            arg, compute_dtype=None).pipeline.params
        assert _dtypes(got) == _dtypes(ref)
