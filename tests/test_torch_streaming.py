"""Real-time streaming in the port against the JAX package on the CPU:
IncrementalMel, StreamingTranscriber (incremental mel on and off, sentence
finalisation and the trim keep-back, resampled sources, the scheduler
thread), the SpeechToText facade, the settings and the logging.

Weights: nano-3 (nano with 3 text layers) at f32 from the JAX package's
init_params(seed=3), converted to torch, with the decoder's final
LayerNorm gain at 30x in both packages.  The streaming recipe keeps the
default temperature ladder and logprob gate; at the random init's logit
spread every window falls through to the sampling rungs, whose noise the
two packages draw differently, while at 30x the decoder is confident and
every window settles on the t = 0 rung, where the two must agree token for
token.  Mels: the JAX suite's limit, 2e-5."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import godot_whisper_tpu as jgwt
import godot_whisper_tpu_torch as gt
from godot_whisper_tpu.audio.mel import log_mel_host
from godot_whisper_tpu.audio.mel import mel_filterbank as jax_filters
from godot_whisper_tpu.audio.tokenizer import Tokenizer as JT
from godot_whisper_tpu.audio.tokenizer import synthetic_vocab as jsv
from godot_whisper_tpu.decode.loop import WhisperPipeline as JP
from godot_whisper_tpu.models.params import init_params as jax_init_params
from godot_whisper_tpu.runtime import logging as jax_logging
from godot_whisper_tpu.runtime import settings as jax_settings
from godot_whisper_tpu.runtime import streaming as jst
from godot_whisper_tpu.runtime.speech_to_text import \
    SpeechToText as JaxSpeechToText
from godot_whisper_tpu_torch.models.params import params_from_jax
from godot_whisper_tpu_torch.runtime import logging as port_logging
from godot_whisper_tpu_torch.runtime import settings as port_settings
from godot_whisper_tpu_torch.runtime import streaming as pst
from godot_whisper_tpu_torch.runtime.speech_to_text import SpeechToText

MEL_TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Single-threaded torch: the CPU is shared with other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def contexts():
    def cfg(pkg):
        return pkg.get_config("tiny.en").replace(
            n_audio_layer=2, n_text_layer=3, n_audio_state=128,
            n_audio_head=4, n_text_state=128, n_text_head=4, name="nano-3")
    jcfg = cfg(jgwt)
    params = jax_init_params(jcfg, seed=3, compute_dtype=jnp.float32)
    params["decoder"]["ln"]["g"] = params["decoder"]["ln"]["g"] * 30.0
    jctx = jgwt.WhisperContext(JP(jcfg, params, JT(jcfg, jsv(jcfg)),
                                  jax_filters(80), n_loaded=1))
    ctx = gt.WhisperContext.from_params(
        cfg(gt), params_from_jax(jax.tree_util.tree_map(np.asarray, params)),
        device="cpu")
    return jctx, ctx


def _speech(seconds, rate=16000):
    t = np.arange(int(seconds * rate)) / rate
    return (0.3 * np.sin(2 * np.pi * (220.0 + 60 * np.sin(
        2 * np.pi * 0.07 * t)) * t)
        + 0.2 * np.sin(2 * np.pi * 447.0 * t)
        * (0.5 + 0.5 * np.sin(2 * np.pi * 1.7 * t))).astype(np.float32)


def test_text_helpers_match_jax():
    for msg in ("hello [noise] world", "a <tag> b", "la ♪music♪ la",
                "so. you. done", "open [bracket", "<tok1><tok2> x."):
        assert (pst.remove_special_characters(msg)
                == jst.remove_special_characters(msg))
        for chars in (".!?;。；？！", "x"):
            assert (pst.has_terminating_characters(msg, chars)
                    == jst.has_terminating_characters(msg, chars))
    assert (pst.StreamingConfig().__dict__.keys()
            == jst.StreamingConfig().__dict__.keys())
    assert pst.StreamingConfig().audio_ctx_bucket == 128


def _feeds(case):
    rng = np.random.default_rng(11)
    if case == "chunks":          # 0.3 s pushes of 3 s of noise
        audio = (0.2 * rng.standard_normal(16000 * 3)).astype(np.float32)
        return audio, [(i, i + 4800) for i in range(0, len(audio), 4800)]
    if case == "tail_burst":      # a burst in the last < 400 samples
        audio = np.full(16000, 1e-4, np.float32)
        audio[-300:] = 0.9
        return audio, [(i, i + 4000) for i in range(0, len(audio), 4000)]
    # a first feed shorter than the 200-sample reflect head
    audio = (0.2 * rng.standard_normal(8000)).astype(np.float32)
    return audio, [(0, 160), (160, 500), (500, len(audio))]


@pytest.mark.parametrize("case", ["chunks", "tail_burst", "short_head"])
def test_incremental_mel_matches_oneshot_and_jax(contexts, case):
    """IncrementalMel fed piece by piece equals the one-shot host mel
    (the JAX package's log_mel_host) within 2e-5 and the JAX
    IncrementalMel within one f32 ulp (XLA rewrites the normalization's
    arithmetic); each feed writes O(delta) frames."""
    jctx, ctx = contexts
    audio, feeds = _feeds(case)
    inc = pst.IncrementalMel(ctx.pipeline)
    jinc = jst.IncrementalMel(jctx.pipeline)
    writes = [inc.feed(audio[a:b]) for a, b in feeds]
    for a, b in feeds:
        jinc.feed(audio[a:b])
    mel, n_len, n_len_org = inc.normalized()
    jmel, jn_len, jn_org = jinc.normalized()
    assert (n_len, n_len_org) == (jn_len, jn_org)
    assert mel.device == ctx.pipeline.device
    np.testing.assert_array_max_ulp(mel.numpy(), np.asarray(jmel),
                                    maxulp=1)
    np.testing.assert_allclose(
        mel.numpy(), log_mel_host(audio, ctx.pipeline.mel.filters,
                                  n_frames=inc.cap), atol=MEL_TOL,
        rtol=MEL_TOL)
    if case == "chunks":
        assert max(writes[1:]) <= 4800 // 160 + 4


def _run_stream(st, audio, step):
    reports = []
    for i in range(0, len(audio), step):
        st.push_audio(audio[i:i + step])
        r = st.process_once()
        reports.append(None if r is None else {k: v for k, v in r.items()
                                               if k != "elapsed"})
    return reports


def _both(contexts, audio, step, source_rate=16000, **cfg):
    out = {}
    for name, mod, c in (("jax", jst, contexts[0]),
                         ("port", pst, contexts[1])):
        events = []
        st = mod.StreamingTranscriber(
            c, mod.StreamingConfig(**cfg),
            on_transcription=lambda p, t: events.append((p, t)),
            source_rate=source_rate)
        reports = _run_stream(st, audio, step)
        out[name] = (events, reports, st.text(), list(st.finalized_texts))
    return out


@pytest.mark.parametrize("incremental", [False, True])
def test_streaming_matches_jax(contexts, incremental):
    """3 s pushed in 0.3 s pieces: the same partial / final events with the
    same text, the same reports (audio_ctx, token counts, finalisation)."""
    out = _both(contexts, _speech(3.0), 4800, minimum_sentence_time=0.5,
                maximum_sentence_time=1.5, incremental_mel=incremental)
    events = out["port"][0]
    assert len(events) == 10 and any(t for _, t in events)
    assert not all(p for p, _ in events)   # a sentence was finalized
    assert out["port"] == out["jax"]


def test_streaming_trim_resets_incremental(contexts):
    """After a finalize trims the buffer the incremental path rebuilds its
    mel even when the buffer regrows past its old length: the same as the
    re-mel path and as JAX throughout."""
    rng = np.random.default_rng(5)
    audio = (0.2 * rng.standard_normal(16000 * 3)).astype(np.float32)
    cfg = dict(minimum_sentence_time=0.4, maximum_sentence_time=0.8,
               keep_seconds=0.3)
    inc = _both(contexts, audio, 16000, incremental_mel=True, **cfg)
    full = _both(contexts, audio, 16000, incremental_mel=False, **cfg)
    assert len(inc["port"][3]) >= 2
    assert inc["port"] == inc["jax"]
    assert inc["port"][:3] == full["port"][:3]


def test_streaming_resamples_other_rates(contexts):
    """A 48 kHz source resampled each interval (incremental mel off): the
    JAX package's reports; audio_ctx from the 16 kHz length, bucketed."""
    out = _both(contexts, _speech(2.0, 48000), 48000, source_rate=48000,
                minimum_sentence_time=0.5)
    reports = out["port"][1]
    exact = int(2.0 * 1500 / 30 + 128)
    assert exact <= reports[-1]["audio_ctx"] <= exact + 128
    assert out["port"] == out["jax"]


def test_streaming_thread_and_empty_buffer(contexts):
    """Nothing pushed: no report.  The scheduler thread transcribes what is
    pushed while it runs and stops when asked."""
    _, ctx = contexts
    events = []
    st = pst.StreamingTranscriber(
        ctx, pst.StreamingConfig(transcribe_interval=0.05),
        on_transcription=lambda p, t: events.append(t))
    assert st.process_once() is None
    st.push_audio(_speech(1.5))
    st.start()
    thread = st._thread
    try:
        deadline = time.perf_counter() + 60
        while not events and time.perf_counter() < deadline:
            time.sleep(0.05)
    finally:
        st.stop()
    assert events and not st.recording
    assert not thread.is_alive()


def test_speech_to_text_matches_jax(contexts):
    """The node facade: resample (44.1 kHz stereo to 16 kHz mono), VAD and
    transcribe give the JAX facade's answers: token dicts equal but for
    p, pt and ptsum within 1e-3 (the JAX clip loop drains them through
    float16) and plog within 1e-4 (f32 sums in another order)."""
    jctx, ctx = contexts
    rng = np.random.default_rng(3)
    stereo = np.stack([_speech(1.2, 44100), 0.1 * rng.standard_normal(
        int(1.2 * 44100)).astype(np.float32)], axis=1)
    outs = {}
    for name, cls, c in (("jax", JaxSpeechToText, jctx),
                         ("port", SpeechToText, ctx)):
        stt = cls(mix_rate=44100)
        stt.set_language(0)
        stt.set_language_model(c)
        assert stt.get_language_model() is c and stt.get_language() == "en"
        mono = stt.resample(stereo)
        res = stt.transcribe(np.concatenate([mono, mono]), "", 256)
        outs[name] = (mono, stt.voice_activity_detection(mono), res)
    (jm, jv, jr), (pm, pv, pr) = outs["jax"], outs["port"]
    np.testing.assert_array_equal(pm, jm)
    assert pv == jv and pr[0] == jr[0] and len(pr) == len(jr) > 1
    close = {"p": 1e-3, "pt": 1e-3, "ptsum": 1e-3, "plog": 1e-4}
    for a, b in zip(pr[1:], jr[1:]):
        assert {k: v for k, v in a.items() if k not in close} == \
            {k: v for k, v in b.items() if k not in close}
        for k, tol in close.items():
            assert abs(a[k] - b[k]) <= tol, k


def test_settings_and_logging_match_jax(monkeypatch):
    for mod in (port_settings, jax_settings):
        mod.reset_settings()
    assert port_settings.all_settings() == jax_settings.all_settings()
    port_settings.set_setting("audio.input.transcribe.max_tokens", 32)
    assert port_settings.get_setting("audio.input.transcribe.max_tokens") \
        == 32
    monkeypatch.setenv("GWT_AUDIO_INPUT_TRANSCRIBE_MAX_TOKENS", "8")
    monkeypatch.setenv("GWT_AUDIO_INPUT_TRANSCRIBE_USE_GPU", "no")
    for key in ("audio.input.transcribe.max_tokens",
                "audio.input.transcribe.use_gpu"):
        assert (port_settings.get_setting(key)
                == jax_settings.get_setting(key))
    port_settings.reset_settings()

    got = []
    port_logging.log_set(lambda lvl, text: got.append((int(lvl), text)))
    want = []
    jax_logging.log_set(lambda lvl, text: want.append((int(lvl), text)))
    try:
        for mod in (port_logging, jax_logging):
            mod.log_info("hello %d", 42)
            mod.log_error("bad")
            mod.log_debug("dbg %s", "x")
            mod.log_warn("careful")
    finally:
        port_logging.log_set(None)
        jax_logging.log_set(None)
    assert got == want and len(got) == 4
    info = port_logging.system_info()
    assert "torch" in info and "cuda" in info and "jax" not in info
