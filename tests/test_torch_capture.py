"""Capture, VAD, the native capture ring and the streaming CLI of the
port on the CPU, against the JAX package and the port's Python ring.

The native library is the port's own copy of the C++ capture ring, built
with g++ into godot_whisper_tpu_torch/_build/ (tests that need it skip
where there is no compiler).  Tolerances: VAD decisions and rings exactly.
The streaming CLI uses nano-3 (3 text layers) with the decoder's final
LayerNorm gain at 30x, which settles every window on the t = 0 rung of
the streaming recipe's ladder, where the port must print what the JAX
scheduler gives, line for line."""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import godot_whisper_tpu as jgwt
from godot_whisper_tpu.audio import vad as jax_vad
from godot_whisper_tpu.audio.mel import mel_filterbank
from godot_whisper_tpu.audio.tokenizer import synthetic_vocab
from godot_whisper_tpu.models import loader_ggml
from godot_whisper_tpu.models.export_ggml import export_checkpoint
from godot_whisper_tpu.models.params import init_params
from godot_whisper_tpu.runtime import capture as jax_capture
from godot_whisper_tpu.runtime import streaming as jax_streaming
from godot_whisper_tpu_torch.audio import vad
from godot_whisper_tpu_torch.audio.wav import write_wav
from godot_whisper_tpu_torch.cli import stream as port_stream
from godot_whisper_tpu_torch.native import bindings
from godot_whisper_tpu_torch.runtime import capture


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Single-threaded torch: the CPU is shared with other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def native():
    if not bindings.available():
        pytest.skip(f"no native build: {bindings.build_error()}")
    return bindings


def test_native_library_is_the_ports_own(native):
    path = native.library_path()
    assert path.exists()
    assert path.parent.parent.name == "_build"
    assert path.parent.parent.parent.name == "godot_whisper_tpu_torch"
    assert native.load_library()._name == str(path)


def _contract(ring):
    """The drop-on-overflow ring contract of the JAX suite
    (tests/test_capture.py)."""
    out = [ring.push(np.arange(5, dtype=np.float32)),
           ring.push(np.arange(5, dtype=np.float32)), ring.available,
           ring.pop(4).tolist(), ring.push(np.full(4, 9, np.float32)),
           ring.pop(8).tolist(), ring.available]
    return out


@pytest.mark.parametrize("kind", ["python", "native"])
def test_ring_contract_matches_jax(kind, request):
    if kind == "native":
        request.getfixturevalue("native")
        ring = bindings.NativeRing(8)
    else:
        ring = capture._PyRing(8)
    want = _contract(jax_capture._PyRing(8))
    assert _contract(ring) == want
    assert want[:3] == [5, 3, 8]


def test_synthetic_producer_through_the_native_ring(native):
    """A paced producer thread fills the port's native ring while the
    consumer drains it, in real time."""
    src = capture.CaptureSource("synthetic", ring_seconds=5.0)
    assert isinstance(src.ring, bindings.NativeRing)
    assert src.start() == "synthetic"
    got = []
    t0 = time.perf_counter()
    try:
        while time.perf_counter() - t0 < 0.7:
            time.sleep(0.1)
            got.append(src.read_available())
    finally:
        src.stop()
    total = sum(len(g) for g in got)
    assert 0.3 * 16000 <= total <= 1.5 * 16000, total
    assert np.abs(np.concatenate(got)).max() > 0.05
    assert src.dropped == 0


def test_ring_overflow_drops_and_missing_backends_raise():
    src = capture.CaptureSource("synthetic", ring_seconds=0.01)  # 160
    src._start_synthetic = lambda: None                          # no thread
    src.start()
    src._push(np.ones(100, np.float32))
    src._push(np.ones(100, np.float32))                          # 40 drop
    assert src.dropped == 40
    assert len(src.read_available()) == 160
    src.stop()
    with pytest.raises(RuntimeError, match="no capture backend"):
        capture.CaptureSource("sounddevice").start()


def _vad_cases():
    rng = np.random.default_rng(1)
    return [(0.5 * rng.standard_normal(3 * 16000)).astype(np.float32),
            np.concatenate([5e-5 * rng.standard_normal(32000),
                            np.zeros(16000)]).astype(np.float32),
            np.concatenate([5e-5 * rng.standard_normal(32000),
                            1e-3 * rng.standard_normal(16000)]).astype(
                                np.float32),
            np.zeros(100, dtype=np.float32)]


def test_vad_matches_jax():
    for x in _vad_cases():
        np.testing.assert_array_equal(
            vad.high_pass_filter(x, 200.0, 16000),
            jax_vad.high_pass_filter(x, 200.0, 16000))
        for kw in ({}, dict(vad_thold=2.0, freq_thold=200.0),
                   dict(last_ms=500, freq_thold=0.0)):
            assert vad.vad_simple(x, **kw) == jax_vad.vad_simple(x, **kw)
    assert [vad.vad_simple(x, vad_thold=2.0) for x in _vad_cases()] == \
        [False, True, False, False]


@pytest.fixture(scope="module")
def nano_bin(tmp_path_factory):
    cfg = jgwt.get_config("tiny.en").replace(
        n_audio_layer=2, n_text_layer=3, n_audio_state=128, n_audio_head=4,
        n_text_state=128, n_text_head=4, name="nano-3")
    params = init_params(cfg, seed=3, compute_dtype=jnp.float32)
    params["decoder"]["ln"]["g"] = params["decoder"]["ln"]["g"] * 30.0
    path = str(tmp_path_factory.mktemp("models") / "nano3.bin")
    export_checkpoint(path, params, cfg, mel_filterbank(80),
                      synthetic_vocab(cfg), ttype=loader_ggml.GGML_TYPE_F32)
    return path


def test_stream_cli_mic_synthetic(nano_bin, native, capsys):
    """--mic with the synthetic device: capture thread -> the port's
    native ring -> StreamingTranscriber -> transcript."""
    rc = port_stream.main(["-m", nano_bin, "--compute-device", "cpu",
                           "--mic", "--capture-backend", "synthetic",
                           "--duration", "0.8", "--step", "0.3"])
    out = capsys.readouterr()
    assert rc == 0
    assert "capturing via synthetic into a NativeRing" in out.err
    assert out.out.splitlines()[-2] == "---"


def test_stream_cli_file_matches_jax(nano_bin, tmp_path, capsys):
    """--file replays a WAV in 0.3 s steps: every printed line is what the
    JAX package's scheduler gives for the same pushes."""
    t = np.arange(int(2.4 * 16000)) / 16000.0
    audio = (0.3 * np.sin(2 * np.pi * (220.0 + 60 * np.sin(
        2 * np.pi * 0.07 * t)) * t)
        + 0.2 * np.sin(2 * np.pi * 447.0 * t)).astype(np.float32)
    wav = str(tmp_path / "s.wav")
    write_wav(wav, audio)
    assert port_stream.main(["-m", nano_bin, "--compute-device", "cpu",
                             "--file", wav, "--min-sentence", "0.5",
                             "--max-sentence", "1.2"]) == 0
    got = capsys.readouterr().out.splitlines()

    from godot_whisper_tpu.audio.wav import read_wav
    samples, _ = read_wav(wav)
    want = []
    st = jax_streaming.StreamingTranscriber(
        jgwt.WhisperContext.from_file(nano_bin),
        jax_streaming.StreamingConfig(minimum_sentence_time=0.5,
                                      maximum_sentence_time=1.2),
        on_transcription=lambda p, text: want.append(
            f"[{'…' if p else '✓'}] {text.strip()}"))
    for i in range(0, len(samples), 4800):
        st.push_audio(samples[i:i + 4800])
        st.process_once()
    st.process_once()
    want += ["---", st.text().strip()]
    assert len(got) > 3 and any("✓" in line for line in got)
    assert got == want
