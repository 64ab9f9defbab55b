"""The port's tools against the JAX package's on the CPU: the WER harness
(``cli/eval.py``), voice commands (``cli/command.py``), the quantizer
(``cli/quantize.py``), the model URLs (``cli/download.py``; nothing here
touches the network), the kernels' build directory (``runtime/cache.py``)
and the bench (``cli/bench.py``: the sweep's CSV on the CPU, and the
modes that time the card refusing to run without one).

The end-to-end CLI runs use the pico checkpoint of tests/test_torch_serve.py
(the decoder's final LayerNorm gain at 30x and a +35 logit on end-of-text),
so that every window settles on the t = 0 rung after a token or two, where
the two packages must print the same lines."""

import functools
import io
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import godot_whisper_tpu as jgwt
import godot_whisper_tpu_torch as gt
from godot_whisper_tpu.audio.mel import mel_filterbank
from godot_whisper_tpu.audio.tokenizer import synthetic_vocab
from godot_whisper_tpu.audio.wav import write_wav
from godot_whisper_tpu.cli import command as jax_command
from godot_whisper_tpu.cli import download as jax_download
from godot_whisper_tpu.cli import eval as jax_eval
from godot_whisper_tpu.cli import quantize as jax_quantize
from godot_whisper_tpu.models import loader_ggml as jax_loader
from godot_whisper_tpu.models.export_ggml import export_checkpoint
from godot_whisper_tpu.models.params import init_params
from godot_whisper_tpu_torch.cli import bench
from godot_whisper_tpu_torch.cli import command as port_command
from godot_whisper_tpu_torch.cli import download as port_download
from godot_whisper_tpu_torch.cli import eval as port_eval
from godot_whisper_tpu_torch.cli import quantize as port_quantize
from godot_whisper_tpu_torch.models import loader_ggml as port_loader
from godot_whisper_tpu_torch.ops import kernels
from godot_whisper_tpu_torch.runtime import cache

COMMANDS = "turn on the light,turn off the light,stop"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Single-threaded torch: the CPU is shared with other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pico_bin(tmp_path_factory):
    cfg = jgwt.get_config("tiny.en").replace(
        n_audio_layer=1, n_text_layer=1, n_audio_state=64, n_audio_head=2,
        n_text_state=64, n_text_head=2, name="pico")
    params = init_params(cfg, seed=0, compute_dtype=jnp.float32)
    ln = params["decoder"]["ln"]
    eot = params["decoder"]["token_embed"][cfg.token_eot]
    ln["g"] = ln["g"] * 30.0
    ln["b"] = ln["b"] + 35.0 * eot / jnp.sum(eot * eot)
    path = str(tmp_path_factory.mktemp("models") / "pico.bin")
    export_checkpoint(path, params, cfg, mel_filterbank(80),
                      synthetic_vocab(cfg), ttype=jax_loader.GGML_TYPE_F32)
    return path


def _tone(path, seconds=2.0, f0=300.0):
    t = np.arange(int(seconds * 16000)) / 16000.0
    write_wav(str(path), (0.3 * np.sin(2 * np.pi * f0 * t)).astype(
        np.float32))
    return str(path)


def _run(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


# --------------------------------------------------------------------- eval
TEXTS = [
    ("And so my fellow Americans, ask not what your country can do for you",
     "and so my fellow americans ask not what your country can do for you"),
    ("[noise] The quick (brown) fox <unk> jumps!", "the quick fox jumps"),
    ("Café déjà vu, naïve résumé", "cafe deja vu naive resume resume"),
    ("it's   a\ttest -- isn't it?", "its a test isnt"),
    ("", "hallucinated words"),
    ("one two three", ""),
]


@pytest.mark.parametrize("ref,hyp", TEXTS, ids=range(len(TEXTS)))
def test_eval_normalization_and_wer_match_jax(ref, hyp):
    for s in (ref, hyp):
        assert port_eval.normalize_text(s) == jax_eval.normalize_text(s)
    for norm in (True, False):
        assert (port_eval.word_error_rate(ref, hyp, normalize=norm)
                == jax_eval.word_error_rate(ref, hyp, normalize=norm))
    r, h = ref.split(), hyp.split()
    assert port_eval.edit_distance(r, h) == jax_eval.edit_distance(r, h)


def test_eval_cli_matches_jax(pico_bin, tmp_path):
    _tone(tmp_path / "a.wav")
    (tmp_path / "a.txt").write_text("turn on the light")
    _tone(tmp_path / "b.wav", 2.5, 440.0)
    (tmp_path / "b.txt").write_text("stop")
    got = _run(port_eval.main, ["-m", pico_bin, "--device", "cpu",
                                str(tmp_path)])
    want = _run(jax_eval.main, ["-m", pico_bin, str(tmp_path)])
    assert got == want
    assert got[0] == 0 and "TOTAL WER" in got[1]


# ------------------------------------------------------------------ command
@pytest.mark.parametrize("commands", [
    ["turn on the light", "turn off the light", "stop"],
    ['say "hi"', "back\\slash", "  padded  ", ""],
])
def test_command_grammar_text_matches_jax(commands):
    assert (port_command.commands_to_gbnf(commands)
            == jax_command.commands_to_gbnf(commands))


@pytest.mark.parametrize("text", ["Turn on the light.", "stop!", "lights on",
                                  ""])
def test_best_command_matches_jax(text):
    cmds = COMMANDS.split(",")
    assert (port_command.best_command(text, cmds)
            == jax_command.best_command(text, cmds))


def test_command_cli_with_grammar_matches_jax(pico_bin, tmp_path):
    """--use-grammar: the host-stepped decoder under the commands'
    grammar, the same heard text, match and exit code as the JAX CLI."""
    wav = _tone(tmp_path / "cmd.wav")
    argv = ["-m", pico_bin, "--commands", COMMANDS, "--file", wav,
            "--use-grammar"]
    got = _run(port_command.main, argv + ["--device", "cpu"])
    want = _run(jax_command.main, argv)
    assert got == want
    assert got[0] in (0, 3) and "heard:" in got[1]


# ----------------------------------------------------------------- quantize
@pytest.fixture(scope="module")
def plain_pico(tmp_path_factory):
    """The pico weights of init_params(seed=0), F32, written by the port's
    exporter."""
    from godot_whisper_tpu_torch.audio.mel import mel_filterbank as pmf
    from godot_whisper_tpu_torch.audio.tokenizer import synthetic_vocab as psv
    from godot_whisper_tpu_torch.models.export_ggml import \
        export_checkpoint as port_export
    cfg = gt.get_config("tiny.en").replace(
        n_audio_layer=1, n_text_layer=1, n_audio_state=64, n_audio_head=2,
        n_text_state=64, n_text_head=2, name="pico")
    path = str(tmp_path_factory.mktemp("models") / "pico-f32.bin")
    port_export(path, gt.init_params(cfg, seed=0, compute_dtype=torch.float32,
                                     device="cpu"),
                cfg, pmf(80), psv(cfg), ttype=port_loader.GGML_TYPE_F32)
    return path


@pytest.mark.parametrize("fmt", sorted(port_quantize._FMTS))
def test_quantize_roundtrip_matches_jax(plain_pico, tmp_path, fmt):
    """Each format: the port's file equals the JAX tool's byte for byte;
    read back through the port's loader it keeps the header and
    vocabulary, the quantized matrices lie within the format's error of
    the F32 ones (relative RMS, from its bits: 8-bit 1%, 6-bit 4%, 5-bit 8%,
    4-bit 15%, 3-bit 30%, 2-bit 60%), and it loads and transcribes."""
    out, ref = str(tmp_path / "port.bin"), str(tmp_path / "jax.bin")
    rc, text = _run(port_quantize.main, [plain_pico, out, fmt])
    assert rc == 0 and f"to {fmt}" in text
    jax_quantize.quantize_model(plain_pico, ref, fmt)
    with open(out, "rb") as f, open(ref, "rb") as g:
        assert f.read() == g.read()

    raw_f = port_loader.read_checkpoint(plain_pico)
    raw_q = port_loader.read_checkpoint(out)
    assert raw_q.config == raw_f.config
    assert raw_q.vocab_tokens == raw_f.vocab_tokens
    rel = {"q8_0": 0.01, "q6_k": 0.04, "q5_k": 0.08, "q4_0": 0.15,
           "q4_1": 0.15, "q4_k": 0.15, "q3_k": 0.3, "q2_k": 0.6}[fmt]
    ttype, _ = port_quantize._FMTS[fmt]
    n_q = 0
    for name, w_f in raw_f.tensors.items():
        w_q = raw_q.tensors[name]
        if port_quantize.should_quantize(name, w_f, ttype):
            n_q += 1
            err = np.sqrt(np.mean((w_q - w_f) ** 2))
            assert err <= rel * np.sqrt(np.mean(w_f ** 2)), name
        else:
            np.testing.assert_array_equal(w_q, w_f)
    assert n_q > 0
    ctx = gt.WhisperContext.from_file(out, device="cpu")
    segs = ctx.full(gt.TranscribeParams(best_of=1, temperature_inc=0.0),
                    np.zeros(2 * 16000, dtype=np.float32))
    assert isinstance(segs, list)


# ----------------------------------------------------------------- download
def test_download_urls_match_jax():
    assert port_download.MODELS == jax_download.MODELS
    assert "tiny.en" in port_download.MODELS
    for m in port_download.MODELS:
        assert port_download.model_url(m) == jax_download.model_url(m)
    assert port_download.model_url("tiny.en") == (
        "https://huggingface.co/ggerganov/whisper.cpp/resolve/main/"
        "ggml-tiny.en.bin")


def test_download_rejects_unknown_model(tmp_path):
    with pytest.raises(ValueError, match="unknown model"):
        port_download.download("tiny.xx", str(tmp_path))


# -------------------------------------------------------------------- cache
def test_cache_moves_the_build_root(tmp_path, monkeypatch):
    monkeypatch.setattr(kernels, "BUILD_ROOT", kernels.BUILD_ROOT)
    monkeypatch.delenv("GWT_TORCH_CACHE", raising=False)
    default = kernels.BUILD_ROOT
    assert cache.enable_compilation_cache() == default
    target = tmp_path / "kernels"
    assert cache.enable_compilation_cache(str(target)) == target
    assert kernels.BUILD_ROOT == target and target.is_dir()
    assert kernels._lib_path("mel").parent.parent == target
    env = tmp_path / "from-env"
    monkeypatch.setenv("GWT_TORCH_CACHE", str(env))
    assert cache.enable_compilation_cache() == env
    assert kernels.BUILD_ROOT == env


def test_cache_refuses_to_move_after_a_library_loaded(tmp_path, monkeypatch):
    monkeypatch.setattr(kernels, "BUILD_ROOT", kernels.BUILD_ROOT)

    @functools.lru_cache(maxsize=None)
    def library(name):
        return object()
    library("mel")
    monkeypatch.setattr(kernels, "library", library)
    before = kernels.BUILD_ROOT
    with pytest.raises(RuntimeError, match="already loaded"):
        cache.enable_compilation_cache(str(tmp_path / "elsewhere"))
    assert kernels.BUILD_ROOT == before
    # the directory it already uses is fine
    assert cache.enable_compilation_cache(str(before)) == before


# -------------------------------------------------------------------- bench
def test_bench_sweep_writes_its_csv_on_the_cpu(tmp_path):
    out = tmp_path / "sweep.csv"
    rc, text = _run(bench.main, [
        "--what", "sweep", "--device", "cpu", "--models", "tiny.en",
        "--batches", "2", "--audio-seconds", "1.5", "-o", str(out)])
    assert rc == 0 and "godot_whisper_tpu_torch: torch" in text
    rows = [r.split(",") for r in out.read_text().splitlines()]
    assert rows[0] == ["model", "batch", "audio_s", "wall_s",
                       "audio_s_per_s", "device"]
    assert [(r[0], r[1], r[2], r[5]) for r in rows[1:]] == [
        ("tiny.en", "2", "3.0", "cpu")]
    assert all(float(r[3]) > 0 and float(r[4]) > 0 for r in rows[1:])


@pytest.mark.parametrize("what", ["kernels", "e2e", "encoder", "memcpy",
                                  "matmul"])
@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_bench_card_modes_refuse_the_cpu(what, device):
    """Without a card a timing mode raises; asked for the CPU it raises
    too: no mode falls back to timing the CPU."""
    if device == "cuda" and torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        _run(bench.main, ["--what", what, "--device", device])


def test_bench_peaks_default_to_the_h100(monkeypatch):
    monkeypatch.delenv("GWT_PEAK_FLOPS", raising=False)
    monkeypatch.delenv("GWT_PEAK_BW", raising=False)
    bw, peaks = bench._peaks()
    assert (bw, peaks["bf16"], peaks["tf32"], peaks["f32"]) == (
        3.35e12, 989e12, 495e12, 67e12)
    monkeypatch.setenv("GWT_PEAK_FLOPS", str(989e12 / 2))
    monkeypatch.setenv("GWT_PEAK_BW", "2e12")
    bw, peaks = bench._peaks()
    assert bw == 2e12 and peaks["tf32"] == pytest.approx(495e12 / 2)


def test_bench_bound_is_the_larger_time(monkeypatch):
    monkeypatch.delenv("GWT_PEAK_FLOPS", raising=False)
    monkeypatch.delenv("GWT_PEAK_BW", raising=False)
    assert bench.bound(3.35e9, 989e9) == (1.0, "bytes")
    assert bench.bound(3.35e9, 2 * 989e9) == (2.0, "operations")
    ms, by = bench.bound(0, 495e9, "tf32", f32_ops=2 * 67e9)
    assert by == "operations" and ms == pytest.approx(2.0)


def test_bench_kernel_cases_are_one_function_each():
    """The bench's table on the CPU, where each wrapper runs a plain
    version: K1-K13 once each, and each case's wrapper, plain version and
    library yardstick (where it runs on the CPU) computing one function,
    within 1e-2 of the plain version (outputs rounded to bf16; K2's
    wrapper takes the einsum here, its plain version the single-pass
    function; K12's W8A8 rounds p to int8).  torch.mm with out_dtype (K9 /
    K10's yardstick) runs only on the card."""
    cpu = torch.device("cpu")
    cases = bench.kernel_cases(cpu)
    assert [c.name.split()[0] for c in cases] == [
        f"K{i}" for i in range(1, 14)]
    cases += bench.route_cases(cpu)
    assert len({c.key for c in cases}) == len(cases) == 16

    def first(x):
        return x[0] if isinstance(x, tuple) else x
    for c in cases:
        got, want = first(c.run()), first(c.plain())
        assert float((got.float() - want.float()).abs().max()) < 1e-2, c.name
        assert c.n_bytes > 0 and bench.bound(
            c.n_bytes, c.n_ops, c.kind, c.f32_ops)[0] > 0
        if c.library is None or c.key.startswith("qmatmul"):
            continue
        lib = first(c.library()).float().reshape(want.shape)
        assert float((lib - want.float()).abs().max()) < 1e-2, c.name
