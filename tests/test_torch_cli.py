"""The port's file-transcription CLI against the JAX package's on the CPU:
one pico ggml checkpoint, one WAV at 16 kHz and at 44.1 kHz (resampled by
both), gates open so that every window settles on the t = 0 rung."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

import godot_whisper_tpu as jgwt
from godot_whisper_tpu.audio.mel import mel_filterbank
from godot_whisper_tpu.audio.tokenizer import synthetic_vocab
from godot_whisper_tpu.audio.wav import write_wav
from godot_whisper_tpu.cli.main import main as jax_main
from godot_whisper_tpu.cli.outputs import to_json as jax_to_json
from godot_whisper_tpu.models import loader_ggml
from godot_whisper_tpu.models.export_ggml import export_checkpoint
from godot_whisper_tpu.models.params import init_params
from godot_whisper_tpu_torch.cli import outputs as toutputs
from godot_whisper_tpu_torch.cli.main import main as port_main

GREEDY = ["--entropy-thold=-1e9", "--logprob-thold=-1e9",
          "--temperature-inc", "0", "--best-of", "1", "--no-prints"]
# the JSON writers' one intended difference: the backend they name
JAX_SYSTEM_INFO = json.loads(jax_to_json([]))["systeminfo"]


@pytest.fixture(scope="module")
def pico_bin(tmp_path_factory):
    cfg = jgwt.get_config("tiny.en").replace(
        n_audio_layer=1, n_text_layer=3, n_audio_state=64, n_audio_head=2,
        n_text_state=64, n_text_head=2, name="pico")
    path = str(tmp_path_factory.mktemp("models") / "pico.bin")
    export_checkpoint(path, init_params(cfg, seed=1,
                                        compute_dtype=jnp.float32),
                      cfg, mel_filterbank(80), synthetic_vocab(cfg),
                      ttype=loader_ggml.GGML_TYPE_F32)
    return path


def _wav(path, rate):
    t = np.arange(int(12.5 * rate)) / rate
    write_wav(path, (0.3 * np.sin(2 * np.pi * (220.0 + 60 * np.sin(
        2 * np.pi * 0.07 * t)) * t)
        + 0.2 * np.sin(2 * np.pi * 447.0 * t)).astype(np.float32), rate)


def _close(a, b, path=""):
    """Equal, except floats named "p" (token probabilities) within 1e-3:
    the JAX clip loop drains p through float16 (ROADMAP queue 3)."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            if k == "p":
                assert abs(a[k] - b[k]) <= 1e-3, path
            else:
                _close(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}/{i}")
    else:
        assert a == b, path


@pytest.mark.parametrize("rate,flags", [
    (16000, ["-otxt", "-osrt", "-ovtt", "-ocsv", "-olrc", "-oj"]),
    (44100, ["-otxt", "-osrt", "-ovtt", "-ocsv", "-olrc", "-ojf", "-owts",
             "--max-len", "40"]),
], ids=["16k", "44k"])
def test_cli_outputs_match_jax(pico_bin, tmp_path, rate, flags):
    """txt / srt / vtt / csv / lrc / json byte for byte (the JSON's
    systeminfo names each backend); json-full and wts (token timestamps
    on) equal in tokens and times, p within 1e-3."""
    wav = str(tmp_path / "in.wav")
    _wav(wav, rate)
    outs = {}
    for name, main, extra in (("jax", jax_main, []),
                              ("port", port_main, ["--device", "cpu"])):
        base = str(tmp_path / name)
        assert main(["-m", pico_bin, wav, "-of", base] + GREEDY + flags
                    + extra) == 0
        outs[name] = {ext: open(f"{base}.{ext}").read()
                      for ext in ("txt", "srt", "vtt", "csv", "lrc", "json",
                                  "wts") if os.path.exists(f"{base}.{ext}")}
    jo, po = outs["jax"], outs["port"]
    assert jo.keys() == po.keys() and len(jo) == len(flags) - 2 * (
        "--max-len" in flags)
    assert jo["srt"].count("-->") > 1
    for ext in ("txt", "srt", "vtt", "csv", "lrc"):
        assert po[ext] == jo[ext], ext
    port_json = po["json"].replace(toutputs.SYSTEM_INFO, JAX_SYSTEM_INFO)
    if "-oj" in flags:
        assert port_json == jo["json"]
    else:
        want = json.loads(jo["json"])
        assert all(s["tokens"] for s in want["transcription"])
        _close(json.loads(port_json), want)
        assert po["wts"] == jo["wts"]


def test_cli_refuses_parallel_and_needs_a_device(pico_bin, tmp_path):
    """-p 2 (full_parallel: two chunks decoded as one batch) writes the
    JAX CLI's transcript byte for byte; the default device is the card,
    which raises without one."""
    import torch
    wav = str(tmp_path / "in.wav")
    _wav(wav, 16000)
    txt = {}
    for name, main, extra in (("jax", jax_main, []),
                              ("port", port_main, ["--device", "cpu"])):
        base = str(tmp_path / name)
        assert main(["-m", pico_bin, wav, "-p", "2", "-otxt", "-of", base]
                    + GREEDY + extra) == 0
        with open(base + ".txt") as f:
            txt[name] = f.read()
    assert txt["port"] == txt["jax"] and txt["port"].strip()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            port_main(["-m", pico_bin, wav, "--no-prints"])
