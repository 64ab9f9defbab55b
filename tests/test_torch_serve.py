"""The port's HTTP server (cli/serve.py) and batch CLI (cli/batch.py) on
the CPU, over real HTTP on 127.0.0.1, against the JAX package's server.

Weights: the JAX suite's pico checkpoint (1 audio + 1 text layer, width
64; one text layer marks it distilled, so it decodes without timestamps)
from init_params(seed=0), with the decoder's final LayerNorm gain at 30x
and its bias moved by 35 along the end-of-text embedding (35 e / |e|^2,
which adds 35 to that token's logit), written by the JAX exporter as F32.
The server's requests keep the default temperature ladder and logprob
gate.  At the random init's logit spread every window falls through to the
sampling rungs, whose noise the two packages draw differently; with the
gain the decoder is confident and with the bias it ends a window after a
token or two, so every window settles on the t = 0 rung, where the two
packages must agree.  Every answer of the port's server (each response
format, the micro-batched requests) and every file of gwt-batch is held
byte for byte to the JAX package's, and also to the port's own pipeline,
BatchTranscriber and writers."""

import json
import os
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import godot_whisper_tpu as jgwt
import godot_whisper_tpu_torch as gt
from godot_whisper_tpu.audio.mel import mel_filterbank
from godot_whisper_tpu.audio.tokenizer import synthetic_vocab
from godot_whisper_tpu.audio.wav import write_wav
from godot_whisper_tpu.cli import serve as jax_serve
from godot_whisper_tpu.models import loader_ggml
from godot_whisper_tpu.models.export_ggml import export_checkpoint
from godot_whisper_tpu.models.params import init_params
from godot_whisper_tpu_torch.cli import batch as port_batch
from godot_whisper_tpu_torch.cli import serve as port_serve
from godot_whisper_tpu_torch.parallel import batch as port_batch_mod


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
                      synthetic_vocab(cfg), ttype=loader_ggml.GGML_TYPE_F32)
    return path


@pytest.fixture(scope="module")
def jax_ctx(pico_bin):
    return jgwt.WhisperContext.from_file(pico_bin)


@pytest.fixture(scope="module")
def ctx(pico_bin):
    return gt.WhisperContext.from_file(pico_bin, device="cpu")


def _wav_bytes(tmp_path, name, seconds, f0):
    t = np.arange(int(seconds * 16000)) / 16000.0
    x = (0.3 * np.sin(2 * np.pi * (f0 + 60 * np.sin(2 * np.pi * 0.07 * t))
                      * t)
         + 0.2 * np.sin(2 * np.pi * 447.0 * t)).astype(np.float32)
    path = str(tmp_path / name)
    write_wav(path, x)
    with open(path, "rb") as f:
        return f.read()


class _Serving:
    """A server on 127.0.0.1 at a free port, shut down on exit."""

    def __init__(self, mod, server):
        self.server = server
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                         mod.make_handler(server))
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=30)
        if hasattr(self.server, "close"):
            self.server.close()

    def post(self, path, data, ctype=None):
        req = urllib.request.Request(self.url + path, data=data,
                                     method="POST")
        if ctype:
            req.add_header("Content-Type", ctype)
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.headers["Content-Type"], r.read().decode()


def _server_params(**kw):
    """The TranscribeParams the server builds for /inference?temperature=0
    (cli/serve.py handle_inference)."""
    return gt.TranscribeParams(
        strategy=gt.SamplingStrategy.GREEDY, language="en", translate=False,
        best_of=5, beam_size=5, temperature=0.0, initial_prompt=None,
        print_progress=False, **kw)


P_TOL = 5e-3


def _same_json(got, want, key=None):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            if k != "systeminfo":  # names the package and its backend
                _same_json(got[k], want[k], k)
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same_json(g, w, key)
    elif key == "p":
        assert abs(got - want) <= P_TOL, (got, want)
    else:
        assert got == want, key


def _same_answer(got, want):
    """The JAX server's answer byte for byte, except in verbose_json: its
    "systeminfo" names the package, and a token's "p" is held within
    P_TOL (the JAX package ships p to the host as float16, and the 30x
    gain scales the two packages' f32 rounding in the logits; measured
    2.2e-3)."""
    assert got[:2] == want[:2]
    if '"systeminfo"' in want[2]:
        _same_json(json.loads(got[2]), json.loads(want[2]))
    else:
        assert got[2] == want[2]


def _form(wav, boundary="gwtboundary"):
    body = (f"--{boundary}\r\nContent-Disposition: form-data; "
            'name="response_format"\r\n\r\ntext\r\n'
            f"--{boundary}\r\nContent-Disposition: form-data; "
            'name="file"; filename="a.wav"\r\n\r\n').encode() \
        + wav + f"\r\n--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


def test_server_endpoints(ctx, jax_ctx, tmp_path):
    """/health, and /inference in every response format (a raw WAV body
    and a multipart form): the port's answers equal the JAX server's byte
    for byte (status, content type and body; ``_same_answer``), and are its own
    pipeline's segments through its writers."""
    from godot_whisper_tpu_torch.cli import outputs
    wav = _wav_bytes(tmp_path, "a.wav", 2.0, 220.0)
    fmts = ("json", "text", "srt", "vtt", "verbose_json")
    answers = {}
    ctx.pipeline._prompt_past = []
    jax_ctx.pipeline._prompt_past = []
    for name, mod, c in (("jax", jax_serve, jax_ctx),
                         ("port", port_serve, ctx)):
        with _Serving(mod, mod.TranscriptionServer(c)) as srv:
            with urllib.request.urlopen(srv.url + "/health",
                                        timeout=60) as r:
                assert json.loads(r.read())["status"] == "ok"
            got = {fmt: srv.post(f"/inference?temperature=0&"
                                 f"response_format={fmt}", wav)
                   for fmt in fmts}
            got["form"] = srv.post("/inference?temperature=0", *_form(wav))
            answers[name] = got
    port, want = answers["port"], answers["jax"]
    for fmt in fmts + ("form",):
        _same_answer(port[fmt], want[fmt])
    assert json.loads(port["json"][2]).keys() == {"text"}

    # the requests again, in order, through the pipeline: prompt_past
    # carries from one request to the next, as in the server
    from godot_whisper_tpu_torch.audio.wav import read_wav
    samples, _ = read_wav(str(tmp_path / "a.wav"))
    ctx.pipeline._prompt_past = []
    for fmt in fmts + ("form",):
        segs = list(ctx.full(_server_params(), samples))
        body = {"json": lambda: json.dumps(
                    {"text": "".join(x.text for x in segs)}) + "\n",
                "text": lambda: outputs.to_txt(segs),
                "form": lambda: outputs.to_txt(segs),
                "srt": lambda: outputs.to_srt(segs),
                "vtt": lambda: outputs.to_vtt(segs),
                "verbose_json": lambda: outputs.to_json(
                    segs, model_name=ctx.config.name, language="en",
                    full=True)}[fmt]
        assert port[fmt][2] == body(), fmt
    assert json.loads(port["json"][2])["text"]


def _concurrent_posts(srv, wavs, fmts):
    """POST every WAV at once, each asking for its own response format
    (the format is not part of the batch key)."""
    results = [None] * len(wavs)

    def post(i):
        results[i] = srv.post(f"/inference?temperature=0&"
                              f"response_format={fmts[i]}", wavs[i])

    threads = [threading.Thread(target=post, args=(i,))
               for i in range(len(wavs))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(300)
    assert not any(th.is_alive() for th in threads)
    return results


def test_server_micro_batching(ctx, jax_ctx, tmp_path, monkeypatch):
    """Four concurrent requests within the 300 ms window, each asking for
    another response format: at least two decode in one batch (the JAX
    suite's check, on a loaded CPU), every request is decoded once, each
    caller gets its own stream's result, and every answer equals the JAX
    server's for the same requests byte for byte (``_same_answer``)."""
    from godot_whisper_tpu.parallel import batch as jax_batch_mod
    from godot_whisper_tpu_torch.audio.wav import read_wav
    from godot_whisper_tpu_torch.cli import outputs
    wavs = [_wav_bytes(tmp_path, f"r{i}.wav", 1.2 + 0.2 * i, 200.0 + 60 * i)
            for i in range(4)]
    fmts = ("srt", "vtt", "verbose_json", "json")
    samples = [read_wav(str(tmp_path / f"r{i}.wav"))[0] for i in range(4)]
    answers, batches = {}, {"jax": [], "port": []}
    for name, mod, bmod, c in (
            ("jax", jax_serve, jax_batch_mod, jax_ctx),
            ("port", port_serve, port_batch_mod, ctx)):
        orig = bmod.BatchTranscriber.transcribe

        def spy(self, clips, tparams=None, orig=orig, name=name):
            out = orig(self, clips, tparams)
            batches[name].append((clips, out))
            return out

        monkeypatch.setattr(bmod.BatchTranscriber, "transcribe", spy)
        c.pipeline._prompt_past = []
        server = mod.TranscriptionServer(c, batch_window_ms=300,
                                         max_batch=4)
        with _Serving(mod, server) as srv:
            answers[name] = _concurrent_posts(srv, wavs, fmts)
        monkeypatch.setattr(bmod.BatchTranscriber, "transcribe", orig)
    assert server._thread is None
    for got, want in zip(answers["port"], answers["jax"]):
        _same_answer(got, want)
    for name in ("jax", "port"):
        sizes = [len(c) for c, _ in batches[name]]
        assert max(sizes) >= 2 and sum(sizes) == 4, (name, sizes)
    for i in range(4):
        segs = [o for clips, outs in batches["port"]
                for c, o in zip(clips, outs) if np.array_equal(c, samples[i])]
        assert len(segs) == 1
        body = {"srt": lambda: outputs.to_srt(segs[0]),
                "vtt": lambda: outputs.to_vtt(segs[0]),
                "verbose_json": lambda: outputs.to_json(
                    segs[0], model_name=ctx.config.name, language="en",
                    full=True),
                "json": lambda: json.dumps(
                    {"text": "".join(x.text for x in segs[0])}) + "\n"}
        ctype = "application/json" if "json" in fmts[i] else "text/plain"
        assert answers["port"][i] == (200, ctype, body[fmts[i]]()), i


def test_server_load_and_errors(ctx, pico_bin, tmp_path):
    """/load swaps the model (on the same device); an empty body is a 400,
    an unknown path a 404, and a bad request a JSON 500 with the server
    still answering."""
    server = port_serve.TranscriptionServer(ctx)
    with _Serving(port_serve, server) as srv:
        status, _, body = srv.post("/load", json.dumps(
            {"model": pico_bin}).encode())
        assert status == 200 and json.loads(body) == {
            "status": "ok", "model": ctx.config.name}
        assert server.ctx is not ctx
        assert server.ctx.pipeline.device == ctx.pipeline.device
        for path, data, code in (("/inference", b"", 400),
                                 ("/nope", b"x", 404),
                                 ("/inference", b"not a wav", 500)):
            with pytest.raises(urllib.error.HTTPError) as e:
                srv.post(path, data)
            assert e.value.code == code
        wav = _wav_bytes(tmp_path, "b.wav", 1.2, 300.0)
        assert srv.post("/inference", wav)[0] == 200


def test_batch_cli(ctx, pico_bin, tmp_path, monkeypatch):
    """gwt-batch over a directory of three WAVs of ragged lengths in
    batches of two: each srt file equals the JAX package's gwt-batch byte
    for byte, and is the port's BatchTranscriber and writer for the same
    batches; the multi-process flags raise without a process group, and
    a tp that does not divide the heads raises."""
    from godot_whisper_tpu.cli import batch as jax_batch
    from godot_whisper_tpu.runtime import cache as jax_cache
    from godot_whisper_tpu_torch.audio.wav import read_wav
    from godot_whisper_tpu_torch.cli import outputs
    # the JAX CLI would point JAX's compilation cache at the home directory
    monkeypatch.setattr(jax_cache, "enable_compilation_cache",
                        lambda *a, **k: None)
    wav_dir = tmp_path / "wavs"
    wav_dir.mkdir()
    for i, (sec, f0) in enumerate(((2.0, 220.0), (1.4, 300.0),
                                   (2.6, 180.0))):
        _wav_bytes(wav_dir, f"c{i}.wav", sec, f0)
    out, jax_out = tmp_path / "out", tmp_path / "jax_out"
    args = [str(wav_dir), "-m", pico_bin, "-b", "2", "--output-format",
            "srt"]
    assert port_batch.main(args + ["--device", "cpu", "-o", str(out)]) == 0
    assert jax_batch.main(args + ["-o", str(jax_out)]) == 0
    names = sorted(os.listdir(wav_dir))
    assert sorted(os.listdir(out)) == sorted(os.listdir(jax_out)) == \
        [n[:-4] + ".srt" for n in names]
    clips = [read_wav(str(wav_dir / n))[0] for n in names]
    bt = port_batch_mod.BatchTranscriber(ctx)
    p = gt.TranscribeParams(language="en", print_progress=False)
    want = bt.transcribe(clips[:2], p) + bt.transcribe(clips[2:], p)
    for n, segs in zip(names, want):
        with open(out / (n[:-4] + ".srt")) as f:
            got = f.read()
        with open(jax_out / (n[:-4] + ".srt")) as f:
            assert got == f.read(), n
        assert got == outputs.to_srt(segs), n
    assert all(want)
    for flags, match in ((["--num-processes", "2"], "need --coordinator"),
                         (["--process-id", "1"], "need --coordinator"),
                         (["--backend", "gloo"], "need --coordinator"),
                         (["--tp", "3"], "must divide n_audio_head=2"),
                         (["--tp", "2"], "needs a multi-process run")):
        with pytest.raises(ValueError, match=match):
            port_batch.main([str(wav_dir), "-m", pico_bin, "--device",
                             "cpu"] + flags)
