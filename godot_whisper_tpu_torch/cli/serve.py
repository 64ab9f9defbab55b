"""HTTP transcription server, the ``examples/server`` equivalent
(whisper.cpp examples/server/server.cpp), port of the JAX package's
``cli/serve.py``.

Endpoints (the reference's):
  POST /inference   body = WAV bytes (or multipart field "file");
                    query / form params: language, translate, beam_size,
                    best_of, temperature, prompt, response_format (json |
                    text | srt | vtt | verbose_json)
  POST /load        {"model": "path.bin"}: swap the loaded model
  GET  /health      liveness probe

Standard library ``http.server`` only.  One lock serializes the work on the
card (whisper_context is not thread-safe, whisper.h:44-45).

    python -m godot_whisper_tpu_torch.cli.serve -m model.bin \\
        --batch-window-ms 100
"""

from __future__ import annotations

import argparse
import json
import queue
import re
import sys
import tempfile
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional


def _parse_multipart(body: bytes, content_type: str):
    """Minimal multipart/form-data parser returning {name: bytes}."""
    m = re.search(r'boundary="?([^";]+)"?', content_type)
    if not m:
        return {}
    boundary = ("--" + m.group(1)).encode()
    out = {}
    for part in body.split(boundary):
        if b"\r\n\r\n" not in part:
            continue
        head, _, payload = part.partition(b"\r\n\r\n")
        name_m = re.search(rb'name="([^"]+)"', head)
        if name_m:
            out[name_m.group(1).decode()] = payload.rstrip(b"\r\n-")
    return out


class TranscriptionServer:
    """``batch_window_ms > 0`` turns on micro-batching: concurrent requests
    that arrive within the window and share their decode parameters are
    decoded as ONE batch of streams (``parallel/batch.py``) by a dispatch
    thread, up to ``max_batch`` at a time."""

    def __init__(self, ctx, batch_window_ms: float = 0.0,
                 max_batch: int = 8):
        self.ctx = ctx
        self.lock = threading.Lock()  # serializes work on the card
        self.batch_window = batch_window_ms / 1e3
        self.max_batch = max_batch
        self._bt = None
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        if self.batch_window > 0:
            self._queue = queue.Queue()
            self._carry: list = []
            self._thread = threading.Thread(target=self._dispatch_loop,
                                            daemon=True,
                                            name="gwt-serve-dispatch")
            self._thread.start()

    def close(self) -> None:
        """Stop the dispatch thread (after the requests queued before)."""
        if self._thread is not None:
            self._queue.put(None)
            self._thread.join(timeout=60)
            self._thread = None

    # ------------------------------------------------------- micro-batching
    @staticmethod
    def _batch_key(tp):
        return (tp.strategy, tp.language, tp.translate, tp.best_of,
                tp.beam_size, tp.temperature, tp.initial_prompt)

    def _transcribe(self, samples, tparams):
        if self._queue is None:
            with self.lock:
                return self.ctx.full(tparams, samples)
        req = {"samples": samples, "tp": tparams,
               "ev": threading.Event(), "out": None, "err": None}
        self._queue.put(req)
        req["ev"].wait()
        if req["err"] is not None:
            raise req["err"]
        return req["out"]

    def _next_group(self):
        """The next batch: the oldest request, then requests with its
        parameters that arrive within the window; requests with other
        parameters wait in ``_carry`` for a later batch.  None stops."""
        first = self._carry.pop(0) if self._carry else self._queue.get()
        if first is None:
            return None
        group = [first]
        key = self._batch_key(first["tp"])
        deadline = time.perf_counter() + self.batch_window
        while len(group) < self.max_batch:
            nxt = next((c for c in self._carry
                        if self._batch_key(c["tp"]) == key), None)
            if nxt is not None:
                self._carry.remove(nxt)
                group.append(nxt)
                continue
            rem = deadline - time.perf_counter()
            if rem <= 0:
                break
            try:
                cand = self._queue.get(timeout=rem)
            except queue.Empty:
                break
            if cand is None:
                self._queue.put(None)  # stop after this batch
                break
            if self._batch_key(cand["tp"]) == key:
                group.append(cand)
            else:
                self._carry.append(cand)
        return group

    def _dispatch_loop(self):
        from ..parallel.batch import BatchTranscriber
        while True:
            group = self._next_group()
            if group is None:
                return
            try:
                with self.lock:
                    if self._bt is None or self._bt.ctx is not self.ctx:
                        self._bt = BatchTranscriber(self.ctx)
                    results = self._bt.transcribe(
                        [g["samples"] for g in group], group[0]["tp"])
                for g, segs in zip(group, results):
                    g["out"] = segs
            except Exception as e:  # each caller gets the error
                for g in group:
                    g["err"] = e
            for g in group:
                g["ev"].set()

    # -------------------------------------------------------------- handlers
    def handle_inference(self, audio_bytes: bytes, params: dict) -> tuple:
        import godot_whisper_tpu_torch as gwt
        from ..audio.resample import resample
        from ..audio.wav import read_wav
        from . import outputs

        with tempfile.NamedTemporaryFile(suffix=".wav") as f:
            f.write(audio_bytes)
            f.flush()
            samples, rate = read_wav(f.name)
        if rate != gwt.SAMPLE_RATE:
            samples = resample(samples, rate, gwt.SAMPLE_RATE)

        beam_size = int(params.get("beam_size", -1))
        tparams = gwt.TranscribeParams(
            strategy=(gwt.SamplingStrategy.BEAM_SEARCH if beam_size > 1
                      else gwt.SamplingStrategy.GREEDY),
            language=params.get("language", "en"),
            translate=params.get("translate", "false") == "true",
            best_of=int(params.get("best_of", 5)),
            beam_size=beam_size if beam_size > 1 else 5,
            temperature=float(params.get("temperature", 0.0)),
            initial_prompt=params.get("prompt") or None,
            print_progress=False,
        )
        segments = self._transcribe(samples, tparams)

        fmt = params.get("response_format", "json")
        if fmt == "text":
            return outputs.to_txt(segments), "text/plain"
        if fmt == "srt":
            return outputs.to_srt(segments), "text/plain"
        if fmt == "vtt":
            return outputs.to_vtt(segments), "text/plain"
        if fmt == "verbose_json":
            return outputs.to_json(
                segments, model_name=self.ctx.config.name,
                language=tparams.language, full=True), "application/json"
        return (json.dumps({"text": "".join(s.text for s in segments)})
                + "\n", "application/json")

    def handle_load(self, body: dict) -> dict:
        import godot_whisper_tpu_torch as gwt
        with self.lock:
            self.ctx = gwt.WhisperContext.from_file(
                body["model"], device=self.ctx.pipeline.device)
        return {"status": "ok", "model": self.ctx.config.name}


def make_handler(server: TranscriptionServer):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: str,
                  ctype: str = "application/json"):
            data = payload.encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def do_GET(self):
            if self.path.startswith("/health"):
                self._send(200, '{"status":"ok"}\n')
            else:
                self._send(404, '{"error":"not found"}\n')

        def do_POST(self):
            body = self.rfile.read(int(self.headers.get("Content-Length",
                                                        0)))
            parsed = urllib.parse.urlparse(self.path)
            params = {k: v[0] for k, v in
                      urllib.parse.parse_qs(parsed.query).items()}
            try:
                if parsed.path == "/inference":
                    ctype = self.headers.get("Content-Type", "")
                    audio = body
                    if ctype.startswith("multipart/form-data"):
                        fields = _parse_multipart(body, ctype)
                        audio = fields.pop("file", b"")
                        params.update({k: v.decode()
                                       for k, v in fields.items()})
                    if not audio:
                        self._send(400, '{"error":"no audio"}\n')
                        return
                    payload, ctype_out = server.handle_inference(audio,
                                                                 params)
                    self._send(200, payload, ctype_out)
                elif parsed.path == "/load":
                    result = server.handle_load(json.loads(body or b"{}"))
                    self._send(200, json.dumps(result) + "\n")
                else:
                    self._send(404, '{"error":"not found"}\n')
            except Exception as e:  # answer with the error, keep serving
                self._send(500, json.dumps({"error": str(e)}) + "\n")

    return Handler


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="gwt-serve-torch")
    p.add_argument("-m", "--model", default=None, help="ggml model path")
    p.add_argument("--synthetic", default=None, metavar="NAME")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch versions of the kernels)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--batch-window-ms", type=float, default=0.0,
                   help="decode concurrent requests that arrive within this "
                        "window as one batch (0 = off)")
    p.add_argument("--max-batch", type=int, default=8)
    args = p.parse_args(argv)

    import godot_whisper_tpu_torch as gwt
    if args.synthetic:
        ctx = gwt.WhisperContext.synthetic(args.synthetic, device=args.device)
    elif args.model:
        ctx = gwt.WhisperContext.from_file(args.model, device=args.device)
    else:
        print("error: need -m or --synthetic", file=sys.stderr)
        return 1

    server = TranscriptionServer(ctx, batch_window_ms=args.batch_window_ms,
                                 max_batch=args.max_batch)
    httpd = ThreadingHTTPServer((args.host, args.port), make_handler(server))
    print(f"listening on http://{args.host}:{args.port}")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        server.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
