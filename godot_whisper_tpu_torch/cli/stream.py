"""Real-time streaming CLI, the ``examples/stream`` equivalent (whisper.cpp
examples/stream/stream.cpp), port of the JAX package's ``cli/stream.py``.

Reads audio from a WAV file (replayed as a stream), a microphone
(``--mic``, ``runtime/capture.py``) or raw float32 PCM on stdin, runs the
streaming transcriber and prints partial lines and finished sentences.

    python -m godot_whisper_tpu_torch.cli.stream -m ggml-tiny.en.bin --file a.wav
    python -m godot_whisper_tpu_torch.cli.stream --synthetic tiny.en --mic \
        --capture-backend synthetic --duration 3
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gwt-stream-torch")
    p.add_argument("-m", "--model", default=None)
    p.add_argument("--synthetic", default=None, metavar="NAME")
    p.add_argument("--compute-device", default="cuda",
                   help="torch device of the model (default cuda; cpu runs "
                        "the plain PyTorch versions of the kernels)")
    p.add_argument("--file", default=None,
                   help="WAV file replayed as a realtime stream")
    p.add_argument("--step", type=float, default=0.3,
                   help="transcribe interval seconds (stream.cpp --step)")
    p.add_argument("--keep", type=float, default=0.2,
                   help="seconds kept after finalize (stream.cpp --keep)")
    p.add_argument("--max-sentence", type=float, default=15.0)
    p.add_argument("--min-sentence", type=float, default=3.0)
    p.add_argument("-l", "--language", default="en")
    p.add_argument("--prompt", default="")
    p.add_argument("--realtime", action="store_true",
                   help="pace file replay at 1x instead of max speed")
    p.add_argument("--mic", action="store_true",
                   help="capture from a microphone (runtime/capture.py: "
                        "sounddevice or arecord; the reference's SDL/"
                        "AudioEffectCapture analogue)")
    p.add_argument("--capture-backend", default="auto",
                   choices=["auto", "sounddevice", "arecord", "synthetic"],
                   help="capture backend (synthetic = paced generator "
                        "for machines without audio hardware)")
    p.add_argument("--device", default=None,
                   help="capture device name/index for --mic")
    p.add_argument("--duration", type=float, default=0.0,
                   help="stop --mic capture after N seconds (0 = Ctrl-C)")
    args = p.parse_args(argv)

    import godot_whisper_tpu_torch as gwt
    from ..runtime.cache import enable_compilation_cache
    from ..runtime.streaming import StreamingConfig, StreamingTranscriber
    enable_compilation_cache()

    if args.synthetic:
        ctx = gwt.WhisperContext.synthetic(args.synthetic,
                                           device=args.compute_device)
    elif args.model:
        ctx = gwt.WhisperContext.from_file(args.model,
                                           device=args.compute_device)
    else:
        print("error: need -m or --synthetic", file=sys.stderr)
        return 1

    def on_text(partial: bool, text: str):
        marker = "…" if partial else "✓"
        print(f"[{marker}] {text.strip()}", flush=True)

    st = StreamingTranscriber(
        ctx,
        StreamingConfig(
            initial_prompt=args.prompt,
            transcribe_interval=args.step,
            minimum_sentence_time=args.min_sentence,
            maximum_sentence_time=args.max_sentence,
            keep_seconds=args.keep,
            language=args.language),
        on_transcription=on_text,
        source_rate=gwt.SAMPLE_RATE)

    chunk = int(args.step * gwt.SAMPLE_RATE)
    if args.mic:
        # mic -> native SPSC ring -> scheduler pull each interval
        # (capture_stream_to_text.gd:69-120 / examples/stream/stream.cpp)
        from ..runtime.capture import CaptureSource
        src = CaptureSource(args.capture_backend, device=args.device)
        backend = src.start()
        print(f"[mic] capturing via {backend} into a "
              f"{type(src.ring).__name__} (Ctrl-C to stop)", file=sys.stderr)
        t_end = (time.perf_counter() + args.duration
                 if args.duration > 0 else None)
        try:
            while t_end is None or time.perf_counter() < t_end:
                time.sleep(args.step)
                st.push_audio(src.read_available())
                st.process_once()
        except KeyboardInterrupt:
            pass
        finally:
            src.stop()
        st.process_once()
    elif args.file:
        from ..audio.resample import resample
        from ..audio.wav import read_wav
        samples, rate = read_wav(args.file)
        if rate != gwt.SAMPLE_RATE:
            samples = resample(samples, rate, gwt.SAMPLE_RATE)
        for i in range(0, len(samples), chunk):
            st.push_audio(samples[i:i + chunk])
            t0 = time.perf_counter()
            st.process_once()
            if args.realtime:
                rest = args.step - (time.perf_counter() - t0)
                if rest > 0:
                    time.sleep(rest)
        # final flush
        st.process_once()
    else:
        # raw float32 PCM at 16 kHz on stdin
        while True:
            raw = sys.stdin.buffer.read(chunk * 4)
            if not raw:
                break
            st.push_audio(np.frombuffer(raw, dtype=np.float32))
            st.process_once()

    print("---")
    print(st.text().strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
