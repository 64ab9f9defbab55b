"""File-transcription CLI, the ``main`` example equivalent
(whisper.cpp examples/main/main.cpp), on the port.

    python -m godot_whisper_tpu_torch.cli.main -m ggml-tiny.en.bin audio.wav \\
        --output-srt --output-json

The JAX package's flags, one for one, plus ``--device`` (default ``cuda``;
``cpu`` runs every kernel's plain version).  ``-p N`` splits each file into
N chunks decoded as one batch (``full_parallel``).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gwt-transcribe-torch",
        description="Whisper file transcription on PyTorch / CUDA")
    p.add_argument("files", nargs="*", help="WAV inputs (resampled to "
                   "16 kHz when they are not)")
    p.add_argument("-m", "--model", default="models/ggml-base.en.bin",
                   help="ggml model path (or HF snapshot dir)")
    p.add_argument("--synthetic", metavar="NAME", default=None,
                   help="use a random-weight model of the given size "
                        "(testing without checkpoints)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu runs the "
                        "plain PyTorch versions of the kernels)")
    p.add_argument("-l", "--language", default="en",
                   help="spoken language ('auto' for detect)")
    p.add_argument("--translate", action="store_true")
    p.add_argument("-t", "--threads", type=int, default=4,
                   help="accepted for compatibility")
    p.add_argument("-p", "--processors", type=int, default=1)
    p.add_argument("--offset-t", type=int, default=0, dest="offset_ms")
    p.add_argument("-d", "--duration", type=int, default=0,
                   dest="duration_ms")
    p.add_argument("--best-of", type=int, default=5)
    p.add_argument("--beam-size", type=int, default=-1)
    p.add_argument("--audio-ctx", type=int, default=0)
    p.add_argument("--max-len", type=int, default=0)
    p.add_argument("--max-tokens", type=int, default=0)
    p.add_argument("--split-on-word", action="store_true")
    p.add_argument("--word-thold", type=float, default=0.01)
    p.add_argument("--entropy-thold", type=float, default=2.4)
    p.add_argument("--logprob-thold", type=float, default=-1.0)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--temperature-inc", type=float, default=0.2)
    p.add_argument("--prompt", default=None, help="initial prompt")
    p.add_argument("--no-timestamps", action="store_true")
    p.add_argument("--detect-language", action="store_true")
    p.add_argument("-otxt", "--output-txt", action="store_true")
    p.add_argument("-ovtt", "--output-vtt", action="store_true")
    p.add_argument("-osrt", "--output-srt", action="store_true")
    p.add_argument("-ocsv", "--output-csv", action="store_true")
    p.add_argument("-olrc", "--output-lrc", action="store_true")
    p.add_argument("-oj", "--output-json", action="store_true")
    p.add_argument("-ojf", "--output-json-full", action="store_true")
    p.add_argument("-owts", "--output-words", action="store_true",
                   help="karaoke ffmpeg script with per-token highlights "
                        "(forces token-level timestamps)")
    p.add_argument("-fp", "--font-path", default=None,
                   help="monospace font for -owts (default: the "
                        "reference's Courier New Bold path)")
    p.add_argument("-of", "--output-file", default=None,
                   help="output basename (default: input path)")
    p.add_argument("--quantize", default=None, metavar="MODE",
                   help="runtime weight quantization: int8, int4 or "
                        "int8_embed (decoder weights through the int8 / int4 "
                        "kernels)")
    p.add_argument("--print-special", action="store_true")
    p.add_argument("-pc", "--print-colors", action="store_true",
                   help="color tokens by confidence (red..green, the "
                        "reference main CLI's probability colors)")
    p.add_argument("--no-prints", action="store_true")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if not args.files:
        print("error: no input files", file=sys.stderr)
        return 1
    import godot_whisper_tpu_torch as gwt
    from ..audio.resample import resample
    from ..audio.wav import read_wav
    from ..runtime.cache import enable_compilation_cache
    from . import outputs

    enable_compilation_cache()
    kw = dict(quantize=args.quantize, device=args.device)
    if args.synthetic:
        ctx = gwt.WhisperContext.synthetic(args.synthetic, **kw)
    elif os.path.isdir(args.model):
        ctx = gwt.WhisperContext.from_hf(args.model, **kw)
    else:
        ctx = gwt.WhisperContext.from_file(args.model, **kw)

    strategy = (gwt.SamplingStrategy.BEAM_SEARCH if args.beam_size > 1
                else gwt.SamplingStrategy.GREEDY)
    tparams = gwt.TranscribeParams(
        strategy=strategy,
        language=args.language,
        translate=args.translate,
        offset_ms=args.offset_ms,
        duration_ms=args.duration_ms,
        best_of=args.best_of,
        beam_size=args.beam_size if args.beam_size > 1 else 5,
        audio_ctx=args.audio_ctx,
        max_len=args.max_len,
        max_tokens=args.max_tokens,
        split_on_word=args.split_on_word,
        thold_pt=args.word_thold,
        entropy_thold=args.entropy_thold,
        logprob_thold=args.logprob_thold,
        temperature=args.temperature,
        temperature_inc=args.temperature_inc,
        initial_prompt=args.prompt,
        no_timestamps=args.no_timestamps,
        detect_language=args.detect_language,
        token_timestamps=(args.max_len > 0 or args.output_json_full
                          or args.output_words),
        print_special=args.print_special,
    )

    for path in args.files:
        samples, rate = read_wav(path)
        if rate != gwt.SAMPLE_RATE:
            samples = resample(samples, rate, gwt.SAMPLE_RATE)
        if args.processors > 1:
            segments = ctx.full_parallel(tparams, samples, args.processors)
        else:
            segments = ctx.full(tparams, samples)

        if args.detect_language:
            lid = ctx.full_lang_id()
            print(f"detected language: {gwt.lang_str(lid)} "
                  f"({gwt.lang_str_full(lid)})")
            continue

        if not args.no_prints:
            for s in segments:
                head = f"[{outputs._ts(s.t0)} --> {outputs._ts(s.t1)}] "
                if args.print_colors:
                    # probability-colored tokens (examples/main/main.cpp
                    # :17-22, 320-325: a 10-step red->green ramp by p^3)
                    body = "".join(
                        f"{outputs.color_for_p(td.p)}"
                        f"{ctx.token_to_str(td.id)}\033[0m"
                        for td in s.tokens
                        if args.print_special
                        or td.id < ctx.config.token_eot)
                    print(head + body.strip())
                else:
                    print(head + s.text.strip())

        base = args.output_file or path
        writers = [
            (args.output_txt, ".txt", lambda: outputs.to_txt(segments)),
            (args.output_vtt, ".vtt", lambda: outputs.to_vtt(segments)),
            (args.output_srt, ".srt", lambda: outputs.to_srt(segments)),
            (args.output_csv, ".csv", lambda: outputs.to_csv(segments)),
            (args.output_lrc, ".lrc", lambda: outputs.to_lrc(segments)),
            (args.output_json or args.output_json_full, ".json",
             lambda: outputs.to_json(segments,
                                     model_name=ctx.config.name,
                                     language=args.language,
                                     full=args.output_json_full)),
            (args.output_words, ".wts",
             lambda: outputs.to_wts(
                 segments, input_path=path,
                 duration_sec=len(samples) / gwt.SAMPLE_RATE,
                 token_to_str=ctx.token_to_str,
                 eot=ctx.config.token_eot,
                 font_path=(args.font_path
                            or outputs.DEFAULT_WTS_FONT))),
        ]
        for enabled, ext, fn in writers:
            if enabled:
                out_path = base + ext
                with open(out_path, "w") as f:
                    f.write(fn())
                if not args.no_prints:
                    print(f"output written to {out_path}", file=sys.stderr)

    if not args.no_prints:
        ctx.print_timings()
    return 0


if __name__ == "__main__":
    sys.exit(main())
