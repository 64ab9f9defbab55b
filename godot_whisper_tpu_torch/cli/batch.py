"""Bulk batch transcription on one card, port of the JAX package's
``cli/batch.py``: a directory of WAV files in batches of streams
(``parallel/batch.py``), one transcript file each.

    python -m godot_whisper_tpu_torch.cli.batch -m model.bin wavs/ -o out/ \\
        --batch-size 8 --output-format srt

The JAX package's multi-host flags (``--coordinator``, ``--num-processes``,
``--process-id``, ``--tp`` above 1) need the port of ``parallel/dist.py``
and ``parallel/sharding.py``; until then they raise NotImplementedError.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="gwt-batch-torch")
    p.add_argument("input_dir", help="directory of .wav files")
    p.add_argument("-m", "--model", default=None)
    p.add_argument("--synthetic", default=None, metavar="NAME")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch versions of the kernels)")
    p.add_argument("-o", "--out-dir", default=None)
    p.add_argument("-b", "--batch-size", type=int, default=8)
    p.add_argument("-l", "--language", default="en")
    p.add_argument("--output-format", default="txt",
                   choices=["txt", "srt", "vtt", "json", "csv", "lrc"])
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="multi-host coordinator (not ported yet)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel width (only 1 is ported)")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if (args.coordinator or os.environ.get("GWT_COORDINATOR")
            or args.num_processes is not None or args.process_id is not None
            or args.tp > 1):
        raise NotImplementedError(
            "multi-host and tensor-parallel batching run on "
            "parallel/dist.py and parallel/sharding.py, which are not "
            "ported to godot_whisper_tpu_torch yet")

    import godot_whisper_tpu_torch as gwt
    from ..audio.resample import resample
    from ..audio.wav import read_wav
    from ..parallel.batch import BatchTranscriber
    from ..runtime.cache import enable_compilation_cache
    from . import outputs
    enable_compilation_cache()

    if args.synthetic:
        ctx = gwt.WhisperContext.synthetic(args.synthetic, device=args.device)
    elif args.model:
        ctx = gwt.WhisperContext.from_file(args.model, device=args.device)
    else:
        print("error: need -m or --synthetic", file=sys.stderr)
        return 1

    wavs = sorted(glob.glob(os.path.join(args.input_dir, "*.wav")))
    if args.limit:
        wavs = wavs[:args.limit]
    if not wavs:
        print("no .wav files found", file=sys.stderr)
        return 1
    out_dir = args.out_dir or args.input_dir
    os.makedirs(out_dir, exist_ok=True)

    writers = {"txt": outputs.to_txt, "srt": outputs.to_srt,
               "vtt": outputs.to_vtt, "csv": outputs.to_csv,
               "lrc": outputs.to_lrc,
               "json": lambda s: outputs.to_json(
                   s, model_name=ctx.config.name, language=args.language)}
    write = writers[args.output_format]
    tparams = gwt.TranscribeParams(language=args.language,
                                   print_progress=False)
    bt = BatchTranscriber(ctx)

    total_audio = 0.0
    t_start = time.perf_counter()
    for i in range(0, len(wavs), args.batch_size):
        group = wavs[i:i + args.batch_size]
        clips = []
        for wav in group:
            samples, rate = read_wav(wav)
            if rate != gwt.SAMPLE_RATE:
                samples = resample(samples, rate, gwt.SAMPLE_RATE)
            clips.append(samples)
            total_audio += len(samples) / gwt.SAMPLE_RATE
        for wav, segs in zip(group, bt.transcribe(clips, tparams)):
            base = os.path.splitext(os.path.basename(wav))[0]
            with open(os.path.join(out_dir, base + "." + args.output_format),
                      "w") as f:
                f.write(write(segs))
        print(f"[{min(i + args.batch_size, len(wavs))}/{len(wavs)}] done",
              file=sys.stderr)

    dt = time.perf_counter() - t_start
    print(f"{len(wavs)} files, {total_audio:.1f}s audio in {dt:.1f}s "
          f"({total_audio / dt:.1f} audio-s/s)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
