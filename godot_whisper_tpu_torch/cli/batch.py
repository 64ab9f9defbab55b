"""Bulk batch transcription, port of the JAX package's ``cli/batch.py``:
a directory of WAV files in batches of streams (``parallel/batch.py``),
one transcript file each.

    python -m godot_whisper_tpu_torch.cli.batch -m model.bin wavs/ -o out/ \\
        --batch-size 8 --output-format srt

Multiple processes, one device each (``parallel/dist.py``): run the same
command in every process with ``--coordinator HOST:PORT --num-processes N
--process-id I`` (or the ``GWT_*`` variables, or under torchrun, which
sets RANK / WORLD_SIZE), and ``--tp T`` to shard the weights over groups
of T processes.  Each process takes an interleaved share of the files
(``files[rank::world]``), a tp group decodes its ranks' files together,
and every process runs the agreed maximum number of rounds.
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
                   help="multi-process: the coordinator address (or set "
                        "GWT_COORDINATOR); run the same command in every "
                        "process with --num-processes / --process-id")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel width (multi-process mode)")
    p.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                   help="multi-process: the torch.distributed backend "
                        "(default nccl on the card, gloo on the CPU; ranks "
                        "that share one card need gloo)")
    return p


def _multi_process(args) -> bool:
    """Whether this run joins a process group; flags that need one without
    it raise."""
    if args.coordinator or os.environ.get("GWT_COORDINATOR"):
        return True
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return True   # torchrun
    if (args.num_processes is not None or args.process_id is not None
            or args.backend is not None):
        raise ValueError("--num-processes / --process-id / --backend need "
                         "--coordinator (or GWT_COORDINATOR, or torchrun)")
    return False


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    multi = _multi_process(args)
    from ..parallel import dist
    device = args.device
    if multi:
        dist.initialize(coordinator_address=args.coordinator,
                        num_processes=args.num_processes,
                        process_id=args.process_id, backend=args.backend,
                        device=args.device)
        device = dist.rank_device(args.device)

    import godot_whisper_tpu_torch as gwt
    from ..audio.resample import resample
    from ..audio.wav import read_wav
    from ..parallel.batch import BatchTranscriber
    from ..parallel.sharding import check_tp
    from ..runtime.cache import enable_compilation_cache
    from . import outputs
    enable_compilation_cache()

    if args.synthetic:
        ctx = gwt.WhisperContext.synthetic(args.synthetic, device=device)
    elif args.model:
        ctx = gwt.WhisperContext.from_file(args.model, device=device)
    else:
        print("error: need -m or --synthetic", file=sys.stderr)
        return 1
    check_tp(ctx.config, args.tp)
    if args.tp > 1 and not multi:
        raise ValueError("--tp above 1 needs a multi-process run "
                         "(--coordinator, GWT_COORDINATOR or torchrun)")

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
    n_rounds = len(wavs)
    if multi:
        # each process takes an interleaved share of the files; every
        # process runs the same number of rounds (each round is a
        # collective), surplus rounds with no local files
        mesh = dist.stream_mesh(args.tp, device=device)
        bt = dist.MultiHostBatchTranscriber(ctx, mesh)
        wavs = wavs[mesh.rank::mesh.world]
        n_rounds = max(dist._allgather_host(len(wavs), mesh))
    else:
        bt = BatchTranscriber(ctx)

    total_audio = 0.0
    t_start = time.perf_counter()
    for i in range(0, n_rounds, args.batch_size):
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
        print(f"[{min(i + args.batch_size, n_rounds)}/{n_rounds}] done",
              file=sys.stderr)

    dt = time.perf_counter() - t_start
    print(f"{len(wavs)} files, {total_audio:.1f}s audio in {dt:.1f}s "
          f"({total_audio / dt:.1f} audio-s/s)", file=sys.stderr)
    if multi:
        dist.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
