"""Voice-command recognition — the ``examples/command`` equivalent
(whisper.cpp examples/command), port of the JAX package's
``cli/command.py``: constrain or match short utterances against a fixed
command list.

Two modes, like the reference:
- free-form: transcribe the chunk, fuzzy-match against the command list;
- grammar-constrained: build a GBNF grammar from the commands so decoding
  can only produce a listed command (decode/grammar.py, through the
  host-stepped decoder).

    python -m godot_whisper_tpu_torch.cli.command -m model.bin \
        --commands "turn on the light,turn off the light,stop" --file a.wav \
        --use-grammar
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Tuple


def commands_to_gbnf(commands: List[str]) -> str:
    """Build a root ::= alternation grammar over the command strings."""
    def esc(s: str) -> str:
        return s.replace("\\", "\\\\").replace('"', '\\"')

    alts = " | ".join(f'" {esc(c.strip())}"' for c in commands if c.strip())
    return f"root ::= {alts}\n"


def best_command(text: str, commands: List[str]) -> Tuple[Optional[str],
                                                          float]:
    """Fuzzy match: highest word-overlap similarity (the reference scores
    token probability sums; word-level Jaccard is the text analogue)."""
    from .eval import normalize_text

    words = set(normalize_text(text).split())
    best, score = None, 0.0
    for cmd in commands:
        cw = set(normalize_text(cmd).split())
        if not cw:
            continue
        sim = len(words & cw) / len(words | cw) if words | cw else 0.0
        if sim > score:
            best, score = cmd, sim
    return best, score


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gwt-command-torch")
    p.add_argument("-m", "--model", default=None)
    p.add_argument("--synthetic", default=None, metavar="NAME")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch versions of the kernels)")
    p.add_argument("--commands", required=True,
                   help="comma-separated command list")
    p.add_argument("--file", required=True, help="WAV utterance")
    p.add_argument("--use-grammar", action="store_true",
                   help="constrain decoding with a GBNF grammar")
    p.add_argument("--threshold", type=float, default=0.3)
    args = p.parse_args(argv)

    import godot_whisper_tpu_torch as gwt
    from ..audio.resample import resample
    from ..audio.wav import read_wav
    from ..runtime.cache import enable_compilation_cache
    enable_compilation_cache()

    if args.synthetic:
        ctx = gwt.WhisperContext.synthetic(args.synthetic, device=args.device)
    elif args.model:
        ctx = gwt.WhisperContext.from_file(args.model, device=args.device)
    else:
        print("error: need -m or --synthetic", file=sys.stderr)
        return 1

    commands = [c.strip() for c in args.commands.split(",") if c.strip()]
    samples, rate = read_wav(args.file)
    if rate != gwt.SAMPLE_RATE:
        samples = resample(samples, rate, gwt.SAMPLE_RATE)

    tparams = gwt.TranscribeParams(
        best_of=1, single_segment=True, no_timestamps=True,
        print_progress=False,
        grammar_rules=commands_to_gbnf(commands) if args.use_grammar
        else None)
    segs = ctx.full(tparams, samples)
    text = "".join(s.text for s in segs)

    cmd, score = best_command(text, commands)
    print(f"heard: {text.strip()!r}")
    if cmd is not None and score >= args.threshold:
        print(f"command: {cmd} (score {score:.2f})")
        return 0
    print("command: <none>")
    return 3


if __name__ == "__main__":
    sys.exit(main())
