"""WER evaluation harness, port of the JAX package's ``cli/eval.py``.

The reference verifies quality by transcript diffs against checked-in
references (whisper.cpp tests/run-tests.sh); this tool makes that
quantitative: word error rate over a directory of (wav, txt) pairs, with
the standard Whisper text normalization applied to both sides.

    python -m godot_whisper_tpu_torch.cli.eval -m ggml-tiny.en.bin data_dir/
    # data_dir/x.wav + data_dir/x.txt per utterance; --device cpu runs the
    # plain PyTorch versions of the kernels

Also usable as a library: ``word_error_rate(ref, hyp)``.
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import sys
import unicodedata
from typing import List, Tuple


def normalize_text(text: str) -> str:
    """Basic English text normalization (lowercase, strip punctuation and
    bracketed annotations, collapse whitespace) — the standard minimal
    normalizer for WER comparisons."""
    text = text.lower()
    text = re.sub(r"[<\[][^>\]]*[>\]]", "", text)    # [noise], <unk>
    text = re.sub(r"\(([^)]+?)\)", r"\1", text)
    text = unicodedata.normalize("NFKD", text)
    text = "".join(c for c in text if not unicodedata.combining(c))
    text = re.sub(r"[^\w\s']", " ", text)
    text = re.sub(r"\s+", " ", text)
    return text.strip()


def edit_distance(ref: List[str], hyp: List[str]) -> Tuple[int, int, int, int]:
    """Levenshtein alignment -> (substitutions, deletions, insertions,
    total edits)."""
    m, n = len(ref), len(hyp)
    # dp over costs with backtrace-free S/D/I counting
    INF = 1 << 30
    dp = [[(0, 0, 0, 0)] * (n + 1) for _ in range(m + 1)]
    for j in range(1, n + 1):
        dp[0][j] = (0, 0, j, j)
    for i in range(1, m + 1):
        dp[i][0] = (0, i, 0, i)
        for j in range(1, n + 1):
            if ref[i - 1] == hyp[j - 1]:
                dp[i][j] = dp[i - 1][j - 1]
                continue
            s, d, ins = dp[i - 1][j - 1], dp[i - 1][j], dp[i][j - 1]
            best = min((s[3] + 1, 0), (d[3] + 1, 1), (ins[3] + 1, 2))
            if best[1] == 0:
                t = s
                dp[i][j] = (t[0] + 1, t[1], t[2], t[3] + 1)
            elif best[1] == 1:
                t = d
                dp[i][j] = (t[0], t[1] + 1, t[2], t[3] + 1)
            else:
                t = ins
                dp[i][j] = (t[0], t[1], t[2] + 1, t[3] + 1)
    return dp[m][n]


def word_error_rate(reference: str, hypothesis: str,
                    normalize: bool = True) -> dict:
    ref = (normalize_text(reference) if normalize else reference).split()
    hyp = (normalize_text(hypothesis) if normalize else hypothesis).split()
    s, d, i, total = edit_distance(ref, hyp)
    n = max(len(ref), 1)
    return {"wer": total / n, "sub": s, "del": d, "ins": i,
            "n_words": len(ref)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gwt-eval-torch")
    p.add_argument("data_dir", help="directory of .wav + .txt pairs")
    p.add_argument("-m", "--model", default=None)
    p.add_argument("--synthetic", default=None, metavar="NAME")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch versions of the kernels)")
    p.add_argument("-l", "--language", default="en")
    p.add_argument("--beam-size", type=int, default=-1)
    p.add_argument("--limit", type=int, default=0)
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

    strategy = (gwt.SamplingStrategy.BEAM_SEARCH if args.beam_size > 1
                else gwt.SamplingStrategy.GREEDY)
    tparams = gwt.TranscribeParams(
        strategy=strategy, language=args.language,
        beam_size=args.beam_size if args.beam_size > 1 else 5,
        print_progress=False)

    wavs = sorted(glob.glob(os.path.join(args.data_dir, "*.wav")))
    if args.limit:
        wavs = wavs[:args.limit]
    if not wavs:
        print("no .wav files found", file=sys.stderr)
        return 1

    total_edits = total_words = 0
    for wav in wavs:
        txt = os.path.splitext(wav)[0] + ".txt"
        if not os.path.exists(txt):
            continue
        samples, rate = read_wav(wav)
        if rate != gwt.SAMPLE_RATE:
            samples = resample(samples, rate, gwt.SAMPLE_RATE)
        segs = ctx.full(tparams, samples)
        hyp = "".join(s.text for s in segs)
        ref = open(txt).read()
        r = word_error_rate(ref, hyp)
        total_edits += r["sub"] + r["del"] + r["ins"]
        total_words += max(r["n_words"], 1)
        print(f"{os.path.basename(wav):30s} wer={r['wer']:.3f} "
              f"(S={r['sub']} D={r['del']} I={r['ins']} N={r['n_words']})")

    print(f"\nTOTAL WER: {total_edits / max(total_words, 1):.4f} "
          f"over {total_words} words, {len(wavs)} files")
    return 0


if __name__ == "__main__":
    sys.exit(main())
