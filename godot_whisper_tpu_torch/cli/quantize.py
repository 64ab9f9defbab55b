"""Model quantization tool — the ``examples/quantize`` equivalent
(whisper.cpp examples/quantize/quantize.cpp), port of the JAX package's
``cli/quantize.py`` (numpy over the port's own ``models/loader_ggml.py``).

    python -m godot_whisper_tpu_torch.cli.quantize in.bin out.bin q8_0

Quantizes 2D matmul weights to the chosen block format; 1D tensors,
convolution stems and positional embeddings stay f32/f16 (matching the
reference's to_quant/to_skip split in ggml_common_quantize_0).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..models import loader_ggml as gg

_FMTS = {
    "q4_0": (gg.GGML_TYPE_Q4_0, 2),
    "q4_1": (gg.GGML_TYPE_Q4_1, 3),
    "q8_0": (gg.GGML_TYPE_Q8_0, 7),
    # K-quant super-block formats (ggml_ftype 10..14)
    "q2_k": (gg.GGML_TYPE_Q2_K, 10),
    "q3_k": (gg.GGML_TYPE_Q3_K, 11),
    "q4_k": (gg.GGML_TYPE_Q4_K, 12),
    "q5_k": (gg.GGML_TYPE_Q5_K, 13),
    "q6_k": (gg.GGML_TYPE_Q6_K, 14),
}

# tensors never quantized (mirror of the quantize example's skip list)
_SKIP_SUFFIXES = (
    "positional_embedding", ".bias", "ln.weight", "ln_post.weight",
    "attn_ln.weight", "mlp_ln.weight", "cross_attn_ln.weight",
    "conv1.weight", "conv2.weight",
)


def should_quantize(name: str, arr: np.ndarray, ttype: int = None) -> bool:
    if arr.ndim < 2:
        return False
    if any(name.endswith(s) for s in _SKIP_SUFFIXES):
        return False
    block = 256 if ttype in gg._K_BLOCK_BYTES else 32
    return arr.size % block == 0


def quantize_model(src: str, dst: str, fmt: str) -> dict:
    ttype, ftype = _FMTS[fmt]
    raw = gg.read_checkpoint(src)
    tensors = {}
    n_q = n_keep = 0
    for name, arr in raw.tensors.items():
        if should_quantize(name, arr, ttype):
            tensors[name] = (arr, ttype)
            n_q += 1
        else:
            tensors[name] = (arr, gg.GGML_TYPE_F32)
            n_keep += 1
    gg.write_checkpoint(dst, raw.config, raw.mel_filters, raw.vocab_tokens,
                        tensors, ftype=ftype)
    return {"quantized": n_q, "kept": n_keep, "format": fmt}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gwt-quantize-torch")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("format", choices=sorted(_FMTS))
    args = p.parse_args(argv)
    stats = quantize_model(args.input, args.output, args.format)
    print(f"quantized {stats['quantized']} tensors to {stats['format']} "
          f"({stats['kept']} kept full precision)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
