"""Readings that set a cell's limits: the program's sound runs over many
seeds, and the controls and faults that the limits must fail, on the chip
at the cell's own size, in one process (set-up is paid once per seed and
variant, the kernels are built once).

    python3 -m gwt_bench.control --workload <cell> --seeds 1,2,3 \
        --variants sound,int8,fp8 [--batches 1] [--out FILE]

Every reading is the cell's own check (``Entry.check``): its numbers and
its verdict, ``correct``.  Variants of a "batch" cell (one batch of the
cell's load by default):

- ``sound``: the program as the configuration states;
- ``int8``: the program's own lower-precision path (int8 decoder weights
  and int8 cross-attention K/V), the control;
- ``fp8``: the reference at fp8 put in the program's place: at every
  position of the sound run's prompts and served tokens, the gap of the
  token it puts first and its log-probabilities;
- ``second_best``: a fault planted in the program: at every seventh step
  the sampler returns each row's second-best allowed token with that
  token's own log-probability.

Variants of a "train" cell:

- ``sound``: the program as the configuration states;
- ``tf32``: the reference with TF32 on in the program's place, the
  control of a float32 configuration;
- ``bf16``: the program with bfloat16 weights (the configuration changed
  to bfloat16);
- ``half_batch``: a fault planted in the program: the loss and gradient of
  each step taken over the first half of its rows only.

Prints one JSON line per (seed, variant) and writes them to ``--out``.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import sys

from . import entries, specs
from .run import use_caches


@contextlib.contextmanager
def half_batch():
    """Plant the fault: every step's loss and gradients over the first
    half of the rows."""
    from godot_whisper_tpu_torch.models import training

    real = training.loss_and_grads

    def half(params, config, batch, *a, **kw):
        n = batch["mel"].shape[0] // 2
        return real(params, config, {k: v[:n] for k, v in batch.items()},
                    *a, **kw)

    training.loss_and_grads = half
    try:
        yield
    finally:
        training.loss_and_grads = real


@contextlib.contextmanager
def second_best():
    """Plant the fault: at every seventh call the sampler returns each
    row's second-best allowed token with that token's own log-probability,
    as an arg-max that goes wrong but reports consistently would."""
    import torch
    from godot_whisper_tpu_torch.decode import window
    from godot_whisper_tpu_torch.ops import filter_sample

    real = window.fused_filter_sample
    calls = [0]

    def fake(logits, suppress, state, *, seed, **kw):
        out = real(logits, suppress, state, seed=seed, **kw)
        calls[0] += 1
        if calls[0] % 7 != 3:
            return out
        lp = filter_sample._filtered_logprobs(logits, suppress, state, **kw)[0]
        tok = lp.topk(2, dim=-1).indices[:, 1]
        plog = lp[torch.arange(len(tok), device=lp.device), tok]
        return out._replace(token=tok.to(out.token.dtype),
                            plog=plog.to(out.plog.dtype))

    window.fused_filter_sample = fake
    try:
        yield
    finally:
        window.fused_filter_sample = real


PLANTED = {"half_batch": half_batch, "second_best": second_best}


def reading(compared) -> dict:
    """A check's numbers by name, and its verdict."""
    out = {k: v for k, v, _ in compared}
    out["correct"] = all(v <= lim for _, v, lim in compared)
    return out


def batch_reading(cfg, spec, seed, variant, batches, device):
    spec = copy.deepcopy(spec)
    if variant == "int8":
        spec["quantize"] = "int8"
        spec["params"]["cross_kv_int8"] = True
    e = entries.load("batch")(cfg, spec, seed, device)
    with PLANTED.get(variant, contextlib.nullcontext)():
        e.setup()
        for _ in range(batches):
            e.window(0.0)                  # one batch
    e.release()
    out = reading(e.check("fp8" if variant == "fp8" else "f32"))
    out["requests"] = e.attempted
    return out


def train_reading(cfg, spec, seed, variant, device):
    if variant == "bf16":
        cfg = dict(cfg, compute_dtype="bfloat16")
    e = entries.load("train")(cfg, spec, seed, device)
    with PLANTED.get(variant, contextlib.nullcontext)():
        e.setup()
    e.release()
    out = reading(e.check("tf32" if variant == "tf32" else "f32"))
    out["losses"] = list(e.losses)
    out["ref_losses"] = list(e.ref[0])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variants", default="sound")
    ap.add_argument("--batches", type=int, default=1)
    ap.add_argument("--out")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    spec = specs.workload(args.workload)
    cfg = specs.config(spec["config"])
    if args.device == "cuda":
        use_caches()
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        for variant in args.variants.split(","):
            if spec["entry"] == "batch":
                r = batch_reading(cfg, spec, seed, variant, args.batches,
                                  args.device)
            else:
                r = train_reading(cfg, spec, seed, variant, args.device)
            line = json.dumps({"workload": args.workload, "seed": seed,
                               "variant": variant, **r})
            print(line, flush=True)
            lines.append(line)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
