"""Readings that set the Uni-MoE-2.0-Omni cell's limits, on the chip at
the cell's own size, in one process: the program's sound runs over many
seeds, the lower-precision control, and faults planted in the program's
routing.

    python3 -m gwt_bench.control_unimoe --workload unimoe.batch.20s \
        --seeds 1,2,3 --variants sound,fp8,top2,renorm,no_shared \
        [--batches 1] [--out FILE]

Every reading is the cell's own check (``Entry.check``, the numbers its
limits name) with its verdict, beside every other number the check can
compare (``Entry.numbers``).  Variants:

- ``sound``: the program as the configuration states;
- ``fp8``: the reference at fp8 put in the program's place (at every
  served position, the gap of the token it puts first, its
  log-probabilities and its router's sets);
- ``top2``: a fault planted in the program's router: always the two most
  probable experts (top-p ignored);
- ``renorm``: a fault: the routed weights renormalised over the chosen
  set;
- ``no_shared``: a fault: the shared experts dropped.

Prints one JSON line per (seed, variant) and appends them to ``--out``.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys

import torch

from . import entries, specs
from .run import use_caches


@contextlib.contextmanager
def _patched(name, make):
    from godot_whisper_tpu_torch.models import unimoe
    real = getattr(unimoe, name)
    setattr(unimoe, name, make(real))
    try:
        yield
    finally:
        setattr(unimoe, name, real)


def top2():
    """Plant the fault: top-p ignored, always the top-k (2) experts."""
    return _patched("top_p_set", lambda real: (
        lambda probs, top_p, top_k: real(probs, 2.0, top_k)))


def renorm():
    """Plant the fault: routed weights over the chosen set's sum."""
    def make(real):
        def route(h, router, cfg):
            r = real(h, router, cfg)
            total = torch.where(r.chosen, r.probs, torch.zeros(
                (), device=r.probs.device)).sum(-1, keepdim=True)
            return r._replace(weights=r.weights / total)
        return route
    return _patched("route", make)


def no_shared():
    """Plant the fault: the shared experts' outputs left out."""
    zeros = {}

    def make(real):
        def moe(h, blk, li, cfg, static):
            z = zeros.get(id(blk["shared_out"]))
            if z is None:
                z = zeros[id(blk["shared_out"])] = torch.zeros_like(
                    blk["shared_out"])
            return real(h, dict(blk, shared_out=z), li, cfg, static)
        return moe
    return _patched("moe", make)


PLANTED = {"top2": top2, "renorm": renorm, "no_shared": no_shared}


def reading(e, mode: str) -> dict:
    chk = e.spec["check"]
    c = e.compared(mode)
    out = e.numbers(c, float(chk["logprob_bound"]))
    out["short_requests"] = float(e.failed)
    lim = chk["limits"]
    out["correct"] = all(out[k] <= float(v) for k, v in lim.items())
    out["requests"] = e.attempted
    return out


def omni_readings(cfg, spec, seed, variant, batches, device,
                  modes=("f32",)):
    """One run of the program (``variant`` "sound" or a planted fault),
    then a reading for each of ``modes``: "f32" the program against the
    reference, "fp8" the reference at fp8 in the program's place."""
    e = entries.load(spec["entry"])(cfg, spec, seed, device)
    with PLANTED.get(variant, contextlib.nullcontext)():
        e.setup()
        for _ in range(batches):
            e.window(0.0)                  # one batch
    e.release()
    out = {m: reading(e, m) for m in modes}
    e.params = e.ctx = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
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
    variants = args.variants.split(",")
    for seed in (int(s) for s in args.seeds.split(",")):
        runs = [(v, ("f32",)) for v in variants if v not in ("sound", "fp8")]
        if "sound" in variants or "fp8" in variants:
            modes = tuple(m for v, m in (("sound", "f32"), ("fp8", "fp8"))
                          if v in variants)
            runs.insert(0, ("sound", modes))
        for variant, modes in runs:
            got = omni_readings(cfg, spec, seed, variant, args.batches,
                                args.device, modes)
            for mode, r in got.items():
                name = "fp8" if mode == "fp8" else variant
                line = json.dumps({"workload": args.workload, "seed": seed,
                                   "variant": name, **r})
                print(line, flush=True)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
