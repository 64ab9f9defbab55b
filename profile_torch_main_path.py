#!/usr/bin/env python3
"""Where the time goes on the PyTorch port's main path, on one NVIDIA GPU.

    python3 profile_torch_main_path.py [--model tiny.en] [--seconds 34]
                                       [--beam K] [--quantize int8|int4]
                                       [--cross-kv-int8] [--root DIR]
    python3 profile_torch_main_path.py --train bf16|f32 [--model tiny.en]

Drives ``WhisperContext.synthetic(model, seed=0)`` (bf16) ``.full(
TranscribeParams(), audio)`` on the deterministic test clip (with
``--beam K``: ``TranscribeParams(strategy=BEAM_SEARCH, beam_size=K)``;
``--quantize`` stores the decoder weights int8 / int4 (K9 / K10),
``--cross-kv-int8`` the cross-attention K/V int8 (K12 / K11)):

1. one warm-up run (kernel build and load, cuBLAS and allocator warm-up);
2. three timed runs (host clock around work that ends in a synchronize):
   median wall, audio-seconds per second, decode steps, wall per step;
3. one run under ``torch.profiler`` (CPU + CUDA activities): total device
   time of all kernels and copies, device time and calls per kernel name,
   kernel launches per decode step, and the quantized kernels' launches
   per decode step (K9 and K10 count the per-window projections too), and
   the device time of K5, K6 and the quantized kernels K9-K12 by kernel
   name.
   The profiler slows the host, not the
   kernels, so the device busy share is that device time over the median
   wall of the unprofiled runs (the rest is the host driving the loop);
4. stage times with CUDA synchronizes around each stage: mel, one window's
   encode (encoder + cross-KV), and one window's rung-0 decode
   (``WindowDecoder.decode``: prompt pass + token loop; greedy, or beam K
   with ``--beam``) at the main path's rows per stream, per decode step.

``--train DTYPE`` profiles ``models/training.py::train_step`` instead,
as ``chip_smoke.py`` phase 15 (a) sets it up: ``init_params(model,
seed=0)`` in DTYPE, a batch of eight 30 s slices of the test clip (mel
from K1), 64 teacher-forced tokens from a numpy seed, lr 1e-4.  Two
warm-up steps; five timed rounds of the forward alone (``loss_fn`` without
autograd), ``loss_and_grads`` and the whole step (AdamW is the step less
``loss_and_grads``), medians and the peak of ``max_memory_allocated``;
then three steps under ``torch.profiler``: device time a step, the busy
share of the median step wall, launches a step, device time by kernel
family and the top kernels.

``--root`` names the checkout whose ``godot_whisper_tpu_torch`` is
profiled (default: this one), so that one call can profile a parent commit
unpacked elsewhere and this tree in turns.  Prints a human-readable
breakdown and, as its last line, one JSON object.  Needs a CUDA device;
exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

from chip_smoke import card_line, frozen_audio, train_batch

# Kernel families by device-side name, current and older ones (a --root
# checkout may hold the older; there K12's exact mode reads as K11).  K11
# runs on K12's kernel template (xattn_packed_kernel), so in this checkout
# its time counts under K12.  K5 and K6 kept their kernel names through
# their redesign (one CTA a row before, a cluster a row since).
FAMILIES = (("K5", r"filter_sample_kernel"),
            ("K6", r"filter_topk_kernel"),
            ("K9", r"qmm_io_rows8|qmm_oi_mma|qmm_io_tc|qmm_oi_rows"
                   r"|qmm_io_rows<false>|qmm_tc<[01]>"),
            ("K10", r"q4mm_io_rows|q4mm_io_tc|q4mm_rows|qmm_io_rows<true>"
                    r"|qmm_tc<2>"),
            ("K11", r"xattn_q_kernel<\d+(, false)?>"),
            ("K12", r"xattn_packed_kernel|xattn_q_kernel<\d+, true>"))
# --train: device time by family, each kernel counted under the first
# family whose pattern its name matches
TRAIN_FAMILIES = (("K2/K13", r"enc_attn"),
                  ("gemm", r"gemm|sm90_xmma|cutlass|cublas"),
                  ("conv", r"conv|cudnn|implicit|winograd|fft"),
                  ("softmax", r"softmax"),
                  ("reduce", r"reduce"),
                  ("elementwise", r"elementwise|vectorized|unrolled|index|"
                                  r"scatter|gather|fill|cat"),
                  ("copy", r"Memcpy|Memset|copy"))


def _kernel_us(evt) -> float:
    """Device time of a device-side event (kernel or copy); 0 for host
    operator events, whose device time would count their kernels twice."""
    from torch.autograd import DeviceType
    if evt.device_type != DeviceType.CUDA:
        return 0.0
    for name in ("device_time_total", "cuda_time_total"):
        v = getattr(evt, name, None)
        if v:
            return float(v)
    return 0.0


def _device_rows(prof):
    """[(device us, calls, name)] of a profile's kernels and copies,
    largest first."""
    rows = [(_kernel_us(e), e.count, e.key) for e in prof.key_averages()]
    return sorted((r for r in rows if r[0] > 0), reverse=True)


def profile_train(model: str, dtype_name: str) -> int:
    """The ``--train`` mode (see the module docstring)."""
    import torch
    import godot_whisper_tpu_torch as gt
    from godot_whisper_tpu_torch.audio.mel import MelFrontend, mel_filterbank
    from godot_whisper_tpu_torch.models import training as tt
    from torch.profiler import ProfilerActivity, profile

    B, T = 8, 64
    sync = torch.cuda.synchronize
    dev = torch.device("cuda")
    card = card_line()
    cfg = gt.get_config(model)
    dtype = torch.bfloat16 if dtype_name == "bf16" else torch.float32
    audio = frozen_audio(30.0 * B + 30.0)
    mel, _ = MelFrontend(mel_filterbank(cfg.n_mels), dev).device_batch(
        [audio[i * 480000:(i + 1) * 480000] for i in range(B)])
    batch = train_batch(torch, cfg, mel, T, np.random.default_rng(15), dev)
    state = tt.init_train_state(gt.init_params(cfg, seed=0,
                                               compute_dtype=dtype))
    for _ in range(2):
        state, _ = tt.train_step(state, cfg, batch)
    sync()

    def forward():
        with torch.no_grad():
            return tt.loss_fn(state.params, cfg, batch["mel"],
                              batch["tokens"], batch["targets"],
                              batch["mask"])

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return (time.perf_counter() - t0) * 1e3, out

    fwd, grad, step = [], [], []
    peak = 0
    for _ in range(5):
        fwd.append(timed(forward)[0])
        grad.append(timed(lambda: tt.loss_and_grads(state.params, cfg,
                                                    batch))[0])
        torch.cuda.reset_peak_memory_stats()
        ms, (state, _) = timed(lambda: tt.train_step(state, cfg, batch))
        step.append(ms)
        peak = max(peak, torch.cuda.max_memory_allocated())
    med = {k: float(np.median(v)) for k, v in
           (("forward", fwd), ("loss_and_grads", grad), ("step", step))}
    med["adamw"] = med["step"] - med["loss_and_grads"]

    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            state, _ = tt.train_step(state, cfg, batch)
        sync()
    rows = _device_rows(prof)
    dev_us = sum(r[0] for r in rows)
    calls = sum(r[1] for r in rows)
    family = {k: 0.0 for k, _ in TRAIN_FAMILIES}
    family["other"] = 0.0
    for us, _, key in rows:
        name = next((k for k, pat in TRAIN_FAMILIES
                     if re.search(pat, key, re.IGNORECASE)), "other")
        family[name] += us
    busy = dev_us / 1e3 / (3 * med["step"])

    print(f"[{card}] train_step {model} {dtype_name} B {B} T {T}: ms a "
          f"step {step} (median {med['step']}), forward alone "
          f"{med['forward']}, loss_and_grads {med['loss_and_grads']}, "
          f"AdamW (step less loss_and_grads) {med['adamw']}; peak memory "
          f"{peak / 2 ** 20} MiB")
    print(f"[{card}] profiled 3 steps: device time {dev_us / 3e3} ms a "
          f"step, busy share {busy} of the median step wall, "
          f"{calls / 3} kernels and copies a step")
    print("device time by family (ms a step, share): " + ", ".join(
        f"{k} {us / 3e3} {us / max(dev_us, 1e-9)}"
        for k, us in family.items()))
    print("top device time by kernel (us a step, calls a step, name):")
    for us, n, key in rows[:15]:
        print(f"  {us / 3:12.1f} {n / 3:8.1f}  {key[:100]}")
    print(json.dumps({
        "card": card, "model": model, "dtype": dtype_name, "batch": B,
        "tokens": T, "step_ms": step, "median_ms": med,
        "peak_mib": peak / 2 ** 20, "device_ms_per_step": dev_us / 3e3,
        "busy_share": busy, "device_ops_per_step": calls / 3,
        "family_ms_per_step": {k: us / 3e3 for k, us in family.items()},
        "top": [{"us_per_step": us / 3, "calls_per_step": n / 3,
                 "name": key[:120]} for us, n, key in rows[:15]]}))
    return 0


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="tiny.en")
    ap.add_argument("--seconds", type=float, default=34.0)
    ap.add_argument("--beam", type=int, default=0,
                    help="beam size (0: the default greedy ladder)")
    ap.add_argument("--quantize", choices=("int8", "int4", "int8_embed"),
                    default=None, help="decoder weight quantization")
    ap.add_argument("--cross-kv-int8", action="store_true",
                    help="int8 cross-attention K/V")
    ap.add_argument("--root", default=None,
                    help="checkout whose godot_whisper_tpu_torch is profiled")
    ap.add_argument("--train", choices=("bf16", "f32"), default=None,
                    help="profile train_step in this dtype instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile: no CUDA device", file=sys.stderr)
        return 2
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.train:
        return profile_train(args.model, args.train)
    import godot_whisper_tpu_torch as gt
    from godot_whisper_tpu_torch.decode.filters import build_filter_context
    from godot_whisper_tpu_torch.decode.window import WindowDecoder
    from godot_whisper_tpu_torch.models.model import (cross_kv,
                                                      encoder_forward,
                                                      quantize_cross_kv)
    from godot_whisper_tpu_torch.ops import cross_attention as CA
    from godot_whisper_tpu_torch.ops import qmatmul as Q

    sync = torch.cuda.synchronize
    audio = frozen_audio(args.seconds)
    ctx = gt.WhisperContext.synthetic(args.model, seed=0,
                                      quantize=args.quantize)
    tp = (gt.TranscribeParams(strategy=gt.SamplingStrategy.BEAM_SEARCH,
                              beam_size=args.beam,
                              cross_kv_int8=args.cross_kv_int8) if args.beam
          else gt.TranscribeParams(cross_kv_int8=args.cross_kv_int8))
    ctx.full(tp, audio)                                   # warm-up

    walls, steps = [], 0
    for _ in range(3):
        ctx.pipeline.timings.reset()
        sync()
        t0 = time.perf_counter()
        ctx.full(tp, audio)
        sync()
        walls.append(time.perf_counter() - t0)
        steps = ctx.timings.n_decode
    wall = float(np.median(walls))

    ctx.pipeline.timings.reset()
    quant = (Q.quant_matmul, Q.quant_matmul4, CA.xattn_q_packed,
             CA.xattn_q_wide)
    for fn in quant:
        fn.launches = 0
    from torch.profiler import ProfilerActivity, profile
    sync()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ctx.full(tp, audio)
        sync()
    prof_wall = time.perf_counter() - t0
    per_step = {fn.__name__: fn.launches / max(ctx.timings.n_decode, 1)
                for fn in quant}
    rows = _device_rows(prof)
    dev_total_us = sum(r[0] for r in rows)
    kernel_calls = sum(r[1] for r in rows)
    family_us = {k: sum(us for us, _, key in rows if re.search(pat, key))
                 for k, pat in FAMILIES}

    # ---- stage times at the main-path shapes
    pipe, cfg, params = ctx.pipeline, ctx.config, ctx.pipeline.params

    def timed(fn, reps=10):
        fn()
        sync()
        t = time.perf_counter()
        for _ in range(reps):
            out = fn()
        sync()
        return (time.perf_counter() - t) / reps * 1e3, out

    mel_ms, _ = timed(lambda: pipe.mel.device(audio))
    mel, _ = pipe.mel.device(audio)
    win = mel[:, :3000].T[None].contiguous()
    def encode():
        x = cross_kv(params, cfg, encoder_forward(params, cfg, win))
        return quantize_cross_kv(x, cfg.n_text_head) if tp.cross_kv_int8 \
            else x
    enc_ms, xkv = timed(encode)
    nd = max(tp.n_decoders_at(t) for t in tp.temperatures())
    mode = (dict(strategy="beam", beam_size=args.beam, n_decoders=args.beam)
            if args.beam else dict(n_decoders=nd))
    nd = mode["n_decoders"]
    wd = WindowDecoder(cfg, build_filter_context(cfg, pipe.tokenizer,
                                                 device="cuda"))
    window_ms, res = timed(lambda: wd.decode(
        params, xkv, np.asarray([cfg.token_sot], np.int32),
        temperature=0.0, seek=0, seek_end=pipe._n_len_org,
        suppress_blank=tp.suppress_blank, no_timestamps=False,
        single_segment=False, max_tokens=0, test_mode=False, **mode),
        reps=3)
    loop_ms_per_step = window_ms / max(res.n_steps, 1)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    what = f"beam {args.beam}" if args.beam else "greedy"
    prec = (f"{args.quantize or 'bf16'} weights, "
            f"{'int8' if args.cross_kv_int8 else 'bf16'} cross-KV")
    print(f"main path {args.model} {prec} {what}, {args.seconds} s audio: "
          f"wall {[round(w, 4) for w in walls]} s (median {wall:.4f}), "
          f"{args.seconds / wall:.2f} audio-s/s, {steps} decode steps, "
          f"{wall / max(steps, 1) * 1e3:.3f} ms wall per step")
    print(f"profiled run: wall {prof_wall:.4f} s (profiler-slowed host), "
          f"device time {dev_total_us / 1e6:.4f} s = busy share "
          f"{dev_total_us / 1e6 / wall:.3f} of the unprofiled median wall, "
          f"{kernel_calls} kernels and copies, "
          f"{kernel_calls / max(ctx.timings.n_decode, 1):.1f} per decode "
          "step")
    print("quantized kernel launches per decode step: "
          + ", ".join(f"{k} {v:.2f}" for k, v in per_step.items()))
    n_dec = max(ctx.timings.n_decode, 1)
    print("kernel families' device time (us total, us per decode step, "
          "share of device time): "
          + ", ".join(f"{k} {us:.1f} {us / n_dec:.2f} "
                      f"{us / max(dev_total_us, 1e-9):.3f}"
                      for k, us in family_us.items()))
    print("top device time by kernel (us total, calls, name):")
    for us, n, key in rows[:15]:
        print(f"  {us:12.1f} {n:7d}  {key[:100]}")
    print(f"stages (synchronized): mel {mel_ms:.3f} ms, encode window "
          f"{enc_ms:.3f} ms, {what} window decode ({nd} rows) "
          f"{window_ms:.3f} ms = {loop_ms_per_step:.3f} ms per step over "
          f"{res.n_steps} steps")
    print(json.dumps({
        "card": smi, "model": args.model, "beam": args.beam,
        "quantize": args.quantize, "cross_kv_int8": args.cross_kv_int8,
        "quant_launches_per_step": per_step,
        "package": os.path.dirname(gt.__file__),
        "family_device_us": family_us,
        "audio_s": args.seconds,
        "wall_s": walls, "steps": steps,
        "audio_s_per_s": args.seconds / wall,
        "profiled_wall_s": prof_wall, "device_s": dev_total_us / 1e6,
        "busy_share": dev_total_us / 1e6 / wall,
        "device_ops": kernel_calls,
        "top": [{"us": us, "calls": n, "name": key[:120]}
                for us, n, key in rows[:15]],
        "stage_ms": {"mel": mel_ms, "encode_window": enc_ms,
                     "window_decode": window_ms,
                     "window_decode_per_step": loop_ms_per_step},
        "window_steps": res.n_steps}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
