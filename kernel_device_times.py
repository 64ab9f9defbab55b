#!/usr/bin/env python3
"""CUDA-graph device times of the decode path's kernels, of the log-mel
kernel and of their library yardsticks, on one NVIDIA GPU.

    python3 kernel_device_times.py [--root DIR] [--tag NAME]

Times, at chip_smoke.py's shapes (bf16, random inputs from numpy seed 0):

- K3 / K4 ``decode_attention``: tiny.en self-attention at step 100 (5 rows,
  cache 512, prompt capacity 232), tiny.en cross-attention (kv_group 5,
  1536 slots, 1500 valid), large-v3 cross-attention (20 heads, S 1280);
- K7 ``split_beam_attention``: one stream of 5 beams, prompt and live
  capacity 256, lo 120, hi_live 100, at tiny.en and large-v3 widths;
- K9 ``quant_matmul`` in its three routes: the tiny.en decode step's
  ``io`` projections at 5 rows, (384, 384) wo, (384, 1152) wqkv, (384,
  1536) mlp.w0 and (1536, 384) mlp.w1; the logits (5, 384) x int8 (51864,
  384) ``oi``; the cross-K projection (1500, 384) x (384, 384) ``io``;
- K10 ``quant_matmul4`` in its two routes: decode rows at tiny.en, 5 rows
  x int4 (384, 1536) mlp.w0 and (1536, 384) mlp.w1, and at large-v3
  widths, 8 rows x (1280, 3840) wqkv and (5120, 1280) mlp.w1; the
  tensor-core route at the cross-K/V projections, (1500, 384) x (384, 384)
  and (1500, 1280) x (1280, 1280);
- K11 / K12 ``cross_attention_quant``: large-v3 widths at beam 8 and at
  kv_group 7 (K11, exact); K12 at tiny.en kv_group 5 (W8A8 and exact),
  tiny.en kv_group 1 (W8A8; 5 streams of one row) and large-v3 widths at
  kv_group 5 (W8A8 and exact);
- K5 ``fused_filter_sample`` (argmax, f32 raw logits, chip_smoke.py's
  ``filter_edge_case`` rows) at (5, 51864), large-v3's (8, 51866) and (40,
  51864), 8 streams of 5 rows; K6 ``fused_filter_topk`` at (5, 51864) K 5
  and (8, 51866) K 8.  These have no library call.
- K1 ``log_mel_raw`` (f16 audio from numpy seed 0): the main path's 90 s
  bucket (1, 1440000) at 80 mels and at large-v3's 128, phase 10's (1,
  2400000) at 80, and 8 clips of 30 s (8, 1440000) at 80.  No single
  PyTorch call computes it; beside it, as a yardstick, the chain
  ``torch.stft`` (cuFFT, ``center=False``, periodic Hann) -> power ->
  ``torch.matmul`` with the filterbank -> ``log10`` (``chain_device_ms``).
  A parent tree whose ``log_mel_raw`` takes the (400, 402) basis and the
  filterbank is called that way.  And the main path's mel stage,
  ``MelFrontend.device`` on chip_smoke.py's 34 s clip (pad, upload, K1,
  normalize; host clock around synchronizes, median of 30).

Each kernel wrapper is captured in a CUDA graph and replayed (``graph_ms``
of this checkout's ``godot_whisper_tpu_torch/cli/bench.py``: the device
time without the host's time to enqueue the call), beside one PyTorch
call computing the same function:
SDPA with a boolean key mask (over keys gathered beforehand for K7, over
K/V dequantized beforehand for K11 / K12), torch.mm on the weight held in
bf16 for K9 / K10.  ``--root`` names the checkout whose
``godot_whisper_tpu_torch`` is timed (default: this one), so that one call
can time a parent commit unpacked elsewhere and this tree in turns on one
card.  Prints the card and one JSON line.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def _here(name: str, path: str):
    """A module of this checkout by its path, whatever --root says."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE,
                    help="checkout whose godot_whisper_tpu_torch is timed")
    ap.add_argument("--tag", default="", help="a name for the JSON line")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_device_times: no CUDA device", file=sys.stderr)
        return 2
    cs = _here("_chip_smoke_here", "chip_smoke.py")
    graph_ms = _here("_bench_here",
                     "godot_whisper_tpu_torch/cli/bench.py").graph_ms
    sys.path.insert(0, os.path.abspath(args.root))
    import godot_whisper_tpu_torch
    from godot_whisper_tpu_torch.models.model import (CrossKV,
                                                      quantize_cross_kv)
    from godot_whisper_tpu_torch.ops import cross_attention as CA
    from godot_whisper_tpu_torch.ops import decode_attention as D
    from godot_whisper_tpu_torch.ops import qmatmul as Q
    from godot_whisper_tpu_torch.ops import split_attention as SA

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rng = np.random.default_rng(0)
    out = {}

    def tens(*shape, dtype=torch.bfloat16, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).to(dev, dtype)

    def record(name, fn, lib=None, chain=None):
        fn()
        torch.cuda.synchronize()
        out[name] = {"device_ms": graph_ms(fn),
                     "library_device_ms": (None if lib is None
                                           else graph_ms(lib))}
        if chain is not None:
            out[name]["chain_device_ms"] = graph_ms(chain)

    # K3 / K4
    for name, S, H, B, kvg, C, L, lo_v, split, hi, layer in (
            ("K3 tiny.en self", 384, 6, 5, 1, 512, 4, [1] * 5, 232, 333, 2),
            ("K4 tiny.en cross", 384, 6, 5, 5, 1536, 4, [1500] * 5, 1536, 0,
             3),
            ("K4 large-v3 cross", 1280, 20, 5, 5, 1536, 2, [1500] * 5, 1536,
             0, 1)):
        g, dh = B // kvg, S // H
        q, k, v = tens(B, S), tens(L, g, C, S), tens(L, g, C, S)
        lo = torch.tensor(lo_v, dtype=torch.int32, device=dev)
        kw = dict(split=split, n_head=H, kv_group=kvg, layer=layer)
        ql = q.view(B, H, 1, dh)
        kl = k[layer].view(-1, C, H, dh).transpose(1, 2).expand(B, H, C, dh)
        vl = v[layer].view(-1, C, H, dh).transpose(1, 2).expand(B, H, C, dh)
        slot = torch.arange(C, device=dev)
        mask = ((slot[None] < lo[:, None])
                | ((slot[None] >= split) & (slot[None] < hi)))[:, None, None]
        record(name, lambda: D.decode_attention(q, k, v, lo, hi, **kw),
               lambda: sdpa(ql, kl, vl, attn_mask=mask))

    # K7
    for name, S, H, L in (("K7 tiny.en", 384, 6, 4),
                          ("K7 large-v3", 1280, 20, 2)):
        KB, CP, NL, lo_v, hi_live, layer = 5, 256, 256, 120, 100, L - 1
        q = tens(KB, S)
        kp, vp = tens(L, 1, CP, S), tens(L, 1, CP, S)
        kl, vl = tens(L, KB, NL, S), tens(L, KB, NL, S)
        lo = torch.full((KB,), lo_v, dtype=torch.int32, device=dev)
        rowmap = torch.from_numpy(rng.integers(0, KB, (KB, NL)).astype(
            np.int32)).to(dev)
        kw = dict(n_head=H, kv_group=KB, layer=layer, rowmap=rowmap)
        rows = rowmap[:, :hi_live].long()
        t = torch.arange(hi_live, device=dev)[None]
        dh = S // H

        def heads(p_, l_):
            full = torch.cat([p_[layer, :, :lo_v].expand(KB, lo_v, S),
                              l_[layer][rows, t]], dim=1)
            return full.view(KB, -1, H, dh).transpose(1, 2).contiguous()
        kf, vf = heads(kp, kl), heads(vp, vl)
        qf = q.view(KB, H, 1, dh)
        record(name, lambda: SA.split_beam_attention(
            q, kp, vp, kl, vl, lo, hi_live, **kw), lambda: sdpa(qf, kf, vf))

    # K9 / K10
    for name, kind, layout, m, s, o in (
            ("K9 io rows tiny.en wo", "int8", "io", 5, 384, 384),
            ("K9 io rows tiny.en wqkv", "int8", "io", 5, 384, 1152),
            ("K9 io rows tiny.en mlp.w0", "int8", "io", 5, 384, 1536),
            ("K9 io rows tiny.en mlp.w1", "int8", "io", 5, 1536, 384),
            ("K9 oi tiny.en logits", "int8", "oi", 5, 384, 51864),
            ("K9 io tiny.en cross-K", "int8", "io", 1500, 384, 384),
            ("K10 rows tiny.en mlp.w0", "int4", "io", 5, 384, 1536),
            ("K10 rows tiny.en mlp.w1", "int4", "io", 5, 1536, 384),
            ("K10 rows large-v3 wqkv", "int4", "io", 8, 1280, 3840),
            ("K10 rows large-v3 mlp.w1", "int4", "io", 8, 5120, 1280),
            ("K10 tc tiny.en cross-K", "int4", "io", 1500, 384, 384),
            ("K10 tc large-v3 cross-K", "int4", "io", 1500, 1280, 1280)):
        x = tens(m, s)
        w = tens(s, o, dtype=torch.float32, scale=0.02)
        if kind == "int4":
            qt = Q.quantize_tensor4(w)
            w_deq = Q.dequantize4(qt)
            fn = (lambda x=x, qt=qt: Q.quant_matmul4(x, qt))
        else:
            qt = (Q.quantize_tensor(w.t().contiguous(), reduce_axis=1)
                  if layout == "oi" else Q.quantize_tensor(w, reduce_axis=0))
            w_deq = Q.dequantize(qt)
            w_deq = w_deq.t() if layout == "oi" else w_deq
            fn = (lambda x=x, qt=qt, layout=layout: Q.quant_matmul(
                x, qt, layout=layout))
        w_bf16 = w_deq.to(torch.bfloat16)
        record(name, fn, lambda x=x, w_bf16=w_bf16: torch.mm(
            x, w_bf16, out_dtype=torch.float32))

    # K11 / K12
    for name, s, h, kg, g, n_layer, w8a8 in (
            ("K12 tiny.en kv_group 5 W8A8", 384, 6, 5, 1, 4, True),
            ("K12 tiny.en kv_group 5 exact", 384, 6, 5, 1, 4, False),
            ("K12 tiny.en kv_group 1 W8A8", 384, 6, 1, 5, 4, True),
            ("K12 large-v3 kv_group 5 W8A8", 1280, 20, 5, 1, 3, True),
            ("K12 large-v3 kv_group 5 exact", 1280, 20, 5, 1, 3, False),
            ("K11 large-v3 beam 8", 1280, 20, 8, 1, 3, False),
            ("K11 large-v3 kv_group 7", 1280, 20, 7, 1, 3, False)):
        k, v = tens(n_layer, g, 1536, s), tens(n_layer, g, 1536, s)
        x = quantize_cross_kv(CrossKV(k, v, 1500), h)
        q = tens(g * kg, s)
        lo = torch.full((g * kg,), 1500, dtype=torch.int32, device=dev)
        d = s // h
        kd = (x.k_q[-1].float().view(g, 1536, h, d)
              * x.k_s[-1, :, :, :h].float()[..., None])
        vd = (x.v_q[-1].float().view(g, 1536, h, d)
              * x.v_s[-1, :, None, :h, None])
        # (g * kg, h, T, d): a group's kv_group rows see one K/V row
        kd = kd.to(torch.bfloat16).transpose(1, 2)[:, None].expand(
            g, kg, h, 1536, d).flatten(0, 1)
        vd = vd.to(torch.bfloat16).transpose(1, 2)[:, None].expand(
            g, kg, h, 1536, d).flatten(0, 1)
        qd = q.view(g * kg, h, 1, d)
        mask = (torch.arange(1536, device=dev) < 1500)[None, None, None]
        record(name, lambda q=q, x=x, lo=lo, h=h, kg=kg, n_layer=n_layer,
               w8a8=w8a8: CA.cross_attention_quant(
                   q, x.k_q, x.k_s, x.v_q, x.v_s, n_head=h, t_valid=lo,
                   kv_group=kg, layer=n_layer - 1, w8a8=w8a8),
               lambda qd=qd, kd=kd, vd=vd, mask=mask: sdpa(
                   qd, kd, vd, attn_mask=mask))

    # K5 / K6
    from godot_whisper_tpu_torch.ops import filter_sample as FS
    for name, V, B, K in (("K5 (5, 51864)", 51864, 5, 0),
                          ("K5 large-v3 (8, 51866)", 51866, 8, 0),
                          ("K5 (40, 51864)", 51864, 40, 0),
                          ("K6 (5, 51864) K 5", 51864, 5, 5),
                          ("K6 large-v3 (8, 51866) K 8", 51866, 8, 8)):
        logits, sup, state = cs.filter_edge_case(torch, rng, V, B, dev)
        eot, beg = cs.filter_vocab(V)
        kw = dict(temperature=0.0, eot=eot, beg=beg, space_id=220,
                  max_initial_tid=50, suppress_blank=True,
                  no_timestamps=False)
        record(name, (lambda lg=logits, su=sup, st=state, kw=kw:
                      FS.fused_filter_sample(lg, su, st, seed=0, **kw))
               if not K else
               (lambda lg=logits, su=sup, st=state, kw=kw, K=K:
                FS.fused_filter_topk(lg, su, st, K=K, **kw)))

    # K1
    from godot_whisper_tpu_torch.audio.mel import mel_filterbank
    from godot_whisper_tpu_torch.ops import mel_kernel as M
    basis = torch.from_numpy(M.dft_basis()).to(dev)
    win = torch.hann_window(400, periodic=True, device=dev)
    for name, B, L, n_mels in (("K1 (1, 1440000) 80 mels", 1, 1440000, 80),
                               ("K1 (1, 1440000) 128 mels", 1, 1440000,
                                128),
                               ("K1 (1, 2400000) 80 mels", 1, 2400000, 80),
                               ("K1 (8, 1440000) 80 mels", 8, 1440000, 80)):
        a16 = tens(B, L, dtype=torch.float16, scale=0.1)
        filt = torch.from_numpy(mel_filterbank(n_mels)).to(dev)
        if hasattr(M, "mel_tables"):
            tables = M.mel_tables(basis, filt)
            fn = (lambda a16=a16, tables=tables: M.log_mel_raw(a16, tables))
        else:
            fn = (lambda a16=a16, filt=filt: M.log_mel_raw(a16, basis, filt))
        record(name, fn, chain=lambda a16=a16, filt=filt: torch.log10(
            torch.clamp(filt @ torch.stft(
                a16.float(), 400, 160, window=win, center=False,
                return_complex=True).abs().square(), min=1e-10)))

    # the main path's synchronized mel stage (MelFrontend.device: pad,
    # upload, K1, normalize) on chip_smoke.py's 34 s clip, host clock
    from godot_whisper_tpu_torch.audio.mel import MelFrontend
    fe = MelFrontend(mel_filterbank(80), device=dev)
    clip = cs.frozen_audio(34.0)
    stage = []
    for _ in range(33):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fe.device(clip)
        torch.cuda.synchronize()
        stage.append((time.perf_counter() - t0) * 1e3)
    stage_ms = float(np.median(stage[3:]))

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    print(f"  mel stage (34 s clip, synchronized, median of 30): "
          f"{stage_ms:.4f} ms")
    for name, r in out.items():
        lib = r["library_device_ms"]
        print(f"  {name}: kernel {r['device_ms']:.4f} ms"
              + ("" if lib is None else f", library {lib:.4f} ms, factor "
                 f"{r['device_ms'] / lib:.2f}")
              + (f", chain {r['chain_device_ms']:.4f} ms"
                 if "chain_device_ms" in r else ""))
    print(json.dumps({"tag": args.tag, "card": smi,
                      "package": os.path.dirname(
                          godot_whisper_tpu_torch.__file__),
                      "device_ms": out, "mel_stage_ms": stage_ms}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
