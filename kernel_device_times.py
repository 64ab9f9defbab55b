#!/usr/bin/env python3
"""CUDA-graph device times of the decode path's kernels and of their
library yardsticks, on one NVIDIA GPU.

    python3 kernel_device_times.py [--root DIR] [--tag NAME]

Times, at chip_smoke.py's shapes (bf16, random inputs from numpy seed 0):

- K3 / K4 ``decode_attention``: tiny.en self-attention at step 100 (5 rows,
  cache 512, prompt capacity 232), tiny.en cross-attention (kv_group 5,
  1536 slots, 1500 valid), large-v3 cross-attention (20 heads, S 1280);
- K7 ``split_beam_attention``: one stream of 5 beams, prompt and live
  capacity 256, lo 120, hi_live 100, at tiny.en and large-v3 widths;
- K9 ``quant_matmul``: the tiny.en logits (5, 384) x int8 (51864, 384)
  ``oi`` and the cross-K projection (1500, 384) x (384, 384) ``io``;
- K10 ``quant_matmul4``: (5, 384) x int4 (384, 1536);
- K11 / K12 ``cross_attention_quant``: large-v3 widths at beam 8 (exact)
  and tiny.en kv_group 5 (W8A8).

Each kernel wrapper is captured in a CUDA graph and replayed
(``chip_smoke.graph_ms``: the device time without the host's time to
enqueue the call), beside one PyTorch call computing the same function:
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

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def _chip_smoke():
    """This checkout's chip_smoke.py (for ``graph_ms``), whatever --root
    says."""
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
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
    cs = _chip_smoke()
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

    def record(name, fn, lib):
        fn()
        torch.cuda.synchronize()
        out[name] = {"device_ms": cs.graph_ms(torch, fn),
                     "library_device_ms": cs.graph_ms(torch, lib)}

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
            ("K9 oi tiny.en logits", "int8", "oi", 5, 384, 51864),
            ("K9 io tiny.en cross-K", "int8", "io", 1500, 384, 384),
            ("K10 tiny.en mlp.w0", "int4", "io", 5, 384, 1536)):
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
    for name, s, h, kg, n_layer, w8a8 in (
            ("K12 tiny.en kv_group 5 W8A8", 384, 6, 5, 4, True),
            ("K11 large-v3 beam 8", 1280, 20, 8, 3, False)):
        k, v = tens(n_layer, 1, 1536, s), tens(n_layer, 1, 1536, s)
        x = quantize_cross_kv(CrossKV(k, v, 1500), h)
        q = tens(kg, s)
        lo = torch.full((kg,), 1500, dtype=torch.int32, device=dev)
        d = s // h
        kd = (x.k_q[-1, 0].float().view(1536, h, d)
              * x.k_s[-1, 0, :, :h].float()[..., None])
        vd = x.v_q[-1, 0].float().view(1536, h, d) * x.v_s[-1, 0, :h, None]
        kd = kd.to(torch.bfloat16).transpose(0, 1)[None].expand(kg, h, 1536,
                                                                d)
        vd = vd.to(torch.bfloat16).transpose(0, 1)[None].expand(kg, h, 1536,
                                                                d)
        qd = q.view(kg, h, 1, d)
        mask = (torch.arange(1536, device=dev) < 1500)[None, None, None]
        record(name, lambda q=q, x=x, lo=lo, h=h, kg=kg, n_layer=n_layer,
               w8a8=w8a8: CA.cross_attention_quant(
                   q, x.k_q, x.k_s, x.v_q, x.v_s, n_head=h, t_valid=lo,
                   kv_group=kg, layer=n_layer - 1, w8a8=w8a8),
               lambda qd=qd, kd=kd, vd=vd, mask=mask: sdpa(
                   qd, kd, vd, attn_mask=mask))

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    for name, r in out.items():
        print(f"  {name}: kernel {r['device_ms']:.4f} ms, library "
              f"{r['library_device_ms']:.4f} ms, factor "
              f"{r['device_ms'] / r['library_device_ms']:.2f}")
    print(json.dumps({"tag": args.tag, "card": smi,
                      "package": os.path.dirname(
                          godot_whisper_tpu_torch.__file__),
                      "device_ms": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
