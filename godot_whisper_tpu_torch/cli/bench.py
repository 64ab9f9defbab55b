"""Benchmark CLI, port of the JAX package's ``cli/bench.py`` — the
``examples/bench`` + in-library microbench equivalents (whisper.cpp
examples/bench/bench.cpp encoder-only timing; whisper_bench_memcpy /
whisper_bench_ggml_mul_mat, whisper.cpp:6027-6296).

    python -m godot_whisper_tpu_torch.cli.bench --what encoder -m tiny.en
    python -m godot_whisper_tpu_torch.cli.bench --what memcpy
    python -m godot_whisper_tpu_torch.cli.bench --what matmul
    python -m godot_whisper_tpu_torch.cli.bench --what kernels
    python -m godot_whisper_tpu_torch.cli.bench --what sweep -o sweep.csv
    python -m godot_whisper_tpu_torch.cli.bench --what e2e

Every mode measures the card given by ``--device`` (default ``cuda``) and
raises without one; only ``sweep`` also runs on ``--device cpu``, and its
CSV names the device of every row.  Every mode prints ``system_info()``
first, and every number comes with the card's name and power limit
(``nvidia-smi``).  ``kernels`` prints one JSON line per hand-written
kernel (K1-K13) in the JAX package's keys; its peaks are the H100 SXM's
(989e12 bf16 operations/s, 3.35e12 bytes/s), overridden by
``GWT_PEAK_FLOPS`` / ``GWT_PEAK_BW`` (the TF32 and f32 peaks scale with
the bf16 one).  ``e2e`` measures tiny.en in-process; the root
``bench.py`` is the JAX package's driver and is not called.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Callable, List, NamedTuple, Optional

import numpy as np

H100_PEAK_BF16 = 989e12   # dense tensor-core bf16, operations/s
H100_PEAK_TF32 = 495e12   # dense tensor-core TF32
H100_PEAK_F32 = 67e12     # f32 outside the tensor cores
H100_HBM_BW = 3.35e12     # HBM3, bytes/s
MAX_ROOFLINE_FRAC = 1.05  # a kernel faster than its bound is a mismeasure
GRAPH_CALLS = 10          # chained calls of a kernel per CUDA graph


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    return out.splitlines()[0] if out else "nvidia-smi: no output"


def _card(device):
    """``device`` resolved; a bench mode that times the card refuses any
    other device rather than measure the CPU instead."""
    import torch

    from ..runtime.device import resolve_device
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"this bench mode measures a CUDA device; got "
                           f"{dev}")
    torch.cuda.set_device(dev)
    return dev


def _event_ms(fn: Callable[[], object], n: int) -> float:
    """Mean ms of ``n`` calls between two CUDA events, after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def time_ms(fn: Callable[[], object], reps: int = 30) -> float:
    """Median of ``reps`` per-call CUDA-event times after a warm-up: the
    host's time to enqueue the call included."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def graph_ms(fn: Callable[[], object], reps: int = 20) -> float:
    """Device ms of one call: GRAPH_CALLS calls chained on one stream in a
    CUDA graph, replayed ``reps`` times between two events (the
    counterpart of the JAX bench's ``_loop_time``).  Unlike ``time_ms`` it
    leaves out the host's time to enqueue the call, which a short
    kernel's event time includes; with several calls per graph a kernel
    shorter than one graph launch on the host (about 6 us) is not timed
    at the host's launch rate."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(GRAPH_CALLS):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        g.replay()
    b.record()
    b.synchronize()
    del g
    return a.elapsed_time(b) / (reps * GRAPH_CALLS)


# ------------------------------------------------------------------- memcpy
def bench_memcpy(device="cuda") -> None:
    """Device copy bandwidth and host <-> device transfers from pinned and
    pageable memory (the memcpy bench, whisper.cpp:6027-6075)."""
    import torch
    dev = _card(device)
    print(card_line())
    n = 256 * 1024 * 1024 // 4
    x = torch.ones(n, dtype=torch.float32, device=dev)
    y = torch.empty_like(x)
    ms = _event_ms(lambda: y.copy_(x), 8)
    print(f"device copy: {2 * x.nbytes / 1e9 / (ms / 1e3):9.2f} GB/s")
    del x, y

    host = torch.ones(32 * 1024 * 1024 // 4, dtype=torch.float32)
    d = torch.empty_like(host, device=dev)
    for name, h in (("pageable", host), ("pinned", host.pin_memory())):
        for what, fn in (("host->device", lambda: d.copy_(h)),
                         ("device->host", lambda: h.copy_(d))):
            times = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            print(f"{what} ({name}): "
                  f"{h.nbytes / 1e9 / float(np.median(times)):9.2f} GB/s")


# ------------------------------------------------------------------- matmul
def bench_matmul(device="cuda") -> None:
    """GEMM sweep 64..4096 in f32 / bf16 / int8 (whisper_bench_ggml_mul_mat's
    role, whisper.cpp:6096-6296) through torch.matmul and torch._int_mm:
    library yardsticks (cuBLAS), not the port's kernels."""
    import torch
    dev = _card(device)
    print(card_line())
    print("library yardstick: torch.matmul (f32 without TF32, bf16 into "
          "f32) and torch._int_mm (int8 into int32)")
    torch.backends.cuda.matmul.allow_tf32 = False
    for size in (64, 128, 256, 512, 1024, 2048, 4096):
        for name in ("f32", "bf16", "int8"):
            if name == "int8":
                a = torch.ones((size, size), dtype=torch.int8, device=dev)
                b = torch.ones((size, size), dtype=torch.int8, device=dev)

                def mm(a=a, b=b):
                    return torch._int_mm(a, b)
            else:
                dt = torch.float32 if name == "f32" else torch.bfloat16
                a = torch.ones((size, size), dtype=dt, device=dev)
                b = torch.ones((size, size), dtype=dt, device=dev)

                def mm(a=a, b=b, dt=dt):
                    return (torch.matmul(a, b) if dt == torch.float32
                            else torch.mm(a, b, out_dtype=torch.float32))
            n_iter = max(4, 2048 // max(1, size // 64))
            ms = _event_ms(mm, n_iter)
            gflops = 2 * size ** 3 / (ms / 1e3) / 1e9
            print(f"{size:5d} x {size:5d}: {name:5s} {gflops:10.1f} GFLOPS")


# ------------------------------------------------------------------ encoder
def bench_encoder(model: str, n_iter: int, device="cuda") -> None:
    """Encoder-only time per 30 s window: ``encoder_forward`` + ``cross_kv``
    (examples/bench semantics)."""
    import torch

    import godot_whisper_tpu_torch as gwt
    dev = _card(device)
    print(card_line())
    ctx = gwt.WhisperContext.synthetic(model, device=dev)
    pipe = ctx.pipeline
    pipe.set_audio(np.zeros(30 * 16000, dtype=np.float32))
    pipe.encode_window(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_iter):
        pipe.encode_window(0)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n_iter
    print(f"{model} encoder: {dt * 1000:8.2f} ms / 30 s window "
          f"({30.0 / dt:8.1f}x realtime encode)")


# ------------------------------------------------------------------ kernels
def _peaks():
    flops = float(os.environ.get("GWT_PEAK_FLOPS", H100_PEAK_BF16))
    scale = flops / H100_PEAK_BF16
    return (float(os.environ.get("GWT_PEAK_BW", H100_HBM_BW)),
            {"bf16": flops, "tf32": H100_PEAK_TF32 * scale,
             "f32": H100_PEAK_F32 * scale})


def bound(n_bytes: float, n_ops: float, kind: str = "bf16",
          f32_ops: float = 0.0):
    """The least ms the card takes for the work, and what bounds it: the
    larger of ``n_bytes`` over HBM's rate and the operations over their
    peak (``n_ops`` at ``kind``'s, ``f32_ops`` more at the f32 one)."""
    bw, peaks = _peaks()
    t_b = n_bytes / bw
    t_o = max(n_ops / peaks[kind], f32_ops / peaks["f32"])
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


class KernelCase(NamedTuple):
    """One timed shape of a hand-written kernel.  ``run`` calls its
    wrapper, ``plain`` its plain PyTorch version, ``library`` one PyTorch
    call computing the same function (a yardstick the port never calls)
    or None.  ``n_bytes``: each input read once, each output written once;
    ``n_ops``: the operations these inputs need, at ``kind``'s peak
    ("bf16", "tf32" or "f32"), ``f32_ops`` more at the f32 peak."""
    key: str
    name: str
    run: Callable[[], object]
    plain: Callable[[], object]
    library: Optional[Callable[[], object]]
    n_bytes: float
    n_ops: float
    kind: str
    f32_ops: float = 0.0
    reps: int = 30


def time_case(c: KernelCase) -> dict:
    """Event ms (``time_ms``) and CUDA-graph device ms (``graph_ms``) of
    the kernel and of its library call, the plain version's event ms, and
    the bound."""
    b_ms, by = bound(c.n_bytes, c.n_ops, c.kind, c.f32_ops)
    r = dict(ms=time_ms(c.run, c.reps), device_ms=graph_ms(c.run),
             plain_ms=time_ms(c.plain, c.reps), library_ms=None,
             library_device_ms=None, bound_ms=b_ms, bound_by=by)
    if c.library is not None:
        r.update(library_ms=time_ms(c.library, c.reps),
                 library_device_ms=graph_ms(c.library))
    return r


def _sdpa_masked(q, k, v, n_valid: int):
    """SDPA over (B, H, T, D) views with a boolean mask of the first
    ``n_valid`` keys."""
    import torch
    mask = (torch.arange(k.shape[2], device=k.device) < n_valid)[
        None, None, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(q, k, v, attn_mask=mask)


def qmm_case(dev, rng, key: str, kind: str, layout: str, m: int, s: int,
             o: int) -> KernelCase:
    """K9 (``kind`` "int8", ``layout`` "io" or "oi") or K10 ("int4") on
    (m, s) bf16 rows times an (s, o) weight quantized from N(0, 0.02);
    the library call is torch.mm on the weight held in bf16."""
    import torch

    from ..ops import qmatmul as Q
    x = torch.from_numpy(rng.standard_normal((m, s)).astype(
        np.float32)).to(dev, torch.bfloat16)
    w = torch.from_numpy((rng.standard_normal((s, o)) * 0.02).astype(
        np.float32)).to(dev)
    if kind == "int4":
        qt = Q.quantize_tensor4(w)
        w_deq = Q.dequantize4(qt)
        run, plain = (lambda: Q.quant_matmul4(x, qt),
                      lambda: Q.quant_matmul4_plain(x, qt))
        w_bytes, name = s * o // 2 + (s // qt.group) * o * 4, "K10"
    else:
        qt = (Q.quantize_tensor(w.t().contiguous(), reduce_axis=1)
              if layout == "oi" else Q.quantize_tensor(w, reduce_axis=0))
        w_deq = Q.dequantize(qt)
        w_deq = w_deq.t() if layout == "oi" else w_deq
        run, plain = (lambda: Q.quant_matmul(x, qt, layout=layout),
                      lambda: Q.quant_matmul_plain(x, qt, layout=layout))
        w_bytes, name = s * o + o * 4, "K9"
    w_bf16 = w_deq.to(torch.bfloat16)
    return KernelCase(
        key, f"{name} {kind} {layout} ({m}, {s}) x ({s}, {o})", run, plain,
        lambda: torch.mm(x, w_bf16, out_dtype=torch.float32),
        w_bytes + m * s * 2 + m * o * 4, 2 * m * s * o, "bf16")


def route_cases(dev) -> List[KernelCase]:
    """K9's and K10's other routes on the tiny.en paths (the logits
    projection through K9's ``oi`` rows; the 1500-row cross-K projection
    through K9's and K10's tensor-core routes), beside ``kernel_cases``'
    one line a kernel."""
    rng = np.random.default_rng(1)
    return [qmm_case(dev, rng, "qmatmul", "int8", "oi", 5, 384, 51864),
            qmm_case(dev, rng, "qmatmul_xk", "int8", "io", 1500, 384, 384),
            qmm_case(dev, rng, "qmatmul4_tc", "int4", "io", 1500, 384, 384)]


def kernel_cases(dev) -> List[KernelCase]:
    """K1-K13, one case each, at the main paths' shapes (tiny.en widths;
    K8 and K11 at large-v3 widths, K13 at an n_audio_ctx of 2000)."""
    import torch

    from ..audio.mel import mel_filterbank, pad_audio
    from ..models.config import get_config
    from ..models.model import CrossKV, quantize_cross_kv
    from ..ops import attention as A
    from ..ops import cross_attention as CA
    from ..ops import decode_attention as D
    from ..ops import filter_sample as FS
    from ..ops import kv_reorder as R
    from ..ops import mel_kernel as M
    from ..ops import split_attention as SA

    rng = np.random.default_rng(0)

    def tens(*shape, dtype=torch.bfloat16, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to(dev, dtype)

    cases = []

    # K1: a 34 s clip bucketed to 90 s, 80 mels; the DFT counted once at
    # the TF32 rate (the split route's second pass only recovers f32
    # accuracy), the power (3 x 201 a frame) and the sparse filterbank (2
    # nnz a frame) at the f32 rate
    t = np.arange(34 * 16000) / 16000.0
    padded = pad_audio((0.3 * np.sin(2 * np.pi * 220.0 * t)).astype(
        np.float32))
    padded = np.pad(padded, (0, -(-len(padded) // 480000) * 480000
                             - len(padded)))
    a16 = torch.from_numpy(padded.astype(np.float16)).to(dev)[None]
    basis_np, filt_np = M.dft_basis(), mel_filterbank(80)
    basis = torch.from_numpy(basis_np).to(dev)
    filt = torch.from_numpy(filt_np).to(dev)
    tables = M.mel_tables(basis, filt)
    mel = M.log_mel_raw(a16, tables)
    n_frames, nnz = mel.shape[2], int((filt_np != 0).sum())
    # the kernel's tables, counted from their host copies
    runs, weights = M.mel_runs(filt_np)
    tables_bytes = (M.frag_basis(basis_np).nbytes + runs.nbytes
                    + weights.nbytes)
    cases.append(KernelCase(
        "mel", "K1 log_mel_raw (34 s in a 90 s bucket, 80 mels)",
        lambda: M.log_mel_raw(a16, tables),
        lambda: M.log_mel_raw_plain(a16, basis, filt), None,
        a16.numel() * 2 + tables_bytes + mel.numel() * 4,
        2 * n_frames * 400 * 402, "tf32",
        f32_ops=n_frames * (3 * 201 + 2 * nnz)))

    # K2: encoder self-attention, 6 heads of 64, bf16
    q, k, v = (tens(6, 1536, 64) for _ in range(3))
    cases.append(KernelCase(
        "enc_attn", "K2 flash_attention_bh (6, 1536, 64) t_valid 1500",
        lambda: A.flash_attention_bh(q, k, v, t_valid=1500),
        lambda: A.attention_bh_sp_plain(q, k, v, 1500),
        _sdpa_masked(*(x.view(1, 6, 1536, 64) for x in (q, k, v)), 1500),
        4 * 6 * 1536 * 64 * 2, 4 * 6 * 1536 * 1500 * 64, "bf16"))

    # K3: tiny.en self-attention at step 100 (prompt capacity 232, 102
    # slots a row), hi read on the device as the token loop's graph
    # passes it; K4: cross-attention, 5 rows sharing 1500 slots.  The
    # library call: SDPA with a boolean key mask
    def dattn(key, name, kv_group, c, lo, split, hi, layer, row_slots,
              kv_slots):
        b, s, h = 5, 384, 6
        qd = tens(b, s)
        kd, vd = (tens(4, b // kv_group, c, s) for _ in range(2))
        lo_t = torch.tensor(lo, dtype=torch.int32, device=dev)
        hi_k = (torch.tensor([hi], dtype=torch.int32, device=dev) if hi
                else hi)
        kw = dict(split=split, n_head=h, kv_group=kv_group, layer=layer)
        ql = qd.view(b, h, 1, s // h)
        kl, vl = (x[layer].view(-1, c, h, s // h).transpose(1, 2).expand(
            b, h, c, s // h) for x in (kd, vd))
        slot = torch.arange(c, device=dev)
        mask = ((slot[None] < lo_t[:, None])
                | ((slot[None] >= split) & (slot[None] < hi)))[:, None, None]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        cases.append(KernelCase(
            key, name,
            lambda: D.decode_attention(qd, kd, vd, lo_t, hi_k, **kw),
            lambda: D.decode_attention_plain(qd, kd, vd, lo_t, hi, **kw),
            lambda: sdpa(ql, kl, vl, attn_mask=mask),
            2 * kv_slots * s * 2 + b * s * 2 + b * s * 4,
            4 * row_slots * s, "bf16"))
    dattn("decode_attn_k3",
          "K3 decode_attention self (5 rows, C 512, step 100, hi on the "
          "device)", 1, 512,
          [1] * 5, 232, 333, 2, 5 * 102, 5 * 102)
    dattn("decode_attn_k4",
          "K4 decode_attention cross (5 rows, kv_group 5, 1500 slots)", 5,
          1536, [1500] * 5, 1536, 0, 3, 5 * 1500, 1500)

    # K5 / K6: filters + sample / top-5 over (5, 51864) raw logits, the
    # initial, mid-sequence and timestamp states
    cfg = get_config("tiny.en")
    V, beg = cfg.n_vocab, cfg.token_beg
    logits = tens(5, V, dtype=torch.float32, scale=3.0)
    sup = torch.zeros(V, dtype=torch.bool, device=dev)
    sup[[cfg.token_not, cfg.token_sot, cfg.token_nosp, cfg.token_solm,
         cfg.token_translate, cfg.token_transcribe, cfg.token_prev]] = True
    state = torch.tensor([[1, -1, -1, 0, 0, 3000, 1],
                          [0, beg + 5, 77, 5, 1, 10, 1],
                          [0, 123, beg + 3, 7, 1, 6, 0],
                          [0, 321, 322, 9, 0, 3000, 0],
                          [1, -1, -1, 0, 0, 3000, 0]], dtype=torch.int32,
                         device=dev)
    fkw = dict(temperature=0.0, eot=cfg.token_eot, beg=beg, space_id=220,
               max_initial_tid=50, suppress_blank=True, no_timestamps=False)
    head = 5 * V * 4 + V + state.numel() * 4
    cases.append(KernelCase(
        "filter_sample", "K5 fused_filter_sample (5, 51864)",
        lambda: FS.fused_filter_sample(logits, sup, state, seed=0, **fkw),
        lambda: FS.fused_filter_sample_plain(logits, sup, state, seed=0,
                                             **fkw), None,
        head + 5 * 6 * 4, 5 * V * 30, "f32"))
    cases.append(KernelCase(
        "filter_topk", "K6 fused_filter_topk (5, 51864) K 5",
        lambda: FS.fused_filter_topk(logits, sup, state, K=5, **fkw),
        lambda: FS.fused_filter_topk_plain(logits, sup, state, K=5, **fkw),
        None, head + 5 * (3 * 5 + 3) * 4, 5 * V * (30 + 2 * 5), "f32"))

    # K7: beam 5 over a shared 120-token prompt and 100 live slots
    # through a row map; the library call: SDPA over the same keys
    # gathered into one cache per beam beforehand
    B, L, NL, lo_v, hi_live, h, dh = 5, 4, 256, 120, 100, 6, 64
    qs = tens(B, 384)
    kp, vp = (tens(L, 1, 256, 384) for _ in range(2))
    kl, vl = (tens(L, B, NL, 384) for _ in range(2))
    lo_s = torch.full((B,), lo_v, dtype=torch.int32, device=dev)
    rowmap = torch.from_numpy(rng.integers(0, B, (B, NL)).astype(
        np.int32)).to(dev)
    skw = dict(n_head=h, kv_group=B, layer=L - 1, rowmap=rowmap)
    rows = rowmap[:, :hi_live].long()
    slots = torch.arange(hi_live, device=dev)[None]

    def gathered(p_, l_):
        full = torch.cat([p_[L - 1, :, :lo_v].expand(B, lo_v, 384),
                          l_[L - 1][rows, slots]], dim=1)
        return full.view(B, -1, h, dh).transpose(1, 2).contiguous()
    kf, vf, qf = gathered(kp, kl), gathered(vp, vl), qs.view(B, h, 1, dh)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    cases.append(KernelCase(
        "split_attn", "K7 split_beam_attention (beam 5, prompt 120, live "
        "100)",
        lambda: SA.split_beam_attention(qs, kp, vp, kl, vl, lo_s, hi_live,
                                        **skw),
        lambda: SA.split_beam_attention_plain(qs, kp, vp, kl, vl, lo_s,
                                              hi_live, **skw),
        lambda: sdpa(qf, kf, vf),
        2 * lo_v * 384 * 2 + 2 * B * hi_live * 384 * 2 + B * 384 * 2
        + B * 384 * 4 + B * hi_live * 4 + B * 4,
        4 * B * (lo_v + hi_live) * 384, "bf16"))

    # K8: large-v3 widths, 3 layers, beam 8, 332 live slots; the library
    # call: index_select of the whole caches
    kc, vc = (tens(3, 8, 512, 1280) for _ in range(2))
    out = (torch.empty_like(kc), torch.empty_like(vc))
    src = torch.from_numpy(rng.integers(0, 8, 8).astype(np.int32)).to(dev)
    cases.append(KernelCase(
        "kv_reorder", "K8 reorder_kv_live (3, 8, 512, 1280) hi 332",
        lambda: R.reorder_kv_live(kc, vc, src, 332, out=out),
        lambda: R.reorder_kv_live_plain(kc, vc, src, 332),
        lambda: (torch.index_select(kc, 1, src),
                 torch.index_select(vc, 1, src)),
        2 * 2 * 3 * 8 * 332 * 1280 * 2 + 8 * 4, 0, "bf16"))

    # K9 / K10: the decode rows' projections (5 rows of tiny.en's wqkv,
    # int8; of its mlp.w0, int4)
    cases.append(qmm_case(dev, rng, "qmatmul_io", "int8", "io", 5, 384,
                          1152))
    cases.append(qmm_case(dev, rng, "qmatmul4", "int4", "io", 5, 384, 1536))

    # K11 / K12: int8 cross-attention over 1500 valid slots (K11 large-v3
    # beam 8, exact; K12 tiny.en kv_group 5, W8A8); the library call: SDPA
    # over K/V dequantized beforehand.  Bytes: int8 K/V and the n_head
    # bf16 k_s of the 1500 valid slots, the n_head f32 v_s, q and lo in,
    # f32 out (the zero lanes of the padded scales are not needed)
    def xattn(key, name, s, h, kg, n_layer, w8a8):
        x = quantize_cross_kv(CrossKV(tens(n_layer, 1, 1536, s),
                                      tens(n_layer, 1, 1536, s), 1500), h)
        qx = tens(kg, s)
        lo_x = torch.full((kg,), 1500, dtype=torch.int32, device=dev)
        kw = dict(n_head=h, kv_group=kg, layer=n_layer - 1)
        d = s // h
        kd = (x.k_q[-1, 0].float().view(1536, h, d)
              * x.k_s[-1, 0, :, :h].float()[..., None])
        vd = x.v_q[-1, 0].float().view(1536, h, d) * x.v_s[-1, 0, :h, None]
        kd, vd = (y.to(torch.bfloat16).transpose(0, 1)[None].expand(
            kg, h, 1536, d) for y in (kd, vd))
        cases.append(KernelCase(
            key, name,
            lambda: CA.cross_attention_quant(
                qx, x.k_q, x.k_s, x.v_q, x.v_s, t_valid=lo_x, w8a8=w8a8,
                **kw),
            lambda: CA.cross_attention_quant_plain(
                qx, x.k_q, x.k_s, x.v_q, x.v_s, lo_x, w8a8=w8a8, **kw),
            _sdpa_masked(qx.view(kg, h, 1, d), kd, vd, 1500),
            2 * 1500 * s + 1500 * h * 2 + h * 4 + kg * s * 2 + kg * s * 4
            + kg * 4, 4 * kg * 1500 * s, "bf16"))
    xattn("xattn_wide", "K11 xattn_q_wide (large-v3 beam 8, exact)", 1280,
          20, 8, 3, False)
    xattn("xattn_packed", "K12 xattn_q_packed (tiny.en kv_group 5, W8A8)",
          384, 6, 5, 4, True)

    # K13: encoder self-attention past 1536 frames (n_audio_ctx 2000)
    q2, k2, v2 = (tens(6, 2048, 64) for _ in range(3))
    cases.append(KernelCase(
        "enc_attn_long", "K13 flash_attention_long (6, 2048, 64) t_valid "
        "2000",
        lambda: A.flash_attention_long(q2, k2, v2, t_valid=2000),
        lambda: A.attention_bh_blocked_plain(q2, k2, v2, 2000),
        _sdpa_masked(*(x.view(1, 6, 2048, 64) for x in (q2, k2, v2)), 2000),
        4 * 6 * 2048 * 64 * 2, 4 * 6 * 2000 * 2000 * 64, "bf16", reps=10))
    return cases


def bench_kernels(device="cuda") -> List[dict]:
    """Roofline suite: one JSON line per kernel K1-K13 in the JAX bench's
    keys (``kernel``, ``us_per_call`` the CUDA-graph device time,
    ``achieved``, ``unit``, ``roofline_frac`` = bound / device time), plus
    ``key``, ``bound_by`` and ``time_case``'s ms columns unrounded.
    Raises if a share exceeds MAX_ROOFLINE_FRAC."""
    import torch
    dev = _card(device)
    print(card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    recs = []
    for c in kernel_cases(dev):
        r = time_case(c)
        s = r["device_ms"] * 1e-3
        frac = r["bound_ms"] / r["device_ms"]
        if r["bound_by"] == "bytes":
            rate, unit = c.n_bytes / s, "GB/s"
        else:
            rate, unit = (c.n_ops + c.f32_ops) / s, "GFLOPS"
        rec = {"kernel": c.name, "us_per_call": round(s * 1e6, 2),
               "achieved": round(rate / 1e9, 1), "unit": unit,
               "roofline_frac": round(frac, 3), "key": c.key, **r}
        if frac > MAX_ROOFLINE_FRAC:
            raise RuntimeError(f"{c.name}: {frac:.3f} of its bound, faster "
                               "than the card can be: a mismeasure")
        print(json.dumps(rec), flush=True)
        recs.append(rec)
    return recs


# -------------------------------------------------------------------- sweep
def bench_sweep(models, batches, audio_seconds: float, out_csv,
                device="cuda") -> None:
    """Model x batch-size throughput sweep -> CSV through the port's
    BatchTranscriber — the analogue of the reference's ``extra/bench.py``
    (whisper.cpp README.md:742-752).  The ``device`` column names where
    each row ran."""
    import csv

    import torch

    import godot_whisper_tpu_torch as gwt
    from ..parallel.batch import BatchTranscriber
    from ..runtime.device import resolve_device

    dev = resolve_device(device)
    where = card_line() if dev.type == "cuda" else "cpu"
    w = csv.writer(out_csv)
    w.writerow(["model", "batch", "audio_s", "wall_s", "audio_s_per_s",
                "device"])
    for model in models:
        ctx = gwt.WhisperContext.synthetic(model, seed=0, device=dev)
        tp = gwt.TranscribeParams(best_of=1, temperature_inc=0.0,
                                  print_progress=False)
        rng = np.random.default_rng(0)

        def make():
            t = np.arange(int(audio_seconds * 16000)) / 16000.0
            return (0.2 * np.sin(2 * np.pi * 220 * t)
                    + 0.01 * rng.standard_normal(len(t))).astype(np.float32)

        bt = BatchTranscriber(ctx)
        for nb in batches:
            clips = [make() for _ in range(nb)]
            bt.transcribe(clips, tp)          # warm-up
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            bt.transcribe(clips, tp)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            total = nb * audio_seconds
            w.writerow([model, nb, total, round(dt, 3), round(total / dt, 2),
                        where])
            out_csv.flush()
            print(f"{model} B={nb}: {total / dt:.2f} audio-s/s on {where}",
                  file=sys.stderr)
        del ctx, bt


# ---------------------------------------------------------------------- e2e
def make_audio(seconds: float, sr: int = 16000, seed: int = 0) -> np.ndarray:
    """Synthetic speech-like audio: AM-modulated harmonics + noise (the
    root ``bench.py``'s recipe)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    f0 = 120 + 30 * np.sin(2 * np.pi * 0.5 * t)
    x = np.zeros_like(t)
    for h in (1, 2, 3):
        x += np.sin(2 * np.pi * f0 * h * t) / h
    envelope = 0.5 * (1 + np.sin(2 * np.pi * 2.3 * t))
    x = 0.2 * x * envelope + 0.01 * rng.standard_normal(len(t))
    return x.astype(np.float32)


def bench_e2e(model: str = "tiny.en", audio_seconds: float = 30.0,
              reps: int = 3, device="cuda") -> dict:
    """Single-stream ``full(TranscribeParams())`` on synthetic bf16 weights:
    the median of ``reps`` walls after one warm-up, as audio-s/s; and
    ``device_decode_rtf``, audio seconds per second of the pipeline's
    decode and encode buckets (``Timings``: host clocks around the decode
    loop, mel excluded) in the median run.  One JSON line."""
    import torch

    import godot_whisper_tpu_torch as gwt
    dev = _card(device)
    ctx = gwt.WhisperContext.synthetic(model, seed=0, device=dev)
    tp = gwt.TranscribeParams()
    audio = make_audio(audio_seconds)
    ctx.full(tp, audio)
    runs = []
    for _ in range(reps):
        ctx.reset_timings()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        ctx.full(tp, audio)
        torch.cuda.synchronize(dev)
        tm = ctx.timings
        runs.append((time.perf_counter() - t0,
                     (tm.t_decode_us + tm.t_encode_us) / 1e6))
    wall, dec = sorted(runs)[len(runs) // 2]
    name, _, limit = card_line().partition(", ")
    out = {"metric": f"{model} e2e audio-s/s (bf16 synthetic weights, "
                     f"default TranscribeParams, {audio_seconds:g} s)",
           "value": round(audio_seconds / wall, 3), "unit": "audio_s/s",
           "walls_s": [round(w, 3) for w, _ in runs],
           "device_decode_rtf": round(audio_seconds / dec, 3),
           "card": name or torch.cuda.get_device_name(dev),
           "power_limit": limit or None}
    print(json.dumps(out), flush=True)
    return out


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="gwt-bench-torch")
    p.add_argument("--what",
                   choices=["encoder", "memcpy", "matmul", "e2e",
                            "kernels", "sweep"],
                   default="encoder")
    p.add_argument("-m", "--model", default="tiny.en")
    p.add_argument("-n", "--iterations", type=int, default=8)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; only --what sweep "
                        "runs on cpu)")
    p.add_argument("--models", default="tiny.en,base.en,small.en",
                   help="sweep: comma list of model names")
    p.add_argument("--batches", default="1,8,16",
                   help="sweep: comma list of batch sizes")
    p.add_argument("--audio-seconds", type=float, default=None,
                   help="sweep: seconds a clip (default 60); e2e: the clip "
                        "(default 30)")
    p.add_argument("-o", "--output", default="-",
                   help="sweep: CSV path (default stdout)")
    args = p.parse_args(argv)

    from ..runtime.cache import enable_compilation_cache
    from ..runtime.logging import system_info
    enable_compilation_cache()
    print(system_info())

    if args.what == "memcpy":
        bench_memcpy(args.device)
    elif args.what == "matmul":
        bench_matmul(args.device)
    elif args.what == "kernels":
        bench_kernels(args.device)
    elif args.what == "sweep":
        models = [m for m in args.models.split(",") if m]
        batches = [int(b) for b in args.batches.split(",") if b]
        seconds = args.audio_seconds or 60.0
        if args.output == "-":
            bench_sweep(models, batches, seconds, sys.stdout, args.device)
        else:
            with open(args.output, "w", newline="") as f:
                bench_sweep(models, batches, seconds, f, args.device)
    elif args.what == "e2e":
        bench_e2e(args.model, args.audio_seconds or 30.0,
                  device=args.device)
    else:
        bench_encoder(args.model, args.iterations, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
