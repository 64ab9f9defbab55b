#!/usr/bin/env python3
"""Chip smoke test of godot_whisper_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase carries on past its own):

1. build  -- compile every CUDA kernel of the port from csrc/ with nvcc
   (one process per source, in parallel); print the build seconds and
   ptxas's register / spill lines.
2. kernels -- each kernel against its plain PyTorch version on the card,
   at the tiny.en main-path shapes and at large-v3 widths, with the
   tolerance stated; then times of kernel, plain version and, where one
   exists, a single PyTorch library call computing the same function (a
   yardstick only; the port never calls it): CUDA events around one call
   (median; the wrapper's host time included) and, for the kernel and the
   library call, the device time of the call captured in a CUDA graph and
   replayed.  The split-cache decode attentions (K3/K4, K7) are also
   checked at their edge cases (step 0, a row that attends only the
   current token, kv_group 8 at large-v3 widths, capacities the slices do
   not divide) and for bitwise-equal results from call to call.
   Beam search's kernels too: K6 filter + top-K, K7 split prompt / live
   attention (with a permuted row map) and K8 the bounded cache reorder
   (into a NaN-filled cache, then K3 over it).  And quantized decoding's:
   K9 int8 matmul (io and oi, decode rows and the 1500-row cross-K/V
   projection), K10 int4 matmul, K11 / K12 int8 cross-attention (exact
   and W8A8).  And the long-context encoder attention K13 at phase 10's
   shape and at large-v3 widths, f32 and bf16.  The bf16 encoder
   attentions (K2, K13) run on the tensor cores; each is held to its own
   function's plain version within a limit that the other function breaks
   (a control), and the registers, spills and shared memory of their
   tensor-core kernels are printed from ptxas's log.
3. golden -- the nano model (numpy seed 3, f32) on the card reproduces
   tests/golden/nano_decode.json["greedy"] and ["beam5"] (K6 + K7) and
   the clip scenarios "multiwindow" and "translate" of
   tests/golden/nano_clip_scenarios.json token for token.
4. main path -- WhisperContext.synthetic("tiny.en", seed=0) (bf16)
   .full(TranscribeParams(), 34 s of audio) with every launch counter set
   to 0 just before; every kernel of the greedy path must have launched.
5. beam path -- the same context .full(TranscribeParams(strategy=
   BEAM_SEARCH), the same audio), counters zeroed just before; K6 and K7
   must have launched and K4 with kv_group 5.
6. wide beam route -- large-v3 widths (S 1280, 20 heads, 128 mels) with
   the depth cut to 2 + 3 layers, beam 8 (8 x 20 heads > 128: the merged
   cache), 10 s of audio, counters zeroed just before; K8 must have
   launched and K7 not.
7. quantized paths -- (1) synthetic("tiny.en", seed=0, quantize="int8")
   .full(TranscribeParams(cross_kv_int8=True), 34 s): K9 (io and oi) and
   K12 must launch, and no cross-attention through K4 (kv_group 5);
   (2) quantize="int4" with TranscribeParams(strategy=BEAM_SEARCH,
   cross_kv_int8=True): K10, K9 (oi), K12, K6 and K7 must launch.
   Counters zeroed just before each.
8. wide quantized route -- phase 6's large-v3 widths with quantize="int4",
   cross_kv_int8 and beam 8 (8 x 20 heads > 128): K11, K10 and K8 must
   launch, K12 must not.
9. file path -- phase 4's bf16 weights exported as an F32 ggml file (the
   port's exporter), WhisperContext.from_file and from_buffer of it, each
   .full(TranscribeParams(), 34 s): segments equal phase 4's token for
   token.  Then the CLI in-process on a 44.1 kHz WAV, from the same
   weights with the decoder's final LayerNorm gain at 8x (segments of
   several tokens): with every output writer and --max-len 5 (every file
   written and parsed, more segments than without --max-len), and a
   multilingual tiny checkpoint with -l auto --detect-language (a language
   printed).  Files go to a temporary directory.
10. long audio context (K13) -- tiny.en widths at full depth with
   n_audio_ctx 2000 (40 s windows), random weights exported as F16 and
   loaded through from_file, .full(TranscribeParams(), 90 s), counters
   zeroed just before: K13 must launch 4 times per window (4 audio
   layers), K2 never; K1, K3/K4 and K5 must launch.

Then one ``{"kernels": [...]}`` line, the card's name and power limit, and
the final ``{"ok": true, "device": {...}}`` line.  Imports no JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
PEAK_BF16 = 989e12            # dense tensor-core bf16
PEAK_F32 = 67e12              # f32 outside the tensor cores
TPU_OPS = "godot_whisper_tpu/ops/"


def log(*a):
    print(*a, flush=True)


def fail(msg: str) -> None:
    log(f"FAIL: {msg}")
    sys.exit(1)


def bound(n_bytes: float, n_ops: float, peak: float):
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, n_ops / peak
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")


def time_ms(torch, fn, reps: int = 30) -> float:
    """Median of per-call CUDA-event times after a warm-up."""
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


def graph_ms(torch, fn, reps: int = 20) -> float:
    """Device time of one call: ``fn`` captured once in a CUDA graph,
    replayed ``reps`` times between two events.  Unlike ``time_ms`` it
    leaves out the host's time to enqueue the call (a ctypes wrapper's
    or PyTorch's dispatch), which a short kernel's event time includes."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
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
    return a.elapsed_time(b) / reps


def timed(torch, fn, lib=None, reps: int = 30) -> dict:
    """Event time (``time_ms``) and CUDA-graph device time (``graph_ms``)
    of a kernel wrapper ``fn`` and, where one exists, of ``lib``, one
    PyTorch call computing the same function (a yardstick only)."""
    r = dict(ms=time_ms(torch, fn, reps), device_ms=graph_ms(torch, fn),
             library_ms=None, library_device_ms=None)
    if lib is not None:
        r.update(library_ms=time_ms(torch, lib, reps),
                 library_device_ms=graph_ms(torch, lib))
    return r


def tf32_round(torch, x):
    """f32 rounded to TF32's 10-bit mantissa (nearest), as tensor cores
    round GEMM inputs when TF32 is allowed."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def blocked_bf16_limit(torch, q, k, v, want, t_valid=None):
    """Per-element limit for K13 in bf16 held against its plain version:
    one bf16 ulp of the element (the output's own rounding), plus one
    flipped bf16 rounding of a probability in its row, 2^-8 max_j w_rj
    max_j |v_jc| with w the softmax weights (two implementations whose f32
    scores or exp differ in the last bit round a p that sits on a bf16
    midpoint differently), plus 1e-5 for f32 sums in another order.  It
    tells K13's function from K2's: the single-pass version exceeds it
    (``check_long_attention``'s control)."""
    t, d = k.shape[1], q.shape[-1]
    tv = t if t_valid is None else int(t_valid)
    s = torch.matmul(q.float(), k[:, :tv].float().transpose(1, 2)) * (
        d ** -0.5)
    w_max = torch.exp(s.amax(dim=-1, keepdim=True)
                      - torch.logsumexp(s, dim=-1, keepdim=True))
    v_max = v[:, :tv].float().abs().amax(dim=1, keepdim=True)
    a = torch.clamp_min(want.float().abs(), 2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(a)) - 7)
    return ulp + 2.0 ** -8 * w_max * v_max + 1e-5


def log_ptxas(logs, source: str, kernel: str, dynamic: bool = True) -> None:
    """Print registers, spills and shared memory of every instantiation of
    ``kernel`` in ``source``'s ``-Xptxas -v`` build log.  ``dynamic``: the
    bf16 encoder-attention kernels (templated on the head size D first),
    whose dynamic shared memory, which ptxas does not see, comes from the
    library; the split-cache decode kernels use static shared memory
    only."""
    from godot_whisper_tpu_torch.ops import kernels as K
    smem_of = (K.entry("enc_attn", "gwt_enc_attn_tc_smem", (K.I,))
               if dynamic else (lambda d: 0))
    text = logs.get(source, "")
    blocks = re.split(r"(?=ptxas info\s*: Compiling entry function)", text)
    found = False
    for b in blocks:
        head = re.search(r"Compiling entry function '([^']+)'", b)
        if not head or kernel not in head.group(1):
            continue
        found = True
        regs = re.search(r"Used (\d+) registers", b)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", b)
        stat = re.search(r"(\d+) bytes smem", b)
        d = re.search(r"ILi(\d+)E", head.group(1))
        smem = smem_of(int(d.group(1))) if d else "?"
        log(f"  [{source}] {head.group(1)}: "
            f"{regs.group(1) if regs else '?'} registers, spill stores/loads "
            f"{spill.group(1) + '/' + spill.group(2) if spill else '?'} "
            f"bytes, static smem {stat.group(1) if stat else 0} bytes, "
            f"dynamic smem {smem} bytes")
    if not found:
        log(f"  [{source}] {kernel}: not in this build's ptxas log")


def frozen_audio(seconds: float) -> np.ndarray:
    """The deterministic clip of tests/test_golden_decode.py."""
    t = np.arange(int(seconds * 16000)) / 16000.0
    x = (0.3 * np.sin(2 * np.pi * (220.0 + 60 * np.sin(
        2 * np.pi * 0.07 * t)) * t)
        + 0.2 * np.sin(2 * np.pi * 447.0 * t)
        * (0.5 + 0.5 * np.sin(2 * np.pi * 1.7 * t)))
    return x.astype(np.float32)


def golden_audio_5s() -> np.ndarray:
    t = np.arange(5 * 16000) / 16000.0
    x = (0.3 * np.sin(2 * np.pi * 220.0 * t)
         + 0.2 * np.sin(2 * np.pi * 447.0 * t)
         * (0.5 + 0.5 * np.sin(2 * np.pi * 1.7 * t)))
    return x.astype(np.float32)


# --------------------------------------------------------------- phase 2 --
def check_kernels(torch, gt, rng, ptx_logs):
    """Kernel vs plain version at the main-path and large-v3 shapes.
    Returns per-kernel records (max error, timings, bound)."""
    from godot_whisper_tpu_torch.audio.mel import frame_counts, pad_audio
    from godot_whisper_tpu_torch.ops import attention as A
    from godot_whisper_tpu_torch.ops import filter_sample as FS
    from godot_whisper_tpu_torch.ops import mel_kernel as M
    from godot_whisper_tpu_torch.audio.mel import mel_filterbank
    from godot_whisper_tpu_torch.models.config import get_config

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    recs = {}

    def tens(*shape, dtype=torch.float32, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).to(dev, dtype)

    # ---- K1 mel: 34 s clip bucketed to 60 s (tiny.en, 80 mels); large-v3
    # widths use 128 mels.  Compared over the frames of real audio only
    # (the zero tail clamps to the 1e-10 floor on both sides).  The limit
    # is set from the readings (1 f32 ulp, 4.8e-7); a control run of the
    # plain version with TF32-rounded GEMM inputs must exceed it, so the
    # check tells the f32 DFT this kernel exists for from a coarser one.
    audio = frozen_audio(34.0) + rng.standard_normal(34 * 16000).astype(
        np.float32) * 0.01
    n_real = frame_counts(len(audio))[1]
    padded = pad_audio(audio)
    bucket = -(-len(padded) // 480000) * 480000
    padded = np.pad(padded, (0, bucket - len(padded)))
    a16 = torch.from_numpy(padded.astype(np.float16)).to(dev)[None]
    basis = torch.from_numpy(M.dft_basis()).to(dev)
    mel_tol = 1e-4
    for n_mels, tag in ((80, "tiny.en"), (128, "large-v3")):
        filt = torch.from_numpy(mel_filterbank(n_mels)).to(dev)
        got = M.log_mel_raw(a16, basis, filt)
        sync()
        want = M.log_mel_raw_plain(a16, basis, filt)
        e_max = float((got - want)[..., :n_real].abs().max())
        frames = a16.float().unfold(-1, 400, 160)
        spec = tf32_round(torch, frames) @ tf32_round(torch, basis)
        power = spec[..., :201] ** 2 + spec[..., 201:] ** 2
        coarse = torch.log10(torch.clamp(
            tf32_round(torch, power) @ tf32_round(torch, filt).T,
            min=1e-10)).transpose(1, 2)
        e_tf32 = float((coarse - want)[..., :n_real].abs().max())
        log(f"K1 mel [{tag}] {tuple(got.shape)}, {n_real} real frames: "
            f"max_abs_err {e_max:.3e} (tol {mel_tol:g} in log10: f32 sums "
            f"in another order); TF32 control {e_tf32:.3e} (must exceed "
            "the tol)")
        if not e_max < mel_tol:
            fail("K1 mel disagrees with its plain version")
        if not e_tf32 > mel_tol:
            fail("K1 mel tolerance cannot tell a TF32 DFT from f32")
        if tag == "tiny.en":
            f = got.shape[2]
            L = a16.shape[1]
            ops = f * (400 * 201 * 4 + 201 * 3 + n_mels * 201 * 2)
            nbytes = L * 2 + basis.numel() * 4 + filt.numel() * 4 \
                + got.numel() * 4
            recs["mel"] = dict(
                err=e_max, bound=bound(nbytes, ops, PEAK_F32),
                plain_ms=time_ms(torch, lambda: M.log_mel_raw_plain(
                    a16, basis, filt)),
                **timed(torch, lambda: M.log_mel_raw(a16, basis, filt)))

    # ---- K2 encoder attention: (B*H, 1536, 64), t_valid 1500.  In bf16
    # the tensor-core kernel computes _flash_sp_kernel's single-pass
    # function and is held to attention_bh_sp_plain within
    # blocked_bf16_limit; K13's blocked function must break that limit
    # (the control), so the check tells the two functions apart.  The
    # shares of the einsum and of the function K2's card kernel computed
    # before the tensor-core redesign (f32 to the end, output rounded once)
    # are printed beside them.  f32: within 2e-4 of the einsum.
    log_ptxas(ptx_logs, "enc_attn", "enc_attn_tc_kernel")
    for bh, tag in ((6, "tiny.en"), (20, "large-v3")):
        q, k, v = (tens(bh, 1536, 64, dtype=torch.bfloat16) for _ in range(3))
        got = A.flash_attention_bh(q, k, v, t_valid=1500)
        sync()
        want = A.attention_bh_sp_plain(q, k, v, 1500)
        lim = blocked_bf16_limit(torch, q, k, v, want, 1500)
        err = (got.float() - want.float()).abs()
        e_max = float(err.max())

        def share(x):
            return float(((x.float() - want.float()).abs() / lim).max())
        e_rel = share(got)
        ctl = share(A.attention_bh_blocked_plain(q, k, v, 1500))
        old = share(A.attention_bh_plain(q.float(), k.float(), v.float(),
                                         1500).to(torch.bfloat16))
        ein = share(A.attention_bh_plain(q, k, v, 1500))
        log(f"K2 enc_attn bf16 [{tag}] {tuple(q.shape)}: max_abs_err "
            f"{e_max:.3e}, worst share of the per-element tol (one bf16 "
            f"ulp + one flipped bf16 rounding of p per row + 1e-5) "
            f"{e_rel:.3f} (must be <= 1); control, K13's blocked function: "
            f"share {ctl:.3f} (must be > 1); the old f32 card function "
            f"{old:.3f}, the einsum {ein:.3f}")
        if not e_rel <= 1.0:
            fail("K2 encoder attention disagrees with its plain version")
        if not ctl > 1.0:
            fail("K2: the bf16 tol does not tell the single-pass function "
                 "from the blocked one")
        qf, kf, vf = (x.float() for x in (q, k, v))
        gotf = A.flash_attention_bh(qf, kf, vf, t_valid=1500)
        sync()
        ef = float((gotf - A.attention_bh_plain(qf, kf, vf, 1500))
                   .abs().max())
        log(f"K2 enc_attn f32 [{tag}]: max_abs_err {ef:.3e} (tol 2e-4)")
        if not ef < 2e-4:
            fail("K2 f32 disagrees with its plain version")
        if tag == "tiny.en":
            mask = (torch.arange(1536, device=dev) < 1500)[None, None, None]
            q4, k4, v4 = (x.view(1, bh, 1536, 64) for x in (q, k, v))
            sdpa = torch.nn.functional.scaled_dot_product_attention
            ops = 4 * bh * 1536 * 1500 * 64
            nbytes = 4 * bh * 1536 * 64 * 2
            recs["enc_attn"] = dict(
                err=e_max, bound=bound(nbytes, ops, PEAK_BF16),
                ms=time_ms(torch, lambda: A.flash_attention_bh(
                    q, k, v, t_valid=1500)),
                plain_ms=time_ms(torch, lambda: A.attention_bh_sp_plain(
                    q, k, v, 1500)),
                library_ms=time_ms(torch, lambda: sdpa(q4, k4, v4,
                                                       attn_mask=mask)))
            r = recs["enc_attn"]
            r["device_ms"] = graph_ms(torch, lambda: A.flash_attention_bh(
                q, k, v, t_valid=1500))
            r["library_device_ms"] = graph_ms(
                torch, lambda: sdpa(q4, k4, v4, attn_mask=mask))
            log(f"  timed bf16: kernel {r['ms']:.4f} ms, bound "
                f"{r['bound'][0]:.5f} ms ({r['bound'][1]}), plain "
                f"{r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms; "
                f"device time (CUDA graph replay): kernel "
                f"{r['device_ms']:.4f} ms, SDPA "
                f"{r['library_device_ms']:.4f} ms")

    # ---- K5 filter + sample: 5 rows of raw logits; argmax and sampling
    # rows, initial and mid-sequence timestamp states
    for name in ("tiny.en", "large-v3"):
        cfg = get_config(name)
        V, beg = cfg.n_vocab, cfg.token_beg
        logits = tens(5, V, scale=3.0)
        sup = torch.zeros(V, dtype=torch.bool, device=dev)
        sup[[cfg.token_not, cfg.token_sot, cfg.token_nosp, cfg.token_solm,
             cfg.token_translate, cfg.token_transcribe,
             cfg.token_prev]] = True
        state = torch.tensor(
            [[1, -1, -1, 0, 0, 3000, 1],
             [0, beg + 5, 77, 5, 1, 10, 1],
             [0, 123, beg + 3, 7, 1, 6, 0],
             [0, 321, 322, 9, 0, 3000, 0],
             [1, -1, -1, 0, 0, 3000, 0]], dtype=torch.int32, device=dev)
        worst, tok_bad = 0.0, 0
        for temp, seed in ((0.0, 0), (0.4, 12345), (1.0, 777)):
            kw = dict(temperature=temp, seed=seed, eot=cfg.token_eot,
                      beg=beg, space_id=220, max_initial_tid=50,
                      suppress_blank=True, no_timestamps=False)
            got = FS.fused_filter_sample(logits, sup, state, **kw)
            sync()
            want = FS.fused_filter_sample_plain(logits, sup, state, **kw)
            tok_bad += int((got.token != want.token).sum())
            tok_bad += int((got.tid != want.tid).sum())
            for a, b in zip(got[1:5], want[1:5]):
                worst = max(worst, float((a - b).abs().max()))
        log(f"K5 filter_sample [{name}] (5, {V}) t in (0, 0.4, 1.0): "
            f"token/tid mismatches {tok_bad}, max_abs_err {worst:.3e} "
            "(tol: 0 mismatches; 1e-5 on p/plog/pt/ptsum)")
        if tok_bad or not worst < 1e-5:
            fail("K5 filter+sample disagrees with its plain version")
        if name == "tiny.en":
            kw = dict(temperature=0.0, seed=0, eot=cfg.token_eot, beg=beg,
                      space_id=220, max_initial_tid=50, suppress_blank=True,
                      no_timestamps=False)
            nbytes = 5 * V * 4 + V + state.numel() * 4 + 5 * 6 * 4
            ops = 5 * V * 30
            recs["filter_sample"] = dict(
                err=worst, bound=bound(nbytes, ops, PEAK_F32),
                plain_ms=time_ms(torch, lambda:
                                 FS.fused_filter_sample_plain(
                                     logits, sup, state, **kw)),
                **timed(torch, lambda: FS.fused_filter_sample(
                    logits, sup, state, **kw)))
    return recs


def check_beam_kernels(torch, rng):
    """K6 and K8 against their plain versions at the tiny.en beam path's
    shapes and large-v3 widths; then their times (K7 is
    ``check_split_attention``'s)."""
    from godot_whisper_tpu_torch.models.config import get_config
    from godot_whisper_tpu_torch.ops import decode_attention as D
    from godot_whisper_tpu_torch.ops import filter_sample as FS
    from godot_whisper_tpu_torch.ops import kv_reorder as R

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    recs = {}

    def tens(*shape, dtype=torch.float32, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).to(dev, dtype)

    # ---- K6 filter + top-K: beam 5 rows, step-0 and mid-sequence states,
    # a forced tie and two bit-identical rows
    for name in ("tiny.en", "large-v3"):
        cfg = get_config(name)
        V, beg = cfg.n_vocab, cfg.token_beg
        logits = tens(5, V, scale=3.0)
        logits[:, [17, 900, 20000]] = 30.0
        logits[4] = logits[3]
        sup = torch.zeros(V, dtype=torch.bool, device=dev)
        sup[[cfg.token_not, cfg.token_sot, cfg.token_nosp, cfg.token_solm,
             cfg.token_translate, cfg.token_transcribe,
             cfg.token_prev]] = True
        state = torch.tensor(
            [[1, -1, -1, 0, 0, 3000, 0],
             [0, beg + 5, 77, 5, 1, 10, 0],
             [0, 123, beg + 3, 7, 1, 6, 0],
             [0, 321, 322, 9, 0, 3000, 0],
             [0, 321, 322, 9, 0, 3000, 0]], dtype=torch.int32, device=dev)
        kw = dict(K=5, temperature=0.0, eot=cfg.token_eot, beg=beg,
                  space_id=220, max_initial_tid=50, suppress_blank=True,
                  no_timestamps=False)
        got = FS.fused_filter_topk(logits, sup, state, **kw)
        sync()
        want = FS.fused_filter_topk_plain(logits, sup, state, **kw)
        bad = int((got.ids != want.ids).sum()) + int(
            (got.tid != want.tid).sum())
        worst = max(float((getattr(got, n) - getattr(want, n)).abs().max())
                    for n in ("plog", "p", "pt", "ptsum"))
        twins = all(bool(torch.equal(t[3], t[4])) for t in got)
        log(f"K6 filter_topk [{name}] (5, {V}) K 5: id/tid mismatches {bad}, "
            f"max_abs_err {worst:.3e}, tie order {got.ids[3, :3].tolist()}, "
            f"identical rows equal {twins} (tol: 0 mismatches; 1e-5 on "
            "plog/p/pt/ptsum; ties lowest id first)")
        if (bad or not worst < 1e-5 or not twins
                or got.ids[3, :3].tolist() != [17, 900, 20000]):
            fail("K6 filter+top-K disagrees with its plain version")
        if name == "tiny.en":
            nbytes = 5 * V * 4 + V + state.numel() * 4 + 5 * (3 * 5 + 3) * 4
            ops = 5 * V * (30 + 2 * 5)
            recs["filter_topk"] = dict(
                err=worst, bound=bound(nbytes, ops, PEAK_F32),
                plain_ms=time_ms(torch, lambda: FS.fused_filter_topk_plain(
                    logits, sup, state, **kw)),
                **timed(torch, lambda: FS.fused_filter_topk(
                    logits, sup, state, **kw)))

    # ---- K8 bounded reorder at phase 6's cache (large-v3 widths, 3 text
    # layers, beam 8, capacity 512, 332 live slots) and at tiny.en's; the
    # destination starts as NaN, and K3 over the reordered cache must stay
    # finite and equal its plain version over index_select's result
    for L, B, C, S, hi, tag in ((3, 8, 512, 1280, 332, "large-v3 beam 8"),
                                (4, 5, 512, 384, 300, "tiny.en beam 5")):
        k, v = (tens(L, B, C, S, dtype=torch.bfloat16) for _ in range(2))
        src = torch.from_numpy(rng.integers(0, B, B).astype(np.int32)).to(dev)
        out = (torch.full_like(k, float("nan")),
               torch.full_like(v, float("nan")))
        ko, vo = R.reorder_kv_live(k, v, src, hi, out=out)
        sync()
        kr, vr = R.reorder_kv_live_plain(k, v, src, hi)
        exact = (bool(torch.equal(ko[:, :, :hi], kr[:, :, :hi]))
                 and bool(torch.equal(vo[:, :, :hi], vr[:, :, :hi])))
        qd = tens(B, S, dtype=torch.bfloat16)
        lo = torch.full((B,), 3, dtype=torch.int32, device=dev)
        kw = dict(split=hi - 40, n_head=S // 64, layer=L - 1)
        a3 = D.decode_attention(qd, ko, vo, lo, hi, **kw)
        sync()
        b3 = D.decode_attention_plain(qd, kr, vr, lo, hi, **kw)
        e3 = float((a3 - b3).abs().max())
        finite = bool(torch.isfinite(a3).all())
        log(f"K8 reorder_kv [{tag}] {tuple(k.shape)} hi {hi}: exact on "
            f"c < hi {exact}; K3 over the NaN-tailed result finite {finite}, "
            f"max_abs_err vs plain {e3:.3e} (tol: exact; finite; 1e-4)")
        if not (exact and finite and e3 < 1e-4):
            fail(f"K8 reorder [{tag}] disagrees with index_select")
        if tag.startswith("large-v3"):
            nbytes = 2 * 2 * L * B * hi * S * 2 + B * 4
            recs["kv_reorder"] = dict(
                err=0.0, bound=bound(nbytes, 0, PEAK_BF16),
                plain_ms=time_ms(torch, lambda: R.reorder_kv_live_plain(
                    k, v, src, hi)),
                **timed(torch, lambda: R.reorder_kv_live(
                    k, v, src, hi, out=out), lambda: (
                        torch.index_select(k, 1, src),
                        torch.index_select(v, 1, src))))
    return recs


def check_decode_attention(torch, rng, ptx_logs):
    """K3/K4 against the plain version at the main path's tiny.en self and
    cross shapes, at large-v3 widths and at the split-cache edge cases:
    step 0, a row whose only valid slot is the current token, kv_group 8 at
    large-v3 widths (8 x 20 = 160 lanes), a C that the slices do not
    divide.  Two calls must give bitwise-equal outputs (the merge runs in
    split order).  Then event and CUDA-graph device times of K3 and K4 at
    the main path's shapes, and of K4 at large-v3 widths, beside SDPA's
    with a boolean key mask (a yardstick; the port never calls it)."""
    from godot_whisper_tpu_torch.ops import decode_attention as D
    from godot_whisper_tpu_torch.ops import kernels as K

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    sdpa = torch.nn.functional.scaled_dot_product_attention
    n_sms = K.sm_count(torch.cuda.current_device())
    log_ptxas(ptx_logs, "decode_attn", "decode_split_kernel", dynamic=False)

    def tens(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, torch.bfloat16)

    def case(name, S, H, B, kv_group, C, L, lo_vals, split, hi, layer):
        g = B // kv_group
        q, k, v = tens(B, S), tens(L, g, C, S), tens(L, g, C, S)
        lo = torch.tensor(lo_vals, dtype=torch.int32, device=dev)
        kw = dict(split=split, n_head=H, kv_group=kv_group, layer=layer)
        got = D.decode_attention(q, k, v, lo, hi, **kw)
        again = D.decode_attention(q, k, v, lo, hi, **kw)
        sync()
        want = D.decode_attention_plain(q, k, v, lo, hi, **kw)
        e_max = float((got - want).abs().max())
        same = bool(torch.equal(got, again))
        sl, (n_split,) = D.split_plan(((C, 1),), g * H, n_sms)
        log(f"K3/K4 decode_attn [{name}] q {tuple(q.shape)} kv "
            f"{tuple(k.shape)} kv_group {kv_group}, lo {lo_vals[:2]}.., "
            f"split {split}, hi {hi}: grid {g} x {H} x n_split {n_split} "
            f"(slices of {sl} on {n_sms} SMs); max_abs_err {e_max:.3e} (tol "
            "1e-4: same bf16 inputs, f32 math in another order); two calls "
            f"bitwise equal {same}")
        if not e_max < 1e-4:
            fail(f"decode attention [{name}] disagrees with its plain "
                 "version")
        if not same:
            fail(f"decode attention [{name}] is not bitwise repeatable")
        return dict(q=q, k=k, v=v, lo=lo, hi=hi, kw=kw, err=e_max)

    # tiny.en main path: prompt capacity 232, cache 512 slots, step 100
    k3 = case("tiny.en self, step 100", 384, 6, 5, 1, 512, 4, [1] * 5, 232,
              333, 2)
    k4 = case("tiny.en cross", 384, 6, 5, 5, 1536, 4, [1500] * 5, 1536, 0, 3)
    case("tiny.en cross kv_group 1", 384, 6, 1, 1, 1536, 4, [1500], 1536, 0,
         1)
    wide = case("large-v3 cross", 1280, 20, 5, 5, 1536, 2, [1500] * 5, 1536,
                0, 1)
    case("large-v3 self", 1280, 20, 5, 1, 512, 2, [3, 5, 7, 9, 11], 232, 300,
         1)
    case("tiny.en self, step 0", 384, 6, 5, 1, 512, 4, [1] * 5, 232, 233, 2)
    case("tiny.en self, rows 0-1 attend only the current token", 384, 6, 5,
         1, 512, 4, [0, 0, 1, 4, 9], 232, 233, 1)
    case("large-v3 cross, kv_group 8 (160 lanes)", 1280, 20, 8, 8, 1536, 2,
         [1500] * 8, 1536, 0, 1)
    case("tiny.en cross, C 1000 (the slices do not divide C)", 384, 6, 5, 5,
         1000, 2, [990] * 5, 1000, 0, 1)

    def library(c):
        q, k, v, lo, hi, kw = (c[n] for n in ("q", "k", "v", "lo", "hi",
                                              "kw"))
        B, S = q.shape
        H, kvg, layer = kw["n_head"], kw["kv_group"], kw["layer"]
        C, dh = k.shape[2], S // H
        ql = q.view(B, H, 1, dh)
        kl = k[layer].view(-1, C, H, dh).transpose(1, 2)
        vl = v[layer].view(-1, C, H, dh).transpose(1, 2)
        if kvg > 1:
            kl = kl.expand(B, H, C, dh)
            vl = vl.expand(B, H, C, dh)
        slot = torch.arange(C, device=dev)
        mask = ((slot[None] < lo[:, None])
                | ((slot[None] >= kw["split"]) & (slot[None] < hi)))
        mask = mask[:, None, None, :]
        return lambda: sdpa(ql, kl, vl, attn_mask=mask)

    recs = {}
    # slots each query row attends (operations) and K/V slots read (bytes)
    for key, c, row_slots, kv_slots in (
            ("decode_attn_k3", k3, 5 * 102, 5 * 102),
            ("decode_attn_k4", k4, 5 * 1500, 1500),
            ("large-v3 cross", wide, 5 * 1500, 1500)):
        B, S = c["q"].shape
        nbytes = 2 * kv_slots * S * 2 + B * S * 2 + B * S * 4
        ops = 4 * row_slots * S

        def run(c=c):
            return D.decode_attention(c["q"], c["k"], c["v"], c["lo"],
                                      c["hi"], **c["kw"])
        r = dict(err=c["err"], bound=bound(nbytes, ops, PEAK_BF16),
                 plain_ms=time_ms(torch, lambda c=c: D.decode_attention_plain(
                     c["q"], c["k"], c["v"], c["lo"], c["hi"], **c["kw"])),
                 **timed(torch, run, library(c)))
        log(f"  timed [{key}]: kernel {r['ms']:.4f} ms, device "
            f"{r['device_ms']:.4f} ms, bound {r['bound'][0]:.6f} ms "
            f"({r['bound'][1]}, {r['bound'][0] / r['device_ms']:.3f} of the "
            f"device time); SDPA {r['library_ms']:.4f} ms, device "
            f"{r['library_device_ms']:.4f} ms; plain {r['plain_ms']:.4f} ms")
        if key.startswith("decode_attn"):
            recs[key] = r
    return recs


def check_split_attention(torch, rng, ptx_logs):
    """K7 against its plain version at the beam path's tiny.en and large-v3
    shapes (one stream of 5 beams, prompt capacity 256, live capacity 256,
    a permuted row map) and at the split-cache edge cases: the live cache
    at step 0 with two beams whose prompts are empty (their only valid
    slot is the current token), kv_group 8 at large-v3 widths, capacities
    the slices do not divide.  Two calls must give bitwise-equal outputs.
    Then event and device times at both widths beside SDPA's over the same
    keys gathered into one cache per beam beforehand (a yardstick)."""
    from godot_whisper_tpu_torch.ops import kernels as K
    from godot_whisper_tpu_torch.ops import split_attention as SA

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    sdpa = torch.nn.functional.scaled_dot_product_attention
    n_sms = K.sm_count(torch.cuda.current_device())
    log_ptxas(ptx_logs, "split_attn", "split_beam_kernel", dynamic=False)

    def tens(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, torch.bfloat16)

    def case(name, S, H, L, G, KB, CP, NL, lo_vals, hi_live):
        B, layer = G * KB, L - 1
        q = tens(B, S)
        kp, vp = tens(L, G, CP, S), tens(L, G, CP, S)
        kl, vl = tens(L, B, NL, S), tens(L, B, NL, S)
        lo = torch.tensor(lo_vals, dtype=torch.int32, device=dev)
        rowmap = torch.from_numpy(rng.integers(0, KB, (B, NL)).astype(
            np.int32)).to(dev)
        kw = dict(n_head=H, kv_group=KB, layer=layer, rowmap=rowmap)
        got = SA.split_beam_attention(q, kp, vp, kl, vl, lo, hi_live, **kw)
        again = SA.split_beam_attention(q, kp, vp, kl, vl, lo, hi_live, **kw)
        sync()
        want = SA.split_beam_attention_plain(
            q.float(), kp.float(), vp.float(), kl.float(), vl.float(), lo,
            hi_live, **kw)
        e_max = float((got - want).abs().max())
        same = bool(torch.equal(got, again))
        sl, (n_p, n_l) = SA.split_plan(((CP, 1), (NL, KB)), G * H, n_sms)
        log(f"K7 split_attn [{name}] q {tuple(q.shape)} prompt "
            f"{tuple(kp.shape)} live {tuple(kl.shape)} lo {lo_vals[:2]}.., "
            f"hi_live {hi_live}: grid {G} x {H} x n_split {n_p + KB * n_l} "
            f"({n_p} prompt + {KB} x {n_l} live slices of {sl}); max_abs_err "
            f"{e_max:.3e} (tol 1e-4: the plain version in f32 on the same "
            f"bf16 inputs, sums in another order); two calls bitwise equal "
            f"{same}")
        if not e_max < 1e-4:
            fail(f"K7 split attention [{name}] disagrees with its plain "
                 "version")
        if not same:
            fail(f"K7 split attention [{name}] is not bitwise repeatable")
        return dict(q=q, kp=kp, vp=vp, kl=kl, vl=vl, lo=lo, kw=kw,
                    hi_live=hi_live, err=e_max)

    tiny = case("tiny.en beam 5", 384, 6, 4, 1, 5, 256, 256, [120] * 5, 100)
    wide = case("large-v3 beam 5", 1280, 20, 2, 1, 5, 256, 256, [120] * 5,
                100)
    case("tiny.en, live step 0, beams 0-1 with empty prompts", 384, 6, 4, 1,
         5, 256, 256, [0, 0, 120, 120, 120], 1)
    case("large-v3 beam 8 (160 lanes)", 1280, 20, 2, 1, 8, 256, 256,
         [120] * 8, 100)
    case("tiny.en, 2 groups, CP 232 and NL 200 (the slices do not divide "
         "them)", 384, 6, 2, 2, 5, 232, 200, [100] * 5 + [37] * 5, 150)

    recs = {}
    for tag, c in (("tiny.en", tiny), ("large-v3", wide)):
        q, kp, vp, kl, vl, lo, kw, hi_live = (c[n] for n in (
            "q", "kp", "vp", "kl", "vl", "lo", "kw", "hi_live"))
        B, S = q.shape
        G, KB, H, layer = 1, kw["kv_group"], kw["n_head"], kw["layer"]
        lo_v = int(lo[0])
        # the same keys gathered into one cache per beam: the library
        # yardstick's input (built outside its timing)
        rows = (torch.arange(B, device=dev)[:, None] // KB * KB
                + kw["rowmap"][:, :hi_live].long())
        t = torch.arange(hi_live, device=dev)[None]
        dh = S // H

        def heads(p_, l_):
            full = torch.cat([p_[layer, :, :lo_v].expand(B, lo_v, S),
                              l_[layer][rows, t]], dim=1)
            return full.view(B, -1, H, dh).transpose(1, 2).contiguous()
        kf, vf = heads(kp, kl), heads(vp, vl)
        qf = q.view(B, H, 1, dh)
        nbytes = (2 * G * lo_v * S * 2 + 2 * B * hi_live * S * 2
                  + B * S * 2 + B * S * 4 + B * hi_live * 4 + B * 4)
        ops = 4 * B * (lo_v + hi_live) * S
        r = dict(err=c["err"], bound=bound(nbytes, ops, PEAK_BF16),
                 plain_ms=time_ms(torch, lambda: SA.split_beam_attention_plain(
                     q, kp, vp, kl, vl, lo, hi_live, **kw)),
                 **timed(torch, lambda: SA.split_beam_attention(
                     q, kp, vp, kl, vl, lo, hi_live, **kw),
                     lambda: sdpa(qf, kf, vf)))
        log(f"  timed [K7 {tag}]: kernel {r['ms']:.4f} ms, device "
            f"{r['device_ms']:.4f} ms, bound {r['bound'][0]:.6f} ms "
            f"({r['bound'][1]}, {r['bound'][0] / r['device_ms']:.3f} of the "
            f"device time); SDPA over the gathered keys {r['library_ms']:.4f}"
            f" ms, device {r['library_device_ms']:.4f} ms; plain "
            f"{r['plain_ms']:.4f} ms")
        if tag == "tiny.en":
            recs["split_attn"] = r
    return recs


def check_quant_kernels(torch, rng):
    """K9-K12 against their plain versions at the quantized paths' shapes
    (tiny.en and large-v3 widths); then their times.  The library yardstick
    of K9 / K10 is torch.mm on the weight already held in bf16 (the bf16
    model's cost, which quantization aims to beat); of K11 / K12 SDPA over
    K/V dequantized beforehand.  The port calls neither."""
    from godot_whisper_tpu_torch.models.model import (CrossKV,
                                                      quantize_cross_kv)
    from godot_whisper_tpu_torch.ops import cross_attention as CA
    from godot_whisper_tpu_torch.ops import qmatmul as Q

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    sdpa = torch.nn.functional.scaled_dot_product_attention
    recs = {}

    def tens(*shape, dtype=torch.float32, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).to(dev, dtype)

    # ---- K9 / K10: f32 sums in another order (tensor-core accumulation
    # included) must stay within 1e-5 of each element's sum of |terms|
    def qmm_case(kind, layout, m, s, o, tag, key=None):
        x = tens(m, s, dtype=torch.bfloat16)
        w = tens(s, o, scale=0.02)
        if kind == "int4":
            qt = Q.quantize_tensor4(w)
            w_deq = Q.dequantize4(qt)

            def run():
                return Q.quant_matmul4(x, qt)

            def plain():
                return Q.quant_matmul4_plain(x, qt)
            w_bytes = s * o // 2 + (s // qt.group) * o * 4
        else:
            qt = (Q.quantize_tensor(w.t().contiguous(), reduce_axis=1)
                  if layout == "oi" else Q.quantize_tensor(w, reduce_axis=0))
            w_deq = Q.dequantize(qt)
            w_deq = w_deq.t() if layout == "oi" else w_deq

            def run():
                return Q.quant_matmul(x, qt, layout=layout)

            def plain():
                return Q.quant_matmul_plain(x, qt, layout=layout)
            w_bytes = s * o + o * 4
        kname = "K10" if kind == "int4" else "K9"
        got = run()
        sync()
        want = plain()
        err = (got - want).abs()
        share = float((err / (1e-5 * (x.float().abs() @ w_deq.abs())
                              + 1e-7)).max())
        e_max = float(err.max())
        log(f"{kname} {kind} {layout} [{tag}] x ({m}, {s}) -> ({m}, {o}): "
            f"max_abs_err {e_max:.3e}, worst share of the tol 1e-5 sum|x w| "
            f"+ 1e-7 {share:.3f} (must be <= 1)")
        if not share <= 1.0:
            fail(f"{kname} [{tag}] disagrees with its plain version")
        if key:
            w_bf16 = w_deq.to(torch.bfloat16)
            nbytes = w_bytes + m * s * 2 + m * o * 4
            r = recs[key] = dict(
                err=e_max, bound=bound(nbytes, 2 * m * s * o, PEAK_BF16),
                plain_ms=time_ms(torch, plain),
                **timed(torch, run, lambda: torch.mm(
                    x, w_bf16, out_dtype=torch.float32)))
            log(f"  timed: kernel {r['ms'] * 1e3:.2f} us (device "
                f"{r['device_ms'] * 1e3:.2f} us), bound "
                f"{r['bound'][0] * 1e3:.2f} us ({nbytes / 1e6:.2f} MB), "
                f"plain {r['plain_ms'] * 1e3:.2f} us, torch.mm on bf16 W "
                f"{r['library_ms'] * 1e3:.2f} us (device "
                f"{r['library_device_ms'] * 1e3:.2f} us)")

    qmm_case("int8", "oi", 5, 384, 51864, "tiny.en logits", "qmatmul")
    qmm_case("int8", "io", 5, 384, 1152, "tiny.en wqkv")
    qmm_case("int8", "io", 1500, 384, 384, "tiny.en cross-K", "qmatmul_xk")
    qmm_case("int8", "oi", 8, 1280, 51866, "large-v3 logits")
    qmm_case("int8", "io", 1500, 1280, 1280, "large-v3 cross-K")
    qmm_case("int4", "io", 5, 384, 1536, "tiny.en mlp.w0", "qmatmul4")
    qmm_case("int4", "io", 1500, 384, 384, "tiny.en cross-K")
    qmm_case("int4", "io", 8, 1280, 3840, "large-v3 wqkv")
    qmm_case("int4", "io", 8, 5120, 1280, "large-v3 mlp.w1")
    qmm_case("int4", "io", 1500, 1280, 1280, "large-v3 cross-K")

    # ---- K11 / K12 over a quantized cross-KV (T 1536, 1500 valid)
    def xattn_case(s, h, kg, n_layer, w8a8, tag, key=None):
        k = tens(n_layer, 1, 1536, s, dtype=torch.bfloat16)
        v = tens(n_layer, 1, 1536, s, dtype=torch.bfloat16)
        x = quantize_cross_kv(CrossKV(k, v, 1500), h)
        q = tens(kg, s, dtype=torch.bfloat16)
        lo = torch.full((kg,), 1500, dtype=torch.int32, device=dev)
        kw = dict(n_head=h, kv_group=kg, layer=n_layer - 1)
        packed = CA.is_packed(h, kg)
        kname = "K12" if packed else "K11"
        mode = "W8A8" if w8a8 and packed else "exact"

        def run():
            return CA.cross_attention_quant(q, x.k_q, x.k_s, x.v_q, x.v_s,
                                            t_valid=lo, w8a8=w8a8, **kw)

        def plain():
            return CA.cross_attention_quant_plain(q, x.k_q, x.k_s, x.v_q,
                                                  x.v_s, lo, w8a8=w8a8, **kw)
        got = run()
        sync()
        want = plain()
        err = (got - want).abs()
        e_max = float(err.max())
        if mode == "W8A8":
            tol = 1e-4 + CA.w8a8_flip_limit(q, x.k_q, x.k_s, x.v_s, lo, **kw)
            what = "1e-4 + one flipped round(127 p) per (row, head)"
        else:
            tol = torch.full_like(err, 1e-4)
            what = "1e-4: the same arithmetic, f32 sums in another order"
        share = float((err / tol).max())
        log(f"{kname} xattn_q {mode} [{tag}] q ({kg}, {s}) kv "
            f"{tuple(x.k_q.shape)} kv_group {kg}: max_abs_err {e_max:.3e}, "
            f"worst share of the tol {share:.3f} (tol {what}; must be <= 1)")
        if not share <= 1.0:
            fail(f"{kname} [{tag}] disagrees with its plain version")
        if key:
            d = s // h
            kf = (x.k_q[-1, 0].float().view(1536, h, d)
                  * x.k_s[-1, 0, :, :h].float()[..., None])
            vf = (x.v_q[-1, 0].float().view(1536, h, d)
                  * x.v_s[-1, 0, :h, None])
            kd = kf.to(torch.bfloat16).transpose(0, 1)[None].expand(
                kg, h, 1536, d)
            vd = vf.to(torch.bfloat16).transpose(0, 1)[None].expand(
                kg, h, 1536, d)
            qd = q.view(kg, h, 1, d)
            mask = (torch.arange(1536, device=dev) < 1500)[None, None, None]
            # int8 K/V and the n_head bf16 k_s of the 1500 valid slots, the
            # n_head f32 v_s, q and lo in, f32 out (the zero lanes of the
            # padded scales are not needed)
            nbytes = (2 * 1500 * s + 1500 * h * 2 + h * 4
                      + kg * s * 2 + kg * s * 4 + kg * 4)
            r = recs[key] = dict(
                err=e_max, bound=bound(nbytes, 4 * kg * 1500 * s, PEAK_BF16),
                plain_ms=time_ms(torch, plain),
                **timed(torch, run, lambda: sdpa(qd, kd, vd,
                                                 attn_mask=mask)))
            log(f"  timed: kernel {r['ms'] * 1e3:.2f} us (device "
                f"{r['device_ms'] * 1e3:.2f} us), bound "
                f"{r['bound'][0] * 1e3:.2f} us ({nbytes / 1e6:.2f} MB), "
                f"plain {r['plain_ms'] * 1e3:.2f} us, SDPA over dequantized "
                f"bf16 K/V {r['library_ms'] * 1e3:.2f} us (device "
                f"{r['library_device_ms'] * 1e3:.2f} us)")

    xattn_case(384, 6, 5, 4, True, "tiny.en kv_group 5", "xattn_packed")
    xattn_case(384, 6, 5, 4, False, "tiny.en kv_group 5")
    xattn_case(384, 6, 1, 4, True, "tiny.en kv_group 1")
    xattn_case(1280, 20, 5, 3, True, "large-v3 kv_group 5")
    xattn_case(1280, 20, 5, 3, False, "large-v3 kv_group 5")
    xattn_case(1280, 20, 8, 3, False, "large-v3 beam 8", "xattn_wide")
    return recs


def check_long_attention(torch, rng, ptx_logs):
    """K13 against its plain version (the same 512-key blocks and rounding
    points) at phase 10's shape (tiny.en, n_audio_ctx 2000 padded to 2048)
    and at large-v3 widths (20 heads; 160 = batch 8 x 20 heads), f32 and
    bf16; then times of kernel, plain version and one SDPA call with a
    boolean key mask (a yardstick; the port never calls it)."""
    from godot_whisper_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    sdpa = torch.nn.functional.scaled_dot_product_attention
    recs = {}
    T, D = 2048, 64
    log_ptxas(ptx_logs, "enc_attn_long", "enc_attn_tc_kernel")
    for bh, tv, tag in ((6, 2000, "tiny.en, n_audio_ctx 2000"),
                        (20, 2048, "large-v3 widths"),
                        (160, 2048, "large-v3 widths, batch 8")):
        qf, kf, vf = (torch.from_numpy(rng.standard_normal((bh, T, D))
                                       .astype(np.float32)).to(dev)
                      for _ in range(3))
        got = A.flash_attention_long(qf, kf, vf, t_valid=tv)
        sync()
        ef = float((got - A.attention_bh_blocked_plain(qf, kf, vf, tv))
                   .abs().max())
        q, k, v = (x.to(torch.bfloat16) for x in (qf, kf, vf))
        got = A.flash_attention_long(q, k, v, t_valid=tv)
        sync()
        want = A.attention_bh_blocked_plain(q, k, v, tv)
        err = (got.float() - want.float()).abs()
        lim = blocked_bf16_limit(torch, q, k, v, want, tv)
        share = float((err / lim).max())
        e_max = float(err.max())
        # control: K2's single-pass function must not pass the same limit
        ctl = float(((A.attention_bh_sp_plain(q, k, v, tv).float()
                      - want.float()).abs() / lim).max())
        log(f"K13 enc_attn_long [{tag}] ({bh}, {T}, {D}) t_valid {tv}: f32 "
            f"max_abs_err {ef:.3e} (tol 1e-5: f32 sums in another order); "
            f"bf16 max_abs_err {e_max:.3e}, worst share of the per-element "
            f"tol {share:.3f} (tol one bf16 ulp + one flipped bf16 rounding "
            f"of p per row + 1e-5; must be <= 1); control, the single-pass "
            f"function against the same tol: share {ctl:.3f} (must be > 1)")
        if not (ef < 1e-5 and share <= 1.0):
            fail(f"K13 [{tag}] disagrees with its plain version")
        if ctl <= 1.0:
            fail(f"K13 [{tag}]: the bf16 tol does not tell the blocked "
                 "function from the single-pass one")
        mask = (torch.arange(T, device=dev) < tv)[None, None, None]
        q4, k4, v4 = (x.view(1, bh, T, D) for x in (q, k, v))
        r = dict(err=e_max,
                 bound=bound(4 * bh * T * D * 2, 4 * bh * tv * tv * D,
                             PEAK_BF16),
                 plain_ms=time_ms(torch, lambda: A.attention_bh_blocked_plain(
                     q, k, v, tv), reps=10),
                 **timed(torch, lambda: A.flash_attention_long(
                     q, k, v, t_valid=tv), lambda: sdpa(
                         q4, k4, v4, attn_mask=mask), reps=10))
        log(f"  timed bf16: kernel {r['ms']:.4f} ms, bound "
            f"{r['bound'][0]:.5f} ms ({r['bound'][1]}), plain "
            f"{r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms; "
            f"device time (CUDA graph replay): kernel {r['device_ms']:.4f} "
            f"ms, SDPA {r['library_device_ms']:.4f} ms")
        if bh == 6:
            recs["enc_attn_long"] = r
        del qf, kf, vf, q, k, v, got, want, err, lim
        torch.cuda.empty_cache()
    return recs


# --------------------------------------------------------------- phase 3 --
def check_goldens(torch, gt):
    from godot_whisper_tpu_torch.decode.filters import build_filter_context
    from godot_whisper_tpu_torch.decode.language import lang_id
    from godot_whisper_tpu_torch.decode.window import WindowDecoder
    from godot_whisper_tpu_torch.models.model import cross_kv, encoder_forward

    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "tests", "golden", "nano_decode.json")) as f:
        want_window = json.load(f)
    with open(os.path.join(root, "tests", "golden",
                           "nano_clip_scenarios.json")) as f:
        want_clip = json.load(f)

    def nano(base, name):
        cfg = gt.get_config(base).replace(
            n_audio_layer=2, n_text_layer=2, n_audio_state=128,
            n_audio_head=4, n_text_state=128, n_text_head=4, name=name)
        params = gt.init_params(cfg, seed=3, compute_dtype=torch.float32,
                                device="cuda")
        return gt.WhisperContext.from_params(cfg, params, device="cuda")

    ctx = nano("tiny.en", "nano")
    cfg, pipe = ctx.config, ctx.pipeline
    mel, _ = pipe.mel.device(golden_audio_5s())
    enc = encoder_forward(pipe.params, cfg, mel[:, :3000].T[None])
    xkv = cross_kv(pipe.params, cfg, enc)
    wd = WindowDecoder(cfg, build_filter_context(cfg, pipe.tokenizer,
                                                 device="cuda"))
    for key, kw in (("greedy", dict(n_decoders=1)),
                    ("beam5", dict(n_decoders=5, strategy="beam",
                                   beam_size=5))):
        res = wd.decode(pipe.params, xkv,
                        np.asarray([cfg.token_sot], np.int32),
                        temperature=0.0, seek=0, seek_end=500,
                        suppress_blank=True, no_timestamps=False,
                        single_segment=False, max_tokens=0, test_mode=False,
                        **kw)
        n = min(res.n_steps, 48)
        got = {"n_steps": res.n_steps,
               "tokens": [[int(x) for x in r[:n]] for r in res.tokens],
               "tid": [[int(x) for x in r[:n]] for r in res.tok_tid],
               "result_len": [int(x) for x in res.result_len],
               "seek_delta": [int(x) for x in res.seek_delta],
               "completed": [bool(x) for x in res.completed],
               "failed": [bool(x) for x in res.failed],
               "sum_logprobs": [round(float(x), 3)
                                for x in res.sum_logprobs_all]}
        want = want_window[key]
        log(f"golden {key}: {got['tokens']} sums {got['sum_logprobs']} "
            f"(want {want['tokens']} sums {want['sum_logprobs']})")
        if got != want:
            fail(f"nano {key} golden differs: {got} vs {want}")

    def scenario(c, audio, tparams, init):
        p = c.pipeline
        p.set_audio(audio)
        cd = p.clip_decoder(tparams, [0.0], init, False)
        outs = cd.run(p.params, p._mel_device[None], [p._mel_n_len], [0],
                      [p._n_len_org], past_init=[[]])
        W = int(outs.w[0])
        return {"w": W, "done": bool(outs.done[0]),
                "past_cnt": int(outs.past_cnt[0]),
                "windows": [{
                    "seek": int(outs.seek[0, k]),
                    "delta": int(outs.delta[0, k]),
                    "rl": int(outs.rl[0, k]),
                    "emitted": bool(outs.emitted[0, k]),
                    "temp": round(float(outs.temp[0, k]), 3),
                    "tokens": [int(x) for x in outs.tokens[
                        0, k, :min(int(outs.rl[0, k]), 24)]],
                } for k in range(W)]}

    p_open = gt.TranscribeParams(entropy_thold=-1e9, logprob_thold=-1e9,
                                 best_of=1, temperature_inc=0.0)
    mctx = nano("tiny", "nano-multi")
    mcfg = mctx.config
    for name, got in (
            ("multiwindow", scenario(ctx, frozen_audio(34.0), p_open,
                                     [cfg.token_sot])),
            ("translate", scenario(mctx, frozen_audio(5.0), p_open,
                                   [mcfg.token_sot,
                                    mcfg.token_lang(lang_id("de")),
                                    mcfg.token_translate]))):
        log(f"golden clip {name}: windows "
            f"{[(w['seek'], w['delta'], w['rl']) for w in got['windows']]}")
        if got != want_clip[name]:
            fail(f"nano clip golden {name!r} differs: {got} vs "
                 f"{want_clip[name]}")


# ---------------------------------------------------------- phases 9-10 --
def seg_view(segs):
    return [(s.text, s.t0, s.t1, [t.id for t in s.tokens]) for s in segs]


def check_file_path(torch, gt, ctx, segs4, drive, tmp):
    """Phase 9: phase 4's weights through a ggml file, from_file and
    from_buffer, then the CLI (every writer, a 44.1 kHz WAV) and language
    detection on a multilingual checkpoint."""
    from godot_whisper_tpu_torch.audio.mel import mel_filterbank
    from godot_whisper_tpu_torch.audio.tokenizer import synthetic_vocab
    from godot_whisper_tpu_torch.audio.wav import write_wav
    from godot_whisper_tpu_torch.cli.main import main as cli_main
    from godot_whisper_tpu_torch.models import loader_ggml
    from godot_whisper_tpu_torch.models.export_ggml import export_checkpoint

    cfg = ctx.config
    path = os.path.join(tmp, "tiny.en-f32.bin")
    t0 = time.perf_counter()
    export_checkpoint(path, ctx.pipeline.params, cfg,
                      mel_filterbank(cfg.n_mels), synthetic_vocab(cfg),
                      ttype=loader_ggml.GGML_TYPE_F32)
    log(f"file path: phase 4's weights exported as F32 ggml "
        f"({os.path.getsize(path) / 1e6:.1f} MB) in "
        f"{time.perf_counter() - t0:.2f} s")
    want = seg_view(segs4)
    for what, make in (
            ("from_file", lambda: gt.WhisperContext.from_file(path)),
            ("from_buffer", lambda: gt.WhisperContext.from_buffer(
                open(path, "rb").read()))):
        c = make()
        t_load = c.timings.t_load_us
        _, _, segs = drive(f"file path: {what}, tiny.en F32 file, bf16 "
                           "compute, 34.0 s audio", c, gt.TranscribeParams(),
                           34.0)
        log(f"file path: {what} load {t_load / 1e3:.1f} ms; {len(segs)} "
            f"segments, equal to phase 4's token for token: "
            f"{seg_view(segs) == want}")
        if seg_view(segs) != want:
            fail(f"{what} segments differ from phase 4's: "
                 f"{seg_view(segs)[:2]} vs {want[:2]}")
        del c

    # the CLI in-process, every writer, a WAV that must be resampled.  Its
    # checkpoint is phase 4's with the decoder's final LayerNorm gain at 8x:
    # logits spread as a trained model's do, so a segment holds several
    # text tokens (at the random init's spread a timestamp follows each
    # one) and --max-len 5 must split it, one token per segment
    sr = 44100
    t = np.arange(int(34.0 * sr)) / sr
    x = (0.3 * np.sin(2 * np.pi * (220.0 + 60 * np.sin(
        2 * np.pi * 0.07 * t)) * t)
        + 0.2 * np.sin(2 * np.pi * 447.0 * t)
        * (0.5 + 0.5 * np.sin(2 * np.pi * 1.7 * t))).astype(np.float32)
    wav = os.path.join(tmp, "clip-44k.wav")
    write_wav(wav, x, sr)
    params = ctx.pipeline.params
    dec = dict(params["decoder"], ln={"g": params["decoder"]["ln"]["g"] * 8,
                                      "b": params["decoder"]["ln"]["b"]})
    wide = os.path.join(tmp, "tiny.en-gain8-f32.bin")
    export_checkpoint(wide, dict(params, decoder=dec), cfg,
                      mel_filterbank(cfg.n_mels), synthetic_vocab(cfg),
                      ttype=loader_ggml.GGML_TYPE_F32)
    rc0 = cli_main(["-m", wide, wav, "-oj", "-of", wav + ".unsplit",
                    "--no-prints"])
    unsplit = json.load(open(wav + ".unsplit.json"))["transcription"]
    t0 = time.perf_counter()
    rc = cli_main(["-m", wide, wav, "-otxt", "-osrt", "-ovtt", "-oj", "-ojf",
                   "-owts", "--max-len", "5", "--no-prints"])
    wall = time.perf_counter() - t0
    stamp = r"\d\d:\d\d:\d\d[.,]\d\d\d --> \d\d:\d\d:\d\d[.,]\d\d\d"
    txt = open(wav + ".txt").read()
    srt = [b.split("\n") for b in open(wav + ".srt").read().strip()
           .split("\n\n")]
    vtt = open(wav + ".vtt").read()
    js = json.load(open(wav + ".json"))
    wts = open(wav + ".wts").read()
    segs = js["transcription"]
    ok = (rc0 == rc == 0 and txt.strip() != ""
          and len(segs) > len(unsplit) > 0
          and all(len(b) >= 3 and b[0].isdigit() and re.fullmatch(stamp, b[1])
                  for b in srt)
          and vtt.startswith("WEBVTT") and len(re.findall(stamp, vtt))
          == len(segs) == len(srt) > 0
          and all(s["tokens"] and all("timestamps" in tk
                                      for tk in s["tokens"]) for s in segs)
          and wts.startswith("#!/bin/bash") and "ffmpeg" in wts)
    log(f"CLI: decoder LayerNorm gain 8x, 34.0 s WAV at 44.1 kHz "
        f"(resampled): -oj {len(unsplit)} segments (longest text "
        f"{max((len(s['text'].encode()) for s in unsplit), default=0)} "
        f"bytes); -otxt -osrt -ovtt -oj -ojf -owts --max-len 5: rc {rc}, "
        f"{wall:.2f} s, {len(segs)} segments (longest text "
        f"{max((len(s['text'].encode()) for s in segs), default=0)} bytes), "
        f"split and every file parsed: {ok}")
    if not ok:
        fail("the CLI's outputs are missing or do not parse, or --max-len "
             "split no segment")

    mcfg = gt.get_config("tiny")
    mctx = gt.WhisperContext.synthetic("tiny", seed=0)
    mpath = os.path.join(tmp, "tiny-f16.bin")
    export_checkpoint(mpath, mctx.pipeline.params, mcfg,
                      mel_filterbank(mcfg.n_mels), synthetic_vocab(mcfg))
    del mctx
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main(["-m", mpath, wav, "-l", "auto", "--detect-language",
                       "--no-prints"])
    said = out.getvalue().strip()
    log(f"CLI: multilingual tiny (F16 file), -l auto --detect-language: rc "
        f"{rc}, printed {said!r}")
    if rc != 0 or not re.fullmatch(r"detected language: \w+ \(.+\)", said):
        fail("language detection printed no language")


def check_long_context(torch, gt, drive, tmp):
    """Phase 10: a tiny.en-width checkpoint with n_audio_ctx 2000 (40 s
    windows) from an F16 file; its encoder attention must run through K13,
    4 launches (one per audio layer) per window, and never through K2."""
    from godot_whisper_tpu_torch.audio.mel import mel_filterbank
    from godot_whisper_tpu_torch.audio.tokenizer import synthetic_vocab
    from godot_whisper_tpu_torch.models.export_ggml import export_checkpoint

    cfg = gt.get_config("tiny.en").replace(n_audio_ctx=2000)
    path = os.path.join(tmp, "tiny.en-ctx2000-f16.bin")
    export_checkpoint(path, gt.init_params(cfg, seed=0, device="cuda"), cfg,
                      mel_filterbank(cfg.n_mels), synthetic_vocab(cfg))
    lctx = gt.WhisperContext.from_file(path)
    c = lctx.config
    n, grp, segs = drive(
        f"long audio context: {c.name} checkpoint (S {c.n_audio_state}, "
        f"{c.n_audio_head} heads, {c.n_audio_layer} + {c.n_text_layer} "
        f"layers, V {c.n_vocab}, n_audio_ctx {c.n_audio_ctx}), F16 file, "
        "bf16 compute, 90.0 s audio", lctx, gt.TranscribeParams(), 90.0)
    n_win = lctx.timings.n_encode
    log(f"long audio context: {n_win} windows, K13 launches "
        f"{n['flash_attention_long']} (want {c.n_audio_layer} x {n_win}), "
        f"K2 launches {n['flash_attention_bh']} (want 0)")
    if not (n_win >= 1 and c.n_audio_ctx == 2000
            and n["flash_attention_long"] == c.n_audio_layer * n_win
            and n["flash_attention_bh"] == 0 and n["log_mel_raw"]
            and n["fused_filter_sample"] and grp.get(1) and grp.get(5)):
        fail("the long audio context did not run its encoder through K13 "
             "alone, or a kernel of the path never launched")
    return n


# ------------------------------------------------------------------ main --
def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import godot_whisper_tpu_torch as gt
    from godot_whisper_tpu_torch.ops import kernels
    from godot_whisper_tpu_torch.ops.attention import (flash_attention_bh,
                                                       flash_attention_long)
    from godot_whisper_tpu_torch.ops.cross_attention import (xattn_q_packed,
                                                             xattn_q_wide)
    from godot_whisper_tpu_torch.ops.decode_attention import decode_attention
    from godot_whisper_tpu_torch.ops.filter_sample import (fused_filter_sample,
                                                           fused_filter_topk)
    from godot_whisper_tpu_torch.ops.kv_reorder import reorder_kv_live
    from godot_whisper_tpu_torch.ops.mel_kernel import log_mel_raw
    from godot_whisper_tpu_torch.ops.qmatmul import (quant_matmul,
                                                     quant_matmul4)
    from godot_whisper_tpu_torch.ops.split_attention import \
        split_beam_attention

    if "jax" in sys.modules:
        fail("the port imported jax")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    # ---- phase 1: build
    t0 = time.perf_counter()
    logs = kernels.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s for {len(logs)} sources")
    for name, text in logs.items():
        for line in text.splitlines():
            if re.search(r"Compiling entry|Used \d+ registers|spill", line):
                log(f"  [{name}] {line.strip()}")

    # ---- phase 2: kernels vs plain versions
    rng = np.random.default_rng(0)
    recs = check_kernels(torch, gt, rng, logs)
    recs.update(check_decode_attention(torch, rng, logs))
    recs.update(check_beam_kernels(torch, rng))
    recs.update(check_split_attention(torch, rng, logs))
    recs.update(check_quant_kernels(torch, rng))
    recs.update(check_long_attention(torch, rng, logs))

    # ---- phase 3: goldens through the kernels
    check_goldens(torch, gt)

    # every launch counter is set to 0 just before a path is driven and
    # read just after it
    counters = (log_mel_raw, flash_attention_bh, decode_attention,
                fused_filter_sample, fused_filter_topk, split_beam_attention,
                reorder_kv_live, quant_matmul, quant_matmul4, xattn_q_wide,
                xattn_q_packed, flash_attention_long)

    def drive(what, c, tparams, audio_s):
        for fn in counters:
            fn.launches = 0
        decode_attention.group_launches.clear()
        quant_matmul.layout_launches.clear()
        xattn_q_packed.mode_launches.clear()
        c.timings.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        segs = c.full(tparams, frozen_audio(audio_s))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = {fn.__name__: fn.launches for fn in counters}
        n["quant_matmul_oi"] = quant_matmul.layout_launches["oi"]
        n["xattn_q_packed_w8a8"] = xattn_q_packed.mode_launches["w8a8"]
        grp = dict(decode_attention.group_launches)
        tm = c.timings
        log(f"{what}: {len(segs)} segments, wall {wall:.3f} s, "
            f"{audio_s / wall:.2f} audio-s/s, {tm.n_decode} decode steps, "
            f"{tm.n_encode} windows, {tm.n_fail_p} windows not emitted")
        log(f"{what} launches: {n}, decode_attention by kv_group {grp}")
        for s_ in segs:
            if not (0 <= s_.t0 <= s_.t1 and s_.tokens and all(
                    0 <= t.id < c.config.n_vocab and np.isfinite(t.plog)
                    for t in s_.tokens)):
                fail(f"malformed segment {s_}")
        return n, grp, segs

    # ---- phase 4: the main path
    ctx = gt.WhisperContext.synthetic("tiny.en", seed=0)
    launches, groups, segs4 = drive("main path: tiny.en bf16, 34.0 s audio",
                                    ctx, gt.TranscribeParams(), 34.0)
    if not all(launches[fn.__name__] for fn in counters[:4]) or not (
            groups.get(1) and groups.get(5)):
        fail("a kernel of the main path never launched")

    # ---- phase 5: the beam path (tiny.en, full width)
    beam = gt.SamplingStrategy.BEAM_SEARCH
    n5, grp5, _ = drive("beam path: tiny.en bf16 beam 5, 34.0 s audio", ctx,
                        gt.TranscribeParams(strategy=beam), 34.0)
    if not (n5["fused_filter_topk"] and n5["split_beam_attention"]
            and grp5.get(5) and n5["log_mel_raw"]
            and n5["flash_attention_bh"]):
        fail("a kernel of the beam path never launched")

    # ---- phase 6: the wide beam route (K8): large-v3 widths, depth cut
    from godot_whisper_tpu_torch.decode.params import beam_params
    wide = gt.get_config("large-v3").replace(n_audio_layer=2, n_text_layer=3)
    wctx = gt.WhisperContext.from_params(
        wide, gt.init_params(wide, seed=0, device="cuda"), device="cuda")
    n6, grp6, _ = drive("wide beam route: large-v3 widths (S 1280, 20 heads, "
                        "128 mels, V 51866) cut to 2 audio + 3 text layers, "
                        "bf16, beam 8, 10.0 s audio", wctx,
                        beam_params(beam_size=8, best_of=8,
                                    temperature_inc=0.0), 10.0)
    if not (n6["reorder_kv_live"] and n6["fused_filter_topk"]
            and grp6.get(8)) or n6["split_beam_attention"]:
        fail("the wide beam route did not go through K8 (or went through "
             "K7)")

    # ---- phase 7: the quantized paths (tiny.en, full width)
    ctx8 = gt.WhisperContext.synthetic("tiny.en", seed=0, quantize="int8")
    n7, grp7, _ = drive("quantized path 1: tiny.en int8 weights, int8 "
                        "cross-KV (W8A8), default ladder, 34.0 s audio", ctx8,
                        gt.TranscribeParams(cross_kv_int8=True), 34.0)
    if not (n7["quant_matmul"] > n7["quant_matmul_oi"] > 0
            and n7["xattn_q_packed_w8a8"] and n7["log_mel_raw"]
            and n7["flash_attention_bh"] and n7["fused_filter_sample"]
            and grp7.get(1)) or grp7.get(5) or n7["quant_matmul4"]:
        fail("quantized path 1 did not go through K9 (io and oi) and K12, "
             "or sent cross-attention through K4")
    del ctx8
    ctx4 = gt.WhisperContext.synthetic("tiny.en", seed=0, quantize="int4")
    n7b, grp7b, _ = drive("quantized path 2: tiny.en int4 weights, int8 "
                          "cross-KV (W8A8), beam 5, 34.0 s audio", ctx4,
                          gt.TranscribeParams(strategy=beam,
                                              cross_kv_int8=True), 34.0)
    if not (n7b["quant_matmul4"] and n7b["quant_matmul_oi"]
            and n7b["xattn_q_packed"] and n7b["fused_filter_topk"]
            and n7b["split_beam_attention"]) or grp7b.get(5):
        fail("quantized path 2 did not go through K10, K9 (oi), K12, K6 and "
             "K7")
    del ctx4

    # ---- phase 8: the wide quantized route (K11): large-v3 widths, int4
    del wctx
    wctx4 = gt.WhisperContext.from_params(
        wide, gt.init_params(wide, seed=0, device="cuda"), device="cuda",
        quantize="int4")
    n8, _, _ = drive("wide quantized route: large-v3 widths cut to 2 audio "
                     "+ 3 text layers, int4 weights, int8 cross-KV, beam 8, "
                     "10.0 s audio", wctx4,
                     beam_params(beam_size=8, best_of=8, temperature_inc=0.0,
                                 cross_kv_int8=True), 10.0)
    if not (n8["xattn_q_wide"] and n8["quant_matmul4"]
            and n8["reorder_kv_live"]) or n8["xattn_q_packed"]:
        fail("the wide quantized route did not go through K11, K10 and K8 "
             "(or went through K12)")
    del wctx4

    tmp = tempfile.mkdtemp(prefix="gwt_chip_smoke_")
    try:
        check_file_path(torch, gt, ctx, segs4, drive, tmp)
        del ctx
        n10 = check_long_context(torch, gt, drive, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    tpu = {"mel": "mel_kernel.py:77", "enc_attn": "attention.py:105",
           "decode_attn_k3": "decode_attention.py:126",
           "decode_attn_k4": "decode_attention.py:221",
           "filter_sample": "filter_sample.py:113",
           "filter_topk": "filter_sample.py:178",
           "split_attn": "split_attention.py:59",
           "kv_reorder": "kv_reorder.py:68",
           "qmatmul": "qmatmul.py:264", "qmatmul4": "qmatmul.py:151",
           "xattn_wide": "cross_attention.py:50",
           "xattn_packed": "cross_attention.py:128",
           "enc_attn_long": "attention.py:53"}
    names = {"mel": ("log_mel_raw", "mel.cu"),
             "enc_attn": ("flash_attention_bh", "enc_attn.cu"),
             "decode_attn_k3": ("decode_attention[kv_group=1]",
                                "decode_attn.cu"),
             "decode_attn_k4": ("decode_attention[kv_group=5]",
                                "decode_attn.cu"),
             "filter_sample": ("fused_filter_sample", "filter_sample.cu"),
             "filter_topk": ("fused_filter_topk", "filter_sample.cu"),
             "split_attn": ("split_beam_attention", "split_attn.cu"),
             "kv_reorder": ("reorder_kv_live", "kv_reorder.cu"),
             "qmatmul": ("quant_matmul", "qmatmul.cu"),
             "qmatmul4": ("quant_matmul4", "qmatmul.cu"),
             "xattn_wide": ("xattn_q_wide", "cross_attn.cu"),
             "xattn_packed": ("xattn_q_packed", "cross_attn.cu"),
             "enc_attn_long": ("flash_attention_long", "enc_attn_long.cu")}
    # launches: K1-K5 from the greedy main path (phase 4), K6 and K7 from
    # the beam path (phase 5), K8 from the wide beam route (phase 6), K9
    # and K12 from quantized path 1, K10 from path 2, K11 from the wide
    # quantized route (phases 7-8), K13 from the long audio context
    # (phase 10)
    n_launch = {"mel": launches["log_mel_raw"],
                "enc_attn": launches["flash_attention_bh"],
                "decode_attn_k3": groups.get(1, 0),
                "decode_attn_k4": groups.get(5, 0),
                "filter_sample": launches["fused_filter_sample"],
                "filter_topk": n5["fused_filter_topk"],
                "split_attn": n5["split_beam_attention"],
                "kv_reorder": n6["reorder_kv_live"],
                "qmatmul": n7["quant_matmul"],
                "qmatmul4": n7b["quant_matmul4"],
                "xattn_wide": n8["xattn_q_wide"],
                "xattn_packed": n7["xattn_q_packed"],
                "enc_attn_long": n10["flash_attention_long"]}
    # K9's second main-path shape, the 1500-row cross-K/V projection: its
    # numbers go to the log, the kernels line keeps one entry per kernel
    xk = recs.pop("qmatmul_xk")
    log(f"K9 io cross-K (1500, 384) x (384, 384): ms {xk['ms']}, device_ms "
        f"{xk['device_ms']}, plain_ms {xk['plain_ms']}, bound_ms "
        f"{xk['bound'][0]} ({xk['bound'][1]}), torch.mm bf16 ms "
        f"{xk['library_ms']}, library_device_ms {xk['library_device_ms']}")
    out = []
    for key, r in recs.items():
        b_ms, b_by = r["bound"]
        out.append({"name": names[key][0], "route": "cuda",
                    "source": "godot_whisper_tpu_torch/csrc/" + names[key][1],
                    "replaces": TPU_OPS + tpu[key],
                    "launches": n_launch[key], "max_abs_err": r["err"],
                    "ms": r["ms"], "device_ms": r["device_ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": r["library_ms"],
                    "library_device_ms": r["library_device_ms"]})
    print(json.dumps({"kernels": out}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else "nvidia-smi: no output", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
