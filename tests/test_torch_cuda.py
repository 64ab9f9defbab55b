"""The port's CUDA kernels on the card: each against its plain PyTorch
version at the main-path and large-v3 shapes, the nano golden
transcripts through the kernels, and training's gradients through K2 and
K13 (models/training.py) against the CPU route, and the kernels on a
second device and under two tp ranks.  Every test here needs
an NVIDIA GPU (``cuda`` marker) and skips without one.  Imports no JAX,
so that it runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import godot_whisper_tpu_torch as gt
from chip_smoke import (CountingSpan, blocked_bf16_limit,
                        filter_edge_errors, frozen_audio, host_padded_stack,
                        mel_f64, mel_limit, mel_tf32_one_pass)
from godot_whisper_tpu_torch.audio.mel import (frame_counts, mel_filterbank,
                                               pad_audio)
from godot_whisper_tpu_torch.decode.filters import build_filter_context
from godot_whisper_tpu_torch.decode.window import WindowDecoder
from godot_whisper_tpu_torch.models.config import get_config
from godot_whisper_tpu_torch.models import model as tm
from godot_whisper_tpu_torch.models.model import cross_kv, encoder_forward
from godot_whisper_tpu_torch.models.params import tree_leaves, tree_map
from godot_whisper_tpu_torch.ops import attention as A
from godot_whisper_tpu_torch.ops import decode_attention as D
from godot_whisper_tpu_torch.ops import filter_sample as FS
from godot_whisper_tpu_torch.ops import mel_kernel as M

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _mel_errors(a16, filt, n_real):
    """K1 on the card against the f64 result over each clip's real frames:
    (kernel error, limit, one-pass TF32 control error, error against the
    plain f32 version)."""
    basis = torch.from_numpy(M.dft_basis()).to(a16.device)
    tables = M.mel_tables(basis, filt)
    before = M.log_mel_raw.launches
    got = M.log_mel_raw(a16, tables)
    torch.cuda.synchronize()
    assert M.log_mel_raw.launches == before + 1
    want = M.log_mel_raw_plain(a16, basis, filt)
    ref = mel_f64(torch, a16, basis, filt)
    coarse = mel_tf32_one_pass(torch, a16, basis, filt)

    def real(d):
        return max(float(d[b, :, :n].abs().max())
                   for b, n in enumerate(n_real))
    lim = mel_limit(real(want - ref))
    return real(got - ref), lim, real(coarse - ref), real(got - want)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_mel_kernel_matches_plain(cuda, n_mels):
    """Within ``mel_limit`` (1.5x the plain f32 version's own error, at
    least 1e-4 log10) of the f64 result over the frames of real audio; the
    plain version with TF32-rounded GEMM inputs (one pass) is not."""
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal(7 * 16000) * 0.1).astype(np.float32)
    n_real = frame_counts(len(audio))[1]
    padded = pad_audio(audio)
    padded = np.pad(padded, (0, -(-len(padded) // 480000) * 480000
                             - len(padded)))
    a16 = torch.from_numpy(padded.astype(np.float16)).to(cuda)[None]
    filt = torch.from_numpy(mel_filterbank(n_mels)).to(cuda)
    e_ref, lim, e_tf32, e_plain = _mel_errors(a16, filt, [n_real])
    print(f"K1 {n_mels} mels: f64 error {e_ref:.3e}, limit {lim:.3e}, "
          f"one-pass TF32 {e_tf32:.3e}, against plain {e_plain:.3e}")
    assert e_ref < lim < e_tf32


@pytest.mark.parametrize("n_mels", [80, 128])
def test_mel_kernel_batch_ragged(cuda, n_mels):
    """B 8 clips of ragged real lengths (3-21 s, quiet to loud, one
    silent) padded to one L whose frame count is no multiple of the 8-frame
    tile or of a CTA's chunk: each clip within ``mel_limit`` of the f64
    result over its real frames, and bitwise equal to the same clip run
    alone (no clip reads another's audio)."""
    rng = np.random.default_rng(5)
    secs = [3.0, 21.0, 7.3, 12.9, 5.5, 16.1, 9.7, 4.2]
    clips = [(rng.standard_normal(int(s * 16000)) * sc).astype(np.float32)
             for s, sc in zip(secs, [0.1, 0.5, 0.01, 0.2, 0.0, 0.05, 0.3,
                                     1.0])]
    clips[4][:] = 0.0
    padded = [pad_audio(c) for c in clips]
    L = max(len(p) for p in padded) + 5 * 160 + 37
    F = (L - 400) // 160 + 1
    assert F % 8 and F % 80
    a = np.stack([np.pad(p, (0, L - len(p))) for p in padded])
    a16 = torch.from_numpy(a.astype(np.float16)).to(cuda)
    filt = torch.from_numpy(mel_filterbank(n_mels)).to(cuda)
    n_real = [frame_counts(len(c))[1] for c in clips]
    e_ref, lim, e_tf32, e_plain = _mel_errors(a16, filt, n_real)
    print(f"K1 B 8 {n_mels} mels: f64 error {e_ref:.3e}, limit "
          f"{lim:.3e}, one-pass TF32 {e_tf32:.3e}, against plain "
          f"{e_plain:.3e}")
    assert e_ref < lim < e_tf32
    tables = M.mel_tables(torch.from_numpy(M.dft_basis()).to(cuda), filt)
    batch = M.log_mel_raw(a16, tables)
    for b in (0, 4, 7):
        assert torch.equal(M.log_mel_raw(a16[b:b + 1].clone(), tables)[0],
                           batch[b])
    assert bool((batch[4] == -10.0).all())


def test_mel_kernel_dense_filterbank(cuda):
    """A filterbank with every bin of every mel nonzero: its runs and
    weights (3 x 128 + 128 x 201 words) exceed the kernel's shared table,
    so the kernel reads them from global memory; still within
    ``mel_limit`` of the f64 result."""
    rng = np.random.default_rng(9)
    filt = torch.from_numpy((rng.random((128, 201)) * 0.01 + 1e-4)
                            .astype(np.float32)).to(cuda)
    audio = (rng.standard_normal(3 * 16000) * 0.1).astype(np.float32)
    a16 = torch.from_numpy(pad_audio(audio).astype(np.float16)).to(cuda)[None]
    e_ref, lim, _, e_plain = _mel_errors(a16, filt,
                                         [frame_counts(len(audio))[1]])
    print(f"K1 dense 128 mels: f64 error {e_ref:.3e}, limit {lim:.3e}, "
          f"against plain {e_plain:.3e}")
    assert e_ref < lim


MEL_PAD_EDGES = [0, 1, 2, 150, 199, 200, 201, 202, 479_799, 480_000,
                 480_001]


def _mel_pad_lengths(case):
    rng = np.random.default_rng(len(case))
    if case == "edges":
        return MEL_PAD_EDGES
    if case == "b1":
        return [476_321]
    if case == "b16":
        return [int(n) for n in rng.integers(32_000, 128_001, 15)] + [
            480_000]
    return [int(n) for n in rng.integers(1, 480_001, 24)] + [480_000] * 8


@pytest.mark.parametrize("case", ["edges", "b1", "b16", "b32"])
def test_mel_pad_kernel_equals_host_padding(cuda, case):
    """``gwt_mel_pad`` (``pad_stack``) on clips stored back to back
    between other samples, at offsets no multiple of 8, with values over
    the f16 range and past it: the stack equals the host padding bit for
    bit (the edge lengths also one clip at a time), and K1's raw mel of it
    equals K1's of the host stack; ``MelFrontend.device_batch`` gives the
    host-padded route's mel and frame counts exactly."""
    from godot_whisper_tpu_torch.audio.mel import (MelFrontend,
                                                   normalize_log_mel)
    rng = np.random.default_rng(3)
    ns = _mel_pad_lengths(case)
    clips = [(rng.standard_normal(n) * 10.0 ** rng.uniform(-8, 5, n))
             .astype(np.float32) for n in ns]
    want = host_padded_stack(clips)
    parts, offsets = [rng.standard_normal(13).astype(np.float32)], []
    for c in clips:
        offsets.append(sum(len(p) for p in parts))
        parts += [c, rng.standard_normal(5).astype(np.float32)]
    flat = torch.from_numpy(np.concatenate(parts)).to(cuda)
    off = torch.tensor(offsets, device=cuda)
    lens = torch.tensor(ns, device=cuda)
    before = M.pad_stack.launches
    got = M.pad_stack(flat, off, lens, want.shape[1])
    torch.cuda.synchronize()
    assert M.pad_stack.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy().view(np.int16),
                                  want.view(np.int16))
    if case == "edges":
        for b in range(len(clips)):
            one = M.pad_stack(flat, off[b:b + 1], lens[b:b + 1],
                              want.shape[1])
            np.testing.assert_array_equal(
                one[0].cpu().numpy().view(np.int16), want[b].view(np.int16))
    filt = torch.from_numpy(mel_filterbank(128)).to(cuda)
    tables = M.mel_tables(torch.from_numpy(M.dft_basis()).to(cuda), filt)
    host = torch.from_numpy(want).to(cuda)
    assert torch.equal(M.log_mel_raw(got, tables), M.log_mel_raw(host,
                                                                tables))
    sane = [(rng.standard_normal(n) * 0.2).astype(np.float32) for n in ns]
    mel, n_lens = MelFrontend(mel_filterbank(128), cuda).device_batch(sane)
    ref = normalize_log_mel(M.log_mel_raw(
        torch.from_numpy(host_padded_stack(sane)).to(cuda), tables))
    assert torch.equal(mel, ref)
    assert n_lens == [min(frame_counts(n)[0], ref.shape[2]) for n in ns]


def test_mel_front_end_staged_then_outsized(cuda):
    """Batch after batch through one front end's pinned buffer (each
    rewriting what the last copied out), then a batch past the buffer,
    which is copied from pageable memory: each mel equals the host-padded
    route's, and the span is given 4 bytes a sample."""
    from godot_whisper_tpu_torch.audio.mel import (MelFrontend,
                                                   normalize_log_mel)
    rng = np.random.default_rng(5)
    filt = mel_filterbank(128)
    front = MelFrontend(filt, cuda)
    tables = M.mel_tables(torch.from_numpy(M.dft_basis()).to(cuda),
                          torch.from_numpy(filt).to(cuda))
    for k, ns in enumerate(([480_000] * 4, [31_999, 7, 480_001],
                            [123_457] * 3, [480_000, 200_003])):
        if k == 3:
            front.STAGED = sum(ns) - 1
        clips = [(rng.standard_normal(n) * 0.2).astype(np.float32)
                 for n in ns]
        span = CountingSpan()
        mel, _ = front.device_batch(clips, span=span)
        ref = normalize_log_mel(M.log_mel_raw(
            torch.from_numpy(host_padded_stack(clips)).to(cuda), tables))
        assert torch.equal(mel, ref), ns
        assert span.counts == {"h2d_bytes": 4 * sum(ns)}
    assert front._staging.numel() == MelFrontend.STAGED


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,t,d,t_valid", [(6, 1536, 64, 1500),
                                            (20, 1536, 64, 1500),
                                            (4, 1536, 32, 1500),
                                            (3, 100, 64, 77)])
def test_attention_kernel_matches_plain(cuda, dtype, bh, t, d, t_valid):
    """f32: within 2e-4 of the plain version.  bf16: the tensor-core
    kernel computes ``_flash_sp_kernel``'s function (q rounded after
    scaling, one row max, p rounded to bf16, l from the rounded p), held to
    ``attention_bh_sp_plain`` within one bf16 ulp per element plus one
    flipped bf16 rounding of a probability per row plus 1e-5
    (``blocked_bf16_limit``)."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(bh, t, d, generator=g).to(cuda, getattr(
        torch, dtype)) for _ in range(3))
    before = A.flash_attention_bh.launches
    got = A.flash_attention_bh(q, k, v, t_valid=t_valid)
    torch.cuda.synchronize()
    assert A.flash_attention_bh.launches == before + 1
    if dtype == "float32":
        want = A.attention_bh_plain(q, k, v, t_valid)
        assert float((got - want).abs().max()) < 2e-4
    else:
        want = A.attention_bh_sp_plain(q, k, v, t_valid)
        err = (got.float() - want.float()).abs()
        lim = blocked_bf16_limit(torch, q, k, v, want, t_valid)
        assert bool((err <= lim).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,h,b,kv_group,c,lo,split,hi", [
    (384, 6, 5, 1, 512, [1, 2, 3, 4, 5], 232, 333),
    (384, 6, 5, 5, 1536, [1500] * 5, 1536, 0),
    (128, 4, 2, 2, 256, [100, 100], 256, 0),
    (1280, 20, 5, 5, 1536, [1500] * 5, 1536, 0),
])
def test_decode_attention_kernel_matches_plain(cuda, dtype, s, h, b,
                                               kv_group, c, lo, split, hi):
    g = torch.Generator().manual_seed(1)
    dt = getattr(torch, dtype)
    q = torch.randn(b, s, generator=g).to(cuda, dt)
    k = torch.randn(2, b // kv_group, c, s, generator=g).to(cuda, dt)
    v = torch.randn(2, b // kv_group, c, s, generator=g).to(cuda, dt)
    lo_t = torch.tensor(lo, dtype=torch.int32, device=cuda)
    kw = dict(split=split, n_head=h, kv_group=kv_group, layer=1)
    before = D.decode_attention.launches
    got = D.decode_attention(q, k, v, lo_t, hi, **kw)
    torch.cuda.synchronize()
    assert D.decode_attention.launches == before + 1
    want = D.decode_attention_plain(q, k, v, lo_t, hi, **kw)
    assert float((got - want).abs().max()) < 1e-4


@pytest.mark.parametrize("name", ["tiny.en", "large-v3"])
@pytest.mark.parametrize("temp", [0.0, 0.4, 1.0])
def test_filter_sample_kernel_matches_plain(cuda, name, temp):
    cfg = get_config(name)
    V = cfg.n_vocab
    g = torch.Generator().manual_seed(2)
    logits = (torch.randn(5, V, generator=g) * 3).to(cuda)
    sup = torch.zeros(V, dtype=torch.bool, device=cuda)
    sup[[cfg.token_not, cfg.token_sot, cfg.token_prev]] = True
    beg = cfg.token_beg
    state = torch.tensor([[1, -1, -1, 0, 0, 3000, int(temp == 0)],
                          [0, beg + 5, 77, 5, 1, 10, 0],
                          [0, 123, beg + 3, 7, 1, 6, 0],
                          [0, 321, 322, 9, 0, 3000, 1],
                          [1, -1, -1, 0, 0, 3000, 0]], dtype=torch.int32,
                         device=cuda)
    kw = dict(temperature=temp, seed=99, eot=cfg.token_eot, beg=beg,
              space_id=220, max_initial_tid=50, suppress_blank=True,
              no_timestamps=False)
    got = FS.fused_filter_sample(logits, sup, state, **kw)
    torch.cuda.synchronize()
    want = FS.fused_filter_sample_plain(logits, sup, state, **kw)
    assert torch.equal(got.token, want.token)
    assert torch.equal(got.tid, want.tid)
    for a, b in zip(got[1:5], want[1:5]):
        assert float((a - b).abs().max()) < 1e-5


def test_greedy_golden_through_kernels(cuda):
    """init_params(nano, seed=3) in f32 on the card reproduces
    tests/golden/nano_decode.json["greedy"] token for token."""
    cfg = get_config("tiny.en").replace(
        n_audio_layer=2, n_text_layer=2, n_audio_state=128, n_audio_head=4,
        n_text_state=128, n_text_head=4, name="nano")
    ctx = gt.WhisperContext.from_params(
        cfg, gt.init_params(cfg, seed=3, compute_dtype=torch.float32,
                            device=cuda),
        device=cuda)
    pipe = ctx.pipeline
    t = np.arange(5 * 16000) / 16000.0
    audio = (0.3 * np.sin(2 * np.pi * 220.0 * t)
             + 0.2 * np.sin(2 * np.pi * 447.0 * t)
             * (0.5 + 0.5 * np.sin(2 * np.pi * 1.7 * t))).astype(np.float32)
    mel, _ = pipe.mel.device(audio)
    xkv = cross_kv(pipe.params, cfg,
                   encoder_forward(pipe.params, cfg, mel[:, :3000].T[None]))
    wd = WindowDecoder(cfg, build_filter_context(cfg, pipe.tokenizer,
                                                 device=cuda))
    res = wd.decode(pipe.params, xkv, np.asarray([cfg.token_sot], np.int32),
                    n_decoders=1, temperature=0.0, seek=0, seek_end=500,
                    suppress_blank=True, no_timestamps=False,
                    single_segment=False, max_tokens=0, test_mode=False)
    with open(os.path.join(os.path.dirname(__file__), "golden",
                           "nano_decode.json")) as f:
        want = json.load(f)["greedy"]
    n = res.n_steps
    assert n == want["n_steps"]
    assert res.tokens[0, :n].tolist() == want["tokens"][0]
    assert res.tok_tid[0, :n].tolist() == want["tid"][0]
    assert res.seek_delta.tolist() == want["seek_delta"]


@pytest.mark.parametrize("name", ["tiny.en", "large-v3"])
def test_filter_topk_kernel_matches_plain(cuda, name):
    """K6: ids and tid exact, plog / p / pt / ptsum within 1e-5; a forced
    tie comes out lowest id first; bit-identical rows give bit-identical
    outputs."""
    cfg = get_config(name)
    V, beg = cfg.n_vocab, cfg.token_beg
    g = torch.Generator().manual_seed(3)
    logits = torch.randn(10, V, generator=g) * 3
    logits[:, [11, 700, 9000]] = 25.0
    logits[8] = logits[3]   # rows 3 and 8 also share their state
    logits = logits.to(cuda)
    sup = torch.zeros(V, dtype=torch.bool, device=cuda)
    sup[[cfg.token_not, cfg.token_sot, cfg.token_prev]] = True
    state = torch.tensor([[1, -1, -1, 0, 0, 3000, 0],
                          [0, beg + 5, 77, 5, 1, 10, 0],
                          [0, 123, beg + 3, 7, 1, 6, 0],
                          [0, 321, 322, 9, 0, 3000, 0],
                          [1, -1, -1, 0, 0, 3000, 0]] * 2,
                         dtype=torch.int32, device=cuda)
    kw = dict(K=5, temperature=0.0, eot=cfg.token_eot, beg=beg, space_id=220,
              max_initial_tid=50, suppress_blank=True, no_timestamps=False)
    before = FS.fused_filter_topk.launches
    got = FS.fused_filter_topk(logits, sup, state, **kw)
    torch.cuda.synchronize()
    assert FS.fused_filter_topk.launches == before + 1
    want = FS.fused_filter_topk_plain(logits, sup, state, **kw)
    assert torch.equal(got.ids, want.ids)
    assert torch.equal(got.tid, want.tid)
    for name_ in ("plog", "p", "pt", "ptsum"):
        assert float((getattr(got, name_) - getattr(want, name_)).abs()
                     .max()) < 1e-5
    assert got.ids[3, :3].tolist() == [11, 700, 9000]
    for t in got:
        assert torch.equal(t[3], t[8])


@pytest.mark.parametrize("V,B", [(51864, 1), (51864, 5), (51864, 40),
                                 (51866, 5), (51866, 8), (1000, 5),
                                 (1000, 8)])
def test_filter_sample_kernel_edge_cases(cuda, V, B):
    """K5's cluster kernel at the edge rows of ``filter_edge_case`` (the
    rule firing, a tie, twin rows, few live ids, timestamp states), t 0
    and t 0.7 with the argmax flag mixed, at tiny.en's V, large-v3's (odd
    rows 8-byte aligned), a small V, B 1 to 40 (8 streams of 5 rows):
    tokens and tids exact, 1e-5 on p / plog / pt / ptsum, a second call
    bitwise equal."""
    r = filter_edge_errors(torch, FS, np.random.default_rng(V + B), V, B)
    assert r["mismatch"] == 0 and r["err"] < 1e-5, r
    assert r["twins"] and r["ties"] and r["repeat"] and r["fired"], r


@pytest.mark.parametrize("V,B,K", [(51864, 5, 5), (51864, 40, 5),
                                   (51866, 8, 8), (51866, 1, 8),
                                   (1000, 8, 6), (1000, 5, 1)])
def test_filter_topk_kernel_edge_cases(cuda, V, B, K):
    """K6's cluster kernel at the same edge rows: ids and tids exact, 1e-5
    on plog / p / pt / ptsum, ties lowest id first, twin rows and two
    calls bitwise equal, and past the few-live row's 3 live ids every slot
    id 0 at -1e30."""
    r = filter_edge_errors(torch, FS, np.random.default_rng(V + B + K), V,
                           B, K)
    assert r["mismatch"] == 0 and r["err"] < 1e-5, r
    assert r["twins"] and r["ties"] and r["repeat"] and r["few"], r


def test_filter_topk_kernel_fewer_live_than_k(cuda):
    """Three live ids at K 6 (every other id in the static mask,
    no_timestamps): the three by value, then id 0 three times at -1e30
    and p 0, as the plain version's argmax-and-mask passes give."""
    cfg = get_config("tiny.en")
    V = cfg.n_vocab
    g = torch.Generator().manual_seed(5)
    logits = (torch.randn(2, V, generator=g) * 3).to(cuda)
    logits[:, 40], logits[:, 7000], logits[:, 900] = 9.0, 8.0, 7.0
    sup = torch.ones(V, dtype=torch.bool, device=cuda)
    sup[[40, 900, 7000]] = False
    state = torch.tensor([[0, 321, 322, 9, 0, 3000, 0],
                          [1, -1, -1, 0, 0, 3000, 0]], dtype=torch.int32,
                         device=cuda)
    kw = dict(K=6, temperature=0.0, eot=cfg.token_eot, beg=cfg.token_beg,
              space_id=220, max_initial_tid=50, suppress_blank=True,
              no_timestamps=True)
    got = FS.fused_filter_topk(logits, sup, state, **kw)
    torch.cuda.synchronize()
    want = FS.fused_filter_topk_plain(logits, sup, state, **kw)
    assert got.ids.tolist() == [[40, 7000, 900, 0, 0, 0]] * 2
    assert torch.equal(got.ids, want.ids) and torch.equal(got.tid, want.tid)
    assert bool((got.plog[:, 3:] == -1e30).all())
    assert bool((got.p[:, 3:] == 0).all())
    for name_ in ("plog", "p", "pt", "ptsum"):
        assert float((getattr(got, name_) - getattr(want, name_)).abs()
                     .max()) < 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,h,g,kgrp,hi_live", [
    (384, 6, 1, 5, 1), (384, 6, 2, 5, 130), (1280, 20, 1, 5, 256),
    (128, 4, 3, 3, 64),
])
def test_split_attention_kernel_matches_plain(cuda, dtype, s, h, g, kgrp,
                                              hi_live):
    """K7 against its plain version in f32 on the same inputs, a permuted
    row map and ragged lo: within 1e-4 (f32 math in another order)."""
    from godot_whisper_tpu_torch.ops import split_attention as SA
    gen = torch.Generator().manual_seed(4)
    dt = getattr(torch, dtype)
    b, cp, nl = g * kgrp, 256, 256

    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to(cuda, dt)
    q, kp, vp = rnd(b, s), rnd(2, g, cp, s), rnd(2, g, cp, s)
    kl, vl = rnd(2, b, nl, s), rnd(2, b, nl, s)
    lo = torch.randint(1, 232, (g,), generator=gen).repeat_interleave(kgrp)
    lo = lo.to(cuda, torch.int32)
    rowmap = torch.randint(0, kgrp, (b, nl), generator=gen).to(
        cuda, torch.int32)
    kw = dict(n_head=h, kv_group=kgrp, layer=1, rowmap=rowmap)
    before = SA.split_beam_attention.launches
    got = SA.split_beam_attention(q, kp, vp, kl, vl, lo, hi_live, **kw)
    torch.cuda.synchronize()
    assert SA.split_beam_attention.launches == before + 1
    want = SA.split_beam_attention_plain(
        q.float(), kp.float(), vp.float(), kl.float(), vl.float(), lo,
        hi_live, **kw)
    assert float((got - want).abs().max()) < 1e-4


@pytest.mark.parametrize("l,b,c,s,hi", [(4, 5, 512, 384, 300),
                                        (3, 8, 512, 1280, 452),
                                        (2, 6, 256, 384, 1)])
def test_reorder_kernel_matches_index_select(cuda, l, b, c, s, hi):
    """K8: exact against index_select on slots c < hi; the slots past hi of
    the NaN-filled destination are never read by K3 (its output over the
    reordered cache is finite and equals its plain version over the
    index_select result)."""
    from godot_whisper_tpu_torch.ops import kv_reorder as R
    gen = torch.Generator().manual_seed(5)
    k = torch.randn(l, b, c, s, generator=gen).to(cuda, torch.bfloat16)
    v = torch.randn(l, b, c, s, generator=gen).to(cuda, torch.bfloat16)
    src = torch.tensor([(j * 3 + 1) % b for j in range(b - 1)] + [b - 1],
                       dtype=torch.int32, device=cuda)
    out = (torch.full_like(k, float("nan")), torch.full_like(v, float("nan")))
    before = R.reorder_kv_live.launches
    ko, vo = R.reorder_kv_live(k, v, src, hi, out=out)
    torch.cuda.synchronize()
    assert R.reorder_kv_live.launches == before + 1
    kr, vr = R.reorder_kv_live_plain(k, v, src, hi)
    assert torch.equal(ko[:, :, :hi], kr[:, :, :hi])
    assert torch.equal(vo[:, :, :hi], vr[:, :, :hi])
    q = torch.randn(b, s, generator=gen).to(cuda, torch.bfloat16)
    lo = torch.ones(b, dtype=torch.int32, device=cuda)
    kw = dict(split=max(hi - 1, 1), n_head=s // 64, layer=l - 1)
    got = D.decode_attention(q, ko, vo, lo, hi, **kw)
    want = D.decode_attention_plain(q, kr, vr, lo, hi, **kw)
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) < 1e-4


def test_beam5_golden_through_kernels(cuda):
    """init_params(nano, seed=3) in f32 on the card reproduces
    nano_decode.json["beam5"] through K6 and K7."""
    from godot_whisper_tpu_torch.ops import split_attention as SA
    cfg = get_config("tiny.en").replace(
        n_audio_layer=2, n_text_layer=2, n_audio_state=128, n_audio_head=4,
        n_text_state=128, n_text_head=4, name="nano")
    ctx = gt.WhisperContext.from_params(
        cfg, gt.init_params(cfg, seed=3, compute_dtype=torch.float32,
                            device=cuda),
        device=cuda)
    pipe = ctx.pipeline
    t = np.arange(5 * 16000) / 16000.0
    audio = (0.3 * np.sin(2 * np.pi * 220.0 * t)
             + 0.2 * np.sin(2 * np.pi * 447.0 * t)
             * (0.5 + 0.5 * np.sin(2 * np.pi * 1.7 * t))).astype(np.float32)
    mel, _ = pipe.mel.device(audio)
    xkv = cross_kv(pipe.params, cfg,
                   encoder_forward(pipe.params, cfg, mel[:, :3000].T[None]))
    wd = WindowDecoder(cfg, build_filter_context(cfg, pipe.tokenizer,
                                                 device=cuda))
    k6, k7 = FS.fused_filter_topk.launches, SA.split_beam_attention.launches
    res = wd.decode(pipe.params, xkv, np.asarray([cfg.token_sot], np.int32),
                    n_decoders=5, temperature=0.0, strategy="beam",
                    beam_size=5, seek=0, seek_end=500, suppress_blank=True,
                    no_timestamps=False, single_segment=False, max_tokens=0,
                    test_mode=False)
    assert FS.fused_filter_topk.launches > k6
    assert SA.split_beam_attention.launches > k7
    with open(os.path.join(os.path.dirname(__file__), "golden",
                           "nano_decode.json")) as f:
        want = json.load(f)["beam5"]
    n = res.n_steps
    assert n == want["n_steps"]
    assert res.tokens[:, :n].tolist() == want["tokens"]
    assert res.tok_tid[:, :n].tolist() == want["tid"]
    assert res.seek_delta.tolist() == want["seek_delta"]
    assert [round(float(x), 3) for x in res.sum_logprobs_all] == \
        want["sum_logprobs"]


# ------------------------------------------------ quantized kernels K9-K12 --
def _qmm_case(gen, cuda, m, s, o):
    x = torch.randn(m, s, generator=gen).to(cuda, torch.bfloat16)
    w = torch.randn(s, o, generator=gen) * 0.02
    return x, w


def _qmm_within(got, want, x, w_abs):
    """f32 sums in another order (tensor-core accumulation included) stay
    within 1e-5 of each element's sum of |terms|."""
    bound = x.float().abs() @ w_abs
    return bool(((got - want).abs() <= 1e-5 * bound + 1e-7).all())


@pytest.mark.parametrize("layout,m,s,o", [
    ("io", 5, 384, 1152),      # tiny.en fused wqkv, one decode step
    ("io", 1500, 384, 384),    # tiny.en cross-K projection (tensor cores)
    ("oi", 5, 384, 51864),     # tiny.en logits against the int8 embedding
    ("io", 8, 1280, 3840),     # large-v3 wqkv at beam 8
    ("io", 1500, 1280, 1280),  # large-v3 cross-K projection
    ("oi", 8, 1280, 51866),    # large-v3 logits
    ("io", 3, 96, 200),        # ragged: no full column quad of blocks
    ("oi", 40, 128, 200),      # tensor-core tiles, oi, ragged O and M
    ("io", 13, 384, 384),      # two row passes of the decode kernel
])
def test_quant_matmul_kernel_matches_plain(cuda, layout, m, s, o):
    from godot_whisper_tpu_torch.ops import qmatmul as Q
    gen = torch.Generator().manual_seed(6)
    x, w = _qmm_case(gen, cuda, m, s, o)
    qt = Q.quantize_tensor((w.t() if layout == "oi" else w).to(cuda),
                           reduce_axis=1 if layout == "oi" else 0)
    before = Q.quant_matmul.launches
    got = Q.quant_matmul(x, qt, layout=layout)
    torch.cuda.synchronize()
    assert Q.quant_matmul.launches == before + 1
    want = Q.quant_matmul_plain(x, qt, layout=layout)
    w_abs = (Q.dequantize(qt).abs().t() if layout == "oi"
             else Q.dequantize(qt).abs())
    assert _qmm_within(got, want, x, w_abs)


@pytest.mark.parametrize("m,s,o", [
    (5, 384, 1152), (5, 1536, 384), (1500, 384, 384), (8, 5120, 1280),
    (1500, 1280, 1280), (3, 256, 200), (40, 256, 200),
])
def test_quant_matmul4_kernel_matches_plain(cuda, m, s, o):
    from godot_whisper_tpu_torch.ops import qmatmul as Q
    gen = torch.Generator().manual_seed(7)
    x, w = _qmm_case(gen, cuda, m, s, o)
    qt = Q.quantize_tensor4(w.to(cuda))
    before = Q.quant_matmul4.launches
    got = Q.quant_matmul4(x, qt)
    torch.cuda.synchronize()
    assert Q.quant_matmul4.launches == before + 1
    want = Q.quant_matmul4_plain(x, qt)
    assert _qmm_within(got, want, x, Q.dequantize4(qt).abs())


@pytest.mark.parametrize("w8a8", [False, True], ids=["exact", "w8a8"])
@pytest.mark.parametrize("s,h,kg,g,t,lo,l", [
    (384, 6, 5, 1, 1536, [1500] * 5, 4),       # tiny.en best_of / beam 5
    (384, 6, 1, 2, 1536, [1500, 1500], 4),     # tiny.en kv_group 1
    (1280, 20, 5, 1, 1536, [1500] * 5, 3),     # large-v3 K12: 100 lanes
    (1280, 20, 8, 1, 1536, [1500] * 8, 3),     # large-v3 beam 8: K11
    (512, 32, 5, 2, 256, [100] * 5 + [77] * 5, 2),  # K11, head dim 16
    (128, 4, 2, 2, 768, [700, 511, 3, 256], 2),     # ragged lo, blocks of 256
])
def test_cross_attention_quant_kernel_matches_plain(cuda, w8a8, s, h, kg, g,
                                                    t, lo, l):
    """K11/K12 against the plain version (the TPU kernels' arithmetic).
    Exact mode: 1e-4.  W8A8: exp() on the card may flip one rounding of
    127 p; the limit allows one flip per (row, head) (``w8a8_flip_limit``)
    on top of 1e-4.  The wide route has exact mode only."""
    from godot_whisper_tpu_torch.models.model import CrossKV, \
        quantize_cross_kv
    from godot_whisper_tpu_torch.ops import cross_attention as CA
    gen = torch.Generator().manual_seed(8)
    b = g * kg
    k = torch.randn(l, g, t, s, generator=gen).to(cuda, torch.bfloat16)
    v = torch.randn(l, g, t, s, generator=gen).to(cuda, torch.bfloat16)
    x = quantize_cross_kv(CrossKV(k, v, t), h)
    q = torch.randn(b, s, generator=gen).to(cuda, torch.bfloat16)
    lo_t = torch.tensor(lo, dtype=torch.int32, device=cuda)
    kw = dict(n_head=h, kv_group=kg, layer=l - 1)
    packed = CA.is_packed(h, kg)
    counter = CA.xattn_q_packed if packed else CA.xattn_q_wide
    before = counter.launches
    got = CA.cross_attention_quant(q, x.k_q, x.k_s, x.v_q, x.v_s,
                                   t_valid=lo_t, w8a8=w8a8, **kw)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    want = CA.cross_attention_quant_plain(q, x.k_q, x.k_s, x.v_q, x.v_s,
                                          lo_t, w8a8=w8a8, **kw)
    err = (got - want).abs()
    if w8a8 and packed:
        tol = 1e-4 + CA.w8a8_flip_limit(q, x.k_q, x.k_s, x.v_s, lo_t, **kw)
        assert bool((err <= tol).all())
    else:
        assert float(err.max()) < 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,t,d,t_valid", [(6, 2048, 64, 2000),
                                            (20, 2048, 64, 2048),
                                            (4, 2000, 32, 2000),
                                            (3, 1600, 64, 1555)])
def test_long_attention_kernel_matches_plain(cuda, dtype, bh, t, d,
                                             t_valid):
    """K13 against its plain version (the same 512-key blocks and rounding
    points): f32 within 1e-5; bf16 within one bf16 ulp per element plus
    one flipped bf16 rounding of a probability per row
    (``blocked_bf16_limit``).  ``flash_attention_bh`` routes a 512-padded
    T above 1536 to K13 and never to K2."""
    gen = torch.Generator().manual_seed(13)
    q, k, v = (torch.randn(bh, t, d, generator=gen).to(cuda,
                                                       getattr(torch, dtype))
               for _ in range(3))
    before = (A.flash_attention_bh.launches, A.flash_attention_long.launches)
    got = A.flash_attention_bh(q, k, v, t_valid=t_valid)
    torch.cuda.synchronize()
    assert (A.flash_attention_bh.launches,
            A.flash_attention_long.launches) == (before[0], before[1] + 1)
    want = A.attention_bh_blocked_plain(q, k, v, t_valid)
    err = (got.float() - want.float()).abs()
    if dtype == "float32":
        assert float(err.max()) < 1e-5
    else:
        lim = blocked_bf16_limit(torch, q, k, v, want, t_valid)
        assert bool((err <= lim).all())


def test_from_file_on_the_card(cuda, tmp_path):
    """A ggml file written by the port's exporter loads onto the card by
    default (from_file and from_buffer) and transcribes as the CPU does
    (f32, gates open)."""
    from godot_whisper_tpu_torch.audio.tokenizer import synthetic_vocab
    from godot_whisper_tpu_torch.models import loader_ggml
    from godot_whisper_tpu_torch.models.export_ggml import export_checkpoint
    cfg = get_config("tiny.en").replace(
        n_audio_layer=2, n_text_layer=3, n_audio_state=128, n_audio_head=4,
        n_text_state=128, n_text_head=4, name="nano-3")
    path = str(tmp_path / "nano3.bin")
    export_checkpoint(path, gt.init_params(cfg, seed=3, device="cpu",
                                           compute_dtype=torch.float32),
                      cfg, mel_filterbank(80), synthetic_vocab(cfg),
                      ttype=loader_ggml.GGML_TYPE_F32)
    t = np.arange(20 * 16000) / 16000.0
    audio = (0.3 * np.sin(2 * np.pi * (220.0 + 60 * np.sin(
        2 * np.pi * 0.07 * t)) * t)).astype(np.float32)
    tp = gt.TranscribeParams(entropy_thold=-1e9, logprob_thold=-1e9)

    def view(c):
        return [(s.text, s.t0, s.t1, [x.id for x in s.tokens])
                for s in c.full(tp, audio)]
    want = view(gt.WhisperContext.from_file(path, device="cpu",
                                            compute_dtype=torch.float32))
    card = gt.WhisperContext.from_file(path, compute_dtype=torch.float32)
    assert card.pipeline.device.type == "cuda"
    assert len(want) > 0 and view(card) == want
    buf = gt.WhisperContext.from_buffer(open(path, "rb").read(),
                                        compute_dtype=torch.float32)
    assert view(buf) == want


@pytest.mark.parametrize("case", [
    # (S, heads, B, kv_group, C, lo, split, hi)
    (384, 6, 5, 1, 512, [1] * 5, 232, 233),            # step 0
    (384, 6, 5, 1, 512, [0, 0, 1, 4, 9], 232, 233),    # lo 0: current token
    (384, 6, 3, 1, 512, [1, 4, 9], 232, 333),          # the dead gap
    (1280, 20, 8, 8, 1536, [1500] * 8, 1536, 0),       # kv_group 8, 160 lanes
    (384, 6, 5, 5, 1000, [990] * 5, 1000, 0),          # slices do not divide C
    (384, 6, 1, 1, 512, [0], 0, 4),                    # host path, step 0
    (384, 6, 1, 1, 512, [0], 0, 230),                  # host path, step 226
], ids=["step0", "current-token-only", "dead-gap", "kv_group8",
        "C1000", "contiguous-step0", "contiguous-step226"])
def test_decode_attention_split_edges(cuda, case):
    """The split-cache K3/K4 at its edge cases against its plain version
    (bf16 inputs, within 1e-4), bitwise equal from call to call (the merge
    runs in split order).  The host-stepped decoder's contiguous cache
    (split 0, lo 0, hi = slot + 1: one region, the slots past hi hold the
    prompt pass's padding rows) is one of them."""
    s, h, b, kv_group, c, lo, split, hi = case
    g = torch.Generator().manual_seed(6)
    q = torch.randn(b, s, generator=g).to(cuda, torch.bfloat16)
    k, v = (torch.randn(2, b // kv_group, c, s, generator=g).to(
        cuda, torch.bfloat16) for _ in range(2))
    lo_t = torch.tensor(lo, dtype=torch.int32, device=cuda)
    kw = dict(split=split, n_head=h, kv_group=kv_group, layer=1)
    got = D.decode_attention(q, k, v, lo_t, hi, **kw)
    again = D.decode_attention(q, k, v, lo_t, hi, **kw)
    torch.cuda.synchronize()
    want = D.decode_attention_plain(q, k, v, lo_t, hi, **kw)
    assert float((got - want).abs().max()) < 1e-4
    assert torch.equal(got, again)


@pytest.mark.parametrize("case", [
    # (S, heads, G, beams, CP, NL, lo per group, hi_live)
    (384, 6, 1, 5, 256, 256, [0], 1),          # live step 0, empty prompt
    (1280, 20, 1, 8, 256, 256, [120], 100),    # 8 beams, 160 lanes
    (384, 6, 2, 5, 232, 200, [100, 37], 150),  # slices do not divide
], ids=["step0-empty-prompt", "beam8", "CP232-NL200"])
def test_split_attention_split_edges(cuda, case):
    """The split-cache K7 at its edge cases against its plain version in
    f32 on the same bf16 inputs (within 1e-4), bitwise equal from call to
    call."""
    from godot_whisper_tpu_torch.ops import split_attention as SA
    s, h, g, kgrp, cp, nl, lo_g, hi_live = case
    gen = torch.Generator().manual_seed(7)
    b = g * kgrp

    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to(cuda, torch.bfloat16)
    q, kp, vp = rnd(b, s), rnd(2, g, cp, s), rnd(2, g, cp, s)
    kl, vl = rnd(2, b, nl, s), rnd(2, b, nl, s)
    lo = torch.tensor(lo_g).repeat_interleave(kgrp).to(cuda, torch.int32)
    rowmap = torch.randint(0, kgrp, (b, nl), generator=gen).to(
        cuda, torch.int32)
    kw = dict(n_head=h, kv_group=kgrp, layer=1, rowmap=rowmap)
    got = SA.split_beam_attention(q, kp, vp, kl, vl, lo, hi_live, **kw)
    again = SA.split_beam_attention(q, kp, vp, kl, vl, lo, hi_live, **kw)
    torch.cuda.synchronize()
    want = SA.split_beam_attention_plain(
        q.float(), kp.float(), vp.float(), kl.float(), vl.float(), lo,
        hi_live, **kw)
    assert float((got - want).abs().max()) < 1e-4
    assert torch.equal(got, again)


def test_split_cache_kernels_replay_in_a_cuda_graph(cuda):
    """K3/K4 and K7 captured in one CUDA graph and replayed: every replay
    gives the eager result bit for bit (the last CTA of each (group, head)
    leaves its ticket at 0 for the next launch)."""
    from godot_whisper_tpu_torch.ops import split_attention as SA
    gen = torch.Generator().manual_seed(8)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to(cuda, torch.bfloat16)
    q, k, v = rnd(5, 384), rnd(2, 1, 1536, 384), rnd(2, 1, 1536, 384)
    lo = torch.full((5,), 1500, dtype=torch.int32, device=cuda)
    kp, vp, kl, vl = (rnd(2, 1, 256, 384), rnd(2, 1, 256, 384),
                      rnd(2, 5, 256, 384), rnd(2, 5, 256, 384))
    lo_p = torch.full((5,), 120, dtype=torch.int32, device=cuda)
    rowmap = torch.randint(0, 5, (5, 256), generator=gen).to(cuda,
                                                             torch.int32)

    def step():
        return (D.decode_attention(q, k, v, lo, 0, split=1536, n_head=6,
                                   kv_group=5, layer=1),
                SA.split_beam_attention(q, kp, vp, kl, vl, lo_p, 100,
                                        n_head=6, kv_group=5, layer=1,
                                        rowmap=rowmap))
    want = step()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = step()
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(outs, want))


# ------------------------------------- K9 / K12 redesigned (split, cluster) --
def _qmm_check(cuda, layout, m, s, o, seed=9, offset=0):
    """K9 against its plain version; ``offset`` > 0 puts the weight at that
    byte offset into a larger buffer (not 16-byte aligned)."""
    from godot_whisper_tpu_torch.ops import qmatmul as Q
    gen = torch.Generator().manual_seed(seed)
    x, w = _qmm_case(gen, cuda, m, s, o)
    qt = Q.quantize_tensor((w.t() if layout == "oi" else w).to(cuda),
                           reduce_axis=1 if layout == "oi" else 0)
    if offset:
        buf = torch.zeros(qt.q.numel() + offset, dtype=torch.int8,
                          device=cuda)
        buf[offset:] = qt.q.reshape(-1)
        qt = Q.QuantTensor(buf[offset:].view(qt.q.shape), qt.s)
        assert qt.q.data_ptr() % 16
    got = Q.quant_matmul(x, qt, layout=layout)
    again = Q.quant_matmul(x, qt, layout=layout)
    torch.cuda.synchronize()
    want = Q.quant_matmul_plain(x, qt, layout=layout)
    w_abs = (Q.dequantize(qt).abs().t() if layout == "oi"
             else Q.dequantize(qt).abs())
    assert _qmm_within(got, want, x, w_abs)
    assert torch.equal(got, again)


@pytest.mark.parametrize("m", list(range(1, 18)))
@pytest.mark.parametrize("layout,s,o", [
    ("io", 1000, 200),   # S not a whole number of slices, O not of tiles
    ("io", 2080, 1104),  # 16-byte rows, several slices and tiles
    ("oi", 1000, 200),   # S not a multiple of 16: byte loads
    ("oi", 448, 3000),   # a partial k-block and a partial column tile
])
def test_quant_matmul_rows_at_every_row_count(cuda, m, layout, s, o):
    """K9's decode-row routes at 1..16 rows (17: the tensor-core route),
    within 1e-5 of each element's sum of |terms|, bitwise equal from call
    to call (the slices' partials are added in a fixed order)."""
    _qmm_check(cuda, layout, m, s, o)


@pytest.mark.parametrize("layout,m,s,o", [
    ("io", 5, 384, 1152), ("io", 40, 384, 384), ("oi", 5, 384, 3000),
    ("oi", 40, 128, 200)])
def test_quant_matmul_unaligned_weight(cuda, layout, m, s, o):
    """A weight one byte into a larger buffer takes the byte-load paths and
    stays correct (no misaligned 16-byte load)."""
    _qmm_check(cuda, layout, m, s, o, offset=1)


def _xattn_inputs(cuda, s, h, kg, g, t, lo, n_layer=2, seed=10):
    from godot_whisper_tpu_torch.models.model import CrossKV, \
        quantize_cross_kv
    gen = torch.Generator().manual_seed(seed)
    k = torch.randn(n_layer, g, t, s, generator=gen).to(cuda, torch.bfloat16)
    v = torch.randn(n_layer, g, t, s, generator=gen).to(cuda, torch.bfloat16)
    x = quantize_cross_kv(CrossKV(k, v, t), h)
    q = torch.randn(g * kg, s, generator=gen).to(cuda, torch.bfloat16)
    lo_t = torch.tensor(lo, dtype=torch.int32, device=cuda)
    return q, x, lo_t


@pytest.mark.parametrize("w8a8", [False, True], ids=["exact", "w8a8"])
@pytest.mark.parametrize("s,h,kg,g,t,lo", [
    (384, 6, 5, 1, 1536, [10] * 5),                  # lo below one slice
    (384, 6, 5, 1, 1536, [100, 77, 130, 1, 64]),     # lo off the slices
    (384, 6, 5, 1, 1536, [1100] * 5),   # block 2: CTAs with no valid slot
    (384, 6, 1, 3, 1536, [1500, 700, 33]),           # kv_group 1
    (384, 6, 8, 1, 1536, [1500, 3, 64, 65, 512, 513, 1024, 1535]),
    (1280, 20, 5, 1, 1536, [1500] * 5),              # large-v3 widths
    (384, 6, 5, 2, 768, [700] * 5 + [200] * 5),      # T 768: 256 blocks
    (512, 32, 4, 1, 512, [300, 1, 511, 512]),        # head dim 16
])
def test_xattn_packed_cluster_edges(cuda, w8a8, s, h, kg, g, t, lo):
    """K12's cluster kernel at its edges against the plain version (exact:
    1e-4; W8A8: 1e-4 plus one flipped round(127 p) per (row, head)), and
    bitwise equal from call to call."""
    from godot_whisper_tpu_torch.ops import cross_attention as CA
    q, x, lo_t = _xattn_inputs(cuda, s, h, kg, g, t, lo)
    assert CA.is_packed(h, kg)
    kw = dict(n_head=h, kv_group=kg, layer=1)
    got = CA.cross_attention_quant(q, x.k_q, x.k_s, x.v_q, x.v_s,
                                   t_valid=lo_t, w8a8=w8a8, **kw)
    again = CA.cross_attention_quant(q, x.k_q, x.k_s, x.v_q, x.v_s,
                                     t_valid=lo_t, w8a8=w8a8, **kw)
    torch.cuda.synchronize()
    want = CA.cross_attention_quant_plain(q, x.k_q, x.k_s, x.v_q, x.v_s,
                                          lo_t, w8a8=w8a8, **kw)
    err = (got - want).abs()
    tol = 1e-4 + (CA.w8a8_flip_limit(q, x.k_q, x.k_s, x.v_s, lo_t, **kw)
                  if w8a8 else 0.0)
    assert bool((err <= tol).all())
    assert torch.equal(got, again)


def test_quant_kernels_replay_in_a_cuda_graph(cuda):
    """K9's three routes (the io rows with split partials and tickets) and
    K12 in both modes captured in one CUDA graph: every replay gives the
    eager result bit for bit."""
    from godot_whisper_tpu_torch.ops import cross_attention as CA
    from godot_whisper_tpu_torch.ops import qmatmul as Q
    gen = torch.Generator().manual_seed(11)
    x5, w_io = _qmm_case(gen, cuda, 5, 1536, 384)
    x_tc, _ = _qmm_case(gen, cuda, 1500, 1536, 384)
    _, w_oi = _qmm_case(gen, cuda, 5, 1536, 3000)
    q_io = Q.quantize_tensor(w_io.to(cuda), reduce_axis=0)
    q_oi = Q.quantize_tensor(w_oi.t().contiguous().to(cuda), reduce_axis=1)
    q, xkv, lo = _xattn_inputs(cuda, 384, 6, 5, 1, 1536, [1100] * 5)

    def step():
        return (Q.quant_matmul(x5, q_io, layout="io"),
                Q.quant_matmul(x_tc, q_io, layout="io"),
                Q.quant_matmul(x5, q_oi, layout="oi"),
                *(CA.cross_attention_quant(q, xkv.k_q, xkv.k_s, xkv.v_q,
                                           xkv.v_s, n_head=6, t_valid=lo,
                                           kv_group=5, layer=1, w8a8=m)
                  for m in (True, False)))
    want = step()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = step()
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(outs, want))


# --------------------------------------- K10 in two routes, K11 as a cluster --
def _q4_check(cuda, m, s, o, seed=12, offset=0):
    """K10 against its plain version within ``_qmm_within``, bitwise equal
    from call to call; ``offset`` > 0 puts the packed weight at that byte
    offset into a larger buffer (not 16-byte aligned).  Returns the route
    the call took."""
    from godot_whisper_tpu_torch.ops import qmatmul as Q
    gen = torch.Generator().manual_seed(seed)
    x, w = _qmm_case(gen, cuda, m, s, o)
    qt = Q.quantize_tensor4(w.to(cuda))
    if offset:
        buf = torch.zeros(qt.q.numel() + offset, dtype=torch.uint8,
                          device=cuda)
        buf[offset:] = qt.q.reshape(-1)
        qt = Q.Quant4Tensor(buf[offset:].view(qt.q.shape), qt.s)
        assert qt.q.data_ptr() % 16
    before = dict(Q.quant_matmul4.route_launches)
    got = Q.quant_matmul4(x, qt)
    again = Q.quant_matmul4(x, qt)
    torch.cuda.synchronize()
    want = Q.quant_matmul4_plain(x, qt)
    assert _qmm_within(got, want, x, Q.dequantize4(qt).abs())
    assert torch.equal(got, again)
    after = Q.quant_matmul4.route_launches
    (route,) = [r for r in after if after[r] != before.get(r, 0)]
    assert after[route] == before.get(route, 0) + 2
    return route


@pytest.mark.parametrize("m,s,o", [
    # decode rows (M <= 16)
    (1, 384, 1152), (5, 384, 1536), (8, 1280, 3840), (16, 384, 384),
    (5, 1536, 384),    # two slices of 6 groups
    (5, 5120, 200),    # eight slices, O not a multiple of 16
    (16, 5120, 1280),  # large-v3 mlp.w1: 10 passes, unsplit
    (5, 128, 200),     # one group
    (12, 128, 1104),   # one group, two row chunks
    # tensor-core tiles (M > 16)
    (17, 384, 1152), (40, 256, 200), (1500, 384, 384), (1500, 128, 200),
    (1500, 1280, 1280), (33, 5120, 1280),
])
def test_quant_matmul4_routes(cuda, m, s, o):
    """K10's decode-row kernel (M <= 16) and tensor-core tiles (M > 16)
    at the decode step's and the 1500-row projections' widths and at their
    edges: one group, slices cut on group boundaries, ragged O (plain
    loads) and M."""
    assert _q4_check(cuda, m, s, o) == ("rows" if m <= 16 else "tc")


@pytest.mark.parametrize("m,s,o", [(5, 384, 1152), (40, 384, 384)])
def test_quant_matmul4_unaligned_weight(cuda, m, s, o):
    """A packed weight one byte into a larger buffer takes the byte-load
    paths of both routes and stays correct."""
    _q4_check(cuda, m, s, o, offset=1)


@pytest.mark.parametrize("s,h,kg,g,t,lo", [
    (1280, 20, 8, 1, 1536, [1500] * 8),               # large-v3 beam 8
    (1280, 20, 7, 1, 1536, [0, 1500, 257, 1, 256, 700, 1023]),  # lo 0
    (1280, 20, 7, 2, 768, [700, 3, 256, 511, 600, 64, 65,
                           500, 257, 9, 400, 1, 300, 299]),
    (1280, 20, 8, 1, 512, [511, 0, 17, 256, 255, 100, 1, 300]),
    (512, 32, 5, 2, 256, [100, 1, 77, 255, 256, 3, 200, 0, 64, 65]),  # D 16
    (320, 20, 8, 1, 768, [700, 0, 1, 256, 257, 511, 512, 600]),       # D 16
])
def test_xattn_wide_cluster_edges(cuda, s, h, kg, g, t, lo):
    """K11 (kv_group * n_head > 128) on the cluster template: ragged lo,
    lo 0 (every slot masked: uniform weights over the group's blocks, as
    in the plain version when the group decides the block count), kv_group
    7 and 8, head dim 16 and 64; within 1e-4 of the plain version and
    bitwise equal from call to call."""
    from godot_whisper_tpu_torch.ops import cross_attention as CA
    q, x, lo_t = _xattn_inputs(cuda, s, h, kg, g, t, lo)
    assert not CA.is_packed(h, kg)
    kw = dict(n_head=h, kv_group=kg, layer=1)
    before = CA.xattn_q_wide.launches
    got = CA.cross_attention_quant(q, x.k_q, x.k_s, x.v_q, x.v_s,
                                   t_valid=lo_t, w8a8=False, **kw)
    again = CA.cross_attention_quant(q, x.k_q, x.k_s, x.v_q, x.v_s,
                                     t_valid=lo_t, w8a8=False, **kw)
    torch.cuda.synchronize()
    assert CA.xattn_q_wide.launches == before + 2
    want = CA.cross_attention_quant_plain(q, x.k_q, x.k_s, x.v_q, x.v_s,
                                          lo_t, w8a8=False, **kw)
    assert float((got - want).abs().max()) < 1e-4
    assert torch.equal(got, again)


def test_k10_k11_replay_in_a_cuda_graph(cuda):
    """K10's two routes (the rows with a split) and K11 captured in one
    CUDA graph: every replay gives the eager result bit for bit."""
    from godot_whisper_tpu_torch.ops import cross_attention as CA
    from godot_whisper_tpu_torch.ops import qmatmul as Q
    gen = torch.Generator().manual_seed(13)
    x5, w = _qmm_case(gen, cuda, 5, 1536, 384)
    x_tc, _ = _qmm_case(gen, cuda, 1500, 1536, 384)
    qt = Q.quantize_tensor4(w.to(cuda))
    q, xkv, lo = _xattn_inputs(cuda, 1280, 20, 8, 1, 1536,
                               [1500, 0, 3, 256, 700, 1100, 1499, 64])

    def step():
        return (Q.quant_matmul4(x5, qt), Q.quant_matmul4(x_tc, qt),
                CA.cross_attention_quant(q, xkv.k_q, xkv.k_s, xkv.v_q,
                                         xkv.v_s, n_head=20, t_valid=lo,
                                         kv_group=8, layer=1, w8a8=False))
    want = step()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = step()
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(outs, want))


def _nano3(gain=1.0):
    cfg = get_config("tiny.en").replace(
        n_audio_layer=2, n_text_layer=3, n_audio_state=128, n_audio_head=4,
        n_text_state=128, n_text_head=4, name="nano-3")
    params = gt.init_params(cfg, seed=3, compute_dtype=torch.float32,
                            device="cuda")
    params["decoder"]["ln"]["g"] *= gain
    return gt.WhisperContext.from_params(cfg, params, device="cuda")


def _tone(seconds):
    t = np.arange(int(seconds * 16000)) / 16000.0
    return (0.3 * np.sin(2 * np.pi * (220.0 + 60 * np.sin(
        2 * np.pi * 0.07 * t)) * t)
        + 0.2 * np.sin(2 * np.pi * 447.0 * t)).astype(np.float32)


def test_batched_nano_equals_single_stream_on_card(cuda):
    """BatchTranscriber on the card: three ragged nano f32 streams of one
    decoder row each (best_of 1: self- and cross-attention both at
    kv_group 1, 3 rows) through K1 (one launch), K2-K5, each equal to its
    single-stream decode token for token (t = 0 rung, gates open)."""
    from godot_whisper_tpu_torch.parallel.batch import BatchTranscriber
    ctx = _nano3()
    bt = BatchTranscriber(ctx)
    p = gt.TranscribeParams(entropy_thold=-1e9, logprob_thold=-1e9,
                            best_of=1, temperature_inc=0.0)
    clips = [_tone(x) for x in (2.0, 5.5, 9.0)]
    before = M.log_mel_raw.launches
    D.decode_attention.rows_launches.clear()
    batched = bt.transcribe(clips, p)
    assert M.log_mel_raw.launches == before + 1
    assert set(D.decode_attention.rows_launches) == {(1, 3)}

    def view(segs):
        return [(s.text, s.t0, s.t1, [x.id for x in s.tokens]) for s in segs]
    assert any(batched)
    for segs, clip in zip(batched, clips):
        assert view(segs) == view(bt.transcribe([clip], p)[0])


def test_incremental_mel_on_card_matches_host(cuda):
    """IncrementalMel's buffer lives on the card; fed in 0.3 s pushes it
    equals the one-shot host mel within 2e-5 (the JAX suite's limit)."""
    from godot_whisper_tpu_torch.audio.mel import log_mel_host
    from godot_whisper_tpu_torch.runtime.streaming import IncrementalMel
    ctx = _nano3()
    audio = _tone(3.1)
    inc = IncrementalMel(ctx.pipeline)
    for i in range(0, len(audio), 4800):
        inc.feed(audio[i:i + 4800])
    mel, _, _ = inc.normalized()
    assert mel.device.type == "cuda"
    np.testing.assert_allclose(
        mel.cpu().numpy(), log_mel_host(audio, ctx.pipeline.mel.filters,
                                        n_frames=inc.cap),
        atol=2e-5, rtol=2e-5)


def test_identity_callback_decodes_like_the_clip_path_on_card(cuda):
    """nano-3 f32 with an identity logits_filter_callback takes the
    host-stepped decoder (K3 for one row's self- and cross-attention, the
    plain filters, no K5) and gives the tokens of the same params without
    it (the clip path through K5): on 34 s, two windows and tens of text
    and timestamp tokens."""
    from godot_whisper_tpu_torch.ops.filter_sample import fused_filter_sample
    ctx = _nano3()
    audio = frozen_audio(34.0)
    p = dict(best_of=1, temperature_inc=0.0, entropy_thold=-1e9,
             logprob_thold=-1e9)
    plain = ctx.full(gt.TranscribeParams(**p), audio)
    D.decode_attention.group_launches.clear()
    before = fused_filter_sample.launches
    hooked = ctx.full(gt.TranscribeParams(
        logits_filter_callback=lambda tokens, logits: None, **p), audio)
    torch.cuda.synchronize()
    assert D.decode_attention.group_launches[1] > 0
    assert set(D.decode_attention.group_launches) == {1}
    assert fused_filter_sample.launches == before

    def ids(segs):
        return [[x.id for x in s.tokens] for s in segs]
    assert sum(map(len, ids(plain))) >= 20 and ids(hooked) == ids(plain)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,t_valid,long", [(1536, 1500, False),
                                            (2048, 2000, True)],
                         ids=["K2", "K13"])
def test_encoder_attention_under_autograd(cuda, dtype, t, t_valid, long):
    """At phase 2's shapes (tiny.en, 6 heads): under autograd K2 / K13
    still compute the forward (one launch, none in the backward) and the
    output has a grad_fn; the gradients equal direct autograd of the
    kernel's plain function on the card (the backward recomputes it from
    the same q, k and v: 1e-6 of the largest element for summation
    order)."""
    gen = torch.Generator().manual_seed(7)
    q, k, v, w = (torch.randn(6, t, 64, generator=gen).to(
        cuda, getattr(torch, dtype)) for _ in range(4))
    plain = A.attention_bh_blocked_plain if long else A.attention_bh_sp_plain

    def grads(fn):
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = fn(*xs)
        return out, xs

    before = (A.flash_attention_bh.launches, A.flash_attention_long.launches)
    out, xs = grads(lambda a, b, c: A.flash_attention_bh(a, b, c, t_valid))
    assert out.grad_fn is not None
    out.backward(w)
    torch.cuda.synchronize()
    after = (A.flash_attention_bh.launches, A.flash_attention_long.launches)
    assert after == ((before[0], before[1] + 1) if long
                     else (before[0] + 1, before[1]))
    ref, ys = grads(lambda a, b, c: plain(a, b, c, t_valid))
    ref.backward(w)
    for x, y in zip(xs, ys):
        scale = float(y.grad.float().abs().max())
        assert scale > 0
        assert float((x.grad.float() - y.grad.float()).abs().max()) <= \
            1e-6 * scale
    assert float(xs[1].grad[:, t_valid:].float().abs().max()) == 0.0


def test_matmul_f32_under_autograd(cuda):
    """The card's bf16 x bf16 -> f32 product (``torch.mm(out_dtype=)``,
    which has no derivative) under autograd: its gradients within one bf16
    ulp of autograd through the CPU route's ``x.float() @ w.float()`` on
    the card."""
    gen = torch.Generator().manual_seed(3)
    x, w = (torch.randn(*s, generator=gen).to(cuda, torch.bfloat16)
            for s in ((2, 40, 384), (384, 1152)))
    g = torch.randn(2, 40, 1152, generator=gen).to(cuda)
    xa, wa = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    y = tm._matmul_f32(xa, wa)
    assert y.dtype == torch.float32 and y.grad_fn is not None
    y.backward(g)
    xb, wb = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    torch.matmul(xb.float(), wb.float()).backward(g)
    for a, b in ((xa.grad, xb.grad), (wa.grad, wb.grad)):
        assert a.dtype == torch.bfloat16
        a, b = a.float(), b.float()
        ulp = torch.exp2(torch.floor(torch.log2(
            b.abs().clamp_min(1e-30))) - 7)
        assert bool(((a - b).abs() <= ulp).all())


def _nano_train(n_audio_ctx=64):
    cfg = get_config("tiny.en").replace(
        n_audio_layer=2, n_text_layer=2, n_audio_state=128, n_audio_head=4,
        n_text_state=128, n_text_head=4, n_audio_ctx=n_audio_ctx,
        name="nano")
    rng = np.random.default_rng(0)
    tok = rng.integers(0, cfg.n_vocab, (2, 9)).astype(np.int32)
    mask = np.ones((2, 8), np.float32)
    mask[1, 4:] = 0.0
    batch = {"mel": rng.standard_normal(
        (2, 2 * n_audio_ctx, cfg.n_mels)).astype(np.float32),
        "tokens": tok[:, :-1], "targets": tok[:, 1:], "mask": mask}
    return cfg, batch, gt.init_params(cfg, seed=3,
                                      compute_dtype=torch.float32,
                                      device="cpu")


def _to(tree, dev):
    return tree_map(lambda _, x: x.to(dev), tree)


def test_conv_stem_gradients_without_tf32(cuda):
    """With cuDNN's TF32 switched on globally (PyTorch's default), the f32
    conv stem's gradients on the card stay within 1e-5 (relative norm) of
    the CPU's: ``loss_and_grads`` runs the backward with TF32 off, as the
    stem runs its forward (TF32 would be about 1e-3 off)."""
    from godot_whisper_tpu_torch.models import training as tt
    cfg, batch, params = _nano_train()
    torch.backends.cudnn.allow_tf32 = True
    try:
        _, g_d = tt.loss_and_grads(_to(params, cuda), cfg, batch)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    _, g_h = tt.loss_and_grads(params, cfg, batch, device="cpu")
    for name in ("conv1", "conv2"):
        a = g_d["encoder"][name]["w"].cpu()
        b = g_h["encoder"][name]["w"]
        assert float((a - b).norm() / b.norm()) <= 1e-5, name


@pytest.mark.parametrize("n_audio_ctx", [64, 1500])
def test_train_step_nano_on_card_matches_cpu(cuda, n_audio_ctx):
    """nano f32 (at n_audio_ctx 1500 the card pads the encoder to 1536 and
    masks the pad keys): the loss within 1e-5 and every gradient leaf
    within 1e-4 (relative norm) of the CPU route's; K2 launches twice a
    gradient (2 audio layers); two steps on the card lower the loss."""
    from godot_whisper_tpu_torch.models import training as tt
    cfg, batch, params = _nano_train(n_audio_ctx)
    before = A.flash_attention_bh.launches
    loss_d, g_d = tt.loss_and_grads(_to(params, cuda), cfg, batch)
    torch.cuda.synchronize()
    assert A.flash_attention_bh.launches == before + 2
    loss_h, g_h = tt.loss_and_grads(params, cfg, batch, device="cpu")
    assert abs(float(loss_d) - float(loss_h)) <= 1e-5 * float(loss_h)
    want = dict(tree_leaves(g_h))
    for key, g in tree_leaves(g_d):
        assert g.device.type == "cuda"
        err = float((g.cpu() - want[key]).norm()
                    / max(float(want[key].norm()), 1e-30))
        assert err <= 1e-4, (key, err)
    state = tt.init_train_state(_to(params, cuda))
    state, l1 = tt.train_step(state, cfg, batch)
    state, l2 = tt.train_step(state, cfg, batch)
    assert float(l2) < float(l1)
    assert state.params["encoder"]["conv1"]["w"].device.type == "cuda"


# ------------------------------------------------------- multiple devices --
def _k1_k5_on(dev):
    """K1 on 3 s of audio and K5 on 5 tiny.en rows on ``dev``: (launched,
    K1 against its plain version, K5's tokens equal the plain version's)."""
    cfg = get_config("tiny.en")
    rng = np.random.default_rng(3)
    audio = (rng.standard_normal(3 * 16000) * 0.1).astype(np.float32)
    a16 = torch.from_numpy(pad_audio(audio).astype(np.float16)).to(dev)[None]
    filt = torch.from_numpy(mel_filterbank(80)).to(dev)
    basis = torch.from_numpy(M.dft_basis()).to(dev)
    n1, n5 = M.log_mel_raw.launches, FS.fused_filter_sample.launches
    got = M.log_mel_raw(a16, M.mel_tables(basis, filt))
    mel_err = float((got - M.log_mel_raw_plain(a16, basis, filt)).abs()
                    .max())
    V = cfg.n_vocab
    logits = (torch.randn(5, V, generator=torch.Generator().manual_seed(2))
              * 3).to(dev)
    sup = torch.zeros(V, dtype=torch.bool, device=dev)
    state = torch.tensor([[1, -1, -1, 0, 0, 3000, 1]] * 5, dtype=torch.int32,
                         device=dev)
    kw = dict(temperature=0.0, seed=99, eot=cfg.token_eot, beg=cfg.token_beg,
              space_id=220, max_initial_tid=50, suppress_blank=True,
              no_timestamps=False)
    tok = FS.fused_filter_sample(logits, sup, state, **kw).token
    torch.cuda.synchronize(dev)
    launched = (M.log_mel_raw.launches == n1 + 1
                and FS.fused_filter_sample.launches == n5 + 1)
    same = torch.equal(tok, FS.fused_filter_sample_plain(logits, sup, state,
                                                         **kw).token)
    return launched, mel_err, same


def test_k1_k5_launch_on_a_second_device(cuda):
    """K1's shared-memory attribute and K5's cluster attribute are set per
    device: both launch, and agree with their plain versions, on cuda:1
    after cuda:0 in one process."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    for dev in (torch.device("cuda", 0), torch.device("cuda", 1)):
        launched, mel_err, same = _k1_k5_on(dev)
        assert launched and same, dev
        assert mel_err < 1e-3, (dev, mel_err)


def _tp2_step_worker(rank, port, out):
    """One rank of a tp 2 decoder_step on cuda:0 over gloo: nano f32, the
    prompt pass and one step, logits written to ``out``."""
    import torch.distributed as dist
    from godot_whisper_tpu_torch.parallel.sharding import (make_mesh,
                                                           shard_params)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    mesh = make_mesh(1, 2, device="cuda:0")
    cfg, logits = _nano_step(shard_params, mesh)
    np.save(out, logits)
    dist.destroy_process_group()


def _nano_step(shard, mesh=None):
    """nano f32 on cuda:0 (sharded when ``mesh`` is given): the logits of
    one decoder_step after a 4-token prompt pass, on the host."""
    cfg = get_config("tiny.en").replace(
        n_audio_layer=2, n_text_layer=2, n_audio_state=128, n_audio_head=4,
        n_text_state=128, n_text_head=4, name="nano")
    dev = torch.device("cuda", 0)
    params = gt.init_params(cfg, seed=3, compute_dtype=torch.float32,
                            device=dev)
    tp = None
    if mesh is not None:
        params, tp = shard(params, mesh, cfg), mesh.tp_group
    rng = np.random.default_rng(4)
    mel = torch.from_numpy(rng.standard_normal(
        (2, 2 * cfg.n_audio_ctx, cfg.n_mels)).astype(np.float32)).to(dev)
    tokens = torch.from_numpy(rng.integers(0, cfg.n_vocab, (2, 4)).astype(
        np.int32)).to(dev)
    with torch.no_grad():
        xkv = cross_kv(params, cfg, encoder_forward(params, cfg, mel, tp=tp),
                       tp=tp)
        kv = tm.init_kv_cache(cfg, 2, dtype=torch.float32, device=dev, tp=tp)
        pos = torch.arange(4, dtype=torch.int32, device=dev).expand(2, 4)
        _, kv = tm.decoder_dense(params, cfg, tokens, pos, kv, xkv,
                                 n_valid=torch.full((2,), 4, device=dev),
                                 tp=tp)
        logits, _ = tm.decoder_step(
            params, cfg, tokens[:, 0], torch.full((2,), 4, dtype=torch.int32,
                                                  device=dev),
            kv, xkv, lo=torch.zeros(2, dtype=torch.int32, device=dev),
            slot=4, split=0, tp=tp)
    return cfg, logits.cpu().numpy()


def test_tp2_decoder_step_on_card_over_gloo(cuda, tmp_path):
    """Two processes share cuda:0 over gloo at tp 2: the logits of one
    decoder_step (K2, K3 / K4 on 2 of 4 heads a rank) equal the one-process
    step within 1e-4 on both ranks, and the ranks agree bit for bit."""
    import torch_workers as tw
    port = tw.free_port()
    outs = [str(tmp_path / f"r{r}.npy") for r in range(2)]
    cmds = [[sys.executable, os.path.abspath(__file__), "tp2-step", str(r),
             str(port), outs[r]] for r in range(2)]
    tw.run_procs(cmds, str(tmp_path), timeout=300)
    _, want = _nano_step(None)
    got = [np.load(o) for o in outs]
    np.testing.assert_array_equal(got[0], got[1])
    assert float(np.abs(got[0] - want).max()) <= 1e-4 * float(
        np.abs(want).max())


if __name__ == "__main__" and sys.argv[1:2] == ["tp2-step"]:
    _tp2_step_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])


# ------------------------------------- the token loop as one CUDA graph --
@pytest.mark.parametrize("kv_group", [1, 5])
@pytest.mark.parametrize("hi", [1, 64, 65, 256])
def test_decode_attention_hi_on_the_device_equals_host_int(cuda, hi,
                                                           kv_group):
    """K3 / K4 with ``hi`` a (1,) int32 tensor read on the device equal the
    launch with hi as an int, bit for bit, at turbo width (20 heads of 64,
    bf16) from one live slot to the whole capacity."""
    gen = torch.Generator().manual_seed(hi)
    b, s, c = 40, 1280, 256
    q = torch.randn(b, s, generator=gen).to(cuda, torch.bfloat16)
    k = torch.randn(4, b // kv_group, c, s, generator=gen).to(cuda,
                                                             torch.bfloat16)
    v = torch.randn(4, b // kv_group, c, s, generator=gen).to(cuda,
                                                             torch.bfloat16)
    lo = torch.zeros(b, dtype=torch.int32, device=cuda)
    kw = dict(split=0, n_head=20, kv_group=kv_group, layer=2)
    want = D.decode_attention(q, k, v, lo, hi, **kw)
    got = D.decode_attention(
        q, k, v, lo, torch.tensor([hi], dtype=torch.int32, device=cuda), **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    plain = D.decode_attention_plain(q, k, v, lo, hi, **kw)
    assert float((got - plain).abs().max()) < 1e-4


def _serving_decoder(cfg, params, seed):
    """The benchmark's serving weights: end-of-text's embedding row scaled
    by 1e-3 (it never wins, so every window runs to ``max_tokens``) and
    the decoder's positional embedding N(0, 1) (every step decides anew)."""
    dec = params["decoder"]
    dec["token_embed"][cfg.token_eot] *= 1e-3
    dec["pos_embed"].copy_(torch.randn(
        dec["pos_embed"].shape, generator=torch.Generator().manual_seed(
            seed)).to(dec["pos_embed"].device))


@pytest.fixture(scope="module")
def turbo():
    """large-v3-turbo's decoder at its published widths (one encoder layer:
    the loop reads a cross-KV made from random encoder output), seeded
    bf16 serving weights; contexts in bf16 and with an int8 decoder."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = get_config("large-v3-turbo").replace(n_audio_layer=1)
    params = gt.init_params(cfg, seed=5, compute_dtype=torch.bfloat16,
                            device="cuda")
    _serving_decoder(cfg, params, 5)
    return cfg, {q: gt.WhisperContext.from_params(cfg, params,
                                                  device="cuda", quantize=q)
                 for q in (None, "int8")}


@pytest.mark.parametrize("route", ["greedy", "sampling", "int8_decoder",
                                   "int8_cross"])
def test_token_loop_graph_replays_the_eager_loop(cuda, turbo, route,
                                                 monkeypatch):
    """``run_decode_loop`` at B 32 replaying one captured step, and the
    same loop with a ``StepGraph`` that does not replay, each equal an
    eager loop written here apart from ``StepGraph`` (a fresh cache, the
    inputs uploaded each step, the cache slot a host int), every
    WindowResult field but ``graph_steps`` bit for bit, over 61 steps, in
    two windows (the first captures, the second only replays): greedy,
    t = 0.4 sampling at kv_group 4 (K4), an int8 decoder (K9), int8
    cross-KV (K12).  The kernel wrappers' counters read the eager loop's
    launches in every window."""
    from types import SimpleNamespace
    from godot_whisper_tpu_torch.decode import window as W
    from godot_whisper_tpu_torch.ops.cross_attention import xattn_q_packed
    from godot_whisper_tpu_torch.ops.qmatmul import quant_matmul
    cfg, ctxs = turbo
    pipe = ctxs["int8" if route == "int8_decoder" else None].pipeline
    params = pipe.params
    fctx = build_filter_context(cfg, pipe.tokenizer, device=cuda)
    B, kv_group = 32, 4 if route == "sampling" else 1
    G = B // kv_group
    temp = 0.4 if route == "sampling" else 0.0
    gen = torch.Generator().manual_seed(21)
    graphs = W.StepGraphs()
    xkv = graphs.cross_kv(params, cfg, torch.randn(
        G, 1500, cfg.n_audio_state, generator=gen).to(cuda, torch.bfloat16),
        route == "int8_cross")
    wrappers = (D.decode_attention, quant_matmul, xattn_q_packed)

    def launches():
        torch.cuda.synchronize()
        return ([w.launches for w in wrappers],
                dict(D.decode_attention.rows_launches),
                dict(quant_matmul.route_launches))

    def since(a, b):
        return ([y - x for x, y in zip(a[0], b[0])],
                *({k: v - x.get(k, 0) for k, v in y.items()}
                  for x, y in zip(a[1:], b[1:])))
    rng = np.random.default_rng(3)
    n_prompt = rng.integers(1, 9, G).astype(np.int32)
    prompt = np.where(np.arange(8)[None] < n_prompt[:, None],
                      rng.integers(0, cfg.token_eot, (G, 8)), 0)
    prompt = torch.from_numpy(prompt.astype(np.int32)).to(cuda)
    st = W.WindowStatics(
        config=cfg, batch=B, n_max=cfg.n_text_ctx // 2 - 4, prompt_pad=8,
        greedy_argmax=temp == 0.0, suppress_blank=True, no_timestamps=True,
        single_segment=False, max_tokens=60, test_mode=False,
        kv_group=kv_group)

    class EagerStep:
        """The token loop's step without ``StepGraph``: its own new cache,
        ``lo`` and the sampler's state uploaded by themselves, tokens and
        positions uploaded each step, the cache slot a host int."""

        def __init__(self):
            self.kv = tm.init_kv_cache(
                cfg, B, st.prompt_pad + st.n_max,
                dtype=tm.param_compute_dtype(params), device=cuda)

        def load(self, n):
            self.lo = torch.as_tensor(n.copy(), device=cuda)

        def set_state(self, state):
            return torch.from_numpy(state).to(cuda)

        def upload(self):
            pass

        def step(self, params, config, tokens, positions, slot):
            assert type(slot) is int
            return tm.decoder_step(
                params, config, torch.from_numpy(tokens.copy()).to(cuda),
                torch.from_numpy(positions.astype(np.int32)).to(cuda),
                self.kv, xkv, lo=self.lo, slot=slot, split=st.prompt_pad,
                kv_group=kv_group)[0]

        def graph_steps(self):
            return 0

    def run(steps):
        n0 = launches()
        res = W.run_decode_loop(params, cfg, fctx, st, steps, xkv, prompt,
                                n_prompt, temp, 0, 3000, 7)
        return res, since(n0, launches())

    def same(got, want):
        for f in W.WindowResult._fields:
            if f != "graph_steps":
                np.testing.assert_array_equal(getattr(got, f),
                                              getattr(want, f), err_msg=f)

    want, eager = run(SimpleNamespace(get=lambda *a: EagerStep()))
    assert want.n_steps == 61 and want.graph_steps == 0
    assert min(eager[0][:2 if route == "int8_decoder" else 1]) > 0
    with monkeypatch.context() as m:     # a step that does not replay
        m.setattr(W.GraphedStep, "replays_on",
                  staticmethod(lambda device, tp: False))
        plain = W.StepGraphs()
        got, counted = run(plain)
    assert plain.get(params, st, xkv).graph is None
    assert got.graph_steps == 0 and counted == eager
    same(got, want)
    del plain
    for window in range(2):
        graph = graphs.get(params, st, xkv)
        assert (graph.graph is None) == (window == 0)
        got, counted = run(graphs)
        if window:
            assert counted == eager
        else:    # and the capture's eager step
            assert counted[0] == [n + graph._launches.wrappers[w]
                                  for n, w in zip(eager[0], wrappers)]
        assert graph.replays == got.n_steps - 1
        assert got.graph_steps == got.n_steps == want.n_steps
        same(got, want)


def test_two_contexts_get_their_own_graphs(cuda):
    """Two tiny.en contexts with different weights in one process: each
    captures its own step (no StepGraph shared), they decode different
    tokens, and the first decodes as before after the second ran."""
    from godot_whisper_tpu_torch.runtime.trace import tracer
    ctxs = [gt.WhisperContext.synthetic("tiny.en", seed=s, device="cuda")
            for s in (0, 1)]
    for s, c in enumerate(ctxs):
        _serving_decoder(c.config, c.pipeline.params, s)
    p = gt.TranscribeParams(no_timestamps=True, temperature_inc=0.0,
                            best_of=1, entropy_thold=0.0,
                            logprob_thold=-1e6, max_tokens=20)
    audio = _tone(6.0)

    def ids(ctx):
        return [t.id for s in ctx.full(p, audio) for t in s.tokens]
    was = tracer.enabled
    tracer.enable()
    tracer.clear()
    try:
        first = [ids(c) for c in ctxs]
        again = ids(ctxs[0])
        loops = [r for r in tracer.records() if r.name == "gwt.token_loop"]
    finally:
        tracer.enabled = was
        tracer.clear()
    assert first[0] and first[1] and first[0] != first[1]
    assert again == first[0]
    assert loops and all(r.counts["graph_steps"] == r.counts["steps"]
                         for r in loops)
    held = [c.pipeline._step_graphs._steps.step for c in ctxs]
    assert all(g is not None and g.graph is not None for g in held)
    assert held[0] is not held[1] and held[0].xkv[0] is not held[1].xkv[0]
