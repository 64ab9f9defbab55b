"""The port's CUDA kernels on the card: each against its plain PyTorch
version at the main-path and large-v3 shapes, and the nano golden
transcripts through the kernels.  Every test here needs an NVIDIA GPU
(``cuda`` marker) and skips without one.  Imports no JAX, so that it runs
where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import json
import os

import numpy as np
import pytest
import torch

import godot_whisper_tpu_torch as gt
from chip_smoke import blocked_bf16_limit
from godot_whisper_tpu_torch.audio.mel import (frame_counts, mel_filterbank,
                                               pad_audio)
from godot_whisper_tpu_torch.decode.filters import build_filter_context
from godot_whisper_tpu_torch.decode.window import WindowDecoder
from godot_whisper_tpu_torch.models.config import get_config
from godot_whisper_tpu_torch.models.model import cross_kv, encoder_forward
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


@pytest.mark.parametrize("n_mels", [80, 128])
def test_mel_kernel_matches_plain(cuda, n_mels):
    """Within 1e-4 (log10) of the plain f32 version over the frames of real
    audio; the plain version with TF32-rounded GEMM inputs is not."""
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal(7 * 16000) * 0.1).astype(np.float32)
    n_real = frame_counts(len(audio))[1]
    padded = pad_audio(audio)
    padded = np.pad(padded, (0, -(-len(padded) // 480000) * 480000
                             - len(padded)))
    a16 = torch.from_numpy(padded.astype(np.float16)).to(cuda)[None]
    basis = torch.from_numpy(M.dft_basis()).to(cuda)
    filt = torch.from_numpy(mel_filterbank(n_mels)).to(cuda)
    before = M.log_mel_raw.launches
    got = M.log_mel_raw(a16, basis, filt)
    torch.cuda.synchronize()
    assert M.log_mel_raw.launches == before + 1
    want = M.log_mel_raw_plain(a16, basis, filt)
    assert float((got - want)[..., :n_real].abs().max()) < 1e-4

    def tf32(x):
        i = x.contiguous().view(torch.int32)
        return ((i + 0x1000) & ~0x1FFF).view(torch.float32)
    spec = tf32(a16.float().unfold(-1, 400, 160)) @ tf32(basis)
    power = spec[..., :201] ** 2 + spec[..., 201:] ** 2
    coarse = torch.log10(torch.clamp(tf32(power) @ tf32(filt).T,
                                     min=1e-10)).transpose(1, 2)
    assert float((coarse - want)[..., :n_real].abs().max()) > 1e-4


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
], ids=["step0", "current-token-only", "dead-gap", "kv_group8",
        "C1000"])
def test_decode_attention_split_edges(cuda, case):
    """The split-cache K3/K4 at its edge cases against its plain version
    (bf16 inputs, within 1e-4), bitwise equal from call to call (the merge
    runs in split order)."""
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
