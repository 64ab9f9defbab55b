"""The port's four kernels, each held against its JAX counterpart through
its plain PyTorch version on the CPU: the JAX side runs as its own suite
runs it (the CPU fallback, or the Pallas kernel in interpret mode).  The
CUDA kernels themselves are held against the plain versions on the card
by tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import blocked_bf16_limit
from godot_whisper_tpu.decode.filters import FilterContext
from godot_whisper_tpu.decode.filters import process_logits as jax_process
from godot_whisper_tpu.decode.filters import \
    timestamp_stats as jax_timestamp_stats
from godot_whisper_tpu.models.config import get_config as jax_get_config
from godot_whisper_tpu.ops import attention as jax_attention
from godot_whisper_tpu.ops import decode_attention as jax_decode
from godot_whisper_tpu.ops.filter_sample import \
    fused_filter_sample as jax_fused
from godot_whisper_tpu_torch.decode import filters as port_filters
from godot_whisper_tpu_torch.ops import attention as A
from godot_whisper_tpu_torch.ops import decode_attention as D
from godot_whisper_tpu_torch.ops import filter_sample as FS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch single-threaded here: these tests share the CPU with other
    test workers, and oversubscribed intra-op threads slow the many small
    ops of a decode loop by two orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def interpret_mode(monkeypatch):
    monkeypatch.setenv("GWT_PALLAS_INTERPRET", "1")
    yield
    jax_attention._flash_bthd.clear_cache()


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ------------------------------------------------------------------ K2 ----
@pytest.mark.parametrize("t,t_valid", [(1536, 1500), (1500, None), (40, 33)])
def test_attention_plain_matches_jax(t, t_valid):
    """Plain version vs the JAX entry on the CPU (its einsum path), f32,
    atol 2e-4 as tests/test_ops.py."""
    rng = np.random.default_rng(0)
    q, k, v = (_rand(rng, 3, t, 64) for _ in range(3))
    got = A.flash_attention_bh(*(torch.from_numpy(x) for x in (q, k, v)),
                               t_valid=t_valid)
    want = jax_attention.flash_attention_bh(
        *(jnp.asarray(x) for x in (q, k, v)), t_valid=t_valid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=0)


def test_attention_plain_matches_tpu_kernel(interpret_mode):
    """Against the TPU kernel _flash_sp_kernel itself (interpret mode) at a
    block-aligned T with masked keys."""
    rng = np.random.default_rng(1)
    q, k, v = (_rand(rng, 2, 512, 64) for _ in range(3))
    got = A.flash_attention_bh(*(torch.from_numpy(x) for x in (q, k, v)),
                               t_valid=500)
    want = jax_attention.flash_attention_bh(
        *(jnp.asarray(x) for x in (q, k, v)), t_valid=500)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=0)


@pytest.mark.parametrize("d", [64, 32])
def test_attention_sp_plain_matches_tpu_kernel_bf16(interpret_mode, d):
    """K2's function in bf16: ``attention_bh_sp_plain`` against the TPU
    kernel ``_flash_sp_kernel`` itself (interpret mode) at (2, 512, D),
    t_valid 500, within ``blocked_bf16_limit`` (one bf16 ulp per element,
    one flipped bf16 rounding of a probability per row, 1e-5).  The
    control: the function K2's card kernel computed before the tensor-core
    redesign (f32 to the end, the output rounded once) breaks that limit
    (shares 2.01 at D 64, 1.95 at D 32, against 0.71 and 0.48)."""
    rng = np.random.default_rng(5)
    q, k, v = (_rand(rng, 2, 512, d) for _ in range(3))
    qt, kt, vt = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    want = torch.from_numpy(np.array(jax_attention.flash_attention_bh(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
        t_valid=500).astype(jnp.float32)))
    got = A.attention_bh_sp_plain(qt, kt, vt, 500)
    assert got.dtype == torch.bfloat16
    lim = blocked_bf16_limit(torch, qt, kt, vt, want, 500)
    share = float(((got.float() - want).abs() / lim).max())
    assert share <= 1.0, share
    old = A.attention_bh_plain(qt.float(), kt.float(), vt.float(),
                               500).to(torch.bfloat16)
    ctl = float(((old.float() - want).abs() / lim).max())
    assert ctl > 1.0, ctl


# --------------------------------------------------------------- K3/K4 ----
def _dec_inputs(rng, L, b, kv_group, c, s):
    q = _rand(rng, b, s)
    k = _rand(rng, L, b // kv_group, c, s)
    v = _rand(rng, L, b // kv_group, c, s)
    return q, k, v


@pytest.mark.parametrize("kind,b,kv_group,lo,split,hi,layer", [
    ("self, split gap", 3, 1, [1, 4, 9], 232, 240, 1),
    ("cross", 2, 1, [1500, 1500], 1536, 0, 2),
    ("cross, kv_group 5", 5, 5, [1500] * 5, 1536, 0, 0),
])
def test_decode_attention_plain_matches_jax(kind, b, kv_group, lo, split, hi,
                                            layer):
    """Plain version vs the JAX entry on the CPU (its ``_fallback``), with
    the layer chosen out of the stacked cache; f32 to 1e-5."""
    rng = np.random.default_rng(2)
    c = 1536 if split == 1536 else 256
    q, k, v = _dec_inputs(rng, 3, b, kv_group, c, 384)
    kw = dict(split=split, n_head=6, kv_group=kv_group, layer=layer)
    got = D.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v),
                             torch.tensor(lo, dtype=torch.int32), hi, **kw)
    want = jax_decode.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(lo, jnp.int32), jnp.int32(hi), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("kv_group", [1, 5])
def test_decode_attention_plain_matches_tpu_kernels(kv_group):
    """Against the TPU kernels themselves in interpret mode: kv_group 1
    runs _decode_attn_kernel, kv_group 5 _decode_attn_group_packed_kernel.
    They contract in bf16, so the tolerance is bf16-level as in
    tests/test_decode_attention.py."""
    rng = np.random.default_rng(3)
    b = 5
    q, k, v = _dec_inputs(rng, 2, b, kv_group, 512, 384)
    lo = [300] * b if kv_group > 1 else [3, 5, 7, 9, 11]
    split, hi = (512, 0) if kv_group > 1 else (256, 270)
    kw = dict(split=split, n_head=6, kv_group=kv_group, layer=1)
    got = D.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v),
                             torch.tensor(lo, dtype=torch.int32), hi, **kw)
    want = jax_decode.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(lo, jnp.int32), jnp.int32(hi), interpret=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-2,
                               rtol=2e-2)


# The split-cache algebra of the K3/K4 card kernel (csrc/decode_split.cuh):
# ``decode_attention_split_plain`` takes its slices (``split_plan``), skips
# the slices it never loads and merges the partials in split order.
# id: (B, kv_group, C, lo, split, hi, n_sms)
SPLIT_CASES = {
    # cross-attention with short prompts: slices [64, 512) hold no valid slot
    "wholly masked slices": (2, 2, 512, [40, 60], 512, 0, 132),
    # row 0's only valid slot is the current token (lo 0, hi = split + 1)
    "only the current token": (3, 1, 512, [0, 2, 7], 232, 233, 132),
    "step 0": (3, 1, 512, [5, 5, 5], 232, 233, 132),
    # 2 slices of 512 over 768 slots (over 1000 in the f32 case)
    "n_split not dividing C": (5, 5, 768, [700] * 5, 768, 0, 8),
    # the gap [9, 232) between the prompts and the prompt capacity
    "dead gap lo 1/4/9": (3, 1, 512, [1, 4, 9], 232, 333, 132),
    "kv_group 8": (8, 8, 1536, [1500] * 8, 1536, 0, 132),
}


def _split_case(rng, case, c=None):
    b, kv_group, c0, lo, split, hi, n_sms = SPLIT_CASES[case]
    c = c0 if c is None else c
    q, k, v = _dec_inputs(rng, 2, b, kv_group, c, 384)
    kw = dict(split=min(split, c), n_head=6, kv_group=kv_group, layer=1)
    return q, k, v, lo, hi, kw, n_sms


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_decode_attention_split_plain_matches_jax(case):
    """The split algebra against the JAX entry's ``_fallback`` on the CPU,
    f32 to 1e-5: every case of the card kernel's slicing and merge."""
    rng = np.random.default_rng(4)
    c = 1000 if case == "n_split not dividing C" else None
    q, k, v, lo, hi, kw, n_sms = _split_case(rng, case, c)
    g, c = k.shape[1], k.shape[2]
    sl, (n_split,) = D.split_plan(((c, 1),), g * 6, n_sms)
    if case == "n_split not dividing C":
        assert n_split * sl != c
    got = D.decode_attention_split_plain(
        *(torch.from_numpy(x) for x in (q, k, v)),
        torch.tensor(lo, dtype=torch.int32), hi, n_sms=n_sms, **kw)
    want = jax_decode.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(lo, jnp.int32), jnp.int32(hi), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_decode_attention_split_plain_matches_tpu_kernels(case):
    """The split algebra against the TPU kernels in interpret mode, on
    bf16-valued inputs: they contract in bf16 and round p to bf16 before
    p . V, so the tolerance is the bf16-level 2e-2 of
    ``test_decode_attention_plain_matches_tpu_kernels``."""
    rng = np.random.default_rng(5)
    q, k, v, lo, hi, kw, n_sms = _split_case(rng, case)
    bf = [np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
          for x in (q, k, v)]
    got = D.decode_attention_split_plain(
        *(torch.from_numpy(x) for x in bf),
        torch.tensor(lo, dtype=torch.int32), hi, n_sms=n_sms, **kw)
    want = jax_decode.decode_attention(
        *(jnp.asarray(x, jnp.bfloat16) for x in bf),
        jnp.asarray(lo, jnp.int32), jnp.int32(hi), interpret=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-2,
                               rtol=2e-2)


def test_split_plan_and_dead_slices():
    """The slices the card kernels run: their length comes from the cache
    capacity and the SM count (never from the step), and a slice that holds
    no slot any row may attend is skipped: at split 232 with prompts of
    1, 4 and 9 slots and hi 333, the gap [9, 232) and the slots past hi."""
    assert D.split_plan(((1536, 1),), 6) == (64, (24,))      # tiny.en cross
    assert D.split_plan(((1536, 1),), 20) == (128, (12,))    # large-v3
    assert D.split_plan(((512, 1),), 30) == (64, (8,))       # tiny.en self
    assert D.split_plan(((256, 1), (256, 5)), 6) == (64, (4, 4))  # K7
    sl, (n,) = D.split_plan(((512, 1),), 3 * 6)
    live = [i for i in range(n)
            if D.slice_live(i * sl, (i + 1) * sl, 9, 232, 333)]
    assert (sl, live) == (64, [0, 3, 4, 5])
    assert D.slice_live(0, 64, 0, 232, 233) is False
    assert D.slice_live(192, 256, 0, 232, 233) is True


# ------------------------------------------------------------------ K5 ----
def _filter_case(seed):
    cfg = jax_get_config("tiny.en")
    V, beg = cfg.n_vocab, cfg.token_beg
    rng = np.random.default_rng(seed)
    logits = _rand(rng, 4, V, scale=3.0)
    sup = np.zeros(V, bool)
    for t in (cfg.token_not, cfg.token_sot, cfg.token_nosp, cfg.token_solm,
              cfg.token_translate, cfg.token_transcribe, cfg.token_prev):
        sup[t] = True
    state = dict(
        is_initial=np.asarray([True, False, False, False]),
        last_token=np.asarray([-1, beg + 5, 123, 321], np.int32),
        penult_token=np.asarray([-1, 77, beg + 3, 322], np.int32),
        n_tokens=np.asarray([0, 5, 7, 9], np.int32),
        has_ts=np.asarray([False, True, True, False]),
        seek_delta=np.asarray([3000, 10, 6, 3000], np.int32))
    return cfg, logits, sup, state


def _port_state(state, argmax: bool):
    """The kernel's (B, 7) int32 state from the JAX-style keyword state."""
    cols = [np.asarray(state[k]).astype(np.int32)
            for k in ("is_initial", "last_token", "penult_token", "n_tokens",
                      "has_ts", "seek_delta")]
    cols.append(np.full(len(cols[0]), int(argmax), np.int32))
    return torch.from_numpy(np.stack(cols, axis=1))


@pytest.mark.parametrize("seed,temp", [(0, 0.0), (5, 0.0), (9, 0.6)])
def test_filter_sample_argmax_matches_jax(seed, temp):
    """Plain version in argmax mode vs the JAX stack ``process_logits`` +
    argmax + ``timestamp_stats``: exact tokens and timestamp ids, f32
    values to the JAX suite's tolerances (tests/test_filter_sample.py)."""
    cfg, logits, sup, state = _filter_case(seed)
    fctx = FilterContext(static_suppress=jnp.asarray(sup),
                         token_eot=cfg.token_eot, token_beg=cfg.token_beg,
                         space_id=220, max_initial_tid=50,
                         n_vocab=cfg.n_vocab)
    _, lp, probs = jax_process(
        jnp.asarray(logits), fctx=fctx, temperature=jnp.float32(temp),
        suppress_blank=True, no_timestamps=False,
        **{k: jnp.asarray(v) for k, v in state.items()})
    ids = np.argmax(np.asarray(probs), axis=-1)
    pt, ptsum, tid = (np.asarray(x) for x in jax_timestamp_stats(
        probs, cfg.token_beg))
    rows = np.arange(len(ids))
    is_ts = ids >= cfg.token_beg
    tid = np.where(is_ts, ids, tid)
    pt = np.where(is_ts, np.asarray(probs)[rows, ids], pt)

    out = FS.fused_filter_sample(
        torch.from_numpy(logits), torch.from_numpy(sup),
        _port_state(state, argmax=True), temperature=temp, seed=0,
        eot=cfg.token_eot, beg=cfg.token_beg, space_id=220,
        max_initial_tid=50, suppress_blank=True, no_timestamps=False)
    np.testing.assert_array_equal(out.token.numpy(), ids)
    np.testing.assert_array_equal(out.tid.numpy(), tid)
    np.testing.assert_allclose(out.p.numpy(), np.asarray(probs)[rows, ids],
                               atol=1e-5)
    np.testing.assert_allclose(out.plog.numpy(), np.asarray(lp)[rows, ids],
                               atol=1e-4)
    np.testing.assert_allclose(out.ptsum.numpy(), ptsum, atol=1e-5)
    np.testing.assert_allclose(out.pt.numpy(), pt, atol=1e-5)


def test_filter_sample_matches_tpu_kernel(monkeypatch):
    """Against the TPU kernel ``_kernel`` itself (interpret mode), argmax:
    every output."""
    monkeypatch.setenv("GWT_PALLAS_INTERPRET", "1")
    cfg, logits, sup, state = _filter_case(3)
    want = jax_fused(
        jnp.asarray(logits), jnp.asarray(sup), temperature=jnp.float32(0.0),
        seeds=jnp.zeros(4, jnp.int32), eot=cfg.token_eot, beg=cfg.token_beg,
        space_id=220, max_initial_tid=50, suppress_blank=True,
        no_timestamps=False, argmax_sample=True,
        **{k: jnp.asarray(v) for k, v in state.items()})
    got = FS.fused_filter_sample(
        torch.from_numpy(logits), torch.from_numpy(sup),
        _port_state(state, argmax=True), temperature=0.0, seed=0,
        eot=cfg.token_eot, beg=cfg.token_beg, space_id=220,
        max_initial_tid=50, suppress_blank=True, no_timestamps=False)
    for name in ("token", "tid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    for name in ("p", "plog", "pt", "ptsum"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=1e-5, rtol=1e-5)


def test_filter_sample_gumbel_frequencies():
    """At t > 0 the counter-hash Gumbel-max draws follow the softmax of the
    filtered log-probs (the JAX package's ``process_logits``): 1200 draws,
    each frequency within 5 standard errors."""
    cfg = jax_get_config("tiny.en")
    V, beg = cfg.n_vocab, cfg.token_beg
    B = 120
    row = np.full(V, -10.0, np.float32)
    row[[11, 22, 33, 44]] = [2.0, 1.5, 1.0, 0.5]
    logits = np.tile(row, (B, 1))
    sup = np.zeros(V, bool)
    state = dict(is_initial=np.zeros(B, bool),
                 last_token=np.full(B, 5, np.int32),
                 penult_token=np.full(B, 6, np.int32),
                 n_tokens=np.full(B, 3, np.int32),
                 has_ts=np.zeros(B, bool),
                 seek_delta=np.full(B, 3000, np.int32))
    fctx = FilterContext(static_suppress=jnp.asarray(sup),
                         token_eot=cfg.token_eot, token_beg=beg,
                         space_id=220, max_initial_tid=50, n_vocab=V)
    _, _, probs = jax_process(
        jnp.asarray(logits[:1]), fctx=fctx, temperature=jnp.float32(1.0),
        suppress_blank=True, no_timestamps=False,
        **{k: jnp.asarray(v[:1]) for k, v in state.items()})
    p_ref = np.asarray(probs)[0]
    counts = np.zeros(V)
    st = _port_state(state, argmax=False)
    for seed in range(10):
        out = FS.fused_filter_sample(
            torch.from_numpy(logits), torch.from_numpy(sup), st,
            temperature=1.0, seed=seed, eot=cfg.token_eot, beg=beg,
            space_id=220, max_initial_tid=50, suppress_blank=True,
            no_timestamps=False)
        np.add.at(counts, out.token.numpy(), 1)
    n = counts.sum()
    for t in (11, 22, 33, 44):
        se = np.sqrt(p_ref[t] * (1 - p_ref[t]) / n)
        assert abs(counts[t] / n - p_ref[t]) < 5 * se, (t, counts[t], n)


def test_filters_process_logits_matches_jax():
    """The port's unfused reference stack equals the JAX package's."""
    cfg, logits, sup, state = _filter_case(11)
    from godot_whisper_tpu.decode.filters import build_filter_context as jb
    from godot_whisper_tpu.audio.tokenizer import Tokenizer as JT
    from godot_whisper_tpu.audio.tokenizer import synthetic_vocab as jsv
    from godot_whisper_tpu_torch.audio.tokenizer import (Tokenizer,
                                                          synthetic_vocab)
    from godot_whisper_tpu_torch.models.config import get_config
    pcfg = get_config("tiny.en")
    jf = jb(cfg, JT(cfg, jsv(cfg)), suppress_non_speech=True)
    pf = port_filters.build_filter_context(
        pcfg, Tokenizer(pcfg, synthetic_vocab(pcfg)),
        suppress_non_speech=True, device="cpu")
    np.testing.assert_array_equal(pf.static_suppress.numpy(),
                                  np.asarray(jf.static_suppress))
    assert pf[1:] == tuple(jf[1:])
    _, lp_j, pr_j = jax_process(
        jnp.asarray(logits), fctx=jf, temperature=jnp.float32(0.5),
        **{k: jnp.asarray(v) for k, v in state.items()})
    _, lp_t, pr_t = port_filters.process_logits(
        torch.from_numpy(logits), fctx=pf, temperature=0.5,
        **{k: torch.from_numpy(np.asarray(v)) for k, v in state.items()})
    np.testing.assert_array_equal(np.isfinite(lp_t.numpy()),
                                  np.isfinite(np.asarray(lp_j)))
    fin = np.isfinite(np.asarray(lp_j))
    np.testing.assert_allclose(lp_t.numpy()[fin], np.asarray(lp_j)[fin],
                               atol=1e-4)
    np.testing.assert_allclose(pr_t.numpy(), np.asarray(pr_j), atol=1e-6)
    pt, ptsum, tid = port_filters.timestamp_stats(pr_t, cfg.token_beg)
    pt_j, ptsum_j, tid_j = jax_timestamp_stats(pr_j, cfg.token_beg)
    np.testing.assert_array_equal(tid.numpy(), np.asarray(tid_j))
    np.testing.assert_allclose(ptsum.numpy(), np.asarray(ptsum_j), atol=1e-6)


def test_wrappers_reject_cpu_fallback_for_other_devices():
    """A wrapper takes its plain version only for CPU tensors; a tensor on
    another device goes to the kernel path, which checks it and raises
    (the meta device stands in for a device without the kernel)."""
    q = torch.empty(2, 16, 64, device="meta")
    with pytest.raises(ValueError):
        A.flash_attention_bh(q, q, q)
