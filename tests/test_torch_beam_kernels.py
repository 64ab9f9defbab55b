"""Beam search's kernels and merge, each held against its JAX counterpart
through the port's plain version on the CPU: K6 filter + top-K, K7 split
prompt / live attention, K8 bounded cache reorder, and the beam merge.  The
JAX side runs as its own suite runs it: the Pallas kernel in interpret
mode, or its CPU branch.  The CUDA kernels are held against the plain
versions on the card by tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from godot_whisper_tpu.decode import window as jax_window
from godot_whisper_tpu.decode.filters import FilterContext
from godot_whisper_tpu.models.config import get_config as jax_get_config
from godot_whisper_tpu.ops.filter_sample import \
    fused_filter_topk as jax_topk
from godot_whisper_tpu.ops.kv_reorder import \
    reorder_kv_live as jax_reorder
from godot_whisper_tpu.ops.split_attention import \
    split_beam_attention as jax_split
from godot_whisper_tpu_torch.decode import window as port_window
from godot_whisper_tpu_torch.ops import filter_sample as FS
from godot_whisper_tpu_torch.ops import kv_reorder as R
from godot_whisper_tpu_torch.ops import split_attention as SA


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Single-threaded torch: these tests share the CPU with other
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ------------------------------------------------------------------ K6 ----
def _topk_case(seed, B=10):
    cfg = jax_get_config("tiny.en")
    V = cfg.n_vocab
    rng = np.random.default_rng(seed)
    logits = _rand(rng, B, V, scale=3.0)
    sup = np.zeros(V, bool)
    for t in (cfg.token_not, cfg.token_sot, cfg.token_nosp, cfg.token_solm,
              cfg.token_translate, cfg.token_transcribe, cfg.token_prev):
        sup[t] = True
    state = dict(
        is_initial=rng.integers(0, 2, B) == 1,
        last_token=rng.integers(-1, V, B).astype(np.int32),
        penult_token=rng.integers(-1, V, B).astype(np.int32),
        n_tokens=rng.integers(0, 9, B).astype(np.int32),
        has_ts=rng.integers(0, 2, B) == 1,
        seek_delta=rng.integers(2, 3000, B).astype(np.int32))
    return cfg, logits, sup, state


def _port_state(state):
    cols = [np.asarray(state[k]).astype(np.int32)
            for k in ("is_initial", "last_token", "penult_token", "n_tokens",
                      "has_ts", "seek_delta")]
    cols.append(np.zeros(len(cols[0]), np.int32))
    return torch.from_numpy(np.stack(cols, axis=1))


def _topk_both(monkeypatch, cfg, logits, sup, state, K):
    monkeypatch.setenv("GWT_PALLAS_INTERPRET", "1")
    kw = dict(temperature=0.0, eot=cfg.token_eot, beg=cfg.token_beg,
              space_id=220, max_initial_tid=50, suppress_blank=True,
              no_timestamps=False)
    want = jax_topk(jnp.asarray(logits), jnp.asarray(sup), K=K,
                    **{k: jnp.asarray(v) for k, v in state.items()}, **kw)
    got = FS.fused_filter_topk(torch.from_numpy(logits),
                               torch.from_numpy(sup), _port_state(state),
                               K=K, **kw)
    return got, want


def test_filter_topk_matches_tpu_kernel(monkeypatch):
    """Against ``_topk_kernel`` (interpret mode) at tiny.en's V, B=10, K=5,
    random states: ids and tid exact, plog within 1e-4, p / pt / ptsum
    within 1e-5 (the JAX suite's tolerances)."""
    cfg, logits, sup, state = _topk_case(3)
    got, want = _topk_both(monkeypatch, cfg, logits, sup, state, K=5)
    for name in ("ids", "tid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    np.testing.assert_allclose(got.plog.numpy(), np.asarray(want.plog),
                               atol=1e-4, rtol=0)
    for name in ("p", "pt", "ptsum"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=1e-5, rtol=0)


def test_filter_topk_ties_take_the_lowest_index(monkeypatch):
    """Rows whose best logits tie exactly: the candidates come in
    ascending id order within each tie (the ``lax.top_k`` order), as in
    the TPU kernel, and bit-identical rows give bit-identical outputs (the
    step-0 dedupe relies on it)."""
    cfg, logits, sup, state = _topk_case(4, B=4)
    state = {k: v.copy() for k, v in state.items()}
    state["is_initial"][:] = False
    state["n_tokens"][:] = 3
    state["has_ts"][:] = False
    state["last_token"][:] = 100
    state["penult_token"][:] = 101
    logits[:, [7, 300, 9000, 12345]] = 20.0   # a 4-way tie at the top
    logits[:, [50, 40]] = 19.0                # then a 2-way tie
    logits[3] = logits[2]
    got, want = _topk_both(monkeypatch, cfg, logits, sup, state, K=6)
    ids = got.ids.numpy()
    np.testing.assert_array_equal(ids, np.asarray(want.ids))
    np.testing.assert_array_equal(ids[0], [7, 300, 9000, 12345, 40, 50])
    for name in ("plog", "p", "pt", "ptsum", "tid"):
        a = getattr(got, name).numpy()
        assert np.array_equal(a[2], a[3])


def test_filter_topk_fewer_live_than_k_matches_tpu_kernel(monkeypatch):
    """Three live ids at K 6 (the static mask takes every other id,
    no_timestamps): K argmax-and-mask passes run out of live ids and take
    id 0, the lowest id at -1e30, for the last three slots.  The plain
    version against ``_topk_kernel`` (interpret mode) at B 2: ids exact,
    -1e30 and p 0 past the third."""
    monkeypatch.setenv("GWT_PALLAS_INTERPRET", "1")
    cfg = jax_get_config("tiny.en")
    V = cfg.n_vocab
    rng = np.random.default_rng(8)
    logits = _rand(rng, 2, V, scale=3.0)
    logits[:, 40], logits[:, 7000], logits[:, 900] = 9.0, 8.0, 7.0
    sup = np.ones(V, bool)
    sup[[40, 900, 7000]] = False
    state = dict(is_initial=np.asarray([False, True]),
                 last_token=np.asarray([321, -1], np.int32),
                 penult_token=np.asarray([322, -1], np.int32),
                 n_tokens=np.asarray([9, 0], np.int32),
                 has_ts=np.asarray([False, False]),
                 seek_delta=np.asarray([3000, 3000], np.int32))
    kw = dict(temperature=0.0, eot=cfg.token_eot, beg=cfg.token_beg,
              space_id=220, max_initial_tid=50, suppress_blank=True,
              no_timestamps=True)
    want = jax_topk(jnp.asarray(logits), jnp.asarray(sup), K=6,
                    **{k: jnp.asarray(v) for k, v in state.items()}, **kw)
    got = FS.fused_filter_topk(torch.from_numpy(logits),
                               torch.from_numpy(sup), _port_state(state),
                               K=6, **kw)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    assert got.ids.tolist() == [[40, 7000, 900, 0, 0, 0]] * 2
    np.testing.assert_array_equal(got.tid.numpy(), np.asarray(want.tid))
    for name in ("plog", "p"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        np.testing.assert_array_equal(a[:, 3:], b[:, 3:])
    assert (got.plog.numpy()[:, 3:] == np.float32(-1e30)).all()
    assert (got.p.numpy()[:, 3:] == 0).all()
    for name in ("plog", "p", "pt", "ptsum"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=1e-5, rtol=0)


# ------------------------------------------------------------------ K7 ----
def _split_inputs(rng, l=2, g=2, kgrp=5, cp=256, nl=512, s=384):
    b = g * kgrp
    kp, vp = _rand(rng, l, g, cp, s), _rand(rng, l, g, cp, s)
    kl, vl = _rand(rng, l, b, nl, s), _rand(rng, l, b, nl, s)
    q = _rand(rng, b, s)
    # ragged prompt lengths, one per group, shared by its beams
    lo = np.repeat(rng.integers(5, cp - 20, g), kgrp).astype(np.int32)
    rowmap = rng.integers(0, kgrp, (b, nl)).astype(np.int32)
    return q, kp, vp, kl, vl, lo, rowmap


def _bf16(x):
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("hi_live", [1, 100, 256])
def test_split_attention_plain_matches_jax(hi_live):
    """Plain version vs the JAX entry's CPU branch (f32), a permuted row
    map, ragged lo, hi_live of one slot, mid-block and a block edge:
    atol 1e-5."""
    rng = np.random.default_rng(hi_live)
    q, kp, vp, kl, vl, lo, rowmap = _split_inputs(rng)
    kw = dict(n_head=6, kv_group=5)
    for li in range(2):
        got = SA.split_beam_attention(
            *(torch.from_numpy(x) for x in (q, kp, vp, kl, vl, lo)),
            hi_live, layer=li, rowmap=torch.from_numpy(rowmap), **kw)
        want = jax_split(*(jnp.asarray(x) for x in (q, kp, vp, kl, vl, lo)),
                         jnp.int32(hi_live), layer=jnp.int32(li),
                         rowmap=jnp.asarray(rowmap), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)


def _p_abs_v(q, kp, vp, kl, vl, lo, rowmap, hi_live, layer, n_head, kgrp):
    """Per output element, sum_c p_c |v_c| of the exact attention (f32):
    the scale of the error one bf16 rounding of every p_c can make."""
    b, s = q.shape
    g, cp = kp.shape[1], kp.shape[2]
    d = s // n_head
    rows = (np.arange(b) // kgrp * kgrp)[:, None] + rowmap[:, :hi_live]
    t = np.arange(hi_live)[None]
    kfull = np.concatenate([np.repeat(kp[layer], kgrp, axis=0),
                            kl[layer][rows, t]], axis=1)
    vfull = np.concatenate([np.repeat(vp[layer], kgrp, axis=0),
                            vl[layer][rows, t]], axis=1)
    sc = np.einsum("bhd,bchd->bhc", q.reshape(b, n_head, d),
                   kfull.reshape(b, -1, n_head, d)) / np.sqrt(d)
    ok = np.concatenate([np.arange(cp)[None] < lo[:, None],
                         np.ones((b, hi_live), bool)], axis=1)[:, None]
    sc = np.where(ok, sc, -np.inf)
    p = np.exp(sc - sc.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhc,bchd->bhd", p,
                     np.abs(vfull).reshape(b, -1, n_head, d)).reshape(b, s)


@pytest.mark.parametrize("hi_live", [1, 100, 256])
def test_split_attention_plain_matches_tpu_kernel(monkeypatch, hi_live):
    """Against ``_split_beam_kernel`` (interpret mode) on bf16-valued
    inputs.  The TPU kernel rounds each probability to bf16 before p @ V
    (relative error <= 2^-9), so per element it may differ from the exact
    f32 result by 2^-9 sum_c p_c |v_c|; allowed: 2^-8 sum_c p_c |v_c| +
    1e-5 (f32 sums in another order)."""
    monkeypatch.setenv("GWT_PALLAS_INTERPRET", "1")
    rng = np.random.default_rng(10 + hi_live)
    q, kp, vp, kl, vl, lo, rowmap = _split_inputs(rng, l=2, nl=512)
    q, kp, vp, kl, vl = (_bf16(x) for x in (q, kp, vp, kl, vl))
    layer = 1
    got = SA.split_beam_attention(
        *(torch.from_numpy(x) for x in (q, kp, vp, kl, vl, lo)), hi_live,
        n_head=6, kv_group=5, layer=layer, rowmap=torch.from_numpy(rowmap))
    want = jax_split(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, kp, vp, kl, vl)),
        jnp.asarray(lo), jnp.int32(hi_live), n_head=6, kv_group=5,
        layer=jnp.int32(layer), rowmap=jnp.asarray(rowmap), interpret=True)
    tol = 2.0 ** -8 * _p_abs_v(q, kp, vp, kl, vl, lo, rowmap, hi_live, layer,
                               6, 5) + 1e-5
    err = np.abs(got.numpy() - np.asarray(want))
    assert (err <= tol).all(), float((err / tol).max())


# K7's split-cache algebra (csrc/decode_split.cuh):
# ``split_beam_attention_split_plain`` takes the card kernel's slices
# (prompt slices over a group's beams, live slices per beam), skips the
# slices it never loads and merges each beam's partials in split order.
# id: (G, kv_group, CP, NL, hi_live, lo per group, n_sms)
SPLIT_BEAM_CASES = {
    # only the current token is live (hi_live 1)
    "live step 0": (1, 5, 256, 256, 1, [120], 132),
    # prompt slices past lo 30 and live slices past 70 hold no valid slot
    "wholly masked slices": (2, 5, 256, 512, 70, [10, 30], 132),
    # one prompt slice of 512 over 256 slots, two live over 768 (f32:
    # 4 of 64 over 200 prompt slots, 6 over 330 live)
    "n_split not dividing the caches": (1, 5, 256, 768, 600, [200], 48),
    "kv_group 8": (1, 8, 256, 256, 130, [100], 132),
}


def _split_beam_case(rng, case, odd=False):
    g, kgrp, cp, nl, hi_live, lo_g, n_sms = SPLIT_BEAM_CASES[case]
    if odd:
        cp, nl, n_sms = 200, 330, 132
    q, kp, vp, kl, vl, _, rowmap = _split_inputs(rng, l=2, g=g, kgrp=kgrp,
                                                 cp=cp, nl=nl)
    lo = np.repeat(np.asarray(lo_g, np.int32), kgrp)
    sl, (n_p, n_l) = SA.split_plan(((cp, 1), (nl, kgrp)), g * 6, n_sms)
    if case.startswith("n_split"):
        assert n_p * sl != cp and n_l * sl != nl
    return (q, kp, vp, kl, vl, lo, rowmap), hi_live, kgrp, n_sms


@pytest.mark.parametrize("case", list(SPLIT_BEAM_CASES))
def test_split_attention_split_plain_matches_jax(case):
    """The split algebra against the JAX entry's CPU branch (f32), a
    permuted row map, both layers: atol 1e-5."""
    rng = np.random.default_rng(21)
    x, hi_live, kgrp, n_sms = _split_beam_case(
        rng, case, odd=case.startswith("n_split"))
    q, kp, vp, kl, vl, lo, rowmap = x
    for li in range(2):
        got = SA.split_beam_attention_split_plain(
            *(torch.from_numpy(a) for a in (q, kp, vp, kl, vl, lo)),
            hi_live, n_head=6, kv_group=kgrp, layer=li,
            rowmap=torch.from_numpy(rowmap), n_sms=n_sms)
        want = jax_split(*(jnp.asarray(a) for a in x[:6]), jnp.int32(hi_live),
                         n_head=6, kv_group=kgrp, layer=jnp.int32(li),
                         rowmap=jnp.asarray(rowmap))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("case", list(SPLIT_BEAM_CASES))
def test_split_attention_split_plain_matches_tpu_kernel(monkeypatch, case):
    """The split algebra against ``_split_beam_kernel`` (interpret mode) on
    bf16-valued inputs, under the budget of
    ``test_split_attention_plain_matches_tpu_kernel``: 2^-8 sum_c p_c |v_c|
    + 1e-5 per element (one bf16 rounding of every p)."""
    monkeypatch.setenv("GWT_PALLAS_INTERPRET", "1")
    rng = np.random.default_rng(22)
    x, hi_live, kgrp, n_sms = _split_beam_case(rng, case)
    q, kp, vp, kl, vl = (_bf16(a) for a in x[:5])
    lo, rowmap = x[5], x[6]
    got = SA.split_beam_attention_split_plain(
        *(torch.from_numpy(a) for a in (q, kp, vp, kl, vl, lo)), hi_live,
        n_head=6, kv_group=kgrp, layer=1, rowmap=torch.from_numpy(rowmap),
        n_sms=n_sms)
    want = jax_split(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, kp, vp, kl, vl)),
        jnp.asarray(lo), jnp.int32(hi_live), n_head=6, kv_group=kgrp,
        layer=jnp.int32(1), rowmap=jnp.asarray(rowmap), interpret=True)
    tol = 2.0 ** -8 * _p_abs_v(q, kp, vp, kl, vl, lo, rowmap, hi_live, 1, 6,
                               kgrp) + 1e-5
    err = np.abs(got.numpy() - np.asarray(want))
    assert (err <= tol).all(), float((err / tol).max())


# ------------------------------------------------------------------ K8 ----
@pytest.mark.parametrize("src,hi", [
    ([3, 3, 0, 5, 5, 5], 80),       # duplicated sources
    ([0, 1, 2, 3, 4, 5], 256),      # identity (dead rows keep themselves)
    ([5, 4, 3, 2, 1, 0], 1),
])
def test_reorder_matches_tpu_kernel(monkeypatch, src, hi):
    """Against ``_copy_kernel`` (interpret mode), bf16 caches: exact on
    slots c < hi, written into the second cache of the pair."""
    monkeypatch.setenv("GWT_PALLAS_INTERPRET", "1")
    rng = np.random.default_rng(hi)
    l, b, c, s = 2, 6, 256, 128
    k, v = _rand(rng, l, b, c, s), _rand(rng, l, b, c, s)
    ko, vo = jax_reorder(jnp.asarray(k, jnp.bfloat16),
                         jnp.asarray(v, jnp.bfloat16),
                         jnp.asarray(src, jnp.int32), jnp.int32(hi),
                         interpret=True)
    kt, vt = (torch.from_numpy(x).to(torch.bfloat16) for x in (k, v))
    out = (torch.full_like(kt, float("nan")), torch.full_like(vt, float("nan")))
    got = R.reorder_kv_live(kt, vt, torch.tensor(src, dtype=torch.int32), hi,
                            out=out)
    assert got[0] is out[0] and got[1] is out[1]
    for a, want in zip(got, (ko, vo)):
        np.testing.assert_array_equal(
            a[:, :, :hi].float().numpy(),
            np.asarray(want[:, :, :hi].astype(jnp.float32)))


# --------------------------------------------------------------- merge ----
def _jax_merge(cand, sum_lp, completed, failed, rowmap, i, K, beg):
    B = len(sum_lp)
    cfg = jax_get_config("tiny.en")
    statics = jax_window.WindowStatics(
        config=cfg, batch=B, n_max=8, prompt_pad=8, strategy="beam",
        beam_size=K, greedy_argmax=False, suppress_blank=True,
        no_timestamps=False, single_segment=False, max_tokens=0,
        test_mode=False)
    fctx = FilterContext(static_suppress=None, token_eot=cfg.token_eot,
                         token_beg=beg, space_id=220, max_initial_tid=50,
                         n_vocab=cfg.n_vocab)
    z = jnp.zeros((B, 8))
    st = jax_window.LoopState(
        i=jnp.int32(i), kv=None, rowmap=jnp.asarray(rowmap),
        tokens=z.astype(jnp.int32), tok_p=z, tok_plog=z, tok_pt=z,
        tok_ptsum=z, tok_tid=z.astype(jnp.int32), probs=None, logprobs=None,
        completed=jnp.asarray(completed), failed=jnp.asarray(failed),
        has_ts=jnp.zeros(B, bool), seek_delta=jnp.zeros(B, jnp.int32),
        result_len=jnp.zeros(B, jnp.int32),
        sum_logprobs_all=jnp.asarray(sum_lp), rng=None)
    src, ids, p, plog, pt, ptsum, tid, new_sum, st, _ = jax_window._merge_beam(
        st, statics, fctx, *(jnp.asarray(x) for x in cand))
    return [np.asarray(x) for x in (src, ids, p, plog, pt, ptsum, tid,
                                    new_sum, st.rowmap)]


@pytest.mark.parametrize("case", ["step0", "ties", "dead_rows"])
def test_merge_beam_matches_jax(case):
    """The port's numpy merge vs the JAX ``_merge_beam`` with G = 2 groups
    of K = 5: src, ids, plog, scores, p / pt / ptsum / tid and the permuted
    row map are equal."""
    rng = np.random.default_rng({"step0": 0, "ties": 1, "dead_rows": 2}[case])
    G, K, beg, i, nl = 2, 5, 50363, 3, 16
    B = G * K
    ids = rng.integers(0, 51864, (B, K)).astype(np.int32)
    ids[:, 0] = beg + rng.integers(0, 40, B)   # some timestamp candidates
    plog = -np.sort(rng.choice(np.float32([0.5, 1.25, 2.0, 3.5, 4.0, 6.0]),
                               (B, K)), axis=1).astype(np.float32)
    sum_lp = -rng.choice(np.float32([1.0, 2.5, 3.0]), B).astype(np.float32)
    completed = np.zeros(B, bool)
    failed = np.zeros(B, bool)
    if case == "step0":
        # every beam of a group holds the same distribution and sum
        ids = np.repeat(ids[::K], K, axis=0)
        plog = np.repeat(-np.sort(_rand(rng, G, K) ** 2, axis=1), K, axis=0)
        sum_lp = np.zeros(B, np.float32)
    elif case == "dead_rows":
        completed[[1, 7]] = True
        failed[[3]] = True
    p = np.exp(plog).astype(np.float32)
    pt0, ptsum0 = _rand(rng, B) ** 2, _rand(rng, B) ** 2
    tid0 = (beg + rng.integers(0, 100, B)).astype(np.int32)
    rowmap = rng.integers(0, K, (B, nl)).astype(np.int32)
    cand = (plog, ids, p, pt0, ptsum0, tid0)

    want = _jax_merge(cand, sum_lp, completed, failed, rowmap, i, K, beg)
    m = port_window._merge_beam(*cand, sum_lp, ~(completed | failed), beg)
    got = [m.src, m.ids, m.p, m.plog, m.pt, m.ptsum, m.tid, m.score,
           port_window.permute_rowmap(rowmap, m.src, i, K)]
    names = ("src", "ids", "p", "plog", "pt", "ptsum", "tid", "score",
             "rowmap")
    for name, a, b in zip(names, got, want):
        np.testing.assert_array_equal(a, b, err_msg=name)
    if case == "step0":   # the dedupe: K distinct tokens per group
        assert all(len(set(m.ids[g * K:(g + 1) * K])) == K for g in range(G))
