"""Uni-MoE-2.0-Omni's speech path in the port (``models/unimoe.py``,
``decode/omni.py``) against the plain reference (``unimoe_reference.py``)
at a small size with seeded random weights: width 64, 4 query heads over
2 K/V heads of 16, 2 layers, 4 routed + 1 null experts, 2 shared, top-p
0.7 capped at 2, 512 ids, a nano Whisper encoder.  In f32 the program
and the reference differ only in the order of their sums, so logits agree
to ~1e-5 of their size; every tolerance below says so where it is set.

The card tests (``cuda`` marker) hold K14 and K5 at the LM's vocabulary to
their plain versions, and the graph-replayed step to the eager step bit
for bit:

    python -m pytest --noconftest -m cuda tests/test_torch_unimoe.py
"""

import os
import sys

import numpy as np
import pytest
import torch

from godot_whisper_tpu_torch.decode.omni import UniMoEContext
from godot_whisper_tpu_torch.decode.params import TranscribeParams
from godot_whisper_tpu_torch.models import unimoe as U
from godot_whisper_tpu_torch.models.config import get_config
from godot_whisper_tpu_torch.models.model import encoder_forward
from godot_whisper_tpu_torch.ops import decode_attention as D
from godot_whisper_tpu_torch.parallel.batch import BatchTranscriber

sys.path.insert(0, os.path.dirname(__file__))
import unimoe_reference as R  # noqa: E402

HEAD, TAIL = [1, 2, 3, 4, 5, 6, 7, 8], [9, 10, 11, 12, 13, 14, 15, 16]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def small_config(**kw) -> U.UniMoEConfig:
    audio = get_config("tiny.en").replace(
        name="nano-enc", n_audio_layer=1, n_audio_state=64, n_audio_head=2,
        n_audio_ctx=1500)
    base = dict(name="unimoe-small", n_vocab=512, n_state=64, n_layer=2,
                n_head=4, n_kv_head=2, head_dim=16, n_shared=2,
                shared_ffn=48, n_routed=4, n_null=1, routed_ffn=96,
                top_p=0.7, top_k=2, audio=audio, token_eot=511)
    return U.UniMoEConfig(**dict(base, **kw))


@pytest.fixture(scope="module")
def small():
    cfg = small_config()
    params = U.init_params(cfg, seed=5, scale=0.3)
    # the router at a spread that makes one, two and null choices common
    params["blocks"]["router"].mul_(4.0)
    return cfg, params


def mel_windows(cfg, n, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n, 3000, cfg.audio.n_mels), generator=g) * 0.5


# ------------------------------------------------------------- the router
SETS = [  # probabilities (4 routed, null last) -> the chosen set
    ([0.80, 0.10, 0.05, 0.03, 0.02], {0}),            # one over 0.7
    ([0.40, 0.35, 0.10, 0.10, 0.05], {0, 1}),         # two needed
    ([0.30, 0.25, 0.25, 0.10, 0.10], {0, 1}),         # capped at 2
    ([0.05, 0.05, 0.05, 0.10, 0.75], {4}),            # the null expert alone
    ([0.20, 0.10, 0.05, 0.05, 0.60], {4, 0}),         # null first, then 0
    ([0.10, 0.45, 0.05, 0.05, 0.35], {1, 4}),         # null second
    ([0.30, 0.30, 0.20, 0.10, 0.10], {0, 1}),         # a tie: lower index
    ([0.20, 0.20, 0.20, 0.20, 0.20], {0, 1}),
    ([0.70, 0.30, 0.00, 0.00, 0.00], {0}),            # reaching 0.7 stops
    ([0.10, 0.10, 0.10, 0.69, 0.01], {3, 0}),         # below 0.7 goes on
]


@pytest.mark.parametrize("probs,want", SETS)
def test_router_set_on_constructed_probabilities(probs, want):
    p = torch.tensor([probs], dtype=torch.float32)
    got = U.top_p_set(p, 0.7, 2)[0]
    assert set(torch.nonzero(got).flatten().tolist()) == want
    assert torch.equal(got, R.chosen_set(p, 0.7, 2)[0])


def test_router_weights_are_unrenormalised_probabilities(small):
    cfg, params = small
    h = torch.randn(64, cfg.n_state, generator=torch.Generator()
                    .manual_seed(1))
    r = U.route(h, params["blocks"]["router"][0], cfg)
    assert torch.allclose(r.probs.sum(-1), torch.ones(64))
    e = cfg.n_routed
    assert torch.equal(r.weights, torch.where(r.chosen[:, :e],
                                              r.probs[:, :e],
                                              torch.zeros(())))
    n = r.chosen.sum(-1)
    assert int(n.min()) >= 1 and int(n.max()) <= 2
    # the draw gives every kind of set: one expert, two, and the null one
    assert (n == 1).any() and (n == 2).any() and r.chosen[:, e].any()


# ---------------------------------------------------------- the experts
def _layer_with_router(params, li, column_weights):
    """A copy of the blocks whose router at layer li gives every row of a
    constant input the softmax of ``column_weights``' logits."""
    blk = {k: v.clone() for k, v in params["blocks"].items()}
    blk["router"][li] = torch.zeros_like(blk["router"][li])
    blk["router"][li][0] = torch.tensor(column_weights)
    return blk


def _shared_sum(h, blk, li):
    out = U._mlps(h, blk["shared_in"][li], blk["shared_out"][li])
    return out[0] + out[1]


@pytest.mark.parametrize("static", [True, False])
def test_null_choice_adds_exactly_zero(small, static):
    """Rows whose set is the null expert alone get the shared experts'
    sum, bit for bit; rows with null and expert 2 get exactly the shared
    sum plus expert 2's weighted output."""
    cfg, params = small
    h = torch.zeros(6, cfg.n_state)
    h[:, 0] = 1.0
    alone = _layer_with_router(params, 0, [0.0, 0.0, 0.0, 0.0, 9.0])
    out, r = U.moe(h, alone, 0, cfg, static)
    assert r.chosen[:, 4].all() and not r.chosen[:, :4].any()
    assert torch.equal(out, _shared_sum(h, alone, 0))
    pair = _layer_with_router(params, 0, [0.0, 0.0, 1.5, 0.0, 2.0])
    out, r = U.moe(h, pair, 0, cfg, static)
    assert r.chosen[:, [2, 4]].all() and r.chosen.sum() == 12
    z = U._mlps(h, pair["expert_in"][0, 2:3], pair["expert_out"][0, 2:3])
    assert torch.equal(out, _shared_sum(h, pair, 0)
                       + r.weights[:, 2:3] * z[0])


@pytest.mark.parametrize("static", [True, False])
def test_shared_experts_run_on_every_token(small, static):
    cfg, params = small
    h = torch.randn(40, cfg.n_state, generator=torch.Generator()
                    .manual_seed(2))
    blk = dict(params["blocks"])
    blk["expert_out"] = torch.zeros_like(blk["expert_out"])
    out, _ = U.moe(h, blk, 1, cfg, static)
    shared = _shared_sum(h, blk, 1)
    assert torch.equal(out, shared)
    assert (shared.abs().sum(-1) > 0).all()
    blk["shared_out"] = torch.zeros_like(blk["shared_out"])
    assert torch.equal(U.moe(h, blk, 1, cfg, static)[0],
                       torch.zeros_like(shared))


def test_static_form_equals_gathered_form(small):
    """The decode step's form (every expert over every row, weight 0 where
    not chosen) against the prefill's (each expert over its rows): the
    same sets and, per row, the same sums in the same order; the products
    of a row may round differently at another row count (1e-6 of their
    size)."""
    cfg, params = small
    h = torch.randn(96, cfg.n_state, generator=torch.Generator()
                    .manual_seed(3))
    for li in range(cfg.n_layer):
        a, ra = U.moe(h, params["blocks"], li, cfg, static=True)
        b, rb = U.moe(h, params["blocks"], li, cfg, static=False)
        assert torch.equal(ra.chosen, rb.chosen)
        assert (a - b).abs().max() <= 1e-6 * a.abs().max()


# ------------------------------------------------ the model against the LM
def test_prefill_then_cached_decode_match_full_forward(small):
    """Prefill over [head | audio | tail] then lm_step through the cache,
    teacher-forced over fixed tokens, against the reference's full
    forward of the whole sequence: logits within 2e-5 of their largest
    (f32 on both sides, sums in other orders), and the same routing."""
    cfg, params = small
    B, steps = 2, 5
    mel = mel_windows(cfg, B)
    tokens = torch.randint(0, 500, (B, steps), generator=torch.Generator()
                           .manual_seed(4))
    enc = encoder_forward(params, cfg.audio, mel)
    audio = U.connector(params, cfg, enc)
    head = torch.tensor(HEAD).expand(B, -1)
    tail = torch.tensor(TAIL).expand(B, -1)
    x = U.embed_prompt(params, head, audio, tail)
    P = x.shape[1]
    cache = U.init_cache(cfg, B, 256, torch.float32, device="cpu")
    got = [U.prefill(params, cfg, x, cache)]
    for i in range(steps - 1):
        slot = torch.tensor([P + i], dtype=torch.int32)
        got.append(U.lm_step(params, cfg, tokens[:, i].int(),
                             torch.full((B,), P + i, dtype=torch.int32),
                             cache, slot))
    got = torch.stack(got, 1)                                  # (B, n, V)
    ref = torch.stack(R.served_logits(params, cfg, mel, HEAD, TAIL,
                                      tokens.tolist()))
    scale = ref.abs().max()
    assert (got - ref).abs().max() <= 2e-5 * scale, float(
        (got - ref).abs().max() / scale)
    assert torch.equal(got.argmax(-1), ref.argmax(-1))


def test_batch_transcriber_serves_the_model(small):
    """``BatchTranscriber.transcribe`` on the CPU: a 20 s clip and a 45 s
    one (three chunks), greedy, ``max_tokens`` + 1 tokens a chunk unless
    end-of-text; every token's id is the reference's greedy choice and its
    log-probability within 2e-5 of the reference's (f32 both sides)."""
    cfg, params = small
    ctx = UniMoEContext(cfg, params, device="cpu",
                        mel_filters=np.abs(np.random.default_rng(0).normal(
                            size=(80, 201))).astype(np.float32) * 0.01,
                        prompt_head=HEAD, prompt_tail=TAIL,
                        record_routes=True)
    rng = np.random.default_rng(7)
    clips = [rng.normal(size=20 * 16000).astype(np.float32) * 0.1,
             rng.normal(size=45 * 16000).astype(np.float32) * 0.1]
    segs = BatchTranscriber(ctx).transcribe(
        clips, TranscribeParams(max_tokens=3, no_timestamps=True))
    assert [len(s) for s in segs] == [1, 3]
    rows = [(c, s) for c in range(2) for s in range(len(segs[c]))]
    served = [[t.id for t in segs[c][s].tokens] for c, s in rows]
    assert all(len(t) <= 4 for t in served)
    mel, _ = ctx.mel.device_batch([r[2] for r in ctx.rows(clips)])
    ref = R.served_logits(params, cfg, mel[:, :, :3000].transpose(1, 2),
                          HEAD, TAIL, served)
    for (c, s), toks, lg in zip(rows, served, ref):
        lp = torch.log_softmax(lg, -1)
        assert lp.argmax(-1).tolist() == toks
        plog = torch.tensor([t.plog for t in segs[c][s].tokens])
        assert (plog - lp[torch.arange(len(toks)), toks]).abs().max() < 2e-5
    assert ctx.timings.n_encode == 1 and ctx.timings.n_decode >= 1
    # the last batch's chosen sets: every position the LM ran, one or two
    # choices each
    steps = ctx.timings.n_decode
    n = ctx.last_routes.sum(-1)
    assert ctx.last_routes.shape == (ctx.prompt_len + steps - 1,
                                     cfg.n_layer, 4, cfg.n_choices)
    assert n.min() >= 1 and n.max() <= 2


def test_routes_are_kept_only_when_asked(small):
    """By default the step writes no chosen sets and the context keeps
    none; the token loop's span counts every step as replayed only on a
    CUDA device."""
    from godot_whisper_tpu_torch.runtime.trace import tracer
    cfg, params = small
    ctx = UniMoEContext(cfg, params, device="cpu",
                        mel_filters=np.full((80, 201), 0.01, np.float32),
                        prompt_head=HEAD, prompt_tail=TAIL)
    clip = np.random.default_rng(2).normal(size=16000).astype(np.float32)
    was = tracer.enabled
    tracer.enable()
    tracer.clear()
    try:
        BatchTranscriber(ctx).transcribe(
            [clip], TranscribeParams(max_tokens=2, no_timestamps=True))
        loop = [r for r in tracer.records() if r.name == "gwt.token_loop"]
    finally:
        tracer.enabled = was
        tracer.clear()
    assert ctx.last_routes is None
    assert ctx._steps.step.routes is None
    assert len(loop) == 1 and loop[0].counts["graph_steps"] == 0
    assert loop[0].counts["steps"] >= 1


def test_routing_counts_of_a_step(small):
    """``tally``: token-layers, routed experts run, null picks, and the
    routed experts some row chose, summed over layers."""
    chosen = torch.zeros(2, 3, 5, dtype=torch.bool)
    chosen[0, 0, [0, 4]] = True
    chosen[0, 1, [0, 1]] = True
    chosen[0, 2, 4] = True
    chosen[1, :, 3] = True
    assert U.tally(chosen, 4).tolist() == [6, 6, 2, 3]


def test_filter_plan_at_lm_vocabulary():
    """K5's plan at the LM's 152064 ids: 16 CTAs of 38 ids a thread cover
    the row, the last slice not empty; K6 keeps Whisper's bound."""
    from godot_whisper_tpu_torch.ops import filter_sample as FS
    C, W = FS.filter_plan(32, 152064, FS.WIDE_VOCAB)
    assert (C, W) == (16, 38 * 256) and (C - 1) * W < 152064 <= C * W
    with pytest.raises(ValueError):
        FS.filter_plan(32, 152064)


def test_gqa_attention_plain_is_grouped_attention():
    """K14's plain version against per-head attention with each query
    head on its K/V head (f32; sums in another order: 1e-6)."""
    g = torch.Generator().manual_seed(8)
    L, B, C, Hk, G, Dh = 2, 3, 64, 2, 3, 16
    q = torch.randn(B, Hk * G * Dh, generator=g)
    k = torch.randn(L, B, C, Hk * Dh, generator=g)
    v = torch.randn(L, B, C, Hk * Dh, generator=g)
    got = D.gqa_decode_attention(q, k, v, 40, n_head=Hk * G, n_kv_head=Hk,
                                 layer=1)
    qh = q.view(B, Hk * G, Dh)
    kh = k[1, :, :40].view(B, 40, Hk, Dh).repeat_interleave(G, 2)
    vh = v[1, :, :40].view(B, 40, Hk, Dh).repeat_interleave(G, 2)
    p = torch.softmax(torch.einsum("bhd,bchd->bhc", qh, kh) * Dh ** -0.5, -1)
    want = torch.einsum("bhc,bchd->bhd", p, vh).reshape(B, -1)
    assert (got - want).abs().max() < 1e-6


# ----------------------------------------------------------------- card
@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,G,C,hi", [(32, 7, 512, 217), (32, 7, 512, 317),
                                      (3, 7, 256, 1), (5, 2, 768, 700),
                                      (4, 8, 256, 256)])
def test_gqa_attention_kernel_matches_plain(cuda, B, G, C, hi):
    """K14 at the LM's shapes (7 query heads a K/V head, head dim 128, the
    cell's capacity 512) and edges (one live slot, a full cache, 8 heads
    a group) against its plain version: 2e-5 (f32 sums in another order
    over bf16 inputs), the slot bound on the device equal to a host int,
    and two calls bitwise equal."""
    g = torch.Generator(device=cuda).manual_seed(B + G + hi)
    Hk, L = 4, 2
    q = torch.randn(B, Hk * G * 128, generator=g, device=cuda).bfloat16()
    k = torch.randn(L, B, C, Hk * 128, generator=g, device=cuda).bfloat16()
    v = torch.randn(L, B, C, Hk * 128, generator=g, device=cuda).bfloat16()
    kw = dict(n_head=Hk * G, n_kv_head=Hk, layer=1)
    want = D.gqa_decode_attention_plain(q, k, v, hi, **kw)
    got = D.gqa_decode_attention(q, k, v, hi, **kw)
    dev_hi = D.gqa_decode_attention(q, k, v, torch.tensor(
        [hi], dtype=torch.int32, device=cuda), **kw)
    torch.cuda.synchronize()
    assert (got - want).abs().max() < 2e-5
    assert torch.equal(got, dev_hi)
    assert torch.equal(got, D.gqa_decode_attention(q, k, v, hi, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 5, 32])
def test_filter_sample_kernel_at_lm_vocabulary(cuda, B):
    """K5's wide instantiation (38 ids a thread) at V 152064 on the edge
    rows of ``filter_edge_case``, as the Whisper vocabularies are
    tested."""
    from chip_smoke import filter_edge_errors
    from godot_whisper_tpu_torch.ops import filter_sample as FS
    r = filter_edge_errors(torch, FS, np.random.default_rng(B), 152064, B)
    assert r["mismatch"] == 0 and r["err"] < 1e-5, r


@pytest.mark.cuda
def test_graph_step_equals_eager_step(cuda):
    """The LM step replayed from its CUDA graph against the eager step,
    bit for bit, over 6 steps after one prefill, at head dim 128 and the
    LM's vocabulary; the routing counts and the recorded sets too."""
    from godot_whisper_tpu_torch.decode.omni import LMStepGraph
    cfg = small_config(n_state=512, n_head=4, n_kv_head=2, head_dim=128,
                       shared_ffn=256, routed_ffn=1024, n_vocab=152064,
                       token_eot=151645)
    params = U.init_params(cfg, seed=9, compute_dtype=torch.bfloat16,
                           scale=0.05, device=cuda)
    B, P = 8, 40
    x = torch.randn(B, P, cfg.n_state, device=cuda)
    toks = np.random.default_rng(3).integers(0, 150000, (6, B))
    outs = []
    for graphed in (True, False):
        g = LMStepGraph(cfg, B, 256, torch.bfloat16, cuda,
                        record_routes=True)
        U.prefill(params, cfg, x, g.cache)
        got = []
        for i in range(6):
            if graphed:
                got.append(g.step(params, cfg, toks[i], P + i).clone())
                # the loop reads each step's tokens back before the host
                # writes the next step's upload buffer
                torch.cuda.synchronize()
            else:
                slot = torch.tensor([P + i], dtype=torch.int32, device=cuda)
                got.append(U.lm_step(
                    params, cfg, torch.tensor(toks[i], dtype=torch.int32,
                                              device=cuda),
                    torch.full((B,), P + i, dtype=torch.int32, device=cuda),
                    g.cache, slot, counts=g.counts, routes=g.routes))
        torch.cuda.synchronize()
        outs.append((torch.stack(got), g.counts.clone(), g.cache.k.clone(),
                     g.routes.clone()))
    (a, ca, ka, ra), (b, cb, kb, rb) = outs
    assert torch.equal(a, b) and torch.equal(ca, cb) and torch.equal(ka, kb)
    assert torch.equal(ra, rb) and ra[P:P + 6].sum(-1).min() >= 1
    assert int(ca[0]) == 6 * B * cfg.n_layer
