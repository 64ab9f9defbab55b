"""The token loop's step on the CPU: which loop a window takes and
whether its step replays (``decode/window.py::run_decode_loop``,
``GraphedStep.replays_on``), a greedy window stepping its ``StepGraph``
eagerly on the step's buffers, the one-shape step cache that the Whisper
and Uni-MoE steps share (``StepCache``), the step with its cache slot on
the device equal to the step with a host int, the caches written in
place for the step's buffers equal to fresh ones, and the benchmark's
reader of the loop's ``graph_steps`` count.  The replay itself runs on
the card (``tests/test_torch_cuda.py -k graph``)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import godot_whisper_tpu_torch as gt
from godot_whisper_tpu_torch.decode import window as W
from godot_whisper_tpu_torch.decode.filters import build_filter_context
from godot_whisper_tpu_torch.decode.omni import UniMoEContext
from godot_whisper_tpu_torch.decode.window import (StepCache, StepGraphs,
                                                   WindowDecoder,
                                                   WindowResult,
                                                   WindowStatics,
                                                   prompt_pass_grouped)
from godot_whisper_tpu_torch.models import model as tm
from godot_whisper_tpu_torch.models import unimoe as U
from godot_whisper_tpu_torch.models.config import get_config
from godot_whisper_tpu_torch.models.params import init_params
from godot_whisper_tpu_torch.ops import decode_attention as D


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Single-threaded torch: the tests share the CPU with other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def nano():
    cfg = get_config("tiny.en").replace(
        n_audio_layer=2, n_text_layer=2, n_audio_state=128,
        n_audio_head=4, n_text_state=128, n_text_head=4, n_audio_ctx=64,
        name="nano")
    return cfg, init_params(cfg, seed=3, compute_dtype=torch.float32,
                            device="cpu")


def statics(cfg, **kw):
    base = dict(config=cfg, batch=10, n_max=8, prompt_pad=8,
                greedy_argmax=True, suppress_blank=True, no_timestamps=False,
                single_segment=False, max_tokens=0, test_mode=False,
                kv_group=5, beam_size=5)
    return WindowStatics(**dict(base, **kw))


# route -> (WindowStatics overrides, device, the loop it takes, its step
# replays a captured graph)
ROUTES = {
    "cpu": ({}, "cpu", "greedy", False),
    "beam_split": ({"strategy": "beam"}, "cuda:0", "beam", False),
    "beam_merged": ({"strategy": "beam"}, "cuda:0", "beam", False),
    "tp": ({"tp": SimpleNamespace(rank=0, size=2)}, "cuda:0", "greedy",
           False),
    "cuda_greedy": ({}, "cuda:0", "greedy", True),
    "cuda_sampling": ({"greedy_argmax": False}, "cuda", "greedy", True),
}


RESULT = SimpleNamespace(n_steps=1, graph_steps=0)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_graph_eligibility_by_route(nano, monkeypatch, route):
    """The loop is decided from the statics alone, the replay from the
    device and ``tp``: greedy and sampling windows write the prompt into
    their step's cache and take the greedy loop, whose step replays on one
    CUDA device and runs eagerly on the CPU and under tensor parallelism;
    both beam caches take a new cache and the beam loop, which steps
    eagerly."""
    over, device, loop, replays = ROUTES[route]
    if route == "beam_merged":     # the wide configurations' K8 path
        monkeypatch.setattr(W, "use_split_cache", lambda st: False)
    st = statics(nano[0], **over)
    if route.startswith("beam"):
        assert W.use_split_cache(st) == (route == "beam_split")
    taken, step = [], SimpleNamespace(kv="the step's cache")

    def prompt_pass(*a, out, **kw):
        taken.append(("prompt", out))
        return None, None

    def get(*a):
        taken.append("step")
        return step
    monkeypatch.setattr(W, "prompt_pass_grouped", prompt_pass)
    monkeypatch.setattr(W, "run_greedy_loop",
                        lambda *a: taken.append("greedy") or RESULT)
    monkeypatch.setattr(W, "run_beam_loop",
                        lambda *a: taken.append("beam") or RESULT)
    W.run_decode_loop(None, st.config, None, st, SimpleNamespace(get=get),
                      None, torch.zeros(2, 8, dtype=torch.int32),
                      np.ones(2, np.int32), 0.0, 0, 3000, 0)
    assert taken == (["step", ("prompt", step.kv), "greedy"]
                     if loop == "greedy" else [("prompt", None), "beam"])
    for dev in (device, torch.device(device)):
        assert (loop == "greedy"
                and W.GraphedStep.replays_on(dev, st.tp)) is replays


def test_cpu_windows_hold_no_graph(nano, monkeypatch):
    """On the CPU a greedy window steps its ``StepGraph`` eagerly on the
    step's buffers: the cross-KV buffer and the self-KV cache serve every
    window, no graph is captured, every step takes its cache slot as a
    host int, the step counts 0 replays and the loop 0 ``graph_steps``;
    the second window through the same buffers gives the WindowResult of
    a fresh decoder (whose own cross-KV becomes its buffer)."""
    cfg, params = nano
    slots = []

    def step(*a, slot, **kw):
        slots.append(slot)
        return tm.decoder_step(*a, slot=slot, **kw)
    monkeypatch.setattr(W, "decoder_step", step)
    ctx = gt.WhisperContext.from_params(cfg, params, device="cpu")
    fctx = build_filter_context(cfg, ctx.pipeline.tokenizer, device="cpu")
    rng = np.random.default_rng(0)
    encs = [torch.from_numpy(rng.standard_normal(
        (1, cfg.n_audio_ctx, cfg.n_audio_state)).astype(np.float32))
        for _ in range(2)]
    kw = dict(n_decoders=2, temperature=0.4, seek=0, seek_end=500,
              suppress_blank=True, no_timestamps=False, single_segment=False,
              max_tokens=12, test_mode=False, seed=1)
    sot = np.asarray([cfg.token_sot], np.int32)
    graphs = StepGraphs()
    wd = WindowDecoder(cfg, fctx, graphs=graphs)
    x1 = graphs.cross_kv(params, cfg, encs[0], False)
    first = wd.decode(params, x1, sot, **kw)
    step = graphs._steps.step
    x2 = graphs.cross_kv(params, cfg, encs[1], False)
    assert x2.k is x1.k and x2.k is step.xkv.k
    got = wd.decode(params, x2, sot, **kw)
    assert graphs._steps.step is step
    assert step.graph is None and step.replays == 0
    assert slots and all(type(s) is int for s in slots)
    assert first.graph_steps == got.graph_steps == 0 and got.n_steps > 1
    want = WindowDecoder(cfg, fctx).decode(
        params, tm.cross_kv(params, cfg, encs[1]), sot, **kw)
    for f in WindowResult._fields:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


@pytest.mark.parametrize("quant", [False, True])
def test_step_graphs_keep_one_buffer_and_one_shape(nano, quant):
    """``cross_kv`` writes every window into one buffer, equal to a new
    cross-KV, under tensor parallelism too; ``get`` keeps one step shape
    (``StepCache``), made anew when the shape changes; a cross-KV made
    elsewhere becomes the buffer that the step reads; other weights or a
    cross-KV of another shape drop the buffer with the step.  The Uni-MoE
    context keeps its step by the same policy."""
    cfg, params = nano
    rng = np.random.default_rng(1)

    def enc(g):
        return torch.from_numpy(rng.standard_normal(
            (g, cfg.n_audio_ctx, cfg.n_audio_state)).astype(np.float32))

    def fresh(e):
        x = tm.cross_kv(params, cfg, e)
        return tm.quantize_cross_kv(x, cfg.n_text_head) if quant else x

    def same(a, b):
        return all(x.dtype == y.dtype and torch.equal(x, y)
                   for x, y in zip(a[:-1], b[:-1]))

    graphs = StepGraphs()
    e1, e2 = enc(2), enc(2)
    x1 = graphs.cross_kv(params, cfg, e1, quant)
    x2 = graphs.cross_kv(params, cfg, e2, quant)
    assert x2[0] is x1[0] and x2.t_valid == cfg.n_audio_ctx
    assert same(x2, fresh(e2))

    st = statics(cfg, batch=10, kv_group=5)
    g = graphs.get(params, st, x2)
    assert isinstance(graphs._steps, StepCache)
    assert g.xkv[0] is x2[0] and graphs.get(params, st, x2) is g
    g16 = graphs.get(params, statics(cfg, batch=10, kv_group=5,
                                     prompt_pad=16), x2)
    again = graphs.get(params, st, x2)
    assert g16 is not g and again is not g and again is not g16
    tp = graphs.get(params, statics(cfg, tp=SimpleNamespace(rank=0,
                                                            size=1)), x2)
    assert tp is not again and tp.tp is not None and tp.xkv[0] is x2[0]

    made = fresh(e2)
    h = graphs.get(params, st, made)
    assert h is not again and h.xkv[0] is made[0] and graphs._xkv is made
    assert graphs.get(params, st, made) is h
    other = graphs.get(dict(params), st, made)
    assert other is not h and other.xkv[0] is made[0]

    x3 = graphs.cross_kv(params, cfg, enc(3), quant)
    assert x3[0] is not x1[0] and graphs._steps.step is None
    assert graphs.cross_kv(params, cfg, enc(3), quant)[0] is x3[0]
    assert graphs.cross_kv(dict(params), cfg, enc(3), quant)[0] \
        is not x3[0]
    e4 = enc(3)
    x4 = graphs.cross_kv(params, cfg, e4, quant, tp=SimpleNamespace(
        rank=0, size=1))
    assert x4[0] is graphs._xkv[0] and same(x4, fresh(e4))

    ucfg = U.UniMoEConfig(
        name="unimoe-nano", n_vocab=64, n_state=32, n_layer=1, n_head=2,
        n_kv_head=1, head_dim=16, n_shared=1, shared_ffn=16, n_routed=2,
        n_null=1, routed_ffn=16, top_p=0.7, top_k=1,
        audio=cfg.replace(n_audio_ctx=1500), token_eot=63)
    uctx = UniMoEContext(ucfg, U.init_params(ucfg, seed=1), device="cpu",
                         mel_filters=np.zeros((80, 201), np.float32),
                         prompt_head=[1], prompt_tail=[2])
    assert isinstance(uctx._steps, StepCache)
    s1 = uctx.graph(2, 128)
    assert uctx.graph(2, 128) is s1 and s1.graph_steps() == 0
    s2 = uctx.graph(3, 128)
    assert s2 is not s1 and uctx.graph(2, 128) not in (s1, s2)


def test_captured_launches_count_at_each_replay():
    """A wrapper's launches inside ``CapturedLaunches`` are kept, not
    counted, and ``add()`` counts them once a replay; another thread's
    launches meanwhile count as they happen."""
    import collections
    import threading
    from godot_whisper_tpu_torch.ops import kernels as K

    def wrapper():
        pass
    wrapper.launches = 0
    by_key = collections.Counter()
    K.count(wrapper, (by_key, "a"))
    with K.CapturedLaunches() as rec:
        K.count(wrapper, (by_key, "a"))
        K.count(wrapper, (by_key, "b"))
        K.count(wrapper, (by_key, "b"))
        t = threading.Thread(target=K.count, args=(wrapper, (by_key, "c")))
        t.start()
        t.join()
    assert wrapper.launches == 2 and by_key == {"a": 1, "c": 1}
    rec.add()
    rec.add()
    assert wrapper.launches == 8 and by_key == {"a": 3, "b": 4, "c": 1}
    K.count(wrapper)
    assert wrapper.launches == 9


@pytest.mark.parametrize("hi", [1, 8, 9, 12, 300])
@pytest.mark.parametrize("kv_group", [1, 2])
def test_decode_attention_plain_takes_hi_on_the_device(hi, kv_group):
    """``decode_attention_plain``, ``decode_attention_split_plain`` and
    the wrapper's CPU route with hi a (1,) int32 tensor equal hi as an
    int, bit for bit."""
    rng = np.random.default_rng(hi + kv_group)
    b, s, c = 4, 128, 320
    q = torch.from_numpy(rng.standard_normal((b, s)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal(
        (2, b // kv_group, c, s)).astype(np.float32)) for _ in range(2))
    lo = torch.tensor([3, 5, 1, 4], dtype=torch.int32)
    hi_t = torch.tensor([hi], dtype=torch.int32)
    kw = dict(split=8, n_head=4, kv_group=kv_group, layer=1)
    for fn in (D.decode_attention_plain, D.decode_attention_split_plain,
               D.decode_attention):
        assert torch.equal(fn(q, k, v, lo, hi_t, **kw),
                           fn(q, k, v, lo, hi, **kw)), fn.__name__


@pytest.mark.parametrize("kv_group", [1, 2])
def test_decoder_step_slot_on_the_device_equals_host_int(nano, kv_group):
    """Four steps with ``slot`` a (1,) int32 tensor (the K/V row written by
    ``index_copy_``, hi = slot + 1 on the device) give the caches and the
    logits of the host-int steps, bit for bit."""
    cfg, params = nano
    B, P, split = 4, 3, 8
    rng = np.random.default_rng(kv_group)
    enc = torch.from_numpy(rng.standard_normal(
        (B // kv_group, cfg.n_audio_ctx, cfg.n_audio_state)).astype(
            np.float32))
    xkv = tm.cross_kv(params, cfg, enc)
    toks = rng.integers(0, cfg.n_vocab, (B, P + 4)).astype(np.int32)
    n_prompt = np.array([3, 2, 3, 1], np.int32)
    kv0 = tm.init_kv_cache(cfg, B, cache_len=split + 8, dtype=torch.float32,
                           device="cpu")
    prompt = np.zeros((B, split), np.int32)
    prompt[:, :P] = toks[:, :P]
    xrows = tm.CrossKV(xkv.k.repeat_interleave(kv_group, dim=1),
                       xkv.v.repeat_interleave(kv_group, dim=1),
                       xkv.t_valid)
    _, kv0 = tm.decoder_dense(
        params, cfg, torch.from_numpy(prompt),
        torch.arange(split, dtype=torch.int32).expand(B, split), kv0, xrows,
        n_valid=torch.from_numpy(n_prompt))
    caches = [tm.KVCache(kv0.k.clone(), kv0.v.clone()) for _ in range(2)]
    lo = torch.from_numpy(n_prompt)
    for i in range(4):
        tok = torch.from_numpy(toks[:, P + i].copy())
        pos = torch.from_numpy(n_prompt + i)
        got = []
        for j, slot in enumerate((split + i, torch.tensor(
                [split + i], dtype=torch.int32))):
            lg, caches[j] = tm.decoder_step(
                params, cfg, tok, pos, caches[j], xkv, lo=lo, slot=slot,
                split=split, kv_group=kv_group)
            got.append(lg)
        assert torch.equal(got[0], got[1]), i
        assert torch.equal(caches[0].k, caches[1].k)
        assert torch.equal(caches[0].v, caches[1].v)


def test_split_beam_step_refuses_a_device_slot(nano):
    cfg, params = nano
    kv = tm.init_kv_cache(cfg, 2, cache_len=8, dtype=torch.float32,
                          device="cpu")
    xkv = tm.cross_kv(params, cfg, torch.zeros(1, cfg.n_audio_ctx,
                                               cfg.n_audio_state))
    with pytest.raises(ValueError, match="host int slot"):
        tm.decoder_step(params, cfg, torch.zeros(2, dtype=torch.int32),
                        torch.zeros(2, dtype=torch.int32), kv, xkv,
                        lo=torch.zeros(2, dtype=torch.int32),
                        slot=torch.zeros(1, dtype=torch.int32), split=0,
                        kv_group=2, kv_prompt=kv)


@pytest.mark.parametrize("quant", [False, True])
def test_cross_kv_written_in_place_equals_fresh(nano, quant):
    """``cross_kv(out=)`` and ``quantize_cross_kv(out=)`` write the values
    of the fresh tensors into zeroed buffers, padding and scale lanes
    included."""
    cfg, params = nano
    rng = np.random.default_rng(5)
    enc = torch.from_numpy(rng.standard_normal(
        (3, cfg.n_audio_ctx, cfg.n_audio_state)).astype(np.float32))
    want = tm.cross_kv(params, cfg, enc)
    out = tm.CrossKV(torch.zeros_like(want.k), torch.zeros_like(want.v), 0)
    got = tm.cross_kv(params, cfg, enc, out=out)
    if quant:
        want = tm.quantize_cross_kv(want, cfg.n_text_head)
        out = tm.QuantCrossKV(*(torch.zeros_like(t) for t in want[:-1]),
                              t_valid=0)
        got = tm.quantize_cross_kv(got, cfg.n_text_head, out=out)
    assert got.t_valid == want.t_valid == cfg.n_audio_ctx
    for a, b, o in zip(got[:-1], want[:-1], out[:-1]):
        assert a is o and a.dtype == b.dtype and torch.equal(a, b)


def test_cross_kv_under_autograd_is_stacked(nano):
    """Where autograd records the projections (training), ``cross_kv``
    stacks and pads: the values of the in-place route, and a backward
    that slices the gradient instead of copying it once a layer."""
    cfg, params = nano
    enc = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, cfg.n_audio_ctx, cfg.n_audio_state)).astype(np.float32))
    want = tm.cross_kv(params, cfg, enc)
    got = tm.cross_kv(params, cfg, enc.clone().requires_grad_())
    for a, b in ((got.k, want.k), (got.v, want.v)):
        assert "CopySlices" not in type(a.grad_fn).__name__
        assert a.is_contiguous() and torch.equal(a.detach(), b)


@pytest.mark.parametrize("n_dec", [1, 3])
def test_prompt_pass_written_in_place_equals_fresh(nano, n_dec):
    """The prompt pass into a used cache (``out=``) zeroes it first and
    leaves it equal to the fresh, repeated cache; a cache of another shape
    is refused."""
    cfg, params = nano
    rng = np.random.default_rng(n_dec)
    G, P, n_max = 2, 8, 8
    xkv = tm.cross_kv(params, cfg, torch.from_numpy(rng.standard_normal(
        (G, cfg.n_audio_ctx, cfg.n_audio_state)).astype(np.float32)))
    prompt = torch.from_numpy(rng.integers(0, cfg.n_vocab, (G, P)).astype(
        np.int32))
    n_prompt = np.array([5, 8], np.int32)
    args = (params, cfg, prompt, n_prompt, xkv, n_dec)
    last, want = prompt_pass_grouped(*args, n_max=n_max)
    out = tm.KVCache(*(torch.full_like(t, 7.0) for t in want))
    got_last, got = prompt_pass_grouped(*args, n_max=n_max, out=out)
    assert got is out
    assert torch.equal(got_last, last)
    assert torch.equal(got.k, want.k) and torch.equal(got.v, want.v)
    L, _, C, S = want.k.shape
    bad = tm.KVCache(*(torch.zeros(L, G, C + tm._BLOCK_C, S)
                       for _ in range(2)))
    with pytest.raises(ValueError, match="init_kv_cache"):
        prompt_pass_grouped(params, cfg, prompt, n_prompt, xkv, 1,
                            n_max=n_max, out=bad)


# ------------------------------------------ the benchmark's graph-step reader
MS = 1_000_000


def _share_run(monkeypatch, records):
    from gwt_bench import spans, specs
    from gwt_bench.devtrace import Trace
    monkeypatch.setattr(spans, "_all_records", lambda: list(records))
    spec = specs.metrics_of("turbo.batch.long")["graph_steps_share.serve"]
    trace = Trace(device=[("kernel", "a", 0, 10 * MS)],
                  host=[("gwt.batch", 0, 100 * MS)], launches=1)
    return specs.reader(spec), SimpleNamespace(trace=trace,
                                               trace_facts={"units": 1})


def _loop(start, **counts):
    return SimpleNamespace(name="gwt.token_loop", start_ns=start,
                           end_ns=start + 1, device_ms=None, counts=counts)


@pytest.mark.parametrize("counts,want", [
    ([dict(steps=101, graph_steps=101), dict(steps=25, graph_steps=25)],
     100.0),
    ([dict(steps=101, graph_steps=101), dict(steps=99, graph_steps=0)],
     50.5),
    ([dict(steps=3, graph_steps=0)], 0.0),
    ([dict(steps=101), dict(steps=25)], None),     # a port without graphs
    ([], None)])
def test_graph_steps_share_reader(monkeypatch, counts, want):
    """``graph_steps`` over ``steps`` of the window's token loops, in
    percent; None where the spans carry no ``graph_steps`` count or there
    is no loop; a loop after the window is left out."""
    recs = [_loop((1 + i) * MS, rung=0, **c) for i, c in enumerate(counts)]
    recs.append(_loop(200 * MS, rung=0, steps=5, graph_steps=0))
    read, run = _share_run(monkeypatch, recs)
    got = read(run)
    assert got == (None if want is None else pytest.approx(want))
    assert read(SimpleNamespace(trace=None, trace_facts={})) is None
