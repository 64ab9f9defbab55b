"""The token loop's CUDA graph on the CPU: which windows replay it
(``decode/window.py::graph_eligible``), the step with its cache slot on
the device equal to the step with a host int, the caches written in place
for the graph's buffers equal to fresh ones, and the benchmark's reader of
the loop's ``graph_steps`` count.  The replay itself runs on the card
(``tests/test_torch_cuda.py -k graph``)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from godot_whisper_tpu_torch.decode.window import (StepGraphs, WindowStatics,
                                                   graph_eligible,
                                                   prompt_pass_grouped,
                                                   use_split_cache)
from godot_whisper_tpu_torch.models import model as tm
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


# route -> (WindowStatics overrides, device, replays the graph)
ROUTES = {
    "cpu": ({}, "cpu", False),
    "beam_split": ({"strategy": "beam"}, "cuda:0", False),
    "beam_merged": ({"strategy": "beam", "force_merged_cache": True},
                    "cuda:0", False),
    "tp": ({"tp": SimpleNamespace(rank=0, size=2)}, "cuda:0", False),
    "cuda_greedy": ({}, "cuda:0", True),
    "cuda_sampling": ({"greedy_argmax": False}, "cuda", True),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_graph_eligibility_by_route(nano, route):
    """Decided from the statics and the device alone: CUDA tensors on one
    device outside beam search replay the graph; the CPU, both beam caches
    and tensor parallelism run eagerly."""
    over, device, want = ROUTES[route]
    st = statics(nano[0], **over)
    if route.startswith("beam"):
        assert use_split_cache(st) == (route == "beam_split")
    assert graph_eligible(st, torch.device(device)) is want
    assert graph_eligible(st, device) is want


def test_cpu_windows_hold_no_graph(nano):
    """On the CPU ``StepGraphs.cross_kv`` gives a new cross-KV each call,
    equal to ``models/model.py``'s, keeps no buffer, and no window gets a
    graph."""
    cfg, params = nano
    graphs = StepGraphs()
    enc = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, cfg.n_audio_ctx, cfg.n_audio_state)).astype(np.float32))
    xkv = graphs.cross_kv(params, cfg, enc, False)
    want = tm.cross_kv(params, cfg, enc)
    assert torch.equal(xkv.k, want.k) and torch.equal(xkv.v, want.v)
    assert graphs.cross_kv(params, cfg, enc, False).k is not xkv.k
    assert graphs.get(params, statics(cfg, batch=10, kv_group=5), xkv) is None
    assert graphs._xkv is None and graphs._graph is None


def _stub_graph(st, device, cdtype, xkv):
    return SimpleNamespace(st=st, xkv=xkv, kv=None)


@pytest.mark.parametrize("quant", [False, True])
def test_step_graphs_keep_one_buffer_and_one_shape(nano, monkeypatch,
                                                   quant):
    """With the CPU taken for one CUDA device (and a stub for the
    capture): ``cross_kv`` writes every window into one buffer, equal to a
    new cross-KV; ``get`` keeps one captured shape, made anew when the
    shape changes; beam, tp, a cross-KV made elsewhere and other weights
    get none; a cross-KV of another shape, or other weights, drop the
    buffer with the graph."""
    from godot_whisper_tpu_torch.decode import window as W
    monkeypatch.setattr(W, "_one_cuda_device", lambda device, tp: tp is None)
    monkeypatch.setattr(W, "StepGraph", _stub_graph)
    cfg, params = nano
    rng = np.random.default_rng(1)

    def enc(g):
        return torch.from_numpy(rng.standard_normal(
            (g, cfg.n_audio_ctx, cfg.n_audio_state)).astype(np.float32))

    def fresh(e):
        x = tm.cross_kv(params, cfg, e)
        return tm.quantize_cross_kv(x, cfg.n_text_head) if quant else x

    graphs = StepGraphs()
    e1, e2 = enc(2), enc(2)
    x1 = graphs.cross_kv(params, cfg, e1, quant)
    x2 = graphs.cross_kv(params, cfg, e2, quant)
    assert x2[0] is x1[0] and x2.t_valid == cfg.n_audio_ctx
    for a, b in zip(x2[:-1], fresh(e2)[:-1]):
        assert a.dtype == b.dtype and torch.equal(a, b)

    st = statics(cfg, batch=10, kv_group=5)
    g = graphs.get(params, st, x2)
    assert g is not None and g.xkv[0] is x2[0]
    assert graphs.get(params, st, x2) is g
    g16 = graphs.get(params, statics(cfg, batch=10, kv_group=5,
                                     prompt_pad=16), x2)
    again = graphs.get(params, st, x2)
    assert g16 is not g and again is not g and again is not g16
    assert graphs.get(params, statics(cfg, strategy="beam"), x2) is None
    assert graphs.get(params, statics(cfg, tp=SimpleNamespace()), x2) is None
    assert graphs.get(params, st, fresh(e2)) is None
    assert graphs.get(dict(params), st, x2) is None

    x3 = graphs.cross_kv(params, cfg, enc(3), quant)
    assert x3[0] is not x1[0] and graphs._graph is None
    assert graphs.cross_kv(params, cfg, enc(3), quant)[0] is x3[0]
    other = dict(params)
    assert graphs.cross_kv(other, cfg, enc(3), quant)[0] is not x3[0]
    x4 = graphs.cross_kv(params, cfg, enc(3), quant, tp=SimpleNamespace(
        rank=0, size=1))
    assert x4[0] is not graphs._xkv[0]


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
