"""The port's tracer (``runtime/trace.py``) and its spans on the CPU.

Off, a span is the shared no-op object and records nothing.  Under the
profiler every ``gwt.*`` span of a batch opens a range of its name on the
profiler's clock, nests as the layers do, and counts what the layer did;
the token loop's ``steps`` add up to ``Timings.n_decode``.  The recompute
backward and AdamW record their spans; ``dump`` writes Chrome JSON on the
same epoch.
"""

import json
import threading

import numpy as np
import pytest
import torch

import godot_whisper_tpu_torch as gt
from godot_whisper_tpu_torch.models import training as tt
from godot_whisper_tpu_torch.ops import attention as A
from godot_whisper_tpu_torch.parallel.batch import BatchTranscriber
from godot_whisper_tpu_torch.runtime import trace
from godot_whisper_tpu_torch.runtime.trace import tracer
from gwt_bench import devtrace

PARAMS = dict(best_of=1, temperature_inc=0.0, entropy_thold=-1e9,
              logprob_thold=-1e9, max_tokens=6, no_timestamps=True)

# the span that encloses each one in a batch of the clip path
PARENT = {"gwt.batch": None, "gwt.mel": "gwt.batch",
          "gwt.clip": "gwt.batch", "gwt.emit": "gwt.batch",
          "gwt.encode": "gwt.clip", "gwt.cross_kv": "gwt.clip",
          "gwt.prompt": "gwt.clip", "gwt.token_loop": "gwt.clip",
          "gwt.gates": "gwt.clip", "gwt.step.state": "gwt.token_loop",
          "gwt.step.sample": "gwt.token_loop",
          "gwt.step.forward": "gwt.token_loop"}
COUNTS = {"gwt.batch": {"clips"}, "gwt.mel": {"clips", "h2d_bytes"},
          "gwt.clip": {"streams"}, "gwt.encode": {"rows"},
          "gwt.cross_kv": {"rows"}, "gwt.prompt": {"rung", "rows"},
          "gwt.token_loop": {"rung", "steps", "graph_steps"},
          "gwt.emit": {"windows"}}


@pytest.fixture(autouse=True)
def quiet_tracer(monkeypatch):
    """Each test starts with the tracer off and empty, and leaves it so;
    torch on one thread (the CPU is shared with other test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(tracer, "enabled", False)
    tracer.clear()
    yield
    tracer.clear()
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def batch():
    """A nano context whose end-of-text embedding row is scaled down, so
    every window decodes ``max_tokens`` + 1 steps, and two clips."""
    cfg = gt.get_config("tiny.en").replace(
        n_audio_layer=1, n_text_layer=2, n_audio_state=64, n_audio_head=2,
        n_text_state=64, n_text_head=2)
    params = gt.init_params(cfg, seed=5, compute_dtype=torch.float32,
                            device="cpu")
    params["decoder"]["token_embed"][cfg.token_eot] *= 1e-3
    ctx = gt.WhisperContext.from_params(cfg, params, device="cpu")
    x = (0.2 * np.sin(np.arange(40000) * 0.05)).astype(np.float32)
    bt = BatchTranscriber(ctx)
    clips = [x, x[:24000]]
    return ctx, bt, clips


def test_off_span_is_the_shared_no_op(batch):
    ctx, bt, clips = batch
    assert tracer.span("gwt.x", rows=1) is trace.OFF
    with tracer.span("gwt.x") as sp:
        sp.set(steps=3)
    bt.transcribe(clips, gt.TranscribeParams(**PARAMS))
    assert tracer.records() == []


def test_profiled_batch_opens_every_span_as_a_range(batch):
    ctx, bt, clips = batch
    tp = gt.TranscribeParams(**PARAMS)
    with devtrace.profiler():         # the first range of a process loads
        bt.transcribe(clips, tp)      # the profiler's op: not timed here
    tracer.clear()
    n0 = ctx.timings.n_decode
    with devtrace.profiler() as prof:
        bt.transcribe(clips, tp)
    recs = tracer.records()
    host = sorted((h for h in devtrace.events(prof).host
                   if h[0].startswith("gwt.")), key=lambda h: h[1])
    assert {r.name for r in recs} == set(PARENT)
    assert [h[0] for h in host] == [r.name for r in
                                    sorted(recs, key=lambda r: r.start_ns)]
    for (_, s, e), r in zip(host, sorted(recs, key=lambda r: r.start_ns)):
        assert abs(s - r.start_ns) < 1e6 and abs(e - r.end_ns) < 1e6
        assert s <= r.start_ns <= r.end_ns <= e
    by_id = {r.id: r for r in recs}
    for r in recs:
        parent = by_id[r.parent].name if r.parent else None
        assert parent == PARENT[r.name], r.name
        assert set(r.counts) == COUNTS.get(r.name, set()), r.name
        assert r.device_ms is None                    # no card
    loops = [r for r in recs if r.name == "gwt.token_loop"]
    assert sum(r.counts["steps"] for r in loops) == \
        ctx.timings.n_decode - n0 == PARAMS["max_tokens"] + 1
    assert all(r.counts["graph_steps"] == 0 for r in loops)   # CPU: eager
    steps = sum(r.name == "gwt.step.sample" for r in recs)
    assert steps == PARAMS["max_tokens"] + 1
    assert sum(r.name == "gwt.step.forward" for r in recs) == steps - 1
    assert [r.counts["rows"] for r in recs if r.name == "gwt.encode"] == [2]


def test_token_loop_steps_sum_to_n_decode_over_a_window(batch):
    """Several batches in a row, tracer on: the token loops' ``steps``
    equal the change in ``Timings.n_decode``, window for window."""
    ctx, bt, clips = batch
    tracer.enable()
    n0 = ctx.timings.n_decode
    for j in range(3):
        bt.transcribe([c[: len(c) - 4000 * j] for c in clips],
                      gt.TranscribeParams(**dict(PARAMS, max_tokens=2 + j)))
    loops = [r for r in tracer.records() if r.name == "gwt.token_loop"]
    assert len(loops) == 3
    assert sum(r.counts["steps"] for r in loops) == ctx.timings.n_decode - n0


def test_mel_span_counts_the_samples_shipped(batch):
    """``gwt.mel``'s ``h2d_bytes`` is 4 bytes a real sample of the batch's
    clips (the padding is made on the device), batch after batch."""
    ctx, bt, clips = batch
    tracer.enable()
    tp = gt.TranscribeParams(**dict(PARAMS, max_tokens=1))
    bt.transcribe(clips, tp)
    bt.transcribe([clips[1][:7001]], tp)
    mels = [r for r in tracer.records() if r.name == "gwt.mel"]
    assert [r.counts["h2d_bytes"] for r in mels] == [
        4 * sum(len(c) for c in clips), 4 * 7001]


def test_per_window_path_spans(batch):
    """A progress callback takes the per-window path: ``gwt.window`` holds
    the prompt pass and the token loop, the encoder and cross K/V run
    before it."""
    ctx, _, clips = batch
    tracer.enable()
    ctx.full(gt.TranscribeParams(**PARAMS, progress_callback=lambda *a: 0),
             clips[1])
    recs = tracer.records()
    by_id = {r.id: r for r in recs}
    parents = {r.name: by_id[r.parent].name if r.parent else None
               for r in recs}
    assert parents["gwt.prompt"] == parents["gwt.token_loop"] == "gwt.window"
    assert parents["gwt.step.sample"] == "gwt.token_loop"
    assert {"gwt.mel", "gwt.encode", "gwt.cross_kv"} <= set(parents)


@pytest.mark.parametrize("on", ["enabled", "profiler"])
def test_recompute_backward_records_one_span_per_backward(on):
    gen = torch.Generator().manual_seed(0)
    q, k, v, w = (torch.randn(3, 40, 32, generator=gen) for _ in range(4))
    plain = A.attention_bh_sp_plain

    def step():
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        A.RecomputeAttention.apply(*xs, 33, plain, plain).backward(w)

    if on == "enabled":
        tracer.enable()
        step()
        step()
    else:
        with devtrace.profiler() as prof:
            step()
            step()
        names = [h[0] for h in devtrace.events(prof).host]
        assert names.count("gwt.attn_recompute") == 2
    recs = [r for r in tracer.records() if r.name == "gwt.attn_recompute"]
    assert len(recs) == 2
    assert all(r.counts == {"rows": 3} for r in recs)


def test_train_step_records_the_optimizer_span():
    cfg = gt.get_config("tiny.en").replace(
        n_audio_layer=1, n_text_layer=1, n_audio_state=64, n_audio_head=2,
        n_text_state=64, n_text_head=2, n_audio_ctx=32)
    state = tt.init_train_state(gt.init_params(
        cfg, seed=1, compute_dtype=torch.float32, device="cpu"), lr=1e-3)
    rng = np.random.default_rng(0)
    batch = {"mel": rng.standard_normal((2, 64, 80)).astype(np.float32),
             "tokens": rng.integers(0, 100, (2, 6)).astype(np.int64),
             "targets": rng.integers(0, 100, (2, 6)).astype(np.int64),
             "mask": np.ones((2, 6), np.float32)}
    tracer.enable()
    tt.train_step(state, cfg, batch, lr=1e-3, device="cpu")
    recs = [r for r in tracer.records() if r.name == "gwt.train.optimizer"]
    assert len(recs) == 1
    from godot_whisper_tpu_torch.models.params import tree_leaves
    assert recs[0].counts == {"leaves": len(tree_leaves(state.params))}


def test_parents_are_per_thread():
    tracer.enable()
    seen = {}

    def worker():
        with tracer.span("gwt.inner") as sp:
            seen["parent"] = sp.parent

    with tracer.span("gwt.outer") as outer:
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=30)
        with tracer.span("gwt.inner") as inner:
            pass
    assert not t.is_alive()
    assert seen["parent"] is None and inner.parent == outer.id
    assert {r.thread for r in tracer.records()} == {
        threading.get_native_id(), t.native_id}


def test_dump_is_chrome_json_on_the_epoch(tmp_path):
    tracer.enable()
    with tracer.span("gwt.outer", rows=4) as outer:
        with tracer.span("gwt.inner") as sp:
            sp.set(steps=7)
    path = tmp_path / "trace.json"
    tracer.dump(str(path))
    ev = {e["name"]: e for e in json.loads(path.read_text())["traceEvents"]}
    assert ev["gwt.outer"]["ts"] == outer.start_ns / 1e3
    assert ev["gwt.outer"]["ph"] == "X" and ev["gwt.outer"]["dur"] >= 0
    assert ev["gwt.outer"]["args"] == {"rows": 4, "id": outer.id,
                                       "parent": None}
    assert ev["gwt.inner"]["args"] == {"steps": 7, "id": sp.id,
                                       "parent": outer.id}
    assert "device_ms" not in ev["gwt.inner"]["args"]
