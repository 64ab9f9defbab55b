"""The program's spans in a traced run (``spans.py``) and the readers of
the five metrics that read them, on traces and records made by hand."""

from types import SimpleNamespace

import pytest
from pytest import approx

from gwt_bench import spans, specs
from gwt_bench.devtrace import Trace

MS = 1_000_000                       # ns


def rec(name, start, device_ms=None, **counts):
    return SimpleNamespace(name=name, start_ns=start, end_ns=start + 1,
                           device_ms=device_ms, counts=counts)


# device busy 0-10, 15-30 and 50-60 ms; the token loop's ranges 5-20 and
# 25-45 ms (one of them inside a longer host op), the window 0-100 ms
TR = Trace(
    device=[("kernel", "a", 0, 10 * MS), ("kernel", "b", 15 * MS, 30 * MS),
            ("gpu_memcpy", "Memcpy DtoH", 50 * MS, 60 * MS)],
    host=[("gwt.batch", 0, 100 * MS), ("gwt.token_loop", 5 * MS, 20 * MS),
          ("gwt.token_loop", 25 * MS, 45 * MS), ("aten::mm", 26 * MS,
                                                   27 * MS)],
    launches=3)
RECORDS = [rec("gwt.encode", 1 * MS, 30.0, rows=4),
           rec("gwt.encode", 60 * MS, 34.0, rows=4),
           rec("gwt.encode", 200 * MS, 99.0, rows=4),     # after the window
           rec("gwt.token_loop", 5 * MS, steps=3),
           rec("gwt.token_loop", 25 * MS, steps=2),
           rec("gwt.attn_recompute", 2 * MS, 1.5, rows=24),
           rec("gwt.attn_recompute", 3 * MS, 2.5, rows=24),
           rec("gwt.train.optimizer", 4 * MS, 7.0, leaves=50)]


def run_of(trace=TR, units=2):
    return SimpleNamespace(trace=trace, trace_facts={"units": units})


@pytest.fixture
def records(monkeypatch):
    monkeypatch.setattr(spans, "_all_records", lambda: list(RECORDS))


def reader(name):
    cell = "small.train" if name.endswith(".train") else "turbo.batch.long"
    return specs.reader(specs.metrics_of(cell)[name])


def test_window_records_and_counts(records):
    run = run_of()
    assert spans.window(run) == (0, 100 * MS)
    late = TR._replace(device=TR.device + [("kernel", "adam", 150 * MS,
                                             210 * MS)])
    assert spans.window(run_of(late)) == (0, 210 * MS)
    assert len(spans.records(run_of(late), "gwt.encode")) == 3
    assert spans.window(run_of(Trace([], [], 0))) is None
    assert [r.start_ns for r in spans.records(run, "gwt.encode")] == [
        1 * MS, 60 * MS]
    assert spans.device_ms(run, "gwt.encode") == approx(64.0)
    assert spans.count(run, "gwt.encode", "rows") == 8
    assert spans.device_ms(run, "gwt.token_loop") is None
    assert spans.count(run, "gwt.token_loop", "steps") == 5


def test_inside_splits_the_ranges_into_busy_and_idle():
    busy, idle = spans.inside(run_of(), "gwt.token_loop")
    assert busy == (5 + 5 + 5) * MS              # 5-10, 15-20, 25-30
    assert idle == (15 + 20) * MS - busy
    assert spans.inside(run_of(), "gwt.nothing") is None
    assert spans.inside(run_of(None), "gwt.token_loop") is None
    assert spans.intersection_ns([(0, 10), (20, 30)],
                                 [(5, 25), (29, 40)]) == 5 + 5 + 1


@pytest.mark.parametrize("name,value", [
    ("encode_ms_per_window.serve", 64.0 / 8),
    ("loop_idle_ms_per_step.serve", 20.0 / 5),
    ("loop_busy_ms_per_step.serve", 15.0 / 5),
    ("recompute_ms_per_step.train", 4.0 / 2),
    ("optimizer_ms_per_step.train", 7.0 / 2)])
def test_readers(records, name, value):
    assert reader(name)(run_of()) == approx(value)


@pytest.mark.parametrize("name", [
    "encode_ms_per_window.serve", "loop_idle_ms_per_step.serve",
    "loop_busy_ms_per_step.serve", "recompute_ms_per_step.train",
    "optimizer_ms_per_step.train"])
def test_readers_find_nothing(monkeypatch, name):
    """No trace; a program whose tracer keeps no records (an older port):
    every reader returns None and raises nothing."""
    read = reader(name)
    assert read(run_of(None)) is None
    monkeypatch.setattr(spans, "_all_records", lambda: [])
    no_loop = TR._replace(host=[h for h in TR.host
                                if h[0] != "gwt.token_loop"])
    assert read(run_of(no_loop)) is None
    assert read(run_of(TR, units=0)) is None


def test_records_of_a_tracer_without_records(monkeypatch):
    from godot_whisper_tpu_torch.runtime import trace
    monkeypatch.setattr(trace, "tracer", SimpleNamespace(events=[]))
    assert spans._all_records() == []
    assert spans.records(run_of(), "gwt.encode") == []


def test_cpu_records_have_no_device_time(monkeypatch):
    """The tracer's own records, made on the CPU: counts, no device ms, so
    the device-time readers return None there."""
    from godot_whisper_tpu_torch.runtime.trace import tracer
    monkeypatch.setattr(tracer, "enabled", True)
    tracer.clear()
    try:
        import torch
        with tracer.span("gwt.encode", device=torch.device("cpu"), rows=3):
            pass
        got = [r for r in spans._all_records() if r.name == "gwt.encode"]
        assert len(got) == 1 and got[0].counts == {"rows": 3}
        lo = got[0].start_ns - MS
        run = run_of(TR._replace(host=[("gwt.batch", lo, lo + 100 * MS)]))
        assert reader("encode_ms_per_window.serve")(run) is None
    finally:
        tracer.clear()
