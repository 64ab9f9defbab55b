"""The Uni-MoE-2.0-Omni cell's harness on the CPU at pico size (the cell
``pico.omni`` under ``data/``, float32): a sound run is correct and
reports the routing metrics; each fault planted in the program's routing
(top-p ignored, weights renormalised, shared experts dropped) and the
fp8 reference in the program's place come out not correct; the parent's
program, without the LM path, stops at once; and the work counts at the
published widths."""

import json

import pytest

from gwt_bench import control_unimoe, run, specs, work_unimoe


def cpu_run(roots, trace=False, seed=2**31 + 11):
    return run.run_cell("pico.omni", seed, 0.2, trace, device="cpu",
                        roots=roots, setup_clock=lambda: 0.0)


def test_sound_run_is_correct_and_counts_routing(roots, tmp_path):
    (tmp_path / "metrics").mkdir()
    for name in ("routed_per_token.omni", "null_share.omni",
                 "prefill_ms_per_window.omni"):
        spec = json.loads((specs.ROOT / "metrics" / f"{name}.json")
                          .read_text())
        spec["workloads"] = ["pico.omni"]
        (tmp_path / "metrics" / f"{name}.json").write_text(json.dumps(spec))
        (tmp_path / "metrics" / f"{name}.py").write_text(
            (specs.ROOT / "metrics" / f"{name}.py").read_text())
    out = cpu_run([tmp_path] + roots, trace=True)
    assert out["correct"] is True, out["compared"]
    assert out["failed"] == 0 and out["attempted"] >= 2
    m = out["metrics"]
    assert 0.0 < m["routed_per_token.omni"]["value"] < 2.0
    assert 0.0 < m["null_share.omni"]["value"] < 100.0
    assert "prefill_ms_per_window.omni" not in m     # no CUDA events


@pytest.mark.parametrize("fault", ["top2", "renorm", "no_shared"])
def test_routing_faults_are_caught(roots, fault):
    """Each fault fails the check; top-p ignored shows in the sets alone
    (the reference routed by them computes what the program did)."""
    with control_unimoe.PLANTED[fault]():
        out = cpu_run(roots)
    assert out["correct"] is False, out["compared"]
    c = out["compared"]
    if fault == "top2":
        assert c["route_far"]["value"] > c["route_far"]["limit"]
        assert c["logprob_q50"]["value"] <= c["logprob_q50"]["limit"]


def test_fp8_reference_control_fails(roots):
    spec = specs.workload("pico.omni", roots)
    cfg = specs.config(spec["config"], roots)
    got = control_unimoe.omni_readings(cfg, spec, 3, "sound", 1, "cpu",
                                       ("f32", "fp8"))
    assert got["f32"]["correct"] and not got["fp8"]["correct"], got
    assert got["f32"]["route_far"] < 1e-5


def test_parent_program_stops_at_once(roots, monkeypatch):
    """A program without ``decode/omni.py`` raises on import in set-up,
    before a weight is drawn."""
    import builtins
    real = builtins.__import__

    def no_omni(name, *a, **kw):
        if name.endswith("decode.omni") or (a and a[2] and "omni" in a[2]
                                            and "decode" in name):
            raise ModuleNotFoundError(name)
        return real(name, *a, **kw)

    from gwt_bench import weights_unimoe
    monkeypatch.setattr(builtins, "__import__", no_omni)
    monkeypatch.setattr(weights_unimoe, "draw", lambda *a, **k: 1 / 0)
    with pytest.raises(ModuleNotFoundError):
        cpu_run(roots)


def test_step_counts_at_published_widths():
    """A decode step of 32 rows with every routed expert hit reads the
    whole LM once (25.06 B layer parameters and the 0.54 B head, bf16) and
    the live K/V; 4 experts x 28 layers are 91% of it."""
    cfg = specs.config("uni-moe-2.0-omni")
    w = work_unimoe.decode_steps(cfg, 32, 216, 1, 4 * 28, 2 * 28 * 32)
    experts = 4 * 28 * work_unimoe.expert_params(cfg) * 2
    assert 51.2e9 < w["bytes"] < 52.0e9
    assert 0.88 < experts / w["bytes"] < 0.92
    a = work_unimoe.gqa_attention(cfg, 32, 216, 1)
    assert a["bytes"] == pytest.approx(
        (2 * 217 * 512 * 2 + 3584 * 6) * 28 * 32)


@pytest.mark.parametrize("base", [
    "encode_ms_per_window", "graph_steps_share", "loop_idle_ms_per_step",
    "loop_busy_ms_per_step", "launches_per_step"])
def test_omni_twins_read_as_the_serve_metrics(monkeypatch, base):
    """The five ``.omni`` twins of the serving cells' loop and encoder
    metrics are listed for this cell only and give their ``.serve``
    reader's number on hand-made records, and None where it finds
    nothing."""
    from types import SimpleNamespace

    from gwt_bench import spans
    from gwt_bench.devtrace import Trace

    ms = 1_000_000
    twin = specs.metrics_of("unimoe.batch.20s")[base + ".omni"]
    serve = specs.metrics_of("turbo.batch.long")[base + ".serve"]
    assert twin["workloads"] == ["unimoe.batch.20s"]
    assert base + ".omni" not in specs.metrics_of("turbo.batch.long")
    assert base + ".serve" not in specs.metrics_of("unimoe.batch.20s")
    got, want = specs.reader(twin), specs.reader(serve)

    def rec(name, start, device_ms=None, **counts):
        return SimpleNamespace(name=name, start_ns=start, end_ns=start + 1,
                               device_ms=device_ms, counts=counts)

    tr = Trace(device=[("kernel", "a", 0, 10 * ms),
                       ("kernel", "b", 15 * ms, 30 * ms)],
               host=[("gwt.batch", 0, 100 * ms),
                     ("gwt.token_loop", 5 * ms, 45 * ms)], launches=7)
    monkeypatch.setattr(spans, "_all_records", lambda: [
        rec("gwt.encode", 1 * ms, 30.0, rows=32),
        rec("gwt.token_loop", 5 * ms, steps=101, graph_steps=100)])
    run_ = SimpleNamespace(trace=tr, trace_facts={"decode_steps": 101})
    assert got(run_) is not None and got(run_) == want(run_)
    none = SimpleNamespace(trace=None, trace_facts={})
    monkeypatch.setattr(spans, "_all_records", lambda: [])
    assert got(none) is None and want(none) is None
