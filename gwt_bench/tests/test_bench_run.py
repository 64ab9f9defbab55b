"""A run of each entry kind at nano size on the CPU, through the harness's
own path (everything but its look for a card), and the no-JAX check."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from gwt_bench import nojax, run

REPO = Path(__file__).resolve().parents[2]


def cpu_run(name, roots, trace=False, seed=123456789012):
    return run.run_cell(name, seed, 0.5, trace, device="cpu", roots=roots,
                        setup_clock=lambda: 1.0)


@pytest.mark.parametrize("cell,e2e", [
    ("nano.batch", "audio_s_per_s"), ("nano.train", "train_samples_per_s")])
def test_dry_run_is_correct(cell, e2e, roots):
    out = cpu_run(cell, roots)
    assert out["correct"] is True
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {e2e, "setup_s"}
    assert out["metrics"]["setup_s"]["value"] == 1.0
    assert out["metrics"][e2e]["value"] > 0
    out.pop("_window")
    assert out["setup_built"] is False          # no cache on the CPU
    assert list(out)[-1] == "compared"          # the numbers come last
    for c in out["compared"].values():
        assert c["value"] <= c["limit"]
    json.dumps(out)


def test_traced_dry_run_reports_per_layer_metrics_only(roots):
    out = cpu_run("nano.batch", roots, trace=True)
    assert out["correct"] is True
    assert "audio_s_per_s" not in out["metrics"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["device"]["window_s"] > 0


def test_same_seed_same_work(roots):
    from gwt_bench import specs
    from gwt_bench.traffic import Traffic
    spec = specs.workload("nano.batch", roots)
    ta = Traffic(spec["traffic"], 7, "cpu")
    tb = Traffic(spec["traffic"], 7, "cpu")
    assert ta.requests(3) == tb.requests(3)
    assert (ta.clip(ta.requests(3)[0]) == tb.clip(tb.requests(3)[0])).all()
    tc = Traffic(spec["traffic"], 2 ** 31 + 11, "cpu")   # a large seed
    assert len(tc.requests(0)) == spec["traffic"]["batch"]


def test_nojax_compares_whole_top_level_names():
    assert nojax.loaded(["godot_whisper_tpu_torch", "godot_whisper_tpu_torch.ops",
                         "jaxtyping", "numpy"]) == []
    assert nojax.loaded(["jax.numpy", "numpy"]) == ["jax"]
    assert nojax.loaded(["godot_whisper_tpu.models", "flax"]) == [
        "flax", "godot_whisper_tpu"]


def test_harness_and_port_load_no_jax():
    code = ("import gwt_bench.run, gwt_bench.control, gwt_bench.entries.batch,"
            " gwt_bench.entries.train, godot_whisper_tpu_torch,"
            " godot_whisper_tpu_torch.models.training,"
            " godot_whisper_tpu_torch.parallel.batch\n"
            "from gwt_bench.nojax import loaded\n"
            "assert not loaded(), loaded()\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)


def test_main_refuses_without_a_card(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", "turbo.batch.long", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    cap = capsys.readouterr()
    assert rc == 2 and cap.out == ""


def test_only_the_benchmark_is_not_enough(tmp_path):
    """In a directory that holds the benchmark alone, a run fails and
    prints no result."""
    import shutil
    shutil.copytree(REPO / "gwt_bench", tmp_path / "gwt_bench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    p = subprocess.run([sys.executable, "-m", "gwt_bench.run", "--workload",
                        "turbo.batch.long", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True)
    assert p.returncode != 0 and p.stdout == ""
