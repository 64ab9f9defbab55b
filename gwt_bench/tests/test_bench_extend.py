"""A cell, a configuration and a per-layer metric added as new files in a
directory of their own, with no file of the harness edited."""

import hashlib
import json
from pathlib import Path

from gwt_bench import run, specs
from gwt_bench.tests.conftest import DATA

HARNESS = Path(specs.__file__).resolve().parent


def digest():
    h = hashlib.sha256()
    for p in sorted(HARNESS.rglob("*")):
        if p.is_file() and ".cache" not in p.parts \
                and "__pycache__" not in p.parts:
            h.update(str(p).encode())
            h.update(p.read_bytes())
    return h.hexdigest()


def test_new_cell_config_and_metric_as_files(tmp_path):
    before = digest()
    for sub in ("configs", "workloads", "metrics"):
        (tmp_path / sub).mkdir()
    cfg = json.loads((DATA / "configs" / "nano.json").read_text())
    cfg["port_name"] = "pico"
    cfg["decoder_layers"] = 2
    (tmp_path / "configs" / "pico.json").write_text(json.dumps(cfg))
    cell = json.loads((DATA / "workloads" / "nano.batch.json").read_text())
    cell["config"] = "pico"
    cell["traffic"]["batch"] = 2
    (tmp_path / "workloads" / "pico.batch.json").write_text(json.dumps(cell))
    (tmp_path / "metrics" / "windows_traced.pico.json").write_text(json.dumps(
        {"unit": "windows", "better": "higher", "source": "program_counter",
         "layer": "clip and token loop", "moves": "audio_s_per_s",
         "workloads": ["pico.batch"]}))
    (tmp_path / "metrics" / "windows_traced.pico.py").write_text(
        "def read(run):\n    return run.trace_facts.get('windows')\n")

    roots = [tmp_path, DATA]
    assert specs.config("pico", roots)["decoder_layers"] == 2
    assert set(specs.metrics_of("pico.batch", roots)) == {
        "windows_traced.pico"}
    out = run.run_cell("pico.batch", 99, 0.2, True, device="cpu",
                       roots=roots, setup_clock=lambda: 0.0)
    assert out["correct"] is True
    assert out["metrics"]["windows_traced.pico"]["value"] >= 2
    assert out["metrics"]["windows_traced.pico"]["unit"] == "windows"
    assert digest() == before
