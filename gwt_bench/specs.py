"""Find a cell, its configuration and its metrics by name.

Everything that belongs to one configuration, one cell or one per-layer
metric is a file of its own under a root directory:

    <root>/configs/<config>.json      published widths, dtype, token ids
    <root>/workloads/<cell>.json      config, chips, entry kind, traffic,
                                      decode or train parameters, limits
    <root>/metrics/<metric>.json      unit, direction, layer, moves, cells
    <root>/metrics/<metric>.py        its reader: read(run) -> float | None

The harness's own root is this directory.  Callers may put other roots in
front (the tests add cells, configurations and metrics from a temporary
directory this way), so a later cell is added as files, never as an edit.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

ROOT = Path(__file__).resolve().parent


def roots_of(roots: Optional[Sequence[Path]]) -> List[Path]:
    """The search path: the callers' roots first, then the harness's."""
    out = [Path(r) for r in (roots or ())]
    if ROOT not in out:
        out.append(ROOT)
    return out


def _find(kind: str, name: str, suffix: str, roots) -> Path:
    for root in roots_of(roots):
        path = root / kind / f"{name}{suffix}"
        if path.is_file():
            return path
    raise FileNotFoundError(f"no {kind[:-1]} named {name!r} "
                            f"(looked for {kind}/{name}{suffix})")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def config(name: str, roots=None) -> dict:
    return load_json(_find("configs", name, ".json", roots))


def workload(name: str, roots=None) -> dict:
    spec = load_json(_find("workloads", name, ".json", roots))
    spec["name"] = name
    return spec


def metric(name: str, roots=None) -> dict:
    spec = load_json(_find("metrics", name, ".json", roots))
    spec["name"] = name
    return spec


def metrics_of(cell: str, roots=None) -> Dict[str, dict]:
    """Every per-layer metric whose file lists ``cell``, by name (the first
    root that holds a name wins)."""
    out: Dict[str, dict] = {}
    for root in roots_of(roots):
        for path in sorted((root / "metrics").glob("*.json")):
            name = path.name[:-len(".json")]
            if name in out:
                continue
            spec = load_json(path)
            if spec.get("end_to_end"):
                continue
            if cell in spec.get("workloads", ()):
                spec["name"] = name
                spec["_reader"] = str(path.with_suffix(".py"))
                out[name] = spec
    return out


def reader(spec: dict):
    """The ``read`` function of a per-layer metric's module."""
    path = Path(spec["_reader"])
    mod_name = "gwt_bench_metric_" + spec["name"].replace(".", "_")
    loader = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(module)
    return module.read
