"""BENCHMARK.json and the files it names, found by name."""

import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(name: str) -> dict:
    """The workload entry `name`, with its config and traffic entries and files resolved."""
    bench = benchmark()
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = dict(found[0])
    entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    w["config_entry"] = entry
    w["config_data"] = json.loads((ROOT / entry["file"]).read_text())
    w["traffic_data"] = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    w["limits"] = json.loads((HERE / "limits" / f"{name}.json").read_text())
    w["end_to_end"] = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    w["per_layer"] = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]
    return w


def kernels() -> dict:
    """Every kernel file, by name."""
    return {p.stem: json.loads(p.read_text()) for p in sorted((HERE / "kernels").glob("*.json"))}


def reader_path(metric: str) -> Path:
    """readers/<name before the first dot>.py; every `<kernel>_roofline` is read by readers/roofline.py."""
    base = metric.split(".")[0]
    return HERE / "readers" / f"{'roofline' if base.endswith('_roofline') else base}.py"
