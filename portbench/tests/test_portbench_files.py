"""Every cell of BENCHMARK.json finds its files by name, and the file keeps
to the contract's shape."""

import json
import re

import pytest

from portbench import loops, spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(w):
    cell = spec.cell(w["name"])
    assert cell["traffic_data"]["kind"] in loops.LOOPS
    assert (spec.ROOT / cell["config_data"]["scene"]).exists()
    assert set(cell["limits"]["limits"]) and all(v > 0 for v in cell["limits"]["limits"].values())
    assert cell["chips"] == 1
    names = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2 and cell["per_layer"]


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(c):
    data = json.loads((spec.ROOT / c["file"]).read_text())
    assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
    for key in c["reduced"]:
        assert data["published"][key] != data[key]
    for key, value in data["published"].items():
        assert key in c["reduced"] or data[key] == value


def test_names_units_and_lengths():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            assert (group, e["name"]) not in seen
            seen.add((group, e["name"]))
            for key in ("why", "layer", "source"):
                if key in e:
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_each_metric_has_a_reader(m):
    assert spec.reader_path(m["name"]).exists()
    if m["name"].endswith("_roofline"):
        assert m["name"][: -len("_roofline")] in spec.kernels()
    for w in m["workloads"]:
        moved = [e for e in BENCH["end_to_end"] if e["name"] == m["moves"]][0]
        assert w in moved.get("workloads", [w])


def test_layers_named_alike():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].split(" ")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
