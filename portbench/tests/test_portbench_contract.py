"""BENCHMARK.json keeps to the benchmark's contract, and every file it
names is found by name."""
import json
import os

import pytest

from portbench import bench

ROOT = bench.ROOT
DATA = bench.load().data
CELLS = [w["name"] for w in DATA["workloads"]]
METRICS = DATA["end_to_end"] + DATA["per_layer"]


def test_keys_and_command():
    assert set(DATA) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert DATA["paths"] == ["portbench"]
    assert DATA["command"][1] == "portbench/run.py"
    assert all(not w.startswith("/") and ".." not in w for w in DATA["command"])
    assert isinstance(DATA["run_seconds"], int) and 1 <= DATA["run_seconds"] <= 51
    assert len(json.dumps(DATA)) <= 64 * 1024


def test_names_and_units():
    names = ([c["name"] for c in DATA["configs"]] + CELLS + [m["name"] for m in METRICS]
             + [w["traffic"] for w in DATA["workloads"]])
    for n in names:
        assert bench.NAME.match(n), n
    for m in METRICS:
        assert bench.UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = [x["name"] for x in DATA[group]]
        assert len(seen) == len(set(seen)), group


def test_entry_keys():
    for c in DATA["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["reduced"] == [] and 1 <= len(c["source"]) <= 200 and len(c["why"]) <= 200
    for w in DATA["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in DATA["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in DATA["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = bench.load().cell(cell)
    assert os.path.exists(bench.driver_path(c.traffic))
    assert c.config["name"] == c.config_name
    entry = {x["name"]: x for x in DATA["configs"]}[c.config_name]
    assert entry["file"] == f"portbench/configs/{c.config_name}.json"
    src = {x["name"]: x["source"] for x in DATA["configs"]}[c.config_name]
    assert c.config["source"] == src
    for name, limit in c.limits.items():
        if isinstance(limit, dict):
            assert limit["limit"] >= 0, name


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    c = bench.load().cell(cell)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e, (m["name"], cell)


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_every_metric_has_a_reader(metric):
    assert bench.reader_path(metric) is not None


def test_config_files_hold_the_published_widths():
    import yaml

    for c, yml in (("celebahq-ddpmpp-256", "custom.yml"), ("afhq-iddpm-256", "afhq.yml")):
        with open(os.path.join(ROOT, "portbench", "configs", c + ".json")) as f:
            got = json.load(f)
        with open(os.path.join(ROOT, "asyrp_official_torch", "configs", yml)) as f:
            want = yaml.safe_load(f)
        for k in ("data", "model", "diffusion"):
            assert got[k] == want[k], (c, k)
