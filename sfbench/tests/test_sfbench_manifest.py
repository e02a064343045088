"""`BENCHMARK.json` against the benchmark's contract, the files it names,
the modules a run imports, and the shape of a run's last line."""

import ast
import json
import re
import subprocess
import sys

import pytest

from sfbench.tests._cells import MANIFEST, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
E2E = {m["name"]: m for m in MANIFEST["end_to_end"]}
CELLS = {w["name"]: w for w in MANIFEST["workloads"]}
MODULES = sorted(p for p in (ROOT / "sfbench").rglob("*.py")
                 if "tests" not in p.parts)


def _names():
    out = [c["name"] for c in MANIFEST["configs"]]
    out += [k for c in MANIFEST["configs"] for k in c["reduced"]]
    out += [w[k] for w in MANIFEST["workloads"]
            for k in ("name", "config", "traffic")]
    out += [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    return out


def test_top_level_keys_and_paths():
    assert set(MANIFEST) == KEYS
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    cmd = MANIFEST["command"]
    assert 1 <= len(cmd) <= 32
    for word in cmd:
        assert 1 <= len(word) <= 200 and "\n" not in word and "\t" not in word
        if "/" in word:
            assert any(word.startswith(p + "/") for p in MANIFEST["paths"])


@pytest.mark.parametrize("name", _names())
def test_name_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", MANIFEST["end_to_end"]
                         + MANIFEST["per_layer"], ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    allowed = {"name", "unit", "better", "source", "workloads"}
    if metric in MANIFEST["end_to_end"]:
        allowed |= {"bound"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        allowed |= {"layer", "moves"}
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert 1 <= len(metric["layer"]) <= 200
        assert "\n" not in metric["layer"]
    assert set(metric) <= allowed


def test_unique_names_and_limits():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in MANIFEST[group]]
        assert len(names) == len(set(names)) and 1 <= len(names) <= 24
    metrics = [m["name"] for m in MANIFEST["end_to_end"]
               + MANIFEST["per_layer"]]
    assert len(metrics) == len(set(metrics))
    assert 1 <= len(MANIFEST["end_to_end"]) <= 16
    assert 1 <= len(MANIFEST["per_layer"]) <= 128
    assert "setup_s" in E2E and E2E["setup_s"]["bound"] <= 0.25
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fits_a_full_check():
    rs = MANIFEST["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_chips():
    chips = [w["chips"] for w in MANIFEST["workloads"]]
    assert set(chips) <= {1, 4}
    assert sum(c == 4 for c in chips) <= max(1, len(chips) // 4)


@pytest.mark.parametrize("conf", MANIFEST["configs"], ids=lambda c: c["name"])
def test_config_file(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert any(conf["file"].startswith(p + "/") for p in MANIFEST["paths"])
    data = json.loads((ROOT / conf["file"]).read_text())
    assert data["name"] == conf["name"]
    assert len(conf["reduced"]) <= 16
    for key in conf["reduced"]:
        assert key in data and not key.endswith(("_dim", "_rank"))
    for text in (conf["why"], conf["source"]):
        assert 1 <= len(text) <= 200 and "\n" not in text
    files = [c["file"] for c in MANIFEST["configs"]]
    assert files.count(conf["file"]) == 1


@pytest.mark.parametrize("cell", MANIFEST["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert 1 <= len(cell["why"]) <= 200 and "\n" not in cell["why"]
    conf = next(c for c in MANIFEST["configs"] if c["name"] == cell["config"])
    assert (ROOT / conf["file"]).is_file()
    traffic = json.loads((ROOT / "sfbench/traffic" / f"{cell['traffic']}.json")
                         .read_text())
    assert {"pattern", "mode", "loads", "seeds_per_load",
            "check_lanes"} <= set(traffic)
    for m in MANIFEST["per_layer"]:
        if cell["name"] in m.get("workloads", [cell["name"]]):
            assert (ROOT / "sfbench/metrics" / f"{m['name']}.py").is_file()


@pytest.mark.parametrize("cell", MANIFEST["workloads"], ids=lambda w: w["name"])
def test_cell_reports_enough(cell):
    e2e = [m["name"] for m in MANIFEST["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(cell["name"] in m.get("workloads", [cell["name"]])
               for m in MANIFEST["per_layer"])


@pytest.mark.parametrize("metric", MANIFEST["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_moves_a_reported_metric(metric):
    moved = E2E[metric["moves"]]
    for cell in metric.get("workloads", list(CELLS)):
        assert cell in CELLS
        assert cell in moved.get("workloads", [cell])


def _imports(path):
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return out


@pytest.mark.parametrize("path", MODULES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & FORBIDDEN


@pytest.mark.parametrize("path", sorted((ROOT / "sfbench/reference")
                                        .glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert tops <= {"__future__", "numpy", "torch"}


def test_result_line_keys():
    import torch
    from sfbench import harness
    run = dict(cell={"end_to_end": MANIFEST["end_to_end"]}, lanes=20,
               sweeps=2, window_s=30.0, setup_s=9.0, tables_s=0.2,
               peak_bytes=2 ** 31, trace=None, lane_cycles=120000,
               per_layer={}, breakdown=None, failed_lanes=0, check_s=12.0,
               checked_lanes=5,
               checks={"tables_mismatch": 0, "traffic_mismatch": 0,
                       "lanes_mismatch": 0})
    line = harness.result_line(run, False, torch.device("cpu"))
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert line["correct"] is True and line["attempted"] == 40
    assert set(line["metrics"]) == set(E2E)
    assert line["metrics"]["lane_cycles_per_s"]["value"] == 4000.0
    assert line["metrics"]["peak_mem_gib"]["value"] == 2.0
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    run["checks"]["lanes_mismatch"] = 3
    assert harness.result_line(run, False, torch.device("cpu"))[
        "correct"] is False
    json.dumps(line)


def test_run_without_a_card_prints_no_result(tmp_path):
    # the whole checkout: refused for want of a card; a directory holding
    # only BENCHMARK.json and the benchmark: refused too
    import shutil
    bare = tmp_path / "bare"
    shutil.copytree(ROOT / "sfbench", bare / "sfbench")
    shutil.copy(ROOT / "BENCHMARK.json", bare)
    for where in (ROOT, bare):
        p = subprocess.run(
            [sys.executable, "sfbench/run.py", "--workload",
             MANIFEST["workloads"][0]["name"], "--seed", "3000000019",
             "--seconds", "1", "--trace", "0"], cwd=where,
            capture_output=True, text=True, timeout=120,
            env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
        assert p.returncode != 0
        assert p.stdout.strip() == ""
