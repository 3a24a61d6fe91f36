"""BENCHMARK.json keeps to its contract's names and units, and a
configuration, mix or metric dropped in by name is found with no other file
edited."""

import json
import re
import shutil
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_names_and_units():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in MANIFEST["configs"]] + [w["name"] for w in MANIFEST["workloads"]]
    names += [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    names += [w["config"] for w in MANIFEST["workloads"]] + [w["traffic"] for w in MANIFEST["workloads"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert all(UNIT.match(m["unit"]) for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"])
    assert all(m["better"] in ("lower", "higher") for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"])
    metrics = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    assert 1 <= MANIFEST["run_seconds"] <= 51


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in MANIFEST["workloads"]:
        spec = harness.load_cell(w["name"])
        e2e = [m["name"] for m in spec["end_to_end"]]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec["per_layer"], w["name"]
        for m in spec["per_layer"]:
            assert m["moves"] in e2e
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").exists()
        assert "mfu" in m["name"] or not m["name"].startswith("step")


def test_each_file_named_in_the_manifest_exists():
    for c in MANIFEST["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"] and c["reduced"] == []
        assert "limits" in cfg
    for w in MANIFEST["workloads"]:
        mix = json.loads((ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
        assert (ROOT / "benchmark" / "drivers" / f"{mix['driver']}.py").exists()


def test_a_dropped_in_cell_is_found_by_name(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "benchmark/configs/salve-rn152-cfrgb-infer.json").read_text())
    cfg["name"] = "other-config"
    (tmp_path / "benchmark/configs/other-config.json").write_text(json.dumps(cfg))
    mix = json.loads((ROOT / "benchmark/traffic/small_floors.json").read_text())
    mix["panos_per_floor"] = [7, 8]
    (tmp_path / "benchmark/traffic/other_mix.json").write_text(json.dumps(mix))
    (tmp_path / "benchmark/metrics/other_metric.py").write_text("def read(ctx):\n    return 42.0\n")
    m["configs"].append({"name": "other-config", "source": "x", "file": "benchmark/configs/other-config.json",
                         "reduced": [], "why": "x"})
    m["workloads"].append({"name": "other-cell", "config": "other-config", "traffic": "other_mix", "chips": 1,
                           "why": "x"})
    m["end_to_end"][0]["workloads"].append("other-cell")
    m["per_layer"].append({"name": "other_metric", "unit": "%", "better": "higher", "source": "device_trace",
                           "layer": "kernels", "moves": "hyp_per_s", "workloads": ["other-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    spec = harness.load_cell("other-cell", root=tmp_path)
    assert spec["config"]["name"] == "other-config" and spec["mix"]["panos_per_floor"] == [7, 8]
    assert [x["name"] for x in spec["per_layer"]] == ["other_metric"]
    assert harness.reader("other_metric", root=tmp_path)({}) == 42.0


def test_a_dropped_in_kind_of_traffic_brings_its_own_driver(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "benchmark/traffic/other_kind.json").write_text(json.dumps({"driver": "other_driver", "n": 3}))
    (tmp_path / "benchmark/drivers/other_driver.py").write_text(
        "def run(config, mix, seed, seconds, trace, device, t_start):\n"
        "    return {'metrics': {'hyp_per_s': float(mix['n']), 'setup_s': 1.0}, 'ctx': {}, 'attempted': mix['n'],\n"
        "            'failed': 0, 'memory_peak_bytes': 0, 'checks': {'logit_gap': 0.0}}\n")
    m["workloads"].append({"name": "other-cell", "config": "salve-rn152-cfrgb-infer", "traffic": "other_kind",
                           "chips": 1, "why": "x"})
    m["end_to_end"][0]["workloads"].append("other-cell")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    spec = harness.load_cell("other-cell", root=tmp_path)
    out = harness.run_cell(spec, 1, 1.0, False, "cpu", 0.0, root=tmp_path)
    assert out["correct"] and out["metrics"]["hyp_per_s"]["value"] == 3.0


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        harness.load_cell("no-such-cell")
    assert harness.main(["--workload", "no-such-cell", "--seed", "1", "--seconds", "1", "--trace", "0"], 0.0) == 2
