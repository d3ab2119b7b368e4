"""BENCHMARK.json against the rules its cells are held to, every name it
gives resolved to a file, and a new cell added with new files only."""
from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from nerfbench import harness

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["nerfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and (REPO / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_and_reports(cell):
    c = harness.find_cell(cell, REPO)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in names
        assert callable(harness.reader(c, m["name"]))
    assert harness.driver_class(c).kind in ("train", "render")
    assert set(c.limits) and all("limit" in v for v in c.limits.values())


def test_a_new_cell_is_new_files_only(tiny_root, tmp_path):
    """A configuration, a traffic mix and a per-layer metric that exist
    only in a copy of the folder are found by name and run."""
    import shutil

    root = tmp_path / "copy"
    shutil.copytree(tiny_root, root)
    folder = root / "nerfbench"
    conf = json.loads((folder / "configs" / "garden_quality.json").read_text())
    conf["capture"]["name"] = "tiny_llff_wide"
    conf["capture"]["width"] = 32
    (folder / "configs" / "garden_wide.json").write_text(json.dumps(conf))
    mix = json.loads((folder / "traffic" / "train_preset.json").read_text())
    (folder / "traffic" / "train_short.json").write_text(
        json.dumps(dict(mix, warmup_steps=4)))
    (folder / "metrics" / "steps_in_window.train.py").write_text(
        "def read(summary):\n"
        "    return summary['window']['rays'] / 64\n")
    (folder / "limits" / "garden_wide.train.json").write_text(
        (folder / "limits" / "garden_quality.train.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="garden_wide",
                                 file="nerfbench/configs/garden_wide.json"))
    bench["workloads"].append({"name": "garden_wide.train",
                               "config": "garden_wide",
                               "traffic": "train_short", "chips": 1,
                               "why": "a test cell"})
    bench["per_layer"].append({"name": "steps_in_window.train", "unit": "1",
                               "better": "higher", "source": "host_clock",
                               "layer": "trainer", "moves": "train_rays_per_s",
                               "workloads": ["garden_wide.train"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = harness.run_cell("garden_wide.train", 5, 2.0, True, "cpu", 0.0, root)
    assert out["correct"], out["checks"]
    assert out["metrics"]["steps_in_window.train"]["value"] >= 4
    assert (folder / ".cache" / "tiny_llff_wide" / "DONE").is_file()


def test_no_card_no_result():
    """Without a CUDA device the command exits non-zero and prints nothing
    on standard output."""
    out = subprocess.run(
        [sys.executable, "-m", "nerfbench.run", "--workload", CELLS[0],
         "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""
