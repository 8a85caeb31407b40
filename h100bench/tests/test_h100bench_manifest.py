"""The manifest meets the contract, and everything of a cell is found by name."""
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchlib import harness
from benchlib.manifest import load_cell, load_manifest, reader

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MANIFEST = load_manifest(ROOT)
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def test_manifest_keys_and_names():
    m = MANIFEST
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert 1 <= m["run_seconds"] <= 51
    metrics = m["end_to_end"] + m["per_layer"]
    names = [x["name"] for x in metrics + m["configs"] + m["workloads"]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    assert all(UNIT.match(x["unit"]) and x["better"] in ("lower", "higher") for x in metrics)
    assert any(x["name"] == "setup_s" for x in m["end_to_end"])
    for x in m["end_to_end"]:
        assert 0.01 <= x["bound"] <= 0.25 and x["source"] in ("host_clock", "device_trace")
    e2e = {x["name"] for x in m["end_to_end"]}
    assert all(x["moves"] in e2e for x in m["per_layer"])
    assert all(w["chips"] == 1 for w in m["workloads"])
    assert len({(w["config"], w["traffic"]) for w in m["workloads"]}) == len(m["workloads"])
    assert len(json.dumps(m)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    c = load_cell(ROOT, cell)
    assert c.config["family"] in ("resnet", "decoder")
    assert (ROOT / "h100bench" / c.config["reference"]).is_file()
    assert c.traffic["loader"]["io_workers"] > 0
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(reader(ROOT, m["name"]))
        if m in c.per_layer:
            assert m["moves"] in e2e


@pytest.mark.parametrize("cell", CELLS)
def test_config_file_states_the_cut(cell):
    c = load_cell(ROOT, cell)
    entry = {x["name"]: x for x in MANIFEST["configs"]}[c.config["name"]]
    assert entry["reduced"] == c.config["reduced"]
    widths = ("hidden_size", "intermediate_size", "head_dim", "resnet_width")
    assert not set(entry["reduced"]) & set(widths)


def test_a_cell_added_as_data_runs(smoke_root):
    """smoke-decoder.smoke-memory exists only as manifest data over files."""
    cell = load_cell(smoke_root, "smoke-decoder.smoke-memory")
    out = harness.run(cell, 3, 0.5, False, torch.device("cpu"), 0.0)
    assert out["record"].steps >= 1
    from benchlib import check

    assert check.passed(out["numbers"]), out["numbers"]


def test_resnet_cell_returns_by_manifest_entries_alone(smoke_root):
    """The ResNet cells' configuration, mix and readers stay; the smoke
    checkout's manifest names their metrics, and a run reports them."""
    from benchlib import result

    cell = load_cell(smoke_root, "smoke-resnet.smoke-memory")
    out = harness.run(cell, 4, 0.5, False, torch.device("cpu"), 0.0)
    line = result.result_line(cell, out, False, {"platform": "cpu"})
    assert line["correct"] and set(line["metrics"]) == {"train_items_per_s", "setup_s"}
    assert {m["name"] for m in cell.per_layer} >= {"step_mfu_pct.images",
                                                  "ingest_norm_roofline"}


def test_a_norm_epsilon_the_program_cannot_take_is_refused():
    from benchlib import program

    cfg = json.loads((ROOT / "h100bench/configs/granite-8b-4l.json").read_text())
    assert program.model_config(cfg).num_layers == cfg["num_hidden_layers"]
    with pytest.raises(ValueError, match="rms_norm_eps"):
        program.model_config(dict(cfg, rms_norm_eps=cfg["rms_norm_eps"] * 10))


def test_without_a_card_no_result_and_nonzero_exit(tmp_path):
    """On a machine without CUDA (this one), and in a bare directory holding only
    the manifest and the benchmark's files, a run prints no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "h100bench", tmp_path / "h100bench",
                    ignore=shutil.ignore_patterns("_cache", "_traces", "__pycache__"))
    for where in (ROOT, tmp_path):
        p = subprocess.run([sys.executable, "h100bench/run.py", "--workload", CELLS[0],
                            "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
                           cwd=where, capture_output=True, text=True, timeout=120)
        assert p.returncode != 0 and p.stdout.strip() == "", (p.stdout, p.stderr)


def test_forbidden_modules_compare_whole_names(monkeypatch):
    sys.path.insert(0, str(ROOT / "h100bench"))
    import run

    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", object())
    assert "repro" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert run.forbidden_modules() == ["repro"]
    assert not math.isnan(run.T_START)
