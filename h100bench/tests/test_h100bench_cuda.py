"""On the card, at each cell's own size: the control and the faults read on
the reference fail the cell's limits, on three seeds.  Runs only with a
CUDA card (``-m cuda``); decides inside the test."""
from pathlib import Path

import pytest
import torch

from benchlib.manifest import load_cell, load_manifest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in load_manifest(ROOT)["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_cell_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import control

    c = load_cell(ROOT, cell)
    limits = c.config["check_limits"]
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        got = control.readings(c, seed, torch.device("cuda"))
        for side in ("control", "half_batch", "altered"):
            assert any(v > limits[k] for k, v in got[side].items() if k in limits), (
                seed, side, got[side])
