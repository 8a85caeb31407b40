"""The port's example twins (``repro_torch.examples``) run on the CPU at a
few steps: ``train_lm`` (the loader over simulated S3, gradient
accumulation and asynchronous checkpoints) and ``elastic_restart``'s two
scenarios (an exact resume from a checkpoint, and an elastic fleet whose
union covers the epoch)."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.examples import elastic_restart, train_lm  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402


def test_train_lm_example_trains_and_checkpoints(tmp_path):
    ckpt = tmp_path / "ckpt"
    res = train_lm.main(["--device", "cpu", "--steps", "10", "--items", "32",
                         "--batch-size", "4", "--seq-len", "64", "--ckpt-dir", str(ckpt)])
    assert res.steps == 10
    assert all(np.isfinite(h["loss"]) for h in res.history)
    mgr = CheckpointManager(str(ckpt))
    assert mgr.steps() == [10]  # every max(steps // 2, 10) steps
    with np.load(ckpt / "step_00000010" / "arrays_h0.npz") as z:
        assert int(z["step"]) == 10 and "opt/mu/embed/w" in z.files
    assert not [d for d in os.listdir(ckpt) if ".tmp" in d]


def test_elastic_restart_checkpoint_scenario_resumes_exactly():
    out = elastic_restart.checkpoint_restart_scenario(torch.device("cpu"))
    assert out["checkpoints"] == [4, 8, 12]
    assert out["resumed"] == pytest.approx(out["reference"], rel=1e-5)
    assert len(out["resumed"]) == elastic_restart.STEPS - 8


def test_elastic_restart_fleet_scenario_covers_the_epoch():
    out = elastic_restart.elastic_fleet_scenario()
    assert out["first"] == 3 and out["batches"] == elastic_restart.N_ITEMS // elastic_restart.BATCH
    assert out["first"] + out["rest"] - out["duplicates"] == out["batches"]


def test_examples_refuse_the_card_when_there_is_none(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for example in (train_lm, elastic_restart):
        with pytest.raises(RuntimeError, match="is_available"):
            example.main([])
