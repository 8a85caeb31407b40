"""The check passes the program against the reference at smoke widths on the
CPU, and fails a run with the timed path broken underneath: the harness
drives the whole run (loader, ring, trainer, probe, reference) with one
fault planted in the built program."""
import pytest
import torch

from benchlib import check, harness
from benchlib.manifest import load_cell

CPU = torch.device("cpu")
RESNET, DECODER = "smoke-resnet.smoke-s3sim", "smoke-decoder.smoke-s3sim"


def _wrap_step(prog, change_batch=None, frozen=False):
    step = prog.trainer.train_step

    def faulty(state, batch):
        if change_batch is not None:
            batch = change_batch(dict(batch))
        if not frozen:
            return step(state, batch)
        # the program updates in place: put every tensor back as it was
        tensors = {k: v for k, v in check._flatten(state).items() if isinstance(v, torch.Tensor)}
        saved = {k: v.detach().clone() for k, v in tensors.items()}
        _, metrics = step(state, batch)
        with torch.no_grad():
            for k, v in tensors.items():
                v.copy_(saved[k])
        return state, metrics

    prog.trainer.train_step = faulty


def _answer(batch):
    key = "label" if "label" in batch else "targets"
    batch[key] = batch[key].clone()
    batch[key].view(-1)[0] += 1
    return batch


def _drop_sample(batch):
    # sample 1 is lost and sample 0 stands in its place
    return {k: torch.cat([v[:1], v[:1], v[2:]]) for k, v in batch.items()}


def _half(batch):
    return {k: v[: v.shape[0] // 2] for k, v in batch.items()}


def _skip_normalize(prog):
    def ingest(batch):
        return dict(batch, image=batch["image"].permute(0, 3, 1, 2).float())

    prog.trainer.ingest_fn = ingest


def _stale_in_window(prog):
    """From the first step after the checked ones on, every batch holds what
    the last one before it held, as a recycled buffer read before it was
    refilled would: steps 1-3 are sound, the window's steps are not."""
    hook, checked = prog.trainer._hook, prog.cfg["bench"]["checked_steps"]
    held = {}

    def faulty(name, *args):
        if name == "on_train_batch_start":
            batch = args[0]
            if prog.trainer.global_step >= checked and held:
                for k, v in batch.items():
                    v.copy_(held[k])
            held.update({k: v.clone() for k, v in batch.items()})
        return hook(name, *args)

    prog.trainer._hook = faulty


FAULTS = {
    "state_unchanged": lambda p: _wrap_step(p, frozen=True),
    "half_batch": lambda p: _wrap_step(p, _half),
    "answer_altered": lambda p: _wrap_step(p, _answer),
    "sample_dropped": lambda p: _wrap_step(p, _drop_sample),
}


def _run(root, cell, fault=None, seed=5):
    out = harness.run(load_cell(root, cell), seed, 0.5, False, CPU, 0.0, fault=fault)
    return out["numbers"]


@pytest.mark.parametrize("cell", [RESNET, DECODER])
def test_honest_run_is_correct(smoke_root, cell):
    numbers = _run(smoke_root, cell, seed=2**31 + 11)
    assert check.passed(numbers), numbers


CASES = [(c, f) for c in (RESNET, DECODER) for f in sorted(FAULTS)] + [
    (RESNET, "normalize_skipped")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_planted_fault_is_not_correct(smoke_root, cell, fault):
    plant = _skip_normalize if fault == "normalize_skipped" else FAULTS[fault]
    numbers = _run(smoke_root, cell, plant)
    assert not check.passed(numbers), numbers


@pytest.mark.parametrize("cell", [RESNET, DECODER])
def test_stale_batches_in_the_window_are_not_correct(smoke_root, cell):
    numbers = _run(smoke_root, cell, _stale_in_window)
    assert not check.passed(numbers), numbers
    over = {k for k, c in numbers.items() if c["value"] > c["limit"]}
    assert over <= {"input_gap", "label_mismatch", "token_mismatch"}, numbers


def test_control_fails_the_limits(smoke_root):
    """The reference in the precision below the configuration's, in the
    program's place, is refused by the limits; so is each fault read on
    the reference."""
    import control

    for cell in (RESNET, DECODER):
        c = load_cell(smoke_root, cell)
        got = control.readings(c, 9, CPU)
        limits = c.config["check_limits"]
        for side in ("control", "half_batch", "altered"):
            over = [k for k, v in got[side].items() if k in limits and v > limits[k]]
            assert over, (cell, side, got[side])
