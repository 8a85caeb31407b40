"""The frozen arithmetic against the dry run's counts, and the metric
arithmetic on synthetic traces."""
import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from benchlib import arith, devtrace, readers

BENCH = Path(__file__).resolve().parents[1]
RESNET = json.loads((BENCH / "configs/resnet18-imagenet.json").read_text())
GRANITE = json.loads((BENCH / "configs/granite-8b-4l.json").read_text())


def test_resnet18_flops_against_the_dry_run():
    # PR 29's dry run counted 6.815e11 FLOPs for a batch-64 step.  It counts
    # the backward as run, and the stem's input gradient is never computed
    # (the image needs none): 2 x 118,013,952 multiply-adds an image fewer
    # than "backward = 2 x forward" takes.
    assert arith.resnet_forward_macs((2, 2, 2, 2), 64, 1000, 224) == 1_814_073_344
    step = 64 * arith.resnet_train_flops_per_image(RESNET)
    stem = 112 * 112 * 64 * 3 * 49
    assert stem == 118_013_952
    assert step - 64 * 2 * stem == pytest.approx(6.815e11, rel=1e-3)
    assert step == pytest.approx(6.815e11, rel=0.025)


def test_granite_parameters_and_flops():
    assert arith.decoder_params(GRANITE) == 1_275_105_280 == GRANITE["parameters"]
    per_token = arith.decoder_train_flops_per_token(GRANITE, 4096)
    assert per_token == 6 * 1_275_105_280 + 12 * 4 * 32 * 128 * 4096
    # the dry run counted 1.440e14 for the 16,384-token step: 1.149 x 6ND, with
    # the recomputed forward of every checkpointed block
    assert 16384 * per_token == pytest.approx(1.440e14 / 1.149 * 1.105, rel=0.01)


def test_ingest_norm_bytes_and_roofline():
    nbytes = arith.ingest_norm_bytes(256, 224, 224)
    assert nbytes == 192_675_840
    bound = nbytes / arith.PEAK_HBM_BYTES_PER_S
    assert bound == pytest.approx(57.5e-6, rel=1e-3)
    assert arith.roofline_pct(0.0, nbytes, 2 * bound, 1.0) == pytest.approx(50.0)
    assert arith.roofline_pct(1e12, 0, 1.0, 1e12) == pytest.approx(100.0)


def _events(intervals, marks=(0.0, 10.0)):
    ev = [{"ph": "X", "cat": "kernel", "name": devtrace.MARKER, "ts": m * 1e6 + 5e6,
           "dur": 1} for m in marks]
    ev += [{"ph": "X", "cat": cat, "name": name, "ts": a * 1e6 + 5e6, "dur": (b - a) * 1e6}
           for name, cat, a, b in intervals]
    ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 5e6,
               "dur": 1e7})
    return ev


def test_idle_is_the_complement_of_the_union():
    trace = devtrace.from_events(_events([
        ("k1", "kernel", 1.0, 3.0), ("k2", "kernel", 2.0, 4.0),  # overlap on two streams
        ("copy", "gpu_memcpy", 6.0, 7.0), ("late", "kernel", 9.5, 12.0),
    ]), host_marks=(100.0, 110.0))
    assert trace.t0 == pytest.approx(100.0) and trace.window_s == pytest.approx(10.0)
    assert trace.busy_s() == pytest.approx(3.0 + 1.0 + 0.5)
    assert [round(b - a, 6) for a, b in trace.idle_gaps()] == [1.0, 2.0, 2.5]
    run = SimpleNamespace(trace=trace)
    assert readers.device_idle_pct(run) == pytest.approx(55.0)
    assert trace.durations("k") == pytest.approx([2.0, 2.0])
    spans = [SimpleNamespace(name="run_training_batch", t0=100.5, t1=102.5),
             SimpleNamespace(name="stage_fetch", t0=100.0, t1=110.0)]
    named = dict(devtrace.name_gaps(trace.idle_gaps(), spans))
    assert named == pytest.approx({"run_training_batch": 1.0, "no_program_span": 4.5})


def test_markers_are_required():
    with pytest.raises(RuntimeError, match="markers"):
        devtrace.from_events([], host_marks=(0.0, 1.0))


def test_step_mfu_and_batch_wait():
    spans = [SimpleNamespace(name="run_training_batch", t0=t, t1=t + 0.1)
             for t in (0.0, 0.15, 0.35, 0.5)]
    run = SimpleNamespace(cfg=RESNET, traffic={}, steps=4, window_s=0.6, t0=0.0, t1=0.6,
                          items_per_step=256, tokens_per_step=0,
                          spans_named=lambda n: [s for s in spans if s.name == n])
    assert readers.step_gaps_s(run) == pytest.approx([0.05, 0.1, 0.05])
    assert readers.mean_ms(readers.step_gaps_s(run)) == pytest.approx(200 / 3)
    flops = 4 * 256 * arith.resnet_train_flops_per_image(RESNET)
    # over the steps' own 0.4 s, not the window's 0.6: the waits are the loader's
    assert readers.step_mfu_pct(run) == pytest.approx(100 * flops / (0.4 * 494.7e12))
