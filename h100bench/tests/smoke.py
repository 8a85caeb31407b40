"""A checkout in a temporary directory whose cells run on the CPU in seconds:
the benchmark's own files, plus smoke-width configurations, mixes and a
manifest that names them, all as data."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
ROOT = BENCH.parent


def _load(rel: str) -> dict:
    return json.loads((BENCH / rel).read_text())


def resnet_config() -> dict:
    cfg = _load("configs/resnet18-imagenet.json")
    cfg.update(name="smoke-resnet", resnet_blocks=[1, 1], resnet_width=8, image_size=32)
    cfg["bench"] = {"warmup_steps": 4, "checked_steps": 3}
    # float32 on the CPU on both sides: gaps of rounding only
    cfg["check_limits"] = {"input_gap": 1e-5, "label_mismatch": 0, "loss_gap": 1e-4,
                           "grad_gap": 1e-3, "change_gap": 1e-3, "bn_gap": 1e-3}
    return cfg


def decoder_config() -> dict:
    cfg = _load("configs/granite-8b-4l.json")
    cfg.update(name="smoke-decoder", hidden_size=64, intermediate_size=192,
               num_attention_heads=4, num_key_value_heads=2, head_dim=16,
               num_hidden_layers=2, vocab_size=512, torch_dtype="float32")
    cfg["bench"] = {"warmup_steps": 4, "checked_steps": 3}
    cfg["check_limits"] = {"token_mismatch": 0, "loss_gap": 1e-4, "grad_gap": 1e-3,
                           "change_gap": 1e-3}
    return cfg


def traffic(store: str) -> dict:
    t = _load("traffic/s3-80ms.json")
    t["name"] = f"smoke-{store}"
    if store == "memory":
        t["store"] = {"kind": "memory"}
    else:
        t["store"] = dict(t["store"], latency_median_s=0.002)
    t["loader"] = dict(t["loader"], io_workers=8, cpu_workers=2, staging_buffers=2)
    t["images"] = dict(t["images"], keys=100000, pool=16, avg_kb=4.0, batch=8,
                       sim_decode_s_per_mb=0.0)
    t["tokens"] = dict(t["tokens"], sequences=64, seq_len=32, batch=4, microbatches=2)
    return t


# the ResNet cells' metrics, which no cell of BENCHMARK.json reports yet:
# a cell that reports them comes back by these manifest entries alone
IMAGE_METRICS = {
    "end_to_end": [{"name": "train_items_per_s", "unit": "items/s", "better": "higher",
                    "bound": 0.05, "source": "host_clock"}],
    "per_layer": [
        {"name": name, "unit": unit, "better": better, "source": source, "layer": layer,
         "moves": "train_items_per_s"}
        for name, unit, better, source, layer in [
            ("batch_wait_ms.images", "ms", "lower", "program_span", "trainer and loader"),
            ("batch_wait_p95_ms.images", "ms", "lower", "program_span", "trainer and loader"),
            ("cpu_stage_ms.images", "ms", "lower", "program_span", "loader CPU stage"),
            ("h2d_ms.images", "ms", "lower", "program_span", "device ring"),
            ("ingest_norm_roofline", "%", "higher", "device_trace", "ingest kernel"),
            ("step_mfu_pct.images", "%", "higher", "program_span", "train step and model"),
            ("device_idle_pct.images", "%", "lower", "device_trace", "device")]],
}


def make_root(tmp: Path, extra_cells=()) -> Path:
    """A checkout at ``tmp`` with the smoke cells ``smoke-resnet.local``,
    ``smoke-resnet.s3`` and ``smoke-decoder.s3`` (and ``extra_cells``,
    (config, traffic) pairs of names) in its manifest."""
    root = Path(tmp)
    shutil.copytree(BENCH, root / "h100bench",
                    ignore=shutil.ignore_patterns("_cache", "_traces", "__pycache__"))
    (root / "src").symlink_to(ROOT / "src")
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    configs = {"smoke-resnet": resnet_config(), "smoke-decoder": decoder_config()}
    for name, cfg in configs.items():
        (root / "h100bench" / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    for store in ("memory", "s3sim"):
        (root / "h100bench" / "traffic" / f"smoke-{store}.json").write_text(
            json.dumps(traffic(store)))
    manifest["configs"] = [{"name": n, "source": c["source"], "file":
                            f"h100bench/configs/{n}.json", "reduced": [], "why": "smoke"}
                           for n, c in configs.items()]
    cells = [("smoke-resnet", "smoke-memory"), ("smoke-resnet", "smoke-s3sim"),
             ("smoke-decoder", "smoke-s3sim"), *extra_cells]
    manifest["workloads"] = [{"name": f"{c}.{t}", "config": c, "traffic": t, "chips": 1,
                              "why": "smoke"} for c, t in cells]
    names = [w["name"] for w in manifest["workloads"]]
    for key, entries in IMAGE_METRICS.items():
        manifest[key] += [dict(m, workloads=[]) for m in entries]
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "workloads" in m:
            kind = "decoder" if "tokens" in m["name"] else "resnet"
            m["workloads"] = [n for n in names if f"smoke-{kind}" in n]
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return root
