"""The system under test, wired as ``repro_torch.launch.train`` wires it.

store -> dataset -> ``make_loader`` (the staged pipeline, pinned staging)
-> ``Trainer.fit`` (device prefetch ring, the ``ingest_norm`` epilogue
for images) -> the train step.  The benchmark hands the program its data
and its initial weights; everything else is the program's.
"""
from __future__ import annotations

import inspect
import re
from dataclasses import replace
from typing import Any, Dict, List, Optional

import torch

from benchlib import weights as W
from benchlib.data import (IMAGE_PREFIX, TOKEN_PREFIX, ImagePool, TokenSet, make_image_pool,
                           make_token_set)
from repro_torch.config import (AttentionConfig, LoaderConfig, ModelConfig, PipelineConfig,
                                TrainConfig)
from repro_torch.core import make_loader
from repro_torch.core.tracing import NULL_TRACER, Tracer
from repro_torch.data.dataset import ImageDataset, TokenDataset
from repro_torch.data.store import KeyNotFound, ObjectStore, SimulatedS3Store
from repro_torch.train.steps import (lm_train_state, make_resnet_train_step, make_train_step,
                                     resnet_train_state)
from repro_torch.train.trainer import Callback, Trainer
from repro_torch.tree import map_with_path


class PoolStore(ObjectStore):
    """A read-only in-memory store of ``keys`` keys dealt from a pool of
    distinct blobs: key i holds ``blobs[i % len(blobs)]``."""

    def __init__(self, prefix: str, suffix: str, blobs: List[bytes], keys: int) -> None:
        self._re = re.compile(re.escape(prefix) + r"(\d{8})" + re.escape(suffix) + "$")
        self.blobs, self.keys = blobs, keys

    def get(self, key: str) -> bytes:
        m = self._re.match(key)
        if m is None or int(m.group(1)) >= self.keys:
            raise KeyNotFound(key)
        return self.blobs[int(m.group(1)) % len(self.blobs)]

    def put(self, key: str, data: bytes) -> None:
        raise PermissionError("the benchmark's store is read-only")

    def list_keys(self, prefix: str = "") -> List[str]:
        raise NotImplementedError("the benchmark's store is not listed")


def norm_eps() -> float:
    """The RMSNorm epsilon the program uses: ``apply_norm``'s, which no caller sets."""
    from repro_torch.models.layers import apply_norm

    return inspect.signature(apply_norm).parameters["eps"].default


def model_config(cfg: Dict) -> ModelConfig:
    if cfg["family"] == "resnet":
        return ModelConfig(name=cfg["name"], family="resnet",
                           resnet_blocks=tuple(cfg["resnet_blocks"]),
                           resnet_width=cfg["resnet_width"], num_classes=cfg["num_classes"],
                           image_size=cfg["image_size"])
    if cfg["rms_norm_eps"] != norm_eps():
        raise ValueError(f"the configuration states rms_norm_eps {cfg['rms_norm_eps']}; the "
                         f"program's RMSNorm takes no epsilon but its own, {norm_eps()}")
    return ModelConfig(
        name=cfg["name"], family="decoder", num_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], d_ff=cfg["intermediate_size"],
        vocab_size=cfg["vocab_size"], mlp="swiglu", norm="rmsnorm",
        attention=AttentionConfig(kind="gqa", num_heads=cfg["num_attention_heads"],
                                  num_kv_heads=cfg["num_key_value_heads"],
                                  head_dim=cfg["head_dim"], rope_theta=cfg["rope_theta"]),
        tie_embeddings=cfg["tie_word_embeddings"], dtype=cfg["torch_dtype"],
        param_dtype=cfg["param_dtype"], remat=cfg["remat"])


def train_config(cfg: Dict, microbatches: int) -> TrainConfig:
    o = cfg["optimizer"]
    return TrainConfig(optimizer=o["name"], learning_rate=o["learning_rate"],
                       weight_decay=o["weight_decay"], beta1=o.get("beta1", o.get("momentum")),
                       beta2=o.get("beta2", 0.95), eps=o.get("eps", 1e-8),
                       grad_clip=o["grad_clip"], warmup_steps=o["warmup_steps"],
                       schedule=o["schedule"], total_steps=o["total_steps"],
                       microbatches=microbatches)


def make_inputs(cfg: Dict, traffic: Dict, seed: int) -> Any:
    if cfg["family"] == "resnet":
        return make_image_pool(seed, traffic["images"])
    return make_token_set(seed, traffic["tokens"], cfg["vocab_size"])


def _store(traffic: Dict, base: ObjectStore, seed: int) -> ObjectStore:
    s = traffic["store"]
    if s["kind"] == "memory":
        return base
    if s["kind"] != "s3sim":
        raise ValueError(f"unknown store kind {s['kind']!r}")
    return SimulatedS3Store(base, latency_mean_s=s["latency_median_s"],
                            latency_sigma=s["latency_sigma"],
                            bandwidth_per_conn=s["bandwidth_per_conn"],
                            nic_bandwidth=s["nic_bandwidth"],
                            max_connections=s["max_connections"], seed=seed)


def _port_tree(tree: Any, drawn: Dict[str, torch.Tensor], grad: bool,
               same_shapes: bool = True) -> Any:
    """The program's tree with every leaf replaced by the benchmark's (shapes
    checked, or only their ranks where the tree was made at other widths)."""
    def swap(path: str, leaf: torch.Tensor) -> torch.Tensor:
        new = drawn.pop(path)
        got, want = tuple(new.shape), tuple(leaf.shape)
        if (got != want) if same_shapes else (len(got) != len(want)):
            raise ValueError(f"{path}: the benchmark draws {got}, the program holds {want}")
        return new.to(leaf.dtype).requires_grad_(grad)
    out = map_with_path(swap, tree)
    if drawn:
        raise ValueError(f"the program's tree lacks {sorted(drawn)}")
    return out


class Program:
    """The built system of one run."""

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, inputs: Any,
                 device: torch.device, callbacks: List[Callback], traced: bool) -> None:
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = device
        # spans are recorded in the traced run only: the end-to-end metrics
        # are measured with the program's tracing off
        self.tracer = Tracer() if traced else NULL_TRACER
        self.mcfg = model_config(cfg)
        lspec = traffic["loader"]
        images = cfg["family"] == "resnet"
        spec = traffic["images"] if images else traffic["tokens"]
        self.tcfg = train_config(cfg, 1 if images else spec["microbatches"])
        if images:
            pool: ImagePool = inputs
            store = _store(traffic, PoolStore(IMAGE_PREFIX, ".rimg", pool.blobs, pool.keys), seed)
            dataset = ImageDataset(store, pool.keys, out_size=cfg["image_size"], seed=seed,
                                   tracer=self.tracer,
                                   sim_decode_s_per_mb=spec["sim_decode_s_per_mb"],
                                   epilogue="device" if cfg["device_ingest"] else "host")
        else:
            toks: TokenSet = inputs
            store = _store(traffic, PoolStore(TOKEN_PREFIX, ".rtok", toks.blobs,
                                              len(toks.blobs)), seed)
            dataset = TokenDataset(store, len(toks.blobs), spec["seq_len"], tracer=self.tracer)
        self.loader = make_loader(
            LoaderConfig(batch_size=spec["batch"], seed=seed, pipeline=PipelineConfig(
                enabled=True, reorder=lspec["reorder"], io_workers=lspec["io_workers"],
                cpu_workers=lspec["cpu_workers"], cpu_executor=lspec["cpu_executor"],
                staging_buffers=lspec["staging_buffers"])),
            dataset, tracer=self.tracer)
        self.state = self._initial_state()
        if images:
            self.step_fn = make_resnet_train_step(self.mcfg, self.tcfg)
        else:
            self.step_fn = make_train_step(self.mcfg, self.tcfg)
        ingest = None
        if images and cfg["device_ingest"]:
            from repro_torch.kernels.ingest_norm.ops import make_ingest_fn

            ingest = make_ingest_fn()
        self.trainer = Trainer(self.step_fn, self.state, callbacks=callbacks,
                               tracer=self.tracer, ingest_fn=ingest, device=device,
                               device_prefetch=lspec["device_prefetch"])

    def _initial_state(self) -> Dict[str, Any]:
        cfg, dev = self.cfg, self.device
        if cfg["family"] == "resnet":
            from repro_torch.models.resnet import init_resnet

            p_leaves, s_leaves = W.resnet_leaves(cfg)
            # the program's trees, drawn on the CPU and replaced leaf by leaf
            params, bn = init_resnet(self.mcfg, torch.Generator().manual_seed(0), "cpu")
            params = _port_tree(params, W.draw(p_leaves, self.seed, dev), grad=True)
            bn = _port_tree(bn, W.draw(s_leaves, self.seed, dev), grad=False)
            return resnet_train_state(params, bn, self.tcfg)
        from repro_torch.models.transformer import init_lm

        # the program's tree at widths of 8, on the CPU: its paths, not its values
        small = replace(self.mcfg, d_model=8, d_ff=8, vocab_size=8,
                        attention=replace(self.mcfg.attention, head_dim=2))
        tree = init_lm(small, torch.Generator().manual_seed(0), "cpu")
        params = _port_tree(tree, W.draw(W.decoder_leaves(cfg), self.seed, dev), grad=True,
                            same_shapes=False)
        return lm_train_state(params, self.tcfg)

    def warm(self) -> None:
        """One forward and backward pass of the model at the step's shapes on a
        batch of zeros, its gradients and statistics thrown away: the CUDA
        libraries and kernels load here, before the loader starts, so the first
        step is short and the loader does not run far ahead of it."""
        images = self.cfg["family"] == "resnet"
        spec = self.traffic["images" if images else "tokens"]
        rows = spec["batch"] // self.tcfg.microbatches
        params = self.state["params"]
        from repro_torch.tree import leaves

        if images:
            from repro_torch.models.resnet import resnet_loss

            side = self.cfg["image_size"]
            batch = {"image": torch.zeros((rows, side, side, 3), dtype=torch.uint8,
                                          device=self.device),
                     "label": torch.zeros((rows,), dtype=torch.int32, device=self.device)}
            if self.trainer.ingest_fn is not None:
                batch = self.trainer.ingest_fn(batch)
            loss, _ = resnet_loss(params, self.state["bn"], batch, self.mcfg, train=True)
        else:
            from repro_torch.models.transformer import forward_train

            toks = torch.zeros((rows, spec["seq_len"]), dtype=torch.int32, device=self.device)
            loss, _ = forward_train(params, {"tokens": toks, "targets": toks}, self.mcfg)
        torch.autograd.grad(loss, leaves(params))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def fit(self, steps: Optional[int] = None):
        return self.trainer.fit(self.loader, epochs=1 << 30, max_steps=steps)

    def close(self) -> None:
        self.loader.close()
