"""Atomic, sharded, resumable checkpointing, in the reference's file layout.

Layout (one directory per step), byte for byte the reference's
(``repro/train/checkpoint.py``), so a checkpoint written by either package
restores into the other::

    <root>/step_00000200.tmp-<pid>/   (written)
        arrays_h{host}.npz            (this host's leaves, keyed by path)
        meta.json                     ({"step", "extra"}: loader state, ...)
    <root>/step_00000200/             (atomic rename on completion)

* atomic: readers never see a partial checkpoint (tmp dir + ``os.replace``);
  :meth:`CheckpointManager.steps` ignores ``.tmp`` directories.
* sharded: each host writes only its own leaves (one host here; under a
  process group rank 0 writes ``arrays_h0.npz`` for every rank, as the
  reference's one process does for all its devices, and every rank
  restores from it).
* keys: the ``/``-joined leaf paths of :func:`repro_torch.tree.flatten`.
* layout: leaves are stored in the reference's layout.  A family whose port
  layout differs gives the manager its :class:`~repro_torch.convert.Layout`
  (``convert.checkpoint_layout(cfg)``; the
  ResNet's conv weights and their optimizer moments are HWIO on disk,
  OIHW in the port: :data:`~repro_torch.convert.RESNET_LAYOUT`).  The
  port's ``state["step"]`` is a Python ``int``; it is written as the
  reference writes its step, a 0-d ``int32``, and restored as an ``int``.
* async: ``save(..., blocking=False)`` snapshots every leaf to host memory
  before it returns (a device leaf through a pinned buffer, its copy
  completed; a CPU leaf copied, since the next step updates the live
  tensor in place), then writes in a background thread.  One save is in
  flight at a time; a failed write surfaces on the next :meth:`wait`.
* retention: keeps the newest ``keep`` checkpoints.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.convert import Layout
from repro_torch.tree import flatten, map_with_path


def _host_leaf(x: Any) -> Any:
    """A non-tensor leaf as the reference stores it: an ``int`` (the port's
    step) as a 0-d int32."""
    if isinstance(x, (bool, np.bool_)):
        return np.asarray(x)
    if isinstance(x, (int, np.integer)):
        return np.asarray(x, dtype=np.int32)
    return np.array(x)  # a copy


class CheckpointManager:
    def __init__(self, root: str, keep: int = 3, host_id: int = 0,
                 layout: Optional[Layout] = None) -> None:
        self.root = root
        self.keep = keep
        self.host_id = host_id
        # the family's leaf layout on disk (None: the port's own)
        self.layout = layout
        os.makedirs(root, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # host snapshot buffers by path, reused by the next save (which
        # waits for the writer first); pinned for device leaves
        self._snap: Dict[str, torch.Tensor] = {}
        # the last save's figures: seconds save() spent snapshotting, seconds
        # the write took (tmp dir to rename), bytes of the arrays written
        self.last_snapshot_s = 0.0
        self.last_write_s = 0.0
        self.last_bytes = 0

    # -- paths ---------------------------------------------------------------
    def _dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:08d}")

    def steps(self) -> List[int]:
        out = []
        for d in os.listdir(self.root):
            if d.startswith("step_") and ".tmp" not in d:
                try:
                    out.append(int(d.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    # -- save ----------------------------------------------------------------
    def _snapshot(self, state: Any) -> Dict[str, Any]:
        """Every leaf of ``state`` in host memory that no later step
        touches, keyed by path.  Device leaves are copied into pinned
        buffers on their device's current stream (where the step that
        wrote them ran), and each such stream is synchronized before this
        returns: the writer never reads a copy still in flight."""
        flat: Dict[str, Any] = {}
        streams = {}
        for path, x in flatten(state).items():
            if not isinstance(x, torch.Tensor):
                flat[path] = _host_leaf(x)
                continue
            x = x.detach()
            buf = self._snap.get(path)
            pinned = x.device.type == "cuda"
            if buf is None or buf.shape != x.shape or buf.dtype != x.dtype:
                buf = self._snap[path] = torch.empty(x.shape, dtype=x.dtype,
                                                     pin_memory=pinned)
            buf.copy_(x, non_blocking=pinned)
            if pinned:
                streams[x.device] = torch.cuda.current_stream(x.device)
            flat[path] = buf
        for stream in streams.values():
            stream.synchronize()
        return flat

    def save(
        self,
        step: int,
        state: Any,
        extra_meta: Optional[Dict[str, Any]] = None,
        blocking: bool = True,
    ) -> None:
        self.wait()  # one async save in flight at a time
        layout = self.layout
        t0 = time.perf_counter()
        flat = self._snapshot(state)
        self.last_snapshot_s = time.perf_counter() - t0
        meta = {"step": int(step), "extra": extra_meta or {}}

        def write():
            try:
                t1 = time.perf_counter()
                arrays = {}
                for path, x in flat.items():
                    a = x.numpy() if isinstance(x, torch.Tensor) else x
                    arrays[path] = layout.to_disk(a) if layout is not None else a
                tmp = self._dir(step) + f".tmp-{os.getpid()}"
                os.makedirs(tmp, exist_ok=True)
                np.savez(os.path.join(tmp, f"arrays_h{self.host_id}.npz"), **arrays)
                with open(os.path.join(tmp, "meta.json"), "w") as f:
                    json.dump(meta, f)
                final = self._dir(step)
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.replace(tmp, final)
                self._gc()
                self.last_bytes = sum(int(a.nbytes) for a in arrays.values())
                self.last_write_s = time.perf_counter() - t1
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        if blocking:
            write()
            self._raise_if_failed()
        else:
            self._thread = threading.Thread(target=write, name="ckpt-writer", daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint failed") from err

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self._dir(s), ignore_errors=True)

    # -- restore -------------------------------------------------------------
    def restore(self, template: Any, step: Optional[int] = None) -> Tuple[Any, Dict[str, Any]]:
        """Restore into the structure of ``template``: each tensor leaf on
        the template leaf's device, with its dtype checked and its
        ``requires_grad`` kept; an ``int`` leaf as an ``int``.  A shape that
        differs from the template's raises ``ValueError``."""
        self.wait()
        layout = self.layout
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        d = self._dir(step)
        with np.load(os.path.join(d, f"arrays_h{self.host_id}.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        missing = [p for p in flatten(template) if p not in arrays]
        if missing:
            raise KeyError(f"checkpoint missing {len(missing)} arrays, e.g. {missing[:3]}")

        def leaf(path: str, t: Any) -> Any:
            a = arrays[path]
            if isinstance(t, torch.Tensor):
                if layout is not None:
                    a = layout.from_disk(a)
                if tuple(t.shape) != tuple(a.shape):
                    raise ValueError(f"shape mismatch at {path}: {tuple(t.shape)} vs {a.shape}")
                r = torch.from_numpy(np.ascontiguousarray(a))
                if r.dtype != t.dtype:
                    raise ValueError(f"dtype mismatch at {path}: {t.dtype} vs {r.dtype}")
                return r.to(t.device).requires_grad_(t.requires_grad)
            if hasattr(t, "shape") and tuple(t.shape) != tuple(a.shape):
                raise ValueError(f"shape mismatch at {path}: {tuple(t.shape)} vs {a.shape}")
            if isinstance(t, (int, np.integer)) and not isinstance(t, bool):
                return int(a)
            return a

        return map_with_path(leaf, template), meta
