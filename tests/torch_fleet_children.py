"""Targets of the processes that the port's coordination twins spawn
(``tests/test_torch_coord.py``, ``tests/test_torch_elastic.py`` and the
cross-package fleets of ``tests/test_torch_fleet.py``).

A spawned child imports the module its target lives in.  The test modules
import torch (``pytest.importorskip``), so the targets live here, in a
module that imports nothing but the coordination layer of one package or
the other: each target checks on its way out that ``torch`` never entered
``sys.modules`` and exits with :data:`TORCH_LOADED` if it did.  Not a test
module: pytest collects nothing from it."""
import json
import os
import signal
import sys
import time

TORCH_LOADED = 86  # exit code of a child in which torch was imported


def torch_free() -> None:
    """Exit with :data:`TORCH_LOADED` when torch was imported here."""
    if "torch" in sys.modules:
        sys.stdout.flush()
        os._exit(TORCH_LOADED)


def reap(procs, timeout_s: float) -> list:
    """Join every process within one shared deadline; kill any still alive
    and return the exit codes (a killed straggler reads as -SIGKILL, so a
    hang fails its own test instead of stalling the run)."""
    deadline = time.monotonic() + timeout_s
    for p in procs:
        p.join(timeout=max(deadline - time.monotonic(), 0.0))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(timeout=10)
    return [p.exitcode for p in procs]


def _pkg(name: str):
    """The package a target runs against: ``repro_torch`` or ``repro``."""
    import importlib

    return lambda mod: importlib.import_module(f"{name}.{mod}")


# ---------------------------------------------------------------------------
# tests/test_torch_coord.py
# ---------------------------------------------------------------------------


def counter_log(dir_, pkg="repro_torch", **kw):
    AppendLog = _pkg(pkg)("core.coord").AppendLog
    return AppendLog(
        dir_,
        "cnt",
        make_state=lambda: {"v": 0},
        apply=lambda st, rec: st.__setitem__(
            "v", rec["v"] if rec["op"] == "snap" else st["v"] + rec["d"]
        ),
        snapshot=lambda st: [{"op": "snap", "v": st["v"]}],
        **kw,
    )


def count_worker(path, n):
    from repro_torch.core.coord import SharedCounter

    c = SharedCounter(path)
    for _ in range(n):
        c.add(1)
    torch_free()


def journal_writer(cache_dir, capacity, wid, n_items, item_size, out_path,
                   pkg="repro_torch"):
    """One writer of a journal-shared disk tier (``pkg``'s DiskTierCache):
    puts ``n_items`` items of its own and records its tier stats."""
    mod = _pkg(pkg)
    DiskTierCache = mod("data.cache").DiskTierCache
    SharedDiskJournal = mod("core.coord").SharedDiskJournal
    tier = DiskTierCache(
        cache_dir, capacity, journal=SharedDiskJournal(cache_dir, capacity)
    )
    for i in range(n_items):
        tier.put(f"w{wid}-item{i}", bytes([wid]) * item_size)
    s = tier.stats()
    with open(out_path, "w") as f:
        json.dump({"admitted": s.admitted, "evictions": s.evictions,
                   "bytes_admitted": s.bytes_admitted,
                   "bytes_evicted": s.bytes_evicted}, f)
    torch_free()


def append_log_writer(dir_, n, compact_every):
    log = counter_log(dir_, compact_every=compact_every)
    for _ in range(n):
        with log.update() as (st, emit):
            emit({"op": "add", "d": 1})
    torch_free()


def crash_compactor(dir_, hook):
    log = counter_log(dir_)
    torch_free()
    log._crash_hooks[hook] = lambda: os._exit(17)
    log.compact()


# ---------------------------------------------------------------------------
# tests/test_torch_elastic.py
# ---------------------------------------------------------------------------

N_ITEMS = 96
BS = 8


def elastic_dataset(n=N_ITEMS, latency_s=0.002, pkg="repro_torch"):
    mod = _pkg(pkg)
    store = mod("data.imagenet_synth").SyntheticImageStore(n, seed=0, avg_kb=2)
    sim = mod("data.store").SimulatedS3Store(store, latency_mean_s=latency_s,
                                             bandwidth_per_conn=1e9, max_connections=64)
    return mod("data.dataset").ImageDataset(sim, n, out_size=16)


def elastic_config(coord_dir, pkg="repro_torch", **kw):
    base = dict(enabled=True, coord_dir=str(coord_dir), lease_ttl_s=5.0,
                heartbeat_interval_s=0.2, shard_batches=2, claim_poll_s=0.01)
    base.update(kw)
    return _pkg(pkg)("config").ElasticConfig(**base)


def batch_key(b):
    """Order-independent fingerprint of one batch's content."""
    return tuple(sorted(float(x) for x in b["image"].sum(axis=(1, 2, 3))))


def chaos_victim(coord_dir, out_path, kill_after):
    """Consume ``kill_after`` batches of the shared epoch, record what was
    delivered, then die without ANY cleanup (SIGKILL)."""
    from repro_torch.config import LoaderConfig
    from repro_torch.core.loader import ConcurrentDataLoader

    ds = elastic_dataset()
    cfg = LoaderConfig(impl="threaded", batch_size=BS, num_workers=2,
                       num_fetch_workers=4, seed=7,
                       elastic=elastic_config(coord_dir, lease_ttl_s=1.0))
    dl = ConcurrentDataLoader(ds, cfg, host_id=0, num_hosts=1)
    torch_free()
    with open(out_path, "w") as f:
        for i, b in enumerate(dl):
            f.write(json.dumps(batch_key(b)) + "\n")
            f.flush()
            os.fsync(f.fileno())
            if i + 1 >= kill_after:
                os.kill(os.getpid(), signal.SIGKILL)
