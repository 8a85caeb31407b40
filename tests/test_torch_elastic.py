"""Twins of ``tests/test_elastic.py`` on the port alone: lease-based
membership, claim-scheduled epochs, and a member that dies (SIGKILL),
leaves or joins mid-epoch while the fleet-wide union of delivered batches
still covers the epoch exactly.  The same cases and assertions with the
imports pointed at ``repro_torch``; the spawned victim runs from
``tests/torch_fleet_children.py``, which imports no torch."""
import json
import multiprocessing
import os
import signal
import threading
import time

import pytest

pytest.importorskip("torch")

from repro_torch.config import ElasticConfig, LoaderConfig  # noqa: E402
from repro_torch.core.coord import EpochShardBoard, MembershipBoard  # noqa: E402
from repro_torch.core.elastic import ClaimStarved, ElasticBatchSampler, ElasticSession  # noqa: E402
from repro_torch.core.loader import ConcurrentDataLoader  # noqa: E402
from repro_torch.core.sampler import ShardedBatchSampler  # noqa: E402
from torch_fleet_children import (  # noqa: E402
    BS,
    N_ITEMS,
    batch_key,
    chaos_victim,
    elastic_config,
    elastic_dataset,
    reap,
)


# the reference's helpers, shared with the spawned victim
_dataset = elastic_dataset


@pytest.fixture
def dataset():
    return _dataset()


_ecfg = elastic_config


def _loader(dataset, coord_dir, *, host=0, seed=7, **ekw):
    cfg = LoaderConfig(impl="threaded", batch_size=BS, num_workers=2,
                       num_fetch_workers=4, seed=seed,
                       elastic=_ecfg(coord_dir, **ekw))
    return ConcurrentDataLoader(dataset, cfg, host_id=host, num_hosts=1)


_batch_key = batch_key


def _reference_batches(dataset, seed=7):
    cfg = LoaderConfig(impl="threaded", batch_size=BS, num_workers=2,
                       num_fetch_workers=4, seed=seed)
    return sorted(_batch_key(b) for b in ConcurrentDataLoader(dataset, cfg))


@pytest.fixture
def chaos_dir(tmp_path, request):
    """Coord dir for chaos tests: under $CHAOS_AUDIT_DIR when set so the CI
    chaos lane uploads membership/lease/journal audit logs on failure."""
    base = os.environ.get("CHAOS_AUDIT_DIR")
    if base:
        d = os.path.join(base, request.node.name)
        os.makedirs(d, exist_ok=True)
        return d
    return str(tmp_path / "coord")


# ---------------------------------------------------------------------------
# session + sampler units
# ---------------------------------------------------------------------------


def test_session_join_heartbeat_leave(tmp_path):
    ses = ElasticSession(_ecfg(tmp_path), member="a")
    ses.join()
    assert ses.membership.is_live("a")
    ses.maybe_heartbeat()  # rate-limited: no error, lease stays fresh
    ses.leave()
    assert not ses.membership.is_live("a")


def test_session_requires_coord_dir():
    with pytest.raises(ValueError, match="coord_dir"):
        ElasticSession(ElasticConfig(enabled=True, coord_dir=""))


def _drain_sampler(sampler, budget_s=30.0):
    """Drive a sampler the way the loader does: retry ClaimStarved, confirm
    consumption by re-entering."""
    out = []
    deadline = time.monotonic() + budget_s
    it = iter(sampler)
    while True:
        try:
            b = next(it)
        except ClaimStarved:
            assert time.monotonic() < deadline, "sampler starved forever"
            continue
        except StopIteration:
            return out
        out.append(b)
        sampler.note_delivered()


def test_sampler_single_host_matches_static(tmp_path):
    ses = ElasticSession(_ecfg(tmp_path), member="a")
    es = ElasticBatchSampler(N_ITEMS, BS, shuffle=True, seed=3, session=ses)
    ref = ShardedBatchSampler(N_ITEMS, BS, shuffle=True, seed=3,
                              host_id=0, num_hosts=1)
    got = _drain_sampler(es)
    want = list(ref)
    # same batch CONTENT set; local batch ids are contiguous
    assert sorted(b.indices for b in got) == sorted(b.indices for b in want)
    assert [b.batch_id for b in got] == list(range(len(want)))
    assert es.epoch == 1  # epoch advanced like the static sampler
    # confirmation drained: the board agrees the epoch is done
    assert ses.shards.all_done(0)
    assert len(es.delivered_log) == len(want)


def test_sampler_two_hosts_partition_epoch(tmp_path):
    ses_a = ElasticSession(_ecfg(tmp_path), member="a")
    ses_b = ElasticSession(_ecfg(tmp_path), member="b")
    a = ElasticBatchSampler(N_ITEMS, BS, shuffle=True, seed=3, session=ses_a)
    b = ElasticBatchSampler(N_ITEMS, BS, shuffle=True, seed=3, session=ses_b)
    got_a, got_b = [], []
    done_a = done_b = False
    it_a, it_b = iter(a), iter(b)
    deadline = time.monotonic() + 30
    while not (done_a and done_b):
        assert time.monotonic() < deadline
        for sampler, it, got, name in ((a, it_a, got_a, "a"),
                                       (b, it_b, got_b, "b")):
            if (name == "a" and done_a) or (name == "b" and done_b):
                continue
            try:
                got.append(next(it))
                sampler.note_delivered()
            except ClaimStarved:
                pass
            except StopIteration:
                if name == "a":
                    done_a = True
                else:
                    done_b = True
    ref = list(ShardedBatchSampler(N_ITEMS, BS, shuffle=True, seed=3,
                                   host_id=0, num_hosts=1))
    union = sorted(x.indices for x in got_a + got_b)
    assert union == sorted(x.indices for x in ref)  # exact, no dup, no loss
    assert got_a and got_b  # interleaved pulls really split the work


def test_sampler_state_dict_roundtrip(tmp_path):
    ses = ElasticSession(_ecfg(tmp_path), member="a")
    s = ElasticBatchSampler(N_ITEMS, BS, seed=3, session=ses)
    s.set_epoch(4)
    sd = s.state_dict()
    assert sd["epoch"] == 4 and sd["next_batch"] == 0
    s2 = ElasticBatchSampler(N_ITEMS, BS, seed=3, session=ses)
    s2.load_state_dict(sd)
    assert s2.epoch == 4


# ---------------------------------------------------------------------------
# loader integration
# ---------------------------------------------------------------------------


def test_loader_single_host_matches_plain(dataset, tmp_path):
    dl = _loader(dataset, tmp_path / "coord")
    got = sorted(_batch_key(b) for b in dl)
    assert got == _reference_batches(dataset)
    # the confirmation path drained: epoch 0 is done on the shared board
    assert dl._elastic.shards.all_done(0)
    # second epoch streams a fresh permutation through the same board
    got2 = [_batch_key(b) for b in dl]
    assert len(got2) == N_ITEMS // BS
    assert dl._elastic.shards.all_done(1)
    dl.release_coordination()
    assert not dl._elastic.membership.is_live(dl._elastic.member)


def test_loader_two_hosts_union_exact(dataset, tmp_path):
    coord = tmp_path / "coord"
    outs = {0: [], 1: []}

    def run(host):
        dl = _loader(dataset, coord, host=host)
        for b in dl:
            outs[host].append(_batch_key(b))
        dl.release_coordination()

    ts = [threading.Thread(target=run, args=(h,)) for h in (0, 1)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=90)
        assert not t.is_alive(), "elastic fleet hung"
    assert sorted(outs[0] + outs[1]) == _reference_batches(dataset)
    assert outs[0] and outs[1]


def test_loader_join_mid_epoch_converges(tmp_path):
    """A host that joins while the epoch is underway claims leftover shards;
    the union stays exact and the joiner does real work."""
    ds = _dataset(n=160, latency_s=0.004)
    coord = tmp_path / "coord"
    outs = {0: [], 1: []}
    started = threading.Event()

    def run_early():
        dl = _loader(ds, coord, host=0)
        for i, b in enumerate(dl):
            if i == 2:
                started.set()  # well into the epoch before host 1 exists
            outs[0].append(_batch_key(b))
            time.sleep(0.02)  # slow consumer: leaves work for the joiner
        dl.release_coordination()

    def run_late():
        started.wait(timeout=60)
        dl = _loader(ds, coord, host=1)
        for b in dl:
            outs[1].append(_batch_key(b))
        dl.release_coordination()

    ts = [threading.Thread(target=run_early), threading.Thread(target=run_late)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
        assert not t.is_alive(), "elastic fleet hung"
    assert sorted(outs[0] + outs[1]) == _reference_batches(ds)
    assert outs[1], "the mid-epoch joiner never got a batch"


def test_loader_restart_scenario(dataset, tmp_path):
    """The examples/elastic_restart.py scenario, loader-level: a host stops
    mid-epoch (clean shutdown), a replacement finishes the SAME epoch from
    the shared board, and the union of delivered batches is exact."""
    coord = tmp_path / "coord"
    dl = _loader(dataset, coord, host=0)
    first, it = [], iter(dl)
    for _ in range(3):
        first.append(_batch_key(next(it)))
    it.shutdown()
    dl.release_coordination()  # clean leave: claims become reapable at once
    dl2 = _loader(dataset, coord, host=1)
    rest = [_batch_key(b) for b in dl2]
    dl2.release_coordination()
    ref = _reference_batches(dataset)
    union = sorted(set(first) | set(rest))
    assert union == ref, "restart lost or fabricated batches"
    # at-least-once: the stopped host's unconfirmed tail may be re-run, but
    # nothing outside the epoch's batch set ever appears
    assert not set(rest) - set(ref)


def test_loader_elastic_guard_rails(dataset, tmp_path):
    ecfg = _ecfg(tmp_path / "c")
    with pytest.raises(ValueError, match="num_hosts=1"):
        ConcurrentDataLoader(
            dataset,
            LoaderConfig(impl="threaded", batch_size=BS, elastic=ecfg),
            host_id=0, num_hosts=2,
        )
    from repro_torch.config import PipelineConfig
    with pytest.raises(ValueError, match="legacy loader path"):
        ConcurrentDataLoader(
            dataset,
            LoaderConfig(impl="threaded", batch_size=BS, elastic=ecfg,
                         pipeline=PipelineConfig(enabled=True)),
        )
    with pytest.raises(ValueError, match="coord_dir"):
        ConcurrentDataLoader(
            dataset,
            LoaderConfig(impl="threaded", batch_size=BS,
                         elastic=ElasticConfig(enabled=True)),
        )


# ---------------------------------------------------------------------------
# chaos lane (nightly: pytest -m chaos)
# ---------------------------------------------------------------------------


@pytest.mark.chaos
def test_chaos_sigkill_member_epoch_completes(chaos_dir, tmp_path):
    """Tentpole claim: SIGKILL a member mid-epoch; a survivor takes over its
    unconfirmed tail and the fleet union still covers the epoch exactly
    (at-least-once, dedupable)."""
    out = str(tmp_path / "victim.jsonl")
    ctx = multiprocessing.get_context("spawn")
    p = ctx.Process(target=chaos_victim, args=(chaos_dir, out, 3))
    p.start()
    assert reap([p], 120) == [-signal.SIGKILL]  # died the hard way
    victim = [tuple(json.loads(ln)) for ln in open(out) if ln.strip()]
    assert len(victim) == 3
    ds = _dataset()
    dl = _loader(ds, chaos_dir, host=1, lease_ttl_s=1.0)
    survivor = [_batch_key(b) for b in dl]
    dl.release_coordination()
    ref = _reference_batches(ds)
    union = sorted(set(victim) | set(survivor))
    assert union == ref, "SIGKILL lost part of the epoch"
    assert not set(survivor) - set(ref)
    # the victim's death is visible in the membership audit trail
    audit_path = os.path.join(chaos_dir, "membership_audit.jsonl")
    events = [json.loads(ln) for ln in open(audit_path) if ln.strip()]
    assert any(e["event"] in ("reap", "leave") for e in events)


@pytest.mark.chaos
def test_chaos_clock_skew_lease_expiry(chaos_dir):
    """A host whose clock runs ahead reaps a freshly-heartbeaten peer (the
    skew hazard); the fleet must converge anyway: the reaped host re-joins
    on its next heartbeat and its shard is taken over, not lost."""
    t_a, t_b = {"t": 1_000.0}, {"t": 1_000.0}
    mem_a = MembershipBoard(chaos_dir, member="a", ttl_s=5,
                            clock=lambda: t_a["t"])
    mem_b = MembershipBoard(chaos_dir, member="b", ttl_s=5,
                            clock=lambda: t_b["t"])
    mem_a.join()
    mem_b.join()
    board_a = EpochShardBoard(chaos_dir, owner="a", ttl_s=5,
                              clock=lambda: t_a["t"], membership=mem_a)
    board_b = EpochShardBoard(chaos_dir, owner="b", ttl_s=5,
                              clock=lambda: t_b["t"], membership=mem_b)
    board_a.setup(0, 4, 4)
    ca = board_a.claim_next(0)
    assert ca.shard == 0
    # b's clock jumps far ahead: a's fresh lease looks expired to b
    t_b["t"] += 60
    mem_a.heartbeat()  # a is alive and heartbeating...
    gen_before = mem_a.generation()
    mem_b.heartbeat()  # ...but skewed b reaps it anyway
    assert not mem_b.is_live("a")
    cb = board_b.claim_next(0)
    assert cb is not None and cb.shard == 0  # work taken over, not orphaned
    # convergence: a's next heartbeat re-joins it with a generation bump
    gen_after = mem_a.heartbeat()
    assert gen_after > gen_before
    assert mem_b.is_live("a") or mem_a.is_live("a")
    audit = [json.loads(ln)
             for ln in open(os.path.join(chaos_dir, "membership_audit.jsonl"))
             if ln.strip()]
    assert any(e["event"] == "reap" and e["member"] == "a" for e in audit)


@pytest.mark.chaos
def test_chaos_torn_membership_log_tail(chaos_dir):
    """Kill-between-write-and-newline on the membership append-log: the next
    board operation truncates the torn tail and the fleet keeps going."""
    mem = MembershipBoard(chaos_dir, member="a", ttl_s=10)
    mem.join()
    seg = os.path.join(chaos_dir, "membership.seg00000000.log")
    with open(seg, "ab") as f:
        f.write(b'{"op":"join","m":"ghost","e":9')  # torn: no newline
    fresh = MembershipBoard(chaos_dir, member="b", ttl_s=10)
    fresh.join()
    assert fresh._log.torn_tails_recovered == 1
    live = fresh.live()
    assert "ghost" not in live  # the unacknowledged join never happened
    assert {"a", "b"} <= set(live)
