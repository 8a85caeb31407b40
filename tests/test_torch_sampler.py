"""Twins of ``tests/test_sampler.py`` on the port alone: the same cases
and assertions with the imports pointed at ``repro_torch``."""
import pytest

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # bare interpreter: skip only the property-based tests
    from _hypothesis_fallback import given, settings, st

pytest.importorskip("torch")

from repro_torch.core.sampler import (  # noqa: E402
    ShardedBatchSampler,
    epoch_permutation,
    shard_plan,
)


def collect(s):
    return list(s)


def test_deterministic_across_instances():
    a = ShardedBatchSampler(100, 10, seed=5)
    b = ShardedBatchSampler(100, 10, seed=5)
    assert [x.indices for x in a] == [x.indices for x in b]


def test_epochs_differ():
    s = ShardedBatchSampler(100, 10, seed=5)
    e0 = [x.indices for x in s]  # epoch auto-advances
    e1 = [x.indices for x in s]
    assert e0 != e1


def test_no_shuffle_is_sequential():
    s = ShardedBatchSampler(20, 5, shuffle=False)
    batches = collect(s)
    assert batches[0].indices == (0, 1, 2, 3, 4)
    assert batches[3].indices == (15, 16, 17, 18, 19)


def test_drop_last():
    s = ShardedBatchSampler(23, 5, shuffle=False, drop_last=True)
    assert len(collect(s)) == 4
    s2 = ShardedBatchSampler(23, 5, shuffle=False, drop_last=False)
    got = collect(s2)
    assert len(got) == 5 and len(got[-1].indices) == 3


@given(
    n_hosts=st.sampled_from([1, 2, 4, 8]),
    ds_len=st.integers(64, 400),
    gbs=st.sampled_from([8, 16, 32]),
    seed=st.integers(0, 1_000),
)
@settings(max_examples=30, deadline=None)
def test_shard_coverage_property(n_hosts, ds_len, gbs, seed):
    """Union of per-host slices == the global batch; slices are disjoint."""
    per_host = [
        collect(ShardedBatchSampler(ds_len, gbs, seed=seed, host_id=h, num_hosts=n_hosts))
        for h in range(n_hosts)
    ]
    n_batches = ds_len // gbs
    perm = epoch_permutation(ds_len, seed, 0, True)
    for b in range(n_batches):
        expected = list(map(int, perm[b * gbs : (b + 1) * gbs]))
        got = []
        for h in range(n_hosts):
            assert per_host[h][b].batch_id == b
            got.extend(per_host[h][b].indices)
        assert sorted(got) == sorted(expected)
        assert len(set(got)) == len(got)  # disjoint


def test_elastic_reshard_pure_function():
    """shard_plan is pure: changing membership re-partitions the same batch."""
    batch = list(range(32))
    before = [shard_plan(batch, h, 4) for h in range(4)]
    after = [shard_plan(batch, h, 8) for h in range(8)]
    assert sorted(sum(before, [])) == batch == sorted(sum(after, []))


def test_resume_reproduces_stream():
    s = ShardedBatchSampler(128, 16, seed=9)
    it = iter(s)
    consumed = [next(it) for _ in range(3)]
    state = s.state_dict()
    rest = list(it)

    s2 = ShardedBatchSampler(128, 16, seed=9)
    s2.load_state_dict(state)
    resumed = list(s2)
    assert [b.indices for b in resumed] == [b.indices for b in rest]
    assert resumed[0].batch_id == consumed[-1].batch_id + 1


def test_epoch_permutations_are_permutations():
    p = epoch_permutation(1000, 3, 7, True)
    assert sorted(p.tolist()) == list(range(1000))
