"""The generator: deterministic in the seed, the same sizes for every
seed, and the mix files' parameters."""

import numpy as np
import pytest

from bench import traffic
from bench.tests.small import BENCH

MIXES = ("batch-sampled", "chat-shared", "chat-unshared")


def mix(name):
    return traffic.load(BENCH / "traffic" / f"{name}.json")


def take(m, seed, n, vocab=1000):
    it = traffic.requests(m, seed, vocab)
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    a, b = take(mix(name), 2 ** 31 + 11, 50), take(mix(name), 2 ** 31 + 11, 50)
    for x, y in zip(a, b):
        assert np.array_equal(x.prompt, y.prompt)
        assert (x.max_new, x.temperature, x.gap_s, x.tenant) == \
            (y.max_new, y.temperature, y.gap_s, y.tenant)
    c = take(mix(name), 2 ** 31 + 12, 50)
    assert any(not np.array_equal(x.prompt, y.prompt) for x, y in zip(a, c))


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_gets_the_same_sizes(name):
    m = mix(name)
    n = traffic.POOL
    sizes = [sorted((len(s.prompt), s.max_new) for s in take(m, seed, n))
             for seed in (1, 2 ** 33 + 5)]
    assert sizes[0] == sizes[1]
    if m["loop"] == "open":
        gaps = [sorted(s.gap_s for s in take(m, seed, n)) for seed in (1, 9)]
        assert gaps[0] == gaps[1]


def test_batch_sampled_lengths_follow_the_mix():
    m = mix("batch-sampled")
    specs = take(m, 3, traffic.POOL)
    p = np.array([len(s.prompt) for s in specs])
    o = np.array([s.max_new for s in specs])
    assert p.min() >= 128 and p.max() <= 3072
    assert o.min() >= 1 and o.max() <= 768
    assert (p + o).max() <= 4096
    assert abs(np.median(p) - 600) <= 5          # median of the lognormal
    assert 190 <= np.median(o) <= 205            # clipped by max_total
    # a lognormal's sigma from its quartiles: (ln q3 - ln q1) / 1.349
    q1, q3 = np.percentile(p, [25, 75])
    assert abs(np.log(q3 / q1) / 1.349 - 0.8) < 0.05
    greedy = sum(s.temperature == 0.0 for s in specs)
    assert greedy == traffic.POOL // m["greedy_every"]
    assert {s.temperature for s in specs} == {0.0, 1.0}


def test_chat_shared_prefixes_and_tenants():
    m = mix("chat-shared")
    specs = take(m, 4, traffic.POOL)
    by_tenant = {}
    for s in specs:
        assert s.shared == 1024 and len(s.prompt) >= 1024 + 16
        by_tenant.setdefault(s.tenant, []).append(s)
    # one system prompt a tenant, different across tenants
    heads = {t: ss[0].prompt[:1024] for t, ss in by_tenant.items()}
    for t, ss in by_tenant.items():
        assert all(np.array_equal(s.prompt[:1024], heads[t]) for s in ss)
    assert len({h.tobytes() for h in heads.values()}) == len(heads) == 8
    counts = [len(by_tenant[t]) for t in range(8)]
    assert counts == sorted(counts, reverse=True)        # Zipf: 0 first
    w = np.array([1 / (k + 1) ** 1.1 for k in range(8)])
    assert abs(counts[0] / traffic.POOL - w[0] / w.sum()) < 0.01
    gaps = np.array([s.gap_s for s in specs])
    assert abs(gaps.mean() * m["rate_rps"] - 1) < 0.01


def test_chat_unshared_leading_tokens_are_unique():
    specs = take(mix("chat-unshared"), 5, 200, vocab=49155)
    heads = {s.prompt[:1024].tobytes() for s in specs}
    assert len(heads) == len(specs)
    assert all(s.tenant == -1 for s in specs)


@pytest.mark.parametrize("name", MIXES)
def test_every_block_holds_one_request_of_each_stratum(name):
    m = mix(name)
    sizes = traffic.size_pool(m)
    edges = np.sort(sizes[:, 0])[::traffic.POOL // traffic.BLOCK]
    specs = take(m, 2 ** 31 + 77, 3 * traffic.BLOCK)
    for b in range(3):
        block = specs[b * traffic.BLOCK:(b + 1) * traffic.BLOCK]
        outs = sorted(len(s.prompt) - s.shared for s in block)
        # the i-th smallest prompt tail of a block lies in the i-th stratum
        assert all(o >= e for o, e in zip(outs, edges))
    if m["loop"] == "open":
        gaps = [sum(s.gap_s for s in specs[b * 32:(b + 1) * 32])
                for b in range(3)]
        mean = traffic.BLOCK / m["rate_rps"]
        assert all(abs(g / mean - 1) < 0.1 for g in gaps), gaps
