"""The traffic generator: fixed by the seed, the same sizes for every seed,
and every request within the context."""

import json
from collections import Counter
from pathlib import Path

import pytest

from portbench.traffic import Traffic, log_uniform_quantiles

HOME = Path(__file__).resolve().parents[1]
MIXES = sorted(p.stem for p in (HOME / "traffic").glob("*.json"))
BIG = 2 ** 31 + 12345


def mix(name):
    return json.loads((HOME / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", MIXES)
def test_fixed_by_seed(name):
    a, b = Traffic(mix(name), BIG, 50257), Traffic(mix(name), BIG, 50257)
    for i in (0, 1, 200, 5000):
        assert a.request(i) == b.request(i)
    assert Traffic(mix(name), BIG + 1, 50257).request(3).prompt != a.request(3).prompt


@pytest.mark.parametrize("name", MIXES)
def test_same_sizes_for_every_seed(name):
    m = mix(name)

    def sizes(seed):  # the first whole block after the first wave's cut budgets
        t = Traffic(m, seed, 50257)
        start = -(-t.clients // t.pool) * t.pool
        reqs = [t.request(i) for i in range(start, start + t.pool)]
        return Counter(len(r.prompt) for r in reqs), Counter(r.budget for r in reqs)

    assert sizes(7) == sizes(BIG)


@pytest.mark.parametrize("name", MIXES)
def test_every_request_fits(name):
    m = mix(name)
    t = Traffic(m, 11, 50257)
    assert t.longest() <= 1000
    for i in range(0, 3 * t.pool + t.clients, 7):
        r = t.request(i)
        assert 1 <= r.budget <= m["output"]["max"]
        assert len(r.prompt) + r.budget <= 1000
        assert all(0 <= x < 50257 for x in r.prompt)
        assert r.prompt[:r.shared] == t.prefix


def test_first_wave_budgets_are_cut():
    t = Traffic(mix("chat"), 5, 50257)
    full = log_uniform_quantiles(t.pool, 32, 320)
    cut = [t.request(i).budget for i in range(t.clients)]
    assert min(cut) >= 1 and max(cut) <= 320
    assert sum(cut) < 0.7 * t.clients * full.mean()


def test_quantiles():
    q = log_uniform_quantiles(4, 1, 10000)
    assert list(q) == [3, 32, 316, 3162]
