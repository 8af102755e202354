"""The serving schedule and request mix: the same work (arrival times and
sizes, in one order) for every seed, which draws only what the requests
sample."""

import json
from collections import Counter

import pytest

from benchmark import harness
from benchmark.drivers import serve

TRAFFIC = json.loads((harness.HERE / "traffic" / "poisson_b32.json")
                     .read_text())


def test_same_seed_same_schedule():
    a = serve.schedule(TRAFFIC, 2 ** 31 + 17, 30.0)
    b = serve.schedule(TRAFFIC, 2 ** 31 + 17, 30.0)
    assert a == b


@pytest.mark.parametrize("seeds", [(1, 2), (5, 3_000_000_000)])
def test_every_seed_offers_the_same_work(seeds):
    a, b = (serve.schedule(TRAFFIC, s, 30.0) for s in seeds)
    assert [x[0] for x in a] == pytest.approx([x[0] for x in b])
    assert [x[1] for x in a] == [x[1] for x in b]
    assert {x[2] for x in a}.isdisjoint({x[2] for x in b})


def test_rate_count_and_shares():
    s = serve.schedule(TRAFFIC, 9, 30.0)
    assert len(s) == round(TRAFFIC["rate"] * 30.0)
    assert all(0 < x[0] < 30.0 for x in s)
    sizes = Counter(x[1] for x in s)
    for size, share in TRAFFIC["sizes"]:
        assert abs(sizes[size] - share * len(s)) <= 1


def test_generation_seeds_and_rows_repeat():
    from benchmark.drivers import generate
    assert generate.check_rows(77, 3, 256, 2) == \
        generate.check_rows(77, 3, 256, 2)
    seeds = {generate.call_seed(2 ** 32, k) for k in range(100)}
    assert len(seeds) == 100 and max(seeds) < 2 ** 63
