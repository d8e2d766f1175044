"""The sample of the window's requests that the comparison checks: drawn
from the seed as the requests finish, the same for the same seed, at most
``count`` held, and each finished request held with the same chance."""

from collections import Counter

import pytest

from gpubench.core.runner import Sample


def draw(count, n, seed):
    s = Sample(count, seed)
    held = []
    for i in range(n):
        slot = s.slot()
        if slot is not None:
            if slot == len(held):
                held.append(i)
            else:
                held[slot] = i
    assert len(s.held) == len(held)
    return sorted(held)


@pytest.mark.parametrize('count,n', [(1, 1), (2, 1), (2, 2), (1, 9), (2, 15)])
def test_holds_at_most_count_and_repeats_per_seed(count, n):
    seed = 2 ** 31 + 7
    got = draw(count, n, seed)
    assert len(got) == min(count, n) and len(set(got)) == len(got)
    assert got == draw(count, n, seed)


@pytest.mark.parametrize('count,n', [(1, 9), (2, 15)])
def test_every_request_as_likely(count, n):
    seeds = 3000
    hits = Counter(i for seed in range(seeds) for i in draw(count, n, seed))
    want = seeds * count / n
    assert set(hits) == set(range(n))
    assert all(abs(h - want) < 0.2 * want for h in hits.values()), hits
