from collections import Counter

import numpy as np
import pytest

from perfbench.harness import spec

GEN = spec.load_module(spec.PACKAGE / "traffic" / "closed_loop.py", "traffic")


def _requests(mix, seed, n, vocab=1000):
    g = GEN.make(mix, seed, vocab)
    return [g.next() for _ in range(n)]


@pytest.mark.parametrize("mix", spec.list_traffic())
def test_same_seed_same_requests(mix):
    p = spec.load_json(spec.PACKAGE / "traffic" / f"{mix}.json")
    a = _requests(p, 2 ** 31 + 77, 40)
    b = _requests(p, 2 ** 31 + 77, 40)
    c = _requests(p, 5, 40)
    assert all(np.array_equal(x[0], y[0]) and x[1] == y[1]
               for x, y in zip(a, b))
    assert any(not np.array_equal(x[0], y[0]) for x, y in zip(a, c))


@pytest.mark.parametrize("mix", spec.list_traffic())
def test_lengths_hold_their_ranges_and_blocks(mix):
    p = spec.load_json(spec.PACKAGE / "traffic" / f"{mix}.json")
    block = p["block"]
    reqs = _requests(p, 123456789012, 2 * block, vocab=49152)
    for prompt, n_out in reqs:
        assert p["prompt"]["min"] <= len(prompt) <= p["prompt"]["max"]
        assert p["output"]["min"] <= n_out <= p["output"]["max"]
        assert prompt.dtype == np.int32
        assert 0 <= prompt.min() and prompt.max() < 49152
    # every block of ``block`` requests holds the same lengths, whatever
    # the seed: the seed changes the order, not the work
    other = _requests(p, 3, block, vocab=49152)
    for part in (reqs[:block], reqs[block:]):
        assert Counter(len(x) for x, _ in part) == Counter(
            len(x) for x, _ in other)
        assert Counter(n for _, n in part) == Counter(n for _, n in other)


def test_stratified_lengths_by_hand():
    p = {"median": 100, "sigma": 0.5, "min": 60, "max": 150}
    lens = GEN.prompt_lengths(p, 4)
    # quantiles 1/8, 3/8, 5/8, 7/8 of exp(ln 100 + 0.5 z), clipped
    assert lens == [60, 85, 117, 150]
    assert GEN.output_lengths({"min": 1, "max": 8}, 8) == list(range(1, 9))
