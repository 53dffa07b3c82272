"""The labs' estimators (raytpu_torch/labs/timing.py) against bench.py's:
``_lsq`` and ``_slope`` on tests/test_bench_slope.py's synthetic ladders
(equal slope, fixed cost, uncertainty, retries, the raw batches), lab 4's
batch-minimum slope on a synthetic ``time_at``, and the chains on the CPU
(each calls its function the expected number of times and feeds each
output into the next input)."""

import random
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import bench  # noqa: E402

from raytpu_torch.labs import timing  # noqa: E402

TRUE_MS, FIXED_MS, LENGTHS = 0.4, 15.0, (20, 60, 100)


def _clean(n):
    return FIXED_MS + TRUE_MS * n


def _ladders():
    """Fresh generators of test_bench_slope.py's cases (each call gives a
    new one, so the two estimators see the same numbers)."""
    def clean():
        return lambda n: [_clean(n)] * 6

    def isolated():
        def time_at(n):
            bs = [_clean(n)] * 6
            bs[0] += 200.0
            return bs
        return time_at

    def majority():
        calls = {n: 0 for n in LENGTHS}

        def time_at(n):
            calls[n] += 1
            if calls[n] == 1 and n == LENGTHS[0]:
                return [_clean(n) + 200.0] * 4 + [_clean(n)] * 2
            return [_clean(n)] * 6
        return time_at

    def persistent():
        state = {"k": 0}

        def time_at(n):
            out = []
            for _ in range(6):
                state["k"] += 1
                out.append(_clean(n) + (150.0 if state["k"] % 2 == 0
                                        else 0.0))
            return out
        return time_at

    def jitter():
        rng = random.Random(0)
        return lambda n: [_clean(n) * (1.0 + 0.01 * rng.random())
                          for _ in range(6)]

    return {"clean": clean, "isolated": isolated, "majority": majority,
            "persistent": persistent, "jitter": jitter}


def test_lsq_matches_bench():
    xs, ys = [20, 60, 100], [15.3, 38.9, 55.1]
    assert timing._lsq(xs, ys) == bench._lsq(xs, ys)
    b, a = timing._lsq(list(LENGTHS), [_clean(n) for n in LENGTHS])
    assert abs(b - TRUE_MS) < 1e-9 and abs(a - FIXED_MS) < 1e-9


@pytest.mark.parametrize("ladder", list(_ladders()))
def test_slope_matches_bench(ladder):
    make = _ladders()[ladder]
    got, got_diag = timing._slope(make(), LENGTHS)
    want, want_diag = bench._slope(make(), LENGTHS)
    assert got == want
    assert got_diag == want_diag
    retries = {"clean": 0, "isolated": 0, "majority": 1, "persistent": 2,
               "jitter": 0}[ladder]
    assert got_diag["retries"] >= 1 if ladder == "majority" else (
        got_diag["retries"] == retries)
    if ladder != "persistent":
        assert abs(got - TRUE_MS) < 0.02
    else:
        assert got_diag["unc_ms"] > 0.25 * got


def test_lab4_min_slope():
    assert timing.min_slope(lambda n: [_clean(n)] * 4, 5, 40) == \
        pytest.approx(TRUE_MS)

    def stalled(n):  # one stalled batch a length: the minimum drops it
        return [_clean(n) + 80.0] + [_clean(n)] * 3

    assert timing.min_slope(stalled, 5, 40) == pytest.approx(TRUE_MS)


def test_slope_time_chains_and_feeds_on_the_cpu():
    seen = []

    def fn(x):
        seen.append(x.clone())
        return x * 2.0, (x > 0).to(torch.int32)

    x = torch.ones(8)
    ms = timing.slope_time(fn, x, n_lo=2, n_hi=5, batches=3, reps=2)
    assert isinstance(ms, float) and ms == ms
    # A warm-up chain and batches x reps chains at each length.
    assert len(seen) == (1 + 3 * 2) * (2 + 5)
    # Each chain starts from x plus its own offset; x is never written.
    assert torch.equal(x, torch.ones(8))


def test_chain_fwd_chains_and_feeds_on_the_cpu():
    calls = []

    def render(x):
        calls.append(1)
        return x * 3.0

    x = torch.full((4,), 1e21)  # large enough that the feed shows
    ms, diag = timing.chain_fwd(render, x, lengths=(2, 3, 4), batches=2,
                                reps=1)
    n = 2 + (1 + diag["retries"]) * 2 * (2 + 3 + 4)
    assert len(calls) == n and set(diag) >= {"slope_ms", "unc_ms", "retries"}
    assert torch.equal(x, torch.full((4,), 1e21))
    # The chain feeds mean x 1e-20 of each output into the next input.
    carry = timing._perturbed(x, 0.0)
    out = render(carry)
    timing._feed(carry, out.mean(), 1e-20)
    assert float(carry[0]) == pytest.approx(1e21 + 3e21 * 1e-20)
