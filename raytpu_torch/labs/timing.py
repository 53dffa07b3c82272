"""The labs' timing estimators (counterparts of bench.py:75-188 and
bench/megakernel_lab4.py:32-59).

  _lsq, _slope       bench.py's regression over >= 3 chain lengths, copied:
                     the least-squares slope of each length's batch median,
                     with the leave-one-out uncertainty, the stall retry and
                     the raw batches in the diag.
  time_batches       per-call ms of ``reps`` calls a batch: CUDA events on
                     the current stream for a CUDA result, the host clock
                     (time.perf_counter) for a CPU one, which only the
                     tests use.
  chain_fwd          bench.py's ``_chain_fwd``: ms per forward. JAX chains n
                     forwards through a carry inside one jit; here the n
                     forwards launch back to back on one stream between two
                     events, and each output's mean x 1e-20 is added to the
                     next call's input, so no launch can be skipped or
                     hoisted.
  slope_time         lab 4's own estimator: chains of 5 and 40, the
                     difference of the batch minima over the 35 calls
                     between them, each output's sum x 1e-30 added to the
                     next input.
"""

from __future__ import annotations

import statistics
import time

import torch


def _lsq(xs, ys):
    """Least-squares slope + intercept for y = a + b*x."""
    n = len(xs)
    mx = sum(xs) / n
    my = sum(ys) / n
    sxx = sum((x - mx) ** 2 for x in xs)
    b = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / sxx
    return b, my - b * mx


def _slope(time_at, lengths):
    """Per-iteration ms via a regression over >= 3 chain lengths (bench.py's
    estimator): the least-squares slope of the per-length batch median, its
    uncertainty the larger half-spread of the leave-one-batch-out and
    leave-one-length-out slopes, up to two retries that add batches while
    the slope is not positive or its uncertainty exceeds a quarter of it.

    time_at(n) -> list of per-call times (ms) for an n-iteration chain.
    Returns (slope_ms, diag).
    """
    lengths = sorted(lengths)
    assert len(lengths) >= 3, "regression slope needs >= 3 chain lengths"
    batches = {n: time_at(n) for n in lengths}

    def fit(drop_len=None, drop_batch=None):
        xs, ys = [], []
        for n in lengths:
            if n == drop_len:
                continue
            bs = list(batches[n])
            if drop_batch is not None and drop_batch[0] == n:
                bs = bs[:drop_batch[1]] + bs[drop_batch[1] + 1:]
            xs.append(n)
            ys.append(statistics.median(bs))
        return _lsq(xs, ys)

    def refit():
        slope, fixed = fit()
        loo = [fit(drop_batch=(n, k))[0]
               for n in lengths for k in range(len(batches[n]))]
        loo_len = [fit(drop_len=n)[0] for n in lengths]
        unc = max((max(loo) - min(loo)) / 2.0,
                  (max(loo_len) - min(loo_len)) / 2.0)
        return slope, fixed, unc

    slope, fixed, unc = refit()
    # Stall retry: more batches (none discarded) restore the median when
    # stalls hit most of one length's batches.
    retries = 0
    while (slope <= 0 or unc > 0.25 * slope) and retries < 2:
        retries += 1
        for n in lengths:
            batches[n] = batches[n] + time_at(n)
        slope, fixed, unc = refit()
    if slope <= 0:  # pathological stall pattern; conservative bound
        slope = min(batches[lengths[-1]]) / lengths[-1]
    hi = batches[lengths[-1]]
    diag = {
        "slope_ms": round(slope, 4),
        "unc_ms": round(unc, 4),
        "fixed_ms": round(fixed, 2),
        "retries": retries,
        "lengths": lengths,
        "batches_ms": {str(n): [round(t, 2) for t in batches[n]]
                       for n in lengths},
        "spread": round(
            (statistics.median(hi) - min(hi)) / min(hi), 3),
    }
    return slope, diag


class _Clock:
    """Elapsed ms between start() and stop(): CUDA events on the current
    stream on a CUDA device, the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def start(self):
        if self.cuda:
            self.begin = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)
            self.begin.record()
        else:
            self.t0 = time.perf_counter()

    def stop(self) -> float:
        if self.cuda:
            self.end.record()
            self.end.synchronize()
            return self.begin.elapsed_time(self.end)
        return (time.perf_counter() - self.t0) * 1e3


def time_batches(fn, args_for_batch, device, batches=6, reps=2):
    """Per-call ms of fn: ``reps`` calls a batch, timed together; the
    arguments vary per (batch, rep) through ``args_for_batch(k)``."""
    clock = _Clock(torch.device(device))
    times = []
    for b in range(batches):
        clock.start()
        for r in range(reps):
            fn(*args_for_batch(b * reps + r))
        times.append(clock.stop() / reps)
    return times


def _perturbed(x, eps: float):
    """A fresh copy of x (a tensor, or a dataclass of tensors) plus eps."""
    if isinstance(x, torch.Tensor):
        return x + eps
    return type(x)(**{k: v + eps if v.is_floating_point() else v
                      for k, v in vars(x).items()})


def _feed(x, value: torch.Tensor, alpha: float) -> None:
    """x += alpha * value in place (every float leaf of a dataclass)."""
    leaves = [x] if isinstance(x, torch.Tensor) else list(vars(x).values())
    for leaf in leaves:
        if leaf.is_floating_point():
            leaf.add_(value, alpha=alpha)


def _device_of(x) -> torch.device:
    if isinstance(x, torch.Tensor):
        return x.device
    return next(iter(vars(x).values())).device


def chain_fwd(render_fn, x, lengths=(10, 30, 50), batches=6, reps=2):
    """ms per forward: n calls of render_fn back to back, each output's
    mean x 1e-20 added to the next call's input x (a tensor or a dataclass
    of tensors), regressed over the chain lengths (_slope). Returns
    (slope_ms, diag)."""
    device = _device_of(x)

    def chained(eps, iters):
        carry = _perturbed(x, eps)
        for _ in range(iters):
            out = render_fn(carry)
            _feed(carry, out.mean(), 1e-20)
        return carry

    chained(0.0, lengths[0])  # warm up

    def time_at(n):
        return time_batches(chained, lambda k: (k * 1e-30, n), device,
                            batches=batches, reps=reps)

    return _slope(time_at, lengths)


def slope_time(fn, x, n_lo=5, n_hi=40, batches=4, reps=2):
    """Lab 4's estimator (megakernel_lab4.py:32-59): chains of n_lo and
    n_hi calls of fn, each call's outputs summed x 1e-30 into the next
    input; (min(hi) - min(lo)) / (n_hi - n_lo) over the batches, in ms."""
    device = _device_of(x)

    def chained(eps, iters):
        carry = x + eps
        for _ in range(iters):
            out = fn(carry)
            total = sum(o.sum(dtype=torch.float32) for o in out)
            carry.add_(total, alpha=1e-30)
        return carry

    def time_at(n):
        chained(0.0, n)  # warm up
        return time_batches(chained, lambda k: (k * 1e-30, n), device,
                            batches=batches, reps=reps)

    return min_slope(time_at, n_lo, n_hi)


def min_slope(time_at, n_lo: int, n_hi: int) -> float:
    """Lab 4's slope: the difference of the batch minima of time_at(n_hi)
    and time_at(n_lo) over n_hi - n_lo."""
    lo, hi = time_at(n_lo), time_at(n_hi)
    return (min(hi) - min(lo)) / (n_hi - n_lo)
