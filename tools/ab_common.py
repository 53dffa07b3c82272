"""What the card tools share (tools/occlusion_ab.py, tools/raster_soft_ab.py,
tools/pri_fwd_rules.py): raytpu_torch loaded from a checkout beside this
checkout's chip_smoke.py, a digest of the bits, the host's timers and the
JSON record. To compare two checkouts, run a tool once for each in turns
(A, B, B, A) on the same card, and compare the digests and the medians.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]


def load(tree: Path, tool: str):
    """Put TREE's raytpu_torch first on the path and return this
    checkout's chip_smoke.py as a module (its cases, timers and checks).
    Exits with the tool's name where there is no CUDA device or
    raytpu_torch does not come from TREE."""
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import raytpu_torch
    if not torch.cuda.is_available():
        raise SystemExit(f"{tool}: no CUDA device")
    if not Path(raytpu_torch.__file__).resolve().is_relative_to(tree):
        raise SystemExit(f"{tool}: raytpu_torch is not {tree}'s")
    torch.cuda.set_device(torch.device("cuda", 0))
    smoke.OUT.mkdir(parents=True, exist_ok=True)
    return smoke


def digest(ts) -> str:
    """sha256 of a tensor's bits, or of a sequence of tensors' in turn."""
    h = hashlib.sha256()
    for t in (ts,) if torch.is_tensor(ts) else ts:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def host_us(fn, hold_cycles: int, n: int = 20, reps: int = 15) -> float:
    """Median host time of one call of fn: n calls enqueued while a
    device-side sleep holds the stream, so the host never waits on it."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(hold_cycles)
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        times.append((time.perf_counter() - t0) / n)
        torch.cuda.synchronize()
    return statistics.median(times) * 1e6


def wall_ms(fn, n: int = 15) -> tuple[float, float]:
    """Median ms of one call of fn on the host's clock, from an idle device
    to the call's return and to the device's end."""
    back, done = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        back.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        done.append(time.perf_counter() - t0)
    return statistics.median(back) * 1e3, statistics.median(done) * 1e3


def write(out: Path, record: dict) -> None:
    """The tool's record as JSON at out."""
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=1))
