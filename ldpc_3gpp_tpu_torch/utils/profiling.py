"""Profiling helpers.

The reference has no profiling at all (SURVEY.md section 5).  Here:

- ``trace(path)``: context manager around ``torch.profiler`` (host and, where
  a card is present, device activity) that writes a Chrome trace to ``path``
  (open it in Perfetto or chrome://tracing).
- ``slope_time(f, x)``: per-call seconds of ``f(x)`` as the slope between
  two runs of chained calls, so fixed costs (the first launch, the final
  wait) cancel.  CUDA events time a CUDA tensor's calls on the device; the
  host clock times a CPU tensor's.
- ``time_ms(fn, reps)``: mean milliseconds of ``fn()`` after a warm-up, by
  CUDA events (or the host clock for ``device='cpu'``).
- ``loop_times(steps_by_name, steps, calls, reps, device)``: the
  benchmark's harness for ablations: ``calls`` calls of ``steps`` steps whose
  results are summed on the device, one host fetch at the end, the programs
  timed in turns; the median over ``reps``.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(path: str = "results/torch_trace.json"):
    """Profile the block and write its Chrome trace to ``path``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with profile(activities=activities) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)


def _run_seconds(f, x, k: int) -> float:
    """Seconds of ``k`` calls of ``f(x)``, waited for to the end."""
    if x.device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(k):
            f(x)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    for _ in range(k):
        f(x)
    return time.perf_counter() - t0


def slope_time(f, x, k_lo: int = 2, k_hi: int = 18, reps: int = 5) -> float:
    """Per-call seconds of ``f(x)``: (best of ``reps`` runs of ``k_hi``
    calls - best of ``reps`` runs of ``k_lo``) / (k_hi - k_lo)."""
    _run_seconds(f, x, 1)  # warm up (caches, first launch)

    def best(k):
        return min(_run_seconds(f, x, k) for _ in range(reps))

    return (best(k_hi) - best(k_lo)) / (k_hi - k_lo)


def time_ms(fn, reps: int, warmup: int = 2, device="cuda") -> float:
    """Mean milliseconds of ``fn`` over ``reps`` calls after ``warmup``: by
    CUDA events on a CUDA device, by the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def loop_times(steps_by_name, steps: int, calls: int = 4, reps: int = 5,
               device="cuda") -> dict:
    """{name: median seconds per call} of ``calls`` calls of ``steps`` steps
    of each ``step`` in ``steps_by_name``.

    ``step()`` returns a tensor on ``device``; its sum is accumulated on the
    device across every step of every call, and one host fetch of the sum
    ends a repetition (the only synchronisation, as in ``bench.py``).  After
    a warm-up call of each, the programs are timed in turns, ``reps`` rounds
    of one repetition each, so that a drift of the host's speed falls on all
    of them alike; the median over the rounds is returned."""
    def run(step, n_calls):
        acc = torch.zeros((), dtype=torch.float64, device=device)
        for _ in range(n_calls * steps):
            acc += step().sum(dtype=torch.float64)
        return float(acc)  # the one fetch

    for step in steps_by_name.values():
        run(step, 1)
    times = {name: [] for name in steps_by_name}
    for _ in range(reps):
        for name, step in steps_by_name.items():
            t0 = time.perf_counter()
            run(step, calls)
            times[name].append((time.perf_counter() - t0) / calls)
    return {name: sorted(t)[len(t) // 2] for name, t in times.items()}
