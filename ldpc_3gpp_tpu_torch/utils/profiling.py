"""Profiling helpers.

The reference has no profiling at all (SURVEY.md section 5).  Here:

- ``trace(path)``: context manager around ``torch.profiler`` (host and, where
  a card is present, device activity) that writes a Chrome trace to ``path``
  (open it in Perfetto or chrome://tracing).
- ``slope_time(f, x)``: per-call seconds of ``f(x)`` as the slope between
  two runs of chained calls, so fixed costs (the first launch, the final
  wait) cancel.  CUDA events time a CUDA tensor's calls on the device; the
  host clock times a CPU tensor's.
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
