"""Tracing and timing helpers — the port's copy of
``mmbidaf_tpu.utils.profiling``.

- ``trace(dir)``: context manager around ``torch.profiler`` (CPU, and CUDA
  where the card is there) that writes a Chrome trace (``trace.json``) for
  chrome://tracing or perfetto.dev; ``tools/device_profile.py`` reads the
  same profiler into its device-op table;
- ``timeit``: wall-clock timing of a call, synchronised on the card
  (median over iters, warm-up calls excluded);
- ``Timer``: scoped host-side timer;
- ``debug_nans``: raises ``FloatingPointError`` at the first operation
  that produces a non-finite floating-point value.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


def profiler_activities() -> list:
    """The CPU, and CUDA where a card is there."""
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile everything inside the context; ``log_dir/trace.json`` holds
    the Chrome trace when it ends."""
    from torch.profiler import profile

    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=profiler_activities()) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _sync(out):
    """Wait for the card's work behind ``out`` (a tensor or a tree of them)."""
    if any(isinstance(t, torch.Tensor) and t.is_cuda for t in tree_leaves(out)):
        torch.cuda.synchronize()
    return out


def timeit(fn: Callable, *args, iters: int = 10, warmup: int = 1) -> dict:
    """Median wall-clock of ``fn(*args)``, each call synchronised on the
    card; the ``warmup`` calls (kernel builds, plans, cuDNN's choices) are
    not timed."""
    for _ in range(warmup):
        _sync(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _sync(fn(*args))
        times.append(time.perf_counter() - t0)
    return {
        "p50_s": float(np.median(times)),
        "mean_s": float(np.mean(times)),
        "min_s": float(np.min(times)),
        "iters": iters,
    }


class Timer:
    """Scoped host-side timer: ``with Timer() as t: ...; t.elapsed_s``."""

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed_s = time.perf_counter() - self._t0
        return False


class _NanCheck(TorchDispatchMode):
    """Checks every floating-point output of every operation."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if (isinstance(t, torch.Tensor) and t.is_floating_point() and t.numel()
                    and not bool(torch.isfinite(t).all())):
                raise FloatingPointError(f"non-finite value in the output of {func}")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Numerical sanitizer: inside the context, an operation whose output
    holds a NaN or an infinity raises ``FloatingPointError`` (each check
    waits for the card: for debugging, not for timing)."""
    if not enable:
        yield
        return
    with _NanCheck():
        yield
