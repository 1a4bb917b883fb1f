"""Tracing and step timing.

Counterpart of ``enhancing_tpu/train/profiler.py``:

- :class:`StepTimer`: rolling wall-clock step timing with images/s,
  printed every N steps; host clocks only, it adds no device sync;
- :func:`trace`: a ``torch.profiler`` window over the CPU and, where there
  is one, the card, written as a Chrome trace (``trace.json``) into
  ``logdir``.
"""
from __future__ import annotations

import contextlib
import time
from collections import deque
from pathlib import Path
from typing import Iterator, Optional


class StepTimer:
    def __init__(self, window: int = 50, batch_size: Optional[int] = None,
                 print_every: Optional[int] = None) -> None:
        self.window = window
        self.batch_size = batch_size
        self.print_every = print_every
        self._times: deque = deque(maxlen=window + 1)
        self._step = 0

    def tick(self) -> None:
        self._times.append(time.perf_counter())
        self._step += 1
        if self.print_every and self._step % self.print_every == 0:
            print(f"[timer] {self.summary()}", flush=True)

    @property
    def steps_per_sec(self) -> float:
        if len(self._times) < 2:
            return 0.0
        dt = self._times[-1] - self._times[0]
        return (len(self._times) - 1) / max(dt, 1e-9)

    def summary(self) -> str:
        sps = self.steps_per_sec
        s = f"step {self._step}: {sps:.2f} steps/s"
        if self.batch_size:
            s += f", {sps * self.batch_size:.1f} images/s"
        return s


@contextlib.contextmanager
def trace(logdir: str, enabled: bool = True) -> Iterator[None]:
    """A ``torch.profiler`` window; its Chrome trace goes to
    ``logdir/trace.json``."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(str(Path(logdir) / "trace.json"))
