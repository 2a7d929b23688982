"""The benchmark's own spans around calls into the program.

A driver opens ``spans.phase(name)`` around each phase of a unit (the
forward pass, the backward pass). Outside a traced unit ``spans`` is
None and a phase costs nothing; in one, each phase ends in a
synchronize, its host-clock seconds are kept by name, and it is a
profiler range named ``bench.<name>``, so device time and host launch
calls can be read per phase from the trace."""
from __future__ import annotations

import contextlib
import time

import torch


class Spans:
    def __init__(self, device: torch.device):
        self.device = device
        self.seconds: dict = {}

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str):
        self.sync()
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"bench.{name}"):
            yield
            self.sync()
        self.seconds[name] = self.seconds.get(name, 0.0) \
            + time.perf_counter() - t0


def phase(spans: Spans | None, name: str):
    """``spans.phase(name)``, or nothing where the unit is not traced."""
    return contextlib.nullcontext() if spans is None else spans.phase(name)
