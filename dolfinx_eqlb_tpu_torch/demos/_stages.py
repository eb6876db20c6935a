"""Host-clock seconds of the demos' stages, synchronised on a CUDA
device so that a stage's time includes its device work."""

from __future__ import annotations

import time

import torch


class Stages:
    """``stages(name, fn)`` runs ``fn()``, adds its seconds to
    ``stages.s[name]`` and returns its result."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.s: dict[str, float] = {}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __call__(self, name, fn):
        self._sync()
        t0 = time.perf_counter()
        out = fn()
        self._sync()
        self.s[name] = self.s.get(name, 0.0) + time.perf_counter() - t0
        return out
