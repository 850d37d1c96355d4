"""R003 fixture (port forms): nondeterminism on the fused replay path."""
import time

import torch


class FusedWindowLoop:
    """Name-seeds the determinism sweep, like the real loop."""

    def execute(self, jobs):
        start = time.perf_counter()                 # wall clock
        noise = torch.randn(len(jobs))              # torch's global RNG
        return start, noise
