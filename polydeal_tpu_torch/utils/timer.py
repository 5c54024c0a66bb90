"""Named-scope wall timing, the TimerOutput analogue.

Counterpart of ``polydeal_tpu/utils/timer.py`` ``Timer``: host-clock
scopes with a printable summary (the reference's deal.II ``TimerOutput``,
monodomain_DG3D.cc:651,787-790).  A scope given a CUDA tensor or device
synchronises that device at its exit, so the device work it launched is
inside its time.  The JAX package's ``chained_cost`` (dispatch-free cost
from two ``lax.scan`` lengths) and its XLA compilation cache have no
counterpart: CUDA events time device work directly, and nothing is
compiled per program.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import torch

__all__ = ["Timer"]


def _cuda_device(sync):
    if sync is None:
        return None
    dev = sync.device if isinstance(sync, torch.Tensor) else torch.device(
        sync)
    return dev if dev.type == "cuda" else None


class Timer:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextmanager
    def scope(self, name: str, sync=None):
        """Time the block on the host clock; ``sync`` (a tensor or a
        device) names a CUDA device to synchronise before the clock
        stops."""
        dev = _cuda_device(sync)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if dev is not None:
                torch.cuda.synchronize(dev)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        lines = ["+---------------------------------+------------+-------+"]
        lines.append("| scope                           | total [s]  | calls |")
        lines.append("+---------------------------------+------------+-------+")
        for k in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(f"| {k:<31} | {self.totals[k]:>10.4f} | "
                         f"{self.counts[k]:>5} |")
        lines.append("+---------------------------------+------------+-------+")
        return "\n".join(lines)
