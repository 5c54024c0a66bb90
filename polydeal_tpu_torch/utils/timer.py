"""Named-scope wall timing, the TimerOutput analogue.

Counterpart of ``polydeal_tpu/utils/timer.py`` ``Timer``: host-clock
scopes with a printable summary (the reference's deal.II ``TimerOutput``,
monodomain_DG3D.cc:651,787-790).  A scope given a CUDA tensor or device
synchronises that device at its exit, so the device work it launched is
inside its time.  The JAX package's XLA compilation cache has no
counterpart: nothing is compiled per program.

:func:`chained_cost` is the per-application cost of a step, free of the
fixed cost of one call: the slope between two chain lengths, as the JAX
package's (there ``lax.scan`` chains; here, on a CUDA tensor, a captured
``torch.cuda.CUDAGraph`` of the chain, so that no host launch overhead
reaches the slope either).
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import torch

__all__ = ["Timer", "chained_cost"]


def chained_cost(step_fn, x0: torch.Tensor, *operands, n_small: int = 8,
                 n_large: int = 64, reps: int = 3) -> float:
    """Seconds per application of ``step_fn(x, *operands) -> x``.

    Times chains of ``n_small`` and ``n_large`` applications and returns
    ``(t(n_large) - t(n_small)) / (n_large - n_small)``.  On a CUDA tensor
    each chain is captured once as one ``torch.cuda.CUDAGraph`` (after a
    warm run on a side stream, which also builds and loads any kernel),
    replayed once to warm it and then timed with a host read of its
    result, best of ``reps``; a chain that cannot be captured raises (the
    eager loop is never timed in its place).  On the CPU each chain is a
    plain loop, timed the same way."""
    dev = x0.device

    def chain(x, n):
        for _ in range(n):
            x = step_fn(x, *operands)
        return x

    def best(run, out):
        run()
        float(out().sum())  # host read: warm and done
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            run()
            float(out().sum())
            ts.append(time.perf_counter() - t0)
        return min(ts)

    if dev.type != "cuda":
        chain(x0, n_large)  # wakes the host's thread pool
    times = []
    for n in (n_small, n_large):
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                side = torch.cuda.Stream(dev)
                side.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(side):
                    chain(x0, n)
                torch.cuda.current_stream(dev).wait_stream(side)
                torch.cuda.synchronize(dev)
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):  # raises if it cannot capture
                    y = chain(x0, n)
                times.append(best(graph.replay, lambda: y))
        else:
            box = [x0]
            times.append(best(lambda: box.__setitem__(0, chain(x0, n)),
                              lambda: box[0]))
    return (times[1] - times[0]) / (n_large - n_small)


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
