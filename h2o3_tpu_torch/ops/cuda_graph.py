"""CUDA-graph capture and replay of the port's launch sequences, with
launch accounting that survives replay.

The kernel wrappers count a launch by adding one to a Python int
(``hist_cuda.launches`` and its peers, :func:`counters`). Under
``torch.cuda.graph`` a wrapper runs once, at capture, and the card then runs
its kernel at every replay. :class:`LaunchGraph` therefore takes back what
the counters moved during capture (nothing ran on the card then), keeps it
on the graph object, and adds it again at every :meth:`LaunchGraph.replay`:
a counter keeps meaning "launches on the card".

Capture runs a function once on the capture stream. Everything a capture
must not do happens before it, in :func:`warm_up`: an eager run of the same
function on a side stream loads the kernel libraries, asks the occupancy
query, resolves B1's tiles and touches every kernel once. The warm-up's
launches ran on the card and stay counted; :func:`warm_up` returns them so
the caller can report them apart.
"""

from __future__ import annotations

import time

import torch


def counters() -> tuple:
    """The kernel wrappers whose ``.launches`` count card launches."""
    from h2o3_tpu_torch.ops import hist_cuda, split_cuda

    return hist_cuda.COUNTERS + split_cuda.COUNTERS


def snapshot() -> dict:
    """``{wrapper name: launches}`` now."""
    return {f.__name__: f.launches for f in counters()}


def _moved(before: dict) -> dict:
    return {k: v - before[k] for k, v in snapshot().items() if v != before[k]}


def warm_up(fn, device: torch.device) -> dict:
    """Run ``fn`` eagerly on a side stream of ``device`` and wait for it;
    returns the launches it made (``{wrapper name: count}``)."""
    before = snapshot()
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    torch.cuda.synchronize(device)
    return _moved(before)


class LaunchGraph:
    """``fn`` captured once into a CUDA graph in the memory pool ``pool``.

    ``launches`` is what each counter moved during capture: the kernels one
    replay launches. :meth:`replay` adds it to the counters. A capture that
    raises propagates its error: there is no eager fallback."""

    def __init__(self, fn, pool=None):
        self.graph = torch.cuda.CUDAGraph()
        before = snapshot()
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(self.graph, pool=pool):
                fn()
        finally:
            self.launches = _moved(before)
            by_name = {f.__name__: f for f in counters()}
            for name, k in self.launches.items():
                by_name[name].launches -= k  # capture ran nothing on the card
        self.capture_seconds = time.perf_counter() - t0
        self.replays = 0

    def replay(self) -> None:
        self.graph.replay()
        self.replays += 1
        if self.launches:
            by_name = {f.__name__: f for f in counters()}
            for name, k in self.launches.items():
                by_name[name].launches += k


def check_not_capturing(what: str) -> None:
    """Raise when a CUDA graph capture is under way on the current stream:
    a CPU tensor handed to a kernel's dispatch then would be computed once
    on the host at capture and never again at replay."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{what}: a CPU tensor during CUDA graph capture "
                           "(the graph would never recompute it)")
