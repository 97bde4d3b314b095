"""One step of a loop over tensors it owns: called on the CPU, replayed from a
CUDA graph on a card.

A step is a function of no arguments that reads its inputs from tensors it
closes over and writes its results back into tensors it closes over, in
place. Running it again therefore continues from where the last run left
off, and a graph captured from it does the same on every replay: the
counterpart of one iteration of a ``lax.while_loop`` / ``fori_loop`` body in
the JAX package's compiled programs. Scalars that change from call to call
(the seed, a sample index, the camera) live in device tensors the step
reads, never in Python constants, so one graph serves every value.

On a CUDA device the first call runs the step once, eagerly, on the capture
stream: a real step, whose kernel launches count as they run. That warm-up
loads each kernel library, sets its attributes and makes the persistent
kernels' counters of that stream (``ops/_launch.persistent_counters``)
outside the graph's memory pool. Then the step is captured, and every later
call replays the graph. A capture that fails raises; nothing falls back to
eager launches.

A step whose traversal reads back to the host (the plain traversals
'bvh' and 'packet', ``ops/intersect.py::make_intersectors``) cannot be
captured. It is made with ``capture=False`` and then runs op by op on the
card on every call, as on the CPU: on the caller's current stream (a
worker's own, say), its launches counted as they run.

The traversal wrappers count their launches in Python, which a capture
runs once. So the capture's counts are taken back out of the modules'
``LAUNCHES`` tables and kept as the graph's launches per entry point, and
each replay adds them: the tables count the launches that ran.

Renderers of a worker pool (``parallel/workers.py``) run their steps from
threads of their own, two of them on one card if the pool says so. So one
capture runs at a time in the process, holding ``_launch.LOCK``, under which
every wrapper counts: another thread's launches wait to be counted until the
capture's own are taken out. And a capture fails only on this thread's
unsafe calls (``thread_local`` mode): the other threads go on launching,
allocating and synchronising their own streams meanwhile.

A renderer and its programs refer to each other, so a dropped renderer's
graphs are freed by the cyclic garbage collector, whenever it runs. A
collection during a capture would destroy a graph while the stream
captures, which CUDA refuses, and the capture would be lost; so a capture
runs with the collector paused (``gc_paused``).
"""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Callable, List, Tuple

import torch

from ..ops import _launch


@contextlib.contextmanager
def gc_paused():
    """The cyclic garbage collector off for the block, as it was after."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


class Step:
    """``fn`` run directly on the CPU, replayed from a CUDA graph on a card,
    or run directly there too when ``capture`` is False.

    ``stream`` and ``pool``: the capture stream and the graph memory pool,
    shared by the steps of one renderer. Its graphs are replayed one after
    another on one stream, never at the same time, so they may share the
    counters the capture stream's persistent launches keep, and a pool
    (each graph's intermediates are dead when it ends; its results live in
    tensors allocated outside the pool).
    """

    # False: the step runs on a card uncaptured, op by op, on every call
    capture = True

    def __init__(self, fn: Callable[[], None], device: torch.device, stream=None, pool=None,
                 capture: bool = True):
        self.fn = fn
        self.device = device
        self.capture = capture
        self.stream = stream
        self.pool = pool
        self.graph = None
        # (table index, entry point, launches) of one replay
        self.launches: List[Tuple[int, str, int]] = []
        self.capture_seconds = 0.0

    def __call__(self) -> None:
        if self.device.type != "cuda" or not self.capture:
            self.fn()
        elif self.graph is None:
            self._capture()
        else:
            self.graph.replay()
            with _launch.LOCK:
                tables = _launch.launch_tables()
                for i, key, count in self.launches:
                    tables[i][key] += count

    def _capture(self) -> None:
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            self.fn()  # the warm-up: a real step
        current.wait_stream(self.stream)
        graph = torch.cuda.CUDAGraph()
        with _launch.LOCK:
            tables = _launch.launch_tables()
            before = [dict(t) for t in tables]
            t0 = time.perf_counter()
            capture = torch.cuda.graph(graph, pool=self.pool, stream=self.stream)
            # read by the context manager when it begins the capture; set
            # here, not as the constructor's keyword, so that a stand-in for
            # torch.cuda.graph taking (graph, pool, stream) still serves
            # (tests/test_torch_compiled.py's)
            capture.capture_error_mode = "thread_local"
            try:
                with gc_paused(), capture:
                    self.fn()
            finally:
                self.launches = [
                    (i, key, t[key] - before[i][key])
                    for i, t in enumerate(tables) for key in t if t[key] != before[i][key]
                ]
                for t, counts in zip(tables, before):
                    t.update(counts)
            self.capture_seconds = time.perf_counter() - t0
        self.graph = graph
