"""Programs over static buffers: the port's counterpart of the reference's
compiled (jitted) programs.

The reference runs its main paths as programs XLA compiled once per shape:
the tracker's steps (``_track_program``, the jitted stream step), the
calibration fit's whole L-BFGS loop (``ObserverCameras._fit_lbfgs_device``),
the exact Jacobian (``Cameras._autodiff_jac``), match refinement, detection
and matching batches. The port's counterpart is a ``torch.cuda.CUDAGraph``
captured from its own eager code over buffers that live as long as the
program: a call copies its inputs into the buffers and replays the graph,
which launches every kernel of the eager code from one host call.

Every program of a thread on a card captures and replays on one side stream
of that thread, in one memory pool (:func:`capture_context`). Captures run
without ``torch.cuda.graph``'s synchronize and ``empty_cache``: capture
records and runs nothing, so the host captures while the card still runs
the work before. A body that reads the card on the host (``.item()``,
``.tolist()``, ``bool`` of a tensor, a copy to the host) cannot be
captured: the capture raises with the reason, and nothing falls back to
the eager code. On the CPU there is no graph, and a program runs its body.
"""
import gc
import threading
from typing import Callable, Iterable

import torch

from . import profiling
from .kernels import _build

#: Per thread, per card: the side stream every program captures and replays
#: on, and the first graph captured there, whose memory pool the later ones
#: share (:func:`capture_context`).
_CAPTURE = threading.local()


def capture_context() -> list:
    """[stream, anchor, pool, failed] of this thread on the current card.
    Every program captures and replays on ``stream``, in the memory pool
    ``pool`` (a ``torch.cuda.graph_pool_handle()``), so captures reuse one
    pool's blocks, call after call, and replays never overlap (each waits
    for the caller's stream, which then waits for it). ``failed`` keeps the
    graphs of failed captures (see :meth:`Graph._capture`). ``anchor``, the
    first graph captured into ``pool`` (None until then), keeps the pool
    alive for the thread's life: a pool a program was freed only when the allocator
    emptied its cache (2-18 % of a 10-step tracking call at 10,240 x 2,048
    to empty it at each call's end, 5.4 GiB more reserved a call not to),
    and a pool a tracker ran a process holding many trackers out of memory
    (PERF.md PR 13)."""
    contexts = getattr(_CAPTURE, "contexts", None)
    if contexts is None:
        contexts = _CAPTURE.contexts = {}
    index = torch.cuda.current_device()
    if index not in contexts:
        contexts[index] = [torch.cuda.Stream(index), None, torch.cuda.graph_pool_handle(), []]
    return contexts[index]


class Graph:
    """One ``torch.cuda.CUDAGraph`` captured from ``body()`` on ``device``.

    The capture runs on the thread's side stream, in its memory pool
    (:func:`capture_context`), with ``generators`` registered so that a
    replay draws what the eager body would and leaves each generator where
    it would. ``body()``'s return value is :attr:`outputs`: tensors in the
    graph's pool, which every replay overwrites. :attr:`launches` holds, by
    label, the launches each registered kernel (``kernels._build.KERNELS``)
    counted in its wrapper's ``captured`` during the capture, and each
    replay adds them to the wrapper's ``launches``. ``name`` says in an
    error what failed to capture.

    While :func:`profiling.enabled`, the capture is the span
    ``graph.capture`` (``name`` its program) and counts in
    ``graph.captures``; :attr:`spans` holds the event pairs of the device
    spans captured in ``body``, which each replay records again
    (:func:`profiling.read_device_spans`), and :attr:`replays` counts the
    replays.
    """

    def __init__(self, body: Callable, device, name: str, generators: Iterable = ()) -> None:
        self.device = torch.device(device)
        self.graph = torch.cuda.CUDAGraph()
        for generator in generators:
            self.graph.register_generator_state(generator)
        self.replays = 0
        before = {label: kernel.wrapper.captured for label, kernel in _build.KERNELS.items()}
        collecting = gc.isenabled()
        profiling.count("graph.captures")
        with profiling.span("graph.capture", program=name), profiling.capturing() as self.spans, \
                torch.cuda.device(self.device):
            context = capture_context()
            self.stream, self.pool = context[0], context[2]
            # capture_begin fills each registered generator's seed and offset
            # tensors on the capture stream before it captures. Those tensors
            # are allocated on the caller's stream, maybe in a block that the
            # caller's queued work still reads (a temporary freed on the host
            # before the card ran it): the capture stream waits for that work
            # first, or the fill overwrites it.
            self.stream.wait_stream(torch.cuda.current_stream())
            # No garbage collection while capturing: a cycle it freed could
            # hold another program's graph, and destroying a graph is not
            # permitted during a capture (it invalidates the capture).
            gc.disable()
            try:
                with torch.cuda.stream(self.stream):
                    self._capture(body, name, context)
            finally:
                if collecting:
                    gc.enable()
            if context[1] is None:
                context[1] = self.graph
        self.launches = {label: kernel.wrapper.captured - before.get(label, 0)
                         for label, kernel in _build.KERNELS.items()}

    def _capture(self, body: Callable, name: str, context: list) -> None:
        """``body()`` captured on the current stream into ``context``'s
        pool. A failed capture raises with the reason. Ending an invalidated
        capture raises before the allocator forgets it (torch 2.11): the
        allocator keeps the pool recording, and keeps a reference to this
        graph, so later captures into that pool would raise. The graph is
        kept alive in ``context`` and the thread moves to a fresh pool."""
        self.graph.capture_begin(self.pool, capture_error_mode="thread_local")
        try:
            self.outputs = body()
        except RuntimeError as error:
            try:
                self.graph.capture_end()
            except RuntimeError:
                context[3].append(self.graph)
                context[1], context[2] = None, torch.cuda.graph_pool_handle()
            raise RuntimeError(
                f"{name} cannot be captured as a CUDA graph (its body must not read the card on the host"
                f" or synchronize): {error}"
            ) from error
        self.graph.capture_end()

    def replay(self):
        """Replay on the side stream, ordered after the caller's stream and
        before what the caller queues next; returns :attr:`outputs`."""
        with torch.cuda.device(self.device):
            current = torch.cuda.current_stream()
            self.stream.wait_stream(current)
            with torch.cuda.stream(self.stream):
                self.graph.replay()
            current.wait_stream(self.stream)
        self.replays += 1
        for label, n in self.launches.items():
            _build.KERNELS[label].wrapper.launches += n
        return self.outputs


class Program:
    """``body()`` over static buffers, run as the reference runs a compiled
    program. On a card its first call runs ``body`` eagerly, which warms up
    what capture cannot do (the kernels' first loads, library handles, the
    allocator's blocks); its second captures ``body`` into a :class:`Graph`
    and replays it; every later call replays. On the CPU every call runs
    ``body``. A call returns ``body``'s outputs; a replay's are the graph's
    tensors, which the next replay overwrites, so read or copy them before
    the next call of any program of the thread (their pool is shared)."""

    def __init__(self, body: Callable, device, name: str) -> None:
        self.body = body
        self.device = torch.device(device)
        self.name = name
        self.graph = None
        self.calls = 0

    def __call__(self):
        self.calls += 1
        if self.graph is None and self.device.type == "cuda" and self.calls > 1:
            self.graph = Graph(self.body, self.device, self.name)
        return self.body() if self.graph is None else self.graph.replay()
