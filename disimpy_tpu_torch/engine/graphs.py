"""One step of a time loop replayed from a captured CUDA graph.

Both engines run their windows as a repeated step on a state of static
buffers: the fused engine one epoch (``engine/fused.epoch_body``), the
classic engine one time step (``engine/core.step_body``). Each step reads
what changes from step to step (RNG key, step index, epoch) from device
tensors that it advances itself, and never syncs the host, so on CUDA one
step of a window shape can be captured once and replayed for every step.

:class:`StepGraph` holds one captured step with its state; :func:`cached`
keeps them per spec and window shape. The kernel launches a capture makes
are tallied and added at each replay (``engine/launch_count.py``).
"""

import collections
import threading
import weakref

import torch

from . import launch_count

# A spec keeps at most this many window shapes per engine (the two parts of
# a split run on one card use two); its entries (graphs, pools, static
# buffers) go when the spec does.
GRAPHS_PER_SPEC = 2
# One capture at a time: capture begins with a device synchronize and
# empty_cache(), which must not fall inside another thread's capture.
_CAPTURE_LOCK = threading.Lock()
_CACHE_LOCK = threading.Lock()


class StepGraph:
    """One step of one window shape captured as a CUDA graph, with the
    state it reads and writes (its static buffers; ``state.positions``
    names the device), the graph's own memory pool and the kernel launches
    one replay makes. ``lock`` is held while a window uses it."""

    def __init__(self, state):
        self.state = state
        self.graph = None
        self.tally = None
        self.lock = threading.Lock()

    def run(self, body, n_steps, prepare=None):
        """Run ``body()`` ``n_steps`` times on the loaded state, by replay.

        The first use runs one step eagerly (it builds and loads the
        kernels, none of which may happen inside a capture), calls
        ``prepare()`` for any other first-use work, then captures the next
        step on a stream of its own; a capture that fails raises. Each
        replay counts the kernel launches that the capture recorded.
        """
        done = 0
        if self.graph is None:
            body()
            done = 1
            if prepare is not None:
                prepare()
            graph = torch.cuda.CUDAGraph()
            device = self.state.positions.device
            with _CAPTURE_LOCK, launch_count.capture() as tally, \
                    torch.cuda.device(device), torch.cuda.graph(
                        graph, stream=torch.cuda.Stream(device),
                        capture_error_mode="thread_local"):
                body()
            self.graph, self.tally = graph, tally
        for _ in range(done, n_steps):
            self.graph.replay()
            launch_count.replayed(self.tally)


def cached(cache, spec, key, make_state):
    """The :class:`StepGraph` of window shape ``key`` for ``spec`` in
    ``cache`` (a dict of {id(spec): OrderedDict of shapes}, the most
    recently used last), made with ``make_state()`` on first use. A spec
    keeps its ``GRAPHS_PER_SPEC`` most recent shapes; a shape in use by
    another window stays until a later call."""
    with _CACHE_LOCK:
        per_spec = cache.get(id(spec))
        if per_spec is None:
            per_spec = cache[id(spec)] = collections.OrderedDict()
            weakref.finalize(spec, cache.pop, id(spec), None)
        entry = per_spec.pop(key, None) or StepGraph(make_state())
        per_spec[key] = entry
        for old in list(per_spec)[:-GRAPHS_PER_SPEC]:
            if per_spec[old].lock.acquire(blocking=False):
                victim = per_spec.pop(old)
                device = victim.state.positions.device
                if device.type == "cuda":
                    # Its last replays may still be queued on the device.
                    torch.cuda.synchronize(device)
                victim.lock.release()
        return entry
