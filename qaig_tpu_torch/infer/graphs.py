"""CUDA-graph capture and replay of the generation cascade and of the
trainers' steps (the port's own module: the JAX package jits the cascade
into one XLA program, ``qaig_tpu/infer/generate.py::_run_fused``, and each
train step into another; on the card the counterpart is a
``torch.cuda.CUDAGraph``, captured once per key and replayed; the train
steps come through ``qaig_tpu_torch/train/common.py::graph_train_step``).

A :class:`GraphRunner` captures a function the first time it is called
with a key and replays the graph on every later call with that key:

* the function's tensor inputs get static buffers, copied into before each
  replay; its outputs are the graph's static tensors, and every call hands
  back clones of them;
* a ``torch.Generator`` that the function draws from is registered with
  the graph, so a replay draws from the generator's state at that moment
  (``manual_seed`` before a replay re-seeds it) and advances it as the
  eager function would;
* capture runs on a side stream in ``thread_local`` mode, one capture at
  a time in the process, into one memory pool that all of the runner's
  graphs share, after a garbage collection (a graph that dies inside
  another capture invalidates it).  The side stream is the card's one
  capture stream, which every runner of the process shares: cuBLAS keeps
  a workspace for each stream it has run on until the process ends
  (PyTorch's workspace cache), so a stream of each runner's own would
  leave one workspace behind every trainer and cascade of the process;
* cuDNN and cuBLAS set up their handles at their first call in a thread,
  allocating device memory, which a capture forbids: before a thread's
  first capture the runner runs its ``warmup`` (a few small eager calls
  of those libraries, from the caller) in that thread;
* a train step's backward runs on autograd's device thread, on the
  capture's stream, so its kernels (kernel A's backward among them) land
  in the graph too; a train step's warm-up (``prepare``: a forward and a
  backward that update nothing) runs eagerly on that stream just before
  its capture;
* the kernel wrappers count a launch when they are called, which a capture
  does once and a replay never: the runner takes a capture's counts (and
  a warm-up's) back out and adds the capture's again at every replay, so
  a replay counts the kernels it ran, as the eager call would.

A capture or a replay that fails raises; nothing falls back to the eager
function.
"""

import gc
import threading
import time

import torch

from qaig_tpu_torch.ops import bmu
from qaig_tpu_torch.ops import decode_attention as da
from qaig_tpu_torch.ops import flash_attention as fa
from qaig_tpu_torch.ops import mlp_fused as mf

# PyTorch allows one graph capture at a time in a process; a server that
# reloads its checkpoints warms (and captures) the new pipeline on another
# thread while the old one serves, so captures take this lock (replays do
# not)
_CAPTURE_LOCK = threading.Lock()
# the capture stream of each card (:func:`capture_stream`)
_CAPTURE_STREAMS = {}


def capture_stream(device):
    """The side stream every capture on ``device`` runs on."""
    stream = _CAPTURE_STREAMS.get(device)
    if stream is None:
        stream = _CAPTURE_STREAMS.setdefault(device,
                                             torch.cuda.Stream(device))
    return stream


def launch_counters():
    """(name, wrapper, attribute) of every kernel launch count of the
    port, and of the backward passes of kernel A that reached the CUDA
    backward (``flash_attention.backward_calls``)."""
    return [("flash_attention", fa.flash_attention, "launches"),
            ("flash_attention_backward_calls", fa.flash_attention,
             "backward_calls"),
            ("flash_attention_backward", fa.fused_flash_attention_backward,
             "launches"),
            ("shared_prefix_attention_fused_t",
             da.shared_prefix_attention_fused_t, "launches"),
            ("shared_prefix_attention_fused_int8",
             da.shared_prefix_attention_fused_int8, "launches"),
            ("shared_prefix_attention_fused_flat",
             da.shared_prefix_attention_fused_flat, "launches"),
            ("shared_prefix_attention_fused_flat_int8",
             da.shared_prefix_attention_fused_flat, "int8_launches"),
            ("fused_bmu", bmu.fused_bmu, "launches"),
            ("fused_bmu_small_m", bmu.fused_bmu, "small_m_launches"),
            ("mlp2_fused", mf.mlp2_fused, "launches")]


def read_counts():
    return [getattr(fn, attr) for _, fn, attr in launch_counters()]


def add_counts(deltas):
    for (_, fn, attr), delta in zip(launch_counters(), deltas):
        setattr(fn, attr, getattr(fn, attr) + delta)


class CapturedGraph:
    """One captured graph on one card (``device``) with its static inputs
    and outputs, the launches one replay makes (in :func:`launch_counters`'
    order) and the capture's host seconds (``capture_s``: the function's
    run under capture; ``instantiate_s``: ending the capture, which
    instantiates the graph)."""

    def __init__(self, graph, device, inputs, outputs, launches,
                 capture_s=0.0, instantiate_s=0.0):
        self.graph = graph
        self.device = device
        self.inputs = inputs
        self.outputs = outputs
        self.launches = launches
        self.capture_s = capture_s
        self.instantiate_s = instantiate_s

    def replay(self, *inputs):
        """Copy ``inputs`` in, replay and hand back clones of the outputs,
        all queued on the graph's card (PyTorch replays on the current
        stream of the current device, so the card is made current here)
        without waiting for it: a caller can start the replays of several
        cards before it reads any of their outputs."""
        with torch.cuda.device(self.device):
            for static, value in zip(self.inputs, inputs):
                static.copy_(value, non_blocking=True)
            self.graph.replay()
            add_counts(self.launches)
            return _clone(self.outputs)


def _clone(tree):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(x) for x in tree)
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


class GraphRunner:
    """The graphs of one set of weights on one CUDA device, by key."""

    def __init__(self, device, warmup=None):
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.warmup = warmup
        self._warm_threads = set()
        self.stream = capture_stream(self.device)
        # One pool for all of this runner's graphs.  Sharing it is safe
        # while (1) inputs are copied in just before a replay (replay()
        # does), (2) outputs are copied out before the next replay
        # (replay() hands back clones) and (3) replays never overlap: the
        # runner's owner replays from one thread at a time.
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs = {}

    def __call__(self, key, fn, inputs=(), generator=None, prepare=None):
        """``fn(*inputs)`` (a tree of tuples, lists and tensors) from the
        graph of ``key``, captured at the key's first call."""
        graph = self.graphs.get(key)
        if graph is None:
            graph = self.graphs[key] = self.capture(fn, inputs, generator,
                                                    prepare)
        return graph.replay(*inputs)

    def capture(self, fn, inputs, generator=None, prepare=None):
        """Capture ``fn`` over static copies of ``inputs``; raises if the
        capture fails (the counts stay as they were).  ``prepare(*static)``
        runs eagerly on the capture stream just before the capture (a
        train step's warm-up: a forward and backward that update
        nothing); its launches are taken out of the counts too."""
        if self.warmup is not None and \
                threading.get_ident() not in self._warm_threads:
            with torch.cuda.device(self.device):
                self.warmup()
            self._warm_threads.add(threading.get_ident())
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        static = tuple(torch.empty_like(x, device=self.device).copy_(x)
                       for x in inputs)
        caller = torch.cuda.current_stream(self.device)
        with _CAPTURE_LOCK, torch.cuda.device(self.device):
            before = read_counts()
            self.stream.wait_stream(caller)
            try:
                with torch.cuda.stream(self.stream):
                    if prepare is not None:
                        prepare(*static)
                    prepared = read_counts()
                    # a graph that dies during the capture (garbage in a
                    # reference cycle, collected at an allocation)
                    # destroys its executable there, which invalidates
                    # the capture: collect such garbage first, as
                    # torch.cuda.graph does
                    gc.collect()
                    t0 = time.perf_counter()
                    graph.capture_begin(pool=self.pool,
                                        capture_error_mode="thread_local")
                    try:
                        outputs = fn(*static)
                        t1 = time.perf_counter()
                        graph.capture_end()
                    except BaseException:
                        self._end_failed_capture(graph)
                        raise
                    t2 = time.perf_counter()
                caller.wait_stream(self.stream)
                launches = [a - b for a, b in zip(read_counts(), prepared)]
            finally:
                add_counts([b - a for a, b in zip(read_counts(), before)])
        return CapturedGraph(graph, self.device, static, outputs, launches,
                             capture_s=t1 - t0, instantiate_s=t2 - t1)

    def _end_failed_capture(self, graph):
        """Leave the stream and the allocator usable after a capture
        failed: end the stream's capture (``capture_end`` raises once the
        capture was invalidated), stop routing allocations to the pool and
        give back the capture's use of it, both of which ``capture_end``
        leaves open when it raises before it gets that far (PyTorch's
        private calls, as ``torch.cuda.use_mem_pool`` makes them).  A pool
        that no graph holds is then freed and cannot be recorded to again,
        so later captures take a new one."""
        try:
            graph.capture_end()
        except RuntimeError:   # the failure being handled, again
            pass
        try:
            torch._C._cuda_endAllocateToPool(self.device.index, self.pool)
            torch._C._cuda_releasePool(self.device.index, self.pool)
        except RuntimeError:   # capture_end had ended the routing; the
            pass               # graph gives the pool back when it goes
        self.pool = torch.cuda.graph_pool_handle()
