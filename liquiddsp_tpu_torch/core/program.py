"""Compiled programs: the counterpart of ``jax.jit`` and its cache.

The JAX package never runs a receiver stage by stage from Python: each
runtime entry point is a program, compiled once per static key, cached and
dispatched once per call (``StreamingRx`` step, superstep and adaptive
program; ``FlexTx`` / ``FlexRx`` / ``FrameDetectorCC``'s programs in
``runtime/blocks.py``). In PyTorch on a card the counterpart is a CUDA graph,
captured once per key and replayed per call. A ``Program`` maps a static key
to a captured graph of the body that ``make(key)`` returns:

- **Capture** (the first call of a key): static input buffers are allocated
  (shared by the program's keys of the same input shapes) and the inputs
  copied in; the body runs once on a side stream (the
  warm-up, which builds every ``device_const`` table, the kernel library and
  the cuBLAS handles before capture) and the ``state`` tensors it wrote are
  put back; then the body is captured with ``torch.cuda.CUDAGraph`` under
  ``torch.cuda.set_sync_debug_mode("error")``, so that a hidden sync raises,
  and the graph is replayed for the call. All graphs of a device share one
  memory pool (``pool_bytes`` counts what it reserved).
- **Replay**: the inputs are copied in with ``copy_`` (a Python int is
  written into a 0-dim int64 device buffer by ``fill_``) and the graph
  replayed on the current stream.
- **Outputs** are cloned, as JAX hands back fresh arrays: a later replay
  must not change results that a caller still holds. That is also what makes
  the shared pool safe: no graph's outputs are read after another replay.
- **Launch counts**: ``kernels/_cuda.launch`` counts on the host, so a
  capture counts what it records and a replay nothing. The capture's counts
  are taken out of ``_cuda.LAUNCHES`` and kept as the graph's; each replay
  adds them back. The warm-up's launches run for real and are counted apart,
  in ``STATS["warmup_launches"]``, so ``_cuda.LAUNCHES`` counts the launches
  whose results a caller got: one set a call, eager or replayed.
- **CPU**: a CPU tensor is the caller's explicit choice (the tests); there
  the body runs directly.
- **No fallback**: on a CUDA tensor a capture or replay that fails raises.
  Nothing runs the eager body in place of a graph.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Hashable, Sequence

import torch

from liquiddsp_tpu_torch.kernels import _cuda

# process-wide counts since the last reset_stats(): graphs captured and
# replayed, seconds spent capturing (warm-up, capture and the first replay),
# bytes the shared pools reserved during captures, and the warm-up's kernel
# launches
STATS: dict[str, Any] = {}


def reset_stats() -> None:
    STATS.update(captures=0, replays=0, capture_s=0.0, pool_bytes=0,
                 warmup_launches={k: 0 for k in _cuda.LAUNCHES})


reset_stats()

_POOLS: dict[str, tuple] = {}  # device -> the graphs' shared memory pool
_STREAMS: dict[str, torch.cuda.Stream] = {}  # device -> the side stream of warm-ups and captures


def map_tensors(fn: Callable[[torch.Tensor], Any], obj):
    """``obj`` with ``fn`` applied to every tensor in it: through tuples,
    lists, dicts and dataclass instances; anything else is kept."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, (tuple, list)):
        return type(obj)(map_tensors(fn, v) for v in obj)
    if isinstance(obj, dict):
        return {k: map_tensors(fn, v) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: map_tensors(fn, getattr(obj, f.name)) for f in dataclasses.fields(obj)
            if f.init})
    return obj


def _launch_delta(before: dict[str, int]) -> dict[str, int]:
    """The launches counted since ``before``; puts the counts back to it."""
    delta = {k: _cuda.LAUNCHES[k] - before[k] for k in _cuda.LAUNCHES}
    _cuda.LAUNCHES.update(before)
    return delta


@dataclasses.dataclass
class Captured:
    """One key's graph: its static inputs and outputs, the kernel launches
    one replay makes, and what the capture cost."""

    graph: torch.cuda.CUDAGraph
    inputs: list[torch.Tensor]
    outputs: Any
    launches: dict[str, int]
    capture_s: float


class Program:
    """A body per static key, run as a CUDA graph on a card.

    ``make(key)`` returns the body: a function of the call's inputs (tensors
    and Python ints, the ints arriving as 0-dim int64 tensors) that returns
    tensors in tuples, lists, dicts or dataclasses, with no host sync and no
    copy from host memory, and that writes none of its inputs. ``state``
    lists the tensors outside the inputs that the body writes (a carry): the
    warm-up puts them back."""

    def __init__(self, name: str, make: Callable[[Hashable], Callable],
                 state: Sequence[torch.Tensor] = ()):
        self.name = name
        self.make = make
        self.state = tuple(state)
        self.bodies: dict[Hashable, Callable] = {}
        self.graphs: dict[Hashable, Captured] = {}
        self.replays = 0
        # static input buffers, shared by the keys whose inputs have the same
        # position, shape and dtype: every replay copies its inputs in first
        self._inputs: dict[tuple, torch.Tensor] = {}

    def body(self, key: Hashable) -> Callable:
        if key not in self.bodies:
            self.bodies[key] = self.make(key)
        return self.bodies[key]

    def __call__(self, key: Hashable, *args, device: torch.device | None = None):
        """Run the body of ``key`` on ``args`` on ``device`` (default: the
        first tensor's): replayed as a graph on a card, directly on the CPU."""
        dev = device or next(a.device for a in args if isinstance(a, torch.Tensor))
        if dev.type != "cuda":
            return self.body(key)(*(
                a if isinstance(a, torch.Tensor) else torch.full((), _int(a), dtype=torch.int64)
                for a in args))
        cap = self.graphs.get(key)
        if cap is None:
            cap = self.graphs[key] = self._capture(key, args, dev)
        else:
            _load(self.name, cap.inputs, args)
            cap.graph.replay()
        for k, v in cap.launches.items():
            _cuda.LAUNCHES[k] += v
        self.replays += 1
        STATS["replays"] += 1
        return map_tensors(torch.clone, cap.outputs)

    def _capture(self, key: Hashable, args, dev: torch.device) -> Captured:
        t0 = time.perf_counter()
        body = self.body(key)
        inputs = []
        for i, a in enumerate(args):
            spec = (i, tuple(a.shape), a.dtype) if isinstance(a, torch.Tensor) else (
                i, (), torch.int64)
            if spec not in self._inputs:
                self._inputs[spec] = torch.empty(spec[1], dtype=spec[2], device=dev)
            inputs.append(self._inputs[spec])
        if str(dev) not in _POOLS:
            _STREAMS[str(dev)] = torch.cuda.Stream(dev)
            _POOLS[str(dev)] = torch.cuda.graph_pool_handle()
        side, pool = _STREAMS[str(dev)], _POOLS[str(dev)]
        cur = torch.cuda.current_stream(dev)
        _load(self.name, inputs, args)
        saved = [t.clone() for t in self.state]
        before = dict(_cuda.LAUNCHES)
        try:
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                body(*inputs)  # the warm-up
            cur.wait_stream(side)
        finally:
            for k, v in _launch_delta(before).items():
                STATS["warmup_launches"][k] += v
        for t, s in zip(self.state, saved):
            t.copy_(s)
        del saved

        graph = torch.cuda.CUDAGraph()
        reserved = torch.cuda.memory_reserved(dev)
        mode = torch.cuda.get_sync_debug_mode()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            torch.cuda.set_sync_debug_mode("error")
            try:
                graph.capture_begin(pool=pool, capture_error_mode="thread_local")
                outputs = body(*inputs)
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass
                raise
            finally:
                torch.cuda.set_sync_debug_mode(mode)
                launches = _launch_delta(before)
            graph.capture_end()
        cur.wait_stream(side)
        pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        graph.replay()
        torch.cuda.synchronize(dev)
        secs = time.perf_counter() - t0
        STATS["captures"] += 1
        STATS["capture_s"] += secs
        STATS["pool_bytes"] += pool_bytes
        return Captured(graph, inputs, outputs, launches, secs)


def _load(name: str, inputs: list[torch.Tensor], args) -> None:
    """Copy a call's inputs into the static buffers of a graph of program
    ``name``."""
    for buf, a in zip(inputs, args, strict=True):
        if not isinstance(a, torch.Tensor):
            buf.fill_(_int(a))
        elif a.shape != buf.shape or a.dtype != buf.dtype:
            raise ValueError(
                f"{name}: input expected {tuple(buf.shape)} {buf.dtype}, got "
                f"{tuple(a.shape)} {a.dtype} (the key must fix every shape)")
        else:
            buf.copy_(a, non_blocking=True)


def _int(v) -> int:
    if isinstance(v, bool) or not isinstance(v, int):
        raise TypeError(f"program input: a tensor or an int, got {type(v).__name__}")
    return v
