"""n steps of a state update as one program: the port's counterpart of
`jax.jit` over a sweep loop (the reference's `jax.jit(sweep_cm.run,
static_argnums=3)`).

    run = CapturedRun(lambda s: sweep_cm.sweep(cmg, s, cfg), state, 5)
    state = run()   # 5 sweeps; on the card one CUDA-graph replay
    run.load(init)  # start the next call from another state

`CapturedRun` owns one set of static state tensors, copies of the state it
was given that share no memory.  On a card, its first call warms up with one
step on a clone of the state, on a side stream (every kernel library is
built and loaded outside the capture, and the state is untouched), then
captures the `n` steps as one CUDA graph whose last nodes copy the results
back into the static tensors, and replays it; every later call is one
`replay()`.  A capture that fails raises: nothing drops to eager on the
card.  On CPU tensors the `n` steps run eagerly (the path the tests take).

What a captured step may not do: read the device (`.item()`, `.cpu()`,
boolean masks, `nonzero`, `torch.tensor` of a host value), call a C entry
that allocates, copies or synchronizes, or depend on a Python value that
changes from call to call (it is baked into the graph).  The prepare steps
read the host and run before the capture.  `ops.messages.COUNTS` counts
Python calls: under capture it counts the warm-up and the captured steps
once; count what a replay launches with the profiler.  The set-up span
`capture.capture` (`utils.profiling.span`) times the warm-up step and the
capture.
"""
from __future__ import annotations

import dataclasses

import torch

from gbp_tpu_torch.utils.profiling import span


def tensors(obj) -> list:
    """Every tensor of a nesting of named tuples, tuples and dataclasses of
    tensors, depth first, in a fixed order."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, tuple):
        return [t for o in obj for t in tensors(o)]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [t for f in dataclasses.fields(obj) for t in tensors(getattr(obj, f.name))]
    return []


def map_tensors(fn, obj):
    """`obj` with every tensor t (in the nesting `tensors` walks) replaced by fn(t)."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, tuple):
        items = [map_tensors(fn, o) for o in obj]
        return type(obj)(*items) if hasattr(obj, "_fields") else tuple(items)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: map_tensors(fn, getattr(obj, f.name))
                                           for f in dataclasses.fields(obj)})
    return obj


def write_back(dst, src) -> None:
    """Copy the tensors of state `src` into those of `dst` (the same
    nesting).  A source that is (a view of) a `dst` tensor other than its
    own target is cloned first, so no write lands before a read."""
    dst, src = tensors(dst), tensors(src)
    if len(dst) != len(src):
        raise ValueError(f"write_back: {len(src)} tensors into {len(dst)}")
    shared = {d.untyped_storage().data_ptr() for d in dst}
    src = [s.clone() if s is not d and s.untyped_storage().data_ptr() in shared else s
           for d, s in zip(dst, src)]
    for d, s in zip(dst, src):
        if s is not d:
            d.copy_(s)


def capture(fn, warm):
    """`fn()` captured as one CUDA graph on the current device, after
    `warm()` ran once on a side stream (it loads every kernel and library
    the capture will meet).  Raises when the capture fails."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        warm()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph


class CapturedRun:
    """`n` calls of `step` (state -> state of the same nesting) as one
    program on static state tensors; see the module docstring."""

    def __init__(self, step, state, n: int):
        if n < 1:
            raise ValueError(f"CapturedRun: n must be at least 1, got {n}")
        self.step, self.n = step, n
        self.state = map_tensors(lambda t: t.clone(memory_format=torch.contiguous_format), state)
        leaves = tensors(self.state)
        if not leaves:
            raise ValueError("CapturedRun: the state holds no tensor")
        self.on_card = leaves[0].is_cuda
        self.graph = None

    def __call__(self):
        """Run the n steps from the static state; returns it (updated in
        place)."""
        if not self.on_card:
            write_back(self.state, self._steps(self.state))
            return self.state
        if self.graph is None:
            self.graph = self._capture()
        self.graph.replay()
        return self.state

    def load(self, state):
        """Copy `state` into the static tensors: the next call starts from
        it.  Returns the static state."""
        write_back(self.state, state)
        return self.state

    def _steps(self, state):
        for _ in range(self.n):
            state = self.step(state)
        return state

    def _capture(self):
        with span("capture.capture"):
            return capture(lambda: write_back(self.state, self._steps(self.state)),
                           lambda: self.step(map_tensors(torch.clone, self.state)))
