"""Serving steps as one program: a step captured once as a CUDA graph and
replayed (the port's counterpart of the reference's `jax.jit` of a step:
the engine's prefill and decode steps, `generate`'s serve step).

A step is a function over named static device buffers, fn(**buffers) ->
outputs.  `Step` runs it eagerly: each call copies the new inputs into
the buffers, then runs fn.  `StepGraph` runs it once on a side stream
(the kernels' first-call setup: the library load, the
`cudaFuncSetAttribute` statics, the SM count), captures one call with
`torch.cuda.graph` into a memory pool the caller may share between
graphs, and from then on replays it: the outputs are the same static
tensors at every replay, overwritten by the next.  A value the step
reads must come from a buffer; shapes, plans and routes freeze at
capture, which is right, since they depend on shapes alone.

Inputs reach the buffers by `copy_`: a device tensor device to device, a
host value through a pinned host buffer with `non_blocking=True` (the
buffer is not rewritten before its last copy has left it).

A replay runs no Python, so no kernel wrapper counts its launches: the
capture takes the wrappers' counters' change (`kernels.counters`), takes
it back (a capture launches nothing), and adds it once per replay.

There is no fallback: asked for on the CPU, `StepGraph` raises; a capture
that fails raises with the port's line that broke it.
"""
from __future__ import annotations

import time
import traceback
from pathlib import Path

import torch

from repro_torch.kernels import counters

_PORT = str(Path(__file__).resolve().parents[1])


class Step:
    """fn(**buffers) over static buffers on one device, run eagerly."""

    def __init__(self, fn, buffers: dict, *, name: str = "step"):
        self.fn, self.buffers, self.name = fn, dict(buffers), name
        self.device = next(iter(self.buffers.values())).device
        self._staged = {}             # name -> (pinned host tensor, event)

    def load(self, **inputs) -> None:
        """Copy each input into its buffer (shapes must match)."""
        for name, value in inputs.items():
            buf = self.buffers[name]
            if torch.is_tensor(value) and value.device == buf.device:
                buf.copy_(value)
            elif buf.device.type == "cuda":
                self._from_host(name, buf, value)
            else:
                buf.copy_(torch.as_tensor(value))

    def _from_host(self, name, buf, value):
        if name not in self._staged:
            self._staged[name] = (
                torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True),
                torch.cuda.Event())
        host, left = self._staged[name]
        left.synchronize()            # its last copy has left the buffer
        host.copy_(torch.as_tensor(value))
        buf.copy_(host, non_blocking=True)
        left.record()

    def run(self):
        return self.fn(**self.buffers)

    def first(self):
        """The outputs for the buffers' values at construction: a run."""
        return self.run()

    def __call__(self, **inputs):
        self.load(**inputs)
        return self.run()


def _broke_at(err: BaseException) -> str:
    """The innermost line of the port in err's traceback, or in that of
    the error it was raised during (the capture's end re-raises)."""
    while err is not None:
        frames = [f for f in traceback.extract_tb(err.__traceback__)
                  if f.filename.startswith(_PORT)
                  and not f.filename.endswith("graphs.py")]
        if frames:
            f = frames[-1]
            return f"at {Path(f.filename).name}:{f.lineno} ({f.line})"
        err = err.__context__
    return "outside the port"


class StepGraph(Step):
    """The step captured as one CUDA graph; each call loads its inputs and
    replays it.  `pool` (`torch.cuda.graph_pool_handle()`) shares one
    memory pool between graphs that never replay at once (an engine's
    two).  `stats`: warm-up and capture seconds, the bytes the pool took
    from the card (`pool_bytes`), the bytes the graph keeps allocated
    (`kept_bytes`: its static outputs), and `max_memory_allocated` before
    and after the capture."""

    def __init__(self, fn, buffers: dict, *, name: str = "step", pool=None):
        super().__init__(fn, buffers, name=name)
        dev = self.device
        if dev.type != "cuda":
            raise ValueError(f"{name}: a CUDA graph needs its buffers on "
                             f"the card, not on {dev}")
        t0 = time.perf_counter()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        mode = torch.cuda.get_sync_debug_mode()
        with torch.cuda.stream(side):
            try:          # the warm-up names any host sync in the step
                torch.cuda.set_sync_debug_mode("error")
                out = self.fn(**self.buffers)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        main = torch.cuda.current_stream(dev)
        main.wait_stream(side)
        for t in out if isinstance(out, (tuple, list)) else (out,):
            t.record_stream(main)         # read on the main stream later
        self._warmed = out
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        torch.cuda.empty_cache()      # as the capture does on entry
        reserved = torch.cuda.memory_reserved(dev)
        allocated = torch.cuda.memory_allocated(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        before = counters.snapshot()
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.graph, pool=pool):
                self.outputs = self.fn(**self.buffers)
        except RuntimeError as e:
            raise RuntimeError(f"capture of the {name} failed "
                               f"{_broke_at(e)}: {e}") from e
        finally:
            self.delta = counters.diff(counters.snapshot(), before)
            counters.add(self.delta, -1)    # a capture launches nothing
        torch.cuda.synchronize(dev)
        self.replays = 0
        self.stats = {
            "warmup_s": t1 - t0, "capture_s": time.perf_counter() - t1,
            "pool_bytes": torch.cuda.memory_reserved(dev) - reserved,
            "kept_bytes": torch.cuda.memory_allocated(dev) - allocated,
            "max_allocated_before": peak,
            "max_allocated_after": torch.cuda.max_memory_allocated(dev)}

    def first(self):
        """The warm-up call's outputs: the step's for the buffers' values
        at construction, so a caller whose buffers start at its first
        real inputs need not replay that step."""
        return self._warmed

    def run(self):
        self.graph.replay()
        counters.add(self.delta)
        self.replays += 1
        return self.outputs
