"""The engine's serving programs captured as CUDA graphs.

Counterpart of the reference engine's ``jax.jit`` programs
(``repro.serving.engine.InferenceEngine``: the decode loop, the bucket and
suffix prefills, the ONE chunked-prefill program per model, the fused spec
loop): on the card a fixed-shape program is a captured CUDA graph, replayed
for one launch of the host instead of the program's thousands.

A ``GraphProgram`` runs ``fn(inputs)``, ``inputs`` a dict of the tensors
that change between calls (tokens, lengths, the cache index, the block
tables, a slot); everything else ``fn`` reads or writes (the weights, the
KV pools, the recurrent state) is read and written where it lives.  The
capture reads static copies of the inputs, which ``replay`` refills first.
A warm-up run on the capture stream may precede the capture (lazy library
set-up: the caller warms each set of kernels and shapes once, not each
graph), Python's cyclic collector is off during it (destroying another
graph while a stream captures invalidates the capture), and the kernel
launches the
capture records are counted at each replay: neither the warm-up's (whose
outputs are dropped, as a compile's would be) nor the capture's, which
launches nothing, so the counters read one program call per replay.  The
caller warms up and captures with inputs whose writes land where a later
replay writes again (a frozen slot's, or the admission's own), so
capturing changes no live state.

The graphs of one engine share one memory pool
(``torch.cuda.graph_pool_handle``): a replay may reuse what another graph's
capture freed, which is safe because replays run one at a time on one
stream and the engine reads or clones every output before the next
replay.  ``pool_bytes`` reports the pool's size (memory taken from the
training job's share).

``AddressedGraphs`` serves callers outside the engine (the serve steps'
``ServeStepArtifacts.jitted``, ``make_collocated_step``'s decode chain):
their programs have no engine to own their weights and cache, so a graph
is keyed by the addresses of the tensors it reads and writes in place.
"""
from __future__ import annotations

import gc
import time
from typing import Callable, Optional

import torch

from repro_torch.kernels import ops


class GraphProgram:
    """``fn`` over static copies of ``inputs``, captured as a CUDA graph on
    ``pool`` from the side stream ``side`` and replayed on the current
    stream.

    ``warm``: a function run once on copies of ``inputs`` on ``side`` before
    the capture (``fn`` itself, or one that launches the same kernels at the
    same shapes), or None where that was done before.  ``generator``: a
    ``torch.Generator`` the program draws from; it is registered with the
    graph (each replay draws what an eager call from the same state would,
    and advances it as much), and its state is put back after the warm-up,
    so capturing consumes no draws."""

    def __init__(self, fn: Callable[[dict], tuple], inputs: dict, *, pool,
                 side: torch.cuda.Stream, warm: Optional[Callable[[dict], tuple]] = None,
                 generator: Optional[torch.Generator] = None):
        t0 = time.perf_counter()
        self.fn = fn
        self.static = {k: v.clone() for k, v in inputs.items()}
        device = next(iter(self.static.values())).device
        start = ops.launch_counts(), ops.body_counts()
        stream = torch.cuda.current_stream(device)
        if warm is not None:
            side.wait_stream(stream)
            state = None if generator is None else generator.get_state()
            with torch.cuda.stream(side):
                warm({k: v.clone() for k, v in self.static.items()})
            stream.wait_stream(side)
            if generator is not None:
                generator.set_state(state)
        before = ops.launch_counts(), ops.body_counts()
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            self.graph.register_generator_state(generator)
        # captured on the side stream, without ``torch.cuda.graph``'s
        # collect-and-empty-cache before each capture (~0.3 s a program,
        # and the emptied cache is allocated again after)
        side.wait_stream(stream)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(side):
                self.graph.capture_begin(pool=pool)
                try:
                    self.out = fn(self.static)
                finally:
                    self.graph.capture_end()
        finally:
            if collecting:
                gc.enable()
        stream.wait_stream(side)
        after = ops.launch_counts(), ops.body_counts()
        self.launches, self.bodies = _launches(before, after)
        made, made_bodies = _launches(start, after)
        ops.add_launch_counts({n: -c for n, c in made.items()},
                              {n: {b: -c for b, c in by.items()} for n, by in made_bodies.items()})
        self.capture_s = time.perf_counter() - t0

    def replay(self, inputs: dict) -> tuple:
        """``fn``'s outputs for ``inputs``: the graph's own tensors, which
        the next replay of any graph on the pool may overwrite (clone what
        outlives it)."""
        for name, value in inputs.items():
            self.static[name].copy_(value)
        self.graph.replay()
        ops.add_launch_counts(self.launches, self.bodies)
        return self.out

    def eager(self, inputs: dict) -> tuple:
        """``fn`` run eagerly on copies of ``inputs`` (what a replay
        computes, for a comparison)."""
        return self.fn({k: v.clone() for k, v in inputs.items()})


class AddressedGraphs:
    """``fn(held, inputs)`` replayed as CUDA graphs keyed by where its
    operands live.

    ``held``: a tree of tensors (dicts, tuples) the program reads and
    writes where they live: weights, cache leaves.  ``inputs``: a dict of
    small tensors (tokens, the cache index, prompt rows) copied into the
    graph's static buffers at each call.  One graph per addresses, shapes,
    strides and dtypes of ``held`` and shapes and dtypes of ``inputs``: a
    call whose weights or cache sit elsewhere captures anew (``captures``
    counts the captures; all share one pool).  A graph keeps the ``held``
    it was captured with alive, so a caller passes back the cache it
    received rather than a fresh copy each call.

    Each capture is preceded by ``fn`` run once on copies of the inputs (a
    ``GraphProgram`` warm-up), whose in-place writes a replay with the same
    inputs writes again; ``kept(held)`` lists what it steps that a replay
    would step again (a recurrent state), put back after the capture.  A
    replay's output that is a ``held`` tensor (written in place) comes back
    as the caller's tensor; any other is cloned (the pool's next replay may
    reuse its memory)."""

    def __init__(self, fn: Callable[[object, dict], object], *,
                 kept: Optional[Callable[[object], list]] = None):
        self.fn = fn
        self.kept = kept
        self.captures = 0
        #: key -> (program, output template, {output leaf: held leaf})
        self.graphs: dict = {}
        self._pool = self._side = None

    def capture(self, held, inputs: dict) -> tuple:
        """The graph of this call's key, captured now if it has none; returns
        the key.  A caller that must not capture while other work is queued
        calls this first."""
        leaves = _flat(held)
        key = (tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype) for t in leaves),
               tuple((k, tuple(v.shape), v.dtype) for k, v in inputs.items()))
        if key in self.graphs:
            return key
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._side = torch.cuda.Stream(next(iter(inputs.values())).device)
        template = []

        def flat(inp):
            out = self.fn(held, inp)
            template[:] = [out]
            return tuple(_flat(out))

        kept = self.kept(held) if self.kept is not None else []
        saved = [t.clone() for t in kept]
        prog = GraphProgram(flat, inputs, pool=self._pool, side=self._side, warm=flat)
        for dst, src in zip(kept, saved):
            dst.copy_(src)
        at = {t.data_ptr(): i for i, t in enumerate(leaves)}
        from_held = {j: at[t.data_ptr()] for j, t in enumerate(prog.out)
                     if t.data_ptr() in at and leaves[at[t.data_ptr()]].shape == t.shape}
        self.graphs[key] = (prog, template[0], from_held)
        self.captures += 1
        return key

    def __call__(self, held, inputs: dict):
        """``fn(held, inputs)``'s outputs from a replay (captured first if
        needed)."""
        prog, template, from_held = self.graphs[self.capture(held, inputs)]
        leaves = _flat(held)
        outs = [leaves[from_held[j]] if j in from_held else t.clone()
                for j, t in enumerate(prog.replay(inputs))]
        return _unflat(template, iter(outs))

    def pool_bytes(self) -> int:
        """Device bytes of the graphs' pool (0 before the first capture)."""
        return 0 if self._pool is None else pool_bytes(self._pool)


def _flat(tree) -> list:
    """The tensors of a tree of dicts, tuples and lists, depth first."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _flat(t)]
    return [tree]


def _unflat(template, leaves):
    """``template``'s structure over the tensors ``leaves`` yields."""
    if isinstance(template, dict):
        return {k: _unflat(v, leaves) for k, v in template.items()}
    if isinstance(template, (tuple, list)):
        return type(template)(_unflat(t, leaves) for t in template)
    return next(leaves)


def _launches(before: tuple, after: tuple) -> tuple:
    """The kernel launches, and by body, between two ``(launch_counts(),
    body_counts())`` readings."""
    counts = {n: after[0][n]["cuda"] - before[0][n]["cuda"] for n in after[0]}
    bodies = {n: {b: after[1][n][b] - before[1][n][b] for b in after[1][n]} for n in after[1]}
    return counts, bodies


def pool_bytes(pool) -> int:
    """Bytes of the allocator's segments in graph pool ``pool``."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) == tuple(pool))
