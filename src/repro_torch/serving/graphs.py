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
``ServeStepArtifacts.jitted``, ``make_collocated_step``'s decode chain,
the train step's ``TrainStepArtifacts.jitted``): their programs have no
engine to own their weights, so a graph is keyed by the addresses of the
tensors it reads and writes in place, holds them only weakly and is
dropped when one of them dies; a decode cache of known shapes is the
graph's own buffers, which a new cache is copied into.
"""
from __future__ import annotations

import gc
import itertools
import time
import weakref
from typing import Callable, NamedTuple, Optional

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


#: the warm-up and capture stream of each device shared by the train steps'
#: graphs (``warm_by_call``).  cuBLAS keeps a workspace for each stream and
#: thread that uses it, and a graph bakes in its capture stream's: a stream
#: made for each train step (after every remesh) would leave 64 MiB more
#: behind each time, while graphs that may replay beside one another (the
#: collocated chain beside the train step) need streams of their own.
#: Train steps replay one at a time.
_CAPTURE_STREAMS: dict = {}


class AddressedGraphs:
    """``fn(held, inputs)`` replayed as CUDA graphs keyed by where its
    operands live.

    ``held``: a tree of tensors (dicts, tuples) the program reads and
    writes where they live: weights, a train state.  ``inputs``: a dict of
    small tensors (tokens, the cache index, prompt rows, a batch) copied
    into the graph's static buffers at each call.  One graph per addresses,
    shapes, strides and dtypes of ``held`` and shapes and dtypes of
    ``inputs`` (``captures`` counts the captures; all share one pool).

    A graph holds ``held`` through weak references only: once any tensor
    it was keyed by is collected, the graph is dropped, and its share of
    the pool with it (at the next call when that happens during a
    capture).  So a replay never reads memory a dead tensor left behind,
    and a caller's new weights or state at new addresses capture anew
    without keeping the old ones alive.

    ``cache=True``: ``held`` is ``(weights, cache)`` and the cache is the
    graph's own, keyed by its shapes, strides and dtypes alone.  The first
    call's cache becomes the graph's buffers; a call whose cache sits
    elsewhere copies it in; every call returns the graph's buffers (the
    reference's donation: the caller passes back what it received, and a
    cache it passed in is not read after the call).  So a new cache of
    known shapes captures nothing, and the graphs stay one per shape set.

    Warm-up.  By default a capture is preceded by ``fn`` run once on copies
    of the inputs (a ``GraphProgram`` warm-up), whose in-place writes a
    replay with the same inputs writes again; ``kept(held)`` lists what it
    steps that a replay would step again (a recurrent state), put back
    after the capture.  ``warm_by_call=True``: a key's first call runs
    ``fn`` eagerly on the capture stream as the warm-up and returns that
    run's result; the capture after it launches nothing, so ``held`` is
    stepped once (a train step, whose state is too large to copy).  The
    allocator's cache is emptied before and after the warm-up: blocks
    cached for one stream serve no other, and the capture takes its own
    pool.  Such graphs share one capture stream a device
    (``_CAPTURE_STREAMS``); any other takes a stream of its own.

    A replay's output that is a ``held`` tensor (written in place) comes
    back as the caller's tensor, a cache leaf as the graph's buffer; any
    other is cloned (the pool's next replay may reuse its memory)."""

    def __init__(self, fn: Callable[[object, dict], object], *,
                 kept: Optional[Callable[[object], list]] = None, cache: bool = False,
                 warm_by_call: bool = False):
        self.fn = fn
        self.kept = kept
        self.owns_cache = cache
        self.warm_by_call = warm_by_call
        self.captures = 0
        #: key -> ``_Graph``
        self.graphs: dict = {}
        self._dead: set = set()  # keys whose tensors died during a capture
        self._pool = self._side = None

    def _parts(self, held) -> tuple:
        """(the leaves keyed by address, the cache's leaves)."""
        if self.owns_cache:
            return _flat(held[0]), _flat(held[1])
        return _flat(held), []

    def _key(self, held, inputs: dict) -> tuple:
        """The graph key of a call."""
        weights, cache = self._parts(held)
        return (tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype) for t in weights),
                tuple((tuple(t.shape), t.stride(), t.dtype) for t in cache),
                tuple((k, tuple(v.shape), v.dtype) for k, v in inputs.items()))

    def drop(self, key) -> None:
        """Forget ``key``'s graph (its pool share returns to the pool);
        during a capture, at the next call instead (destroying a graph
        then would invalidate the capture)."""
        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            self._dead.add(key)
            return
        graph = self.graphs.pop(key, None)
        if graph is not None:
            for f in graph.finalizers:
                f.detach()

    def _sweep(self) -> None:
        while self._dead:
            self.drop(self._dead.pop())

    def capture(self, held, inputs: dict) -> tuple:
        """The graph of this call's key, captured now (after a warm-up on
        copies of the inputs) if it has none; returns the key.  A caller
        that must not capture while other work is queued calls this
        first."""
        self._sweep()
        key = self._key(held, inputs)
        if key not in self.graphs:
            self._capture(key, held, inputs, warm=True)
        return key

    def _stream(self, inputs: dict) -> torch.cuda.Stream:
        if self._pool is None:
            device = next(iter(inputs.values())).device
            self._pool = torch.cuda.graph_pool_handle()
            if not self.warm_by_call:
                self._side = torch.cuda.Stream(device)
            else:
                if device not in _CAPTURE_STREAMS:
                    _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
                self._side = _CAPTURE_STREAMS[device]
        return self._side

    def _capture(self, key, held, inputs: dict, warm: bool) -> None:
        side = self._stream(inputs)
        weights, cache = self._parts(held)
        refs = [weakref.ref(t) for t in weights]
        skeleton = _unflat(held, itertools.repeat(None))
        fn, template = self.fn, []

        def flat(inp):
            # the weights through their weak references, the cache the
            # graph's own: the program keeps neither the caller's weights
            # nor its state alive
            out = fn(_unflat(skeleton, iter([r() for r in refs] + cache)), inp)
            template[:] = [_unflat(out, itertools.repeat(None))]
            return tuple(_flat(out))

        kept = self.kept(held) if warm and self.kept is not None else []
        saved = [t.clone() for t in kept]
        prog = GraphProgram(flat, inputs, pool=self._pool, side=side,
                            warm=flat if warm else None)
        for dst, src in zip(kept, saved):
            dst.copy_(src)
        leaves = weights + cache
        at = {t.data_ptr(): i for i, t in enumerate(leaves)}
        back = {j: at[t.data_ptr()] for j, t in enumerate(prog.out)
                if t.data_ptr() in at and leaves[at[t.data_ptr()]].shape == t.shape}
        # an output that is a held tensor is handed back as the caller's
        prog.out = tuple(None if j in back else t for j, t in enumerate(prog.out))
        me = weakref.ref(self)
        self.graphs[key] = _Graph(prog, template[0], back, cache,
                                  [weakref.finalize(t, _drop, me, key) for t in weights])
        self.captures += 1

    def __call__(self, held, inputs: dict):
        """``fn(held, inputs)``'s outputs from a replay (captured first if
        needed)."""
        self._sweep()
        key = self._key(held, inputs)
        if key not in self.graphs:
            if self.warm_by_call:
                torch.cuda.empty_cache()
                out = self._warm_call(held, inputs)
                torch.cuda.empty_cache()
                self._capture(key, held, inputs, warm=False)
                return out
            self._capture(key, held, inputs, warm=True)
        graph = self.graphs[key]
        weights, cache = self._parts(held)
        for dst, src in zip(graph.cache, cache):
            if dst.data_ptr() != src.data_ptr():
                dst.copy_(src)
        leaves = weights + graph.cache
        outs = [leaves[graph.back[j]] if j in graph.back else t.clone()
                for j, t in enumerate(graph.prog.replay(inputs))]
        return _unflat(graph.template, iter(outs))

    def _warm_call(self, held, inputs: dict):
        """``fn(held, inputs)`` run eagerly on the capture stream."""
        side = self._stream(inputs)
        stream = torch.cuda.current_stream(side.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            out = self.fn(held, inputs)
        stream.wait_stream(side)
        return out

    def pool_bytes(self) -> int:
        """Device bytes of the graphs' pool (0 before the first capture)."""
        return 0 if self._pool is None else pool_bytes(self._pool)


class _Graph(NamedTuple):
    """One ``AddressedGraphs`` graph: its program, its output's structure,
    ``{output index: index into the keyed leaves + cache}``, the cache
    buffers it owns, and the finalizers that drop it."""

    prog: GraphProgram
    template: object
    back: dict
    cache: list
    finalizers: list


def _drop(graphs: "weakref.ref", key) -> None:
    """A keyed tensor died: drop its graph (the ``AddressedGraphs`` held
    weakly, so a finalizer keeps no graph alive)."""
    owner = graphs()
    if owner is not None:
        owner.drop(key)


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
