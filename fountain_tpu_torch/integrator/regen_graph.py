"""The regeneration wave's iteration as segments between its triangle
queries: CUDA graphs on a card, plain calls elsewhere.

An iteration is a generator (``path._iteration``) that yields each
triangle query as (o, d, t_max, any_hit), takes the query's (t, face_idx,
found) back, and returns what the end of the iteration needs; a tail
(one per variant: inside the refill window, or draining) turns that into
the next state. ``Segments`` runs it on static buffers: the wave's state
lives in one tensor a field, and each query's results are copied into
tensors of their own before the iteration goes on. The queries stay
ordinary calls of ``geometry.intersect.intersect_faces``, looked up on the
module at each call, so a wrapper of that function sees every query and
its real rays.

On a card the first iteration of a key runs op by op on a side stream
(the warm-up: cached constants and per-stream state), then the code
between two queries, and each tail, is captured once as a CUDA graph in
one memory pool; every later iteration replays them, each query between
two replays. On the CPU every iteration runs as plain calls through the
same buffers. A scene holds one key's segments at a time (``cached``),
and they go with the scene.
"""
from __future__ import annotations

import dataclasses
import weakref

import torch

from fountain_tpu_torch.geometry import intersect

_COUNTS = {"captures": 0, "replays": 0, "eager_iterations": 0}
_HELD: dict = {}          # id(scene) -> (key, what ``cached`` made)
_STREAMS: dict = {}       # device index -> the capture stream


def counts() -> dict:
    """Iterations by how they ran: ``captures`` (keys recorded: on a card
    captured as graphs), ``replays`` (iterations run from a recording: on
    a card graph replays, on the CPU plain calls of the recorded
    segments) and ``eager_iterations`` (op by op: the plain loop, and
    the warm-up of each capture)."""
    return dict(_COUNTS)


def reset_counts() -> None:
    for k in _COUNTS:
        _COUNTS[k] = 0


def count(name: str, n: int = 1) -> None:
    _COUNTS[name] += n


def _leaves(obj):
    """The tensors and host values under ``obj``, through dataclasses,
    objects' attributes, sequences and dicts, in a fixed order."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _leaves(v)
    elif isinstance(obj, dict):
        for k in sorted(obj, key=repr):
            yield k
            yield from _leaves(obj[k])
    elif dataclasses.is_dataclass(obj) or hasattr(obj, "__dict__") \
            and not callable(obj):
        yield type(obj)
        yield from _leaves(vars(obj))
    else:
        yield obj


def signature(obj) -> tuple:
    """What a capture bakes in of ``obj``: each device tensor's address,
    shape, strides and dtype (a replay reads its values), each host
    tensor's version as well (its values are read on the host while
    capturing), and every other leaf's value."""
    out = []
    for leaf in _leaves(obj):
        if isinstance(leaf, torch.Tensor):
            out.append((leaf.data_ptr(), leaf.device, leaf.dtype,
                        tuple(leaf.shape), leaf.stride(),
                        leaf._version if leaf.device.type == "cpu" else 0))
        else:
            out.append(leaf)
    return tuple(out)


def requires_grad(*objs) -> bool:
    """Whether any tensor under ``objs`` requires grad."""
    return any(isinstance(leaf, torch.Tensor) and leaf.requires_grad
               for obj in objs for leaf in _leaves(obj))


def cached(scene, key, make):
    """What ``make()`` made for the scene under ``key``, made the first
    time. A scene holds one key: another key drops the one it held."""
    sid = id(scene)
    held = _HELD.get(sid)
    if held is not None and held[0] == key:
        return held[1]
    if sid not in _HELD:
        weakref.finalize(scene, _HELD.pop, sid, None)
    elif held is not None and torch.cuda.is_initialized():
        torch.cuda.synchronize()     # the replays of what it held have ended
    _HELD[sid] = None                # what it held goes before the new
    made = make()
    _HELD[sid] = (key, made)
    return made


def _capture_stream(device) -> torch.cuda.Stream:
    if device.index not in _STREAMS:
        _STREAMS[device.index] = torch.cuda.Stream(device)
    return _STREAMS[device.index]


def _advance(steps, value):
    """(the next query, None), or (None, the generator's value) at its
    end."""
    try:
        return steps.send(value), None
    except StopIteration as stop:
        return None, stop.value


class Segments:
    """One key's iteration on static buffers.

    ``state``: name -> tensor, the wave's state between iterations;
    ``body(scene, state)``: the iteration's generator of queries;
    ``tails``: variant -> f(what the body returned) -> the next state
    (name -> tensor), one for each variant this key's waves run."""

    def __init__(self, state: dict, body, tails: dict):
        self.state, self.body, self.tails = state, body, tails
        self.device = next(iter(state.values())).device
        self.recorded = False
        self.outs = []          # per query: its static result tensors
        # on a card: each query's (o, d, t_max, any_hit) tensors, the
        # graph before each query and the one after the last, each tail's
        self.queries, self.graphs, self.tail_graphs = [], [], {}

    def load(self, state: dict) -> None:
        """A wave's first state into the static buffers."""
        for k, v in state.items():
            self.state[k].copy_(v)

    def _store(self, new: dict) -> None:
        for k, v in new.items():
            buf = self.state[k]
            if v.data_ptr() != buf.data_ptr():
                buf.copy_(v)

    def _answer(self, scene, k: int, query) -> tuple:
        """Query ``k`` through ``intersect.intersect_faces``, its results
        copied into the static ones (made while recording)."""
        o, d, t_max, any_hit = query
        res = intersect.intersect_faces(scene, o, d, t_max, any_hit=any_hit)
        if k == len(self.outs) and not self.recorded:
            self.outs.append(tuple(torch.empty_like(r) for r in res))
        for buf, r in zip(self.outs[k], res):
            buf.copy_(r)
        return self.outs[k]

    def _plain(self, scene, variant) -> None:
        """One iteration as plain calls through the static buffers."""
        steps = self.body(scene, self.state)
        k, (query, middle) = 0, _advance(steps, None)
        while query is not None:
            query, middle = _advance(steps, self._answer(scene, k, query))
            k += 1
        if k != len(self.outs):
            raise RuntimeError(f"an iteration made {k} triangle queries, "
                               f"its recording {len(self.outs)}")
        self._store(self.tails[variant](middle))

    def _graph(self, pool, fn):
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            out = fn()
        finally:
            graph.capture_end()
        return graph, out

    def _capture(self, scene) -> None:
        """The body as one graph before each query and one after the
        last, and each tail as a graph; one memory pool."""
        pool = torch.cuda.graph_pool_handle()
        steps = self.body(scene, self.state)
        value = None
        while True:
            graph, (query, middle) = self._graph(
                pool, lambda: _advance(steps, value))
            self.graphs.append(graph)
            if query is None:
                break
            value = self.outs[len(self.queries)]
            self.queries.append(query)
        if len(self.queries) != len(self.outs):
            raise RuntimeError("the captured iteration made another number "
                               "of triangle queries than its warm-up")
        for v, tail in self.tails.items():
            self.tail_graphs[v], _ = self._graph(
                pool, lambda: self._store(tail(middle)))

    def _record(self, scene, variant) -> None:
        """The key's first iteration, op by op, then on a card the
        capture (on the capture stream, which the warm-up readies)."""
        if self.device.type == "cuda":
            dev = self.device
            stream = _capture_stream(dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                self._plain(scene, variant)
                torch.cuda.synchronize(dev)
                self._capture(scene)
            torch.cuda.current_stream(dev).wait_stream(stream)
        else:
            self._plain(scene, variant)
        self.recorded = True
        count("eager_iterations")
        count("captures")

    def iterate(self, scene, variant) -> None:
        """One iteration of the wave with tail ``variant``: recorded the
        first time, replayed after (on the CPU as plain calls)."""
        if not self.recorded:
            self._record(scene, variant)
            return
        if self.device.type == "cuda":
            for k, (graph, query) in enumerate(zip(self.graphs,
                                                   self.queries)):
                graph.replay()
                self._answer(scene, k, query)
            self.graphs[-1].replay()
            self.tail_graphs[variant].replay()
        else:
            self._plain(scene, variant)
        count("replays")
