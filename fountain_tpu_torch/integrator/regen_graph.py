"""The regeneration wave's iteration, and the differentiable fixed wave,
as segments between their triangle queries: CUDA graphs on a card, plain
calls elsewhere.

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

The fixed wave under autograd (``differentiable``) runs as ``_WaveFn``,
an autograd function over the scene's tables that require grad and the
wave's first lanes. On a card the first call of a key captures the code
between two queries with autograd on, on the capture stream and with no
warm-up, so that the autograd graph and its saved tensors live in the
graphs' pool; each query's static results are made from a one-lane query
of its kind. Every call, the first too, copies its inputs in, replays,
and returns clones. Its backward copies the incoming gradients in and
replays one more graph, the backward from the wave's outputs to its
inputs (a ``backward`` into the static inputs' ``.grad``, same pool,
captured in the first backward), and returns clones. A backward whose
wave a later call has replayed over replays its own forward first. A
device holds one key's wave (``_WAVES``), and it goes with the first
tensor of its scene that goes: the key reads the tables that require
grad by shape and dtype and every other tensor of the scene by address,
so a step that builds fresh leaves and a fresh scene each time replays.
On the CPU each call runs under autograd as plain calls, and its
backward through ``torch.autograd.grad`` of its graph.
"""
from __future__ import annotations

import copy
import dataclasses
import inspect
import weakref

import torch
from torch.autograd.function import once_differentiable

from fountain_tpu_torch.geometry import intersect

_COUNTS = {"captures": 0, "replays": 0, "eager_iterations": 0,
           "wave_captures": 0, "wave_replays": 0, "eager_waves": 0}
_HELD: dict = {}          # id(scene) -> (key, what ``cached`` made)
_WAVES: dict = {}         # device -> (key, GradWave): the one held
_STREAMS: dict = {}       # device index -> the capture stream


def counts() -> dict:
    """Regeneration iterations by how they ran: ``captures`` (keys
    recorded: on a card captured as graphs), ``replays`` (iterations run
    from a recording: on a card graph replays, on the CPU plain calls of
    the recorded segments) and ``eager_iterations`` (op by op: the plain
    loop, and the warm-up of each capture); fixed waves likewise:
    ``wave_captures`` (differentiable keys recorded: on a card captured
    as graphs), ``wave_replays`` (differentiable waves run from a
    recording, a re-run before a backward included) and ``eager_waves``
    (op by op: the plain loop without autograd)."""
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


def signature(obj, grad_inputs: bool = False) -> tuple:
    """What a capture bakes in of ``obj``: each device tensor's address,
    shape, strides and dtype (a replay reads its values), each host
    tensor's version as well (its values are read on the host while
    capturing), and every other leaf's value. With ``grad_inputs`` a
    tensor that requires grad is an input of the differentiable wave,
    copied in at each call: its device, dtype, shape and which of the
    inputs it is."""
    out, inputs = [], {}
    for leaf in _leaves(obj):
        if isinstance(leaf, torch.Tensor) and leaf.requires_grad \
                and grad_inputs:
            out.append((inputs.setdefault(id(leaf), len(inputs)),
                        leaf.device, leaf.dtype, tuple(leaf.shape)))
        elif isinstance(leaf, torch.Tensor):
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


def _grad_tables(obj) -> list:
    """The tensors under ``obj`` that require grad, each once, in the
    order ``signature`` numbers them."""
    found = {}
    for leaf in _leaves(obj):
        if isinstance(leaf, torch.Tensor) and leaf.requires_grad:
            found.setdefault(id(leaf), leaf)
    return list(found.values())


def _substitute(obj, swap: dict):
    """``obj`` with each tensor whose id is in ``swap`` replaced by its
    value there, through the containers ``_leaves`` walks; objects and
    containers holding none are shared, the others shallow-copied."""
    if isinstance(obj, torch.Tensor):
        return swap.get(id(obj), obj)
    if isinstance(obj, (list, tuple)):
        new = [_substitute(v, swap) for v in obj]
        if all(a is b for a, b in zip(new, obj)):
            return obj
        return type(obj)(*new) if hasattr(obj, "_fields") else type(obj)(new)
    if isinstance(obj, dict):
        new = {k: _substitute(v, swap) for k, v in obj.items()}
        return obj if all(new[k] is obj[k] for k in obj) else new
    if dataclasses.is_dataclass(obj) or hasattr(obj, "__dict__") \
            and not callable(obj):
        changed = {k: n for k, v in vars(obj).items()
                   if (n := _substitute(v, swap)) is not v}
        if not changed:
            return obj
        out = copy.copy(obj)
        for k, v in changed.items():
            object.__setattr__(out, k, v)    # frozen dataclasses too
        return out
    return obj


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


def _on_capture_stream(device, fn):
    """``fn()`` on the device's capture stream, ordered after the work
    queued on the current stream and before the work queued after."""
    if device.index not in _STREAMS:
        _STREAMS[device.index] = torch.cuda.Stream(device)
    stream = _STREAMS[device.index]
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        out = fn()
    torch.cuda.current_stream(device).wait_stream(stream)
    return out


def _advance(steps, value):
    """(the next query, None), or (None, the generator's value) at its
    end."""
    try:
        return steps.send(value), None
    except StopIteration as stop:
        return None, stop.value


def _empty_results(scene, query) -> tuple:
    """Uninitialised result tensors for ``query``, their dtypes those of
    a one-lane query of the same kind (a ray of length 0)."""
    o, _, _, any_hit = query
    zero = torch.zeros(1, dtype=o.x.dtype, device=o.x.device)
    res = intersect.intersect_faces(scene, type(o)(zero, zero, zero),
                                    type(o)(zero, zero, zero + 1), zero,
                                    any_hit=any_hit)
    return tuple(torch.empty((o.x.shape[0], *r.shape[1:]), dtype=r.dtype,
                             device=r.device) for r in res)


class _Recording:
    """A key's triangle queries between recorded code: each query's
    static results, and on a card each query's tensors and the graph
    before each query and the one after the last, in one memory pool."""

    def __init__(self, device):
        self.device = device
        self.recorded = False
        self.outs = []          # per query: its static result tensors
        self.queries, self.graphs = [], []

    def _answer(self, scene, k: int, query) -> tuple:
        """Query ``k`` through ``intersect.intersect_faces``, its results
        copied into the static ones (made while recording). The copy goes
        through ``.data``: an autograd graph that saved a static result
        (``GradWave``'s) sees no change of version."""
        o, d, t_max, any_hit = query
        res = intersect.intersect_faces(scene, o, d, t_max, any_hit=any_hit)
        if k == len(self.outs) and not self.recorded:
            self.outs.append(tuple(torch.empty_like(r) for r in res))
        for buf, r in zip(self.outs[k], res):
            buf.data.copy_(r)
        return self.outs[k]

    def _graph(self, pool, fn):
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            out = fn()
        finally:
            graph.capture_end()
        return graph, out

    def _capture_steps(self, scene, steps, pool):
        """The generator ``steps`` as one graph before each query and one
        after the last, each query reading the static results (made here
        where no warm-up made them); returns the generator's value."""
        value = None
        while True:
            graph, (query, middle) = self._graph(
                pool, lambda: _advance(steps, value))
            self.graphs.append(graph)
            if query is None:
                break
            if len(self.outs) == len(self.queries):
                self.outs.append(_empty_results(scene, query))
            value = self.outs[len(self.queries)]
            self.queries.append(query)
        if len(self.queries) != len(self.outs):
            raise RuntimeError("the capture made another number of "
                               "triangle queries than its warm-up")
        return middle

    def _replay_steps(self, scene) -> None:
        """The captured graphs in turn, each query answered between two."""
        for k, (graph, query) in enumerate(zip(self.graphs, self.queries)):
            graph.replay()
            self._answer(scene, k, query)
        self.graphs[-1].replay()


class Segments(_Recording):
    """One key's iteration on static buffers.

    ``state``: name -> tensor, the wave's state between iterations;
    ``body(scene, state)``: the iteration's generator of queries;
    ``tails``: variant -> f(what the body returned) -> the next state
    (name -> tensor), one for each variant this key's waves run."""

    def __init__(self, state: dict, body, tails: dict):
        super().__init__(next(iter(state.values())).device)
        self.state, self.body, self.tails = state, body, tails
        self.tail_graphs = {}   # on a card: each tail's graph

    def load(self, state: dict) -> None:
        """A wave's first state into the static buffers."""
        for k, v in state.items():
            self.state[k].copy_(v)

    def _store(self, new: dict) -> None:
        for k, v in new.items():
            buf = self.state[k]
            if v.data_ptr() != buf.data_ptr():
                buf.copy_(v)

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

    def _capture(self, scene) -> None:
        """The body as one graph before each query and one after the
        last, and each tail as a graph; one memory pool."""
        pool = torch.cuda.graph_pool_handle()
        middle = self._capture_steps(scene, self.body(scene, self.state),
                                     pool)
        for v, tail in self.tails.items():
            self.tail_graphs[v], _ = self._graph(
                pool, lambda: self._store(tail(middle)))

    def _record(self, scene, variant) -> None:
        """The key's first iteration, op by op, then on a card the
        capture (on the capture stream, which the warm-up readies)."""
        if self.device.type == "cuda":
            def warm_then_capture():
                self._plain(scene, variant)
                torch.cuda.synchronize(self.device)
                self._capture(scene)
            _on_capture_stream(self.device, warm_then_capture)
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
            self._replay_steps(scene)
            self.tail_graphs[variant].replay()
        else:
            self._plain(scene, variant)
        count("replays")


def _backward(outs, grads, inputs=(), keep_graph: bool = True):
    """The autograd engine's backward from ``outs`` with their incoming
    ``grads``: into the leaves' ``.grad``, or, given ``inputs``, returned
    as their gradients (None where unused). It is
    ``torch.autograd.backward`` (``grad``) less its checks of given
    gradients, whose first call imports ``torch.fx``'s symbolic shapes:
    ~4.3 s of a card's set-up on the H100 machine."""
    from torch.autograd.graph import _engine_run_backward
    return _engine_run_backward(tuple(outs), tuple(grads), keep_graph,
                                False, tuple(inputs),
                                allow_unreachable=True,
                                accumulate_grad=not inputs)


def _eager_grads(leaves, outs, grads) -> list:
    """d(outs) / d(leaves) with the incoming ``grads`` (None: no
    gradient), by ``_backward``; None where a leaf takes no grad."""
    pairs = [(o, g) for o, g in zip(outs, grads)
             if g is not None and o.requires_grad]
    wrt = [x for x in leaves if x.requires_grad]
    if not pairs or not wrt:
        return [None] * len(leaves)
    got = iter(_backward(*zip(*pairs), wrt, keep_graph=False))
    return [next(got) if x.requires_grad else None for x in leaves]


class GradWave(_Recording):
    """One key's differentiable wave. ``body(scene, seed, *args)``: a
    generator function of its triangle queries returning a tuple of
    tensors (so that everything it makes, it makes inside the graphs);
    its inputs are the scene's ``n_tables`` tables that require grad and
    then ``args``. Run through ``_WaveFn``."""

    def __init__(self, device, n_tables: int, body):
        if not inspect.isgeneratorfunction(body):
            raise TypeError("a differentiable wave's body must be a "
                            "generator function")
        super().__init__(device)
        self.n_tables, self.body = n_tables, body
        self.generation = 0     # graph replays so far: whose values it holds
        self.bwd_graph = None

    def _on(self, scene, inputs):
        """``scene`` with its tables that require grad swapped for the
        first ``n_tables`` of ``inputs``."""
        return _substitute(scene, {id(t): x for t, x in zip(
            _grad_tables(scene), inputs[:self.n_tables])})

    def eager(self, scene, seed, inputs):
        """One call as plain calls under autograd, on leaves that alias
        ``inputs``: (leaves, outputs)."""
        leaves = [x.detach().requires_grad_(x.requires_grad)
                  for x in inputs]
        sc = self._on(scene, leaves)
        with torch.enable_grad():
            outs = intersect.answer_queries(
                sc, self.body(sc, seed, *leaves[self.n_tables:]))
        return leaves, outs

    def record(self, scene, inputs) -> None:
        """On a card, the key's first call: on the capture stream, the
        body on static inputs captured with autograd on between the
        queries, in one pool where its outputs and the autograd graph with
        its saved tensors stay. No warm-up runs first: the kernels load
        while capturing, a constant not cached yet is a fill in the graph
        (``vecmath.const``), and each query's static results are made
        from a one-lane query of its kind."""
        def capture():
            self.inputs = [torch.empty_like(x).requires_grad_(
                x.requires_grad) for x in inputs]
            self.seed = torch.zeros((), dtype=torch.int64,
                                    device=self.device)
            sc = self._on(scene, self.inputs)
            self.pool = torch.cuda.graph_pool_handle()
            with torch.enable_grad():
                self.outputs = self._capture_steps(
                    sc, self.body(sc, self.seed,
                                  *self.inputs[self.n_tables:]), self.pool)
        _on_capture_stream(self.device, capture)
        self.recorded = True

    def _capture_backward(self) -> None:
        """The backward from the static outputs to the static inputs as
        one graph. It is a plain ``backward`` (``_backward``): the static
        inputs are the graph's only leaves that require grad, and each
        one's ``.grad``, None until then, becomes its static gradient,
        which every replay writes anew."""
        self.want = [i for i, o in enumerate(self.outputs)
                     if o.requires_grad]
        self.grad_outs = [torch.empty_like(self.outputs[i])
                          for i in self.want]
        if not self.want:
            self.bwd_graph, self.grads = False, [None] * len(self.inputs)
            return
        self.bwd_graph, _ = self._graph(
            self.pool, lambda: _backward(
                [self.outputs[i] for i in self.want], self.grad_outs))
        self.grads = [x.grad for x in self.inputs]

    def replay(self, scene, seed, inputs) -> None:
        """The captured wave on ``inputs`` (copied in through ``.data``,
        so the saved autograd graph sees no change of version), its
        queries on ``scene``, whose tensors are at the key's addresses."""
        with torch.no_grad():
            for buf, x in zip(self.inputs, inputs):
                buf.data.copy_(x)
            self.seed.data.fill_(seed)
            self._replay_steps(scene)
        self.generation += 1

    def backward(self, ctx, grads) -> list:
        """A call's backward: the wave replayed again first if a later
        call has replaced its values, then the backward graph replayed
        (captured the first time)."""
        if ctx.generation != self.generation:
            self.replay(ctx.scene, ctx.seed, ctx.saved_tensors)
            count("wave_replays")
        if self.bwd_graph is None:
            _on_capture_stream(self.device, self._capture_backward)
        if self.bwd_graph is False:
            return [None] * len(self.inputs)
        with torch.no_grad():
            for buf, i in zip(self.grad_outs, self.want):
                if grads[i] is None:
                    buf.zero_()
                else:
                    buf.copy_(grads[i])
        self.bwd_graph.replay()
        return [None if g is None else g.clone() for g in self.grads]


class _WaveFn(torch.autograd.Function):
    """A differentiable wave: ``apply(wave, scene, seed, *inputs)`` ->
    clones of the wave's outputs. On a card a replay of the key's
    graphs (recorded first if need be); on the CPU the body under
    autograd, differentiated by ``torch.autograd.grad``."""

    @staticmethod
    def forward(ctx, wave, scene, seed, *inputs):
        ctx.set_materialize_grads(False)
        ctx.wave, ctx.seed, ctx.eager = wave, seed, None
        count("wave_replays" if wave.recorded else "wave_captures")
        if wave.device.type == "cuda":
            if not wave.recorded:
                wave.record(scene, inputs)
            wave.replay(scene, seed, inputs)
            ctx.scene, ctx.generation = scene, wave.generation
            ctx.save_for_backward(*inputs)
            outs = wave.outputs
        else:
            wave.recorded = True
            ctx.eager = wave.eager(scene, seed, inputs)
            outs = ctx.eager[1]
        res = tuple(o.detach().clone() for o in outs)
        ctx.mark_non_differentiable(*(r for r, o in zip(res, outs)
                                      if not o.requires_grad))
        return res

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        if ctx.eager is None:
            got = ctx.wave.backward(ctx, grads)
        else:
            (leaves, outs), ctx.eager = ctx.eager, None
            got = _eager_grads(leaves, outs, grads)
        return (None, None, None, *got)


def _spec(x: torch.Tensor) -> tuple:
    return x.device, x.dtype, tuple(x.shape), x.requires_grad


def _release(device, wave) -> None:
    """``_WAVES``' wave of ``device`` dropped if it is ``wave()``."""
    held = _WAVES.get(device)
    if held is not None and held[1] is wave():
        del _WAVES[device]


def differentiable(scene, seed, args: tuple, body, key) -> tuple:
    """``body(scene, seed, *args)`` (a generator of triangle queries that
    returns a tuple of tensors; ``args`` and each query's results are
    per lane, lanes first) as ``_WaveFn``: differentiable in the scene's
    tables that require grad and in ``args``. ``key``: what else
    the body bakes in (its configuration). The device holds one key's
    ``GradWave``: another key drops the one it held, and so does the end
    of any tensor of the scene that does not require grad (whose address
    the graphs read)."""
    tables = _grad_tables(scene)
    dev = args[0].device
    key = (signature(scene, grad_inputs=True),
           tuple(_spec(x) for x in args), key)
    held = _WAVES.get(dev)
    if held is None or held[0] != key:
        if held is not None and dev.type == "cuda":
            torch.cuda.synchronize(dev)  # the replays of what it held ended
        _WAVES[dev] = None               # what it held goes before the new
        wave = GradWave(dev, len(tables), body)
        _WAVES[dev] = held = (key, wave)
        ref = weakref.ref(wave)
        for t in {id(t): t for t in _leaves(scene) if isinstance(
                t, torch.Tensor) and not t.requires_grad}.values():
            weakref.finalize(t, _release, dev, ref)
    return _WaveFn.apply(held[1], scene, seed, *tables, *args)
