"""The graphed waves: code between a wave's triangle queries, recorded
once a key and replayed; CUDA graphs on a card, plain calls elsewhere.

A body is a generator (``path._iteration``, ``path._fixed_wave``) that
yields each triangle query as (o, d, t_max, any_hit), takes the query's
(t, face_idx, found) back, and returns what follows its last query. Two
kinds of recording run one:
- ``Segments``: a regeneration wave's iteration with no autograd graph,
  on static state buffers, and its tails (one per variant: inside the
  refill window, or draining) that turn the body's value into the next
  state;
- ``GradWave``: the fixed wave under autograd, run as ``_WaveFn``, an
  autograd function over the scene's tables that require grad and the
  wave's first lanes; its backward is one more graph.

The queries stay ordinary calls of ``geometry.intersect.intersect_faces``,
looked up on the module at each call, so a wrapper of that function sees
every query of every wave, the first of a key too, and its real rays.
Each query's results are copied into static tensors of the hit record's
format (``intersect.empty_results``) that the code after it reads.

One policy for both kinds:
- Capture. On a card the first call of a key captures, on the device's
  capture stream and with nothing run op by op first: the code before
  each query and after the last as one graph each (and each tail), in
  one memory pool. The kernels load while capturing; a constant not
  cached yet is a fill inside the graph (``vecmath.const``). Then that
  call replays, as every later call does: its inputs copied in, each
  query answered between two replays. The differentiable wave captures
  with autograd on, so its autograd graph and saved tensors live in the
  pool; its first backward captures the backward graph. On the CPU every
  call runs as plain calls: segments through the same static buffers, the
  differentiable wave under autograd.
- Holding. A device holds one recording of each kind (``_HELD``). A call
  with another key replaces it after a synchronize, and the recording
  goes when any tensor that its key reads by address is freed.
- Key (``_key``, the one rule of what a recording bakes in). A tensor
  copied into the recording at each call (the segments' first state; the
  wave's tables that require grad and first lanes) by its device, dtype,
  shape and whether it requires grad; every other tensor by address,
  shape, strides and dtype (a replay reads it there), and a CPU tensor by
  its version too (its values are read on the host while capturing);
  every other leaf by its value. A step that builds fresh leaves and a
  fresh scene each time therefore replays.
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
_HELD: dict = {}          # (device, kind) -> (key, recording): the one held
_STREAMS: dict = {}       # device index -> the capture stream


def counts() -> dict:
    """Regeneration iterations by how they ran: ``captures`` (the first
    iteration of each key recorded; on a card captured as graphs, then
    replayed), ``replays`` (later iterations from a recording: on a card
    graph replays, on the CPU plain calls of the recorded segments) and
    ``eager_iterations`` (op by op: the plain loop; no capture runs one
    first); fixed waves likewise: ``wave_captures`` (differentiable keys
    recorded), ``wave_replays`` (later differentiable waves, a re-run
    before a backward included) and ``eager_waves`` (op by op: the plain
    loop without autograd)."""
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


def _key(obj, copied) -> tuple:
    """(the key, the tensors it reads by address) of a recording of
    ``obj`` whose ``copied`` tensors are copied in at each call: the rule
    in the module docstring. A copied tensor met under ``obj`` is keyed by
    its place in ``copied``."""
    index = {id(t): i for i, t in enumerate(copied)}
    key = [tuple((t.device, t.dtype, tuple(t.shape), t.requires_grad)
                 for t in copied)]
    by_address = {}
    for leaf in _leaves(obj):
        if not isinstance(leaf, torch.Tensor):
            key.append(leaf)
        elif id(leaf) in index:
            key.append(index[id(leaf)])
        else:
            by_address[id(leaf)] = leaf
            key.append((leaf.data_ptr(), leaf.device, leaf.dtype,
                        tuple(leaf.shape), leaf.stride(),
                        leaf._version if leaf.device.type == "cpu" else 0))
    return tuple(key), list(by_address.values())


def requires_grad(*objs) -> bool:
    """Whether any tensor under ``objs`` requires grad."""
    return any(isinstance(leaf, torch.Tensor) and leaf.requires_grad
               for obj in objs for leaf in _leaves(obj))


def _grad_tables(obj) -> list:
    """The tensors under ``obj`` that require grad, each once, in the
    order of their first appearance."""
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


def _release(slot, rec) -> None:
    """``_HELD``'s recording of ``slot`` dropped if it is ``rec()``."""
    held = _HELD.get(slot)
    if held is not None and held[1] is rec():
        del _HELD[slot]


def _hold(kind: str, device, key, by_address, make):
    """The device's recording of ``kind`` for ``key``: the one held, or
    ``make()`` in place of one with another key. The new one goes when
    any tensor of ``by_address`` goes."""
    slot = (device, kind)
    if slot in _HELD:
        if _HELD[slot][0] == key:
            return _HELD[slot][1]
        if device.type == "cuda":
            torch.cuda.synchronize(device)   # the replays of what it held
        del _HELD[slot]                      # goes before the new is made
    rec = make()
    _HELD[slot] = (key, rec)
    ref = weakref.ref(rec)
    for t in by_address:
        weakref.finalize(t, _release, slot, ref)
    return rec


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


class _Recording:
    """A key's triangle queries between recorded code: each query's
    static results, the seeds the body reads from a device tensor, and on
    a card each query's tensors and the graph before each query and the
    one after the last, in one memory pool."""

    def __init__(self, device, n_seeds: int):
        self.device = device
        self.recorded = False
        self.seeds = torch.zeros(n_seeds, dtype=torch.int64, device=device)
        self.outs = []          # per query: its static result tensors
        self.queries, self.graphs = [], []

    def _load(self, statics, values, seeds) -> None:
        """A call's inputs and seeds into the static ones, through
        ``.data``: an autograd graph that saved a static input
        (``GradWave``'s) sees no change of version."""
        with torch.no_grad():
            for buf, x in zip(statics, values):
                buf.data.copy_(x)
            for buf, s in zip(self.seeds.data, seeds):
                buf.fill_(s)

    def _results(self, k: int, query) -> tuple:
        """Query ``k``'s static results, made the first time."""
        if k == len(self.outs):
            o = query[0]
            self.outs.append(intersect.empty_results(o.x.shape[0],
                                                     o.x.device))
        return self.outs[k]

    def _answer(self, scene, k: int, query) -> tuple:
        """Query ``k`` through ``intersect.intersect_faces``, its results
        copied into the static ones (through ``.data``, as ``_load``)."""
        o, d, t_max, any_hit = query
        res = intersect.intersect_faces(scene, o, d, t_max, any_hit=any_hit)
        for buf, r in zip(self._results(k, query), res):
            buf.data.copy_(r)
        return self.outs[k]

    def _graph(self, fn):
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
        try:
            out = fn()
        finally:
            graph.capture_end()
        return graph, out

    def _record(self, capture) -> None:
        """The capture policy (module docstring): ``capture()`` on the
        device's capture stream, in a new pool."""
        self.pool = torch.cuda.graph_pool_handle()
        _on_capture_stream(self.device, capture)
        self.recorded = True

    def _capture_steps(self, scene, steps):
        """The generator ``steps`` as one graph before each query and one
        after the last, each query reading its static results; returns
        the generator's value."""
        value = None
        while True:
            graph, (query, middle) = self._graph(
                lambda: _advance(steps, value))
            self.graphs.append(graph)
            if query is None:
                return middle
            value = self._results(len(self.queries), query)
            self.queries.append(query)

    def _replay_steps(self, scene) -> None:
        """The captured graphs in turn, each query answered between two."""
        for k, (graph, query) in enumerate(zip(self.graphs, self.queries)):
            graph.replay()
            self._answer(scene, k, query)
        self.graphs[-1].replay()


class Segments(_Recording):
    """One key's regeneration iteration on static buffers.

    ``state``: name -> tensor, the wave's state between iterations (the
    buffers take its shapes and dtypes); ``body(scene, state, seeds)``:
    the iteration's generator of queries; ``tails``: variant -> f(what
    the body returned, seeds) -> the next state (name -> tensor)."""

    def __init__(self, state: dict, n_seeds: int, body, tails: dict):
        device = next(iter(state.values())).device
        super().__init__(device, n_seeds)
        self.state = {k: torch.empty(v.shape, dtype=v.dtype, device=device)
                      for k, v in state.items()}
        self.body, self.tails = body, tails
        self.tail_graphs = {}   # on a card: each tail's graph

    def _store(self, new: dict) -> None:
        for k, v in new.items():
            buf = self.state[k]
            if v.data_ptr() != buf.data_ptr():
                buf.copy_(v)

    def _plain(self, scene, variant) -> None:
        """One iteration as plain calls through the static buffers."""
        steps = self.body(scene, self.state, self.seeds)
        k, (query, middle) = 0, _advance(steps, None)
        while query is not None:
            query, middle = _advance(steps, self._answer(scene, k, query))
            k += 1
        if k != len(self.outs):
            raise RuntimeError(f"an iteration made {k} triangle queries, "
                               f"its recording {len(self.outs)}")
        self._store(self.tails[variant](middle, self.seeds))

    def _capture(self, scene, variants) -> None:
        """The body as graphs between its queries, and a graph of each
        tail in ``variants``."""
        middle = self._capture_steps(
            scene, self.body(scene, self.state, self.seeds))
        for v in variants:
            self.tail_graphs[v], _ = self._graph(
                lambda: self._store(self.tails[v](middle, self.seeds)))

    def run(self, scene, state: dict, seeds, schedule) -> dict:
        """A wave from its first ``state`` with ``seeds``: one iteration
        with each tail variant of ``schedule`` in turn; returns the static
        state after the last."""
        self._load(self.state.values(), state.values(), seeds)
        for variant in schedule:
            count("replays" if self.recorded else "captures")
            if self.device.type == "cuda":
                if not self.recorded:
                    self._record(lambda: self._capture(
                        scene, dict.fromkeys(schedule)))
                self._replay_steps(scene)
                self.tail_graphs[variant].replay()
            else:
                self._plain(scene, variant)
                self.recorded = True
        return self.state


def segmented(scene, state: dict, seeds: tuple, body, tails: dict,
              schedule, config) -> dict:
    """A regeneration wave through the device's ``Segments`` for this key
    (made the first time): ``state`` copied in, then an iteration of
    ``body`` and the tail ``schedule[i]`` for each i. ``seeds`` (ints or
    device scalars) are read by ``body`` and ``tails`` from a device
    tensor; ``config`` is everything else they bake in. Returns the
    static state after the last iteration: clone what is kept."""
    key, by_address = _key((scene, tuple(schedule), config),
                           list(state.values()))
    seg = _hold("segments", next(iter(state.values())).device, key,
                by_address, lambda: Segments(state, len(seeds), body, tails))
    return seg.run(scene, state, seeds, schedule)


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
        super().__init__(device, 1)
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

    def _capture(self, scene, inputs) -> None:
        """The body on static inputs, captured with autograd on: its
        outputs and the autograd graph with its saved tensors stay in the
        pool."""
        self.inputs = [torch.empty_like(x).requires_grad_(x.requires_grad)
                       for x in inputs]
        sc = self._on(scene, self.inputs)
        with torch.enable_grad():
            self.outputs = self._capture_steps(sc, self.body(
                sc, self.seeds[0], *self.inputs[self.n_tables:]))

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
        self.bwd_graph, _ = self._graph(lambda: _backward(
            [self.outputs[i] for i in self.want], self.grad_outs))
        self.grads = [x.grad for x in self.inputs]

    def replay(self, scene, seed, inputs) -> None:
        """The captured wave on ``inputs``, its queries on ``scene``,
        whose tensors are at the key's addresses."""
        self._load(self.inputs, inputs, (seed,))
        with torch.no_grad():
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
                wave._record(lambda: wave._capture(scene, inputs))
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


def differentiable(scene, seed, args: tuple, body, config) -> tuple:
    """``body(scene, seed, *args)`` (a generator of triangle queries that
    returns a tuple of tensors; ``args`` and each query's results are
    per lane, lanes first) as ``_WaveFn`` over the device's ``GradWave``
    for this key: differentiable in the scene's tables that require grad
    and in ``args``, which are copied in at each call. ``config``: what
    else the body bakes in."""
    tables = _grad_tables(scene)
    key, by_address = _key((scene, config), (*tables, *args))
    wave = _hold("wave", args[0].device, key, by_address,
                 lambda: GradWave(args[0].device, len(tables), body))
    return _WaveFn.apply(wave, scene, seed, *tables, *args)
