"""Whole-pipeline capture: a homomorphic pipeline as one CUDA graph (port of
mkhe_tpu/fuse.py).

The JAX package compiles a pipeline into one XLA program, so that its
evaluator ops cost one dispatch instead of one each. The counterpart here
is a captured torch.cuda.CUDAGraph: the pipeline's eager kernel launches
(about 11,000 for one CNN inference) become one replay.

Key material stays out of the graph's code, as in the JAX package: a
recording pass logs which stacked key combinations the pipeline requests
from its RelinearizationKeySet / RotationKeySet / ConjugationKeySet, in
order of first request, and fuse keeps copies of those stacks as the
graph's static key tensors (args[1]). It does not lean on the sets' memos,
which a set drops when a key is added. Where the JAX package records under
jax.eval_shape, the recording pass here is the eager warm-up a capture
needs anyway, on a side stream: it also builds every table the pipeline
builds on first use (Galois tables, basis constants, index tensors, the
split NTT's tables, the kernel library), so that nothing inside the
capture is made from host values.

Inputs are flattened: mkckks and BFV (mkrlwe) ciphertexts, lists and
tuples of them, and plaintext tensors (on the params' device; the
evaluator's numpy route for plaintexts is for eager callers). Calling fn
with new inputs copies them into the graph's static inputs; ids, level, scale,
shapes and dtypes must equal the captured ones, or fn raises ValueError:
the JAX package compiles once per shape, and a graph is captured once per
shape, by calling fuse again. Outputs are clones of the graph's static outputs, so
a second call does not overwrite the first call's result.

With CUDA parameters fuse captures one graph, in the default capture
error mode; nothing catches a failed capture or runs eagerly instead. The
parallel tier's collectives cannot be captured (parallel/comm.py raises
inside a capture), so fuse raises on a pipeline that reaches one rather
than record a broken graph: the sharded paths run eagerly.
With CPU parameters (asked for explicitly, as the tests do) fn runs the
pipeline eagerly against the recorded tables.

Usage, as in the JAX package::

    def pipeline(ev, keys, ct_a, ct_b):
        prod = ev.mul_relin_new(ct_a, ct_b, keys.rlk)
        return ev.rotate_new(prod, 1, keys.rtk)

    fn, args = fuse.fuse(params, pipeline, (ct_a, ct_b),
                         rlk_set=rlk, rtk_set=rtk)
    out = fn(*args)                          # one graph replay
    out2 = fn(args[0], args[1], (ct_a2, ct_b2))   # new inputs
"""

from __future__ import annotations

import dataclasses
import time
import types

import torch

from . import mkbfv, mkckks
from .mkrlwe.elements import Ciphertext as RCt
from .ops import ntt_cuda
from .utils.profiling import span


class _Record:
    """Recording shim: logs each stacked key combination the pipeline
    requests from a RelinearizationKeySet or ConjugationKeySet, in order
    of first request, and returns the real stack."""

    def __init__(self, real):
        self.real, self.stacks = real, {}

    def stacked(self, ids):
        k = tuple(ids)
        if k not in self.stacks:
            self.stacks[k] = self.real.stacked(k)
        return self.stacks[k]


class _RecordRot(_Record):
    """_Record for a RotationKeySet: requests are (ids, rotation)."""

    def stacked(self, ids, rot):
        k = (tuple(ids), rot)
        if k not in self.stacks:
            self.stacks[k] = self.real.stacked(*k)
        return self.stacks[k]


class _Replay:
    def __init__(self, table):
        self.table = table

    def stacked(self, ids, rot=None):
        return self.table[tuple(ids) if rot is None
                          else (tuple(ids), rot)]


def _keys_ns(rlk, rtk, cjk):
    return types.SimpleNamespace(rlk=rlk, rtk=rtk, cjk=cjk)


def _replay_keys(tables):
    return _keys_ns(*(_Replay(tables[k]) if k in tables else None
                      for k in ("rlk", "rtk", "cjk")))


# ----------------------------------------------------------------------------
# Flattening of inputs and outputs
# ----------------------------------------------------------------------------

def _meta(t: torch.Tensor):
    return tuple(t.shape), t.dtype, t.device


def _flatten(tree, leaves: list):
    """Appends tree's tensors to leaves in order and returns its spec: the
    structure with ids, scales, shapes, dtypes and devices."""
    if isinstance(tree, mkckks.Ciphertext):
        leaves.append(tree.ct.data)
        return ("ckks", tree.ct.ids, tree.scale, _meta(tree.ct.data))
    if isinstance(tree, RCt):
        leaves.append(tree.data)
        return ("rlwe", tree.ids, _meta(tree.data))
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return ("tensor", _meta(tree))
    if isinstance(tree, (list, tuple)):
        return (type(tree), tuple(_flatten(t, leaves) for t in tree))
    raise TypeError(f"fuse takes ciphertexts, tensors and lists or tuples "
                    f"of them, not {type(tree).__name__}")


def _unflatten(spec, leaves):
    """The tree of spec with the tensors taken in order from the iterator
    leaves."""
    kind = spec[0]
    if kind == "ckks":
        return mkckks.Ciphertext(ct=RCt(ids=spec[1], data=next(leaves)),
                                 scale=spec[2])
    if kind == "rlwe":
        return RCt(ids=spec[1], data=next(leaves))
    if kind == "tensor":
        return next(leaves)
    return kind(_unflatten(s, leaves) for s in spec[1])


def _table_leaves(tables) -> list:
    return [t for name in sorted(tables) for v in tables[name].values()
            for t in (v if isinstance(v, tuple) else (v,))]


# ----------------------------------------------------------------------------
# The fused callable
# ----------------------------------------------------------------------------

class Fused:
    """fn of fuse(): fn(p_arg, tables, cts) runs the pipeline, one graph
    replay on the card. `graph` is the torch.cuda.CUDAGraph, `capture_s`
    the host seconds its capture took, `launches` the NTT kernel
    launches captured into it, per kernel (ntt_cuda.counters; a replay
    runs them again without the wrapper, so the counters do not see
    replays) and `replays` the graph replays run, fuse_chained's step
    graph's included; None, 0.0, {} and 0 on the CPU. fuse_chained's step
    graph adds to capture_s and launches. A call is the span fuse.call
    (copy-in, replay, clone-out) and its replays the span fuse.replay;
    spans open during a capture are not replayed."""

    def __init__(self, make_ev, pipeline, p_arg, tables, spec, leaves):
        self.make_ev, self.pipeline = make_ev, pipeline
        self.p_arg, self.tables, self.spec = p_arg, tables, spec
        self.device = p_arg.device
        self.cuda = self.device.type == "cuda"
        self.graph, self.capture_s, self.launches = None, 0.0, {}
        self.replays = 0
        if self.cuda:
            self.static_in = [t.clone() for t in leaves]
            # the recording pass was the warm-up
            self.graph, out = self._capture(
                lambda cts: self._run(cts, self.tables), warm=False)
            self.static_out = []
            self.out_spec = _flatten(out, self.static_out)

    # -- checks and copies --------------------------------------------------

    def _leaves(self, p_arg, tables, cts) -> list:
        """cts' tensors, after checking p_arg, tables and cts against the
        captured ones; on the card, other tables are copied into the
        static key tensors."""
        if p_arg is not self.p_arg:
            raise ValueError("other parameters than the captured ones: call "
                             "fuse again")
        leaves = []
        if _flatten(tuple(cts), leaves) != self.spec:
            raise ValueError("inputs differ from the captured ones in ids, "
                             "level, scale, shape or structure: call fuse "
                             "again (a graph is captured per shape)")
        if tables is not self.tables:
            want, got = _table_leaves(self.tables), _table_leaves(tables)
            if ({n: list(t) for n, t in tables.items()}
                    != {n: list(t) for n, t in self.tables.items()}
                    or [_meta(t) for t in got] != [_meta(t) for t in want]):
                raise ValueError("key tables differ from the captured ones "
                                 "in requests or shapes: call fuse again")
            if self.cuda:
                for s, t in zip(want, got):
                    if t is not s:
                        s.copy_(t)
        return leaves

    def _load(self, leaves) -> None:
        for s, t in zip(self.static_in, leaves):
            if t is not s:
                s.copy_(t)

    def _run(self, cts, tables):
        return self.pipeline(self.make_ev(self.p_arg), _replay_keys(tables),
                             *cts)

    def _outputs(self):
        return _unflatten(self.out_spec,
                          iter([t.clone() for t in self.static_out]))

    # -- capture ------------------------------------------------------------

    def _capture(self, body, warm: bool):
        """Capture body(static input tree), after one eager run of it on a
        side stream if warm; returns (graph, body's output)."""
        cts = _unflatten(self.spec, iter(self.static_in))
        with torch.cuda.device(self.device):
            if warm:
                _on_side_stream(self.device, lambda: body(cts))
            graph = torch.cuda.CUDAGraph()
            before = ntt_cuda.counters()
            start = time.perf_counter()
            with torch.cuda.graph(graph):
                out = body(cts)
            self.capture_s += time.perf_counter() - start
        after = ntt_cuda.counters()
        for k in after:
            self.launches[k] = self.launches.get(k, 0) + after[k] - before[k]
        return graph, out

    # -- calls --------------------------------------------------------------

    def __call__(self, p_arg, tables, cts):
        with span("fuse.call"):
            leaves = self._leaves(p_arg, tables, cts)
            if not self.cuda:
                return self._run(_unflatten(self.spec, iter(leaves)), tables)
            self._load(leaves)
            with span("fuse.replay"):
                self.graph.replay()
            self.replays += 1
            return self._outputs()

    def chained(self, chain):
        """run_k of fuse_chained (below)."""
        if not self.cuda:
            def run_k(p_arg, tables, cts, k):
                with span("fuse.call"):
                    c = _unflatten(self.spec,
                                   iter(self._leaves(p_arg, tables, cts)))
                    for _ in range(k):
                        c = _unflatten(self.spec, iter(self._chain_leaves(
                            self._chain_step(chain, c, tables))))
                    return self._run(c, tables)
            run_k.fused = self
            return run_k

        def step(cts):
            self._load(self._chain_leaves(
                self._chain_step(chain, cts, self.tables)))

        step_graph = self._capture(step, warm=True)[0]

        def run_k(p_arg, tables, cts, k):
            with span("fuse.call"):
                self._load(self._leaves(p_arg, tables, cts))
                with span("fuse.replay"):
                    for _ in range(k):
                        step_graph.replay()
                    self.graph.replay()
                self.replays += k + 1
                return self._outputs()

        run_k.fused = self
        return run_k

    def _chain_step(self, chain, cts, tables):
        return tuple(chain(tuple(cts), self._run(cts, tables)))

    def _chain_leaves(self, cts) -> list:
        leaves = []
        if _flatten(tuple(cts), leaves) != self.spec:
            raise ValueError("chain(cts, out) must return inputs of the "
                             "captured ids, level, scale and shapes")
        return leaves


def _on_side_stream(device, fn):
    """fn() on a new stream that waits for the current one, which then
    waits for it: the warm-up before a capture (torch.cuda.graph's
    documented pattern)."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        out = fn()
    torch.cuda.current_stream(device).wait_stream(side)
    return out


def fuse(params, pipeline, cts, rlk_set=None, rtk_set=None, cjk_set=None):
    """Capture `pipeline(ev, keys, *cts)` as one replayable call.

    - `params`: mkckks.Parameters or mkbfv.Parameters (scheme inferred);
      their device decides the route (CUDA: one graph; CPU: eager).
    - `pipeline(ev, keys, *cts) -> ciphertext tree`, written against the
      normal Evaluator API; `keys.rlk/.rtk/.cjk` stand in for the key
      sets.
    - `cts`: tuple of ciphertexts / trees of ciphertexts (plaintext
      tensors too): the graph's inputs.

    Returns `(fn, args)`; `fn(*args)` runs the pipeline. To run on new
    inputs, replace the trailing `args[2]` tuple (the first two entries
    are the parameters and the recorded key tables)."""
    is_bfv = isinstance(params, mkbfv.Parameters)
    p_arg = params if is_bfv else params.rlwe

    def make_ev(p):
        if is_bfv:
            return mkbfv.Evaluator(p)
        return mkckks.Evaluator(dataclasses.replace(params, rlwe=p))

    cts = tuple(cts)
    leaves = []
    spec = _flatten(cts, leaves)

    # recording pass: the eager warm-up, which also builds every lazily
    # made table (on a side stream on the card, as before a capture)
    rec = _keys_ns(_Record(rlk_set) if rlk_set is not None else None,
                   _RecordRot(rtk_set) if rtk_set is not None else None,
                   _Record(cjk_set) if cjk_set is not None else None)
    if p_arg.device.type == "cuda":
        _on_side_stream(p_arg.device, lambda: pipeline(
            make_ev(p_arg), rec, *_unflatten(spec, iter(leaves))))
    else:
        pipeline(make_ev(p_arg), rec, *_unflatten(spec, iter(leaves)))

    # the recorded stacks, copied: fuse owns its static key tensors
    tables = {name: {k: (tuple(t.clone() for t in v) if isinstance(v, tuple)
                         else v.clone()) for k, v in r.stacks.items()}
              for name, r in vars(rec).items() if r is not None}
    fn = Fused(make_ev, pipeline, p_arg, tables, spec, leaves)
    return fn, (p_arg, tables, cts)


def fuse_chained(params, pipeline, cts, chain, rlk_set=None, rtk_set=None,
                 cjk_set=None):
    """Like fuse(), but returns run_k(p_arg, tables, cts, k): the pipeline
    runs k+1 times, each run's inputs made from the previous one's by
    `chain(cts, out) -> cts` (a real data dependency), bit-identical to
    k+1 eager runs chained. On the card the pipeline plus the chain's
    write-back into the static inputs is a second captured graph, replayed
    k times before the pipeline's own graph: the (t(k2) - t(k1)) /
    (k2 - k1) slope then times one run on the device alone (bench.py's
    protocol). run_k.fused is fuse()'s fn, whose capture_s and launches
    include the step graph's."""
    fn, args = fuse(params, pipeline, cts, rlk_set=rlk_set,
                    rtk_set=rtk_set, cjk_set=cjk_set)
    return fn.chained(chain), args
