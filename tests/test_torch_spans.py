"""The program's spans (mkhe_tpu_torch/utils/profiling.py) on the CPU at
logN 10: off, an op enters no record_function; on, under torch.profiler,
mul_relin_new, mul_ptxt_new and the rotations, and the BFV mult, its
hoisted form and hoisted mult, open exactly the spans of their steps,
nested as the code nests them, and compute the same bits as with the
spans off. SpanTrace on synthetic event lists: device ops put
down through their correlation ids to the innermost span, idle gaps to
spans, to a request outside the program and to the harness, request
indices, coverage and the idle time inside top-level spans."""

import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mkhe_tpu_torch import fuse, mkckks, mkrlwe
from mkhe_tpu_torch.utils import profiling
from mkhe_tpu_torch.utils.profiling import Event, SpanTrace

torch.set_num_threads(1)

RECIPE = dict(logn=10, logslots=9, q0_bits=28.9, level_bits=20.0, levels=4,
              scale=2.0 ** 40, p_bits=28.4)
USERS = ("user0", "user1")

# (depth, name) of every span an op opens, in order
MULT = [(0, "ckks.mul_relin"), (1, "ksw.decompose"), (1, "ksw.aggregate"),
        (1, "ksw.tensor"),
        (1, "ksw.external_product"), (1, "ksw.mod_down"),
        (1, "ksw.decompose"), (1, "ksw.v_sum"), (1, "ksw.external_product"),
        (1, "ksw.mod_down"), (1, "ckks.rescale")]
SWITCH = [(1, "ksw.v_sum"), (1, "ksw.external_product"), (1, "ksw.mod_down")]
TREES = {
    "mul_relin": MULT,
    "mul_relin_hoisted": [MULT[0]] + MULT[2:],
    "mul_ptxt": [(0, "ckks.mul_ptxt"), (1, "ckks.rescale")],
    "rotate": [(0, "ckks.rotate"), (1, "ksw.decompose")] + SWITCH,
    "rotate_hoisted": [(0, "ckks.rotate")] + SWITCH,
}
# the BFV mult (mkbfv): the double-basis conversions, the tensor over R
# and its quantize, and the key switch's steps as the CKKS mult has them
BFV_MULT = [(0, "bfv.mul_relin"), (1, "bfv.lift"), (1, "bfv.rescale_qr"),
            (1, "ksw.decompose"), (1, "ksw.aggregate"), (1, "bfv.tensor"),
            (1, "bfv.quantize"), (1, "ksw.external_product"),
            (1, "ksw.mod_down"), (1, "ksw.decompose"), (1, "ksw.v_sum"),
            (1, "ksw.external_product"), (1, "ksw.mod_down")]
BFV_TREES = {
    "mul_relin": BFV_MULT,
    "mul_relin_hoisted": [BFV_MULT[0]] + BFV_MULT[4:],
    "hoisted_form": [(0, "ksw.decompose"), (1, "bfv.lift"),
                     (1, "bfv.rescale_qr")],
}


@pytest.fixture(scope="module")
def ctx():
    params = mkckks.new_parameters(**RECIPE, device="cpu")
    kgen = mkrlwe.KeyGenerator(params.rlwe, seed=7)
    rlk, rtk, pks = mkrlwe.RelinearizationKeySet(), mkrlwe.RotationKeySet(), {}
    for uid in USERS:
        sk, pks[uid] = kgen.gen_key_pair(uid)
        rlk.add(kgen.gen_relinearization_key(sk, kgen.gen_secret_key(uid)))
        rtk.add(kgen.gen_rotation_key(1, sk))
    enc = mkckks.Encryptor(params, seed=8)
    rng = np.random.default_rng(9)

    def msg():
        return mkckks.Message(value=rng.uniform(-0.5, 0.5, params.slots)
                              + 0j)

    ct0, ct1 = (enc.encrypt_msg(msg(), pks[uid]) for uid in USERS)
    ev = mkckks.Evaluator(params)
    both = ev.add_new(ct0, ct1)
    pt = torch.from_numpy(enc.encode_msg(msg()).astype(np.int64))
    h0, h1, hb = (ev.hoisted_form(c) for c in (ct0, ct1, both))
    ops = {
        "mul_relin": lambda: ev.mul_relin_new(ct0, ct1, rlk),
        "mul_relin_hoisted": lambda: ev.mul_relin_hoisted_new(
            ct0, ct1, h0, h1, rlk),
        "mul_ptxt": lambda: ev.mul_ptxt_new(both, pt, params.scale),
        "rotate": lambda: ev.rotate_new(both, 1, rtk),
        "rotate_hoisted": lambda: ev.rotate_hoisted_new(both, 1, hb, rtk),
    }
    return types.SimpleNamespace(params=params, ev=ev, rlk=rlk, ops=ops)


@pytest.fixture(scope="module")
def bfv_ops():
    """BFV at logN 10 (6 + 6 limbs, P of 4, alpha 2), two parties."""
    from mkhe_tpu_torch import mkbfv
    from mkhe_tpu_torch.ops.primes import ntt_primes
    params = mkbfv.new_parameters(10, ntt_primes(10, 26.5, 6),
                                  ntt_primes(10, 26.5, 6, skip=6),
                                  ntt_primes(10, 28.4, 4), device="cpu")
    kgen = mkbfv.KeyGenerator(params, seed=7)
    rlk, pks = mkbfv.RelinearizationKeySet(), {}
    for uid in USERS:
        sk, pks[uid] = kgen.gen_key_pair(uid)
        rlk.add(kgen.gen_relinearization_key_bfv(sk, kgen.gen_secret_key(uid)))
    enc = mkbfv.Encryptor(params, seed=8)
    rng = np.random.default_rng(9)
    ct0, ct1 = (enc.encrypt_msg(rng.integers(0, params.t, params.n), pks[u])
                for u in USERS)
    ev = mkbfv.Evaluator(params)
    h0, h1 = ev.hoisted_form(ct0), ev.hoisted_form(ct1)
    return {"mul_relin": lambda: ev.mul_relin_new(ct0, ct1, rlk),
            "mul_relin_hoisted": lambda: ev.mul_relin_hoisted_new(h0, h1,
                                                                  rlk),
            "hoisted_form": lambda: ev.hoisted_form(ct0)}


def _traced(fn):
    """fn() under a CPU torch.profiler with the spans on; (output,
    SpanTrace)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.spans_on():
            out = fn()
    return out, SpanTrace(profiling.kineto_events(prof))


def _tree(st):
    def depth(i):
        p = st.spans[i].parent
        return 0 if p is None else 1 + depth(p)
    return [(depth(i), s.name) for i, s in enumerate(st.spans)]


@pytest.mark.parametrize("op", sorted(TREES))
def test_spans_off_enter_no_record_function(ctx, op, monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counted(name, *args, **kwargs):
        entered.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    ctx.ops[op]()
    assert entered == []
    with profiling.spans_on():
        ctx.ops[op]()
    assert entered == [name for _, name in TREES[op]]
    assert profiling.span("x") is profiling.span("y")   # off again


@pytest.mark.parametrize("op", sorted(TREES))
def test_spans_name_nest_and_count_each_op(ctx, op):
    _, st = _traced(ctx.ops[op])
    assert _tree(st) == TREES[op]
    assert st.requests == 0 and st.device_us == 0.0
    top = st.top_level()
    assert len(top) == 1 and top[0].name == TREES[op][0][1]


@pytest.mark.parametrize("op", sorted(TREES))
def test_outputs_bit_identical_with_spans_on(ctx, op):
    off = ctx.ops[op]()
    on, _ = _traced(ctx.ops[op])
    assert on.ids == off.ids and on.scale == off.scale
    assert torch.equal(on.ct.data, off.ct.data)


@pytest.mark.parametrize("op", sorted(BFV_TREES))
def test_bfv_spans_name_and_nest_each_op(bfv_ops, op, monkeypatch):
    """Off, a BFV op enters no record_function; on, it opens exactly the
    spans of its steps, nested as the code nests them, no name inside
    itself."""
    entered = []
    real = torch.profiler.record_function

    def counted(name, *args, **kwargs):
        entered.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    bfv_ops[op]()
    assert entered == []
    monkeypatch.setattr(torch.profiler, "record_function", real)
    _, st = _traced(bfv_ops[op])
    assert _tree(st) == BFV_TREES[op]
    for s in st.spans:
        p = s.parent
        while p is not None:
            assert st.spans[p].name != s.name
            p = st.spans[p].parent


@pytest.mark.parametrize("op", sorted(BFV_TREES))
def test_bfv_outputs_bit_identical_with_spans_on(bfv_ops, op):
    off = bfv_ops[op]()
    on, _ = _traced(bfv_ops[op])
    fields = ("lift", "resc", "dec_lift", "dec_resc") \
        if op == "hoisted_form" else ("data",)
    assert on.ids == off.ids
    for f in fields:
        assert torch.equal(getattr(on, f), getattr(off, f))


def test_mul_relin_opens_once(ctx):
    """mul_relin_new hoists both operands and runs the hoisted mult inside
    its own span; a sum of products is one mult span too."""
    _, st = _traced(ctx.ops["mul_relin"])
    assert [s.name for s in st.spans].count("ckks.mul_relin") == 1
    ct = ctx.ops["mul_relin"]()
    _, st = _traced(lambda: ctx.ev.mul_relin_sum_new([(ct, ct), (ct, ct)],
                                                     ctx.rlk))
    assert [s.name for s in st.top_level()] == ["ckks.mul_relin"]
    rows = st.by_name()
    assert rows["ckks.mul_relin"]["calls"] == 1
    assert rows["ksw.aggregate"]["calls"] == 2


def test_fused_call_span_and_replays_on_cpu(ctx):
    """On the CPU fn runs the pipeline eagerly inside fuse.call, with no
    graph to replay: Fused.replays stays 0."""
    ev = ctx.ev
    a = ctx.ops["mul_ptxt"]()
    fn, args = fuse.fuse(ctx.params, lambda e, keys, x: e.add_new(x, x), (a,))
    out, st = _traced(lambda: fn(*args))
    assert torch.equal(out.ct.data, ev.add_new(a, a).ct.data)
    assert [s.name for s in st.spans] == ["fuse.call"]
    assert fn.replays == 0


# -- SpanTrace on synthetic events (us) ---------------------------------------

def _ev(name, kind, start, end, corr=0, thread=1):
    return Event(name, kind, float(start), float(end), thread, corr)


def _two_requests():
    """Two requests on thread 1. The first: op > step, the step launching
    kernels k1 (corr 11) and k2 (12), op itself k3 (13), and a copy (14)
    launched in the request outside any span; the second: op launching
    k4 (15). A span of another thread and a device op whose runtime call
    is not in the trace (corr 99)."""
    return [
        _ev("req", "span", 0, 100), _ev("op", "span", 10, 60),
        _ev("step", "span", 20, 40), _ev("req", "span", 120, 200),
        _ev("op", "span", 130, 190), _ev("other", "span", 0, 500, thread=2),
        _ev("cudaLaunchKernel", "runtime", 22, 23, 11),
        _ev("cudaLaunchKernel", "runtime", 30, 31, 12),
        _ev("cudaLaunchKernel", "runtime", 50, 51, 13),
        _ev("cudaMemcpyAsync", "runtime", 70, 71, 14),
        _ev("cudaGraphLaunch", "runtime", 140, 141, 15),
        _ev("aten::add", "host", 49, 52),
        _ev("k1", "device", 25, 35, 11), _ev("k2", "device", 35, 45, 12),
        _ev("k3", "device", 55, 65, 13), _ev("Memcpy HtoD", "device", 80, 84,
                                            14),
        _ev("k4", "device", 150, 170, 15), _ev("k5", "device", 300, 310, 99),
    ]


def test_span_trace_nesting_and_requests():
    st = SpanTrace(_two_requests(), request="req")
    assert [(s.name, s.parent, s.request) for s in st.spans] == [
        ("req", None, 0), ("op", 0, 0), ("step", 1, 0), ("req", None, 1),
        ("op", 3, 1)]
    assert st.requests == 2
    assert [s.name for s in st.top_level()] == ["op", "op"]
    assert st.innermost(25) == 2 and st.innermost(55) == 1
    assert st.innermost(65) == 0 and st.innermost(110) is None


def test_span_trace_puts_device_time_down_by_correlation():
    st = SpanTrace(_two_requests(), request="req")
    rows = st.by_name()
    assert rows["step"] == dict(calls=1, host_us=20.0, device_us=20.0,
                                self_us=20.0)
    assert rows["op"] == dict(calls=2, host_us=110.0, device_us=50.0,
                              self_us=30.0)
    assert rows["req"]["device_us"] == 54.0 and rows["req"]["self_us"] == 4.0
    assert "other" not in rows                     # another thread
    assert st.device_us == 64.0 and st.unresolved_us == 10.0
    assert st.covered_us() == 50.0


def test_span_trace_idle_gaps_by_span():
    """The device idles from 45 (op open on the host), 65 and 84 (the
    first request open, no program span) and 170 (the second op open)."""
    st = SpanTrace(_two_requests(), request="req")
    assert st.gaps == [(45.0, 10.0), (65.0, 15.0), (84.0, 66.0),
                       (170.0, 130.0)]
    assert st.busy_us == 64.0 and st.window_us == 285.0
    assert st.idle_by_span() == {"op": 140.0,
                                 profiling.OUTSIDE_PROGRAM: 81.0}
    assert st.label(110) == profiling.OUTSIDE
    # op is open over 45-55, 130-150 and 170-190 of the gaps
    assert st.idle_in_top_us() == 50.0


def test_span_trace_without_spans():
    """No span at all (a profile taken with the spans off): every device
    op is outside, nothing is covered, and no request is counted."""
    events = [e for e in _two_requests() if e.kind != "span"]
    st = SpanTrace(events, request="req")
    assert st.spans == [] and st.requests == 0 and st.top_level() == []
    assert st.covered_us() == 0.0 and st.idle_in_top_us() == 0.0
    assert set(st.idle_by_span()) == {profiling.OUTSIDE}
    assert st.by_name() == {}
