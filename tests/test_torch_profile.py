"""The mult profiler (mkhe_tpu_torch/profile_mult.py) at a small size on the
CPU: the same code that breaks down the PN15QP880 mult on the card runs
end to end, times every step, and counts no NTT kernel launch here."""

import math

import pytest
import torch

from mkhe_tpu_torch import mkckks, profile_mult

torch.set_num_threads(1)

RECIPE = dict(logn=10, logslots=9, q0_bits=28.9, level_bits=20.0, levels=4,
              scale=2.0 ** 40, p_bits=28.4)


@pytest.fixture(scope="module")
def ctx():
    params = mkckks.new_parameters(**RECIPE, device="cpu")
    return (params, *profile_mult.setup(params, 2, seed=7))


def test_profile_times_every_step(ctx):
    params, ev, ct0, ct1, rlk = ctx
    res = profile_mult.profile(params, ev, ct0, ct1, rlk, reps=1)
    assert res["ntt_fwd_launches"] == res["ntt_inv_launches"] == 0
    assert len(res["steps_ms"]) == 9
    times = [res["mult_ms"], res["mult_host_ms"], *res["steps_ms"].values()]
    assert all(math.isfinite(t) and t > 0 for t in times)


def test_trace_has_no_device_rows_on_cpu(ctx):
    params, ev, ct0, ct1, rlk = ctx
    tr = profile_mult.trace(lambda: ev.mul_relin_new(ct0, ct1, rlk), 1,
                            params.rlwe.device)
    assert tr["calls"] == 1 and tr["wall_ms_per_call"] > 0
    assert tr["kernels_per_call"] == 0 and tr["kernel_ms_per_call"] == 0
    assert tr["device_idle_share"] is None
    assert tr["top_ops"] == [] and tr["top_kernels"] == []
