"""The CNN profiler (mkhe_tpu_torch/profile_cnn.py) at the MINI layout on
the CPU: the same setup, inference and span counting that break the REF
inference down on the card run end to end here; the counts of every span
and of the key-switched rotations follow from the layout, and the logits
are within 5e-3 of plain_forward."""

import math

import numpy as np
import pytest
import torch

from mkhe_tpu_torch import mkckks, profile_cnn
from mkhe_tpu_torch.models import cnn
from mkhe_tpu_torch.utils import profiling

torch.set_num_threads(1)

LO = cnn.MINI


@pytest.fixture(scope="module")
def mini():
    params = mkckks.new_parameters(
        11, 10, q0_bits=28.9, level_bits=20.0, levels=7, scale=2.0 ** 40,
        p_bits=28.4, device="cpu")
    rng = np.random.default_rng(5)
    n_in = LO.num_kernels * LO.conv_out ** 2
    weights = (rng.uniform(-1, 1, (LO.num_kernels, LO.ksize, LO.ksize))
               / LO.ksize ** 2,
               rng.uniform(-1, 1, (n_in, LO.fc_units)) / n_in,
               rng.uniform(-1, 1, (LO.fc_units, LO.classes)) / LO.fc_units,
               rng.uniform(-0.5, 0.5, LO.fc_units),
               rng.uniform(-0.5, 0.5, LO.classes))
    s = profile_cnn.setup(params, LO, weights, seed=7)
    img = profile_cnn.image(LO, 8)
    return s, img, s.encrypt_image(img)


def _want_spans(lo):
    """Spans per inference of cnn._pipeline at layout lo, and the
    key-switched rotations."""
    n = lo.n_diag
    log_gap, log_units = lo.gap.bit_length() - 1, lo.fc_units.bit_length() - 1
    rotate_new = 2 + log_gap + 4 + log_units    # one key switch each
    # image, 4 kernels, n fc1 blocks; conv's 3 rotated images, conv, sq1,
    # fc1's n - 1 rotated vectors, f1; fc2's mul_relin_new, both operands
    # in one span
    hoistings = 1 + 4 + n + 3 + 1 + 1 + (n - 1) + 1 + 1
    mults, sums = 3, (4, n)     # sq1, sq2, fc2's mult; conv's, fc1's sums
    switches = rotate_new + 2   # and the two batched hoisted rotations
    return {
        "cnn.conv": 1, "cnn.fc1": 1, "cnn.fc2": 1,
        "ckks.mul_relin": mults + len(sums),
        "ckks.mul_ptxt": 1,
        "ckks.rescale": mults + len(sums) + 1,
        "ckks.rotate": switches,
        "ksw.decompose": hoistings + rotate_new + mults + len(sums),
        "ksw.aggregate": mults + sum(sums),
        "ksw.tensor": mults + sum(sums) + len(sums),
        "ksw.external_product": 2 * mults + sum(sums) + len(sums) + switches,
        "ksw.mod_down": 2 * mults + 2 * len(sums) + switches,
        "ksw.v_sum": mults + len(sums) + switches,
        "rotations": 2 + log_gap + 4 + log_units + 3 + (n - 1),
    }


def test_setup_draws_what_the_inference_needs(mini):
    s, _, _ = mini
    crs = s.params.rlwe.crs
    rots = set(LO.extra_rots) | {1 << i for i in range(s.params.logn - 1)}
    assert rots | {0, -1, -2} <= set(crs)
    assert set(s.rtk.value) == set(profile_cnn.USERS)
    assert all(set(by_rot) == rots for by_rot in s.rtk.value.values())
    assert set(s.cjk.value) == set(profile_cnn.USERS)
    assert s.keygen_s > 0 and s.model_s > 0
    assert len(s.model[0]) == 4 and len(s.model[1]) == LO.n_diag


def test_op_profile_counts_every_op(mini):
    """Every span of the inference, traced with the spans on, against the
    layout's count; the host ms of each (no device here) and the logits."""
    s, img, ct_img = mini
    with profile_cnn.op_profile(s.params.rlwe.device) as ops:
        out = profile_cnn.infer(s, ct_img)
    want = _want_spans(LO)
    assert ops.pop("rotations") == want.pop("rotations")
    assert {name: calls for name, (calls, _) in ops.items()} == want
    assert all(math.isfinite(ms) and ms > 0 for _, ms in ops.values())
    assert profiling.span("x") is profiling.span("y")   # off again
    assert out.ids == profile_cnn.USERS
    logits = s.logits(out)
    plain = cnn.plain_forward(img, *s.weights, LO)
    np.testing.assert_allclose(logits, plain, rtol=5e-3, atol=5e-3)
    assert int(np.argmax(logits)) == int(np.argmax(plain))


def test_count_rotations_alone_and_restores(mini):
    s, _, ct_img = mini
    rotate = profile_cnn.ksw.rotate
    with profile_cnn.count_rotations() as rot:
        profile_cnn.infer(s, ct_img)
    assert rot["rotations"] == _want_spans(LO)["rotations"]
    assert profile_cnn.ksw.rotate is rotate
    # the REF layout's count, which chip_smoke.py measures on the card
    assert _want_spans(cnn.REF)["rotations"] == 29
