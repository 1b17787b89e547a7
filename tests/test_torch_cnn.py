"""The port's encrypted CNN (mkhe_tpu_torch.models.cnn) against
mkhe_tpu.models.cnn:

  - the packing encoders, the mask and the weights are equal, at the MNIST
    layout REF and the reduced layout MINI;
  - the staged two-party pipeline (conv -> square -> fc1 -> square -> fc2,
    hoistings, batched rotations and lazy-relin inner products included)
    at MINI with tests/test_cnn.py:131-133's parameters gives the JAX
    package's output ciphertext bit for bit, from the JAX package's CRS,
    keys and ciphertexts carried across by convert.py, with the same
    scale and ids; each logit is within 5e-3 of plain_forward
    (tests/test_cnn.py:187)."""

import dataclasses

import numpy as np
import pytest
import torch

from mkhe_tpu import mkckks as jckks
from mkhe_tpu import mkrlwe as jrlwe
from mkhe_tpu.models import cnn as jcnn
from mkhe_tpu_torch import convert
from mkhe_tpu_torch import mkckks as tckks
from mkhe_tpu_torch.models import cnn as tcnn

torch.set_num_threads(1)

USERS = ("dataOwner", "modelOwner")


def _synthetic_model(layout, seed=5):
    """Random weights at the layout's shapes, scaled so every activation
    stays O(1) (tests/test_cnn.py:108-120)."""
    r = np.random.default_rng(seed)
    lo = layout
    kernels = r.uniform(-1, 1, (lo.num_kernels, lo.ksize, lo.ksize)) \
        / lo.ksize ** 2
    n_in = lo.num_kernels * lo.conv_out ** 2
    fc1 = r.uniform(-1, 1, (n_in, lo.fc_units)) / n_in
    fc2 = r.uniform(-1, 1, (lo.fc_units, lo.classes)) / lo.fc_units
    b1 = r.uniform(-0.5, 0.5, lo.fc_units)
    b2 = r.uniform(-0.5, 0.5, lo.classes)
    return kernels, fc1, fc2, b1, b2


def test_load_weights_match():
    for got, want in zip(tcnn.load_weights(), jcnn.load_weights()):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["REF", "MINI"])
def test_packing_matches(name):
    tlo, jlo = getattr(tcnn, name), getattr(jcnn, name)
    assert tlo.extra_rots == jlo.extra_rots
    assert dataclasses.asdict(tlo) == dataclasses.asdict(jlo)
    weights = (tcnn.load_weights() if name == "REF"
               else _synthetic_model(tlo))
    kernels, fc1, fc2, b1, b2 = weights
    img = np.random.default_rng(7).uniform(0, 1, (tlo.image, tlo.image))
    slots = tlo.slots
    pairs = [
        (tcnn.pack_image(img, slots, tlo), jcnn.pack_image(img, slots, jlo)),
        (tcnn.pack_fc2(fc2, slots, tlo), jcnn.pack_fc2(fc2, slots, jlo)),
        (tcnn.pack_b1(b1, slots, tlo), jcnn.pack_b1(b1, slots, jlo)),
        (tcnn.pack_b2(b2, slots, tlo), jcnn.pack_b2(b2, slots, jlo)),
        (tcnn.mask_vector(slots, tlo), jcnn.mask_vector(slots, jlo)),
        *zip(tcnn.pack_kernels(kernels, slots, tlo),
             jcnn.pack_kernels(kernels, slots, jlo)),
        *zip(tcnn.pack_fc1(fc1, slots, tlo), jcnn.pack_fc1(fc1, slots, jlo)),
    ]
    assert len(pairs) == 5 + 4 + tlo.n_diag
    for got, want in pairs:
        assert np.array_equal(got, want)
    np.testing.assert_array_equal(
        tcnn.plain_forward(img, *weights, tlo),
        jcnn.plain_forward(img, *weights, jlo))


@pytest.fixture(scope="module")
def mini():
    """The JAX package's MINI state (tests/test_cnn.py:130-177) and the
    port's copy of it."""
    lo = jcnn.MINI
    params = jckks.new_parameters(
        11, 10, q0_bits=28.9, level_bits=20.0, levels=7, scale=2.0 ** 40,
        p_bits=28.4)
    for rot in lo.extra_rots:
        params = params.add_crs(rot)
    rots = list(lo.extra_rots) + [1 << i for i in range(params.logn - 1)]
    kgen = jrlwe.KeyGenerator(params.rlwe, seed=43)
    sks, pks = jrlwe.SecretKeySet(), jrlwe.PublicKeySet()
    rlk, rtk = jrlwe.RelinearizationKeySet(), jrlwe.RotationKeySet()
    for uid in USERS:
        sk, pk = kgen.gen_key_pair(uid)
        sks.add(sk)
        pks.add(pk)
        rlk.add(kgen.gen_relinearization_key(sk, kgen.gen_secret_key(uid)))
        for rot in rots:
            rtk.add(kgen.gen_rotation_key(rot, sk))
    enc = jckks.Encryptor(params, seed=44)
    weights = _synthetic_model(lo)
    kernels, fc1, fc2, b1, b2 = weights
    img = np.random.default_rng(7).uniform(0, 1, (lo.image, lo.image))
    slots = params.slots

    def encrypt(v, uid="modelOwner"):
        return enc.encrypt_msg(jckks.Message(value=v), pks.get(uid))

    cts = dict(
        ct_img=encrypt(jcnn.pack_image(img, slots, lo), "dataOwner"),
        ct_k=[encrypt(v) for v in jcnn.pack_kernels(kernels, slots, lo)],
        ct_fc1=[encrypt(v) for v in jcnn.pack_fc1(fc1, slots, lo)],
        ct_fc2=encrypt(jcnn.pack_fc2(fc2, slots, lo)),
        ct_b1=encrypt(jcnn.pack_b1(b1, slots, lo)),
        ct_b2=encrypt(jcnn.pack_b2(b2, slots, lo)))
    pt_mask = enc.encode_msg(jckks.Message(value=jcnn.mask_vector(slots, lo)))

    rp = params.rlwe
    tp = convert.ckks_parameters(
        convert.rlwe_parameters(rp.logn, rp.q_moduli, rp.p_moduli, rp.gamma,
                                rp.sigma, {i: np.asarray(rp.crs[i])
                                           for i in [0, -1] + rots},
                                rp.crs_seed, "cpu"),
        params.logslots, params.scale)
    tcts = {k: ([_to_port(c) for c in v] if isinstance(v, list)
                else _to_port(v)) for k, v in cts.items()}
    tstate = dict(
        params=tp, cts=tcts, pt_mask=pt_mask,
        sks=convert.secret_key_set(
            {uid: np.asarray(k.data) for uid, k in sks.value.items()}, "cpu"),
        rlk=convert.relinearization_key_set(
            {uid: tuple(np.asarray(getattr(k, f)) for f in "bdv")
             for uid, k in rlk.value.items()}, "cpu"),
        rtk=convert.rotation_key_set(
            {(uid, r): np.asarray(k.data) for uid, by_rot in rtk.value.items()
             for r, k in by_rot.items()}, "cpu"))
    return dict(layout=lo, params=params, rlk=rlk, rtk=rtk, enc=enc,
                cts=cts, pt_mask=pt_mask, img=img, weights=weights,
                port=tstate)


def _to_port(ct):
    return convert.ckks_ciphertext(ct.ids, np.asarray(ct.ct.data), ct.scale,
                                   "cpu")


def test_mask_encoding_matches(mini):
    """The port's encode_msg gives the fc2 mask plaintext of the JAX
    package's."""
    tp = mini["port"]["params"]
    lo = tcnn.MINI
    got = tckks.Encryptor(tp).encode_msg(
        tckks.Message(value=tcnn.mask_vector(tp.slots, lo)))
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, np.asarray(mini["pt_mask"]))


@pytest.fixture(scope="module")
def staged(mini):
    """The staged MINI pipeline's output from both packages, on the same
    carried state."""
    lo, params, cts = mini["layout"], mini["params"], mini["cts"]
    want = jcnn._pipeline(jckks.Evaluator(params), mini["rlk"], mini["rtk"],
                          cts["ct_img"], cts["ct_k"], cts["ct_fc1"],
                          cts["ct_fc2"], cts["ct_b1"], cts["ct_b2"],
                          mini["pt_mask"], params.scale, lo)

    port = mini["port"]
    tp, tcts = port["params"], port["cts"]
    got = tcnn._pipeline(tckks.Evaluator(tp), port["rlk"], port["rtk"],
                         tcts["ct_img"], tcts["ct_k"], tcts["ct_fc1"],
                         tcts["ct_fc2"], tcts["ct_b1"], tcts["ct_b2"],
                         port["pt_mask"], tp.scale, tcnn.MINI)
    return dict(want=want, got=got)


def _check_logits(mini, ct):
    """Every logit within 5e-3 of the plaintext forward pass, same
    argmax."""
    lo, port = mini["layout"], mini["port"]
    out = tckks.Decryptor(port["params"]).decrypt(ct, port["sks"]).value
    logits = np.real(out[:lo.classes])
    plain = tcnn.plain_forward(mini["img"], *mini["weights"], tcnn.MINI)
    np.testing.assert_allclose(logits, plain, rtol=5e-3, atol=5e-3)
    assert int(np.argmax(logits)) == int(np.argmax(plain))


def test_mini_pipeline_bit_identical(mini, staged):
    """The staged pipeline on the same carried state: the same ciphertext,
    scale and ids as the JAX package's, and every logit within 5e-3 of the
    plaintext forward pass."""
    got, want = staged["got"], staged["want"]
    assert got.ids == want.ids == USERS
    assert got.scale == want.scale
    np.testing.assert_array_equal(convert.to_numpy(got.ct.data),
                                  np.asarray(want.ct.data))
    _check_logits(mini, got)


def test_mini_fused_inference_bit_identical(mini, staged):
    """build_fused_inference (CPU route) with the JAX package's arguments
    (mask_scale defaulting to params.scale, the image at args[2][0]): the
    staged pipeline's ciphertext bit for bit, the key requests of the
    JAX package's recorder, and every logit within 5e-3 of the plaintext
    forward pass."""
    port = mini["port"]
    tp, tcts = port["params"], port["cts"]
    fn, args = tcnn.build_fused_inference(
        tp, port["rlk"], port["rtk"], tcts["ct_img"], tcts["ct_k"],
        tcts["ct_fc1"], tcts["ct_fc2"], tcts["ct_b1"], tcts["ct_b2"],
        convert.tensor(port["pt_mask"], "cpu"), layout=tcnn.MINI)
    assert args[2][0] is tcts["ct_img"]
    cts = mini["cts"]
    _, jargs = jcnn.build_fused_inference(
        mini["params"], mini["rlk"], mini["rtk"], cts["ct_img"], cts["ct_k"],
        cts["ct_fc1"], cts["ct_fc2"], cts["ct_b1"], cts["ct_b2"],
        mini["pt_mask"], layout=jcnn.MINI)
    assert ({n: list(t) for n, t in args[1].items()}
            == {n: list(t) for n, t in jargs[1].items()})
    got = fn(*args)
    want = staged["want"]
    assert got.ids == want.ids == USERS and got.scale == want.scale
    np.testing.assert_array_equal(convert.to_numpy(got.ct.data),
                                  np.asarray(want.ct.data))
    assert torch.equal(got.ct.data, staged["got"].ct.data)
    _check_logits(mini, got)
