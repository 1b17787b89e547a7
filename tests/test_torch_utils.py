"""The port's utils (mkhe_tpu_torch.utils) and examples against mkhe_tpu's,
on the CPU:

  - serialization: files written by mkhe_tpu.utils.serialize load in the
    port and files written by the port load in mkhe_tpu, bit for bit, for
    secret, relinearization and rotation keys and a CKKS ciphertext with
    its scale; the port writes the JAX package's dtypes (uint32 limbs); a
    relin key of the old format (no fmt stamp) is refused by both; keys
    and a ciphertext loaded back give the same mult and decryption;
  - the u64 oracle gate at tests/test_ref_oracle.py's toy config (logN 12,
    the same parameters and bound, |err64 - err32| <= 6), and the port's
    copy of ref_oracle.cpp byte for byte the JAX package's;
  - both examples' main(device="cpu")."""

import math
import shutil

import numpy as np
import pytest
import torch


from mkhe_tpu import mkckks as jckks
from mkhe_tpu import mkrlwe as jrlwe
from mkhe_tpu.utils import serialize as jser
from mkhe_tpu_torch import convert
from mkhe_tpu_torch import mkckks as tckks
from mkhe_tpu_torch import mkrlwe as trlwe
from mkhe_tpu_torch.utils import oracle
from mkhe_tpu_torch.utils import serialize as tser

torch.set_num_threads(1)

# tests/test_serialize.py's recipe
RECIPE = dict(logn=8, logslots=7, q0_bits=28.9, level_bits=20.0, levels=2,
              scale=2.0 ** 40, p_bits=28.4)


def _same(got, want):
    """A port tensor equals a JAX array (or another tensor) bit for bit."""
    w = (convert.to_numpy(want) if isinstance(want, torch.Tensor)
         else np.asarray(want))
    np.testing.assert_array_equal(convert.to_numpy(got), w)


@pytest.fixture(scope="module")
def jax_state():
    params = jckks.new_parameters(**RECIPE)
    kgen = jrlwe.KeyGenerator(params.rlwe, seed=61)
    sk, pk = kgen.gen_key_pair("alice")
    rlk = kgen.gen_relinearization_key(sk, kgen.gen_secret_key("alice"))
    rtk = kgen.gen_rotation_key(1, sk)
    msg = jckks.Message(value=np.ones(params.slots, np.complex128))
    ct = jckks.Encryptor(params, seed=62).encrypt_msg(msg, pk)
    return dict(params=params, sk=sk, rlk=rlk, rtk=rtk, ct=ct)


def test_jax_files_load_in_the_port(jax_state, tmp_path):
    s = jax_state
    jser.save_secret_key(str(tmp_path / "sk.npz"), s["sk"])
    jser.save_relin_key(str(tmp_path / "rlk.npz"), s["rlk"])
    jser.save_rotation_key(str(tmp_path / "rtk.npz"), s["rtk"])
    jser.save_ciphertext(str(tmp_path / "ct.npz"), s["ct"].ct,
                         scale=s["ct"].scale)
    sk = tser.load_secret_key(str(tmp_path / "sk.npz"), device="cpu")
    assert sk.id == "alice" and sk.data.dtype == torch.int64
    _same(sk.data, s["sk"].data)
    rlk = tser.load_relin_key(str(tmp_path / "rlk.npz"), device="cpu")
    assert rlk.id == "alice"
    for f in "bdv":
        _same(getattr(rlk, f), getattr(s["rlk"], f))
    rtk = tser.load_rotation_key(str(tmp_path / "rtk.npz"), device="cpu")
    assert (rtk.id, rtk.rot_idx) == ("alice", 1)
    _same(rtk.data, s["rtk"].data)
    ct, scale = tser.load_ciphertext(str(tmp_path / "ct.npz"), device="cpu")
    assert ct.ids == s["ct"].ids and scale == s["ct"].scale
    _same(ct.data, s["ct"].ct.data)
    # the loaded key decrypts the loaded ciphertext
    rp = s["params"].rlwe
    tp = convert.ckks_parameters(
        convert.rlwe_parameters(rp.logn, rp.q_moduli, rp.p_moduli, rp.gamma,
                                rp.sigma, {0: np.asarray(rp.crs[0])},
                                rp.crs_seed, "cpu"),
        s["params"].logslots, s["params"].scale)
    sks = trlwe.SecretKeySet()
    sks.add(sk)
    out = tckks.Decryptor(tp).decrypt(tckks.Ciphertext(ct=ct, scale=scale),
                                      sks)
    assert np.max(np.abs(out.value - 1.0)) < 1e-6   # test_serialize's bound


def test_port_files_load_in_jax_and_back(tmp_path):
    """The port's own keys and a product ciphertext: written with uint32
    limbs, read by the JAX package bit for bit, read back by the port bit
    for bit; a mult with the loaded relin keys equals one with the
    originals."""
    params = tckks.new_parameters(**RECIPE, device="cpu")
    kgen = trlwe.KeyGenerator(params.rlwe, seed=63)
    sks, rlk, pks = trlwe.SecretKeySet(), trlwe.RelinearizationKeySet(), {}
    for uid in ("a", "b"):
        sk, pks[uid] = kgen.gen_key_pair(uid)
        sks.add(sk)
        rlk.add(kgen.gen_relinearization_key(sk, kgen.gen_secret_key(uid)))
    rtk = kgen.gen_rotation_key(2, sks.get("b"))
    enc, ev = tckks.Encryptor(params, seed=64), tckks.Evaluator(params)
    rng = np.random.default_rng(65)
    cts = [enc.encrypt_msg(tckks.Message(value=rng.uniform(
        0.1, 0.5, params.slots)), pks[u]) for u in ("a", "b")]
    prod = ev.mul_relin_new(*cts, rlk)

    paths = {k: str(tmp_path / f"{k}.npz") for k in ("sk", "rtk", "ct")}
    tser.save_secret_key(paths["sk"], sks.get("a"))
    tser.save_rotation_key(paths["rtk"], rtk)
    tser.save_ciphertext(paths["ct"], prod.ct, scale=prod.scale)
    for uid in ("a", "b"):
        tser.save_relin_key(str(tmp_path / f"rlk_{uid}.npz"), rlk.get(uid))
    for path in (*paths.values(), str(tmp_path / "rlk_a.npz")):
        with np.load(path) as z:
            for name in ("data", "b", "d", "v"):
                if name in z:
                    assert z[name].dtype == np.uint32, (path, name)

    jsk = jser.load_secret_key(paths["sk"])
    assert jsk.id == "a"
    _same(sks.get("a").data, jsk.data)
    jrtk = jser.load_rotation_key(paths["rtk"])
    assert (jrtk.id, jrtk.rot_idx) == ("b", 2)
    _same(rtk.data, jrtk.data)
    jct, jscale = jser.load_ciphertext(paths["ct"])
    assert jct.ids == prod.ids and jscale == prod.scale
    _same(prod.ct.data, jct.data)

    loaded = trlwe.RelinearizationKeySet()
    for uid in ("a", "b"):
        path = str(tmp_path / f"rlk_{uid}.npz")
        jk = jser.load_relin_key(path)
        tk = tser.load_relin_key(path, device="cpu")
        for f in "bdv":
            _same(getattr(rlk.get(uid), f), getattr(jk, f))
            assert torch.equal(getattr(tk, f), getattr(rlk.get(uid), f))
        loaded.add(tk)
    assert torch.equal(ev.mul_relin_new(*cts, loaded).ct.data, prod.ct.data)
    ct, scale = tser.load_ciphertext(paths["ct"], device="cpu")
    assert ct.ids == prod.ids and scale == prod.scale
    assert torch.equal(ct.data, prod.ct.data)


def test_old_relin_format_refused(jax_state, tmp_path):
    """A relin-key file without the fmt stamp (format 1) is refused by
    both packages, and the port refuses another stamped format too."""
    k = jax_state["rlk"]
    old = str(tmp_path / "old.npz")
    np.savez_compressed(old, id=np.array(k.id), b=np.asarray(k.b),
                        d=np.asarray(k.d), v=np.asarray(k.v))
    for load in (jser.load_relin_key,
                 lambda p: tser.load_relin_key(p, device="cpu")):
        with pytest.raises(ValueError, match="format 1, expected 2"):
            load(old)
    three = str(tmp_path / "three.npz")
    np.savez_compressed(three, id=np.array(k.id), b=np.asarray(k.b),
                        d=np.asarray(k.d), v=np.asarray(k.v),
                        fmt=np.int64(3))
    with pytest.raises(ValueError, match="format 3"):
        tser.load_relin_key(three, device="cpu")


# ----------------------------------------------------------------------------
# The u64 oracle
# ----------------------------------------------------------------------------

def test_oracle_source_is_the_jax_packages():
    from pathlib import Path
    jax_src = Path(__file__).resolve().parents[1] / "mkhe_tpu" / "native" \
        / "ref_oracle.cpp"
    assert oracle.SRC.read_bytes() == jax_src.read_bytes()


@pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")
def test_u64_oracle_cross_validation():
    """tests/test_ref_oracle.py's gate on the port: logN 12, 8 x ~25b Q
    limbs (the u64 toy's 4 x ~50b), alpha 2; both errors within
    -log2(scale) + logslots + 12 and within 6 bits of each other."""
    logn, logslots, scale = 12, 11, 2.0 ** 40
    params = tckks.new_parameters(
        logn, logslots, q0_bits=25.0, level_bits=25.0, levels=3,
        scale=scale, gamma=2, p_bits=25.4, p_count=4, device="cpu")
    assert oracle.oracle_binary() == str(oracle.EXE)
    err64, err32, want = oracle.cross_validate("toy", params)
    assert want.shape == (params.slots,)
    bound = -math.log2(scale) + logslots + 12
    assert err64 <= bound, f"u64 oracle err {err64:.1f} > {bound:.1f}"
    assert err32 <= bound, f"port err {err32:.1f} > {bound:.1f}"
    assert abs(err64 - err32) <= 6.0, (err64, err32)


def test_oracle_decode_helpers_match_jax():
    """center_coeffs_u64 (its 2-limb path and its full-CRT fallback) and
    decode_slots against the JAX package's."""
    from mkhe_tpu.utils import oracle as joracle
    rng = np.random.default_rng(66)
    moduli = ((1 << 61) - 1, (1 << 31) - 1, (1 << 19) - 1)   # primes
    for hi in (1 << 80, 1 << 100):   # q0 q1 / 2 ~ 2^91, Q / 2 ~ 2^110
        vals = [int(rng.integers(-(1 << 62), 1 << 62)) * (hi >> 62)
                for _ in range(32)]
        res = np.array([[v % q for v in vals] for q in moduli], np.uint64)
        got = oracle.center_coeffs_u64(res, moduli)
        np.testing.assert_array_equal(got, joracle.center_coeffs_u64(res,
                                                                     moduli))
    coeffs = rng.normal(0, 2.0 ** 40, 1 << 10)
    for logslots in (9, 7):
        np.testing.assert_array_equal(
            oracle.decode_slots(coeffs, 2.0 ** 40, 10, logslots),
            joracle.decode_slots(coeffs, 2.0 ** 40, 10, logslots))


# ----------------------------------------------------------------------------
# The examples
# ----------------------------------------------------------------------------

def test_examples_run_on_the_cpu(capsys):
    from mkhe_tpu_torch.examples import two_party_bfv, two_party_ckks
    assert two_party_ckks.main(device="cpu") < 1e-6
    two_party_bfv.main(device="cpu")
    out = capsys.readouterr().out
    assert "two-party encrypted computation verified" in out
    assert "sum, product and rotation EXACT" in out
