"""The CUDA NTT kernels (mkhe_tpu_torch/csrc/ntt.cu, the split NTT's
kernels in csrc/ntt_split.cu in their five modes, and the NTT cost probe's
variant in csrc/ntt_variant.cu) and the key-switching kernels
(csrc/keyswitch.cu: mod_up with its digit axis, mod_down, mul_accum,
the rescale, the tensor terms) against their plain PyTorch versions on the
card, bit for bit;
the fused decomposition (csrc/ntt.cu::decompose_ntt_kernel) against the
composition it replaces, bit for bit; rotation, conjugation and the CNN
pipeline on the card against the same calls on the CPU; and threefry's
bits, every sampler and the PN14QP433_CNN CRS drawn on the card against
the CPU's. Needs an
NVIDIA GPU and nvcc; without a card every test skips. This file imports
no JAX, so it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py -q -o addopts="" --noconftest
"""

import dataclasses

import pytest
import torch

from mkhe_tpu_torch import ntt_probe
from mkhe_tpu_torch.ops import ntt_cuda
from mkhe_tpu_torch.ops.primes import ntt_primes
from mkhe_tpu_torch.ops.ring import Ring

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    return g


def _ring(logn, limbs=3):
    mods = ntt_primes(logn, 28.9, 1) + ntt_primes(logn, 27.0, limbs - 1)
    return Ring.create(mods, logn, "cuda")


def _rand(gen, shape, bound):
    return torch.randint(0, 1 << 62, shape, generator=gen,
                         dtype=torch.int64, device="cuda") % bound


def _full_args(ring):
    """(kernel, plain) argument tuples of the forward and inverse."""
    fwd_p = (ring.q, ring.bar, ring.psi, ring.psi_sh)
    inv_p = (ring.q, ring.bar, ring.ipsi, ring.ipsi_sh, ring.ninv,
             ring.ninv_sh)
    return (fwd_p + (ring.psi_pack,), fwd_p, inv_p + (ring.ipsi_pack,),
            inv_p)


@pytest.mark.parametrize("logn", range(1, 16))
def test_kernels_match_plain(gen, logn):
    """Any-u32 forward and < 8q inverse inputs, with n_polys = 6 (not a
    multiple of the polynomials per block below logN 12) and 1, and one
    limb."""
    ring = _ring(logn)
    fwd, fwd_p, inv, inv_p = _full_args(ring)
    q = ring.q[:, None]
    for shape in ((2, 3, ring.nlimbs, ring.n), (1, ring.nlimbs, ring.n)):
        for x in (_rand(gen, shape, q), _rand(gen, shape, 1 << 32)):
            assert torch.equal(ntt_cuda.ntt(x, *fwd), ntt_cuda.ntt_plain(x, *fwd_p))
        x = _rand(gen, shape, 8 * q)
        assert torch.equal(ntt_cuda.intt(x, *inv), ntt_cuda.intt_plain(x, *inv_p))
        x = _rand(gen, shape, q)
        assert torch.equal(ring.intt(ring.ntt(x)), x)
    one = ring.take(1, 2)
    fwd, fwd_p, inv, inv_p = _full_args(one)
    x = _rand(gen, (5, 1, ring.n), 1 << 32)
    assert torch.equal(ntt_cuda.ntt(x, *fwd), ntt_cuda.ntt_plain(x, *fwd_p))
    assert torch.equal(ntt_cuda.intt(x, *inv), ntt_cuda.intt_plain(x, *inv_p))
    torch.cuda.synchronize()


@pytest.mark.parametrize("logn", [10, 14, 15])
def test_kernels_extreme_inputs(gen, logn):
    """All q - 1, all 2^32 - 1 and all 8q - 1: the lazy ranges at their
    ends."""
    ring = _ring(logn)
    fwd, fwd_p, inv, inv_p = _full_args(ring)
    q = ring.q[:, None]
    shape = (3, ring.nlimbs, ring.n)
    for fill in (q - 1, torch.full_like(q, (1 << 32) - 1), 8 * q - 1):
        x = fill.expand(shape).contiguous()
        assert torch.equal(ntt_cuda.ntt(x, *fwd), ntt_cuda.ntt_plain(x, *fwd_p))
        assert torch.equal(ntt_cuda.intt(x, *inv), ntt_cuda.intt_plain(x, *inv_p))
    torch.cuda.synchronize()


def test_launch_counters(gen):
    ring = _ring(10)
    x = _rand(gen, (ring.nlimbs, ring.n), ring.q[:, None])
    ntt_cuda.reset_counters()
    ring.intt(ring.ntt(ring.ntt(x)))
    ntt_cuda.ntt_plain(x, ring.q, ring.bar, ring.psi, ring.psi_sh)
    assert (ntt_cuda.fwd_launches, ntt_cuda.inv_launches) == (2, 1)


def test_wrapper_raises_on_cuda(gen):
    ring = _ring(10)
    x = _rand(gen, (ring.nlimbs, ring.n), ring.q[:, None])
    fwd = _full_args(ring)[0][1:]
    with pytest.raises(TypeError):
        ntt_cuda.ntt(x.to(torch.int32), ring.q, *fwd)
    with pytest.raises(ValueError):
        ntt_cuda.ntt(x.t(), ring.q, *fwd)
    with pytest.raises(ValueError):
        ntt_cuda.ntt(x, ring.q.cpu(), *fwd)
    with pytest.raises(ValueError, match="16-byte"):
        flat = torch.zeros(ring.psi_pack.numel() + 1, dtype=torch.int64,
                           device="cuda")
        skewed = flat[1:].view(ring.psi_pack.shape)
        skewed.copy_(ring.psi_pack)
        ntt_cuda.ntt(x, ring.q, *fwd[:-1], skewed)
    big = _ring(16, limbs=1)
    with pytest.raises(ValueError):
        big.ntt(torch.zeros((1, big.n), dtype=torch.int64, device="cuda"))


def _split_args(ring):
    t = ring.split_tables()
    head = (ring.q, t.twist, t.twist_sh, t.wpack, t.wpack_sh, t.twist_pack,
            t.wpack_pack)
    inv = (ring.q, ring.bar, t.iwpack, t.iwpack_sh, t.untwist, t.untwist_sh)
    return t, head, inv, inv + (t.iwpack_pack, t.untwist_pack)


@pytest.mark.parametrize("logn", range(8, 16))
def test_split_kernels_match_plain(gen, logn):
    """The split kernel's fused forward, head and tail (both maps) and the
    tailed inverse against their plain versions; the fused forward and
    head + tail against ntt_fwd_kernel, tail + tailed inverse against
    ntt_inv_kernel, the round trip; canonical, any-u32 (with 2^32 - 1
    extremes) and < 8q inputs, 6 polynomials a limb."""
    ring = _ring(logn)
    t, head, inv, inv_k = _split_args(ring)
    q = ring.q[:, None]
    shape = (2, 3, ring.nlimbs, ring.n)
    fwd_t, _, inv_t, _ = _full_args(ring)
    x = _rand(gen, shape, 1 << 32)
    x[0, 0, :, :300] = (1 << 32) - 1
    split = (ring.q, ring.r_inv, t)
    for inp in (x, _rand(gen, shape, q)):
        fused = ntt_cuda.ntt_split_fwd(inp, *split)
        assert torch.equal(fused, ntt_cuda.ntt_split_fwd_plain(inp, *split))
        assert torch.equal(fused, ntt_cuda.ntt(inp, *fwd_t))
    h = ntt_cuda.ntt_head(x, *head)
    assert torch.equal(h, ntt_cuda.ntt_head_plain(x, *head[:5]))
    y = _rand(gen, shape, 8 * q)
    for mat, frag in ((t.tail_fwd, t.tail_fwd_frag),
                      (t.tail_inv, t.tail_inv_frag)):
        args = (ring.q, ring.r_inv, mat, t.tail_pow)
        for inp in (x, y):
            assert torch.equal(ntt_cuda.tail(inp, *args, frag, t.tail_pow8),
                               ntt_cuda.tail_plain(inp, *args))
    fwd = ntt_cuda.tail(h, ring.q, ring.r_inv, t.tail_fwd, t.tail_pow,
                        t.tail_fwd_frag, t.tail_pow8)
    assert torch.equal(fwd, ntt_cuda.ntt(x, *fwd_t))
    tailed = ntt_cuda.tail(y, ring.q, ring.r_inv, t.tail_inv, t.tail_pow,
                           t.tail_inv_frag, t.tail_pow8)
    got = ntt_cuda.intt_tailed(tailed, *inv_k)
    assert torch.equal(got, ntt_cuda.intt_tailed_plain(tailed, *inv))
    assert torch.equal(got, ntt_cuda.intt(y, *inv_t))
    from mkhe_tpu_torch import config
    config.ntt_mxu_tail = True
    try:
        assert torch.equal(ring.intt(ring.ntt(x)), ring.reduce(x))
    finally:
        config.ntt_mxu_tail = False
    torch.cuda.synchronize()


@pytest.mark.parametrize("logn", range(8, 16))
def test_split_inv_matches_plain(gen, logn):
    """The split inverse kernel's fused mode (ntt_split_inv) and DIT-alone
    mode (intt_tailed) against their plain versions on canonical, < 8q
    and any-u32 inputs with the extremes 0, q - 1 and 2^32 - 1; the fused
    inverse equals ntt_inv_kernel bit for bit, and undoes the fused
    forward."""
    ring = _ring(logn)
    t, _, inv, inv_k = _split_args(ring)
    q = ring.q[:, None]
    shape = (2, 3, ring.nlimbs, ring.n)
    split = (ring.q, ring.bar, ring.r_inv, t)
    inv_t = _full_args(ring)[2]
    canon = _rand(gen, shape, q)
    x = _rand(gen, shape, 1 << 32)
    x[0, 0, :, :100] = 0
    x[0, 1, :, :100] = (q - 1).expand(-1, 100)
    x[1, 0, :, :300] = (1 << 32) - 1
    for inp in (canon, _rand(gen, shape, 8 * q), x):
        got = ntt_cuda.ntt_split_inv(inp, *split)
        assert torch.equal(got, ntt_cuda.ntt_split_inv_plain(inp, *split))
        assert torch.equal(got, ntt_cuda.intt(inp, *inv_t))
        assert torch.equal(ntt_cuda.intt_tailed(inp, *inv_k),
                           ntt_cuda.intt_tailed_plain(inp, *inv))
    fwd = ntt_cuda.ntt_split_fwd(canon, ring.q, ring.r_inv, t)
    assert torch.equal(ntt_cuda.ntt_split_inv(fwd, *split), canon)
    torch.cuda.synchronize()


def test_split_routing_and_counters(gen):
    """With config.ntt_mxu_tail the ring runs the fused forward and the
    fused inverse (one launch each), and only kernel launches count."""
    from mkhe_tpu_torch import config
    ring = _ring(10)
    x = _rand(gen, (ring.nlimbs, ring.n), ring.q[:, None])
    want = ring.ntt(x)
    ntt_cuda.reset_counters()
    config.ntt_mxu_tail = True
    try:
        got = ring.ntt(x)
        back = ring.intt(got)
    finally:
        config.ntt_mxu_tail = False
    assert torch.equal(got, want) and torch.equal(back, x)
    assert ntt_cuda.counters() == {"ntt_fwd": 0, "ntt_inv": 0,
                                   "ntt_fwd_head": 0, "ntt_tail": 0,
                                   "ntt_inv_tailed": 0, "ntt_variant": 0,
                                   "ntt_split_fwd": 1, "ntt_split_inv": 1}


def test_split_wrappers_raise_on_cuda(gen):
    """On a CUDA tensor the head and tail need the kernel's tables, and a
    misaligned fragment table or a logN the kernel is not built for
    raises; a CUDA tensor never reaches a plain version."""
    import dataclasses
    ring = _ring(10)
    t, head, inv, _ = _split_args(ring)
    x = _rand(gen, (ring.nlimbs, ring.n), 1 << 32)
    with pytest.raises(ValueError, match="reads"):
        ntt_cuda.ntt_head(x, *head[:5])
    with pytest.raises(ValueError, match="reads"):
        ntt_cuda.intt_tailed(x, *inv)
    with pytest.raises(ValueError, match="reads"):
        ntt_cuda.tail(x, ring.q, ring.r_inv, t.tail_inv, t.tail_pow)
    flat = torch.zeros(t.tail_fwd_frag.numel() + 1, dtype=torch.uint8,
                       device="cuda")
    skewed = flat[1:].view(t.tail_fwd_frag.shape)
    skewed.copy_(t.tail_fwd_frag)
    with pytest.raises(ValueError, match="16-byte"):
        ntt_cuda.ntt_split_fwd(x, ring.q, ring.r_inv,
                               dataclasses.replace(t, tail_fwd_frag=skewed))
    small = _ring(7)
    small_t = small.split_tables()
    with pytest.raises(ValueError):
        ntt_cuda.ntt_split_fwd(_rand(gen, (small.nlimbs, small.n), 1 << 32),
                               small.q, small.r_inv, small_t)
    ntt_cuda.reset_counters()
    ntt_cuda.ntt_split_fwd(x, ring.q, ring.r_inv, t)
    ntt_cuda.ntt_split_fwd_plain(x, ring.q, ring.r_inv, t)
    ntt_cuda.ntt_split_inv(x, ring.q, ring.bar, ring.r_inv, t)
    ntt_cuda.ntt_split_inv_plain(x, ring.q, ring.bar, ring.r_inv, t)
    assert ntt_cuda.counters()["ntt_split_fwd"] == 1
    assert ntt_cuda.counters()["ntt_split_inv"] == 1
    torch.cuda.synchronize()


@pytest.mark.parametrize("logn", ntt_cuda.VARIANT_LOGNS)
def test_variant_kernel_matches_plain(gen, logn):
    """Every setting the variant kernel is built for, in both block
    orders, on any-u32 input with 2^32 - 1 extremes, 9 polynomials (the
    last block short at logN 10); every stage against Ring.ntt and logN - 7
    stages against the head kernel; at logN 15 also every setting at the
    probe's `digits` launch."""
    ring = _ring(logn)
    t = ntt_probe.variant_tables(ring)
    x = _rand(gen, (3, ring.nlimbs, ring.n), 1 << 32)
    x[0, :, :64] = (1 << 32) - 1
    for stages, exchange, mul in sorted(ntt_cuda.variant_settings(logn)):
        want = ntt_cuda.ntt_variant_plain(x, t, stages=stages,
                                          exchange=exchange, mul=mul)
        for order in ntt_cuda.ORDERS:
            got = ntt_cuda.ntt_variant(x, t, stages=stages,
                                       exchange=exchange, mul=mul,
                                       order=order)
            assert torch.equal(got, want), (stages, exchange, mul, order)
    assert torch.equal(ntt_cuda.ntt_variant(x, t, stages=logn),
                       ring.ntt(x))
    assert torch.equal(ntt_cuda.ntt_variant(x, t, stages=logn - 7),
                       ntt_cuda.ntt_head(x, t.q, t.twist, t.twist_sh,
                                         t.wpack, t.wpack_sh, t.twist_pack,
                                         t.wpack_pack))
    if logn == 15:
        # the probe's `digits` launch: 4 x 14 x 32 x 2^15, 1792 blocks
        ring = _ring(15, 32)
        t = ntt_probe.variant_tables(ring)
        x = _rand(gen, (4, 14, ring.nlimbs, ring.n), 1 << 32)
        for stages, exchange, mul in sorted(ntt_cuda.variant_settings(15)):
            want = ntt_cuda.ntt_variant_plain(x, t, stages=stages,
                                              exchange=exchange, mul=mul)
            for order in ntt_cuda.ORDERS:
                got = ntt_cuda.ntt_variant(x, t, stages=stages,
                                           exchange=exchange, mul=mul,
                                           order=order)
                assert torch.equal(got, want), (stages, exchange, mul,
                                                order)
            del want, got
    torch.cuda.synchronize()


def test_variant_wrapper_raises_on_cuda(gen):
    """Settings and logN the kernel is not built for, malformed or
    misaligned tables, a table on another device and moduli of 2^30 or
    more raise; only kernel launches count."""
    ring = _ring(14)
    t = ntt_probe.variant_tables(ring)
    x = _rand(gen, (2, ring.nlimbs, ring.n), 1 << 32)
    with pytest.raises(ValueError, match="not built"):
        ntt_cuda.ntt_variant(x, t, stages=5)
    small = _ring(12)
    ts = ntt_probe.variant_tables(small)
    with pytest.raises(ValueError, match="not built"):
        ntt_cuda.ntt_variant(_rand(gen, (small.nlimbs, small.n), 1 << 32),
                             ts, stages=12)
    with pytest.raises(ValueError):
        ntt_cuda.ntt_variant(x, dataclasses.replace(
            t, wpack_pack=t.wpack_pack[:, :-1].clone()), stages=14)
    with pytest.raises(ValueError):
        ntt_cuda.ntt_variant(x, dataclasses.replace(t, q=t.q.cpu()),
                             stages=14)
    with pytest.raises(ValueError, match="16-byte"):
        flat = torch.zeros(t.wpack_pack.numel() + 1, dtype=torch.int64,
                           device="cuda")
        skewed = flat[1:].view(t.wpack_pack.shape)
        skewed.copy_(t.wpack_pack)
        ntt_cuda.ntt_variant(x, dataclasses.replace(t, wpack_pack=skewed),
                             stages=14)
    with pytest.raises(ValueError, match="2\\^30"):
        ntt_cuda.pack_natural(t.wpack.cpu().numpy(),
                              t.wpack_sh.cpu().numpy(),
                              ring.moduli[:-1] + ((1 << 30) + 3,))
    ntt_cuda.reset_counters()
    ntt_cuda.ntt_variant(x, t, stages=14)
    ntt_cuda.ntt_variant(x, t, stages=14, exchange=False)
    ntt_cuda.ntt_variant_plain(x, t, stages=14)
    assert ntt_cuda.counters()["ntt_variant"] == 2
    torch.cuda.synchronize()


# ----------------------------------------------------------------------------
# Rotation, conjugation and the CNN pipeline: the card against the CPU
# ----------------------------------------------------------------------------

def _carry(params, device):
    """mkckks Parameters with params' moduli and CRS on another device."""
    from mkhe_tpu_torch import convert
    rp = params.rlwe
    return convert.ckks_parameters(
        convert.rlwe_parameters(rp.logn, rp.q_moduli, rp.p_moduli, rp.gamma,
                                rp.sigma, {i: a.numpy()
                                           for i, a in rp.crs.items()},
                                rp.crs_seed, device),
        params.logslots, params.scale)


def _keys(params, rots, conj, seed):
    """Two parties' keys on the CPU from the port's seeds, and copies of
    the evaluation keys for the card."""
    from mkhe_tpu_torch import convert, mkrlwe
    kgen = mkrlwe.KeyGenerator(params.rlwe, seed=seed)
    sks, pks = mkrlwe.SecretKeySet(), {}
    rlk, rtk = mkrlwe.RelinearizationKeySet(), mkrlwe.RotationKeySet()
    cjk = mkrlwe.ConjugationKeySet()
    for uid in ("dataOwner", "modelOwner"):
        sk, pks[uid] = kgen.gen_key_pair(uid)
        sks.add(sk)
        rlk.add(kgen.gen_relinearization_key(sk, kgen.gen_secret_key(uid)))
        for r in rots:
            rtk.add(kgen.gen_rotation_key(r, sk))
        if conj:
            cjk.add(kgen.gen_conjugation_key(sk))
    cuda = dict(
        rlk=convert.relinearization_key_set(
            {u: (k.b.numpy(), k.d.numpy(), k.v.numpy())
             for u, k in rlk.value.items()}, "cuda"),
        rtk=convert.rotation_key_set(
            {(u, r): k.data.numpy() for u, by in rtk.value.items()
             for r, k in by.items()}, "cuda"),
        cjk=convert.conjugation_key_set(
            {u: k.data.numpy() for u, k in cjk.value.items()}, "cuda"))
    return dict(sks=sks, pks=pks, rlk=rlk, rtk=rtk, cjk=cjk, cuda=cuda)


def _on(ct, device):
    from mkhe_tpu_torch import mkckks, mkrlwe
    return mkckks.Ciphertext(ct=mkrlwe.Ciphertext(
        ids=ct.ids, data=ct.ct.data.to(device)), scale=ct.scale)


def _same_ct(got, want):
    assert got.ids == want.ids and got.scale == want.scale
    assert torch.equal(got.ct.data.cpu(), want.ct.data)


def test_rotation_and_conjugation_logn14_match_cpu(gen):
    """At PN14QP433_CNN (logN 14, 14 + 4 limbs, alpha 2), 2 parties:
    rotate_new (one index with its CRS, one by the power-of-two
    fallback), a hoisted rotation one level down, a batched hoisted
    rotation and a conjugation on the card equal the same calls on the
    CPU."""
    import numpy as np
    from mkhe_tpu_torch import mkckks
    cpu = mkckks.PN14QP433_CNN("cpu")
    rots = (1, 4, 384, 8191)
    for idx in rots + (-2,):
        cpu = cpu.add_crs(idx)
    keys = _keys(cpu, rots, True, seed=81)
    enc = mkckks.Encryptor(cpu, seed=82)
    rng = np.random.default_rng(83)
    ct = None
    for uid in ("dataOwner", "modelOwner"):
        c = enc.encrypt_msg(mkckks.Message(
            value=rng.uniform(-1, 1, cpu.slots)), keys["pks"][uid])
        ct = c if ct is None else mkckks.Evaluator(cpu).add_new(ct, c)
    gpu = _carry(cpu, "cuda")
    ev_c, ev_g = mkckks.Evaluator(cpu), mkckks.Evaluator(gpu)
    ct_g = _on(ct, "cuda")
    for r in (384, 5, -1):
        _same_ct(ev_g.rotate_new(ct_g, r, keys["cuda"]["rtk"]),
                 ev_c.rotate_new(ct, r, keys["rtk"]))
    h_c, h_g = ev_c.hoisted_form(ct), ev_g.hoisted_form(ct_g)
    low_c, low_g = ev_c.drop_level(ct, 3), ev_g.drop_level(ct_g, 3)
    _same_ct(ev_g.rotate_hoisted_new(low_g, 4, h_g, keys["cuda"]["rtk"]),
             ev_c.rotate_hoisted_new(low_c, 4, h_c, keys["rtk"]))
    many_g = ev_g.rotate_hoisted_many_new(ct_g, rots, h_g,
                                          keys["cuda"]["rtk"])
    for got, want in zip(many_g, ev_c.rotate_hoisted_many_new(
            ct, rots, h_c, keys["rtk"])):
        _same_ct(got, want)
    _same_ct(ev_g.conjugate_new(low_g, keys["cuda"]["cjk"]),
             ev_c.conjugate_new(low_c, keys["cjk"]))
    torch.cuda.synchronize()


def test_cnn_mini_pipeline_matches_cpu(gen):
    """The staged CNN pipeline at MINI (logN 11) on the card gives the
    CPU's ciphertext bit for bit, and its logits are within 5e-3 of
    plain_forward."""
    import numpy as np
    from mkhe_tpu_torch import mkckks
    from mkhe_tpu_torch.models import cnn
    lo = cnn.MINI
    cpu = mkckks.new_parameters(11, 10, q0_bits=28.9, level_bits=20.0,
                                levels=7, scale=2.0 ** 40, p_bits=28.4,
                                device="cpu")
    rots = list(lo.extra_rots) + [1 << i for i in range(cpu.logn - 1)]
    for r in rots:
        cpu = cpu.add_crs(r)
    keys = _keys(cpu, rots, False, seed=84)
    enc = mkckks.Encryptor(cpu, seed=85)
    r = np.random.default_rng(86)
    kernels = r.uniform(-1, 1, (lo.num_kernels, lo.ksize, lo.ksize)) / 16
    n_in = lo.num_kernels * lo.conv_out ** 2
    fc1 = r.uniform(-1, 1, (n_in, lo.fc_units)) / n_in
    fc2 = r.uniform(-1, 1, (lo.fc_units, lo.classes)) / lo.fc_units
    b1 = r.uniform(-0.5, 0.5, lo.fc_units)
    b2 = r.uniform(-0.5, 0.5, lo.classes)
    img = r.uniform(0, 1, (lo.image, lo.image))
    s = cpu.slots

    def e(v, uid="modelOwner"):
        return enc.encrypt_msg(mkckks.Message(value=v), keys["pks"][uid])

    args = [e(cnn.pack_image(img, s, lo), "dataOwner"),
            [e(v) for v in cnn.pack_kernels(kernels, s, lo)],
            [e(v) for v in cnn.pack_fc1(fc1, s, lo)],
            e(cnn.pack_fc2(fc2, s, lo)), e(cnn.pack_b1(b1, s, lo)),
            e(cnn.pack_b2(b2, s, lo))]
    pt_mask = torch.from_numpy(enc.encode_msg(mkckks.Message(
        value=cnn.mask_vector(s, lo))).astype(np.int64))
    want = cnn._pipeline(mkckks.Evaluator(cpu), keys["rlk"], keys["rtk"],
                         *args, pt_mask, cpu.scale, lo)
    gpu = _carry(cpu, "cuda")
    args_g = [[_on(c, "cuda") for c in a] if isinstance(a, list)
              else _on(a, "cuda") for a in args]
    got = cnn._pipeline(mkckks.Evaluator(gpu), keys["cuda"]["rlk"],
                        keys["cuda"]["rtk"], *args_g, pt_mask.cuda(),
                        gpu.scale, lo)
    _same_ct(got, want)
    logits = np.real(mkckks.Decryptor(cpu).decrypt(
        want, keys["sks"]).value[:lo.classes])
    np.testing.assert_allclose(
        logits, cnn.plain_forward(img, kernels, fc1, fc2, b1, b2, lo),
        rtol=5e-3, atol=5e-3)


# ----------------------------------------------------------------------------
# fuse: the pipeline captured as one CUDA graph, and the batched mult
# ----------------------------------------------------------------------------

def _fuse_ctx(gen, rots=(1, 2), params=None):
    """CKKS at logN 10 (alpha 2, 2 parties) on the card, or at `params`,
    keys from the port's seeds, with rotation CRS and keys for rots and a
    conjugation key; fresh() encrypts one ciphertext under each party."""
    import numpy as np
    from mkhe_tpu_torch import mkckks, mkrlwe
    if params is None:
        params = mkckks.new_parameters(10, 9, q0_bits=28.9, level_bits=20.0,
                                       levels=3, scale=2.0 ** 40,
                                       p_bits=28.0, p_count=4, device="cuda")
    for r in rots + (-2,):
        params = params.add_crs(r)
    kgen = mkrlwe.KeyGenerator(params.rlwe, seed=87)
    pks, rlk = {}, mkrlwe.RelinearizationKeySet()
    rtk, cjk = mkrlwe.RotationKeySet(), mkrlwe.ConjugationKeySet()
    for uid in ("dataOwner", "modelOwner"):
        sk, pks[uid] = kgen.gen_key_pair(uid)
        rlk.add(kgen.gen_relinearization_key(sk, kgen.gen_secret_key(uid)))
        for r in rots:
            rtk.add(kgen.gen_rotation_key(r, sk))
        cjk.add(kgen.gen_conjugation_key(sk))
    enc = mkckks.Encryptor(params, seed=88)
    rng = np.random.default_rng(89)

    def fresh():
        return tuple(enc.encrypt_msg(mkckks.Message(
            value=rng.uniform(-0.5, 0.5, params.slots)), pks[uid])
            for uid in ("dataOwner", "modelOwner"))

    return params, rlk, rtk, cjk, fresh


def _fuse_pipe(ev, keys, a, b):
    """tests/test_fuse.py's pipeline, with a fractional constant (the
    Montgomery scalars) and a scale-aligning add."""
    prod = ev.mul_relin_new(a, b, keys.rlk)
    rot = ev.rotate_new(prod, 3, keys.rtk)
    conj = ev.conjugate_new(rot, keys.cjk)
    return ev.add_new(ev.add_new(conj, prod), ev.mult_by_const_new(a, 0.5))


def test_fuse_capture_equals_eager_on_fresh_inputs(gen):
    """One capture, replayed on inputs that are not the capture's: each
    replay equals the eager pipeline bit for bit; the capture is in the
    default error mode (fuse passes no capture_error_mode) and captured
    NTT launches."""
    from mkhe_tpu_torch import fuse, mkckks
    params, rlk, rtk, cjk, fresh = _fuse_ctx(gen)
    keys = type("K", (), dict(rlk=rlk, rtk=rtk, cjk=cjk))()
    fn, args = fuse.fuse(params, _fuse_pipe, fresh(), rlk_set=rlk,
                         rtk_set=rtk, cjk_set=cjk)
    assert fn.graph is not None and fn.launches["ntt_fwd"] > 0
    ev = mkckks.Evaluator(params)
    for _ in range(3):
        cts = fresh()
        got, want = fn(args[0], args[1], cts), _fuse_pipe(ev, keys, *cts)
        assert got.ids == want.ids and got.scale == want.scale
        assert torch.equal(got.ct.data, want.ct.data)


def test_fuse_results_do_not_alias(gen):
    from mkhe_tpu_torch import fuse, mkckks
    params, rlk, rtk, cjk, fresh = _fuse_ctx(gen)
    keys = type("K", (), dict(rlk=rlk, rtk=rtk, cjk=cjk))()
    fn, args = fuse.fuse(params, _fuse_pipe, fresh(), rlk_set=rlk,
                         rtk_set=rtk, cjk_set=cjk)
    first = fn(*args)
    first_copy = first.ct.data.clone()
    second = fn(args[0], args[1], fresh())
    assert first.ct.data.data_ptr() != second.ct.data.data_ptr()
    assert torch.equal(first.ct.data, first_copy)
    assert not torch.equal(first.ct.data, second.ct.data)
    ev = mkckks.Evaluator(params)
    assert torch.equal(first.ct.data, _fuse_pipe(ev, keys, *args[2]).ct.data)


def test_fuse_chained_on_card(gen):
    """fuse_chained at k = 0, 1 and 3 equals the eager chain bit for bit
    (sum feedback, benchmarks/_timing.py)."""
    from mkhe_tpu_torch import fuse, mkckks, mkrlwe
    params, rlk, rtk, cjk, fresh = _fuse_ctx(gen)
    keys = type("K", (), dict(rlk=rlk, rtk=rtk, cjk=cjk))()

    def chain(cts, out):
        a = cts[0]
        w = out.ct.data.sum() & ((1 << 32) - 1)
        return (mkckks.Ciphertext(ct=mkrlwe.Ciphertext(
            ids=a.ids, data=a.ct.data ^ w), scale=a.scale), cts[1])

    run_k, args = fuse.fuse_chained(params, _fuse_pipe, fresh(), chain,
                                    rlk_set=rlk, rtk_set=rtk, cjk_set=cjk)
    ev = mkckks.Evaluator(params)
    cts = fresh()
    for k in (0, 1, 3):
        c = cts
        for _ in range(k):
            c = chain(c, _fuse_pipe(ev, keys, *c))
        assert torch.equal(run_k(args[0], args[1], cts, k).ct.data,
                           _fuse_pipe(ev, keys, *c).ct.data)


def test_fused_replays_and_spans_on_card(gen):
    """Fused.replays rises by 1 a call and by k + 1 a run_k(k). A graph
    captured with the spans off replays the same kernels with them on, to
    the same bits, every device op put down by its correlation id under
    fuse.call, the replay's under fuse.replay; the eager mult launches the
    same kernels with the spans on and off, all of them under
    ckks.mul_relin, to the same bits."""
    import contextlib
    from torch.profiler import ProfilerActivity, profile
    from mkhe_tpu_torch import fuse, mkckks
    from mkhe_tpu_torch.utils import profiling
    params, rlk, rtk, cjk, fresh = _fuse_ctx(gen)
    keys = dict(rlk_set=rlk, rtk_set=rtk, cjk_set=cjk)
    fn, args = fuse.fuse(params, _fuse_pipe, fresh(), **keys)
    assert fn.replays == 0
    fn(*args)
    fn(args[0], args[1], fresh())
    assert fn.replays == 2
    run_k, cargs = fuse.fuse_chained(params, _fuse_pipe, fresh(),
                                     lambda cts, out: cts, **keys)
    run_k(*cargs, 3)
    assert run_k.fused.replays == 4
    run_k(*cargs, 0)
    assert run_k.fused.replays == 5

    def traced(call, spans):
        torch.cuda.synchronize()
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts) as prof:
            with profiling.spans_on() if spans else contextlib.nullcontext():
                out = call()
            torch.cuda.synchronize()
        return out, profiling.kineto_events(prof)

    def kernels(events):
        return [e.name for e in sorted(events, key=lambda e: e.start)
                if e.kind == "device"]

    ev = mkckks.Evaluator(params)
    a, b = fresh()
    for call, top in ((lambda: fn(*args), "fuse.call"),
                      (lambda: ev.mul_relin_new(a, b, rlk), "ckks.mul_relin")):
        call()
        (out_off, off), (out_on, on) = traced(call, False), traced(call, True)
        assert torch.equal(out_off.ct.data, out_on.ct.data)
        assert kernels(off) == kernels(on) and kernels(on)
        st = profiling.SpanTrace(on)
        assert st.unresolved_us == 0.0
        assert st.covered_us() == pytest.approx(st.device_us)
        assert [s.name for s in st.top_level()] == [top]
    rows = profiling.SpanTrace(traced(lambda: fn(*args), True)[1]).by_name()
    assert rows["fuse.replay"]["calls"] == 1
    assert 0 < rows["fuse.replay"]["device_us"] < rows["fuse.call"][
        "device_us"]


def test_fused_bfv_split_and_batched_mults_on_card(gen):
    """BFV at logN 9 with the split NTT on: fuse of mult + add equals the
    staged ops, the batched mult (B = 2) equals mult by mult; CKKS
    batched (B = 3) equals mult by mult."""
    import numpy as np
    from mkhe_tpu_torch import config, fuse, mkbfv, mkckks
    from mkhe_tpu_torch.ops.primes import ntt_primes
    params, rlk, _, _, fresh = _fuse_ctx(gen, rots=())
    ev = mkckks.Evaluator(params)
    cts = [fresh() for _ in range(3)]
    for got, (a, b) in zip(ev.mul_relin_batched_new(
            [c[0] for c in cts], [c[1] for c in cts], rlk), cts):
        assert torch.equal(got.ct.data, ev.mul_relin_new(a, b, rlk).ct.data)
    bp = mkbfv.new_parameters(9, ntt_primes(9, 26.5, 6, skip=10),
                              ntt_primes(9, 26.5, 6, skip=16),
                              ntt_primes(9, 28.0, 4), device="cuda")
    kgen = mkbfv.KeyGenerator(bp, seed=90)
    pks, brlk = {}, mkbfv.RelinearizationKeySet()
    for uid in ("a", "b"):
        sk, pks[uid] = kgen.gen_key_pair(uid)
        brlk.add(kgen.gen_relinearization_key_bfv(sk,
                                                  kgen.gen_secret_key(uid)))
    enc, bev = mkbfv.Encryptor(bp, seed=91), mkbfv.Evaluator(bp)
    rng = np.random.default_rng(92)

    def pair():
        return tuple(enc.encrypt_msg(rng.integers(0, 65537, bp.n), pks[u])
                     for u in ("a", "b"))

    def pipe(ev, keys, x, y):
        return ev.add_new(ev.mul_relin_new(x, y, keys.rlk), x)

    config.ntt_mxu_tail = True
    try:
        fn, args = fuse.fuse(bp, pipe, pair(), rlk_set=brlk)
        assert fn.launches["ntt_split_fwd"] > 0
        x, y = pair()
        assert torch.equal(fn(args[0], args[1], (x, y)).data,
                           pipe(bev, type("K", (), dict(rlk=brlk))(),
                                x, y).data)
        pairs = [pair() for _ in range(2)]
        for got, (x, y) in zip(bev.mul_relin_batched_new(
                [p[0] for p in pairs], [p[1] for p in pairs], brlk), pairs):
            assert torch.equal(got.data, bev.mul_relin_new(x, y, brlk).data)
    finally:
        config.ntt_mxu_tail = False


@pytest.mark.parametrize("kernel", ["ntt", "intt", "split_fwd", "split_inv",
                                    "variant"])
def test_ntt_wrappers_capture_in_default_mode(gen, kernel):
    """Each NTT wrapper, warmed up once, captures into a CUDA graph in the
    default (global) capture error mode, and the replay equals eager."""
    ring = _ring(14)
    x = _rand(gen, (2, ring.nlimbs, ring.n), 1 << 32)
    st = ring.split_tables()
    call = {"ntt": ring.ntt, "intt": ring.intt,
            "split_fwd": lambda a: ntt_cuda.ntt_split_fwd(
                a, ring.q, ring.r_inv, st),
            "split_inv": lambda a: ntt_cuda.ntt_split_inv(
                a, ring.q, ring.bar, ring.r_inv, st),
            "variant": lambda a: ntt_cuda.ntt_variant(
                a, ntt_probe.variant_tables(ring), stages=14)}[kernel]
    want = call(x)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="global"):
        got = call(x)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_bfv_rotation_and_conjugation_match_cpu(gen):
    """BFV rotate_new by 1 (its own CRS) and 3 (1 then 2) and
    conjugate_new of a 2-party sum at logN 10 on the card, with the split
    NTT on and off, equal the same calls on the CPU."""
    import numpy as np
    from mkhe_tpu_torch import config, convert, mkbfv, mkrlwe
    q, qmul = ntt_primes(10, 26.5, 6), ntt_primes(10, 26.5, 6, skip=6)
    cpu = mkbfv.new_parameters(10, q, qmul, ntt_primes(10, 28.0, 4),
                               device="cpu")
    rp = cpu.rlwe
    gpu = convert.bfv_parameters(convert.rlwe_parameters(
        rp.logn, rp.q_moduli, rp.p_moduli, rp.gamma, rp.sigma,
        {i: a.numpy() for i, a in rp.crs.items()}, rp.crs_seed, "cuda"),
        cpu.qmul_moduli, cpu.t)
    kgen = mkbfv.KeyGenerator(cpu, seed=84)
    rtk, cjk, pks = mkrlwe.RotationKeySet(), mkrlwe.ConjugationKeySet(), {}
    for uid in ("a", "b"):
        sk, pks[uid] = kgen.gen_key_pair(uid)
        for r in (1, 2):
            rtk.add(kgen.gen_rotation_key(r, sk))
        cjk.add(kgen.gen_conjugation_key(sk))
    g_rtk = convert.rotation_key_set(
        {(u, r): k.data.numpy() for u, by in rtk.value.items()
         for r, k in by.items()}, "cuda")
    g_cjk = convert.conjugation_key_set(
        {u: k.data.numpy() for u, k in cjk.value.items()}, "cuda")
    enc, ev_c = mkbfv.Encryptor(cpu, seed=85), mkbfv.Evaluator(cpu)
    rng = np.random.default_rng(86)
    ct = ev_c.add_new(*(enc.encrypt_msg(rng.integers(0, cpu.t, cpu.n),
                                        pks[u]) for u in ("a", "b")))
    ct_g = mkrlwe.Ciphertext(ids=ct.ids, data=ct.data.cuda())
    ev_g = mkbfv.Evaluator(gpu)
    want = [ev_c.rotate_new(ct, 1, rtk), ev_c.rotate_new(ct, 3, rtk),
            ev_c.conjugate_new(ct, cjk)]
    try:
        for on in (True, False):
            config.ntt_mxu_tail = on
            got = [ev_g.rotate_new(ct_g, 1, g_rtk),
                   ev_g.rotate_new(ct_g, 3, g_rtk),
                   ev_g.conjugate_new(ct_g, g_cjk)]
            for g, w in zip(got, want):
                assert g.ids == w.ids and torch.equal(g.data.cpu(), w.data)
    finally:
        config.ntt_mxu_tail = False


def test_serialize_card_tensors(gen, tmp_path):
    """Keys and a product ciphertext made on the card, saved and loaded
    back onto the card (the default device): bit for bit, and a mult with
    the loaded relin keys equals one with the originals."""
    import numpy as np
    from mkhe_tpu_torch import mkckks, mkrlwe
    from mkhe_tpu_torch.utils import serialize
    params = mkckks.new_parameters(10, 9, q0_bits=28.9, level_bits=20.0,
                                   levels=3, scale=2.0 ** 40, p_bits=28.0,
                                   p_count=4)
    kgen = mkrlwe.KeyGenerator(params.rlwe, seed=87)
    rlk, pks, loaded = (mkrlwe.RelinearizationKeySet(), {},
                        mkrlwe.RelinearizationKeySet())
    for uid in ("a", "b"):
        sk, pks[uid] = kgen.gen_key_pair(uid)
        rlk.add(kgen.gen_relinearization_key(sk, kgen.gen_secret_key(uid)))
        path = str(tmp_path / f"rlk_{uid}.npz")
        serialize.save_relin_key(path, rlk.get(uid))
        loaded.add(serialize.load_relin_key(path))
        for f in "bdv":
            got = getattr(loaded.get(uid), f)
            assert got.is_cuda and torch.equal(got, getattr(rlk.get(uid), f))
    serialize.save_secret_key(str(tmp_path / "sk.npz"), sk)
    sk2 = serialize.load_secret_key(str(tmp_path / "sk.npz"))
    assert sk2.data.is_cuda and torch.equal(sk2.data, sk.data)
    rtk = kgen.gen_rotation_key(4, sk)
    serialize.save_rotation_key(str(tmp_path / "rtk.npz"), rtk)
    rtk2 = serialize.load_rotation_key(str(tmp_path / "rtk.npz"))
    assert rtk2.rot_idx == 4 and torch.equal(rtk2.data, rtk.data)
    enc, ev = mkckks.Encryptor(params, seed=88), mkckks.Evaluator(params)
    rng = np.random.default_rng(89)
    cts = [enc.encrypt_msg(mkckks.Message(value=rng.uniform(
        0.1, 0.5, params.slots)), pks[u]) for u in ("a", "b")]
    prod = ev.mul_relin_new(*cts, rlk)
    assert torch.equal(ev.mul_relin_new(*cts, loaded).ct.data, prod.ct.data)
    serialize.save_ciphertext(str(tmp_path / "ct.npz"), prod.ct,
                              scale=prod.scale)
    ct, scale = serialize.load_ciphertext(str(tmp_path / "ct.npz"))
    assert ct.data.is_cuda and scale == prod.scale
    assert ct.ids == prod.ids and torch.equal(ct.data, prod.ct.data)


def test_examples_on_card(gen, capsys):
    from mkhe_tpu_torch.examples import two_party_bfv, two_party_ckks
    assert two_party_ckks.main() < 1e-6
    two_party_bfv.main()
    out = capsys.readouterr().out
    assert "(cuda:0)" in out and "rotation EXACT" in out


# ----------------------------------------------------------------------------
# The parallel tier on the card
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [2, 4])
def test_chunk_local_kernels_match_plain(gen, n_shards):
    """A dist ring's chunk-local stages: the full kernels at logN 15 -
    log2 C with every rank's tables (dist_ntt._rank_tables) on PN15QP880's
    QP moduli (32 limbs; chunks of 2^14 and 2^13), against ntt_plain /
    intt_plain with the same tables; the launch counters grow."""
    from mkhe_tpu_torch.mkckks.params import _PRESETS, select_moduli
    from mkhe_tpu_torch.parallel import dist_ntt

    pre = _PRESETS["PN15QP880"]
    q, p = select_moduli(15, pre["q0_bits"], pre["level_bits"],
                         pre["levels"], p_bits=pre["p_bits"],
                         p_count=pre["p_count"])
    ring = Ring.create(q + p, 15, "cuda")
    assert ring.nlimbs == 32
    c = ring.n // n_shards
    for d in range(n_shards):
        t = dist_ntt._rank_tables(ring.moduli, 15, n_shards, d,
                                  ring.q.device)
        x = _rand(gen, (2, ring.nlimbs, c), 1 << 32)
        fwd = (ring.q, ring.bar, t["fwd_loc"], t["fwd_loc_sh"])
        inv = (ring.q, ring.bar, t["inv_loc"], t["inv_loc_sh"], t["one"],
               t["one_sh"])
        ntt_cuda.reset_counters()
        assert torch.equal(ntt_cuda.ntt(x, *fwd, t["fwd_pack"]),
                           ntt_cuda.ntt_plain(x, *fwd))
        lazy = _rand(gen, (2, ring.nlimbs, c), 8 * ring.q[:, None])
        assert torch.equal(ntt_cuda.intt(lazy, *inv, t["inv_pack"]),
                           ntt_cuda.intt_plain(lazy, *inv))
        assert (ntt_cuda.fwd_launches, ntt_cuda.inv_launches) == (1, 1)
    torch.cuda.synchronize()


def test_sharded_ntt_two_ranks_on_card(gen):
    """One spawn of 2 ranks on the card over gloo: the coefficient-sharded
    forward and inverse NTT equal Ring.ntt / intt on the card, and every
    rank launched the chunk-local kernels."""
    from mkhe_tpu_torch.parallel import _ranks

    ring = _ring(12, limbs=4)
    x = _rand(gen, (3, ring.nlimbs, ring.n), ring.q[:, None])
    nt = ring.ntt(x)
    common = dict(moduli=ring.moduli, logn=12, rns=1, coeff=2,
                  limb_axis=False)
    outs = _ranks.run([("ntt", dict(common, x=x.cpu(), inverse=False)),
                       ("ntt", dict(common, x=nt.cpu(), inverse=True))],
                      2, backend="gloo", device="cuda", timeout=300)
    for i, want in enumerate((nt, x)):
        got = torch.cat([o["results"][i] for o in outs], -1)
        assert torch.equal(got, want.cpu())
    for o in outs:
        assert o["transport"] == "gloo" and o["foreign_modules"] == []
        assert o["launches"][0]["ntt_fwd"] == 1
        assert o["launches"][1]["ntt_inv"] == 1


def test_collective_refuses_capture(gen, tmp_path):
    """A collective inside a CUDA graph capture (fuse's) raises rather than
    record a broken graph."""
    import torch.distributed as dist
    from mkhe_tpu_torch.parallel import comm

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        x = torch.ones(4, dtype=torch.int64, device="cuda")
        assert torch.equal(comm.all_reduce_sum(x, None), x)
        graph = torch.cuda.CUDAGraph()
        with pytest.raises(RuntimeError, match="cannot be captured"):
            with torch.cuda.graph(graph):
                comm.all_reduce_sum(x, None)
    finally:
        dist.destroy_process_group()


def test_sharded_paths_over_nccl(gen):
    """On a machine with 2 or more cards, one rank a card over NCCL (the
    device-tensor route of parallel/comm.py): the coefficient-sharded NTT
    and mult and the party-sharded mult and rotation equal the
    single-device results on cuda:0."""
    import torch.distributed as dist
    from mkhe_tpu_torch import mkckks, mkrlwe
    from mkhe_tpu_torch.mkrlwe import keyswitch as ksw
    from mkhe_tpu_torch.parallel import _ranks

    world = min(4, torch.cuda.device_count())
    if world < 2 or not dist.is_nccl_available():
        pytest.skip("needs 2 or more CUDA devices and NCCL")
    params = mkckks.new_parameters(12, 11, q0_bits=28.9, level_bits=20.0,
                                   levels=3, scale=2.0 ** 40, p_bits=28.4,
                                   device="cuda")
    rp = params.rlwe
    users = [f"u{i}" for i in range(world)]
    kgen = mkrlwe.KeyGenerator(rp, seed=31)
    rlk, rtk, pks = mkrlwe.RelinearizationKeySet(), mkrlwe.RotationKeySet(), {}
    for uid in users:
        sk, pks[uid] = kgen.gen_key_pair(uid)
        rlk.add(kgen.gen_relinearization_key(sk, kgen.gen_secret_key(uid)))
        rtk.add(kgen.gen_rotation_key(1, sk))
    enc, ev = mkckks.Encryptor(params, seed=32), mkckks.Evaluator(params)
    cts = [enc.encrypt_msg(mkckks.Message(value=torch.rand(
        params.slots, generator=torch.Generator().manual_seed(i)).numpy()),
        pks[u]) for i, u in enumerate(users)]
    ct0 = ct1 = cts[0]
    for c in cts[1:]:
        ct0, ct1 = ev.add_new(ct0, c), ev.sub_new(ct1, c)
    stacked = rlk.stacked(ct0.ids)
    rtk1 = rtk.stacked(ct0.ids, 1)
    ring = rp.ring_qp
    x = _rand(gen, (2, ring.nlimbs, ring.n), ring.q[:, None])
    want = [ring.ntt(x),
            ksw.mul_and_relin(rp, ct0.ct, ct1.ct, stacked, ct0.level).data,
            ksw.mul_and_relin(rp, ct0.ct, ct1.ct, stacked, ct0.level).data,
            ksw.rotate(rp, ct0.ct, 1, rtk1).data]
    state = dict(logn=rp.logn, q=rp.q_moduli, p=rp.p_moduli, gamma=rp.gamma,
                 sigma=rp.sigma, crs={i: rp.crs[i].cpu() for i in (-1, 1)})
    cts_host = [(c.ids, c.ct.data.cpu()) for c in (ct0, ct1)]
    keys_host = tuple(a.cpu() for a in stacked)
    outs = _ranks.run([
        ("ntt", dict(moduli=ring.moduli, logn=rp.logn, x=x.cpu(), rns=1,
                     coeff=world, inverse=False, limb_axis=False)),
        ("coeff_mul", dict(params=state, ct0=cts_host[0], ct1=cts_host[1],
                           rlk=keys_host, level=ct0.level, rns=1,
                           coeff=world)),
        ("party_mul", dict(params=state, ct0=cts_host[0], ct1=cts_host[1],
                           rlk=keys_host, h0=None, h1=None, parties=world)),
        ("party_rot", dict(params=state, ct=cts_host[0], rot=1,
                           rtk=rtk1.cpu(), h=None, parties=world))],
        world, backend="nccl", device="cuda", timeout=300)
    assert all(o["transport"] == "nccl" for o in outs)
    got_ntt = torch.cat([o["results"][0] for o in outs], -1)
    got_mul = torch.cat([o["results"][1][1] for o in outs], -1)
    assert torch.equal(got_ntt, want[0].cpu())
    assert torch.equal(got_mul, want[1].cpu())
    for o in outs:
        assert torch.equal(o["results"][2][1], want[2].cpu())
        assert torch.equal(o["results"][3][1], want[3].cpu())
        assert o["launches"][0]["ntt_fwd"] == 1


# ----------------------------------------------------------------------------
# Threefry, the samplers and the CRS: the card against the CPU
# ----------------------------------------------------------------------------

def test_threefry_bits_and_permutation_match_cpu(gen):
    """bits at shapes that cross the chunk, and permutation at 0, 1 and
    2 rounds, on the card equal the CPU's."""
    from mkhe_tpu_torch.ops import threefry
    for seed in (0, 2 ** 31, -1):
        k = threefry.key(seed)
        for shape in ((7,), (3, 5, 7), (2, 7, 18, 1 << 10),
                      (threefry.CHUNK + 3,)):
            assert torch.equal(threefry.bits(k, shape, "cuda").cpu(),
                               threefry.bits(k, shape, "cpu"))
        for n in (1, 2, 1626, 1 << 15):
            assert torch.equal(threefry.permutation(k, n, "cuda").cpu(),
                               threefry.permutation(k, n, "cpu"))


def test_samplers_match_cpu(gen):
    """Every sampler under one key on the card equals the CPU's."""
    from mkhe_tpu_torch.ops import sampling, threefry
    mods = ntt_primes(12, 28.9, 1) + ntt_primes(12, 27.0, 5)
    rc, rg = Ring.create(mods, 12, "cpu"), Ring.create(mods, 12, "cuda")
    k = threefry.key(17)
    n = rc.n
    pairs = [(sampling.uniform(k, rg, 3), sampling.uniform(k, rc, 3)),
             (sampling.ternary(k, n, "cuda"), sampling.ternary(k, n, "cpu")),
             (sampling.gaussian(k, n, "cuda"), sampling.gaussian(k, n, "cpu")),
             (sampling.ternary_sparse(k, n, 192, "cuda"),
              sampling.ternary_sparse(k, n, 192, "cpu")),
             (sampling.gaussian_rns(k, rg, 2), sampling.gaussian_rns(k, rc, 2)),
             (sampling.ternary_rns(k, rg, 2), sampling.ternary_rns(k, rc, 2))]
    for got, want in pairs:
        assert got.is_cuda and torch.equal(got.cpu(), want)


def test_cnn_crs_matches_cpu(gen):
    """The PN14QP433_CNN parameters' every default CRS, drawn on the card,
    equals the one drawn on the CPU."""
    from mkhe_tpu_torch import mkckks
    cpu, card = mkckks.PN14QP433_CNN("cpu"), mkckks.PN14QP433_CNN("cuda")
    assert sorted(card.rlwe.crs) == sorted(cpu.rlwe.crs)
    for idx, a in cpu.rlwe.crs.items():
        assert torch.equal(card.rlwe.crs[idx].cpu(), a)


# ----------------------------------------------------------------------------
# The key-switching kernels (csrc/keyswitch.cu, ops/basis_cuda.py)
# ----------------------------------------------------------------------------

def _ks_moduli(logn):
    """28 Q, 4 P and 28 QMul moduli at logN (the PN15QP880 layout)."""
    q = ntt_primes(logn, 28.9, 1) + ntt_primes(logn, 27.0, 27)
    return q, ntt_primes(logn, 28.4, 4), ntt_primes(logn, 26.0, 28)


def _with_boundary(x, src, alpha):
    """x, with coefficients planted on the float32 v boundary where the
    seed gave none; asserts that every digit that has such inputs
    (basis_cuda.boundary_ys) has a coefficient there whose float32 v
    differs from the exact floor (python ints where close)."""
    from mkhe_tpu_torch.ops import basis_cuda as bc
    has = [bc.boundary_ys(src[lo:lo + alpha]) is not None
           for lo in range(0, len(src), alpha)]

    def shown(x):
        v32, exact = bc.v_floors(x, src, alpha)
        per = (v32 != exact).any(axis=tuple(range(v32.ndim - 2)) + (-1,))
        return all(p for p, h in zip(per, has) if h)

    if not shown(x):
        x = bc.plant_v_boundary(x, src, alpha, [1, x.shape[-1] - 1])
    assert shown(x)
    return x


def _basis_cases(gen, logn, n):
    """(name, wrapper, plain, args) of every basis-kernel call site at
    logN (chunks of n coefficients): mod_up at Ls 1..4 into QP and 28 -> 28
    (BFV), the digits at alpha 2 and 3 (28 limbs), ModDown from 4 and 2 P
    limbs to 28, the Q and P parts sliced from one (.., 32, n) tensor."""
    from mkhe_tpu_torch.ops import basis_cuda as bc
    q, p, qmul = _ks_moduli(logn)
    dev = torch.device("cuda")
    cases = []
    for ls in (1, 2, 3, 4, 28):
        src, dst = q[:ls], (qmul if ls == 28 else q + p)
        x = _with_boundary(_rand(gen, (3, ls, n), 1 << 32), src, ls)
        t = bc.mod_up_tables(src, dst, dev)
        cases.append((f"mod_up {ls}->{len(dst)}", bc.mod_up, bc.mod_up_plain,
                      (x, t)))
    for alpha in (2, 3):
        x = _with_boundary(_rand(gen, (2, 28, n), 1 << 32), q, alpha)
        t = bc.digit_tables(q, q + p, alpha, dev)
        cases.append((f"decompose alpha {alpha}", bc.decompose,
                      bc.decompose_plain, (x, t)))
    for lp in (4, 2):
        bound = torch.tensor(q + p[:lp], device=dev)[:, None]
        c = _rand(gen, (3, 28 + lp, n), bound)
        c[:, 28:] = _with_boundary(c[:, 28:], p[:lp], lp)
        t = bc.mod_down_tables(q, p[:lp], dev)
        cases.append((f"mod_down {lp}", bc.mod_down, bc.mod_down_plain,
                      (c[:, :28], c[:, 28:], t)))
    return cases


@pytest.mark.parametrize("logn,shards", [(10, 1), (14, 1), (15, 1), (15, 2),
                                         (15, 4)])
def test_basis_kernels_match_plain(gen, logn, shards):
    """mod_up, the digits and ModDown against their plain versions bit for
    bit, the float32 v boundary included, at N and at the N/2 and N/4
    chunks of the coefficient-sharded mult."""
    for name, kern, plain, args in _basis_cases(gen, logn,
                                                (1 << logn) // shards):
        got, want = kern(*args), plain(*args)
        torch.cuda.synchronize()
        assert got.shape == want.shape and torch.equal(got, want), name


def _wide_basis_cases(gen):
    """(name, wrapper, plain, args) of the basis kernel's wide body (digits
    of more than basis_cuda.WIDE_ALPHA limbs) at logN 15, the float32 v
    boundary in every case: BFV's three conversions at (5, 28) x 2^15
    (Q -> QMul, QMul -> Q, the ModDown by QMul), a strided view of a
    taller tensor, 1 and 3 polynomials, and short sources of 17 and 20
    limbs."""
    from mkhe_tpu_torch.ops import basis_cuda as bc
    q, _, qmul = _ks_moduli(15)
    dev, n = torch.device("cuda"), 1 << 15
    up, back = bc.mod_up_tables(q, qmul, dev), bc.mod_up_tables(qmul, q, dev)
    down = bc.mod_down_tables(q, qmul, dev)
    bound_q = torch.tensor(q, device=dev)[:, None]
    bound_m = torch.tensor(qmul, device=dev)[:, None]

    def coeffs(polys, src, bound):
        return _with_boundary(_rand(gen, (polys, len(src), n), bound), src,
                              len(src))

    x, y = coeffs(5, q, bound_q), coeffs(5, qmul, bound_m)
    tall = _rand(gen, (3, 30, n), 1 << 32)
    tall[:, 1:29] = _with_boundary(tall[:, 1:29], q, 28)
    cases = [("Q -> QMul (5, 28)", bc.mod_up, bc.mod_up_plain, (x, up)),
             ("QMul -> Q (5, 28)", bc.mod_up, bc.mod_up_plain, (y, back)),
             ("ModDown by QMul (5, 28 + 28)", bc.mod_down, bc.mod_down_plain,
              (x, y, down)),
             ("strided view (3, 30)[:, 1:29]", bc.mod_up, bc.mod_up_plain,
              (tall[:, 1:29], up))]
    for polys in (1, 3):
        cases.append((f"{polys} polynomials", bc.mod_up, bc.mod_up_plain,
                      (coeffs(polys, q, bound_q), up)))
        cases.append((f"ModDown, {polys} polynomials", bc.mod_down,
                      bc.mod_down_plain, (coeffs(polys, q, bound_q),
                                          coeffs(polys, qmul, bound_m), down)))
    for ls in (17, 20):
        cases.append((f"Ls {ls} -> QMul", bc.mod_up, bc.mod_up_plain,
                      (coeffs(2, q[:ls], 1 << 32),
                       bc.mod_up_tables(q[:ls], qmul, dev))))
    return cases


def test_wide_basis_kernels_match_plain(gen):
    """The wide body against mod_up_plain / mod_down_plain bit for bit,
    one launch each, every launch counted under `basis_wide`."""
    from mkhe_tpu_torch.ops import basis_cuda as bc
    for name, kern, plain, args in _wide_basis_cases(gen):
        bc.reset_counters()
        got = kern(*args)
        torch.cuda.synchronize()
        assert bc.counters()["basis_wide"] == 1, name
        want = plain(*args)
        assert got.shape == want.shape and torch.equal(got, want), name
    assert bc.counters()["basis_wide"] == 1


def test_bfv_mult_wide_conversions_match_cpu(gen):
    """A 2-party BFV mult at logN 10 over 28 Q and 28 QMul limbs on the
    card equals the same mult on the CPU bit for bit (the same seeds give
    both devices the same keys and ciphertexts), with its four 28 -> 28
    conversions in the wide body: `basis_wide` reads 4."""
    import numpy as np
    from mkhe_tpu_torch import mkbfv
    from mkhe_tpu_torch.ops import basis_cuda as bc
    q, qmul = ntt_primes(10, 26.5, 28), ntt_primes(10, 26.5, 28, skip=28)
    msgs = np.random.default_rng(93).integers(0, 65537, (2, 1 << 10))
    res = {}
    for dev in ("cpu", "cuda"):
        bp = mkbfv.new_parameters(10, q, qmul, ntt_primes(10, 28.0, 4),
                                  device=dev)
        kgen = mkbfv.KeyGenerator(bp, seed=94)
        pks, rlk = {}, mkbfv.RelinearizationKeySet()
        for uid in ("a", "b"):
            sk, pks[uid] = kgen.gen_key_pair(uid)
            rlk.add(kgen.gen_relinearization_key_bfv(
                sk, kgen.gen_secret_key(uid)))
        enc, ev = mkbfv.Encryptor(bp, seed=95), mkbfv.Evaluator(bp)
        cts = [enc.encrypt_msg(m, pks[u]) for m, u in zip(msgs, "ab")]
        bc.reset_counters()
        res[dev] = (cts, ev.mul_relin_new(*cts, rlk))
        torch.cuda.synchronize()
        if dev == "cuda":
            assert bc.counters()["basis_wide"] == 4
    (cts_c, prod_c), (cts_g, prod_g) = res["cpu"], res["cuda"]
    for a, b in zip(cts_c, cts_g):
        assert torch.equal(b.data.cpu(), a.data)
    assert prod_g.ids == prod_c.ids
    assert torch.equal(prod_g.data.cpu(), prod_c.data)


def _contraction_cases(gen, n):
    """(name, a, b, nterms) in each caller's layout over 32 limbs."""
    k, beta, B, R = 4, 14, 2, 3
    sh = (32, n)
    d, key = _rand(gen, (k, beta, *sh), 1 << 28), _rand(gen, (k, beta, *sh),
                                                        1 << 28)
    db = _rand(gen, (k, B, beta, *sh), 1 << 28)
    x, crs = _rand(gen, (B, beta, *sh), 1 << 28), _rand(gen, (R, beta, *sh),
                                                        1 << 28)
    dbi = db.movedim(0, -4)        # parties_inner: (B, k, beta, ...)
    many = _rand(gen, (10, beta, *sh), 1 << 28)   # 140 terms
    return [
        ("parties", d, key, 1),
        ("parties batched", db, key, 1),
        ("digits, key broadcast", d.movedim(-3, 0), key[0].movedim(-3, 0),
         1),
        ("digits batched", db.movedim(-3, 0), x.movedim(-3, 0), 1),
        ("rotations", d[None].movedim(-3, 0), crs[:, None].movedim(-3, 0),
         1),
        ("parties x digits", d.movedim((-4, -3), (0, 1)),
         key.movedim((-4, -3), (0, 1)), 2),
        ("parties x digits batched", dbi.movedim((-4, -3), (0, 1)),
         key.movedim((-4, -3), (0, 1)), 2),
        ("140 terms", many.movedim((-4, -3), (0, 1)),
         many.flip(0).movedim((-4, -3), (0, 1)), 2),
        ("limb-strided", d[..., 1:, :], key[..., :-1, :], 1),
    ]


@pytest.mark.parametrize("logn,shards", [(12, 1), (15, 2), (15, 4)])
def test_mul_accum_kernel_matches_plain(gen, logn, shards):
    """The contraction in every caller's layout (broadcast keys, batch
    axes, parties_inner's strides, more than 64 terms, a limb-sliced view)
    against its plain version bit for bit, on moduli just below 2^29."""
    from mkhe_tpu_torch.ops import basis_cuda as bc
    mods = ntt_primes(logn, 28.99, 32)
    for name, a, b, nt in _contraction_cases(gen, (1 << logn) // shards):
        L = a.shape[-2]
        t = bc.limb_tables(mods[:L], torch.device("cuda"))
        q = t.q[:, None]
        a, b = a % q, b % q
        if name == "140 terms":   # residues just below q: the sum needs folds
            a, b = q - 1 - a % 1024, q - 1 - b % 1024
        got, want = bc.mul_accum(a, b, nt, t), bc.mul_accum_plain(a, b, nt, t)
        torch.cuda.synchronize()
        assert got.shape == want.shape and torch.equal(got, want), name


def test_keyswitch_kernels_count_and_raise(gen):
    """A CUDA tensor reaches each kernel (one count a launch, none for a
    plain call); shapes, types and devices the kernels do not take raise."""
    from mkhe_tpu_torch.ops import basis_cuda as bc
    q, p, _ = _ks_moduli(10)
    dev = torch.device("cuda")
    x = _rand(gen, (2, 28, 1 << 10), 1 << 32)
    up, dig = bc.mod_up_tables(q[:2], q + p, dev), bc.digit_tables(
        q, q + p, 2, dev)
    down, lt = bc.mod_down_tables(q, p, dev), bc.limb_tables(q + p, dev)
    c = _rand(gen, (2, 32, 1 << 10), torch.tensor(q + p, device=dev)[:, None])
    bc.reset_counters()
    bc.mod_up(x[:, :2], up)
    bc.decompose(x, dig)
    bc.mod_down(c[:, :28], c[:, 28:], down)
    bc.mul_accum(c, c, 1, lt)
    bc.mod_up_plain(x[:, :2], up)
    bc.mul_accum_plain(c, c, 1, lt)
    assert bc.counters() == {"mod_up": 2, "mod_down": 1, "mul_accum": 1,
                             "rescale": 0, "decompose_ntt": 0, "tensor": 0,
                             "basis_wide": 0}
    with pytest.raises(ValueError):
        bc.mod_up(x[:, :3], up)
    with pytest.raises(TypeError):
        bc.decompose(x.to(torch.int32), dig)
    with pytest.raises(ValueError):
        bc.mod_up(x[:, :2], bc.mod_up_tables(q[:2], q + p, torch.device(
            "cpu")))
    with pytest.raises(ValueError):
        bc.mod_down(c[:1, :28], c[:, 28:], down)
    with pytest.raises(ValueError):
        bc.mul_accum(c, c[..., :16], 1, lt)
    # four outer axes that step differently in the two operands
    y = _rand(gen, (1, 2, 3, 2, 3, 32, 8), 1 << 28)
    z = _rand(gen, (1, 3, 2, 3, 2, 32, 8), 1 << 28).permute(0, 2, 1, 4, 3,
                                                            5, 6)
    with pytest.raises(ValueError):
        bc.mul_accum(y, z, 1, lt)
    assert bc.counters() == {"mod_up": 2, "mod_down": 1, "mul_accum": 1,
                             "rescale": 0, "decompose_ntt": 0, "tensor": 0,
                             "basis_wide": 0}


@pytest.mark.parametrize("kernel", ["mod_up", "decompose", "mod_down",
                                    "mul_accum"])
def test_keyswitch_wrappers_capture_in_default_mode(gen, kernel):
    """Each key-switching wrapper, warmed up once, captures into a CUDA
    graph in the default (global) capture error mode, and the replay
    equals eager."""
    from mkhe_tpu_torch.ops import basis_cuda as bc
    q, p, _ = _ks_moduli(14)
    dev = torch.device("cuda")
    x = _rand(gen, (2, 28, 1 << 14), 1 << 32)
    c = _rand(gen, (2, 32, 1 << 14), torch.tensor(q + p, device=dev)[:, None])
    call = {"mod_up": lambda: bc.mod_up(x[:, :2], bc.mod_up_tables(
                q[:2], q + p, dev)),
            "decompose": lambda: bc.decompose(x, bc.digit_tables(
                q, q + p, 2, dev)),
            "mod_down": lambda: bc.mod_down(c[:, :28], c[:, 28:],
                                            bc.mod_down_tables(q, p, dev)),
            "mul_accum": lambda: bc.mul_accum(
                c[None].expand(3, -1, -1, -1), c[None], 1,
                bc.limb_tables(q + p, dev))}[kernel]
    want = call()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="global"):
        got = call()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# ----------------------------------------------------------------------------
# The fused decomposition (csrc/ntt.cu::decompose_ntt_kernel,
# basis_cuda.decompose_ntt)
# ----------------------------------------------------------------------------

def _decompose_cases(gen):
    """(name, source view, source moduli, destination moduli, logN) of
    every shape the fused route takes, digits of two limbs: the CKKS
    mult's (Ls 28 -> 32, 8 party polys), an odd level (Ls 27: a one-limb
    last digit), a level-dropped view of a taller tensor, BFV over R (Ls
    56, 28 digits), the CNN's logN 14 (Ls 14 -> 18) and a batch axis."""
    q, p, qmul = _ks_moduli(15)
    q14, p14, _ = _ks_moduli(14)
    cases = []

    def add(name, x, src, dst, logn):
        cases.append((name, _with_boundary(x, src, 2), src, dst, logn))

    n = 1 << 15
    add("ckks (8, 28) -> (8, 14, 32)", _rand(gen, (8, 28, n), 1 << 32), q,
        q + p, 15)
    add("odd level (4, 27)", _rand(gen, (4, 27, n), 1 << 32), q[:27],
        q[:27] + p, 15)
    tall = _rand(gen, (3, 28, n), 1 << 32)
    add("level-dropped view (3, 28)[:, :21]", tall[:, :21], q[:21],
        q[:21] + p, 15)
    add("bfv R (2, 56) -> (2, 28, 32)", _rand(gen, (2, 56, n), 1 << 32),
        q + qmul, q + p, 15)
    add("cnn logN 14 (2, 14) -> (2, 7, 18)",
        _rand(gen, (2, 14, 1 << 14), 1 << 32), q14[:14], q14[:14] + p14, 14)
    add("batch axis (2, 3, 7) logN 14",
        _rand(gen, (2, 3, 7, 1 << 14), 1 << 32), q14[:7], q14[:7] + p14, 14)
    return cases


def test_decompose_ntt_matches_composition(gen):
    """The fused digits equal ring.ntt(basis_cuda.decompose(x, t)) and the
    plain version (decompose_ntt_plain) bit for bit at every shape of
    _decompose_cases, so both instantiations meet the plain reference, the
    float32 v boundary in every digit; one fused launch each, no mod_up or
    forward NTT launch."""
    from mkhe_tpu_torch.ops import basis_cuda as bc
    dev = torch.device("cuda")
    for name, x, src, dst, logn in _decompose_cases(gen):
        ring = Ring.create(dst, logn, "cuda")
        t = bc.digit_tables(src, dst, 2, dev)
        bc.reset_counters()
        ntt_cuda.reset_counters()
        got = bc.decompose_ntt(x, t, ring)
        assert bc.counters()["decompose_ntt"] == 1, name
        assert bc.counters()["mod_up"] == 0 and ntt_cuda.fwd_launches == 0
        want = ring.ntt(bc.decompose(x, t))
        torch.cuda.synchronize()
        assert got.shape == want.shape == (*x.shape[:-2], -(-len(src) // 2),
                                           len(dst), 1 << logn)
        assert torch.equal(got, want), name
        del want
        assert torch.equal(got, bc.decompose_ntt_plain(x, t, ring)), name


def test_decompose_ntt_routes_and_counts(gen):
    """basis.decompose_ntt on the card: one fused launch for digits of two
    limbs at logN 14; the composition (one mod_up, one forward NTT) with
    the split NTT on, at alpha 3 and at logN 12, 10, 8 and 4 (4: a single
    pass), and a broadcast view at alpha 1; all equal the plain version.
    basis_cuda.decompose_ntt raises for a shape its kernel lacks. A
    two-party CKKS mult at PN14QP433_CNN launches the fused kernel once per
    decomposition (both operands' hoistings and t's) and no mod_up."""
    from mkhe_tpu_torch import config, mkckks
    from mkhe_tpu_torch.ops import basis
    from mkhe_tpu_torch.ops import basis_cuda as bc
    dev = torch.device("cuda")

    def route(x, rq, rqp, alpha, split=False):
        bc.reset_counters()
        ntt_cuda.reset_counters()
        config.ntt_mxu_tail = split
        try:
            got = basis.decompose_ntt(x, rq, rqp, alpha)
        finally:
            config.ntt_mxu_tail = False
        want = bc.decompose_ntt_plain(x, bc.digit_tables(
            rq.moduli, rqp.moduli, alpha, dev), rqp)
        assert torch.equal(got, want), (rq.logn, alpha, split)
        return (bc.counters()["decompose_ntt"], bc.counters()["mod_up"],
                ntt_cuda.fwd_launches)

    for logn in (14, 12, 10, 8, 4):
        q, p, _ = _ks_moduli(logn)
        rq = Ring.create(q[:7], logn, "cuda")
        rqp = Ring.create(q[:7] + p, logn, "cuda")
        x = _with_boundary(_rand(gen, (3, 7, 1 << logn), rq.q[:, None]),
                           rq.moduli, 2)
        if logn == 14:
            assert route(x, rq, rqp, 2) == (1, 0, 0)
            assert route(x, rq, rqp, 2, split=True) == (0, 1, 0)
            assert route(x, rq, rqp, 3) == (0, 1, 1)
            assert route(x, rq, rqp, 1) == (0, 0, 1)
            with pytest.raises(ValueError):
                bc.decompose_ntt(x, bc.digit_tables(rq.moduli, rqp.moduli,
                                                    3, dev), rqp)
        else:
            assert route(x, rq, rqp, 2) == (0, 1, 1)
            with pytest.raises(ValueError):
                bc.decompose_ntt(x, bc.digit_tables(rq.moduli, rqp.moduli,
                                                    2, dev), rqp)
    params, rlk, _, _, fresh = _fuse_ctx(
        gen, rots=(), params=mkckks.PN14QP433_CNN("cuda"))
    ev = mkckks.Evaluator(params)
    a, b = fresh()
    ev.mul_relin_new(a, b, rlk)
    bc.reset_counters()
    ev.mul_relin_new(a, b, rlk)
    torch.cuda.synchronize()
    assert bc.counters()["decompose_ntt"] == 3
    assert bc.counters()["mod_up"] == 0


def test_decompose_ntt_in_captured_mult(gen):
    """A CKKS mult at PN14QP433_CNN captured into a CUDA graph (fuse.fuse,
    the default capture error mode) with the fused decompositions in it:
    replays on fresh inputs equal eager mul_relin_new bit for bit."""
    from mkhe_tpu_torch import fuse, mkckks
    from mkhe_tpu_torch.ops import basis_cuda as bc
    params, rlk, _, _, fresh = _fuse_ctx(
        gen, rots=(), params=mkckks.PN14QP433_CNN("cuda"))
    ev = mkckks.Evaluator(params)

    def mult(ev, keys, a, b):
        return ev.mul_relin_new(a, b, keys.rlk)

    bc.reset_counters()
    fn, args = fuse.fuse(params, mult, fresh(), rlk_set=rlk)
    assert fn.graph is not None and bc.counters()["decompose_ntt"] > 0
    for _ in range(2):
        a, b = fresh()
        got, want = fn(args[0], args[1], (a, b)), ev.mul_relin_new(a, b, rlk)
        assert got.ids == want.ids and got.scale == want.scale
        assert torch.equal(got.ct.data, want.ct.data)


# ----------------------------------------------------------------------------
# The rescale kernel (csrc/keyswitch.cu::rescale_kernel, basis_cuda.rescale)
# ----------------------------------------------------------------------------

def _config_q(preset):
    """(logN, Q moduli) of a parameter preset, without building it."""
    from mkhe_tpu_torch.mkckks import params as cp
    args = {k: v for k, v in cp._PRESETS[preset].items()
            if k not in ("logslots", "scale")}
    return args["logn"], cp.select_moduli(**args)[0]


@pytest.mark.parametrize("preset", ["PN15QP880", "PN14QP433_CNN"])
def test_rescale_kernel_matches_plain(gen, preset):
    """The rescale kernel against rescale_plain bit for bit at the
    benchmark configurations' Q moduli and N (PN15QP880: logN 15, 28
    limbs, the ckks_pn15qp880_4p cells; PN14QP433_CNN: logN 14, 14 limbs,
    cnn_pn14qp433_2p), for nb = 1, 2, 3 and every L from nb + 1 up: 1-5
    polynomials behind an extra batch axis, a level-dropped view of a
    taller tensor (read by its strides), and views whose batch axes do not
    flatten (copied by the wrapper)."""
    from mkhe_tpu_torch.ops import basis_cuda as bc
    logn, q = _config_q(preset)
    full = Ring.create(q, logn, "cuda")
    base = _rand(gen, (5, 2, len(q) + 1, 1 << logn),
                 torch.tensor(q + q[:1], device="cuda")[:, None])
    cases = 0
    for nb in (1, 2, 3):
        for L in range(nb + 1, len(q) + 1):
            ring = full.take(0, L)
            x = base[:1 + (L + nb) % 5, :, :L]
            views = [x] + ([x.transpose(0, 1)] if L in (nb + 1, len(q))
                           else [])
            for x in views:
                bc.reset_counters()
                got = bc.rescale(x, ring, nb)
                assert bc.counters()["rescale"] == 1
                want = bc.rescale_plain(x, ring, nb)
                torch.cuda.synchronize()
                assert got.shape == want.shape == (*x.shape[:-2], L - nb,
                                                   1 << logn)
                assert got.is_contiguous()
                assert torch.equal(got, want), (nb, L, tuple(x.shape))
                cases += 1
    assert cases == 3 * len(q)


def test_rescale_kernel_in_captured_graph(gen):
    """The rescale wrapper, warmed up once, captures into a CUDA graph in
    the default (global) capture error mode; two replays, the second on
    new input copied into the static one, equal rescale_plain."""
    from mkhe_tpu_torch.ops import basis_cuda as bc
    logn, q = _config_q("PN14QP433_CNN")
    ring = Ring.create(q, logn, "cuda")
    bound = torch.tensor(q + q[:2], device="cuda")[:, None]
    x = _rand(gen, (3, len(q) + 2, 1 << logn), bound)[:, :len(q)]
    bc.rescale(x, ring, 2)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="global"):
        got = bc.rescale(x, ring, 2)
    for replay in range(2):
        if replay:
            x.copy_(_rand(gen, x.shape, bound[:len(q)]))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, bc.rescale_plain(x, ring, 2))


def test_rescale_launches_once_per_op(gen):
    """One mul_relin_new and one mul_ptxt_new each launch the rescale
    kernel exactly once, and no basis conversion of the wide body."""
    import numpy as np
    from mkhe_tpu_torch import mkckks
    from mkhe_tpu_torch.ops import basis_cuda as bc
    params, rlk, _, _, fresh = _fuse_ctx(gen, rots=())
    ev = mkckks.Evaluator(params)
    a, b = fresh()
    pt = torch.from_numpy(mkckks.Encryptor(params, seed=90).encode_msg(
        mkckks.Message(value=np.full(params.slots, 0.25))).astype(
            np.int64)).cuda()
    for call in (lambda: ev.mul_relin_new(a, b, rlk),
                 lambda: ev.mul_ptxt_new(a, pt, params.scale)):
        bc.reset_counters()
        out = call()
        torch.cuda.synchronize()
        assert out.level < a.level
        assert bc.counters()["rescale"] == 1
        assert bc.counters()["basis_wide"] == 0


def test_rescale_wrapper_raises_on_cuda(gen):
    """A modulus of 2^29 or more, a ring on another device and a wrong
    limb count raise on a CUDA tensor (no fallback to the torch chain);
    nothing launches."""
    from mkhe_tpu_torch.ops import basis_cuda as bc
    from mkhe_tpu_torch.ops.primes import _is_prime
    q = ntt_primes(10, 27.0, 4)
    # the first NTT prime for logN 10 above 2^29 (ntt_primes stays below)
    big = (next(p for p in range((1 << 29) + 1, 1 << 30, 1 << 11)
                if _is_prime(p)),)
    x = _rand(gen, (2, 5, 1 << 10), 1 << 27)
    bc.reset_counters()
    with pytest.raises(ValueError, match="2\\^29"):
        bc.rescale(x, Ring.create(q + big, 10, "cuda"), 1)
    with pytest.raises(ValueError):
        bc.rescale(x, Ring.create(q + big, 10, "cpu"), 1)
    with pytest.raises(ValueError):
        bc.rescale(x[:, :4], Ring.create(q + big, 10, "cuda"), 1)
    assert bc.counters()["rescale"] == 0


# ----------------------------------------------------------------------------
# The tensor terms (csrc/keyswitch.cu::tensor_kernel, basis_cuda.tensor_terms)
# ----------------------------------------------------------------------------

_USERS = ("u0", "u1", "u2", "u3")


def _tensor_cases():
    """(name, moduli, logN, batch axes, ids0, ids1, square) at the main
    path's shapes: the CKKS mult (5, 28, 2^15) and a subset of its
    parties, each in both operand orders; the batched BFV mult over R (5,
    B = 2, 56, 2^15); the CNN's (3, 14, 2^14) with disjoint and with equal
    ids; the square; 40 parties, more outputs than one launch holds."""
    q, _, qmul = _ks_moduli(15)
    q14, _, _ = _ks_moduli(14)
    return [
        ("ckks 4 parties", q, 15, (), _USERS, _USERS, False),
        ("ckks subset", q, 15, (), _USERS[1:3], _USERS, False),
        ("ckks subset, operands swapped", q, 15, (), _USERS, _USERS[1:3],
         False),
        ("bfv R batched", q + qmul, 15, (2,), _USERS, _USERS, False),
        ("cnn disjoint", q14[:14], 14, (), _USERS[:1], _USERS[1:2], False),
        ("cnn equal", q14[:14], 14, (), _USERS[:2], _USERS[:2], False),
        ("cnn square", q14[:14], 14, (), _USERS[:2], _USERS[:2], True),
        ("40 parties", q14[:2], 10, (2,), tuple(range(40)),
         tuple(range(0, 40, 2)), False),
    ]


def _tensor_operands(gen, moduli, logn, batch, ids0, ids1, square):
    bound = torch.tensor(moduli, device="cuda")[:, None]
    nt0 = _rand(gen, (1 + len(ids0), *batch, len(moduli), 1 << logn), bound)
    nt1 = nt0 if square else _rand(gen, (1 + len(ids1), *batch, len(moduli),
                                         1 << logn), bound)
    for x in (nt0, nt1):   # the largest sums
        x[..., :4] = bound - 1
    return nt0, nt1


def test_tensor_kernel_matches_plain(gen):
    """The tensor kernel against tensor_terms_plain bit for bit at every
    shape of _tensor_cases; one launch a call, two for 41 outputs."""
    from mkhe_tpu_torch.ops import basis_cuda as bc
    for name, mods, logn, batch, ids0, ids1, square in _tensor_cases():
        nt0, nt1 = _tensor_operands(gen, mods, logn, batch, ids0, ids1,
                                    square)
        ids = tuple(sorted(set(ids0) | set(ids1)))
        t = bc.limb_tables(tuple(mods), torch.device("cuda"))
        bc.reset_counters()
        got = bc.tensor_terms(nt0, nt1, ids0, ids1, ids, t)
        assert bc.counters()["tensor"] == (2 if len(ids) >= 32 else 1), name
        want = bc.tensor_terms_plain(nt0, nt1, ids0, ids1, ids, t)
        torch.cuda.synchronize()
        assert got.shape == want.shape == (1 + len(ids), *nt0.shape[1:])
        assert torch.equal(got, want), name


def test_tensor_kernel_in_captured_graph(gen):
    """The tensor wrapper, warmed up once, captures into a CUDA graph in the
    default (global) capture error mode (its row map rides in the launch's
    parameters); two replays, the second on new inputs copied into the
    static ones, equal tensor_terms_plain."""
    from mkhe_tpu_torch.ops import basis_cuda as bc
    q14, _, _ = _ks_moduli(14)
    mods = tuple(q14[:14])
    nt0, nt1 = _tensor_operands(gen, mods, 14, (), _USERS[:2], _USERS[1:],
                                False)
    ids = _USERS
    t = bc.limb_tables(mods, torch.device("cuda"))
    bc.tensor_terms(nt0, nt1, _USERS[:2], _USERS[1:], ids, t)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="global"):
        got = bc.tensor_terms(nt0, nt1, _USERS[:2], _USERS[1:], ids, t)
    for replay in range(2):
        if replay:
            new0, new1 = _tensor_operands(gen, mods, 14, (), _USERS[:2],
                                          _USERS[1:], False)
            nt0.copy_(new0)
            nt1.copy_(new1)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, bc.tensor_terms_plain(
            nt0, nt1, _USERS[:2], _USERS[1:], ids, t))


def test_tensor_launches_once_per_mult(gen):
    """One mul_relin_new launches the tensor kernel once and runs no
    to_mont chain; mul_ptxt_new launches it never."""
    import numpy as np
    from mkhe_tpu_torch import mkckks
    from mkhe_tpu_torch.ops import basis_cuda as bc
    params, rlk, _, _, fresh = _fuse_ctx(gen, rots=())
    ev = mkckks.Evaluator(params)
    a, b = fresh()
    pt = torch.from_numpy(mkckks.Encryptor(params, seed=90).encode_msg(
        mkckks.Message(value=np.full(params.slots, 0.25))).astype(
            np.int64)).cuda()
    for call, want in ((lambda: ev.mul_relin_new(a, b, rlk), 1),
                       (lambda: ev.mul_relin_new(a, a, rlk), 1),
                       (lambda: ev.mul_ptxt_new(a, pt, params.scale), 0)):
        bc.reset_counters()
        call()
        torch.cuda.synchronize()
        assert bc.counters()["tensor"] == want


def test_tensor_wrapper_raises_on_cuda(gen):
    """Operands that are not contiguous, a start not 16-byte aligned,
    int32, tables on the CPU and a party count that does not match the
    rows raise on a CUDA tensor (no fallback to the torch chain); nothing
    launches."""
    from mkhe_tpu_torch.ops import basis_cuda as bc
    q14, _, _ = _ks_moduli(10)
    mods = tuple(q14[:4])
    ids = _USERS[:2]
    nt0, nt1 = _tensor_operands(gen, mods, 10, (2,), ids, ids, False)
    t = bc.limb_tables(mods, torch.device("cuda"))
    # contiguous, but 8 bytes past an aligned start
    shifted = _rand(gen, (3 * 4 * 1024 + 1,), 1 << 28)[1:].view(3, 4, 1024)
    bc.reset_counters()
    for a, b, tab, i0 in (
            (nt0.transpose(1, 2), nt1.transpose(1, 2), t, ids),
            (shifted, shifted, t, ids),
            (nt0.to(torch.int32), nt1, t, ids),
            (nt0, nt1, bc.limb_tables(mods, torch.device("cpu")), ids),
            (nt0, nt1, t, ids[:1])):
        with pytest.raises((ValueError, TypeError)):
            bc.tensor_terms(a, b, i0, ids, ids, tab)
    assert bc.counters()["tensor"] == 0
