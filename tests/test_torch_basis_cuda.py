"""The interfaces of the key-switching kernels (csrc/keyswitch.cu through
mkhe_tpu_torch/ops/basis_cuda.py) on the CPU, bit for bit against
mkhe_tpu (tolerance: exact, every output is a canonical residue):

- each wrapper's plain route (mod_up, decompose, mod_down, mul_accum);
- the argument plans the launchers hand the kernels: the (P, Ls, N) view
  of a strided input, the digit axis, and the contraction's term and
  outer axes with broadcast strides (contraction_plan);
- the packed tables and the kernels' arithmetic, emulated in numpy over
  those plans and tables (REDC, the Barrett-folded 64-bit sums, the
  float32 v added left to right), including inputs planted on the float32
  v boundary and contractions of more than 64 terms;
- the rescale kernel's table and word arithmetic (Barrett of the rounded
  limb, the Shoup product) against rescale_plain, boundary values
  included; the rescale's JAX parity is tests/test_torch_basis.py's.

logN 8, one torch thread; the kernels themselves run in
tests/test_torch_cuda.py on a card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mkhe_tpu.ops import basis as jbasis
from mkhe_tpu.ops import modmath as jmm
from mkhe_tpu.ops import ring as jring
from mkhe_tpu.ops.primes import ntt_primes
from mkhe_tpu_torch.ops import basis_cuda as bc
from mkhe_tpu_torch.ops.ring import Ring

torch.set_num_threads(1)

LOGN = 8
N = 1 << LOGN
Q = ntt_primes(LOGN, 28.9, 1) + ntt_primes(LOGN, 27.0, 27)
QMUL = ntt_primes(LOGN, 28.4, 28)
P = ntt_primes(LOGN, 26.0, 4)
M32 = np.uint64(0xFFFFFFFF)
S32 = np.uint64(32)

_j_mod_up = jax.jit(jbasis.mod_up, static_argnames=("lazy",))
_j_mod_down = jax.jit(jbasis.mod_down)
_j_digits = jax.jit(jbasis.decompose_digits, static_argnames=("alpha",))


def _jring(moduli):
    return jring.Ring.create(tuple(moduli), LOGN)


def _rand(shape, seed, bound=1 << 32):
    """int64 tensor of uniform values below bound ((L, 1) or an int)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 62, shape, dtype=np.uint64) % np.asarray(
        bound, np.uint64)
    return torch.from_numpy(x.astype(np.int64))


def _u32(x):
    return jnp.asarray(np.asarray(x).astype(np.uint32))


def _same(got, want):
    np.testing.assert_array_equal(np.asarray(got).astype(np.int64),
                                  np.asarray(want).astype(np.int64))


# -- numpy emulations of the kernels' arithmetic -----------------------------

def _csub(a, q):
    return np.where(a >= q, a - q, a)


def _redc(t, q, qn):
    m = ((t & M32) * qn) & M32
    return _csub((t + m * q) >> S32, q)


def _barrett(a, q, bar):
    return _csub(_csub(a - ((a * bar) >> S32) * q, q), q)


def _mont_wide(acc, q, qn, bar):
    lo = acc & M32
    t = (lo + ((lo * qn) & M32) * q) >> S32
    return _csub(_barrett(acc >> S32, q, bar) + t, q)


def emulate_basis(x3, words, ls, alpha, beta, ld, xq3=None):
    """basis_kernel on x3 (P, Ls, N) (and xq3 (P, ld, N), ModDown) with
    the packed words, as csrc/keyswitch.cu computes it."""
    w = words.astype(np.uint64)
    x3 = x3.numpy().astype(np.uint64) & M32
    dst = w[:4 * ld].reshape(ld, 4)
    ds = 4 * alpha + alpha * ld + ld * (alpha + 1)
    out = np.empty((x3.shape[0], beta, ld, x3.shape[-1]), np.uint64)
    for k in range(beta):
        tab = w[4 * ld + k * ds:4 * ld + (k + 1) * ds]
        src = tab[:4 * alpha].reshape(alpha, 4)
        qhat = tab[4 * alpha:4 * alpha + alpha * ld].reshape(alpha, ld)
        vq = tab[4 * alpha + alpha * ld:].reshape(ld, alpha + 1)
        lsd = min(alpha, ls - k * alpha)
        ys, vf = [], np.zeros(out[:, 0, 0].shape, np.float32)
        for i in range(lsd):
            y = _redc(x3[:, k * alpha + i] * src[i, 2], src[i, 0], src[i, 1])
            inv_b = src[i, 3:4].astype(np.uint32).view(np.float32)[0]
            vf = vf + y.astype(np.float32) * inv_b
            ys.append(y)
        v = np.clip(np.floor(vf).astype(np.int64), 0, lsd)
        for j in range(ld):
            q, qn, bar, pinv = dst[j]
            acc = sum(y * qhat[i, j] for i, y in enumerate(ys))
            r = _csub(_mont_wide(acc, q, qn, bar) + q - vq[j][v], q)
            if xq3 is not None:
                xj = _barrett(xq3[:, j].numpy().astype(np.uint64) & M32, q,
                              bar)
                r = _redc(_csub(xj + q - r, q) * pinv, q, qn)
            out[:, k, j] = r
    return out.astype(np.int64)


def emulate_mul_accum(a, b, plan, t):
    """mul_accum_kernel over the plan's strides (as_strided on a's and b's
    storage) with its fold of the sum every FOLD terms."""
    d, (L, n) = plan.dims, plan.out_shape[-2:]
    size = (*d[0:2], *d[2:5], L, n)
    va = torch.as_strided(a, size, (*d[5:10], d[10], 1),
                          a.storage_offset()).numpy().astype(np.uint64)
    vb = torch.as_strided(b, size, (*d[11:16], d[16], 1),
                          b.storage_offset()).numpy().astype(np.uint64)
    words = t.pack.numpy().view(np.uint32).astype(np.uint64)
    q, qn, bar = (words[:, i][:, None] for i in range(3))
    acc, since = np.zeros(size[2:], np.uint64), 0
    for t0 in range(d[0]):
        for t1 in range(d[1]):
            acc = acc + va[t0, t1] * vb[t0, t1]
            since += 1
            if since == bc.FOLD:
                acc = (_barrett(acc >> S32, q, bar) << S32) | (acc & M32)
                since = 0
    return _mont_wide(acc, q, qn, bar).reshape(plan.out_shape).astype(
        np.int64)


# -- basis extension ---------------------------------------------------------

@pytest.mark.parametrize("ls", [1, 2, 3, 4, 28])
def test_mod_up(ls):
    """Q[:ls] -> QP (ls <= 4) or Q -> QMul (ls = 28, BFV), from a strided
    view with two leading axes, any u32 input, planted float32 v
    boundaries included: the plain route, the kernel's arithmetic on its
    view and table, and the JAX mod_up, reduced, all equal."""
    src = Q[:ls]
    dst = QMUL if ls == 28 else Q + P
    base = _rand((2, 3, ls + 2, N), seed=ls)
    base[:, :, 1:ls + 1, :] = bc.plant_v_boundary(
        base[:, :, 1:ls + 1, :], src, ls, [0, 7, 200])
    x = base[:, :, 1:ls + 1, :]
    assert not x.is_contiguous()
    v32, exact = bc.v_floors(x, src, ls)
    assert int((v32 != exact).sum()) >= 2 * 3 * 3
    t = bc.mod_up_tables(src, dst, torch.device("cpu"))
    got = bc.mod_up(x, t)
    jd = _jring(dst)
    want = jd.reduce(_j_mod_up(_u32(x), _jring(src), jd,
                               jbasis.mod_up_tables(src, dst)))
    _same(got, want)
    x3 = bc.polys(x, ls)
    assert x3.shape == (6, ls, N) and x3.stride(-1) == 1
    emu = emulate_basis(x3, t.pack.numpy().view(np.uint32), ls, ls, 1,
                        len(dst))
    _same(emu.reshape(got.shape), want)


@pytest.mark.parametrize("alpha", [2, 3])
def test_decompose_digits_axis(alpha):
    """Seven limbs in digits of alpha (the last digit shorter) extended to
    QP: one decomposition through the digit axis against the JAX
    decompose_digits (lazy, reduced)."""
    src, dst = Q[:7], Q[:7] + P
    x = bc.plant_v_boundary(_rand((4, 7, N), seed=alpha, bound=np.array(
        src, np.uint64)[:, None]), src, alpha, [3, 100])
    t = bc.digit_tables(src, dst, alpha, torch.device("cpu"))
    beta = -(-7 // alpha)
    assert len(t.digits) == beta
    got = bc.decompose(x, t)
    assert got.shape == (4, beta, len(dst), N)
    jd = _jring(dst)
    want = jd.reduce(_j_digits(_u32(x), _jring(src), jd, alpha=alpha))
    _same(got, want)
    emu = emulate_basis(bc.polys(x, 7), t.pack.numpy().view(np.uint32), 7,
                        alpha, beta, len(dst))
    _same(emu.reshape(got.shape), want)


@pytest.mark.parametrize("lp", [2, 4])
def test_mod_down(lp):
    """round(x / P) from (..., Lq + Lp, N) sliced into its Q and P parts,
    as mod_down_qp slices the inverse NTT's output."""
    qm, pm = Q[:6], P[:lp]
    c = _rand((3, 6 + lp, N), seed=30 + lp,
              bound=np.array(qm + pm, np.uint64)[:, None])
    c[:, 6:, :] = bc.plant_v_boundary(c[:, 6:, :], pm, lp, [1, 2, 250])
    xq, xp = c[:, :6, :], c[:, 6:, :]
    t = bc.mod_down_tables(qm, pm, torch.device("cpu"))
    got = bc.mod_down(xq, xp, t)
    want = _j_mod_down(_u32(xq), _u32(xp), _jring(qm), _jring(pm))
    _same(got, want)
    emu = emulate_basis(bc.polys(xp, lp), t.pack.numpy().view(np.uint32),
                        lp, lp, 1, 6, xq3=bc.polys(xq, 6))
    _same(emu.reshape(got.shape), want)


def test_basis_wrappers_raise():
    """A wrong limb count, a Q / P shape mismatch, tables on another device
    and moduli the kernels cannot take all raise, on the CPU route too."""
    t = bc.mod_up_tables(Q[:2], P, torch.device("cpu"))
    with pytest.raises(ValueError):
        bc.mod_up(_rand((2, 3, N), 0), t)
    with pytest.raises(TypeError):
        bc.mod_up(_rand((2, 2, N), 0).to(torch.int32), t)
    md = bc.mod_down_tables(Q[:3], P[:2], torch.device("cpu"))
    with pytest.raises(ValueError):
        bc.mod_down(_rand((2, 3, N), 0), _rand((3, 2, N), 0), md)
    with pytest.raises(ValueError):
        bc.pack_table(Q[:2], ((1 << 29) + 11,), 2)
    with pytest.raises(ValueError):
        bc.pack_table(Q[:2], Q * 3, 2)       # more than MAX_LIMBS outputs


# -- contractions ------------------------------------------------------------

def _jax_contract(pairs, moduli):
    """(sum a b) 2^-32 mod q with the JAX package's 64-bit accumulate and
    Montgomery reduce, in chunks of 56 terms (its budget) added mod q."""
    q = jnp.asarray(np.array(moduli, np.uint32))[:, None]
    qn = jnp.asarray(np.array([jmm.mont_constants(m)[0] for m in moduli],
                              np.uint32))[:, None]
    bar = jnp.asarray(np.array([jmm.barrett_constant(m) for m in moduli],
                               np.uint32))[:, None]
    total = None
    for c in range(0, len(pairs), 56):
        acc = jmm.mul_accum_init(np.broadcast_shapes(
            *(np.shape(x) for pair in pairs for x in pair)))
        for a, b in pairs[c:c + 56]:
            acc = jmm.mul_accum_step(acc, _u32(a), _u32(b))
        r = jmm.barrett_reduce(jmm.mul_accum_reduce(acc, q, qn), q, bar)
        total = r if total is None else jmm.add_mod(total, r, q)
    return np.asarray(total)


MODS = ntt_primes(LOGN, 28.99, 5)   # products near 2^58: 64 fill a u64
QB = np.array(MODS, np.uint64)[:, None]


def _canon(shape, seed):
    return _rand(shape, seed, QB)


def _case(name):
    """(a, b, nterms, the reference's term pairs) of each caller's
    layout at 5 limbs (k parties, beta digits, B batch, R rotations)."""
    k, beta, B, R = 4, 3, 2, 3
    if name == "parties":            # _aggregate_keys
        a, b = _canon((k, beta, 5, N), 1), _canon((k, beta, 5, N), 2)
        return a, b, 1, [(a[i], b[i]) for i in range(k)]
    if name == "parties_batched":    # _aggregate_keys, (k, B, beta, ...)
        a, b = _canon((k, B, beta, 5, N), 3), _canon((k, beta, 5, N), 4)
        return a, b, 1, [(a[i], b[i]) for i in range(k)]
    if name == "digits_broadcast_key":   # external_product_ntt
        d, key = _canon((k, beta, 5, N), 5), _canon((beta, 5, N), 6)
        return (d.movedim(-3, 0), key.movedim(-3, 0), 1,
                [(d[:, i], key[i]) for i in range(beta)])
    if name == "digits_batched":     # the batched mult's Ext(dec, x)
        d, x = _canon((k, B, beta, 5, N), 7), _canon((B, beta, 5, N), 8)
        return (d.movedim(-3, 0), x.movedim(-3, 0), 1,
                [(d[..., i, :, :], x[..., i, :, :]) for i in range(beta)])
    if name == "rotations":          # rotate_hoisted_batched's Ext
        d = _canon((k, beta, 5, N), 9)[None]
        crs = _canon((R, beta, 5, N), 10)[:, None]
        return (d.movedim(-3, 0), crs.movedim(-3, 0), 1,
                [(d[..., i, :, :], crs[..., i, :, :]) for i in range(beta)])
    if name in ("parties_digits_batched", "over_64_terms"):
        # _sum_parties_ntt over parties_inner's (B, k, beta, ...) digits
        kk, bb = (k, beta) if name != "over_64_terms" else (5, 14)
        d = _canon((kk, B, bb, 5, N), 11).movedim(0, -4)
        v = _canon((kk, bb, 5, N), 12)
        if name == "over_64_terms":   # residues just below q: the u64 sum
            d = torch.from_numpy(QB.astype(np.int64)) - 1 - d % 1024
            v = torch.from_numpy(QB.astype(np.int64)) - 1 - v % 1024
        return (d.movedim((-4, -3), (0, 1)), v.movedim((-4, -3), (0, 1)), 2,
                [(d[..., i, j, :, :], v[i, j]) for i in range(kk)
                 for j in range(bb)])
    if name == "strided_limbs":      # a limb-sliced view of a wider key
        a = _canon((k, beta, 5, N), 13)
        wide = _rand((k, beta, 8, N), 14, np.array(MODS + Q[5:8], np.uint64)[
            :, None])[..., :5, :]
        return a, wide, 1, [(a[i], wide[i]) for i in range(k)]
    raise KeyError(name)


CASES = ("parties", "parties_batched", "digits_broadcast_key",
         "digits_batched", "rotations", "parties_digits_batched",
         "over_64_terms", "strided_limbs")


@pytest.mark.parametrize("name", CASES)
def test_contraction(name):
    """Each caller's layout: the plain route, the kernel's arithmetic over
    the launcher's plan (broadcast operands at stride 0, never copied),
    and the JAX package's accumulate + reduce, all equal."""
    a, b, nterms, pairs = _case(name)
    t = bc.limb_tables(MODS, torch.device("cpu"))
    got = bc.mul_accum(a, b, nterms, t)
    want = _jax_contract(pairs, MODS)
    _same(got, want)
    plan = bc.contraction_plan(a, b, nterms, 5)
    assert plan.out_shape == tuple(got.shape)
    assert len(plan.dims) == 17 and min(plan.dims[:5]) >= 1
    _same(emulate_mul_accum(a, b, plan, t), want)
    if name == "over_64_terms":
        assert plan.dims[0] * plan.dims[1] == 70 > 2 * bc.FOLD
    if name == "digits_broadcast_key":
        # the key is read in place across the parties: stride 0
        assert 0 in plan.dims[13:16] and plan.dims[3:5] == (1, 4)


def test_contraction_plan_raises():
    """Axes that do not merge beyond the kernel's two term and three outer
    axes, limb or N mismatches and zero terms raise."""
    t = bc.limb_tables(MODS, torch.device("cpu"))
    a = _canon((2, 3, 5, N), 1)
    with pytest.raises(ValueError):
        bc.mul_accum(a, _canon((2, 3, 4, N), 1), 1,
                     bc.limb_tables(MODS[:4], torch.device("cpu")))
    with pytest.raises(ValueError):
        bc.mul_accum(a[:0], a[:0], 1, t)
    # outer axes (2, 3, 2, 3) stepping differently in a and b: 4 axes
    x = _canon((1, 2, 3, 2, 3, 5, N), 2)
    y = _canon((1, 3, 2, 3, 2, 5, N), 3).permute(0, 2, 1, 4, 3, 5, 6)
    with pytest.raises(ValueError):
        bc.mul_accum(x, y, 1, t)
    # the same axes merge when both step alike: a plan of 1 outer axis
    plan = bc.contraction_plan(x, x, 1, 5)
    assert plan.dims[2:5] == (1, 1, 36)


# -- the rescale ---------------------------------------------------------------

def emulate_rescale(x3, words, L, nb):
    """rescale_kernel on x3 (P, L, N) with its packed words, as
    csrc/keyswitch.cu computes it: the dropped limbs' chain first, then
    every step on each kept limb (Barrett of the rounded limb, the sum
    below 3q, the Shoup product), in u32 words."""
    w = words.astype(np.uint64)
    x3 = x3.numpy().astype(np.uint64) & M32
    limb = w[:2 * L].reshape(L, 2)
    step = w[2 * L:].reshape(nb, L, 3)

    def one(v, t, s, j):
        q, bar = limb[j]
        a = (v + step[s, j, 0] - _barrett(t, q, bar)) & M32
        return _csub((a * step[s, j, 1] - ((a * step[s, j, 2]) >> S32) * q)
                     & M32, q)

    d = [x3[:, L - 1 - s] for s in range(nb)]
    t = []
    for s in range(nb):
        ql = limb[L - 1 - s, 0]
        t.append(_csub(d[s] + (ql >> np.uint64(1)), ql))
        for r in range(s + 1, nb):
            d[r] = one(d[r], t[s], s, L - 1 - r)
    out = np.empty((x3.shape[0], L - nb, x3.shape[-1]), np.uint64)
    for j in range(L - nb):
        v = x3[:, j]
        for s in range(nb):
            v = one(v, t[s], s, j)
        out[:, j] = v
    return out.astype(np.int64)


# the suite's Q; the largest modulus last (the rounded limb above every
# other modulus); moduli just below 2^29 (the step's sum near 3q)
RESCALE_MODULI = {"q": Q, "largest_last": Q[1:8] + Q[:1],
                  "near_2^29": ntt_primes(LOGN, 28.99, 6)}


def _rescale_input(moduli, nb, seed):
    """Canonical (2, 3, L + 2, N) sliced to a level-dropped (2, 3, L, N)
    view, with the boundary values in its first columns: every kept limb
    at 0, 1 or q_j - 1 against every dropped limb at 0, 1, q_l - 1,
    q_l // 2 or q_l // 2 + 1."""
    L = len(moduli)
    bound = np.array(moduli + moduli[:2], np.uint64)[:, None]
    base = _rand((2, 3, L + 2, N), seed, bound)
    x = base[:, :, :L, :]
    q = torch.tensor(moduli)
    kept = {0: torch.zeros_like(q), 1: torch.ones_like(q), 2: q - 1}
    dropped = {0: torch.zeros_like(q), 1: torch.ones_like(q), 2: q - 1,
               3: q // 2, 4: q // 2 + 1}
    col = 0
    for kv in kept.values():
        for dv in dropped.values():
            x[..., :L - nb, col] = kv[:L - nb]
            x[..., L - nb:, col] = dv[L - nb:]
            col += 1
    return x


@pytest.mark.parametrize("name", sorted(RESCALE_MODULI))
@pytest.mark.parametrize("nb", [1, 2, 3])
def test_rescale_kernel_arithmetic(name, nb):
    """The kernel's word arithmetic, emulated on its (P, L, N) view of a
    level-dropped input and its table, equals rescale_plain (the torch
    chain) on random canonical inputs and the boundary values; the CPU
    route is the plain version and counts no launch."""
    moduli = RESCALE_MODULI[name]
    L = len(moduli)
    ring = Ring.create(moduli, LOGN, "cpu")
    x = _rescale_input(moduli, nb, seed=50 + nb)
    assert not x.is_contiguous()
    want = bc.rescale_plain(x, ring, nb)
    assert want.shape == (2, 3, L - nb, N)
    bc.reset_counters()
    _same(bc.rescale(x, ring, nb), want)
    assert bc.counters()["rescale"] == 0
    x3 = bc.polys(x, L)
    assert x3.shape == (6, L, N) and x3.stride(-1) == 1
    emu = emulate_rescale(x3, bc.rescale_table(moduli, nb), L, nb)
    _same(emu.reshape(want.shape), want)


@pytest.mark.parametrize("nb", [1, 2, 3])
def test_rescale_table_words(nb):
    """Each word of the rescale table against its formula: q_j and
    floor(2^32 / q_j) a limb; q_j + floor(q_l / 2) mod q_j, q_l^-1 mod
    q_j and its Shoup word for each step's lower limbs; 0 above them."""
    moduli = RESCALE_MODULI["largest_last"]
    L = len(moduli)
    w = bc.rescale_table(moduli, nb).astype(np.int64)
    assert w.shape == ((2 + 3 * nb) * L,)
    for j, q in enumerate(moduli):
        assert tuple(w[2 * j:2 * j + 2]) == (q, (1 << 32) // q)
    step = w[2 * L:].reshape(nb, L, 3)
    for s in range(nb):
        ql = moduli[L - 1 - s]
        for j, q in enumerate(moduli):
            if j >= L - 1 - s:
                assert not step[s, j].any()
                continue
            half, inv, sh = (int(v) for v in step[s, j])
            assert half == q + (ql // 2) % q
            assert inv < q and inv * ql % q == 1
            assert sh == (inv << 32) // q


def test_rescale_raises():
    """Limb counts, nb and types the wrapper does not take raise on the
    CPU route too; the table refuses moduli of 2^29 or more, even moduli,
    more dropped limbs than the kernel holds and a table over 48 KiB."""
    ring = Ring.create(Q[:5], LOGN, "cpu")
    x = _rand((2, 5, N), 0, np.array(Q[:5], np.uint64)[:, None])
    for bad_nb in (0, 5):
        with pytest.raises(ValueError):
            bc.rescale(x, ring, bad_nb)
    with pytest.raises(ValueError):
        bc.rescale(x[:, :4], ring, 1)
    with pytest.raises(TypeError):
        bc.rescale(x.to(torch.int32), ring, 1)
    for moduli, nb in ((Q[:3] + ((1 << 29) + 1,), 1), (Q[:3] + (1 << 20,), 1),
                       (Q[:10], bc.MAX_DROP + 1), (Q * 200, 2)):
        with pytest.raises(ValueError):
            bc.rescale_table(moduli, nb)
