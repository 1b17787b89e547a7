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
  included; the rescale's JAX parity is tests/test_torch_basis.py's;
- the fused decomposition (csrc/ntt.cu's decompose_ntt_kernel): its first
  pass's digit values, emulated from the packed words and the strided
  source as the kernel reads them, against decompose_plain; which route
  ops/basis.decompose_ntt takes; and the kernel's name against the
  benchmark's kernel maps;
- the tensor terms' kernel (csrc/keyswitch.cu::tensor_kernel): its row
  map, its arithmetic emulated in numpy from limb_tables' words (the
  u64 sum, mont_wide, the REDC by 2^64 mod q) against tensor_terms_plain,
  the wrapper's checks, and its name against the kernel maps (none).

logN 8, one torch thread; the kernels themselves run in
tests/test_torch_cuda.py on a card."""

import dataclasses
import itertools
import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mkhe_tpu.ops import basis as jbasis
from mkhe_tpu.ops import modmath as jmm
from mkhe_tpu.ops import ring as jring
from mkhe_tpu.ops.primes import ntt_primes
from mkhe_tpu_torch import config
from mkhe_tpu_torch.mkbfv.params import preset_moduli
from mkhe_tpu_torch.ops import basis, ntt_cuda
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


# -- the wide body (digits of more than WIDE_ALPHA limbs) --------------------

_, PN15_Q, PN15_QMUL, PN15_P = preset_moduli("PN15QP880")


class SharedReads:
    """The shared-memory accesses of an emulated schedule, one warp
    instruction at a time: a 32-bit access is conflict-free where no two
    of its lanes reach one bank at different words; a 16-byte load is one
    address a warp (a broadcast)."""

    def __init__(self):
        self.words = self.vectors = 0
        self.conflicts = []

    def word(self, addr, active):
        for a, m in zip(np.broadcast_to(addr, active.shape).reshape(-1, 32),
                        active.reshape(-1, 32)):
            u = np.unique(a[m])
            if u.size:
                self.words += 1
                if np.unique(u % 32).size != u.size:
                    self.conflicts.append(("word", u))

    def vector(self, addr):
        u = np.unique(addr)
        self.vectors += 1
        if u.size != 1 or u[0] % 4:
            self.conflicts.append(("16 bytes", u))


def _kmax(alpha):
    return next(m for m in (2, 4, 8, 16, 32, 64) if alpha <= m)


def emulate_basis_wide(x3, words, ls, alpha, beta, ld, xq3=None,
                       reads=None):
    """basis_kernel's wide body (csrc/keyswitch.cu::basis_wide) on x3 (P,
    Ls, N) (and xq3 (P, ld, N), ModDown) with the packed words, block by
    block and phase by phase as the kernel runs them: its shared memory
    filled from the table (bc.wide_geometry's layout, each group's qhat
    words at WIDE_STRIDE), y_i spread over the block's threads, v summed
    left to right in float32 by one thread a coefficient, then each warp's
    (group, 32 coefficients) with WIDE_GROUP u64 sums. Every shared read
    goes to `reads` (SharedReads)."""
    reads = reads if reads is not None else SharedReads()
    w = words.astype(np.uint64)
    x3 = x3.numpy().astype(np.uint64) & M32
    xq = None if xq3 is None else xq3.numpy().astype(np.uint64) & M32
    n_polys, _, n = x3.shape
    geo = bc.wide_geometry(alpha, ld)
    C, T, G = bc.WIDE_COEFFS, bc.THREADS, bc.WIDE_GROUP
    ds = 4 * alpha + alpha * ld + ld * (alpha + 1)
    out = np.full((n_polys, beta, ld, n), -1, np.int64)
    tid = np.arange(T)
    lane = np.arange(32)
    for p, k, c0 in itertools.product(range(n_polys), range(beta),
                                      range(0, n, C)):
        tab = w[4 * ld + k * ds:4 * ld + (k + 1) * ds]
        lo, lsd = k * alpha, min(alpha, ls - k * alpha)
        sm = np.zeros(geo.words, np.uint64)
        sm[:4 * ld] = w[:4 * ld]
        sm[geo.src:geo.src + 4 * alpha] = tab[:4 * alpha]
        q_w = np.arange(alpha * geo.row)
        i, t = q_w // geo.row, q_w % bc.WIDE_STRIDE
        j = (q_w % geo.row) // bc.WIDE_STRIDE * G + t
        keep = (t < G) & (j < ld)
        sm[geo.qh + q_w[keep]] = tab[4 * alpha + i[keep] * ld + j[keep]]
        sm[geo.vq:geo.vq + ld * (alpha + 1)] = tab[4 * alpha + alpha * ld:]
        # 1. the y_i, kMax C / T rounds of the block's threads
        for r in range(_kmax(alpha) * C // T):
            wv = r * T + tid
            i, c = wv // C, c0 + wv % C
            act = i < lsd
            valid = act & (c < n)
            xv = np.where(valid, x3[p, np.minimum(lo + i, ls - 1),
                                    np.minimum(c, n - 1)], 0)
            s = [geo.src + 4 * np.minimum(i, alpha - 1) + e for e in range(3)]
            for a in s:
                reads.word(a, act)
            y = _redc(xv * sm[s[2]], sm[s[0]], sm[s[1]])
            sm[geo.ys + wv[act]] = y[act]
        # 2. v, left to right in float32, one thread a coefficient
        vf = np.zeros(C, np.float32)
        for i in range(lsd):
            addr = geo.ys + i * C + np.arange(C)
            reads.word(addr, np.ones(C, bool))
            reads.word(np.full(C, geo.src + 4 * i + 3), np.ones(C, bool))
            inv_b = sm[geo.src + 4 * i + 3:geo.src + 4 * i + 4].astype(
                np.uint32).view(np.float32)[0]
            vf = vf + sm[addr].astype(np.float32) * inv_b
        sm[geo.vs:geo.vs + C] = np.clip(np.floor(vf).astype(np.int64), 0,
                                        lsd).astype(np.uint64)
        # 3. a warp per (group, 32 coefficients)
        for item in range(geo.groups * (C // 32)):
            g, cc = item // (C // 32), item % (C // 32) * 32 + lane
            row = geo.qh + g * bc.WIDE_STRIDE
            acc = np.zeros((G, 32), np.uint64)
            for i in range(lsd):
                reads.word(geo.ys + i * C + cc, np.ones(32, bool))
                for half in (0, 4):
                    reads.vector(np.full(32, row + i * geo.row + half))
                qs = sm[row + i * geo.row:row + i * geo.row + G]
                acc += sm[geo.ys + i * C + cc][None, :] * qs[:, None]
            c = c0 + cc
            act = c < n
            reads.word(geo.vs + cc, act)
            v = sm[geo.vs + cc].astype(np.int64)
            for t in range(G):
                j = g * G + t
                if j >= ld:
                    break
                for e in range(4 if xq is not None else 3):
                    reads.word(np.full(32, 4 * j + e), act)
                q, qn, bar, pinv = sm[4 * j:4 * j + 4]
                vq_addr = geo.vq + j * (alpha + 1) + v
                reads.word(vq_addr, act)
                r = _csub(_mont_wide(acc[t], q, qn, bar) + q - sm[vq_addr], q)
                if xq is not None:
                    xj = _barrett(xq[p, j, np.minimum(c, n - 1)], q, bar)
                    r = _redc(_csub(xj + q - r, q) * pinv, q, qn)
                out[p, k, j, c[act]] = r[act].astype(np.int64)
    return out


def _wide_case(name):
    """(x, src, dst, alpha, Q part or None) of a wide-body case at
    PN15QP880's moduli, the float32 v boundary planted in every digit,
    N = 200 (a ragged last block)."""
    q, qmul, p = PN15_Q, PN15_QMUL, PN15_P
    src, dst, alpha = {
        "Q -> QMul": (q, qmul, 28), "QMul -> Q": (qmul, q, 28),
        "ModDown by QMul": (qmul, q, 28), "Ls 17 -> QMul": (q[:17], qmul, 17),
        "Ls 20 -> QP (5 groups)": (q[:20], q[:28] + p, 20),
        "digits of 12, 28 limbs": (q, qmul[:9], 12)}[name]
    n, seed = 200, len(name)
    x = _rand((2, len(src), n), seed, np.array(src, np.uint64)[:, None])
    x = bc.plant_v_boundary(x, src, alpha, [0, 5, 199])
    xq = (_rand((2, len(dst), n), seed + 1, np.array(dst, np.uint64)[:, None])
          if name.startswith("ModDown") else None)
    return x, src, dst, alpha, xq


@pytest.mark.parametrize("name", ["Q -> QMul", "QMul -> Q", "ModDown by QMul",
                                  "Ls 17 -> QMul", "Ls 20 -> QP (5 groups)",
                                  "digits of 12, 28 limbs"])
def test_wide_basis_schedule(name):
    """The wide body's schedule (emulate_basis_wide) against the plain
    mod_up / decompose / mod_down and today's one-thread-a-coefficient
    arithmetic (emulate_basis), bit for bit, the float32 v boundary
    included: BFV's three 28 -> 28 conversions, a short source (17, 20
    limbs), five groups of output limbs (more than a block's warps), a
    digit axis with a short last digit; every shared read conflict-free,
    the 16-byte qhat loads broadcasts."""
    x, src, dst, alpha, xq = _wide_case(name)
    v32, exact = bc.v_floors(x, src, alpha)
    assert (v32 != exact).any()
    ls, ld, beta = len(src), len(dst), -(-len(src) // alpha)
    assert alpha > bc.WIDE_ALPHA
    cpu = torch.device("cpu")
    if xq is not None:
        t = bc.mod_down_tables(dst, src, cpu)
        want = bc.mod_down_plain(xq, x, t)[:, None]
    elif beta > 1:
        t = bc.digit_tables(src, dst, alpha, cpu)
        want = bc.decompose_plain(x, t)
    else:
        t = bc.mod_up_tables(src, dst, cpu)
        want = bc.mod_up_plain(x, t)[:, None]
    words = t.pack.numpy().view(np.uint32)
    reads = SharedReads()
    got = emulate_basis_wide(x, words, ls, alpha, beta, ld, xq, reads)
    _same(got, want)
    _same(emulate_basis(x, words, ls, alpha, beta, ld, xq), want)
    assert reads.words > 0 and reads.vectors > 0
    assert reads.conflicts == []


def test_wide_body_constants():
    """The wide body's constants and the dispatch in csrc/keyswitch.cu are
    the ones basis_cuda.wide_geometry, the emulation and the wide counter
    assume: digits of more than WIDE_ALPHA limbs reach kMax >= kWideMin,
    and the launch takes wide_words of shared memory."""
    src = (ntt_cuda.CSRC / "keyswitch.cu").read_text()
    const = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(const["kWideGroup"]) == bc.WIDE_GROUP
    assert int(const["kWideStride"]) == bc.WIDE_STRIDE
    assert int(const["kWideCoeffs"]) == bc.WIDE_COEFFS
    assert int(const["kThreads"]) == bc.THREADS
    assert int(const["kWideMin"]) == 2 * bc.WIDE_ALPHA
    assert (f"if (a.alpha <= {bc.WIDE_ALPHA}) return launch_basis<"
            f"{bc.WIDE_ALPHA}, kDown>") in src
    assert bc.WIDE_STRIDE % 4 == 0 and bc.WIDE_GROUP <= bc.WIDE_STRIDE
    assert bc.WIDE_COEFFS % 32 == 0 and bc.THREADS % bc.WIDE_COEFFS == 0
    for alpha, ld in ((28, 28), (17, 28), (64, 64), (9, 1)):
        geo = bc.wide_geometry(alpha, ld)
        assert geo.qh % 4 == 0 and geo.row % 4 == 0   # 16-byte qhat loads
        assert geo.words == (4 * ld + 4 * alpha + alpha * geo.row
                             + ld * (alpha + 1) + (alpha + 1) * bc.WIDE_COEFFS)
        assert 4 * geo.words <= 227 * 1024


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


# -- the fused decomposition (csrc/ntt.cu::decompose_ntt_kernel) -------------

def emulate_digit_values(x3, words, ls, beta, ld, logn):
    """decompose_ntt_kernel's first-pass values on x3 (P, Ls, N) with the
    packed words of digits of two limbs, as csrc/ntt.cu::digit_values
    computes them: the output polynomial pi = (p beta + k) Ld + j, the
    source read from the storage at p sxp + (2 k + i) sxl + c (a one-limb
    last digit reads its limb twice, the second time with a zero
    multiplier), the digit's words at 4 Ld + k ds, y_i by REDC, v from
    fl32(y_0 / b_0) + fl32(y_1 / b_1) in float32 (the floor read from vf +
    2^23 rounded down), cv = -b_0 qhat_0j mod d_j, and one lazy Montgomery
    reduction of y_0 qhat_0j + y_1 qhat_1j + v cv (Barrett of the high
    word, REDC of the low word, no final subtraction)."""
    w = words.astype(np.uint64)
    n = 1 << logn
    sxp, sxl = x3.stride(0), x3.stride(1)
    flat = torch.as_strided(x3, (x3.untyped_storage().nbytes() // 8,),
                            (1,), 0)
    store = flat.numpy().astype(np.uint64) & M32
    ds = 8 + 2 * ld + 3 * ld
    n_polys = x3.shape[0] * beta * ld
    out = np.empty((n_polys, n), np.uint64)
    c = np.arange(n)
    for pi in range(n_polys):
        pk, j = divmod(pi, ld)
        p, k = divmod(pk, beta)
        first = 2 * k
        lsd = min(2, ls - first)
        src = 4 * ld + k * ds
        q, qn, bar = w[4 * j], w[4 * j + 1], w[4 * j + 2]
        b0, bn0, w0, ib0 = w[src:src + 4]
        b1, bn1, w1, ib1 = w[src + 4:src + 8]
        w1 = w1 if lsd > 1 else np.uint64(0)
        h0, h1 = w[src + 8 + j], w[src + 8 + ld + j]
        bm = b0 * h0 % q
        cv = q - bm if bm else np.uint64(0)
        at = x3.storage_offset() + p * sxp + first * sxl + c
        y0 = _redc(store[at] * w0, b0, bn0)
        y1 = _redc(store[at + (sxl if lsd > 1 else 0)] * w1, b1, bn1)
        vf = (y0.astype(np.float32) * np.uint32(ib0).view(np.float32)
              + y1.astype(np.float32) * np.uint32(ib1).view(np.float32))
        total = vf.astype(np.float64) + 2.0 ** 23   # exact
        near = total.astype(np.float32)              # rounded to nearest
        down = np.where(near > total, near - np.float32(1), near)
        v = np.minimum(down.view(np.int32) - 0x4B000000, lsd).astype(
            np.uint64)
        acc = y0 * h0 + y1 * h1 + v * cv
        hi, lo = acc >> S32, acc & M32
        t = (lo + ((lo * qn) & M32) * q) >> S32
        out[pi] = ((hi - ((hi * bar) >> S32) * q) & M32) + t
    return out.reshape(x3.shape[0], beta, ld, n).astype(np.int64)


@pytest.mark.parametrize("alpha,ls", [(2, 7), (2, 6), (2, 5), (2, 3)])
def test_decompose_ntt_digit_values(alpha, ls):
    """The fused kernel's digit values, emulated from DigitTables.pack on
    the (P, Ls, N) view of a level-dropped source (the last digit one
    limb short at an odd Ls), with the float32 v boundary planted: below 3q
    and equal to decompose_plain mod q; the wrapper's CPU route is the
    composition it fuses (decompose_plain, then the plain NTT) and counts
    no launch."""
    src, dst = Q[:ls], Q[:ls] + P
    base = _rand((2, 3, ls + 2, N), seed=60 + 10 * alpha + ls,
                 bound=np.array(Q[:ls + 2], np.uint64)[:, None])
    base[:, :, :ls] = bc.plant_v_boundary(base[:, :, :ls], src, alpha,
                                          [5, 77, 254])
    x = base[:, :, :ls]
    assert not x.is_contiguous()
    v32, exact = bc.v_floors(x, src, alpha)
    assert int((v32 != exact).sum()) > 0
    t = bc.digit_tables(src, dst, alpha, torch.device("cpu"))
    beta = -(-ls // alpha)
    want = bc.decompose_plain(x, t)
    assert want.shape == (2, 3, beta, len(dst), N)
    x3 = bc.polys(x, ls)
    assert x3.stride(1) == N and x3.stride(0) == (ls + 2) * N
    emu = emulate_digit_values(x3, t.pack.numpy().view(np.uint32), ls,
                               beta, len(dst), LOGN).reshape(want.shape)
    dq = np.array(dst, np.int64)[:, None]
    assert (emu < 3 * dq).all()      # the butterflies take < 4q
    _same(emu % dq, want)
    ring = Ring.create(dst, LOGN, "cpu")
    bc.reset_counters()
    got = bc.decompose_ntt(x, t, ring)
    assert bc.counters()["decompose_ntt"] == 0
    _same(got, ntt_cuda.ntt_plain(want, ring.q, ring.bar, ring.psi,
                                  ring.psi_sh))
    with pytest.raises(ValueError):
        bc.decompose_ntt(x, t, Ring.create(dst[:-1], LOGN, "cpu"))


def test_decompose_ntt_route():
    """basis.decompose_ntt fuses only a CUDA tensor's digits of two limbs
    at logN 14 or 15 into a ring whose ntt is the full forward kernel
    (Ring.full_forward): a CPU tensor, alpha 1 or 3, another logN, a ring
    with a dist setting (parallel/coeff_mul.py's) and config.ntt_mxu_tail
    on keep the composition, whose result on the CPU equals the plain
    one."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert bc.DECOMPOSE_NTT_LOGNS == (14, 15)
    for logn in bc.DECOMPOSE_NTT_LOGNS:
        big = Ring.create(ntt_primes(logn, 28.4, 3), logn, "cpu")
        sharded = dataclasses.replace(big, dist=object())
        assert big.full_forward() and basis.fuses(cuda, big, 2)
        assert not basis.fuses(cpu, big, 2)
        assert not basis.fuses(cuda, big, 1)
        assert not basis.fuses(cuda, big, 3)
        assert not sharded.full_forward()
        assert not basis.fuses(cuda, sharded, 2)
        try:
            config.ntt_mxu_tail = True
            assert not big.full_forward()
            assert not basis.fuses(cuda, big, 2)
        finally:
            config.ntt_mxu_tail = False
    src, dst = Q[:6], Q[:6] + P
    ring = Ring.create(dst, LOGN, "cpu")
    assert ring.full_forward() and not basis.fuses(cuda, ring, 2)
    x = _rand((2, 6, N), seed=70, bound=np.array(src, np.uint64)[:, None])
    rq = Ring.create(src, LOGN, "cpu")
    for alpha in (1, 2):
        bc.reset_counters()
        got = basis.decompose_ntt(x, rq, ring, alpha)
        want = ring.ntt(basis.decompose_digits(x, rq, ring, alpha))
        _same(got, want)
        assert bc.counters()["decompose_ntt"] == 0


def test_decompose_ntt_kernel_is_an_ntt_kernel():
    """The kernel mkhe_decompose_ntt launches is declared in csrc/ntt.cu
    under a name that hebench/kernel_maps/ntt.json's fragments match and
    keyswitch.json's do not, so its time counts as NTT time."""
    root = Path(__file__).resolve().parent.parent
    src = (ntt_cuda.CSRC / "ntt.cu").read_text()
    entry = src[src.index('extern "C" int mkhe_decompose_ntt'):]
    launched = set(re.findall(r"kernel(?:\)\(Args\))? = (\w+)<(\d+)>;",
                              entry))
    assert "return launch(kernel, a," in entry
    names = {name for name, _ in launched}
    assert len(names) == 1
    name = names.pop()
    assert sorted(int(logn) for _, logn in launched) == list(
        bc.DECOMPOSE_NTT_LOGNS)
    assert re.search(r"__global__ void __launch_bounds__\(kMaxThreads, 1\)"
                     r"\s+" + name + r"\(const Args in\)", src)
    for _, logn in launched:
        mangled = (f"_ZN12_GLOBAL__N_1{len(name)}{name}ILi{logn}EEEv"
                   "NS_4ArgsE")
        assert ntt_cuda.kernel_name(mangled) == f"{name}<{logn}>"
    maps = {m: json.loads((root / "hebench" / "kernel_maps" / f"{m}.json")
                          .read_text())["kernels"]
            for m in ("ntt", "keyswitch")}
    assert "ntt_kernel" in name and "basis_kernel" not in name
    assert any(f in name for f in maps["ntt"])
    assert not any(f in name for f in maps["keyswitch"])


# -- the tensor terms ------------------------------------------------------------

def emulate_tensor(nt0, nt1, rows, t):
    """tensor_kernel with limb_tables' words, as csrc/keyswitch.cu
    computes it: each output's u64 sum of at most two products, mont_wide
    (acc 2^-32 mod q), then REDC of that times 2^64 mod q."""
    words = t.pack.numpy().view(np.uint32).astype(np.uint64)
    q, qn, bar, r2 = (words[:, i][:, None] for i in range(4))
    a = nt0.numpy().astype(np.uint64) & M32
    b = nt1.numpy().astype(np.uint64) & M32
    out = []
    for r0, r1 in rows:
        acc = np.zeros(a.shape[1:], np.uint64)
        if r1 >= 0:
            acc = acc + a[0] * b[r1]
        if r0 >= 0:
            acc = acc + a[r0] * b[0]
        out.append(_redc(_mont_wide(acc, q, qn, bar) * r2, q, qn))
    return np.stack(out).astype(np.int64)


def test_tensor_rows():
    """The row map: out_0 from both row 0s, then per party of the union
    the row in each operand that holds it, -1 where it lacks the party;
    a party in neither operand raises."""
    assert bc.tensor_rows(("a", "b"), ("a", "b"), ("a", "b")) == (
        (-1, 0), (1, 1), (2, 2))
    assert bc.tensor_rows(("a",), ("b",), ("a", "b")) == (
        (-1, 0), (1, -1), (-1, 1))
    assert bc.tensor_rows(("b",), ("a", "b", "c"), ("a", "b", "c")) == (
        (-1, 0), (-1, 1), (1, 2), (-1, 3))
    with pytest.raises(ValueError):
        bc.tensor_rows(("a",), ("b",), ("a", "c"))


@pytest.mark.parametrize("moduli", ["q", "near_2^29"])
def test_tensor_kernel_arithmetic(moduli):
    """The kernel's word arithmetic equals tensor_terms_plain over 4
    parties in both operands, disjoint ids and a subset, residues 0, 1 and
    q - 1 included (the largest sums, 2 (q - 1)^2 < 2^59)."""
    mods = Q[:6] if moduli == "q" else ntt_primes(LOGN, 28.99, 6)
    t = bc.limb_tables(tuple(mods), torch.device("cpu"))
    q = np.array(mods, np.uint64)[:, None]
    users = ("u0", "u1", "u2", "u3")
    for ids0, ids1 in ((users, users), (users[:1], users[1:2]),
                       (users[2:3], users[:3])):
        ids = tuple(sorted(set(ids0) | set(ids1)))
        nt0 = _rand((1 + len(ids0), 2, len(mods), N), 1, q)
        nt1 = _rand((1 + len(ids1), 2, len(mods), N), 2, q)
        for x in (nt0, nt1):
            x[..., 0] = 0
            x[..., 1] = 1
            x[..., 2:6] = torch.from_numpy(q.astype(np.int64)) - 1
        want = bc.tensor_terms_plain(nt0, nt1, ids0, ids1, ids, t)
        _same(emulate_tensor(nt0, nt1, bc.tensor_rows(ids0, ids1, ids), t),
              want)


def test_tensor_terms_wrapper_checks():
    """Operands whose party rows do not match their ids, whose trailing
    axes differ or whose limbs are not the tables', and an int32 operand,
    raise on the CPU route too; nothing counts as a launch."""
    t = bc.limb_tables(tuple(Q[:4]), torch.device("cpu"))
    x = _rand((3, 4, N), 3, np.array(Q[:4], np.uint64)[:, None])
    ids = ("a", "b")
    bc.reset_counters()
    assert bc.tensor_terms(x, x, ids, ids, ids, t).shape == (3, 4, N)
    for a, b, i0 in ((x, x, ids[:1]), (x, x[..., :N // 2], ids),
                     (x[:, :3], x[:, :3], ids), (x.to(torch.int32), x, ids)):
        with pytest.raises((ValueError, TypeError)):
            bc.tensor_terms(a, b, i0, ids, ids, t)
    assert bc.counters()["tensor"] == 0


def test_tensor_kernel_is_in_no_kernel_map():
    """mkhe_tensor launches csrc/keyswitch.cu's tensor_kernel, a name that
    no fragment of hebench/kernel_maps/*.json matches: hebench/work.py
    counts no words for the tensor terms, so no roofline takes its time."""
    root = Path(__file__).resolve().parent.parent
    src = (ntt_cuda.CSRC / "keyswitch.cu").read_text()
    entry = src[src.index('extern "C" int mkhe_tensor'):]
    assert set(re.findall(r"(\w+)<<<", entry)) == {"tensor_kernel"}
    assert re.search(r"__global__ void __launch_bounds__\(kThreads\)\s+"
                     r"tensor_kernel\(const __grid_constant__ TensorArgs a\)",
                     src)
    for path in (root / "hebench" / "kernel_maps").glob("*.json"):
        for frag in json.loads(path.read_text())["kernels"]:
            assert frag not in "tensor_kernel", (path.name, frag)
