"""The four-step negacyclic NTT plan of the polynomial-sharded transforms.

A copy of the plan part of the JAX package's ``crypto/ntt2.py``
(``NegPlan``, ``make_neg_plan``, ``neg_fwd``, ``neg_inv``), in numpy.  The
polynomial-sharded functions of ``parallel.py`` exist only in this layout:
hats [k2, k1] (flat h = k2*n1 + k1, n1 = 128 lanes, j = j1 + n1*j2), with
the negacyclic twist, 1/N and 256^{-3g} folded into the stage constants
``mf``, ``w1``, ``w1i`` and ``mi``.  The port's own transform
(``crypto/ntt.py``: two primes, bit-reversed order) is another layout, so
it cannot take the same inputs.

    ahat[k2, k1] = sum_j1 w^{n2 j1 k1} S[j1, k2],
    S[j1, k2]    = sum_j2 a[j1, j2] * Mf[j1][j2, k2],
    Mf[j1][j2,k2] = psi^{j1 + n1 j2} * w^{j1 k2 + n1 j2 k2}

(psi a primitive 2N-th root mod p, w = psi^2); the inverse mirrors it.
Every array is a centered residue in [-(p-1)/2, (p-1)/2], and the numpy
transforms here are exact (float64 products of centered residues, sums
below 2^53).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from .ntt import omega_root

LANES = 128
NUM_GROUPS = 3  # shift-plane groups of the external product (256^{-3g})


def _center(x: np.ndarray, p: int) -> np.ndarray:
    """Map residues to the balanced range [-(p-1)/2, p/2]."""
    x = np.mod(x, p)
    return np.where(x > p // 2, x - p, x).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class NegPlan:
    """Twist-folded negacyclic four-step constants for one (prime, N).

    All arrays are centered int64 residues.  Index convention: j = j1 +
    n1*j2, k = n2*k1 + k2; hat layout [k2, k1]."""

    p: int
    n: int
    n1: int
    n2: int
    # forward stage 1 (block-diagonal, twist and twiddle folded):
    # [n1(j1), n2(j2), n2(k2)]
    mf: np.ndarray
    # forward stage 2 (dense): [num_la variants][n1(j1), n1(k1)], 256^la
    # folded
    w1: tuple
    # inverse stage 1 (dense): [n1(k1), n1(j1)]
    w1i: np.ndarray
    # inverse stage 2 (block-diagonal, untwist, twiddle, 1/N and 256^{-3g}
    # folded): [NUM_GROUPS variants][n1(j1), n2(k2), n2(j2)]
    mi: tuple


@functools.lru_cache(maxsize=None)
def make_neg_plan(p: int, n: int, num_la: int = 3) -> NegPlan:
    assert (p - 1) % (2 * n) == 0, (p, n)
    n1 = min(LANES, n)
    n2 = n // n1
    psi = omega_root(p, 2 * n)
    w = psi * psi % p
    wi = pow(w, p - 2, p)
    psii = pow(psi, p - 2, p)
    n_inv = pow(n, p - 2, p)
    inv256 = pow(256, p - 2, p)

    j1 = np.arange(n1)
    j2 = np.arange(n2)
    k1 = np.arange(n1)
    k2 = np.arange(n2)

    def pw(base, e):
        e = np.mod(e, 2 * n)
        flat = np.array([pow(base, int(x), p) for x in e.ravel()],
                        dtype=np.int64)
        return flat.reshape(e.shape)

    # Mf[j1, j2, k2] = psi^{j1 + n1 j2} * w^{j1 k2 + n1 j2 k2}
    twist = pw(psi, j1[:, None, None] + n1 * j2[None, :, None]
               + 0 * k2[None, None, :])
    tw = pw(w, j1[:, None, None] * k2[None, None, :]
            + n1 * j2[None, :, None] * k2[None, None, :])
    mf = _center(twist * tw % p, p)

    # W1[j1, k1] = w^{n2 j1 k1} * 256^{la}
    w1_base = pw(w, n2 * j1[:, None] * k1[None, :])
    w1 = tuple(_center(w1_base * pow(256, la, p) % p, p)
               for la in range(num_la))

    # W1i[k1, j1] = w^{-n2 j1 k1}
    w1i = _center(pw(wi, n2 * j1[None, :] * k1[:, None]), p)

    # Mi[j1, k2, j2] = sigma_g * psi^{-j1 - n1 j2} * w^{-j1 k2 - n1 j2 k2}
    untwist = pw(psii, j1[:, None, None] + 0 * k2[None, :, None]
                 + n1 * j2[None, None, :])
    twi = pw(wi, j1[:, None, None] * k2[None, :, None]
             + n1 * k2[None, :, None] * j2[None, None, :])
    base_mi = untwist * twi % p
    mi = tuple(
        _center(base_mi * (n_inv * pow(inv256, 3 * g, p) % p) % p, p)
        for g in range(NUM_GROUPS))
    return NegPlan(p, n, n1, n2, mf, w1, w1i, mi)


def _bmm_exact(x: np.ndarray, mats: np.ndarray, p: int) -> np.ndarray:
    """Exact batched modular contraction sum_j x[.., a, j] mats[a, j, k] in
    float64 (|x|, |mats| <= p/2 < 2^16, K <= 128: sums < 2^39 < 2^53)."""
    xf = x.astype(np.float64)
    out = np.empty(x.shape[:-1] + (mats.shape[-1],))
    for a in range(mats.shape[0]):
        out[..., a, :] = xf[..., a, :] @ mats[a].astype(np.float64)
    return _center(np.rint(out).astype(np.int64), p)


def neg_fwd(a: np.ndarray, plan: NegPlan, la: int = 0) -> np.ndarray:
    """a int [..., N] -> centered twisted hats [..., N] (flat h = k2*n1 +
    k1): NTT_n(a_j * psi^j) * 256^la, centered mod p."""
    p, n1, n2 = plan.p, plan.n1, plan.n2
    x = a.reshape(a.shape[:-1] + (n2, n1)).astype(np.int64)   # [.., j2, j1]
    xt = np.swapaxes(x, -1, -2)                               # [.., j1, j2]
    # stage 1: S[j1, k2] = sum_j2 x[j1, j2] Mf[j1][j2, k2]
    s = _bmm_exact(_center(xt, p), plan.mf, p)                # [.., j1, k2]
    st = np.swapaxes(s, -1, -2)                               # [.., k2, j1]
    # stage 2: ahat[k2, k1] = sum_j1 S[k2, j1] W1[j1, k1]
    prod = st.astype(np.float64) @ plan.w1[la].astype(np.float64)
    out = _center(np.rint(prod).astype(np.int64), p)          # [.., k2, k1]
    return out.reshape(a.shape[:-1] + (plan.n,))


def neg_inv(ahat: np.ndarray, plan: NegPlan, g: int = 0) -> np.ndarray:
    """Centered hats [..., N] -> centered coefficients of sigma_g * a
    [..., N] (sigma_g = 256^{-3g} / N folded into ``mi``)."""
    p, n1, n2 = plan.p, plan.n1, plan.n2
    c = ahat.reshape(ahat.shape[:-1] + (n2, n1)).astype(np.int64)  # [k2, k1]
    prod = _center(c, p).astype(np.float64) @ plan.w1i.T.astype(np.float64)
    q = _center(np.rint(prod).astype(np.int64), p)             # [.., k2, j1]
    qt = np.swapaxes(q, -1, -2)                                # [.., j1, k2]
    out = _bmm_exact(qt, plan.mi[g], p)                        # [.., j1, j2]
    out = np.swapaxes(out, -1, -2)                             # [.., j2, j1]
    return out.reshape(ahat.shape[:-1] + (plan.n,))
