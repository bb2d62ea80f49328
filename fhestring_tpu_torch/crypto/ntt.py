"""Negacyclic number-theoretic transform over the two turbo CRT primes.

Residues mod p are held in [0, p) in int64 tensors; every product of two
residues is below 2**32, so int64 arithmetic is exact.  The transform is the
textbook pair for Z_p[X]/(X^N + 1) with psi a primitive 2N-th root of unity:

- ``ntt_fwd``: Cooley-Tukey butterflies, natural order in, bit-reversed
  order out, twiddles psi^bitrev(k);
- ``ntt_inv``: Gentleman-Sande butterflies, bit-reversed in, natural out,
  twiddles psi^-bitrev(k), WITHOUT the final 1/N scaling.  The key hats
  carry that factor instead (``key_hats``), so
  ``ntt_inv(ntt_fwd(a) * key_hats(b))`` is the negacyclic product a * b
  mod p.

The CUDA kernels (``csrc/blind_rotate32.cu``, ``csrc/blind_rotate64.cu``)
run exactly these butterflies with the twiddle tables of ``twiddles``;
these torch versions are their plain counterparts and pack the bootstrap
keys.  Both primes are processed at once: a leading axis of size 2 selects
the prime.  ``crt_centered`` rebuilds |W| < M/2 from the two residues.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# Two NTT primes == 1 (mod 4096): negacyclic N for all N <= 2048.  Their
# product M = 2,516,684,801 bounds what the CRT reconstructs: |W| < M/2.
PRIMES = (40961, 61441)
M = PRIMES[0] * PRIMES[1]


def _find_generator(p: int) -> int:
    """Smallest generator of (Z/p)*."""
    factors = []
    n = p - 1
    d = 2
    while d * d <= n:
        if n % d == 0:
            factors.append(d)
            while n % d == 0:
                n //= d
        d += 1
    if n > 1:
        factors.append(n)
    for g in range(2, p):
        if all(pow(g, (p - 1) // f, p) != 1 for f in factors):
            return g
    raise ValueError(p)


@functools.lru_cache(maxsize=None)
def omega_root(p: int, length: int) -> int:
    """A primitive `length`-th root of unity mod p."""
    assert (p - 1) % length == 0, (p, length)
    g = _find_generator(p)
    w = pow(g, (p - 1) // length, p)
    assert pow(w, length, p) == 1 and pow(w, length // 2, p) != 1
    return w


@functools.lru_cache(maxsize=None)
def twiddles(n: int) -> np.ndarray:
    """int64 [prime, (forward, inverse), n]: psi^bitrev(k) and
    psi^-bitrev(k) mod p, bit reversal over log2(n) bits."""
    log_n = n.bit_length() - 1
    assert 1 << log_n == n
    rev = np.array([int(format(k, f"0{log_n}b")[::-1], 2) if log_n else 0
                    for k in range(n)])
    out = np.zeros((len(PRIMES), 2, n), np.int64)
    for pi, p in enumerate(PRIMES):
        psi = omega_root(p, 2 * n)
        psi_inv = pow(psi, p - 2, p)
        out[pi, 0] = [pow(psi, int(e), p) for e in rev]
        out[pi, 1] = [pow(psi_inv, int(e), p) for e in rev]
    return out


@functools.lru_cache(maxsize=None)
def device_twiddles(n: int, device: str) -> torch.Tensor:
    """``twiddles(n)`` as an int64 tensor on ``device``, for the plain
    versions (the kernels read ``kernel_twiddles``)."""
    return torch.from_numpy(twiddles(n)).to(device)


@functools.lru_cache(maxsize=None)
def kernel_twiddles(n: int, device: str) -> torch.Tensor:
    """The CUDA kernels' twiddle table, int32 (u32 bits) [prime, (forward,
    inverse), n, 2]: each twiddle w of ``twiddles(n)`` with its Shoup
    quotient floor(w * 2**32 / p), which turns a product by w mod p into
    two multiplies and a multiply-high (``csrc/ntt64.cuh``: mul_shoup)."""
    tw = twiddles(n)
    p = np.array(PRIMES, np.int64).reshape(-1, 1, 1)
    table = np.stack([tw, (tw << 32) // p], axis=-1).astype(np.uint32)
    return torch.from_numpy(table.view(np.int32)).to(device)


def crt_centered(res: torch.Tensor) -> torch.Tensor:
    """Residues int64 [2, ...] (mod PRIMES[0], PRIMES[1]) -> the integer W
    with |W| < M/2 they represent (centered Garner CRT), int64 [...]."""
    p0, p1 = PRIMES
    x2 = (res[1] - res[0]) % p1 * pow(p0, p1 - 2, p1) % p1
    v = res[0] + p0 * x2                                   # [0, M)
    return torch.where(v > M // 2, v - M, v)


def _moduli(device) -> torch.Tensor:
    return torch.tensor(PRIMES, dtype=torch.int64, device=device)


def ntt_fwd(x: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """x int64 [2, ..., n] residues (prime on axis 0); tw int64 [2, 2, n]
    from ``twiddles``.  Returns the bit-reversed negacyclic transform,
    residues in [0, p).

    The sums u +- v are left unreduced between stages (|values| grow by at
    most p per stage, far inside int64) and reduced once at the end; only
    the twiddle products are reduced per stage.  The result is the same
    residue the kernel's per-stage reductions give."""
    P, n = x.shape[0], x.shape[-1]
    p = _moduli(x.device).view(P, 1, 1, 1)
    y = x.reshape(P, -1, n)
    m, t = 1, n // 2
    while m < n:
        y = y.view(P, -1, m, 2, t)
        s = tw[:, 0, m:2 * m].view(P, 1, m, 1)
        u, v = y[:, :, :, 0], y[:, :, :, 1] * s % p
        y = torch.stack((u + v, u - v), dim=3)
        m, t = 2 * m, t // 2
    return (y % p.view(P, 1, 1, 1, 1)).reshape(x.shape)


def ntt_inv(x: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """Inverse of ``ntt_fwd`` up to the factor N (no 1/N scaling), residues
    in [0, p); the sums are reduced lazily as in ``ntt_fwd``."""
    P, n = x.shape[0], x.shape[-1]
    p = _moduli(x.device).view(P, 1, 1, 1)
    y = x.reshape(P, -1, n)
    h, t = n // 2, 1
    while h >= 1:
        y = y.view(P, -1, h, 2, t)
        s = tw[:, 1, h:2 * h].view(P, 1, h, 1)
        u, v = y[:, :, :, 0], y[:, :, :, 1]
        y = torch.stack((u + v, (u - v) * s % p), dim=3)
        h, t = h // 2, 2 * t
    return (y % p.view(P, 1, 1, 1, 1)).reshape(x.shape)


def key_hats(polys: torch.Tensor) -> torch.Tensor:
    """Small signed integer polys int64 [..., n] -> int64 [2, ..., n]:
    forward transforms per prime with 1/N folded in, residues in [0, p)."""
    n = polys.shape[-1]
    p = _moduli(polys.device).view((2,) + (1,) * polys.dim())
    tw = device_twiddles(n, str(polys.device))
    hats = ntt_fwd(polys.unsqueeze(0) % p, tw)
    n_inv = torch.tensor([pow(n, q - 2, q) for q in PRIMES],
                         dtype=torch.int64, device=polys.device)
    return hats * n_inv.view(p.shape) % p
