"""The benchmark's own TFHE key generation, encryption and decryption.

Every input of a run is made here from ``--seed``: the secret keys, the
raw evaluation keys (bootstrap key and keyswitch key, which the program
packs) and every request's ciphertexts.  Decryption and the noise reading
of the program's results are here too.  This module imports nothing of the
program: it follows the scheme as the configuration file states it
(``params``), in plain PyTorch on the device the run uses, in a few large
calls.

Torus elements are int64 tensors holding the u64 residue's bits, so sums
and products wrap mod 2**64.  Layouts, which the program's packing reads:

- bootstrap key ``bsk``: [n, (k+1)*ell, k+1, N], row ``r*ell + lev`` a GLWE
  encryption of zero with ``bit_j * 2**(64 - base_log*(lev+1))`` added to
  coefficient 0 of polynomial ``r``;
- keyswitch key ``ksk``: [k*N, ks_level, n+1], ``ksk[i, lev]`` an LWE
  encryption under the small key of ``big_sk[i] * 2**(64 -
  ks_base_log*(lev+1))``;
- a ciphertext at rest: [..., k*N+1] under the flattened GLWE key, mask
  first, body last, with the GLWE noise.

A value v of a 2-bit block is encoded as ``v * delta``, delta = 2**64 /
(2 * message_modulus * carry_modulus); a char is 4 blocks, low bits first.
"""

from __future__ import annotations

import dataclasses

import torch

NB = 4  # blocks per char
LIMB = 16  # bits per limb of the exact float64 negacyclic products


@dataclasses.dataclass
class Secret:
    lwe: torch.Tensor   # int64 [n] in {0, 1}
    glwe: torch.Tensor  # int64 [k, N] in {0, 1}

    @property
    def big(self) -> torch.Tensor:
        return self.glwe.reshape(-1)


def delta(p: dict) -> int:
    return (1 << 64) // (2 * p["message_modulus"] * p["carry_modulus"])


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded by any whole number."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


def uniform(shape, g: torch.Generator, torus_bits: int) -> torch.Tensor:
    """Uniform torus elements in the 2**(64 - torus_bits) subgroup."""
    dev = g.device
    hi = torch.randint(0, 1 << 32, shape, generator=g, device=dev)
    lo = torch.randint(0, 1 << 32, shape, generator=g, device=dev)
    a = (hi << 32) | lo
    if torus_bits < 64:
        a &= -(1 << (64 - torus_bits))
    return a


def noise(std: float, shape, g: torch.Generator, torus_bits: int
          ) -> torch.Tensor:
    """Gaussian noise of relative std ``std``, quantized to the subgroup."""
    if std == 0.0:
        return torch.zeros(shape, dtype=torch.int64, device=g.device)
    e = torch.randn(shape, generator=g, device=g.device, dtype=torch.float64)
    e = torch.round(e * (std * 2.0 ** torus_bits)).to(torch.int64)
    return e * (1 << (64 - torus_bits))


def negacyclic_times_binary(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """a [..., N] (torus) times the binary polynomial s [N] mod X^N + 1,
    exactly: 16-bit limbs of a against the signed 0/1 matrix of s, in
    float64, where every partial sum is an integer below 2**27."""
    N = s.shape[-1]
    j = torch.arange(N, device=s.device)
    t = j[None, :] - j[:, None]                 # t - j for row j, column t
    mat = s[t % N].to(torch.float64)
    mat = torch.where(t >= 0, mat, -mat)        # X^N = -1
    flat = a.reshape(-1, N)
    out = torch.zeros_like(flat)
    for limb in range(64 // LIMB):
        part = ((flat >> (LIMB * limb)) & ((1 << LIMB) - 1)).to(torch.float64)
        out += torch.round(part @ mat).to(torch.int64) << (LIMB * limb)
    return out.reshape(a.shape)


def keygen(p: dict, g: torch.Generator) -> tuple[Secret, torch.Tensor,
                                                  torch.Tensor]:
    """(secret keys, bsk, ksk) of the parameter set ``p`` from ``g``."""
    n, k, N = p["lwe_dimension"], p["glwe_dimension"], p["polynomial_size"]
    ell, tb = p["pbs_level"], p["torus_bits"]
    dev = g.device
    secret = Secret(torch.randint(0, 2, (n,), generator=g, device=dev),
                    torch.randint(0, 2, (k, N), generator=g, device=dev))

    rows = n * (k + 1) * ell
    masks = uniform((rows, k, N), g, tb)
    body = noise(p["glwe_noise_std"], (rows, N), g, tb)
    for i in range(k):
        body += negacyclic_times_binary(masks[:, i], secret.glwe[i])
    bsk = torch.cat([masks, body[:, None]], dim=1).view(n, k + 1, ell, k + 1,
                                                        N)
    for lev in range(ell):
        gadget = 1 << (64 - p["pbs_base_log"] * (lev + 1))
        for r in range(k + 1):
            bsk[:, r, lev, r, 0] += secret.lwe * gadget
    bsk = bsk.reshape(n, (k + 1) * ell, k + 1, N)

    big = secret.big
    gadgets = torch.tensor([1 << (64 - p["ks_base_log"] * (v + 1))
                            for v in range(p["ks_level"])],
                           dtype=torch.int64, device=dev)
    a = uniform((k * N, p["ks_level"], n), g, tb)
    b = ((a * secret.lwe).sum(-1, dtype=torch.int64) + big[:, None] * gadgets
         + noise(p["lwe_noise_std"], (k * N, p["ks_level"]), g, tb))
    ksk = torch.cat([a, b[..., None]], dim=-1)
    return secret, bsk, ksk


def encrypt_blocks(p: dict, secret: Secret, values: torch.Tensor,
                   g: torch.Generator) -> torch.Tensor:
    """Block values (int64, any shape) -> ciphertexts [..., kN+1]."""
    tb = p["torus_bits"]
    big = secret.big
    a = uniform(tuple(values.shape) + (big.shape[0],), g, tb)
    b = ((a * big).sum(-1, dtype=torch.int64) + values * delta(p)
         + noise(p["glwe_noise_std"], tuple(values.shape), g, tb))
    return torch.cat([a, b[..., None]], dim=-1)


def char_blocks(data: torch.Tensor) -> torch.Tensor:
    """Bytes (int64 [...]) -> their 4 two-bit blocks [..., 4], low first."""
    shifts = 2 * torch.arange(NB, device=data.device)
    return (data[..., None] >> shifts) & 3


def encrypt_bytes(p: dict, secret: Secret, data: torch.Tensor,
                  g: torch.Generator) -> torch.Tensor:
    """Bytes [...] -> ciphertexts [..., 4, kN+1]."""
    return encrypt_blocks(p, secret, char_blocks(data.to(torch.int64)), g)


def phase(secret: Secret, ct: torch.Tensor) -> torch.Tensor:
    """b - <a, s> of ciphertexts [..., kN+1] (wrapping int64)."""
    big = secret.big
    return ct[..., -1] - (ct[..., :-1] * big).sum(-1, dtype=torch.int64)


def decode(p: dict, ph: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(block values in [0, message*carry), noise share) of phases: the
    value is the phase rounded to the nearest multiple of delta, as the
    client decodes it; the noise share is the distance to that multiple
    over half a slot (delta / 2), where 1 is a decryption failure."""
    d = delta(p)
    half = d // 2
    shifted = ph + half
    value = ((shifted >> (d.bit_length() - 1))
             & (2 * p["message_modulus"] * p["carry_modulus"] - 1))
    value %= p["message_modulus"] * p["carry_modulus"]
    err = (shifted & (d - 1)) - half
    return value, err.abs().to(torch.float64) / half


def decrypt_bytes(p: dict, secret: Secret, ct: torch.Tensor
                  ) -> tuple[torch.Tensor, float]:
    """Ciphertexts [..., 4, kN+1] -> (bytes [...], widest noise share)."""
    value, share = decode(p, phase(secret, ct))
    shifts = 2 * torch.arange(NB, device=ct.device)
    data = ((value % 4) << shifts).sum(-1) % 256
    return data, float(share.max()) if share.numel() else 0.0
