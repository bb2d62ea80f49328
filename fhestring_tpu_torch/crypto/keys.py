"""Device-format key material for the PyTorch PBS pipeline.

Host keygen lives in ``numpy_ref`` (client side, CPU) or the native keygen;
this module packs the server-side evaluation keys into the layouts the
device path reads:

- Keyswitch key: balanced int8 limb planes flattened for one
  ``[B, kN*ks_level] @ [kN*ks_level, (n+1)*P]`` int8 matmul with int32
  accumulation.  A 64-bit-torus key keeps all P = 8 byte planes
  (PARAM_PROD: [10240, 5944]); a 32-bit-torus key has only P = 4 nonzero
  ones (the low 4 of the u64 value are zero).  The columns are zero-padded
  to a multiple of 8, which CUDA's ``torch._int_mm`` requires (turbo:
  2972 -> 2976).
- Bootstrap key: the NTT-domain layout of the blind-rotation kernel of the
  torus family, int16 [n, 2(prime), R, (k+1)*P, N]: the forward transforms
  (1/N folded in) of the P balanced byte limbs of each key value, as u16
  residues stored in int16 bits.  P = 4 limbs of the u32 payload
  (``kernels/blind_rotate32.py``) or P = 8 limbs of the u64 value
  (``kernels/blind_rotate64.py``, whose step ``kernels/ntt_ext.py`` reads
  it too).  Packed unless ``with_ntt2=False``.
- Bootstrap key limbs: int8 [n, R, k+1, 8, 2N], for the step-wise
  external product (``kernels/ext_product.py``): the 8 balanced byte-limb
  planes of each key poly doubled with its negation, P = (K, -K), each
  plane reversed: plane[i] = limb(P)[-i mod 2N].  The limbs of -K are those
  of the negated u64 value (-(-128) is no int8).  Reversed, the 4
  consecutive digit indices of one tensor-core fragment word are 4
  ascending bytes.  The R = (k+1)*ell rows are level-major (row lev*(k+1)
  + r), so that each gadget level's (k+1) x (k+1) polys are one
  contiguous key for one launch of the external product; the JAX rows are
  r*ell + lev, the same order when ell = 1.  Un-reversed and in the JAX
  row order (``jax_bsk_limbs``) this is the JAX ``bsk_limbs``; the JAX
  kernel's further doubling to 4N is a layout for the TPU's lanes and is
  not kept.  Packed for every 64-bit set, and for a 32-bit set without
  its NTT-domain key.  PARAM_PROD: 97.3 MB; turbo: 292 MB.
- LUT bank: doubled test polynomials, int64 torus [L, 2N].

These replace the JAX package's ``crypto/keys.py`` layouts; the numpy
``ServerKeys`` of ``numpy_ref`` (or of the JAX package, which has the same
arrays) is the common input.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import torus
from ..numpy_ref import core as ref
from ..params import CryptoParams
from . import ntt

KEY_PLANES = 4  # nonzero byte limbs of a 32-bit-subgroup key value
KEY_PLANES64 = 8  # byte limbs of a 64-bit key value
_STEP_CHUNK = 64  # bootstrap-key steps transformed at once while packing


def key_planes(p: CryptoParams) -> int:
    """Byte-limb planes of the family's key values: 4 (32-bit) or 8."""
    return KEY_PLANES if p.torus_bits == 32 else KEY_PLANES64


@dataclasses.dataclass
class DeviceServerKeys:
    params: CryptoParams
    # int8 [kN*ks_level, ks_cols]: KSK limb planes for the KS matmul; the
    # first (n+1)*key_planes(params) columns are live, the rest are zero
    # padding.
    ksk_limbs: torch.Tensor
    # int16 [n, 2(prime), R, (k+1)*4, N]: NTT-domain bootstrap key of a
    # 32-bit-torus set, else None.
    bsk_ntt32: torch.Tensor | None = None
    # int16 [n, 2(prime), R, (k+1)*8, N]: NTT-domain bootstrap key of a
    # 64-bit-torus set, else None.
    bsk_ntt64: torch.Tensor | None = None
    # int8 [n, R, k+1, 8, 2N]: reversed byte-limb planes of the doubled polys
    # of the bootstrap key, rows level-major (the step-wise routes), or None.
    bsk_limbs: torch.Tensor | None = None

    @property
    def device(self) -> torch.device:
        return self.ksk_limbs.device

    @property
    def ntt_key(self) -> torch.Tensor | None:
        """The family's NTT-domain key, or None where it was not packed."""
        return getattr(self, ntt_field(self.params))


def ntt_field(p: CryptoParams) -> str:
    """The ``DeviceServerKeys`` field of the family's NTT-domain key."""
    return "bsk_ntt32" if p.torus_bits == 32 else "bsk_ntt64"


def balanced_limbs(values: torch.Tensor, num_limbs: int) -> torch.Tensor:
    """Integers -> balanced base-256 limbs [..., num_limbs] in [-128, 127],
    values == sum_i limbs[i] * 256**i modulo 256**num_limbs."""
    out = []
    state = values
    for _ in range(num_limbs):
        d = ((state + 128) & 255) - 128
        out.append(d)
        state = (state - d) >> 8
    return torch.stack(out, dim=-1)


def _u16_bits(x: torch.Tensor) -> torch.Tensor:
    """Residues in [0, 65536) -> int16 tensor holding the same 16 bits."""
    return torch.where(x >= 1 << 15, x - (1 << 16), x).to(torch.int16)


def pack_bsk_hats(bsk, device, planes: int) -> torch.Tensor:
    """u64 [n, R, k+1, N] key polys (numpy or int64 tensor) -> int16
    [n, 2, R, (k+1)*planes, N] kernel key, packed on ``device`` in chunks
    of steps: the hats of the balanced byte limbs of the u32 payload
    (planes = KEY_PLANES: subgroup-valued keys, ``blind_rotate32``) or of
    the whole u64 value (planes = KEY_PLANES64, limb 7's carry dropped as
    in ``fhestring_tpu.crypto.keys.balanced_limbs_u64``: ``blind_rotate64``).
    """
    bsk = bsk if torch.is_tensor(bsk) else torus.from_numpy(bsk)
    n_steps, R, kp1, N = bsk.shape
    out = torch.empty((n_steps, len(ntt.PRIMES), R, kp1 * planes, N),
                      dtype=torch.int16, device=device)
    for s in range(0, n_steps, _STEP_CHUNK):
        chunk = bsk[s:s + _STEP_CHUNK].to(device)
        if planes == KEY_PLANES:
            if bool((chunk & torus.MASK32).any()):
                raise ValueError("bootstrap key not in the 32-bit subgroup")
            chunk = (chunk >> 32) & torus.MASK32
        limbs = balanced_limbs(chunk, planes)           # [c, R, kp1, N, P]
        limbs = limbs.movedim(-1, -2).reshape(-1, R, kp1 * planes, N)
        hats = ntt.key_hats(limbs)                      # [2, c, R, KO, N]
        out[s:s + _STEP_CHUNK] = _u16_bits(hats.movedim(0, 1))
    return out


def pack_ksk(ksk, p: CryptoParams, device) -> torch.Tensor:
    """u64 [kN, ks_level, n+1] -> int8 [kN*ks_level, ceil8((n+1)*P)],
    P = key_planes(p)."""
    ksk = ksk if torch.is_tensor(ksk) else torus.from_numpy(ksk)
    ksk = ksk.to(device)
    planes = key_planes(p)
    if planes == KEY_PLANES:
        if bool((ksk & torus.MASK32).any()):
            raise ValueError("keyswitch key not in the 32-bit subgroup")
        ksk = (ksk >> 32) & torus.MASK32
    limbs = balanced_limbs(ksk, planes)
    cols = (p.lwe_dimension + 1) * planes
    flat = limbs.reshape(p.big_lwe_dimension * p.ks_level, cols)
    padded = torch.zeros((flat.shape[0], -(-cols // 8) * 8),
                         dtype=torch.int8, device=device)
    padded[:, :cols] = flat
    return padded


def level_major(levels: int, kp1: int, device=None) -> torch.Tensor:
    """Row permutation from the JAX order (r*ell + lev) of the R key rows
    to the level-major order (lev*(k+1) + r): rows[lev*kp1 + r] = r*ell +
    lev.  Its inverse is ``argsort``."""
    lev, r = torch.meshgrid(torch.arange(levels), torch.arange(kp1),
                            indexing="ij")
    return (r * levels + lev).reshape(-1).to(device)


def pack_bsk_limbs(bsk, device, levels: int = 1) -> torch.Tensor:
    """u64 [n, R, k+1, N] key polys (numpy or int64 tensor; rows r*ell +
    lev, R = (k+1)*levels) -> int8 [n, R, k+1, 8, 2N] with the rows
    level-major: the balanced byte limbs (limb 7's carry dropped, as
    ``fhestring_tpu.crypto.keys.balanced_limbs_u64``) of each poly doubled
    with its negation, (K, -K mod 2^64), each plane reversed:
    out[..., lb, i] = limb_lb of the doubled poly at -i mod 2N."""
    bsk = bsk if torch.is_tensor(bsk) else torus.from_numpy(bsk)
    n_steps, R, kp1, N = bsk.shape
    out = torch.empty((n_steps, R, kp1, KEY_PLANES64, 2 * N), dtype=torch.int8,
                      device=device)
    reverse = (-torch.arange(2 * N, device=device)) % (2 * N)
    rows = level_major(levels, R // levels, device)
    for s in range(0, n_steps, _STEP_CHUNK):
        chunk = bsk[s:s + _STEP_CHUNK].to(device)[:, rows]
        limbs = balanced_limbs(torch.cat([chunk, -chunk], dim=-1),
                               KEY_PLANES64)              # [c, R, kp1, 2N, 8]
        out[s:s + _STEP_CHUNK] = limbs.movedim(-1, -2)[..., reverse]
    return out


def doubled_limbs(bsk_limbs: torch.Tensor) -> torch.Tensor:
    """The planes of ``pack_bsk_limbs`` un-reversed, int8 [..., 8, 2N]: the
    limbs of the doubled polys (K, -K) in coefficient order, the first N of
    which are the limbs of K itself."""
    two_n = bsk_limbs.shape[-1]
    reverse = (-torch.arange(two_n, device=bsk_limbs.device)) % two_n
    return bsk_limbs[..., reverse]


def jax_bsk_limbs(bsk_limbs: torch.Tensor, levels: int) -> torch.Tensor:
    """``pack_bsk_limbs``'s key in the JAX package's layout (its
    ``DeviceServerKeys.bsk_limbs``): un-reversed, rows r*ell + lev."""
    R = bsk_limbs.shape[1]
    back = torch.argsort(level_major(levels, R // levels, bsk_limbs.device))
    return doubled_limbs(bsk_limbs)[:, back]


def bsk_from_limbs(jax_limbs: torch.Tensor) -> torch.Tensor:
    """The raw key polys int64 (u64 bits) [n, R, k+1, N] from limb planes in
    the JAX layout int8 [n, R, k+1, 8, 2N]: the first N coefficients are the
    limbs of K itself, sum_lb limb_lb << 8 lb mod 2^64."""
    N = jax_limbs.shape[-1] // 2
    out = torch.zeros(jax_limbs.shape[:3] + (N,), dtype=torch.int64,
                      device=jax_limbs.device)
    for lb in range(jax_limbs.shape[3]):
        out += jax_limbs[:, :, :, lb, :N].to(torch.int64) << (8 * lb)
    return out


def bsk_from_hats(khat: torch.Tensor, p: CryptoParams) -> torch.Tensor:
    """The raw key polys int64 (u64 bits) [n, R, k+1, N] from the family's
    NTT-domain key (``pack_bsk_hats``): the inverse transform of the first
    prime's hats gives each balanced limb mod 40961 (the 1/N the hats carry
    cancels the inverse's missing scaling), which is the limb itself."""
    planes = key_planes(p)
    n_steps, _, R, cols, N = khat.shape
    kp1 = cols // planes
    tw = ntt.device_twiddles(N, str(khat.device))
    q = ntt.PRIMES[0]
    out = torch.empty((n_steps, R, kp1, N), dtype=torch.int64,
                      device=khat.device)
    for s in range(0, n_steps, _STEP_CHUNK):
        hats = khat[s:s + _STEP_CHUNK].to(torch.int64) & 0xFFFF
        res = ntt.ntt_inv(hats.movedim(1, 0), tw)[0]     # [c, R, cols, N]
        limbs = torch.where(res > q // 2, res - q, res)
        limbs = limbs.view(-1, R, kp1, planes, N)
        value = torch.zeros_like(limbs[:, :, :, 0])
        for lb in range(planes):
            value += limbs[:, :, :, lb] << (8 * lb)
        out[s:s + _STEP_CHUNK] = value << 32 if planes == KEY_PLANES else value
    return out


def pack_server_keys(srv_or_arrays, device, params: CryptoParams | None = None,
                     with_ntt2: bool = True) -> DeviceServerKeys:
    """Pack the numpy ``bsk`` and ``ksk`` arrays of a ``ServerKeys`` (this
    package's numpy_ref or the JAX package's: the arrays are the same) onto
    ``device``, in the layout of the parameter set's torus family.
    ``params`` (default: ``srv_or_arrays.params``) names the parameter set
    the device keys are tagged with.

    with_ntt2: pack the NTT-domain bootstrap key (``bsk_ntt32`` or
    ``bsk_ntt64``), which the whole-rotation kernels read.  ``bsk_limbs``
    is packed for a 64-bit set always, as the JAX package's
    ``pack_server_keys`` always packs its limb key, and for a 32-bit set
    when it has no ``bsk_ntt32``: its served route then reads the limbs."""
    bsk, ksk = srv_or_arrays.bsk, srv_or_arrays.ksk
    p = params or srv_or_arrays.params
    keys = DeviceServerKeys(params=p, ksk_limbs=pack_ksk(ksk, p, device))
    if p.torus_bits == 64 or not with_ntt2:
        keys.bsk_limbs = pack_bsk_limbs(bsk, device, p.pbs_level)
    if with_ntt2:
        khat = pack_bsk_hats(bsk, device, key_planes(p))
        if p.torus_bits == 32:
            keys.bsk_ntt32 = khat
        else:
            keys.bsk_ntt64 = khat
    return keys


def pack_luts(tables, p: CryptoParams, device) -> torch.Tensor:
    """Bank of doubled test polynomials, int64 torus [L, 2N]."""
    polys = np.stack([ref.make_test_poly(t, p) for t in tables])
    doubled = np.concatenate([polys, np.uint64(0) - polys], axis=-1)
    return torus.from_numpy(doubled, device)
