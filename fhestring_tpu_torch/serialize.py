"""Checkpoint / serialization of keys and ciphertexts.

The JAX package's ``serialize.py`` on the port's keys and tensors: the same
function names and signatures, the same flat numpy ``.npz`` files (no
pickles), and a file saved by either package loads in the other.  Each
loader takes a keyword-only ``device`` (default: the card, as
``client.default_device``) for what it puts on a device.

Formats (all little-endian numpy):

- client key:  lwe_sk[u8], glwe_sk[u8], bsk[u64], ksk[u64] + params JSON
- server key:  bsk[u64], ksk[u64] + params JSON (no secrets)
- packed server key: the device-format keys (below)
- ciphertext:  ct[u64 ...xB, kN+1] (+ kind/degree/noise metadata); covers
  FheString ([L, 4, kN+1]) and FheChar ([4, kN+1]).

``params`` is JSON of ``dataclasses.asdict``: the two packages'
``CryptoParams`` are different classes with the same fields.

The packed server key is where the two packages' device layouts differ.
The port writes the arrays the JAX package reads in the JAX layout, which
it can always derive: ``bsk_limbs`` (int8 [n, R, k+1, 8, 2N], doubled,
un-reversed, rows r*ell + lev) and ``ksk_limbs`` (int8 [kN*ks_level,
(n+1)*P], without the port's padding to a multiple of 8 columns).  Its own
NTT-domain key (two primes, ``crypto/ntt.py``) is not the JAX package's
(``bsk_ntt2`` has three primes) and is not stored: the file lists the
fields that hold it as ``torch_hats_fields``, a name the JAX loader never
reads (it reads only the ``_PACKED_OPTIONAL`` names, and the port writes
none of them).  On load the port rebuilds that key on the device from the
limb planes (the raw bootstrap key, then its transform) where the list
names the family's field, or where a JAX file holds the JAX package's key
of the whole-rotation kernel (``bsk_ntt32`` / ``bsk_ntt2``).  The JAX
package's ``bsk_ntt`` (its use_ntt route's key) asks for nothing: that key
loads with its limb planes only, and is served by the limb-plane route.
Rebuilding on an H100 loads a file faster than reading a stored copy
would: ``PERF.md``, PR 7.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from . import torus
from .ciphertext import FheChar, FheString, PublicParameters
from .numpy_ref import core as ref
from .params import CryptoParams
from .shortint import Blocks

FORMAT_VERSION = 1


# ---------------------------------------------------------------------------
# params <-> json
# ---------------------------------------------------------------------------

def params_to_json(p: CryptoParams) -> str:
    return json.dumps(dataclasses.asdict(p))


def params_from_json(s: str) -> CryptoParams:
    return CryptoParams(**json.loads(s))


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------

def save_client_key(path: str, ck) -> None:
    """Full client checkpoint: secrets + the server-key clone it owns."""
    np.savez_compressed(
        path,
        version=FORMAT_VERSION,
        kind="client_key",
        params=params_to_json(ck.params),
        lwe_sk=ck.secret.lwe_sk,
        glwe_sk=ck.secret.glwe_sk,
        bsk=ck._server_raw.bsk,
        ksk=ck._server_raw.ksk,
    )


def load_client_key(path: str, *, device=None):
    """A ClientKey whose ciphertexts are made on ``device``."""
    from .client import ClientKey, default_device
    from .native import SecureRng

    data = np.load(path, allow_pickle=False)
    assert str(data["kind"]) == "client_key", data["kind"]
    params = params_from_json(str(data["params"]))
    ck = ClientKey.__new__(ClientKey)
    ck.params = params
    ck.device = default_device(device)
    ck._rng = SecureRng(seed=None)  # fresh randomness for future encryptions
    ck.secret = ref.SecretKeys(params, data["lwe_sk"], data["glwe_sk"])
    ck._server_raw = ref.ServerKeys(params, data["bsk"], data["ksk"])
    ck.public_parameters = PublicParameters(num_blocks=params.num_blocks)
    return ck


def save_server_key(path: str, ck) -> None:
    """Evaluation keys only — safe to ship to an untrusted server."""
    np.savez_compressed(
        path,
        version=FORMAT_VERSION,
        kind="server_key",
        params=params_to_json(ck.params),
        bsk=ck._server_raw.bsk,
        ksk=ck._server_raw.ksk,
    )


def load_server_key(path: str, with_ntt2: bool = True, *, device=None):
    """A ServerKey packed on ``device`` from the raw keys; with_ntt2 as
    ``ClientKey.get_server_key``'s."""
    from .client import default_device
    from .crypto.keys import pack_server_keys
    from .server import ServerKey

    data = np.load(path, allow_pickle=False)
    assert str(data["kind"]) == "server_key", data["kind"]
    params = params_from_json(str(data["params"]))
    raw = ref.ServerKeys(params, data["bsk"], data["ksk"])
    return ServerKey(pack_server_keys(raw, default_device(device),
                                      with_ntt2=with_ntt2), params)


# ---------------------------------------------------------------------------
# packed (device-format) server key: the cold-start killer
# ---------------------------------------------------------------------------

# The JAX package's optional names (its loader reads these and no others).
_PACKED_OPTIONAL = ("bsk_ntt", "bsk_ntt2", "bsk_ntt32")


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().contiguous().numpy()


def save_packed_server_key(path: str, server_key) -> None:
    """Persist the DEVICE-format evaluation keys: the JAX layout of the limb
    planes, and the list of the port's NTT-domain fields to rebuild (module
    docstring).  Uncompressed on purpose: load speed is the point."""
    from .crypto import keys as K

    dk = server_key.backend.sc.keys
    p = dk.params
    hats = dk.ntt_key
    if dk.bsk_limbs is not None:
        bsk_limbs = K.jax_bsk_limbs(dk.bsk_limbs, p.pbs_level)
    else:  # a 32-bit key packed with its NTT key only
        bsk_limbs = K.jax_bsk_limbs(
            K.pack_bsk_limbs(K.bsk_from_hats(hats, p), hats.device,
                             p.pbs_level), p.pbs_level)
    cols = (p.lwe_dimension + 1) * K.key_planes(p)
    arrs = dict(
        version=FORMAT_VERSION,
        kind="packed_server_key",
        params=params_to_json(p),
        bsk_limbs=_numpy(bsk_limbs),
        ksk_limbs=_numpy(dk.ksk_limbs[:, :cols]),
    )
    if hats is not None:
        arrs.update(torch_hats_fields=json.dumps([K.ntt_field(p)]))
    # Write through an open handle: np.savez(path) appends ".npz" when the
    # path lacks it, which would desync the filename from the existence
    # check in client.get_server_key (silent repack on every start).
    with open(path, "wb") as f:
        np.savez(f, **arrs)


def load_packed_server_key(path: str, *, device=None):
    """Load a packed server key saved by either package's
    ``save_packed_server_key`` onto ``device``."""
    from .client import default_device
    from .crypto import keys as K
    from .server import ServerKey

    device = default_device(device)
    data = np.load(path, allow_pickle=False)
    assert str(data["kind"]) == "packed_server_key", data["kind"]
    p = params_from_json(str(data["params"]))
    jax_limbs = torch.from_numpy(data["bsk_limbs"])    # on the host
    ksk = torch.from_numpy(data["ksk_limbs"]).to(device)
    padded = torch.zeros((ksk.shape[0], -(-ksk.shape[1] // 8) * 8),
                         dtype=torch.int8, device=device)
    padded[:, :ksk.shape[1]] = ksk
    dk = K.DeviceServerKeys(params=p, ksk_limbs=padded)
    # the NTT-domain key, where the port's list names the family's field or
    # a JAX file holds its whole-rotation key.  Older files of the port
    # may list "bsk_ntt" beside the family's field: it asks for nothing.
    family = K.ntt_field(p)
    listed = (json.loads(str(data["torch_hats_fields"]))
              if "torch_hats_fields" in data else [])
    if family in listed or ("bsk_ntt32" if p.torus_bits == 32
                            else "bsk_ntt2") in data:
        # rebuilt on the device from the limb planes
        setattr(dk, family, K.pack_bsk_hats(
            K.bsk_from_limbs(jax_limbs.to(device)), device, K.key_planes(p)))
    if p.torus_bits == 64 or dk.bsk_ntt32 is None:
        rows = K.level_major(p.pbs_level, p.glwe_dimension + 1, device)
        two_n = jax_limbs.shape[-1]
        reverse = (-torch.arange(two_n, device=device)) % two_n
        dk.bsk_limbs = jax_limbs.to(device)[:, rows][..., reverse].contiguous()
    return ServerKey(dk, p)


# ---------------------------------------------------------------------------
# ciphertexts
# ---------------------------------------------------------------------------

def _save_blocks(path: str, blocks: Blocks, kind: str) -> None:
    np.savez_compressed(
        path,
        version=FORMAT_VERSION,
        kind=kind,
        ct=torus.to_numpy(blocks.ct),
        degree=blocks.degree,
        noise_var=blocks.noise_var,
    )


def _load_blocks(data, device) -> Blocks:
    from .client import default_device

    return Blocks(torus.from_numpy(data["ct"], default_device(device)),
                  int(data["degree"]), float(data["noise_var"]))


def save_fhe_string(path: str, s: FheString) -> None:
    _save_blocks(path, s.blocks, "fhe_string")


def load_fhe_string(path: str, *, device=None) -> FheString:
    data = np.load(path, allow_pickle=False)
    assert str(data["kind"]) == "fhe_string", data["kind"]
    return FheString(_load_blocks(data, device))


def save_fhe_char(path: str, c: FheChar) -> None:
    _save_blocks(path, c.blocks, "fhe_char")


def load_fhe_char(path: str, *, device=None) -> FheChar:
    data = np.load(path, allow_pickle=False)
    assert str(data["kind"]) == "fhe_char", data["kind"]
    return FheChar(_load_blocks(data, device))
