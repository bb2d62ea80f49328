"""The benchmark's own keys and ciphertexts: exact products, encryption
that decrypts, and keys that the program packs and bootstraps with."""

from __future__ import annotations

import json
import os
import types

import numpy as np
import pytest
import torch

from fhebench import scheme

HERE = os.path.dirname(os.path.abspath(__file__))


def tiny(name: str) -> dict:
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


def naive_negacyclic(a: np.ndarray, s: np.ndarray) -> np.ndarray:
    N = len(s)
    out = [0] * N
    for j in range(N):
        for t in range(N):
            k = j + t
            term = int(a[j]) * int(s[t])
            if k < N:
                out[k] += term
            else:
                out[k - N] -= term
    return np.array([v % (1 << 64) for v in out], dtype=np.uint64)


def test_negacyclic_product_is_exact():
    g = scheme.generator(3, "cpu")
    a = scheme.uniform((2, 32), g, 64)
    s = torch.randint(0, 2, (32,), generator=g)
    got = scheme.negacyclic_times_binary(a, s).numpy().view(np.uint64)
    for row in range(2):
        want = naive_negacyclic(a[row].numpy().view(np.uint64), s.numpy())
        assert (got[row] == want).all()


@pytest.mark.parametrize("name", ["tiny64", "tiny32"])
def test_encryptions_decrypt_with_small_noise(name):
    p = tiny(name)["params"]
    g = scheme.generator(2**31 + 1, "cpu")
    secret, bsk, ksk = scheme.keygen(p, g)
    data = torch.arange(32, 127)
    ct = scheme.encrypt_bytes(p, secret, data, g)
    got, share = scheme.decrypt_bytes(p, secret, ct)
    assert torch.equal(got, data)
    assert share < 0.01
    n, k, N = p["lwe_dimension"], p["glwe_dimension"], p["polynomial_size"]
    assert bsk.shape == (n, (k + 1) * p["pbs_level"], k + 1, N)
    assert ksk.shape == (k * N, p["ks_level"], n + 1)
    if p["torus_bits"] == 32:
        assert not bool((bsk & 0xFFFFFFFF).any())
        assert not bool((ksk & 0xFFFFFFFF).any())


def test_same_seed_same_keys():
    p = tiny("tiny64")["params"]
    a = scheme.keygen(p, scheme.generator(7, "cpu"))
    b = scheme.keygen(p, scheme.generator(7, "cpu"))
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])


@pytest.mark.parametrize("name", ["tiny64", "tiny32"])
def test_the_program_bootstraps_with_these_keys(name):
    from fhestring_tpu_torch.crypto.keys import pack_luts, pack_server_keys
    from fhestring_tpu_torch.crypto.pbs import pbs_batch
    from fhestring_tpu_torch.params import CryptoParams

    config = tiny(name)
    p = config["params"]
    params = CryptoParams(**p)
    g = scheme.generator(11, "cpu")
    secret, bsk, ksk = scheme.keygen(p, g)
    keys = pack_server_keys(types.SimpleNamespace(bsk=bsk, ksk=ksk,
                                                  params=params), "cpu")
    values = torch.arange(16) % 4
    ct = scheme.encrypt_blocks(p, secret, values, g)
    table = [(3 * v + 1) % 16 for v in range(16)]
    out = pbs_batch(ct, torch.zeros(16, dtype=torch.int64),
                    pack_luts([table], params, "cpu"), keys)
    got, share = scheme.decode(p, scheme.phase(secret, out))
    assert got.tolist() == [table[v] for v in values.tolist()]
    assert float(share.max()) < 0.2
