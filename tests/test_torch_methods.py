"""String methods beyond the six of the served slice, on the port's torch
FheBackend: compaction, prefix counts, the engine scans and splits decrypt
to what Python's str gives.

Tolerance: zero.  Decrypted strings and values must be equal.
"""

import pytest
import torch

from fhestring_tpu_torch import PARAM_TEST32_ZERO_NOISE
from fhestring_tpu_torch.client import ClientKey

# One intra-op thread: the suite runs test files in parallel worker
# processes, and torch's spinning OpenMP pool would oversubscribe the CPU.
torch.set_num_threads(1)

P = PARAM_TEST32_ZERO_NOISE


@pytest.fixture(scope="module")
def client():
    ck = ClientKey(P, seed=9, device="cpu")
    return ck, ck.get_server_key()


S, PAT = "a bc", "b"
MORE_METHODS = {
    "starts_with_clear": (lambda k, s: k.starts_with_clear(s, "a "), "char", 1),
    "ends_with_clear": (lambda k, s: k.ends_with_clear(s, "c"), "char", 1),
    "rfind_clear": (lambda k, s: k.rfind_clear(s, PAT), "char", S.rfind(PAT)),
    "is_empty": (lambda k, s: k.is_empty(s), "char", 0),
    "to_lower": (lambda k, s: k.to_lower(s), "string", S.lower()),
    "trim": (lambda k, s: k.trim(s), "string", S.strip()),
    "repeat_clear": (lambda k, s: k.repeat_clear(s, 2), "string", S * 2),
    "replace_clear": (lambda k, s: k.replace_clear(s, "b", ""), "string",
                      S.replace("b", "")),
}


@pytest.mark.parametrize("method", list(MORE_METHODS))
def test_more_methods_decrypt_to_python_str(client, method):
    ck, srv = client
    call, kind, expected = MORE_METHODS[method]
    out = call(srv, ck.encrypt(S, 1))
    got = ck.decrypt(out) if kind == "string" else ck.decrypt_char(out)
    assert got == expected


def test_split_clear_decrypts_to_python_split(client):
    ck, srv = client
    buffers, found = ck.decrypt_split(srv.split_clear(ck.encrypt("a b", 1), " "))
    assert [x for x in buffers if x] == "a b".split(" ")
    assert found == 1
