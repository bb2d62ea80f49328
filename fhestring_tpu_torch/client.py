"""Client-side runtime: key generation, encryption, decryption.

API parity with the JAX package's ``client.ClientKey`` (itself the
reference's MyClientKey): ``from_params``, ``encrypt(string, padding)``
(appends ``padding`` NUL bytes, rejects non-ASCII and embedded NULs),
``encrypt_no_padding``, ``encrypt_char``, ``decrypt`` (truncates at the
first NUL), ``decrypt_char``, ``get_server_key``, ``get_public_parameters``.

All secret-key operations run on the host in numpy; ciphertexts are handed
out as tensors on the client's ``device`` and evaluation keys are packed
onto the device ``get_server_key`` is given.  The same ``seed`` gives the
same secret keys and ciphertexts as the JAX package's ``ClientKey``.
"""

from __future__ import annotations

import numpy as np
import torch

from .ciphertext import FheChar, FheString, PublicParameters, blocks_from_numpy
from .crypto.keys import pack_server_keys
from .numpy_ref import core as ref
from .params import PARAM_PROD, CryptoParams
from .shortint import Blocks
from . import torus

NB = 4


def default_device(device=None) -> torch.device:
    """``device``, or the card where none is given.  Without a CUDA device
    the default raises: the CPU runs only where the caller asks for it."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device=\"cpu\" to run on the CPU")
    return torch.device("cuda")


class ClientKey:
    def __init__(self, params: CryptoParams = PARAM_PROD,
                 seed: int | None = 0, native_keygen: bool | None = None,
                 device=None):
        """seed=None uses a fresh AES-CTR key (secure); an int seed gives a
        deterministic AES-CTR stream (tests/benchmarks).

        native_keygen: use the C++ keygen (much faster at production
        parameters).  Default: auto — native for production sizes
        (N >= 1024) when a compiler is available, NumPy otherwise.
        device: where encrypted tensors are created and, by default, the
        server key is packed.  None (the default) means the card, "cuda";
        where there is none it raises, and ``device="cpu"`` runs on the
        CPU.
        """
        from . import native
        from .native import SecureRng

        self.params = params
        self.device = default_device(device)
        self._rng = SecureRng(seed=seed)
        if native_keygen is None:
            native_keygen = (params.polynomial_size >= 1024
                             and native.keygen_available())
        if native_keygen:
            # Counter regions >= 2^32: disjoint from self._rng's encryption
            # stream, which counts up from 0 under the same key.
            self.secret, self._server_raw = native.keygen_native(
                params, self._rng._key)
        else:
            self.secret, self._server_raw = ref.keygen(params, self._rng)
        self.public_parameters = PublicParameters(num_blocks=params.num_blocks)

    @classmethod
    def from_params(cls, params: CryptoParams = PARAM_PROD,
                    seed: int | None = 0, device=None) -> "ClientKey":
        return cls(params, seed, device=device)

    def get_server_key(self, with_ntt2: bool = True,
                       cache_path: str | None = None, *, device=None):
        """Pack the evaluation keys onto ``device`` (default: the client's)
        and return the ServerKey that evaluates on it.  The positional
        parameters are the JAX package's ``ClientKey.get_server_key``'s.

        with_ntt2: also pack the NTT-domain bootstrap key, which the
        whole-rotation kernels (K1, K2) read.  False leaves it out: the
        set is then served by the step-wise route over the limb planes, K5
        + K3 at 64 bits, digits + K3 per gadget level at 32 bits
        (``crypto/pbs.blind_rotate``).  The JAX package's default packs it
        only off CPU; here the CPU path runs the plain versions of K1 and
        K2, which read it, so it is packed on every device.  The bits are
        the same either way.

        cache_path: optional packed-key checkpoint (.npz, the format of
        ``serialize.save_packed_server_key``, which either package loads).
        If it exists, the device-format keys are loaded instead of packed;
        a file of another parameter set is refused, and one that lacks the
        NTT-domain key with_ntt2 asks for is re-packed and overwritten.  On
        a miss the packed keys are saved there after packing."""
        import os

        from .server import ServerKey

        device = self.device if device is None else torch.device(device)
        if cache_path and os.path.exists(cache_path):
            from . import serialize

            srv = serialize.load_packed_server_key(cache_path, device=device)
            if srv.params != self.params:
                raise ValueError(
                    f"packed-key cache {cache_path!r} was created for "
                    f"parameter set {srv.params.name!r}, not "
                    f"{self.params.name!r}")
            if not with_ntt2 or srv.backend.sc.keys.ntt_key is not None:
                return srv
            # Packed without the NTT-domain key: loading it as it is would
            # silently drop the whole-rotation kernel.  Re-pack with it and
            # overwrite the checkpoint.
        srv = ServerKey(pack_server_keys(self._server_raw, device,
                                         with_ntt2=with_ntt2), self.params)
        if cache_path:
            from . import serialize

            serialize.save_packed_server_key(cache_path, srv)
        return srv

    def get_public_parameters(self) -> PublicParameters:
        return self.public_parameters

    def get_public_key(self, zero_count: int | None = None):
        """LWE public key: encryptions of zero enabling encryption WITHOUT
        the secret key (numpy_ref.public_encrypt)."""
        return ref.public_keygen(self.secret, self._rng,
                                 zero_count=zero_count)

    def encrypt_with_public_key(self, pk, string: str,
                                padding: int = 1) -> FheString:
        """Public-key string encryption (NUL-padding protocol as encrypt)."""
        self._check_ascii(string)
        data = string.encode("ascii") + b"\0" * padding
        n_ct = self.params.big_lwe_dimension + 1
        out = np.zeros((len(data), NB, n_ct), dtype=np.uint64)
        for i, byte in enumerate(data):
            for b in range(NB):
                out[i, b] = ref.public_encrypt(pk, (byte >> (2 * b)) & 3,
                                               self._rng)
        return FheString(blocks_from_numpy(out, self.device))

    # ---- encryption ---------------------------------------------------------
    def _encrypt_bytes(self, data: bytes) -> Blocks:
        """Encrypt bytes as [len, 4, kN+1] block tensor."""
        p = self.params
        n_ct = p.big_lwe_dimension + 1
        out = np.zeros((len(data), NB, n_ct), dtype=np.uint64)
        for i, byte in enumerate(data):
            for b in range(NB):
                val = (byte >> (2 * b)) & 3
                out[i, b] = ref.lwe_encrypt_raw(
                    self.secret.big_lwe_sk, ref.encode(val, p), p.glwe_noise_std,
                    self._rng, p.torus_bits)
        return blocks_from_numpy(out, self.device)

    @staticmethod
    def _check_ascii(string: str) -> None:
        if not all(ord(c) < 128 and c != "\0" for c in string):
            raise ValueError("The input string must only contain ascii "
                             "letters and not include null characters")

    def encrypt(self, string: str, padding: int = 1) -> FheString:
        """Encrypt with NUL padding appended."""
        self._check_ascii(string)
        data = string.encode("ascii") + b"\0" * padding
        return FheString(self._encrypt_bytes(data))

    def encrypt_no_padding(self, string: str) -> FheString:
        """Unpadded encryption, used for patterns."""
        self._check_ascii(string)
        return FheString(self._encrypt_bytes(string.encode("ascii")))

    def encrypt_char(self, value: int) -> FheChar:
        blocks = self._encrypt_bytes(bytes([value]))
        return FheChar(Blocks(blocks.ct[0], 3, 1.0))

    # ---- decryption ---------------------------------------------------------
    def _decrypt_block_values(self, blocks: Blocks) -> np.ndarray:
        p = self.params
        cts = torus.to_numpy(blocks.ct)  # [..., kN+1]
        sk = self.secret.big_lwe_sk.astype(np.uint64)
        phase = cts[..., -1] - (cts[..., :-1] * sk).sum(axis=-1, dtype=np.uint64)
        decoded = ((phase + np.uint64(p.delta // 2)) // np.uint64(p.delta)) % np.uint64(
            p.full_space
        )
        return (decoded % np.uint64(p.plaintext_space)).astype(np.int64)

    def decrypt_blocks_to_bytes(self, blocks: Blocks) -> np.ndarray:
        """[..., 4] block tensor -> [...] uint8 values."""
        vals = self._decrypt_block_values(blocks)  # [..., 4]
        out = np.zeros(vals.shape[:-1], dtype=np.int64)
        for b in range(NB):
            out += (vals[..., b] % 4) << (2 * b)
        return (out % 256).astype(np.uint8)

    def decrypt_bits(self, bits: Blocks) -> np.ndarray:
        """Decrypt bit-valued blocks (no block axis) to a 0/1 array."""
        return self._decrypt_block_values(bits).astype(np.uint8)

    def decrypt_char(self, c: FheChar) -> int:
        return int(self.decrypt_blocks_to_bytes(c.blocks))

    def decrypt_split(self, split) -> tuple[list[str], int]:
        """FheSplit -> (buffer strings, pattern_found)."""
        grid = self.decrypt_blocks_to_bytes(split.buffers)  # [n_buf, L]
        out = []
        for row in grid:
            chars = bytearray()
            for byte in row:
                if byte == 0:
                    break
                chars.append(int(byte))
            out.append(chars.decode("ascii"))
        return out, self.decrypt_char(split.pattern_found)

    def decrypt_strip(self, strip) -> tuple[str, int]:
        """FheStrip -> (string, flag)."""
        return self.decrypt(strip.string), self.decrypt_char(strip.pattern_found)

    def decrypt(self, s: FheString) -> str:
        """Decrypt and truncate at the first NUL."""
        if len(s) == 0:
            return ""
        data = self.decrypt_blocks_to_bytes(s.blocks)
        out = bytearray()
        for byte in data:
            if byte == 0:
                break
            out.append(int(byte))
        return out.decode("ascii")
