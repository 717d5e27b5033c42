"""Cryptographic randomness for key/noise/mask sampling (a copy of
``lattisense_tpu/utils/csprng.py``: the same seed gives the same stream,
so both packages sample the same keys and ciphertexts).

The reference delegates all secret sampling to cryptographic PRNGs
(Lattigo's Blake2-based samplers, wolfssl on the FPGA path). NumPy's
default PCG64 is *not* a CSPRNG — its state is recoverable from outputs —
so every secret-bearing sampling site (key generation, encryption noise,
multiparty masks, compressed-ciphertext seeds) draws from :class:`CryptoRng`
instead: a SHAKE-256 XOF in counter mode keyed from ``os.urandom`` (or from
an explicit seed for deterministic tests — the reference's
``create_random_context_with_seed`` path, fhe_lib_v2.h:846).

Only the subset of the ``numpy.random.Generator`` API the codebase uses is
implemented (``integers``, ``normal``, ``choice``), so a ``CryptoRng`` and a
NumPy generator are interchangeable at every sampling site.
"""

import hashlib
import os

import numpy as np

_U64 = np.uint64
_DOMAIN = b'lattisense-tpu-csprng-v1'


class CryptoRng:
    """SHAKE-256 counter-mode DRBG with a vectorized NumPy-style facade.

    Each request hashes (key ‖ counter) with a fresh counter, so output
    blocks never overlap and backtracking resistance follows from SHAKE's
    preimage resistance. 256-bit key from ``os.urandom`` unless an explicit
    (test) seed is given.
    """

    def __init__(self, seed=None):
        if seed is None:
            self._key = os.urandom(32)
        else:
            # Deterministic derivation for reproducible tests/examples.
            self._key = hashlib.sha3_256(
                _DOMAIN + str(int(seed)).encode()).digest()
        self._counter = 0

    # -- raw streams -------------------------------------------------------
    def bytes(self, nbytes: int) -> bytes:
        h = hashlib.shake_256()
        h.update(self._key)
        h.update(self._counter.to_bytes(16, 'little'))
        self._counter += 1
        return h.digest(int(nbytes))

    def _u64(self, count: int) -> np.ndarray:
        """The next request's ``count`` words, a read-only view of its bytes
        (every caller makes a new array of them)."""
        return np.frombuffer(self.bytes(8 * int(count)), dtype=_U64)

    # -- numpy.random.Generator subset ------------------------------------
    def integers(self, low, high=None, size=None, dtype=np.int64,
                 endpoint=False):
        if high is None:
            low, high = 0, low
        low, high = int(low), int(high)
        if endpoint:
            high += 1
        span = high - low
        if span <= 0:
            raise ValueError('low >= high')
        n = int(np.prod(size)) if size is not None else 1
        # Unbiased via rejection against the next power-of-two mask.
        nbits = max(span - 1, 1).bit_length()
        mask = _U64((1 << nbits) - 1)
        out = np.empty(n, dtype=_U64)
        filled = 0
        while filled < n:
            need = n - filled
            cand = self._u64(need + (need >> 2) + 8) & mask
            cand = cand[cand < span][:need]
            out[filled:filled + len(cand)] = cand
            filled += len(cand)
        if low < 0:
            res = out.astype(np.int64) + low
        else:
            res = out + _U64(low) if low else out
        res = res.astype(dtype, copy=False)
        if size is None:
            return res.reshape(()).item() if np.issubdtype(dtype, np.integer) else res[0]
        return res.reshape(size)

    def normal(self, loc=0.0, scale=1.0, size=None):
        n = int(np.prod(size)) if size is not None else 1
        # Box-Muller from 53-bit uniforms.
        m = n + (n & 1)
        u = (self._u64(2 * m) >> np.uint64(11)).astype(np.float64) * (2.0 ** -53)
        u1 = np.clip(u[:m], np.finfo(np.float64).tiny, None)
        u2 = u[m:]
        r = np.sqrt(-2.0 * np.log(u1))
        z = np.concatenate([r * np.cos(2 * np.pi * u2),
                            r * np.sin(2 * np.pi * u2)])[:n]
        z = loc + scale * z
        return z.reshape(size) if size is not None else z[0]

    def choice(self, a, size=None, replace=True):
        if np.ndim(a) == 0:
            pool = np.arange(int(a))
        else:
            pool = np.asarray(a)
        n = int(np.prod(size)) if size is not None else 1
        if replace:
            idx = self.integers(0, len(pool), size=n)
        else:
            if n > len(pool):
                raise ValueError('cannot sample more than population without replacement')
            # Unbiased partial shuffle: order by independent random keys.
            idx = np.argsort(self._u64(len(pool)), kind='stable')[:n]
        out = pool[idx]
        return out.reshape(size) if size is not None else out[0]

    def seed_128(self) -> int:
        """A 128-bit integer seed (compressed-ciphertext c1 expansion)."""
        return int.from_bytes(self.bytes(16), 'little')


def default_crypto_rng(seed=None) -> CryptoRng:
    return CryptoRng(seed)
