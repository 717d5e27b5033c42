"""Serialization of contexts, keys and ciphertexts (host NumPy and ``struct``).

Port of ``lattisense_tpu/utils/serialize.py`` with the same byte format, so a
blob written by either package is read by the other: a magic word, a
version, a length-prefixed JSON header (schema and metadata) and raw
bit-packed limb sections. Each polynomial limb is packed at
``bit_length(q_i) - n_drop`` bits a coefficient; dropping low bits is the
reference's lossy ciphertext compression (after fhe_lib_v2.h:1283), done on
the CRT-composed coefficient mod Q.

Compressed ciphertexts store (c0, seed): c1 is re-expanded from a Philox
counter PRNG with rejection sampling (``expand_uniform``), deterministic
across hosts, which halves a ciphertext (seed-expanded symmetric encryption).

Packing reads tensors back to the host; unpacking gives int64 tensors on the
device the caller names (the card unless ``device='cpu'``).
"""

import json
import math
import struct

import numpy as np
import torch

from .. import resolve_device
from ..params import BfvParams, CkksParams
from ..schemes.types import Ciphertext, KeySwitchKey, PublicKey

_MAGIC = b'LSTP'
_VERSION = 1


def _host(x) -> np.ndarray:
    """A residue tensor or array as a host uint64 array (residues are
    non-negative, so the cast is exact)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x).astype(np.uint64)


def _tensor(arr: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr).astype(np.int64)).to(device)


# ---------------------------------------------------------------------------
# bit packing
# ---------------------------------------------------------------------------

def pack_bits(vals: np.ndarray, width: int) -> bytes:
    """Pack u64 values (flat) at ``width`` bits each (big-endian bit order)."""
    v = np.ascontiguousarray(vals.reshape(-1), dtype=np.uint64)
    bits = np.unpackbits(v.astype('>u8').view(np.uint8).reshape(-1, 8), axis=1)
    return np.packbits(bits[:, 64 - width:].reshape(-1)).tobytes()


def unpack_bits(data: bytes, width: int, count: int) -> np.ndarray:
    if len(data) < (count * width + 7) // 8:
        raise ValueError('truncated serialized data')
    bits = np.unpackbits(np.frombuffer(data, np.uint8), count=count * width)
    full = np.zeros((count, 64), np.uint8)
    full[:, 64 - width:] = bits.reshape(count, width)
    return np.packbits(full, axis=1).view('>u8').reshape(count).astype(np.uint64)


def _packed_size(width: int, count: int) -> int:
    return (count * width + 7) // 8


# ---------------------------------------------------------------------------
# container
# ---------------------------------------------------------------------------

def _emit(header: dict, sections: list[bytes]) -> bytes:
    h = json.dumps(header).encode()
    return b''.join([_MAGIC, struct.pack('<HI', _VERSION, len(h)), h] + sections)


def _parse(data: bytes):
    if data[:4] != _MAGIC:
        raise ValueError('bad magic')
    ver, hlen = struct.unpack('<HI', data[4:10])
    if ver != _VERSION:
        raise ValueError(f'unsupported version {ver}')
    return json.loads(data[10:10 + hlen]), data[10 + hlen:]


def _params_header(params) -> dict:
    d = {'algo': params.algo, 'n': params.n, 'q': params.q, 'p': params.p}
    if isinstance(params, BfvParams):
        d['t'] = params.t
    else:
        d['slots'] = params.slots
        d['scale'] = params.scale
    if params.word_bits != 64:
        d['word'] = params.word_bits    # absent = 64 (format-stable)
    return d


def params_from_header(d: dict):
    w = d.get('word', 64)
    if d['algo'] == 'BFV':
        return BfvParams(d['n'], d['t'], d['q'], d['p'], word_bits=w)
    return CkksParams(d['n'], d['q'], d['p'], d['slots'], d['scale'], word_bits=w)


def _poly_widths(moduli, drop: int = 0):
    return [max(1, int(q).bit_length() - drop) for q in moduli]


def _pack_rns(data: np.ndarray, moduli, drop: int = 0) -> list[bytes]:
    """data: (..., L, n) uint64 → per-limb packed sections (leading axes
    flattened)."""
    L = data.shape[-2]
    widths = _poly_widths(moduli, drop)
    flat = data.reshape(-1, L, data.shape[-1])
    return [pack_bits(flat[:, i, :] >> np.uint64(drop), widths[i]) for i in range(L)]


def _unpack_rns(blob: bytes, offset: int, shape, moduli, drop: int = 0):
    """→ (uint64 array (..., L, n), new offset)."""
    L, n = shape[-2], shape[-1]
    lead = math.prod(shape[:-2])
    widths = _poly_widths(moduli, drop)
    out = np.empty((lead, L, n), dtype=np.uint64)
    for i in range(L):
        size = _packed_size(widths[i], lead * n)
        vals = unpack_bits(blob[offset:offset + size], widths[i], lead * n)
        out[:, i, :] = vals.reshape(lead, n) << np.uint64(drop)
        offset += size
    return out.reshape(shape), offset


# ---------------------------------------------------------------------------
# ciphertexts
# ---------------------------------------------------------------------------

def _crt_compose(poly: np.ndarray, moduli) -> np.ndarray:
    """RNS (L, n) → positional big-int array (n,) dtype=object, in [0, Q)."""
    Q = math.prod(int(q) for q in moduli)
    X = np.zeros(poly.shape[-1], dtype=object)
    for i, qi in enumerate(moduli):
        Qi = Q // int(qi)
        X = X + poly[i].astype(object) * (Qi * pow(Qi, -1, int(qi)))
    return X % Q


def _crt_decompose(X: np.ndarray, moduli) -> np.ndarray:
    out = np.empty((len(moduli), len(X)), dtype=np.uint64)
    for i, qi in enumerate(moduli):
        out[i] = np.array([int(x) % int(qi) for x in X], dtype=np.uint64)
    return out


def _pack_bigints(X: np.ndarray, width_bits: int) -> bytes:
    """Exactly ``width_bits`` a value (no per-value byte rounding)."""
    nbytes = (width_bits + 7) // 8
    raw = np.frombuffer(b''.join(int(x).to_bytes(nbytes, 'big') for x in X),
                        np.uint8).reshape(len(X), nbytes)
    bits = np.unpackbits(raw, axis=1)[:, nbytes * 8 - width_bits:]
    return np.packbits(bits.reshape(-1)).tobytes()


def _unpack_bigints(data: bytes, width_bits: int, count: int) -> np.ndarray:
    if len(data) < (count * width_bits + 7) // 8:
        raise ValueError('truncated serialized data')
    nbytes = (width_bits + 7) // 8
    bits = np.unpackbits(np.frombuffer(data, np.uint8), count=count * width_bits)
    full = np.zeros((count, nbytes * 8), np.uint8)
    full[:, nbytes * 8 - width_bits:] = bits.reshape(count, width_bits)
    raw = np.packbits(full, axis=1)
    return np.array([int.from_bytes(raw[i].tobytes(), 'big') for i in range(count)],
                    dtype=object)


def serialize_ciphertext(ct: Ciphertext, params, n_drop_bit_0: int = 0,
                         n_drop_bit_1: int = 0) -> bytes:
    """One (degree+1, L, n) ciphertext. ``n_drop_bit_0`` / ``n_drop_bit_1``
    drop low bits of the CRT-composed coefficients of c0 / the other
    components (truncating RNS residues would corrupt the value; the
    composed truncation adds noise below 2^drop)."""
    data = _host(ct.data)
    if data.ndim != 3:
        raise ValueError(f'serialize_ciphertext takes one ciphertext, got shape {data.shape}')
    moduli = params.q[:ct.level + 1]
    drops = [n_drop_bit_0] + [n_drop_bit_1] * ct.degree
    header = {
        'kind': 'ct', 'level': ct.level, 'degree': ct.degree,
        'is_ntt': ct.is_ntt, 'is_mform': ct.is_mform, 'scale': ct.scale,
        'drop': drops, 'params': _params_header(params),
    }
    sections = []
    q_bits = math.prod(int(q) for q in moduli).bit_length()
    for j in range(data.shape[0]):
        if drops[j] == 0:
            sections += _pack_rns(data[j], moduli)
        else:
            X = _crt_compose(data[j], moduli) >> drops[j]
            sections.append(_pack_bigints(X, q_bits - drops[j]))
    return _emit(header, sections)


def deserialize_ciphertext(blob: bytes, device=None) -> Ciphertext:
    header, body = _parse(blob)
    if header['kind'] != 'ct':
        raise ValueError(f"expected a ciphertext blob, got {header['kind']!r}")
    params = params_from_header(header['params'])
    level = header['level']
    moduli = params.q[:level + 1]
    n = params.n
    q_bits = math.prod(int(q) for q in moduli).bit_length()
    polys = []
    offset = 0
    for j in range(header['degree'] + 1):
        drop = header['drop'][j]
        if drop == 0:
            poly, offset = _unpack_rns(body, offset, (level + 1, n), moduli)
        else:
            width = q_bits - drop
            size = _packed_size(width, n)
            X = _unpack_bigints(body[offset:offset + size], width, n) << drop
            poly = _crt_decompose(X, moduli)
            offset += size
        polys.append(poly)
    return Ciphertext(data=_tensor(np.stack(polys), resolve_device(device)), level=level,
                      is_ntt=header['is_ntt'], is_mform=header['is_mform'],
                      scale=header['scale'])


# ---------------------------------------------------------------------------
# seed-expanded (compressed) ciphertexts
# ---------------------------------------------------------------------------

def expand_uniform(seed: int, moduli, n: int) -> np.ndarray:
    """Deterministic uniform (L, n) residues from a seed: a Philox counter
    PRNG and per-limb mask-and-reject (Lattigo's uniform sampler shape).
    Seeds up to 128 bits feed the whole Philox key; a seed below 2^64
    leaves the high key word zero."""
    m64 = (1 << 64) - 1
    rng = np.random.Generator(np.random.Philox(key=[seed & m64, (seed >> 64) & m64]))
    out = np.empty((len(moduli), n), dtype=np.uint64)
    for i, q in enumerate(moduli):
        q = int(q)
        mask = (1 << q.bit_length()) - 1
        need = n
        vals = np.empty(0, dtype=np.uint64)
        while need > 0:
            cand = rng.integers(0, 1 << 63, size=2 * need, dtype=np.uint64) & np.uint64(mask)
            cand = cand[cand < q]
            vals = np.concatenate([vals, cand[:need]])
            need = n - len(vals)
        out[i] = vals
    return out


class CompressedCiphertext:
    """A (c0, seed) pair: c1 = expand_uniform(seed) is not stored
    (after the reference's encrypt_symmetric_compressed)."""

    def __init__(self, c0, seed: int, level: int, is_ntt: bool, scale: float = 1.0):
        self.c0 = c0
        self.seed = seed
        self.level = level
        self.is_ntt = is_ntt
        self.scale = scale

    def serialize(self, params) -> bytes:
        header = {'kind': 'compressed_ct', 'level': self.level, 'is_ntt': self.is_ntt,
                  'scale': self.scale, 'seed': self.seed, 'params': _params_header(params)}
        return _emit(header, _pack_rns(_host(self.c0), params.q[:self.level + 1]))

    @staticmethod
    def deserialize(blob: bytes, device=None) -> 'CompressedCiphertext':
        header, body = _parse(blob)
        if header['kind'] != 'compressed_ct':
            raise ValueError(f"expected a compressed ciphertext blob, got {header['kind']!r}")
        params = params_from_header(header['params'])
        level = header['level']
        c0, _ = _unpack_rns(body, 0, (level + 1, params.n), params.q[:level + 1])
        return CompressedCiphertext(_tensor(c0, resolve_device(device)), header['seed'], level,
                                    header['is_ntt'], header['scale'])


# ---------------------------------------------------------------------------
# keys and contexts
# ---------------------------------------------------------------------------

def _pack_ksk(ksk: KeySwitchKey, params) -> tuple[dict, list[bytes]]:
    kq, kp = _host(ksk.key_q), _host(ksk.key_p)
    meta = {'beta': kq.shape[0], 'level': ksk.level, 'sp_level': ksk.sp_level}
    return meta, _pack_rns(kq, params.q) + _pack_rns(kp, params.p)


def _unpack_ksk(meta: dict, body: bytes, offset: int, params, device):
    beta, n = meta['beta'], params.n
    kq, offset = _unpack_rns(body, offset, (beta, 2, len(params.q), n), params.q)
    kp, offset = _unpack_rns(body, offset, (beta, 2, len(params.p), n), params.p)
    return KeySwitchKey(key_q=_tensor(kq, device), key_p=_tensor(kp, device),
                        level=meta['level'], sp_level=meta['sp_level']), offset


def serialize_context(context, advanced: bool = False) -> bytes:
    """The secret and public key; with ``advanced`` also the evaluation keys
    (relinearization, Galois and switching keys)."""
    params = context.params
    header = {'kind': 'context', 'advanced': advanced,
              'has_sk': context.sk is not None,
              'has_pk': context.pk is not None,
              'params': _params_header(params)}
    sections = []
    if context.sk is not None:
        coeffs = (np.asarray(context.sk.coeffs) + 1).astype(np.uint64)   # {-1,0,1} → {0,1,2}
        header['sk_bits'] = 2
        sections.append(pack_bits(coeffs, 2))
    if context.pk is not None:
        sections += _pack_rns(_host(context.pk.data), params.q)
    if advanced:
        if context.rlk is not None:
            header['rlk'], s = _pack_ksk(context.rlk, params)
            sections += s
        glk_meta = {}
        for elt in sorted(context.glk.keys):
            glk_meta[str(elt)], s = _pack_ksk(context.glk.keys[elt], params)
            sections += s
        header['glk'] = glk_meta
        swk_meta = {}
        for name in sorted(context.swk):
            swk_meta[name], s = _pack_ksk(context.swk[name], params)
            sections += s
        header['swk'] = swk_meta
    return _emit(header, sections)


def deserialize_context(blob: bytes, device=None):
    """A ``BfvContext`` or ``CkksContext`` on ``device`` holding the blob's
    keys (encryption uses a fresh CSPRNG)."""
    from ..runtime.context import BfvContext, CkksContext
    from ..schemes.keys import SecretKey

    header, body = _parse(blob)
    if header['kind'] != 'context':
        raise ValueError(f"expected a context blob, got {header['kind']!r}")
    params = params_from_header(header['params'])
    cls = BfvContext if isinstance(params, BfvParams) else CkksContext
    ctx = cls(params, device=device)
    offset = 0
    n = params.n
    if header['has_sk']:
        size = _packed_size(2, n)
        ctx.sk = SecretKey(unpack_bits(body[offset:offset + size], 2, n).astype(np.int64) - 1)
        offset += size
    if header['has_pk']:
        pk, offset = _unpack_rns(body, offset, (2, len(params.q), n), params.q)
        ctx.pk = PublicKey(data=_tensor(pk, ctx.device))
    if header.get('advanced'):
        if 'rlk' in header:
            ctx.rlk, offset = _unpack_ksk(header['rlk'], body, offset, params, ctx.device)
        for elt, meta in header.get('glk', {}).items():
            ctx.glk.keys[int(elt)], offset = _unpack_ksk(meta, body, offset, params, ctx.device)
        for name, meta in header.get('swk', {}).items():
            ctx.swk[name], offset = _unpack_ksk(meta, body, offset, params, ctx.device)
    return ctx
