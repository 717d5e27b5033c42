"""Fixture files of the C ABI plug-in client (``csrc/plugin_client.cpp``).

The port's copy of ``tools/plugin_fixture.py`` over this package's tensors:
the same bytes for the same values. Binary formats (little-endian; magics
'LSTC' / 'LSTK' / 'LSTG'):

  ct:  u32 magic, u32 level, u32 degree, u32 n_component, u32 n,
       (degree+1)*n_component*n u64 coefficients (limb-major)
  ksk: u32 magic, u32 n_public_key, u32 level, u32 n_component, u32 n,
       n_public_key * 2 * n_component * n u64
  glk: u32 magic, u32 n_key, u32 n_public_key, u32 level,
       u32 n_component, u32 n, then per key: u64 galois_element +
       n_public_key * 2 * n_component * n u64

Keys are written as plain NTT residues (the mf_nbits=0 exchange,
cxx_abi_bridge_executors.h:70): the runner re-enters Montgomery form at
import, as it would for a foreign library's export.
"""

import struct

import numpy as np
import torch

from .. import resolve_device
from ..schemes.types import Ciphertext
from ..utils.serialize import _host

CT_MAGIC = 0x4354534C
KSK_MAGIC = 0x4B54534C
GLK_MAGIC = 0x4754534C


def write_ct(path: str, ct) -> None:
    data = np.ascontiguousarray(_host(ct.data), dtype='<u8')
    deg, L, n = data.shape[0] - 1, data.shape[1], data.shape[2]
    with open(path, 'wb') as f:
        f.write(struct.pack('<5I', CT_MAGIC, ct.level, deg, L, n))
        f.write(data.tobytes())


def read_ct(path: str, device=None) -> Ciphertext:
    with open(path, 'rb') as f:
        magic, level, deg, L, n = struct.unpack('<5I', f.read(20))
        assert magic == CT_MAGIC, 'bad ct magic'
        data = np.frombuffer(f.read(8 * (deg + 1) * L * n), dtype='<u8').reshape(deg + 1, L, n)
    return Ciphertext(data=torch.from_numpy(data.astype(np.int64)).to(resolve_device(device)),
                      level=level)


def _ksk_plain(ksk, qp_ring) -> np.ndarray:
    """(β, 2, T, n) plain NTT residues of a key held in Montgomery form."""
    data = torch.cat([ksk.key_q, ksk.key_p], dim=2).to(qp_ring.device)
    return _host(qp_ring.word.from_mont(data, qp_ring.q, qp_ring.pinv))


def write_ksk(path: str, ksk, qp_ring) -> None:
    data = np.ascontiguousarray(_ksk_plain(ksk, qp_ring), dtype='<u8')
    beta, _, T, n = data.shape
    with open(path, 'wb') as f:
        f.write(struct.pack('<5I', KSK_MAGIC, beta, T - 1, T, n))
        f.write(data.tobytes())


def write_glk(path: str, glk: dict, qp_ring) -> None:
    elements = sorted(glk.keys())
    datas = [np.ascontiguousarray(_ksk_plain(glk[e], qp_ring), dtype='<u8') for e in elements]
    beta, _, T, n = datas[0].shape
    with open(path, 'wb') as f:
        f.write(struct.pack('<6I', GLK_MAGIC, len(elements), beta, T - 1, T, n))
        for elt, data in zip(elements, datas):
            f.write(struct.pack('<Q', elt))
            f.write(data.tobytes())
