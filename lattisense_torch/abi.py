"""Raw-RNS C ABI: the exchange format of the plug-in boundary.

Port of ``lattisense_tpu/abi.py`` (reference parity: abi/c_types.h:26-60),
the struct layout other libraries (SEAL, Lattigo plug-ins) use to hand
polynomials to the runners:

    CComponent    { int n;  uint64* data; }              # one limb
    CPolynomial   { int n_component;  CComponent* }      # limbs of one poly
    CPlaintext    { int level;  CPolynomial poly; }
    CCiphertext   { int level;  int degree;  CPolynomial* polys; }
    CPublicKey    = CCiphertext
    CKeySwitchKey { int n_public_key;  CPublicKey* }     # one per digit
    CRelinKey     = CKeySwitchKey
    CGaloisKey    { int n_key_switch_key;  uint64* galois_elements;
                    CKeySwitchKey* }

The ctypes structures have the header's field layout (``int`` fields are C
``int``), so a foreign library links against these buffers. Exporters take
the port's int64 tensors on any device and copy them into host ``uint64``
buffers, which the returned ``_Exported`` keeps alive; importers copy the
buffers into int64 tensors on the device the caller names (the card unless
``device='cpu'``).

Montgomery form (the reference's ``mf_nbits``, cxx_sdk_v2/
cxx_abi_bridge_executors.h:70-82): keys live in NTT + Montgomery form;
``mf_nbits=0`` exchanges plain NTT-domain residues, leaving and re-entering
the Montgomery form with the Q∪P ring's word (``word.from_mont`` /
``to_mont``, on the ring's device); any other value exchanges the keys as
stored.
"""

import ctypes

import numpy as np
import torch

from . import resolve_device
from .schemes.types import Ciphertext, KeySwitchKey, Plaintext
from .utils.serialize import _host, _tensor

_U64P = ctypes.POINTER(ctypes.c_uint64)
_INT = ctypes.c_int     # the header's fields are C int (abi/c_types.h:27)


class CComponent(ctypes.Structure):
    _fields_ = [('n', _INT), ('data', _U64P)]


class CPolynomial(ctypes.Structure):
    _fields_ = [('n_component', _INT),
                ('components', ctypes.POINTER(CComponent))]


class CPlaintext(ctypes.Structure):
    _fields_ = [('level', _INT), ('poly', CPolynomial)]


class CCiphertext(ctypes.Structure):
    _fields_ = [('level', _INT), ('degree', _INT),
                ('polys', ctypes.POINTER(CPolynomial))]


CPublicKey = CCiphertext


class CKeySwitchKey(ctypes.Structure):
    _fields_ = [('n_public_key', _INT),
                ('public_keys', ctypes.POINTER(CPublicKey))]


CRelinKey = CKeySwitchKey


class CGaloisKey(ctypes.Structure):
    _fields_ = [('n_key_switch_key', _INT),
                ('galois_elements', _U64P),
                ('key_switch_keys', ctypes.POINTER(CKeySwitchKey))]


class _Exported:
    """Owns the host buffers and ctypes arrays behind an exported struct."""

    def __init__(self, struct, buffers):
        self.struct = struct
        self._buffers = buffers


def _poly_struct(arr2d: np.ndarray, keep):
    """A (L, n) uint64 host array as a CPolynomial over its rows."""
    arr2d = np.ascontiguousarray(arr2d)
    keep.append(arr2d)
    L, n = arr2d.shape
    comps = (CComponent * L)()
    for i in range(L):
        comps[i] = CComponent(n, arr2d[i].ctypes.data_as(_U64P))
    keep.append(comps)
    return CPolynomial(L, comps)


def _read_poly(poly: CPolynomial) -> np.ndarray:
    """A CPolynomial's limbs as a (L, n) int64 host array (a copy)."""
    return np.stack([np.ctypeslib.as_array(poly.components[i].data,
                                           shape=(poly.components[i].n,))
                     for i in range(poly.n_component)]).view(np.int64)


def export_ciphertext(ct: Ciphertext) -> _Exported:
    """Ciphertext → CCiphertext over a host copy of its limbs."""
    data = _host(ct.data)
    keep: list = []
    polys = (CPolynomial * data.shape[0])()
    for j in range(data.shape[0]):
        polys[j] = _poly_struct(data[j], keep)
    keep.append(polys)
    return _Exported(CCiphertext(ct.level, ct.degree, polys), keep)


def import_ciphertext(c: CCiphertext, is_ntt: bool = False, scale: float = 1.0,
                      device=None) -> Ciphertext:
    data = np.stack([_read_poly(c.polys[j]) for j in range(c.degree + 1)])
    return Ciphertext(data=_tensor(data, resolve_device(device)), level=int(c.level),
                      is_ntt=is_ntt, scale=scale)


def export_plaintext(pt: Plaintext) -> _Exported:
    keep: list = []
    return _Exported(CPlaintext(pt.level, _poly_struct(_host(pt.data), keep)), keep)


def import_plaintext(c: CPlaintext, is_ntt: bool = False, scale: float = 1.0,
                     device=None) -> Plaintext:
    return Plaintext(data=_tensor(_read_poly(c.poly), resolve_device(device)),
                     level=int(c.level), is_ntt=is_ntt, scale=scale)


# ---------------------------------------------------------------------------
# evaluation keys (CKeySwitchKey / CRelinKey / CGaloisKey)
# ---------------------------------------------------------------------------

def _need_ring(qp_ring, what: str):
    if qp_ring is None:
        raise ValueError(f'mf_nbits=0 needs the Q∪P ring {what}')


def export_keyswitch_key(ksk: KeySwitchKey, mf_nbits: int = 64, qp_ring=None) -> _Exported:
    """KeySwitchKey → CKeySwitchKey: one CPublicKey (a degree-1 ciphertext
    over Q∪P) per decomposition digit, limbs ordered Q then P.
    ``mf_nbits=0`` needs ``qp_ring`` to leave the Montgomery form."""
    data = torch.cat([ksk.key_q, ksk.key_p], dim=2)          # (β, 2, T, n)
    if mf_nbits == 0:
        _need_ring(qp_ring, 'for de-Montgomery')
        data = qp_ring.word.from_mont(data.to(qp_ring.device), qp_ring.q, qp_ring.pinv)
    data = _host(data)
    beta, _, T, _ = data.shape
    keep: list = []
    pks = (CPublicKey * beta)()
    for d in range(beta):
        polys = (CPolynomial * 2)()
        for j in range(2):
            polys[j] = _poly_struct(data[d, j], keep)
        keep.append(polys)
        pks[d] = CPublicKey(T - 1, 1, polys)
    keep.append(pks)
    return _Exported(CKeySwitchKey(beta, pks), keep)


def import_keyswitch_key(c: CKeySwitchKey, level: int, sp_level: int, mf_nbits: int = 64,
                         qp_ring=None, device=None) -> KeySwitchKey:
    """CKeySwitchKey → KeySwitchKey, splitting the Q∪P limbs at level+1, on
    ``device`` (the ring's device when a ring is given and no device)."""
    if device is None and qp_ring is not None:
        device = qp_ring.device
    dev = resolve_device(device)
    data = np.stack([np.stack([_read_poly(c.public_keys[d].polys[j]) for j in range(2)])
                     for d in range(c.n_public_key)])      # (β, 2, T, n)
    data = _tensor(data, dev)
    if mf_nbits == 0:
        _need_ring(qp_ring, 'to re-enter Montgomery form')
        data = qp_ring.word.to_mont(data, qp_ring.q, qp_ring.pinv, qp_ring.r2)
    Lq = level + 1
    return KeySwitchKey(key_q=data[:, :, :Lq].contiguous(), key_p=data[:, :, Lq:].contiguous(),
                        level=level, sp_level=sp_level)


def export_galois_keys(glk: dict, mf_nbits: int = 64, qp_ring=None) -> _Exported:
    """{galois_element: KeySwitchKey} → CGaloisKey, elements ascending."""
    elements = sorted(glk.keys())
    elems = np.asarray(elements, dtype=np.uint64)
    keep: list = [elems]
    ksks = (CKeySwitchKey * len(elements))()
    for i, elt in enumerate(elements):
        e = export_keyswitch_key(glk[elt], mf_nbits, qp_ring)
        keep.append(e)
        ksks[i] = e.struct
    keep.append(ksks)
    return _Exported(CGaloisKey(len(elements), elems.ctypes.data_as(_U64P), ksks), keep)


def import_galois_keys(c: CGaloisKey, level: int, sp_level: int, mf_nbits: int = 64,
                       qp_ring=None, device=None) -> dict:
    return {int(c.galois_elements[i]): import_keyswitch_key(
        c.key_switch_keys[i], level, sp_level, mf_nbits, qp_ring, device)
        for i in range(c.n_key_switch_key)}
