"""Plain modular arithmetic for the reference: the negacyclic NTT in the
ciphertexts' documented layout, and the CRT.

A ciphertext limb over a prime q is held either as coefficients or, "in the
NTT domain", as the evaluations of its polynomial at the odd powers of the
deterministic primitive 2n-th root ψ of q (the smallest base x >= 2 whose
power x^((q-1)/2n) is one), in bit-reversed order: position i holds
a(ψ^(2·brv(i)+1)). That layout is the reference SDK's and Lattigo's; it is
written out here from its definition.

Residues are int64 tensors on the device of the ciphertext they come from.
Below 2^31 every product fits. Up to 2^61 a product a·w mod q is put
together from 31-bit pieces: the multiplier is cut in two, and each partial
product's quotient by q comes from float64, off by at most one, while its
remainder is taken in pieces that each fit in int64, so that no step
overflows. Nothing here imports the program.
"""

import functools

import numpy as np
import torch

NARROW = 1 << 31
WIDE = 1 << 61
HALF = 31
MASK = (1 << HALF) - 1


@functools.lru_cache(maxsize=None)
def root_2n(q: int, n: int) -> int:
    if (q - 1) % (2 * n):
        raise ValueError(f'{q} is not NTT-friendly at n={n}')
    exp = (q - 1) // (2 * n)
    for x in range(2, 1 << 20):
        psi = pow(x, exp, q)
        if psi != 1 and pow(psi, n, q) == q - 1:
            return psi
    raise ValueError(f'no primitive 2n-th root of {q}')


def bitrev(n: int) -> np.ndarray:
    logn = n.bit_length() - 1
    idx = np.arange(n)
    out = np.zeros(n, dtype=np.int64)
    for b in range(logn):
        out |= ((idx >> b) & 1) << (logn - 1 - b)
    return out


@functools.lru_cache(maxsize=None)
def _tables(q: int, n: int):
    """ψ^brv(i) and ψ^-brv(i), i < n, as Python integers."""
    psi = root_2n(q, n)
    inv = pow(psi, -1, q)
    pw, pw_inv = [1] * n, [1] * n
    for i in range(1, n):
        pw[i] = pw[i - 1] * psi % q
        pw_inv[i] = pw_inv[i - 1] * inv % q
    br = bitrev(n)
    return [pw[j] for j in br], [pw_inv[j] for j in br]


def _table(q: int, n: int, inverse: bool, like):
    return torch.tensor(_tables(q, n)[1 if inverse else 0], dtype=torch.int64,
                        device=like.device)


def as_limb(x, q: int) -> torch.Tensor:
    """A limb's residues (..., n) as an int64 tensor in [0, q), on the
    device ``x`` is on."""
    if q >= WIDE:
        raise ValueError(f'{q} is wider than 61 bits')
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x).astype(np.int64))
    return x.to(torch.int64) % q


def _mul_short(a: torch.Tensor, m: torch.Tensor, q: int) -> torch.Tensor:
    """a·m mod q for 0 <= a < q < 2^61 and 0 <= m <= 2^31. With k the
    quotient from float64, a·m - k·q = (a1·m - k·q1)·2^31 + (a0·m - k·q0),
    where a = a1·2^31 + a0 and q = q1·2^31 + q0: every term fits in int64,
    and so does the sum, which lies in [-q, 2q)."""
    k = torch.floor(a.double() * m.double() / float(q)).to(torch.int64)
    r = ((a >> HALF) * m - k * (q >> HALF)) * (1 << HALF) + ((a & MASK) * m - k * (q & MASK))
    r = torch.where(r < 0, r + q, r)
    return torch.where(r >= q, r - q, r)


def mulmod(a: torch.Tensor, w, q: int) -> torch.Tensor:
    """a·w mod q, elementwise (broadcast), for residues in [0, q)."""
    if q < NARROW:
        return a * w % q
    w = torch.as_tensor(w, dtype=torch.int64, device=a.device)
    r = (_mul_short(_mul_short(a, w >> HALF, q), torch.tensor(1 << HALF, device=a.device), q)
         + _mul_short(a, w & MASK, q))
    return torch.where(r >= q, r - q, r)


def ntt(a, q: int):
    """Forward negacyclic NTT of the rows (..., n) of one limb: coefficients
    → evaluations in bit-reversed order (Cooley–Tukey, ψ^brv tables)."""
    n = a.shape[-1]
    lead = a.shape[:-1]
    w = _table(q, n, False, a)
    m, t = 1, n
    while m < n:
        t //= 2
        blk = a.reshape(*lead, m, 2, t)
        u, v = blk[..., 0, :], mulmod(blk[..., 1, :], w[m:2 * m].reshape(m, 1), q)
        a = torch.stack([(u + v) % q, (u - v) % q], -2).reshape(*lead, n)
        m *= 2
    return a


def intt(a, q: int):
    """Inverse of ``ntt``: bit-reversed evaluations → coefficients
    (Gentleman–Sande, ψ^-brv tables, then n^-1)."""
    n = a.shape[-1]
    lead = a.shape[:-1]
    w = _table(q, n, True, a)
    m, t = n, 1
    while m > 1:
        h = m // 2
        blk = a.reshape(*lead, h, 2, t)
        u, v = blk[..., 0, :], blk[..., 1, :]
        a = torch.stack([(u + v) % q, mulmod((u - v) % q, w[h:m].reshape(h, 1), q)],
                        -2).reshape(*lead, n)
        t *= 2
        m = h
    return mulmod(a, pow(n, -1, q), q)


def crt(limbs, moduli) -> tuple[np.ndarray, int]:
    """Residues [(..., n) per prime] → (the integers in [0, Q) as Python
    integers, Q)."""
    Q = 1
    for q in moduli:
        Q *= int(q)
    x = 0
    for r, q in zip(limbs, moduli):
        Qi = Q // int(q)
        arr = r.cpu().numpy() if isinstance(r, torch.Tensor) else np.asarray(r)
        x = x + arr.astype(object) * (Qi * pow(Qi, -1, int(q)))
    return x % Q, Q


def centered(x, Q: int):
    return np.where(x > Q // 2, x - Q, x)


def centered_float(limbs, moduli) -> np.ndarray:
    """The centred CRT of the residues [(..., n) per prime] as float64.

    A sound decryption's phase is far below q0/2 in magnitude: then it is
    limb 0's centred residue, and every other limb agrees with it; that
    value is exact in int64. Rows (...) where a limb disagrees are worked
    out again by the exact CRT of Python integers."""
    q0 = int(moduli[0])
    v = torch.where(limbs[0] > q0 // 2, limbs[0] - q0, limbs[0])
    ok = torch.ones(v.shape[:-1], dtype=torch.bool, device=v.device)
    for r, q in zip(limbs[1:], moduli[1:]):
        ok &= (v % int(q) == r).all(dim=-1)
    out = v.double().cpu().numpy()
    bad = ~ok.cpu().numpy()
    if bad.any():
        x, Q = crt([r.cpu().numpy()[bad] for r in limbs], moduli)
        out[bad] = centered(x, Q).astype(np.float64)
    return out
