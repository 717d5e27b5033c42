"""Homomorphic linear transforms: slot-space matrix × ciphertext by diagonals,
with baby-step / giant-step rotations and hoisted key-switch digits.

Port of ``lattisense_tpu/schemes/linear_transform.py`` to the port's engine
(the engine methods take tensors; leading batch dimensions are batches).
(Mv)_k = Σ_d diag_d[k] · v[k+d], so a matrix with diagonal support D costs
|D| plaintext products and, split d = g·n1 + b, |babies| + |giants|
rotations; the baby rotations share one ``rns_sp_decomp`` (hoisting). This
is the engine of CKKS bootstrapping's CoeffsToSlots and SlotsToCoeffs.

Giant-step correction: out = Σ_g rot_g(Σ_b pre_g(diag_{g+b}) ⊙ rot_b(ct))
needs each diagonal pre-rotated by -g when it is encoded. The diagonals are
encoded on the host in NumPy float64 and cached on the device per (level,
scale) of the ciphertexts the transform meets.
"""

import numpy as np

from .galois import galois_elt_col
from .types import Ciphertext


class EncodedLinearTransform:
    """The encoded diagonals of one matrix, for application on the device.

    ``diags``: {offset: complex slot vector (slots,)}; offsets taken mod slots.
    """

    def __init__(self, engine, diags: dict, level: int, n1: int,
                 scale: float | None = None,
                 out_scale_target: float | None = None,
                 limb_step: int = 1):
        """``scale=None`` encodes the diagonals lazily at the product of the
        primes the transform's rescale divides by, so the running scale is
        kept exactly on any chain. ``out_scale_target`` instead steers the
        rescaled output onto a fixed scale (the bootstrap's EvalMod entry).
        ``limb_step``: the limbs one transform level consumes (2 on the
        32-bit word, where the working scale spans a pair of primes)."""
        self.engine = engine
        self.level = level
        self.n1 = n1
        self.scale = scale
        self.out_scale_target = out_scale_target
        self.step = int(limb_step)
        slots = engine.params.slots
        self.slots = slots
        self.raw: dict[tuple[int, int], np.ndarray] = {}
        self._plain_cache: dict = {}
        self.babies: set[int] = set()
        self.giants: set[int] = set()
        for off, vec in diags.items():
            off = off % slots
            g, b = (off // n1) * n1, off % n1
            self.babies.add(b)
            if g:
                self.giants.add(g)
            # pre-rotate by -g so the giant rotation can be applied last
            self.raw[(g, b)] = np.roll(np.asarray(vec, dtype=np.complex128), g)
        if scale is not None:
            self._plain_cache[level] = {
                k: engine.encode_mul(v, level, scale) for k, v in self.raw.items()}

    def _plain(self, ct_level: int, ct_scale: float):
        if self.scale is not None:
            return self._plain_cache[self.level]
        q_lv = 1.0
        for j in range(ct_level - self.step + 1, ct_level + 1):
            q_lv *= float(self.engine.q[j])
        if self.out_scale_target is not None:
            scale = self.out_scale_target * q_lv / ct_scale
        else:
            scale = q_lv
        key = (ct_level, scale)
        if key not in self._plain_cache:
            self._plain_cache[key] = {
                k: self.engine.encode_mul(v, self.level, scale)
                for k, v in self.raw.items()}
        return self._plain_cache[key]

    def galois_elements(self):
        n = self.engine.params.n
        return [galois_elt_col(r, n) for r in sorted((self.babies | self.giants) - {0})]

    def __call__(self, ct: Ciphertext, glk_map: dict) -> Ciphertext:
        """Apply to a CKKS ciphertext (NTT domain) at ``self.level`` or below."""
        eng = self.engine
        n = eng.params.n
        plain = self._plain(ct.level, ct.scale)

        # hoist: one decomposition serves every baby rotation
        rotated: dict[int, Ciphertext] = {}
        if 0 in self.babies:
            rotated[0] = ct
        nonzero = sorted(self.babies - {0})
        if nonzero:
            dct = eng.rns_sp_decomp(ct)
            for b in nonzero:
                elt = galois_elt_col(b, n)
                rotated[b] = eng.apply_galois_decomposed(dct, elt, glk_map[elt])

        # baby products grouped per giant step, then the giant rotations
        out = None
        for g in sorted({g for g, _ in plain}):
            acc = None
            for (gg, b), pt in plain.items():
                if gg != g:
                    continue
                term = eng.mult(rotated[b], pt)
                acc = term if acc is None else eng.add(acc, term)
            if g:
                elt = galois_elt_col(g, n)
                acc = eng.apply_galois(acc, elt, glk_map[elt])
            out = acc if out is None else eng.add(out, acc)
        return out


def matrix_diagonals(mat: np.ndarray, tol: float = 0.0) -> dict:
    """Dense (s, s) matrix → {offset: diagonal vector}; offsets whose entries
    are all at most ``tol`` in magnitude are dropped."""
    s = mat.shape[0]
    out = {}
    idx = np.arange(s)
    for d in range(s):
        diag = mat[idx, (idx + d) % s]
        if np.max(np.abs(diag)) > tol:
            out[d] = diag
    return out


def bsgs_split(n_diags_offsets, slots: int, ratio: float = 2.0) -> int:
    """The power-of-two baby window n1 with the fewest rotations."""
    best_n1, best_cost = 1, None
    n1 = 1
    while n1 <= slots:
        giants = {((d % slots) // n1) * n1 for d in n_diags_offsets}
        babies = {(d % slots) % n1 for d in n_diags_offsets}
        cost = len(giants - {0}) + len(babies - {0})
        if best_cost is None or cost < best_cost:
            best_n1, best_cost = n1, cost
        n1 <<= 1
    return best_n1
