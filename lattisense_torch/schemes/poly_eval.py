"""Homomorphic polynomial evaluation in the Chebyshev basis
(Paterson–Stockmeyer recursion over T_{2^k} giants, log depth).

Port of ``lattisense_tpu/schemes/poly_eval.py`` to the port's engine (the
engine methods take tensors; leading batch dimensions are batches). It backs
CKKS bootstrapping's EvalMod (a scaled cosine) and the polynomial
activations of the reference SDK (CkksContext::poly_eval_relu_function /
poly_eval_step_function, fhe_lib_v2.h:1101-1135).

Scale discipline: a backward plan σ(ℓ) = sqrt(σ(ℓ-step)·q_ℓ) makes any two
branches meeting at a level carry the same scale; products rescale onto the
plan, constant products steer onto it, and additions align their operands
by dropping levels and one steering product. The scales are host floats,
set exactly as the reference sets them.
"""

import numpy as np

from .types import Ciphertext



def chebyshev_interpolate(f, a: float, b: float, degree: int) -> np.ndarray:
    """Chebyshev series coefficients of f on [a, b] (degree+1 terms)."""
    k = np.arange(degree + 1)
    nodes = np.cos(np.pi * (k + 0.5) / (degree + 1))
    vals = f((b - a) / 2 * nodes + (b + a) / 2)
    # DCT-based projection
    coeffs = np.empty(degree + 1)
    for j in range(degree + 1):
        coeffs[j] = 2.0 / (degree + 1) * np.sum(vals * np.cos(np.pi * j * (k + 0.5) / (degree + 1)))
    coeffs[0] /= 2.0
    return coeffs


def cheb_divmod(c: np.ndarray, g: int):
    """p = q·T_g + r in the Chebyshev basis (deg r < g)."""
    c = np.array(c, dtype=np.float64)
    d = len(c) - 1
    q = np.zeros(max(d - g + 1, 1))
    for i in range(d, g, -1):
        ci = c[i]
        if ci == 0.0:
            continue
        q[i - g] += 2.0 * ci
        c[i] = 0.0
        c[abs(i - 2 * g)] -= ci
    if d >= g:
        q[0] += c[g]
        c[g] = 0.0
    return q, c[:g]


def eval_chebyshev_plain(coeffs, y):
    """Clenshaw reference evaluation (oracle for tests)."""
    b1 = b2 = 0.0
    for c in coeffs[::-1][:-1]:
        b1, b2 = 2 * y * b1 - b2 + c, b1
    return y * b1 - b2 + coeffs[0]


class ChebyshevEvaluator:
    """Evaluate Σ c_i·T_i((2x-(a+b))/(b-a)) on a CKKS ciphertext."""

    def __init__(self, engine, coeffs, a: float, b: float,
                 baby_log: int | None = None, pre_normalized: bool = False,
                 limb_step: int = 1):
        """``pre_normalized``: the operand already lives on [-1, 1] (the
        caller folded the affine map into an upstream constant, e.g. the
        bootstrap CoeffsToSlots post-scale) — saves one level.

        ``limb_step``: limbs consumed per multiplicative level. 1 for
        chains whose primes match the working scale (the u64 layout);
        2 for the 32-bit-word engine, where the working scale ≈ 2^62
        spans a PAIR of 31-bit primes and every rescale drops two limbs
        (composite scaling — the TPU-native bootstrap's level unit)."""
        self.engine = engine
        self.coeffs = np.asarray(coeffs, dtype=np.float64)
        self.a, self.b = float(a), float(b)
        self.pre_normalized = pre_normalized
        self.step = int(limb_step)
        if pre_normalized:
            assert abs(a + b) < 1e-12, 'pre-normalized domain must be symmetric'
        d = len(self.coeffs) - 1
        m = max((d).bit_length(), 1)
        self.baby_log = baby_log if baby_log is not None else (m + 1) // 2
        # giants the recursion reads: T_{2^(bl+1)} .. T_{2^(m-1)} (the top
        # divmod block is 2^(m-1); the babies provide T_{2^bl})
        self.giant_logs = list(range(self.baby_log, m - 1))

    # ---- scale-targeted level plan ---------------------------------------
    # Backward plan (Lattigo-style): σ(ℓ) := sqrt(σ(ℓ-1)·q_ℓ). A product of
    # two σ(ℓ) operands rescales to σ(ℓ)²/q_ℓ = σ(ℓ-1) EXACTLY, so any two
    # recursion branches meeting at a level carry identical scales by
    # construction — stable under mixed prime sizes (the forward recurrence
    # σ²/q squares deviations and diverges). The sqrt damps the anchor
    # choice; anchored at the EvalMod/entry magnitude.
    def _qstep(self, level: int) -> float:
        """Product of the ``step`` primes a rescale chain from ``level``
        divides by (q_level for step 1; q_level·q_{level-1} for pairs)."""
        q = self.engine.q
        out = 1.0
        for j in range(level - self.step + 1, level + 1):
            out *= float(q[j])
        return out

    def _rescale(self, ct):
        for _ in range(self.step):
            ct = self.engine.rescale(ct)
        return ct

    def _plan_scales(self, anchor: float):
        q = self.engine.q
        sigma = {lv: float(anchor) for lv in range(self.step)}
        for lv in range(self.step, len(q)):
            sigma[lv] = float(np.sqrt(sigma[lv - self.step] * self._qstep(lv)))
        self._sigma = sigma

    def planned_scale(self, level: int, anchor: float) -> float:
        """The plan's scale at ``level`` — upstream producers (bootstrap
        CoeffsToSlots) steer onto this so the evaluator enters on-plan
        without spending a level."""
        self._plan_scales(anchor)
        return self._sigma[level]

    def _to_level(self, ct, level: int):
        """Bring ct down to ``level`` landing exactly on σ(level): free
        drops to level+step, then one steering constant multiply."""
        if ct.level == level:
            return ct
        eng = self.engine
        if ct.level > level + self.step:
            ct = eng.drop_level(ct, ct.level - level - self.step)
        pt_scale = self._sigma[level] * self._qstep(ct.level) / ct.scale
        pt = eng.encode_const(1.0, ct.level, pt_scale)
        out = self._rescale(eng.mult(ct, pt))
        out.scale = self._sigma[level]
        return out

    def _align(self, cts: list) -> list:
        level = min(c.level for c in cts)
        return [self._to_level(c, level) for c in cts]

    def _add(self, x, y):
        x, y = self._align([x, y])
        return self.engine.add(x, y)

    def _add_const(self, ct, value: float):
        eng = self.engine
        pt = eng.encode_const(value, ct.level, ct.scale)
        return eng.add(ct, pt)

    def _mul_const(self, ct, value: float, rescale=True):
        """Constant multiply landing exactly on σ(level-step)."""
        eng = self.engine
        pt_scale = (self._sigma[ct.level - self.step]
                    * self._qstep(ct.level) / ct.scale)
        pt = eng.encode_const(value, ct.level, pt_scale)
        out = eng.mult(ct, pt)
        if not rescale:
            return out
        out = self._rescale(out)
        out.scale = self._sigma[out.level]
        return out

    def _mult(self, x, y, rlk):
        x, y = self._align([x, y])
        out = self._rescale(self.engine.relinearize(self.engine.mult(x, y), rlk))
        # x.scale·y.scale/Πq ≡ σ(ℓ-step) by the plan; pin the float exactly
        out.scale = self._sigma[out.level]
        return out

    # ---- basis -----------------------------------------------------------
    def _basis_babies(self, ct, rlk):
        """T_1 = affine(x); babies T_2..T_{2^bl}."""
        a, b = self.a, self.b
        if self.pre_normalized:
            y = ct
        else:
            y = self._mul_const(ct, 2.0 / (b - a))
            y = self._add_const(y, -(a + b) / (b - a))
        T = {1: y}
        for k in range(1, 1 << self.baby_log):
            if k + 1 in T or k + 1 == 1:
                continue
            half, other = (k + 1) // 2, k + 1 - (k + 1) // 2
            if half == other:
                t = self._mult(T[half], T[half], rlk)
                t = self._add(t, t)                       # 2T²
                T[k + 1] = self._add_const(t, -1.0)       # −T_0
            else:
                # T_a T_b = (T_{a+b} + T_{a−b})/2
                t = self._mult(T[half], T[other], rlk)
                t = self._add(t, t)
                diff = other - half
                if diff == 0:
                    T[k + 1] = self._add_const(t, -1.0)
                else:
                    # pre-drop T_diff so its -1 multiply lands exactly on
                    # t's (level, scale) — no align steer in the add
                    td = T[diff]
                    if td.level > t.level + self.step:
                        td = self.engine.drop_level(td, td.level - t.level - self.step)
                    corr = self._mul_const(td, -1.0)
                    T[k + 1] = self._add(t, corr)
        return T

    def _basis_giants(self, T, rlk):
        for lg in self.giant_logs:
            src = 1 << lg
            t = self._mult(T[src], T[src], rlk)
            t = self._add(t, t)
            T[2 * src] = self._add_const(t, -1.0)
        return T

    def _basis(self, ct, rlk):
        return self._basis_giants(self._basis_babies(ct, rlk), rlk)

    # canonical basis-key orders for the staged evaluation boundaries
    def _baby_keys(self):
        return sorted({1} | set(range(2, (1 << self.baby_log) + 1)))

    def _all_keys(self):
        return sorted(set(self._baby_keys())
                      | {2 << lg for lg in self.giant_logs})

    def _eval_rec(self, coeffs, T, rlk):
        d = len(coeffs) - 1
        if d < (1 << self.baby_log):
            # direct: c_0 + Σ c_i T_i at a common level and scale. Each
            # term is dropped to the common level first, so its one
            # constant product lands exactly on σ(common).
            idx = [i for i in range(1, d + 1) if abs(coeffs[i]) >= 1e-14]
            const = coeffs[0]
            if not idx:
                base = self._mul_const(T[1], 0.0)
                return self._add_const(base, float(const))
            eng = self.engine
            common = min(T[i].level for i in idx) - self.step
            terms = []
            for i in idx:
                t = T[i]
                if t.level > common + self.step:
                    t = eng.drop_level(t, t.level - common - self.step)
                terms.append(self._mul_const(t, float(coeffs[i])))
            out = terms[0]
            for t in terms[1:]:
                out = eng.add(out, t)        # same level+scale by plan
            return self._add_const(out, float(const))
        g = 1 << (d.bit_length() - 1)
        q, r = cheb_divmod(coeffs, g)
        qc = self._eval_rec(q, T, rlk)
        rc = self._eval_rec(r, T, rlk)
        out = self._mult(qc, T[g], rlk)
        return self._add(out, rc)

    def _enter(self, ct):
        """Steer onto the plan: one steering multiply if off by > 1e-9."""
        sig = self._sigma[ct.level]
        if abs(ct.scale - sig) / sig > 1e-9:
            eng = self.engine
            pt_scale = (self._sigma[ct.level - self.step]
                        * self._qstep(ct.level) / ct.scale)
            pt = eng.encode_const(1.0, ct.level, pt_scale)
            ct = self._rescale(eng.mult(ct, pt))
            ct.scale = self._sigma[ct.level]
        return ct

    def __call__(self, ct: Ciphertext, rlk, anchor: float | None = None) -> Ciphertext:
        self._plan_scales(anchor or ct.scale)
        ct = self._enter(ct)
        T = self._basis(ct, rlk)
        return self._eval_rec(self.coeffs, T, rlk)

    def stages(self, anchor: float):
        """The evaluation as [(suffix, fn)] with
        fn(cts: list[Ciphertext], rlk) -> list[Ciphertext]; folding in
        order is op-for-op identical to ``__call__(..., anchor=anchor)``.

        The bootstrap's segments (and a task's partitioned run, one CUDA
        graph a segment) cut the evaluation here: baby basis, giant basis,
        the divmod tree's leaves, its combination. Boundaries carry the live
        basis entries in canonical key order (``_baby_keys`` /
        ``_all_keys``)."""
        def s_babies(cts, rlk):
            ct, = cts
            self._plan_scales(anchor)
            T = self._basis_babies(self._enter(ct), rlk)
            return [T[k] for k in self._baby_keys()]

        def s_giants(cts, rlk):
            self._plan_scales(anchor)
            T = dict(zip(self._baby_keys(), cts))
            T = self._basis_giants(T, rlk)
            return [T[k] for k in self._all_keys()]

        # The recursion in two stages:
        # 'l' evaluates every divmod-tree LEAF (constant multiplies only),
        # 'e' walks the tree combining them (the ct-ct giant multiplies).
        # Same ops, same operands, different emission order — values are
        # identical to the fused recursion.
        def _tree(coeffs):
            d = len(coeffs) - 1
            if d < (1 << self.baby_log):
                return ('leaf', coeffs)
            g = 1 << (d.bit_length() - 1)
            q, r = cheb_divmod(coeffs, g)
            return ('node', g, _tree(q), _tree(r))

        tree = _tree(self.coeffs)

        def _leaves(node, out):
            if node[0] == 'leaf':
                out.append(node[1])
            else:
                _leaves(node[2], out)
                _leaves(node[3], out)
            return out

        n_leaves = len(_leaves(tree, []))

        def _node_gs(node, out):
            if node[0] == 'node':
                out.add(node[1])
                _node_gs(node[2], out)
                _node_gs(node[3], out)
            return out

        # basis entries the combine stage multiplies by: every divmod
        # block size in the tree (giants AND the top baby T_{2^bl})
        comb_keys = sorted(_node_gs(tree, set()))

        def s_leaves(cts, rlk):
            self._plan_scales(anchor)
            T = dict(zip(self._all_keys(), cts))
            leaf_cts = [self._eval_rec(c, T, rlk)
                        for c in _leaves(tree, [])]
            return leaf_cts + [T[k] for k in comb_keys]

        def s_combine(cts, rlk):
            self._plan_scales(anchor)
            leaf_cts = list(cts[:n_leaves])
            T = dict(zip(comb_keys, cts[n_leaves:]))
            it = iter(leaf_cts)

            def walk(node):
                if node[0] == 'leaf':
                    return next(it)
                qc = walk(node[2])
                rc = walk(node[3])
                return self._add(self._mult(qc, T[node[1]], rlk), rc)
            return [walk(tree)]

        def s_eval(cts, rlk):
            self._plan_scales(anchor)
            T = dict(zip(self._all_keys(), cts))
            return [self._eval_rec(self.coeffs, T, rlk)]

        out = [('b', s_babies)]
        if self.giant_logs:
            out.append(('g', s_giants))
        if tree[0] == 'node':
            out += [('l', s_leaves), ('e', s_combine)]
        else:
            out.append(('e', s_eval))
        return out


def poly_eval_relu(engine, ct, rlk, degree: int = 15,
                   bound: float = 1.0):
    """Smooth ReLU ≈ x·sigmoid-ish via Chebyshev (reference
    poly_eval_relu_function semantics: polynomial ReLU approximation)."""
    ev = ChebyshevEvaluator(engine,
                            chebyshev_interpolate(lambda t: np.maximum(t, 0.0),
                                                  -bound, bound, degree),
                            -bound, bound)
    return ev(ct, rlk)


def poly_eval_step(engine, ct, rlk, degree: int = 15,
                   bound: float = 1.0):
    """Polynomial step/sign approximation (reference poly_eval_step_function)."""
    ev = ChebyshevEvaluator(engine,
                            chebyshev_interpolate(
                                lambda t: (np.tanh(20 * t) + 1) / 2,
                                -bound, bound, degree),
                            -bound, bound)
    return ev(ct, rlk)
