"""Special-FFT factorization for CKKS bootstrapping linear transforms.

Host NumPy, the port's copy of ``lattisense_tpu/schemes/special_fft.py``.

The decode map on folded coefficients u_c = m_c + i·m_{c+s} (s = n/2) is
z_c = Σ_j u_j ω^{5^c j} (ω = e^{iπ/n}) — a size-s transform over the
index group ⟨5⟩. It factors into log2(s) radix-2 butterfly stages S_L
(butterfly distance L, twiddles w_j = ω^{(s/2L)·5^j}):

    z = S_{s/2} ∘ … ∘ S_2 ∘ S_1 ∘ BR (u)

The bit-reversal BR is never applied homomorphically: CoeffsToSlots uses
the inverse stages only (producing coefficients in bit-reversed slot
order), EvalMod is slot-wise, and SlotsToCoeffs replays the forward stages
— the orderings cancel exactly (Lattigo's bit_reversed convention,
reference frontend/bootstrap_params.py).

Each stage has diagonals {0, +L, −L}; adjacent stages merge into `depth`
groups by diagonal-algebra composition (reference merge schedule:
EncodingMatrixParams._merge_schedule).
"""

import numpy as np


def _twiddles(s: int, L: int) -> np.ndarray:
    """w_j = ω^{(s/(2L))·5^j mod 4s} for j < L (ω = primitive 4s-th root)."""
    two_n = 4 * s
    exps = np.empty(L, dtype=np.int64)
    g = 1
    for j in range(L):
        exps[j] = (s // (2 * L)) * g % two_n
        g = g * 5 % two_n
    return np.exp(2j * np.pi * exps / two_n)


def stage_diagonals(s: int, L: int, inverse: bool = False) -> dict:
    """Diagonals of the butterfly stage S_L (or its inverse) as
    {offset: complex (s,) vector}."""
    w = _twiddles(s, L)
    r = np.arange(s)
    j = r % (2 * L)
    top = j < L
    wj = np.where(top, w[j % L], w[(j - L) % L])
    d0 = np.empty(s, dtype=np.complex128)
    dp = np.zeros(s, dtype=np.complex128)
    dm = np.zeros(s, dtype=np.complex128)
    if not inverse:
        # out[r] = in[r] + w·in[r+L] (top) ; out[r] = in[r-L] − w·in[r] (bottom)
        d0[top] = 1.0
        d0[~top] = -wj[~top]
        dp[top] = wj[top]
        dm[~top] = 1.0
    else:
        # in = S^{-1} out: top: (out_r + out_{r+L})/2 ; bottom j:
        # (out_{r-L} − out_r)/(2 w_j)
        d0[top] = 0.5
        d0[~top] = -0.5 / wj[~top]
        dp[top] = 0.5
        dm[~top] = 0.5 / wj[~top]
    out = {0: d0}
    for off, d in (((L % s), dp), ((-L) % s, dm)):
        # at the top stage +L ≡ −L (mod s): accumulate, don't clobber
        out[off] = out.get(off, 0) + d
    return out


def compose_diagonals(a: dict, b: dict, s: int) -> dict:
    """Diagonal form of A·B (apply B first):
    C_o[r] = Σ_{o1+o2≡o} A_{o1}[r] · B_{o2}[(r+o1) mod s]."""
    out: dict = {}
    for o1, da in a.items():
        for o2, db in b.items():
            o = (o1 + o2) % s
            term = da * np.roll(db, -o1)
            if o in out:
                out[o] = out[o] + term
            else:
                out[o] = term.copy()
    return {o: v for o, v in out.items() if np.max(np.abs(v)) > 1e-14}


def merge_schedule(log_s: int, depth: int) -> list[int]:
    """Distribute log_s radix-2 stages over `depth` merged groups
    (reference: EncodingMatrixParams._merge_schedule)."""
    merge = []
    remaining = log_s
    for i in range(depth):
        d = -(-remaining // (depth - i))
        merge.append(d)
        remaining -= d
    return merge


def bit_reverse_perm(s: int) -> np.ndarray:
    bits = s.bit_length() - 1
    out = np.empty(s, dtype=np.int64)
    for i in range(s):
        r = 0
        x = i
        for _ in range(bits):
            r = (r << 1) | (x & 1)
            x >>= 1
        out[i] = r
    return out


def cts_matrices(s: int, depth: int, post_scale: complex = 1.0) -> list[dict]:
    """CoeffsToSlots merged groups, application order first→last:
    z → BR(u)·post_scale. Stage order: S_{s/2}^{-1} first, S_1^{-1} last;
    groups follow the reference merge schedule on that ordering."""
    log_s = s.bit_length() - 1
    stages = [stage_diagonals(s, 1 << (log_s - 1 - i), inverse=True)
              for i in range(log_s)]
    groups = []
    i = 0
    for cnt in merge_schedule(log_s, depth):
        g = stages[i]
        for k in range(1, cnt):
            # applied after g: later stage composes on the left
            g = compose_diagonals(stages[i + k], g, s)
        groups.append(g)
        i += cnt
    if post_scale != 1.0:
        groups[-1] = {o: v * post_scale for o, v in groups[-1].items()}
    return groups


def stc_matrices(s: int, depth: int, post_scale: complex = 1.0) -> list[dict]:
    """SlotsToCoeffs merged groups: BR(u) → z·post_scale. Stage order S_1
    first, S_{s/2} last; the merge distribution is reversed relative to
    CoeffsToSlots (reference EncodingMatrixParams._merge_schedule)."""
    log_s = s.bit_length() - 1
    stages = [stage_diagonals(s, 1 << i) for i in range(log_s)]
    groups = []
    i = 0
    for cnt in merge_schedule(log_s, depth)[::-1]:
        g = stages[i]
        for k in range(1, cnt):
            g = compose_diagonals(stages[i + k], g, s)
        groups.append(g)
        i += cnt
    if post_scale != 1.0:
        groups[-1] = {o: v * post_scale for o, v in groups[-1].items()}
    return groups


def apply_diagonals(diags: dict, v: np.ndarray) -> np.ndarray:
    """Plain (host) application — test oracle and golden model."""
    s = len(v)
    out = np.zeros(s, dtype=np.complex128)
    for o, d in diags.items():
        out += d * np.roll(v, -o)
    return out
