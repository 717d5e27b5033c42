"""RLWE security estimation from the HE-standard tables.

Maps (ring dimension n, total modulus bits logQP) to a classical security
tier using the Homomorphic Encryption Standard's recommended maximum
modulus sizes for ternary secrets (homomorphicencryption.org, 2018 tables;
the same tables SEAL enforces and Lattigo documents). The n=2^16 row is
not part of the published standard — the 128-bit bound there follows the
convention of production libraries' default profiles (Lattigo's
N16QP1546/N16QP1761 bootstrap parameter sets sit under ≈1792 bits).

These are *estimates for the standard uniform-ternary secret
distribution*; sparse secrets (bootstrap contexts with Hamming weight h)
are strictly weaker and not modeled by the table — treat the returned
tier as an upper bound there.
"""

import math
import warnings

# max log2(QP) for classical security {128, 192, 256} bits, ternary secret
_MAX_LOGQP = {
    1024:  {128: 27,   192: 19,  256: 14},
    2048:  {128: 54,   192: 37,  256: 29},
    4096:  {128: 109,  192: 75,  256: 58},
    8192:  {128: 218,  192: 152, 256: 118},
    16384: {128: 438,  192: 305, 256: 237},
    32768: {128: 881,  192: 611, 256: 476},
    65536: {128: 1792},      # library-convention row (see module docstring)
}


def log_qp(params) -> float:
    """Total modulus size log2(Q·P) of a parameter set."""
    return float(sum(math.log2(m) for m in list(params.q) + list(params.p)))


def security_bits(params) -> int:
    """Highest standard tier (256/192/128) whose bound covers the
    parameter set's logQP, or 0 if it exceeds even the 128-bit bound.
    Unknown ring dimensions return 0 (no table row)."""
    row = _MAX_LOGQP.get(int(params.n), {})
    lqp = log_qp(params)
    for tier in (256, 192, 128):
        if tier in row and lqp <= row[tier]:
            return tier
    return 0


def check_security(params, min_bits: int = 128, stacklevel: int = 2) -> int:
    """Warn (UserWarning) when ``params`` misses ``min_bits`` of classical
    security; returns the estimated tier either way."""
    tier = security_bits(params)
    if tier < min_bits:
        row = _MAX_LOGQP.get(int(params.n), {})
        bound = row.get(min_bits)
        detail = (f'needs logQP <= {bound}' if bound is not None
                  else 'no standard table row for this n')
        warnings.warn(
            f'parameter set n={params.n} logQP={log_qp(params):.0f} is below '
            f'{min_bits}-bit classical security ({detail}); shorten the '
            f'prime chain or increase n', UserWarning, stacklevel=stacklevel)
    return tier
