"""The yardstick: the bytes and 32-bit integer operations an operation needs,
and the H100's peaks, frozen here so that no change to the program moves it.

The seven kernel work functions and their operation constants are copies of
those the kernels' bring-up measured with (``chip_smoke.py``, held equal to
it by ``portbench/tests/test_work.py``). Each counts the bytes of a call's
inputs, keys, tables and outputs once, and the operations its algorithm
needs, whatever route a kernel takes. The composite functions below them
add the work of one homomorphic operation of a cell: the multiply, the key
switch, the rescale.

The least time of a piece of work is the larger of its bytes over the HBM
bandwidth and its operations over the 32-bit integer rate: 64 results a
clock on each SM of compute capability 9.0 (CUDA C++ Programming Guide,
throughput of native arithmetic instructions), times the SMs the device
reports, times its maximum SM clock.
"""

PEAK_BYTES_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
INT32_PER_CLOCK_SM = 64

# 32-bit integer operations per step, counted from csrc/: a Shoup product is
# 6 (umulhi, two mul, sub, compare, select), a modular add or sub 3, a
# Montgomery product 8 (wide mul as two, mul, umulhi, two adds, compare,
# select).
OPS_SHOUP, OPS_ADDSUB, OPS_MONT = 6, 3, 8
OPS_BUTTERFLY = OPS_SHOUP + 2 * OPS_ADDSUB
# The 64-bit word in the same 32-bit operations: a 64x64 low product is 4,
# a high product 12, a 64-bit add, sub, compare or select 2. So a Shoup
# product is 26, a modular add or sub 6, a Montgomery product 40.
OPS64_SHOUP, OPS64_ADDSUB, OPS64_MONT = 26, 6, 40
OPS64_BUTTERFLY = OPS64_SHOUP + 2 * OPS64_ADDSUB


def int32_peak(sm_count: int, max_sm_clock_hz: float) -> float:
    """32-bit integer operations a second: 64 a clock on each SM."""
    return INT32_PER_CLOCK_SM * sm_count * max_sm_clock_hz


def least_s(work: tuple[float, float], int_peak: float) -> float:
    """The least seconds a (bytes, operations) pair can take on the card."""
    nbytes, ops = work
    return max(nbytes / PEAK_BYTES_S, ops / int_peak)


def add(*works: tuple[float, float]) -> tuple[float, float]:
    return (sum(w[0] for w in works), sum(w[1] for w in works))


# ---- the kernels' work (copies) --------------------------------------------

def ntt_work(rows: int, limbs: int, n: int) -> tuple[float, float]:
    """Bytes and operations of one B1 call: int64 rows in and out, the
    limbs' twiddle tables (value + companion, uint32) read once; log2(n)
    stages of n/2 butterflies plus the per-element epilogue."""
    logn = n.bit_length() - 1
    nbytes = 16.0 * rows * n + 8.0 * limbs * n
    ops = rows * (n // 2 * logn * OPS_BUTTERFLY + n * OPS_SHOUP)
    return nbytes, float(ops)


def behz_work(polys: int, L: int, T: int, n: int) -> tuple[float, float]:
    """Bytes and operations of one B2 call: x read once, fq and fa written
    once, both rings' tables read once; per coefficient 2L Shoup products
    and the m~ channel (3L), then per aux row L Shoup-accumulates and the
    SmMRq tail; then the forward NTT with epilogue over L+T rows."""
    nbytes = 8.0 * polys * (2 * L + T) * n + 8.0 * (L + T) * n
    per_coef = L * (2 * OPS_SHOUP + 3) + T * (L * (OPS_SHOUP + OPS_ADDSUB)
                                              + 3 * OPS_SHOUP + OPS_ADDSUB + 3)
    ops = polys * n * per_coef + ntt_work(polys * (L + T), L + T, n)[1]
    return nbytes, float(ops)


def ksw_work(G: int, L: int, alpha: int, beta: int, n: int,
             output_ntt: bool = False) -> tuple[float, float]:
    """Bytes and operations of one B3 call on G polynomials: x read once,
    the key's β digits over T = L+α rows read once, the Q_ℓ∪P twiddle tables
    of both directions read once, e0 and e1 written once (int64). The
    operations: per coefficient the decomposition and mod-up, the β·T-row
    forward NTT, the inner product, the 2T-row inverse NTT and the mod-down."""
    T = L + alpha
    nbytes = 8.0 * G * L * n + 8.0 * beta * 2 * T * n + 16.0 * G * L * n + 16.0 * T * n
    per_coef = (L * OPS_SHOUP + beta * T * alpha * (OPS_SHOUP + OPS_ADDSUB)
                + 2 * T * beta * (OPS_MONT + OPS_ADDSUB)
                + 2 * (alpha * (OPS_ADDSUB + OPS_SHOUP + 3)
                       + L * (alpha * (OPS_SHOUP + OPS_ADDSUB) + 3 * OPS_ADDSUB + OPS_SHOUP)))
    ops = (G * n * per_coef + ntt_work(G * beta * T, T, n)[1]
           + ntt_work(G * 2 * T, T, n)[1])
    if output_ntt:
        nbytes += 8.0 * L * n
        ops += ntt_work(G * 2 * L, L, n)[1]
    return nbytes, float(ops)


def finish_work(polys: int, L: int, T: int, n: int) -> tuple[float, float]:
    """Bytes and operations of one B4 call: dq and da read once, both rings'
    inverse twiddle tables read once, the output written once (int64). The
    operations: the inverse NTT with its epilogue over L+T rows, then per
    coefficient [tX]_Q, the conversion to the aux basis, the Q^-1 scale and
    Shenoy–Kumaresan back to Q."""
    Tb = T - 1
    nbytes = 8.0 * polys * (2 * L + T) * n + 8.0 * (L + T) * n
    per_coef = (2 * L * OPS_SHOUP + T * (L * (OPS_SHOUP + OPS_ADDSUB) + 2 * OPS_SHOUP
                                         + OPS_ADDSUB)
                + Tb * OPS_SHOUP + Tb * (OPS_SHOUP + OPS_ADDSUB) + OPS_ADDSUB + OPS_SHOUP
                + L * (Tb * (OPS_SHOUP + OPS_ADDSUB) + 3 + OPS_SHOUP + OPS_ADDSUB))
    ops = polys * n * per_coef + ntt_work(polys * (L + T), L + T, n)[1]
    return nbytes, float(ops)


def ntt64_work(rows: int, limbs: int, n: int, inverse: bool) -> tuple[float, float]:
    """Bytes and operations of one B5 call: int64 rows in and out, the limbs'
    twiddle tables (value + companion, 64-bit) read once; log2(n) stages of
    n/2 butterflies, plus the inverse's per-element n^-1."""
    logn = n.bit_length() - 1
    nbytes = 16.0 * rows * n + 16.0 * limbs * n
    ops = rows * (n // 2 * logn * OPS64_BUTTERFLY + (n * OPS64_SHOUP if inverse else 0))
    return nbytes, float(ops)


def bconv64_work(rows: int, L: int, T: int, n: int) -> tuple[float, float]:
    """Bytes and operations of one B6 call: L source rows read once, T
    written once; per output L Montgomery products and L-1 modular adds."""
    nbytes = 8.0 * rows * (L + T) * n
    return nbytes, float(rows * n * T * (L * OPS64_MONT + (L - 1) * OPS64_ADDSUB))


def ksw64_work(G: int, beta: int, T: int, n: int) -> tuple[float, float]:
    """Bytes and operations of one B7 call: the digits and the key's β·2·T
    rows read once, the (G, 2, T, n) product written once; per output β
    Montgomery products and β-1 modular adds."""
    nbytes = 8.0 * (G * beta * T + beta * 2 * T + G * 2 * T) * n
    return nbytes, float(G * 2 * T * n * (beta * OPS64_MONT + (beta - 1) * OPS64_ADDSUB))


# ---- one homomorphic operation of a batch of B ciphertexts ------------------

def bfv_mult_work(B: int, L: int, T: int, n: int) -> tuple[float, float]:
    """BFV ct×ct at the 32-bit word (BEHZ): B2 on the four input
    polynomials of each pair, the tensor product over the L+T rows of
    Q ∪ aux (four products and an add a coefficient), B4 on its three
    outputs. Bytes: the inputs (4 polynomials) and outputs (3) over Q once,
    both rings' forward and inverse tables once."""
    ops = (behz_work(4 * B, L, T, n)[1]
           + B * (L + T) * n * (4 * OPS_MONT + OPS_ADDSUB)
           + finish_work(3 * B, L, T, n)[1])
    return 8.0 * n * (7 * B * L + 2 * (L + T)), float(ops)


def bfv_relin_work(B: int, L: int, alpha: int, n: int) -> tuple[float, float]:
    """BFV relinearization at the 32-bit word: B3's key switch of c2, then
    c0 + e0, c1 + e1 (c0 and c1 read once more)."""
    beta = -(-L // alpha)
    nbytes, ops = ksw_work(B, L, alpha, beta, n)
    return nbytes + 16.0 * B * L * n, ops + 2.0 * B * L * n * OPS_ADDSUB


def bfv_rotate_work(B: int, L: int, alpha: int, n: int) -> tuple[float, float]:
    """BFV apply_galois at the 32-bit word: the automorphism of c0 and c1
    (a signed permutation: a conditional negation a coefficient), B3's key
    switch of σ(c1), then σ(c0) + e0 (c0 read once more)."""
    beta = -(-L // alpha)
    nbytes, ops = ksw_work(B, L, alpha, beta, n)
    return nbytes + 8.0 * B * L * n, ops + 3.0 * B * L * n * OPS_ADDSUB


def ckks_mult_work(B: int, L: int, n: int) -> tuple[float, float]:
    """CKKS ct×ct at the 64-bit word: the NTT-domain tensor product, four
    modular products and an add a coefficient; the inputs (4 polynomials)
    and outputs (3) once."""
    return 8.0 * n * 7 * B * L, float(B * L * n * (4 * OPS64_MONT + OPS64_ADDSUB))


def ckks_relin_work(B: int, L: int, alpha: int, n: int) -> tuple[float, float]:
    """CKKS relinearization at the 64-bit word (B5, B6, B7 and the mod-down):
    c2 to coefficients, its β digits decomposed and raised to the T = L+α
    rows of Q ∪ P (B6), forward NTT over T (B5), the inner product with the
    key (B7), the inverse NTT of the two sums (B5), RoundDivP: P → Q (B6),
    subtract and multiply by P^-1, the forward NTT of e0 and e1 over Q (B5),
    and c0 + e0, c1 + e1. Bytes: the three input polynomials, the key, the
    two outputs and both directions' tables of Q ∪ P once."""
    beta = -(-L // alpha)
    T = L + alpha
    ops = add(ntt64_work(B * L, L, n, True),
              (0.0, float(B * beta * alpha * n * OPS64_MONT)),
              bconv64_work(B * beta, alpha, T - alpha, n),
              ntt64_work(B * beta * T, T, n, False),
              ksw64_work(B, beta, T, n),
              ntt64_work(B * 2 * T, T, n, True),
              bconv64_work(2 * B, alpha, L, n),
              (0.0, float(2 * B * L * n * (OPS64_ADDSUB + OPS64_MONT))),
              ntt64_work(2 * B * L, L, n, False),
              (0.0, float(2 * B * L * n * OPS64_ADDSUB)))[1]
    nbytes = 8.0 * n * (5 * B * L + beta * 2 * T) + 32.0 * T * n
    return nbytes, float(ops)


def ckks_rescale_work(B: int, L: int, n: int) -> tuple[float, float]:
    """CKKS rescale at the 64-bit word: the inverse NTT of both polynomials
    over L limbs, the divide-and-round by the last prime (a subtract and a
    product on each of the L-1 limbs left), the forward NTT over L-1."""
    ops = add(ntt64_work(2 * B * L, L, n, True),
              (0.0, float(2 * B * (L - 1) * n * (OPS64_ADDSUB + OPS64_MONT))),
              ntt64_work(2 * B * (L - 1), L - 1, n, False))[1]
    nbytes = 8.0 * n * 2 * B * (2 * L - 1) + 16.0 * n * (2 * L - 1)
    return nbytes, float(ops)
