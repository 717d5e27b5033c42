"""Kernel B1: the 32-bit-word negacyclic NTT and inverse NTT.

Replaces ``lattisense_tpu/ops/ntt_pallas32.py`` ``ntt_fused32`` /
``intt_fused32`` (kernels ``_fwd_kernel`` / ``_inv_kernel``). The CUDA source
is ``csrc/ntt32.cu`` on the shared body ``csrc/ntt_passes.cuh``: persistent
blocks walk the (batch·limb) rows, each row held in registers by n/E threads
(E = 16 residues a thread up to n = 2^14) and transformed in register passes
of up to four butterfly stages, exchanged between passes through shared
memory, while the block's next row streams into a staging buffer. The
transform is bound by device-memory bytes (a row moves in and out as int64,
against ~12 integer operations per butterfly); the design touches each
element once each way and reads each twiddle once per row.

The schedule lives here as well as in the source, in plain Python:
``schedule`` (the register bits and the passes' windows), ``element_index``
(which thread holds which elements in which pass), ``pass_tables`` (each
pass's twiddles in the order a thread reads them) and ``exchange_slot`` /
``staging_slot`` (the shared-memory swizzles).
``tests/test_torch_ntt_schedule.py`` walks that schedule on the CPU against
``lattisense_tpu/core/ntt.py``.

``ntt32_fwd`` / ``ntt32_inv`` take an int64 (..., L, n) stack of residues in
[0, q) for the ring's L limbs. A CUDA tensor launches the kernel (or raises);
a CPU tensor runs the plain PyTorch twin below, the radix-2 loops of
``lattisense_tpu/core/ntt.py`` (written for either word: kernel B5's twin
uses them too). Output is canonical, so both are bit-exact with any correct
NTT of the same tables.

B1-r4 and the perm-layout entries. ``ntt32_fwd_r4`` / ``ntt32_inv_r4`` stand
for ``ntt_pallas32.py`` ``ntt_fused32_r4`` / ``intt_fused32_r4``: the same
transform with two butterfly levels merged per pass, a scheduling device of
the TPU compiler with no meaning here, so they launch B1 itself.
``ntt32_fwd_perm`` / ``ntt32_inv_perm`` stand for ``ntt_fused32_perm`` /
``intt_fused32_perm``: B1 with its output stored (forward) or its input
loaded (inverse) in the transposed tile layout of ``perm_layout``, where
position b·(n/128)+a holds standard-order element a·128+b. Each counts its
launches under its own name. Above 2^14 each runs B1's cluster kernel; the
perm entries add one transpose pass (``ntt32_perm_launch``) after the
forward or before the inverse, since the cluster's blocks hold sub-rows and
not the row whose layout they would store.

Above 2^14. A row of 2^16 32-bit words does not fit a block, and a row
kernel at 2^15 (1024 threads of 32 residues, its row read straight from
device memory) spills. Such a transform is one launch of the cluster kernel
(``csrc/ntt_cluster.cuh``, as B5 at 2^15 and 2^16): a thread-block cluster
of 2^k blocks holds a row in sub-rows of 2^``SUB_LOGN``, trades the
k = log2 n - ``SUB_LOGN`` stages that span sub-rows through distributed
shared memory and runs the row body on each sub-row, each (limb, sub-row) a
virtual limb over tables re-indexed from the ring's (``split_indices``,
``split_pass_tables``, ``column_tables``). Its launches count under
``ntt32_fwd_cluster`` / ``ntt32_inv_cluster`` beside the entry's own count.
At 2^15 it measured 2.3x faster than the row kernel, and sub-rows of 2^14
no faster than these (``PERF.md`` §6), so the kernel is built for sub-rows
of 2^13 alone (``ntt::kSubLogn`` in the source).
``tests/test_torch_ntt_cluster.py`` walks the cluster kernel on the CPU,
``tests/test_torch_ntt_split.py`` its tables.
"""

import ctypes

import numpy as np
import torch

from ..core import u64 as _u
from . import cuda_build

#: launches of each entry since the last reset, counted in ``launch``: the
#: cluster kernel also under ``*_cluster``, B2's and B4's at 2^16 under
#: ``behz32_split_*``
launches = {'ntt32_fwd': 0, 'ntt32_inv': 0, 'ntt32_fwd_cluster': 0, 'ntt32_inv_cluster': 0,
            'ntt32_fwd_r4': 0, 'ntt32_inv_r4': 0, 'ntt32_fwd_perm': 0, 'ntt32_inv_perm': 0,
            'behz32_split_fwd': 0, 'behz32_split_inv': 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    'ntt32_fwd_launch': [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P],
    'ntt32_inv_launch': [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P],
    'ntt32_blocks_per_sm': [_I, _I],
    'ntt32_fwd_perm_launch': [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P],
    'ntt32_inv_perm_launch': [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P],
    'ntt32_cluster_launch': [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    'ntt32_cluster_fit': [_I, _I, _I],
    'ntt32_perm_launch': [_P, _P, _I, _I, _I, _P],
}
ROW_MAX_LOGN = 14      # the row kernel B1 takes: 1024 threads of 16 residues, a row staged
SUB_LOGN = 13          # the cluster kernel's sub-rows (ntt_cluster.cuh kSubLogn): 512 threads
MAX_LOGN = 16          # the cluster kernel: clusters of 2^(16 - SUB_LOGN) blocks
SMEM_LIMIT = 232448    # bytes of shared memory a block may use (sm_90)
LANES = 128            # the tile width of the perm layout


# ---------------------------------------------------------------------------
# plain PyTorch twins
# ---------------------------------------------------------------------------

def ntt_plain(x, ring, to_mont: bool = False):
    """Forward negacyclic NTT, natural → bit-reversed order, optionally
    followed by to-Montgomery (x·R mod q), on the ring's word."""
    w = ring.word
    n = x.shape[-1]
    L = x.shape[-2]
    batch = x.shape[:-2]
    q = ring.q.reshape(L, 1, 1)
    t, m = n, 1
    while m < n:
        t //= 2
        xv = x.reshape(*batch, L, m, 2, t)
        s = ring.psi_rev[:, m:2 * m].reshape(L, m, 1)
        s_sh = ring.psi_rev_shoup[:, m:2 * m].reshape(L, m, 1)
        u = xv[..., 0, :]
        v = w.shoup_mul(xv[..., 1, :], s, s_sh, q)
        x = torch.stack([_u.addmod(u, v, q), _u.submod(u, v, q)], dim=-2).reshape(*batch, L, n)
        m *= 2
    if to_mont:
        x = w.to_mont(x, ring.q, ring.pinv, ring.r2)
    return x


def intt_plain(x, ring):
    """Inverse negacyclic NTT, bit-reversed → natural order, scaled by n^-1,
    on the ring's word."""
    w = ring.word
    n = x.shape[-1]
    L = x.shape[-2]
    batch = x.shape[:-2]
    q = ring.q.reshape(L, 1, 1)
    t, m = 1, n // 2
    while m >= 1:
        xv = x.reshape(*batch, L, m, 2, t)
        s = ring.psi_inv_rev[:, m:2 * m].reshape(L, m, 1)
        s_sh = ring.psi_inv_rev_shoup[:, m:2 * m].reshape(L, m, 1)
        u = xv[..., 0, :]
        v = xv[..., 1, :]
        lo = w.shoup_mul(_u.submod(u, v, q), s, s_sh, q)
        x = torch.stack([_u.addmod(u, v, q), lo], dim=-2).reshape(*batch, L, n)
        t *= 2
        m //= 2
    return w.shoup_mul(x, ring.n_inv, ring.n_inv_shoup, ring.q)


def perm_layout(x):
    """Standard bit-reversed order → the transposed tile layout (last axis):
    ``lattisense_tpu/ops/ntt_pallas32.py`` ``perm_layout``."""
    n = x.shape[-1]
    return x.reshape(*x.shape[:-1], n // LANES, LANES).transpose(-1, -2).reshape(x.shape)


def unperm_layout(x):
    """The transposed tile layout → standard bit-reversed order (last axis)."""
    n = x.shape[-1]
    return x.reshape(*x.shape[:-1], LANES, n // LANES).transpose(-1, -2).reshape(x.shape)


# ---------------------------------------------------------------------------
# the kernels' pass schedule (csrc/ntt_passes.cuh builds the same)
# ---------------------------------------------------------------------------

def schedule(logn: int):
    """The pass schedule of B1 and B5 at n = 2^logn: ``(K, windows)``.

    Each thread holds E = 2^K residues of a row in registers, n/E threads a
    row (K = 4 up to n = 2^14, K = 5 at n = 2^15). ``windows`` lists the
    passes in forward order as ``(lo, kp)``: in that pass register i covers
    element bits [lo, lo + K) (``element_index``), and the pass runs the
    butterfly stages of the window's low kp bits. The forward runs the
    windows in this order (top bits first), the inverse in reverse. All but
    the last are full (kp = K); the last, the chunk window (lo = 0), takes
    the remaining kr = logn - K·(P-1) stages."""
    K = logn if logn <= 4 else (4 if logn <= 14 else logn - 10)
    passes = -(-logn // K)
    kr = logn - K * (passes - 1)
    return K, [(logn - K * (f + 1), K) for f in range(passes - 1)] + [(0, kr)]


def element_index(logn: int, lo: int) -> torch.Tensor:
    """(n/E, E) int64: the element that register i of thread ``lane`` holds
    in the window starting at element bit ``lo``."""
    K, _ = schedule(logn)
    lane = torch.arange(1 << (logn - K)).reshape(-1, 1)
    i = torch.arange(1 << K).reshape(1, -1)
    return (lane & ((1 << lo) - 1)) | (i << lo) | ((lane >> lo) << (lo + K))


def pass_indices(logn: int, inverse: bool, per_vector: int) -> np.ndarray:
    """Which entry of the ring's bit-reversed table (psi_rev for the forward,
    psi_inv_rev for the inverse) each slot of the direction's pass table
    holds. Passes follow in execution order, 2^(logn - lo) slots each.

    Within a pass, group G = element >> (lo + kp) owns 2^kp slots and thread
    group u = lane >> lo owns the E slots of its groups, k = x·2^kp + slot
    (x the extra bits). Forward stage j of the pass (element bit
    lo + kp - 1 - j) takes slots 2^j + h: psi_rev[2^(s0 + j) + G·2^j + h],
    s0 = logn - lo - kp; inverse stage j (element bit lo + j) takes slots
    2^kp - 2^(kp-j) + h: psi_inv_rev[2^(logn-lo-j-1) + G·2^(kp-j-1) + h]. The
    one unused slot of each group holds entry 0. Slots are stored by 16-byte
    vector of ``per_vector`` entries: vector v of every u in turn, so a warp
    reads one vector index in one contiguous piece."""
    K, windows = schedule(logn)
    out = []
    for lo, kp in (windows[::-1] if inverse else windows):
        groups = np.arange(1 << (logn - lo - kp)).reshape(-1, 1)
        slots = np.zeros((len(groups), 1 << kp), dtype=np.int64)
        for j in range(kp):
            if inverse:
                cnt, off, base = 1 << (kp - j - 1), (1 << kp) - (1 << (kp - j)), 1 << (logn - lo - j - 1)
            else:
                cnt, off, base = 1 << j, 1 << j, 1 << (logn - lo - kp + j)
            slots[:, off:off + cnt] = base + groups * cnt + np.arange(cnt)
        by_thread = slots.reshape(-1, (1 << K) // per_vector, per_vector)      # (u, v, entry)
        out.append(by_thread.transpose(1, 0, 2).reshape(-1))
    return np.concatenate(out)


def pass_tables(tw, tws, logn: int, inverse: bool, per_vector: int):
    """The direction's pass table of (L, n) arrays of twiddles ``tw`` and
    their Shoup companions ``tws``: a C-contiguous (L, entries, 2) array,
    each entry (value, companion) at the slot of ``pass_indices``."""
    idx = pass_indices(logn, inverse, per_vector)
    return np.ascontiguousarray(np.stack([np.asarray(tw)[:, idx], np.asarray(tws)[:, idx]],
                                         axis=-1))


def table_position(logn: int, lo: int, lane, k, per_vector: int):
    """Slot, within its pass, of entry k of thread ``lane`` in the window
    starting at element bit ``lo`` (the layout of ``pass_indices``)."""
    K, _ = schedule(logn)
    groups = (1 << (logn - K)) >> lo
    return ((k // per_vector) * groups + (lane >> lo)) * per_vector + k % per_vector


def exchange_slot(idx, word_bits: int):
    """The slot of the exchange buffer that holds element ``idx``. 32-bit
    words: the bank bits XORed with a linear map of element bits 5..9;
    64-bit words (16 to a row of banks): the slot bits XORed with element
    bits 4..7. Under either no exchange of any window has a bank conflict."""
    if word_bits == 64:
        return idx ^ ((idx >> 4) & 15)
    h = (idx >> 5) & 31
    return idx ^ (((h << 1) & 30) | (((h >> 3) ^ (h >> 4)) & 1))


def staging_slot(idx):
    """The int64 slot of B1's staging buffer that holds element ``idx``: its
    16-byte chunk permuted within each aligned group of eight chunks."""
    c = idx >> 1
    return ((c ^ ((c >> 3) & 7)) << 1) | (idx & 1)


def stages_rows(logn: int, word_bits: int) -> bool:
    """Whether the kernel stages the next row by cp.async: at the 32-bit word
    where the 8n-byte staging buffer fits beside the 4n-byte exchange buffer
    (n <= 2^14); never at the 64-bit word."""
    return word_bits == 32 and (12 << logn) <= SMEM_LIMIT


# ---------------------------------------------------------------------------
# the cluster kernel above the row kernel's cap (csrc/ntt_cluster.cuh)
# ---------------------------------------------------------------------------

def split_depth(logn: int, row_max_logn: int) -> int:
    """k: the stages that span sub-rows at n = 2^logn, so that the row body
    takes sub-rows of 2^(logn - k) <= 2^row_max_logn."""
    return max(0, logn - row_max_logn)


def cluster_depth(logn: int) -> int:
    """k: the stages B1's cluster kernel trades between the blocks of a
    cluster at n = 2^logn (clusters of 2^k blocks over sub-rows of
    2^SUB_LOGN); 0 where the row kernel takes the row (n <= 2^14)."""
    return 0 if logn <= ROW_MAX_LOGN else split_depth(logn, SUB_LOGN)


def split_indices(logn: int, k: int) -> np.ndarray:
    """(2^k, n/2^k) int64: the entry of the ring's bit-reversed table
    (psi_rev forward, psi_inv_rev inverse) that slot v of sub-row s's
    virtual table holds. After the k column stages, sub-row s's local stage
    m' (a power of two) and block i' (slot v = m' + i') take the full
    transform's twiddle of stage 2^k·m', block s·m' + i':
    entry (2^k + s)·m' + i'. Slot 0 (unused) holds entry 0. At k = 0 the
    map is the identity."""
    sub = 1 << (logn - k)
    v = np.arange(sub, dtype=np.int64)
    m = np.ones(sub, dtype=np.int64)
    for b in range(1, logn - k):
        m[v >= 1 << b] = 1 << b
    idx = ((1 << k) + np.arange(1 << k, dtype=np.int64)).reshape(-1, 1) * m + (v - m)
    idx[:, 0] = 0
    return idx


def split_pass_tables(tw, tws, logn: int, k: int, inverse: bool, per_vector: int):
    """The row kernel's pass table over the virtual limbs of a split at
    depth k: (L·2^k, entries, 2), virtual limb l·2^k + s for sub-row s of
    limb l, built by ``pass_tables`` at log2 n - k from the (L, n) tables
    ``tw``/``tws`` re-indexed by ``split_indices``. At k = 0 it is
    ``pass_tables`` itself."""
    idx = split_indices(logn, k).reshape(-1)
    L, sub = np.asarray(tw).shape[0], 1 << (logn - k)
    return pass_tables(np.asarray(tw)[:, idx].reshape(L << k, sub),
                       np.asarray(tws)[:, idx].reshape(L << k, sub), logn - k, inverse,
                       per_vector)


def column_tables(tw, tws, k: int) -> np.ndarray:
    """The cross stages' (L, 2^k, 2) table: entries 0 .. 2^k - 1 of the
    (L, n) tables ``tw``/``tws`` as (value, companion) pairs; stage m reads
    entries m .. 2m - 1 (entry 0 is unused)."""
    return np.ascontiguousarray(np.stack([np.asarray(tw)[:, :1 << k],
                                          np.asarray(tws)[:, :1 << k]], axis=-1))


# ---------------------------------------------------------------------------
# kernel launch
# ---------------------------------------------------------------------------

def u32_tensor(values, device):
    """uint32 table as an int32 tensor with the same bits (the C side reads
    uint32)."""
    arr = np.ascontiguousarray(np.asarray(values, dtype=np.int64).astype(np.uint32))
    return torch.from_numpy(arr.view(np.int32)).to(device)


def row_tables(ring):
    """The ring's pass tables and per-limb constants in the row kernel's
    uint32 layout (one limb a row), for B1's row kernel and the row loops
    built on it (B2, B3's fused route, B4), cached on the ring."""
    return _tables(ring, 0)


def cluster_tables(ring, k: int):
    """The ring's tables for a cluster of 2^k blocks a row (k >= 1; B1's
    cluster kernel at ``cluster_depth``, B3's cluster route): the pass
    tables and the constants (``q``, the epilogues') per virtual limb, each
    limb's repeated 2^k times, and the cross stages' tables and the limbs'
    primes (``cols_*``), cached on the ring."""
    if k < 1:
        raise ValueError(f'a cluster spans at least two sub-rows, got depth {k}')
    return _tables(ring, k)


def _tables(ring, k: int):
    logn = ring.n.bit_length() - 1
    cache = ring.__dict__.setdefault('_b1_tables', {})
    tabs = cache.get(k)
    if tabs is None:
        rs, dev = ring.rings, ring.device
        r1 = [r.r1 for r in rs]
        nir = [r.n_inv * pow(1 << 32, -1, r.q) % r.q for r in rs]

        def stacked(attr):
            return np.stack([getattr(r, attr) for r in rs])

        def per_row(vals):
            return u32_tensor([v for v in vals for _ in range(1 << k)], dev)

        def table(attr, inverse):
            return u32_tensor(split_pass_tables(stacked(attr), stacked(attr + '_shoup'), logn, k,
                                                inverse, 2), dev)

        tabs = {
            'q': per_row([r.q for r in rs]),
            'fwd': table('psi_rev', False),
            'inv': table('psi_inv_rev', True),
            'n_inv': per_row([r.n_inv for r in rs]),
            'n_inv_shoup': per_row([r.n_inv_shoup for r in rs]),
            'r1': per_row(r1),
            'r1_shoup': per_row([(v << 32) // r.q for v, r in zip(r1, rs)]),
            'n_inv_rinv': per_row(nir),
            'n_inv_rinv_shoup': per_row([(v << 32) // r.q for v, r in zip(nir, rs)]),
        }
        if k:
            tabs.update({
                'cols_q': u32_tensor([r.q for r in rs], dev),
                'cols_fwd': u32_tensor(column_tables(stacked('psi_rev'), stacked('psi_rev_shoup'),
                                                     k), dev),
                'cols_inv': u32_tensor(column_tables(stacked('psi_inv_rev'),
                                                     stacked('psi_inv_rev_shoup'), k), dev)})
        cache[k] = tabs
    return tabs


def check_stack(x, ring):
    if not isinstance(x, torch.Tensor) or x.dtype != torch.int64:
        raise TypeError(f'expected an int64 tensor, got {getattr(x, "dtype", type(x))}')
    if x.dim() < 2 or tuple(x.shape[-2:]) != (len(ring.moduli), ring.n):
        raise ValueError(f'expected shape (..., {len(ring.moduli)}, {ring.n}), '
                         f'got {tuple(x.shape)}')
    if x.device != ring.device:
        raise ValueError(f'tensor on {x.device}, ring tables on {ring.device}')


def launch(x, y, ring, inverse: bool, to_mont: bool = False, from_mont: bool = False,
           perm: bool = False, name: str | None = None):
    """Launch B1 on contiguous CUDA int64 stacks x → y (same shape) on the
    current stream, and count the launch under ``name`` (by default its
    direction's). Every launch of the kernel goes through here, so kernels
    built on B1 (B2 and B4 at 2^16) show in the count too.

    ``to_mont`` (forward) multiplies the output by 2^32 mod q; ``from_mont``
    (inverse) folds a from-Montgomery of the input into the n^-1 scale: the
    transform is linear, so INTT(x·2^-32) = 2^-32·INTT(x), and the kernel's
    per-limb epilogue multiplies by n^-1·2^-32 instead of n^-1. ``perm``
    stores the forward output, or loads the inverse input, in the perm
    layout (above 2^14 through a transpose pass beside the cluster kernel)."""
    _u.require_word(ring, 32, 'B1 (ntt32)')
    if not (x.is_cuda and y.is_cuda and x.is_contiguous() and y.is_contiguous()):
        raise ValueError('B1 takes contiguous CUDA tensors')
    if y.shape != x.shape or y.dtype != torch.int64:
        raise ValueError(f'output {tuple(y.shape)} {y.dtype} does not match input {tuple(x.shape)}')
    if (to_mont and inverse) or (from_mont and not inverse):
        raise ValueError('to_mont is a forward epilogue, from_mont an inverse one')
    logn = ring.n.bit_length() - 1
    if not 1 <= logn <= MAX_LOGN:
        raise ValueError(f'B1 supports 2 <= n <= 2^{MAX_LOGN}, got n={ring.n}')
    if perm and ring.n < LANES:
        raise ValueError(f'the perm layout needs n >= {LANES}, got n={ring.n}')
    k = cluster_depth(logn)
    rows = x.numel() // ring.n
    if rows == 0:
        return
    lib = cuda_build.load('ntt32', _SIGNATURES)
    tabs = cluster_tables(ring, k) if k else row_tables(ring)
    if inverse:
        post, posts = ((tabs['n_inv_rinv'], tabs['n_inv_rinv_shoup']) if from_mont
                       else (tabs['n_inv'], tabs['n_inv_shoup']))
    else:
        post, posts = (tabs['r1'], tabs['r1_shoup']) if to_mont else (None, None)
    what = f'ntt32 {"inverse" if inverse else "forward"}'
    if k:
        src, dst = x, y
        if perm:
            mid = torch.empty_like(x)
            if inverse:
                _perm_pass(lib, x, mid, rows, logn, True)
                src = mid
            else:
                dst = mid
        with torch.cuda.device(x.device):
            err = lib.ntt32_cluster_launch(
                src.data_ptr(), dst.data_ptr(), rows, len(ring.moduli), logn, SUB_LOGN,
                int(inverse), tabs['inv' if inverse else 'fwd'].data_ptr(),
                tabs['cols_inv' if inverse else 'cols_fwd'].data_ptr(), tabs['cols_q'].data_ptr(),
                None if post is None else post.data_ptr(),
                None if posts is None else posts.data_ptr(),
                torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f'{what} cluster launch failed: cudaError_t {err}')
        if perm and not inverse:
            _perm_pass(lib, mid, y, rows, logn, False)
        launches['ntt32_inv_cluster' if inverse else 'ntt32_fwd_cluster'] += 1
    else:
        if inverse:
            fn = lib.ntt32_inv_perm_launch if perm else lib.ntt32_inv_launch
        else:
            fn = lib.ntt32_fwd_perm_launch if perm else lib.ntt32_fwd_launch
        run_aligned(fn, x, y, rows, len(ring.moduli), logn, tabs['inv' if inverse else 'fwd'],
                    tabs['q'], post, posts, what)
    launches[name or ('ntt32_inv' if inverse else 'ntt32_fwd')] += 1


def _perm_pass(lib, x, y, rows: int, logn: int, inverse: bool):
    """``perm_layout`` (or, ``inverse``, ``unperm_layout``) of the rows of
    x into y, on the current stream: ntt32.cu ``perm_kernel``."""
    with torch.cuda.device(x.device):
        err = lib.ntt32_perm_launch(x.data_ptr(), y.data_ptr(), rows, logn, int(inverse),
                                    torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'ntt32 perm pass launch failed: cudaError_t {err}')


def run_aligned(fn, x, y, rows, limbs, logn, tab, q, post, posts, what: str):
    """Call the C entry ``fn`` of B1 or B5 on the current stream. The kernel
    moves rows in 16-byte pieces, so a stack that does not start on 16 bytes
    (a view into a larger tensor) goes through an aligned copy."""
    xin = x if x.data_ptr() % 16 == 0 else x.clone()
    out = y if y.data_ptr() % 16 == 0 else torch.empty_like(y)
    with torch.cuda.device(x.device):
        err = fn(xin.data_ptr(), out.data_ptr(), rows, limbs, logn, tab.data_ptr(),
                 q.data_ptr(), None if post is None else post.data_ptr(),
                 None if posts is None else posts.data_ptr(),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'{what} launch failed: cudaError_t {err}')
    if out is not y:
        y.copy_(out)


def blocks_per_sm(logn: int, inverse: bool) -> int:
    """Blocks of B1's kernel at n = 2^logn that one SM of the current card
    holds, from the occupancy calculator (registers, shared memory, threads)."""
    got = cuda_build.load('ntt32', _SIGNATURES).ntt32_blocks_per_sm(logn, int(inverse))
    if got < 0:
        raise RuntimeError(f'ntt32 occupancy query failed: cudaError_t {-got}')
    return got


def cluster_fit(logn: int, inverse: bool) -> int:
    """Clusters of B1's cluster kernel at n = 2^logn (2^15 or 2^16) that the
    current card runs at once, from ``cudaOccupancyMaxActiveClusters``;
    raises where none fits."""
    got = cuda_build.load('ntt32', _SIGNATURES).ntt32_cluster_fit(logn, SUB_LOGN, int(inverse))
    if got <= 0:
        raise RuntimeError(f'ntt32 cluster occupancy query failed: cudaError_t {-got}')
    return got


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def ntt32_fwd(x, ring, to_mont: bool = False):
    """Forward NTT of an int64 (..., L, n) stack over ``ring`` (bit-reversed
    output), with the optional to-Montgomery epilogue."""
    _u.require_word(ring, 32, 'ntt32_fwd')
    check_stack(x, ring)
    if not x.is_cuda:
        return ntt_plain(x, ring, to_mont)
    y = torch.empty(x.shape, dtype=torch.int64, device=x.device)
    launch(x, y, ring, inverse=False, to_mont=to_mont)
    return y


def ntt32_inv(x, ring):
    """Inverse NTT of an int64 (..., L, n) stack over ``ring`` (bit-reversed
    input, natural output, scaled by n^-1)."""
    _u.require_word(ring, 32, 'ntt32_inv')
    check_stack(x, ring)
    if not x.is_cuda:
        return intt_plain(x, ring)
    y = torch.empty(x.shape, dtype=torch.int64, device=x.device)
    launch(x, y, ring, inverse=True)
    return y


def _entry(x, ring, inverse: bool, perm: bool, name: str):
    _u.require_word(ring, 32, name)
    check_stack(x, ring)
    if perm and ring.n % LANES:
        raise ValueError(f'{name} needs n divisible by {LANES}, got n={ring.n}')
    if not x.is_cuda:
        if inverse:
            return intt_plain(unperm_layout(x) if perm else x, ring)
        out = ntt_plain(x, ring)
        return perm_layout(out) if perm else out
    if not x.is_contiguous():
        raise ValueError(f'{name} takes a contiguous tensor')
    y = torch.empty(x.shape, dtype=torch.int64, device=x.device)
    launch(x, y, ring, inverse=inverse, perm=perm, name=name)
    return y


def ntt32_fwd_r4(x, ring):
    """``ntt_fused32_r4``: the forward transform of ``ntt32_fwd`` (B1)."""
    return _entry(x, ring, False, False, 'ntt32_fwd_r4')


def ntt32_inv_r4(x, ring):
    """``intt_fused32_r4``: the inverse transform of ``ntt32_inv`` (B1)."""
    return _entry(x, ring, True, False, 'ntt32_inv_r4')


def ntt32_fwd_perm(x, ring):
    """``ntt_fused32_perm``: ``perm_layout(ntt32_fwd(x))``, the layout
    written by the kernel's store."""
    return _entry(x, ring, False, True, 'ntt32_fwd_perm')


def ntt32_inv_perm(x, ring):
    """``intt_fused32_perm``: ``ntt32_inv(unperm_layout(x))``, the layout
    read by the kernel's load."""
    return _entry(x, ring, True, True, 'ntt32_inv_perm')
