#!/usr/bin/env python3
"""Smoke test of lattisense_torch on one CUDA card (written for an H100).

Run from the repository root with no arguments: ``python3 chip_smoke.py``.

1. Set-up: builds the CUDA kernels from ``lattisense_torch/csrc`` (one nvcc
   per source, all started together) and prints the toolchain, the card and
   a summary of each library's ptxas report (the whole report goes to
   ``build/kernels/ptxas/``), the clusters of B5's and B1's cluster kernels
   and of B3's cluster route that fit the card, and the IMAD-family instructions a butterfly (B5) or a
   Montgomery product (B6, B7) in the SASS of the built libraries
   (``cuobjdump -sass``), from which each 64-bit kernel's
   ``imad_bound_ms`` is computed.
2. Kernels: calls each kernel wrapper on the card at the shapes its path
   gives it, holds the result bit for bit against the plain PyTorch twin run
   on a CPU copy, and times kernel and twin on the card with CUDA events:
   the 32-bit word's ``ntt32_fwd``, ``ntt32_inv``, ``behz_prep32``,
   ``ksw_switch32``, ``behz_finish32`` and the B1-r4 / perm entries
   (``ntt32_fwd_r4``, ``ntt32_inv_r4``, ``ntt32_fwd_perm``,
   ``ntt32_inv_perm``), and the 64-bit word's ``ntt64_fwd``, ``ntt64_inv``
   (B5), ``bconv64_convert`` (each of its four conversions alone and the
   four together), ``bconv64_raw`` (B6) and ``ksw_inner64`` (B7).
3. Main path: the batched BFV mult_relin at the headline configuration
   (``BfvParams.create_tpu_param(16384)``, level 7, batch 32): every output
   must decrypt to a·b mod t slot-wise, element 0 must equal the port's plain
   path on the CPU bit for bit, and each kernel's launch count, reset just
   before the run, must have risen, B1's standalone entries' excepted, which
   the path must not launch (B2, B3 and B4 run their own NTTs). Each path's
   line holds its ms a step (CUDA events) and the device's busy ms a step
   and idle share (torch.profiler over five steps in one window).
4. Rotate path: the batched BFV rotate_col by 1 on the same context, level
   and batch (``make_rotate_step``): every output must decrypt to each half
   of the slot vector rolled by -1, element 0 must equal the port's CPU path
   bit for bit, and the key switch's count, reset just before the run, must
   have risen.
5. u64 path: the batched BFV mult_relin on the u64 conformance chain
   (``BfvParams.create(16384)``, level 3, batch 32), checked as in 3; the
   counts of B5, B6 and B7 must have risen and the 32-bit kernels' must not.
6. u64 rotate path: the batched rotate_col by 1 on the u64 context, checked
   as in 4 and 5. None of the paths at n=16384 may launch B1's or B5's
   cluster kernel.
7. BFV at n=32768 on the u64 chain (``BfvParams.create(32768)``, level 11,
   the chain's full width, batch 32): B5 through its cluster kernel (one
   launch a call: clusters of 4 blocks over sub-rows of 2^13), B6 and B7,
   each held against its plain twin on the card at the path's shapes; then
   ``u64_32k_path`` (mult_relin) and ``u64_32k_rotate_path`` (rotate_col by
   1), checked as in 5 and 6, with the cluster kernel's launches required
   and B5's row kernel's refused.
8. BFV at n=32768 on the 31-bit profile (``create_tpu_param(32768)``, level
   21, batch 32): B2, B3 (its cluster route: clusters of 4 blocks over
   sub-rows of 2^13) and B4 held against their twins on the card, then
   ``w32_32k_path`` (mult_relin), checked as in 3, launching no B1 entry.
9. B5 and B1 at n=2^16 (clusters of 8, a card-test shape, on no path)
   against their twins; then the n=2^16 repairs, each against its twin:
   B1-r4 and the perm entries on the same stack (B1's cluster kernel, the
   perm entries with their transpose pass), B2 and B4 on a custom 31-bit
   BFV chain (22 q limbs, around B1's cluster kernel), and B3's cluster
   route at the shapes of ``CkksParams.create_tpu_btp_param()`` (levels 47
   and 9, both outputs) and ``create_tpu_param(65536)`` (level 43), batch 2.
10. Task paths: the compiled-task runtime (``runtime/task.py``) on the task
   directories committed under ``lattisense_torch/runtime/tasks/``.
   ``task_path`` (after 4) runs the 32-``mult_relin`` task on the main
   path's context and ciphertexts: eager (the per-op plan) and the captured
   CUDA graph of the fused plan must both equal ``main_path``'s batched step
   bit for bit and decrypt to a·b mod t; the eager run must launch B2, B3
   and B4 and no B1 entry. ``task_mix_path`` (w32, level 7, after it) and
   ``task_mix64_path`` (u64, level 3, after 6) run the op mix (every BFV
   executor branch): every output of the eager run equals the port's CPU
   run of the same task bit for bit and decrypts to its NumPy plaintext, the
   replay equals eager, and the eager run launches B1 (w32) or B5, B6 and
   B7 (u64). Each prints ms per run (the runtime's ``duration_ns``, which
   ends in a synchronize) eager and replayed, and the device's idle share
   of each (busy time from ``torch.profiler``).
11. CKKS, on two contexts made once: the u64 chain ``CkksParams.create(16384)``
   and the composite 2^60 chain on the 31-bit primes of
   ``CkksParams.create_tpu_param(16384)``. B1, B3, B5, B6 and B7 are held
   against their twins at the shapes the CKKS paths give them, then, batch
   32: ``ckks_path`` (u64 mult_relin_rescale, level 3 → 2: B5, B6, B7),
   ``ckks_w32_path`` (w32 mult_relin_rescale2, level 10 → 8: B1's own
   entries and B3 with an NTT-domain output), ``ckks_rotate_path`` (rotate by
   1 on the w32 context at level 10), ``ckks_task_mix_path`` (w32, level 10)
   and ``ckks_task_mix64_path`` (u64, level 3), the CKKS op mixes of
   ``runtime/tasks`` eager and replayed, a second set of input scales
   through the same task capturing its own graph. Element 0 of each path
   equals the port's plain path on the CPU bit for bit, and elements 0 and
   31 decode within 1e-3 of their float64 slots (a·b, or the rolled
   vector); every task output equals the CPU run and decodes within 1e-3.
   Each line holds the ms a step, the idle share, the peak memory, the
   launches, the decoded errors of elements 0 and 31 and
   ``get_precision_stats``' mean log2 precision of element 0.

12. CKKS bootstrapping: the JAX package's three bootstrap runs
   (``schemes/bootstrap_params.py`` ``reference_run``), one
   ``CkksBtpContext`` at a time (h=192, seed 77), freed before the next:
   ``btp_toy_path`` (the toy profile, n=8192, 25 q and 5 p 64-bit limbs:
   B5's row kernel, B6, B7), ``btp_full_path`` (the same chain at n=2^16:
   B5's cluster kernel) and ``btp_w32_path`` (``create_tpu_btp_param()``,
   48 q and 4 p 31-bit limbs, two a level: B1's cluster kernel and B3's
   cluster route).
   Each line holds the ms a bootstrap (CUDA events, one warm-up, 3 timed),
   the busy ms and idle share over two bootstraps in one profiler window,
   each segment's ms, the launches of each kernel a bootstrap, the key
   set's bytes, keygen seconds, the first bootstrap's seconds and the host
   encoding of the transforms' diagonals alone (``encode_s``), the top
   kernels by device time, the peak memory, the output
   level and the decoded error, which must meet the JAX test's bounds. The
   kernels the path runs are held against their twins at its key-switch
   shapes. The toy run also holds four segments (``raise``, ``cts0``,
   ``evalmod_da``, ``stc2``) bit for bit against the CPU twin from the
   card's own input, and runs the committed ``ckks_bootstrap_toy_n8192``
   task eagerly, replayed (one CUDA graph) and partitioned (one graph a
   segment): each equal to ``ctx.bootstrap``.

13. Threshold BFV (``schemes/multiparty.py``): three parties (seeds 100 +
   i, smudging σ 2^30) build the public, relinearization (two rounds) and
   Galois (rotate_col by 1) keys on the card, each share through
   ``serialize`` / ``deserialize``, and the same protocol on a CPU copy of
   the same seeds must give the same keys bit for bit. The keys go on an
   empty context; 32 pairs encrypted under the collective key run the
   batched ``mult_relin`` and ``rotate_col`` (element 0 equal to the CPU
   plain path), elements 0 and 31 of both outputs are threshold-decrypted
   by E2S, and element 0 goes back by S2E and through a refresh with and
   without a permutation, each decrypting right under the joint secret.
   ``mpc_path`` on the main path's configuration (B1 in the key generation;
   B2, B3, B4 in the step), ``mpc64_path`` on ``BfvParams.create(16384)``
   level 3 (B5, B6, B7; no 32-bit kernel). B1 and B5 are held against their
   twins at the protocols' shapes (Q∪P and Q_ℓ).
14. ``foreign_path``: ``ForeignTask`` (the 32-bit word, one CUDA graph) over
   C structs of ``abi.py`` only: the 32-``mult_relin`` task on
   ``mpc_path``'s ciphertexts and collective rlk, equal to its batched step
   bit for bit, and the mult-rotate task on ``task_mix_path``'s context
   (its Galois keys as one CGaloisKey), equal to ``FheTask``, each with
   ``mf_nbits`` 0 and 64; the ms a run, import and export apart.
15. ``capi_path``: the C ABI shim (``lattisense_torch/csrc/plugin/``) and the
   repository's client ``csrc/plugin_client.cpp``, built with g++; the
   client runs the mult-rotate task on fixture files of ``mpc_path``'s
   element 0 and collective keys in a process of its own on the card,
   passes its signature-error checks, and its output equals the in-process
   ``ForeignTask`` on the same values bit for bit and decrypts right.
16. ``dev_monitor``: a replay of the 32-``mult_relin`` task under
   ``LATTISENSE_DEV=1`` writes ``mem_usage_gpu_0.csv`` with the card's
   bytes in use, and returns ``mpc_path``'s step.
17. ``mxu_path`` (run right after 5, on its context): the four-step NTT as
   matrix products (``ops/ntt_mxu.py``) at ``u64_path``'s shapes, forward
   and inverse over q, aux and q∪p, bit for bit against B5 on both routes
   (bf16 ``bmm`` with float32 sums; int8 ``_int_mm``), each route's ms
   beside B5's, its multiply-adds and its bound at the dense int8 and bf16
   tensor-core peaks; then ``u64_path``'s batched ``mult_relin`` with
   ``ntt_mxu.ENABLED`` set: equal to ``u64_path``'s output bit for bit,
   decrypting to a·b mod t, B6 and B7 launched and B5 not at all, with its
   ms a step, idle share and multiply-adds a step.
18. The mesh paths (after 6), over ``parallel/`` and ``parallel/launch.py``:
   a world of 2 ranks sharing the card over gloo (NCCL refuses two ranks on
   one device), each rank loading the main path's keys and inputs (saved
   by this script with ``tools/mesh_paths.py``: a load is cheaper than
   keygen from the seed) and running, at the main path's width:
   ``mesh_op_path`` (``make_batched_step(mesh=(op=2))``), ``limb_tp_path``
   (``make_limb_tp_mult_relin`` over (op=1, limb=2)) at w32 L7 and u64 L3
   (``limb_tp_path_u64``), ``limb_tp_rotate_path``, ``coeff_ksw_path``
   (``CoeffShardedRelin`` over coeff=2 on ``mult(a, b)``) and
   ``mesh_task_path`` (the 32-``mult_relin`` task with ``mesh=(op=2)``,
   eager, and replayed as CUDA graphs cut at each collective); then a world
   of 1 rank over NCCL runs ``limb_tp_path`` (``limb_tp_path_nccl``), its
   one-rank collectives issued to NCCL. Each gathered output equals its
   single-card path bit for bit on every rank. Each line holds the ms a
   step (CUDA events on each rank, between barriers), the calls and bytes
   of each collective in a step, the bytes staged through the host, the
   backend and each rank's launches.
19. The sharded views (after 12), in worlds of ranks sharing the card over
   gloo, each rank loading what 18. saved (or, for the toy bootstrap, making
   the profile's context from its seed): ``coeff_engine_path``, the
   coefficient-sharded engine view (``parallel/sharded_engine.py``) over
   coeff=2 running the BFV ``mult_relin`` at ``main_path``'s shapes on its
   unfused route (no B2, B3 or B4 on a shard) and the CKKS
   ``mult_relin_rescale`` at ``ckks_path``'s; ``coeff_btp_path``
   (``CoeffShardedBootstrap`` over coeff=2), ``limb_btp_path``
   (``LimbShardedBootstrap`` over limb=2) and, in a world of 4,
   ``limb_coeff_btp_path`` (limb=2 × coeff=2), each refreshing
   ``btp_toy_path``'s input; ``mesh_task_coeff_path``, the 32-``mult_relin``
   task with ``mesh=(op=1, limb=1, coeff=2)`` eager and replayed, and the
   toy bootstrap task on coeff=2, partitioned. Each output equals its
   single-card path's bit for bit on every rank; each line holds the ms a
   step or a bootstrap (one warm-up, then 2 or 1 timed), the collectives'
   calls and bytes, the bytes staged through the host and each rank's
   launches. Then ``frontend_path``: the port's frontend
   (``lattisense_torch/frontend/``, no JAX here) compiles the 32-``mult_relin``
   graph and the toy bootstrap graph, each equal to its committed task
   directory after the id mapping (``tasks.normalize``), and the first runs
   on the card, replayed, equal to ``main_path``.
20. The model zoo (``lattisense_torch/models/``) at the JAX examples' sizes,
   one context a chain holding the union of its models' keys (a
   ``model_contexts`` line): ``model_logistic_path`` (30 features, level 3),
   ``model_distance_path`` (pack 4, skip slots/8, level 3) and
   ``model_conv_path`` (32×32 input, 3×3 kernel, pack 4, level 2) on
   ``CkksParams.create(16384)``; ``model_poly_path`` (degree 7, top level 4)
   on ``BfvParams.create(16384)``; ``model_matvec_path`` (8192 slots, 32
   nonzero diagonals, level 2) on ``CkksParams.create(16384)`` and
   ``model_matvec_w32_path`` on ``create_tpu_param(16384)``, each through
   ``FheModel.load`` and ``FheTask``: the ms a run eager and replayed, idle
   shares, the top kernels, each kernel's launches in the counted eager run,
   the decoded error against the numpy oracle within the JAX tests' bounds,
   the key bytes. The matvec lines' kernels (B5, B6, B7; B1, B3) are held
   against their twins at their shapes (batch 1, level 2). Then
   ``model_toy_paths``: each model on its toy chain at n=1024
   (``tests/test_models.py``), the card's output data equal to the port's
   CPU run bit for bit. Then ``examples_path``: every runner of
   ``lattisense_torch/examples/`` through ``main(['--toy'])`` in this
   process on the card (``ckks_bootstrap`` also with ``--w32``;
   ``multichip_sharding`` in a gloo world of 4 ranks sharing the card), each
   printing OK last, with its seconds, the values it checked and its
   launches.

Prints a line for each path (``main_path``, ``rotate_path``, ``task_path``,
``task_mix_path``, ``u64_path``, ``u64_rotate_path``, ``task_mix64_path``,
``u64_32k_path``, ``u64_32k_rotate_path``, ``w32_32k_path``, ``ckks_path``,
``ckks_w32_path``, ``ckks_rotate_path``, ``ckks_task_mix_path``,
``ckks_task_mix64_path``, ``btp_toy_path``, ``btp_full_path``,
``btp_w32_path``, ``mpc_path``, ``mpc64_path``, ``foreign_path``,
``capi_path``, ``dev_monitor``, ``mxu_path``, the mesh paths, the sharded
views' paths, ``frontend_path``, the six ``model_*_path`` lines,
``model_toy_paths`` and ``examples_path``), a
``{"kernels": [...]}`` line (each kernel with the CKKS, bootstrap, threshold and model paths
that launch it, ``ckks_launches``, ``btp_launches``, ``mpc_launches``, ``models_launches``),
a ``{"phase_s": ...}`` line after each phase (its seconds and the seconds
since the start), the card's name and power
limit as nvidia-smi reports them, and as its last line ``{"ok": true,
"device": {...}}``. Any failure raises and exits non-zero; without a CUDA
card, or without the package beside it, it exits 2 and prints no result.
"""

import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

N = 16384
LEVEL = 7
LEVEL64 = 3            # the u64 chain's benchmark level (4 limbs, logQ 223)
BATCH = 32
WARMUP = 3
ITERS = 10             # timed calls of each kernel and its twin: every phase shares
                       # the script's 1 200 s limit
MAIN_ITERS = 10
SEED = 7
N32K = 32768
LEVEL_U32K = 11        # create(32768): all 12 q limbs
LEVEL_W32K = 21        # create_tpu_param(32768): all 22 q limbs
ITERS_32K = 5          # the n=32768 steps and the plain twins at the large shapes
TASK_ITERS = 5         # timed runs of a task, eager and replayed
BTP_PROFILE_REPS = 1   # bootstraps in a profiler window: each takes 0.1-1.3 s of the
                       # card, and a window's host cost (15-50 s at five) grows with its events
N64K = 1 << 16
LEVEL_C64 = 3          # CkksParams.create(16384): 4 of the 10 q limbs
LEVEL_C32 = 10         # the composite chain: all 11 q limbs, two rescales a step
CKKS_TOL = 1e-3        # decoded error bound (the reference's tests/test_word32.py)
PARTIES = 3            # the threshold paths' parties, seeds 100 + i
SIGMA_SMUDGING = 2.0 ** 30
MPC64_ITERS = 1        # timed steps of mpc64_path
MXU_ITERS = 3          # timed calls of the MXU route and of mxu_path's step
MESH_ITERS = 2         # timed steps of each mesh path, the counted one first
VIEW_ITERS = 1         # timed steps or bootstraps of each sharded view's path: the counted one
MODEL_ITERS = 3        # timed runs of each model's task, eager and replayed
MODEL_REPS = 2         # runs of each model's task in a profiler window
MODEL_TOY_N = 1024     # the model zoo's toy chains (tests/test_models.py)

# Published H100 SXM peaks (NVIDIA data sheet) for the bound: HBM bytes/s,
# and the float32 rate outside the tensor cores, the table's only 32-bit
# CUDA-core rate — an upper limit on the card's 32-bit integer rate, so the
# operations bound below is a lower bound.
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
# the dense tensor-core peaks (the same data sheet), the MXU route's bound
PEAK_INT8_OPS_S = 1979e12
PEAK_BF16_OPS_S = 989e12
# 32-bit integer operations per step, counted from csrc/: a Shoup product is
# 6 (umulhi, two mul, sub, compare, select), a modular add or sub 3, a
# Montgomery product 8 (wide mul as two, mul, umulhi, two adds, compare,
# select).
OPS_SHOUP, OPS_ADDSUB, OPS_MONT = 6, 3, 8
OPS_BUTTERFLY = OPS_SHOUP + 2 * OPS_ADDSUB
# The 64-bit word in the same 32-bit operations, from csrc/*64.cu built from
# 32-bit halves: a 64x64 low product (a * b) is 4 (three 32-bit multiplies
# and an add); a high product (__umul64hi) is 12 (four 32x32->64 partial
# products at two each, four adds with carry); a 64-bit add, sub, compare or
# select is 2. So a Shoup product is 12 + 4 + 4 + 2 (sub) + 2 + 2 = 26, a
# modular add or sub 6, a Montgomery product 4 + 12 + 4 + 12 + 4 (the two
# adds and the carry) + 4 (compare, select) = 40.
OPS64_SHOUP, OPS64_ADDSUB, OPS64_MONT = 26, 6, 40
OPS64_BUTTERFLY = OPS64_SHOUP + 2 * OPS64_ADDSUB
# The integer multiply-add pipe: 64 IMAD results a clock an SM on compute
# capability 9.0 (CUDA C++ Programming Guide, throughput of native arithmetic
# instructions), half the float32 rate above. The 64-bit kernels' products
# run there, so ``imad_bound_ms`` counts their IMAD-family instructions (from
# the SASS) at this rate, the SMs and the card's maximum SM clock.
IMAD_PER_CLOCK_SM = 64


def fail(msg: str) -> int:
    print(f'chip_smoke: {msg}', file=sys.stderr)
    return 2


def nvidia_smi() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_OPS_S
    return max(t_bytes, t_ops) * 1e3, ('bytes' if t_bytes >= t_ops else 'operations')


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
    """Bytes and operations of one B3 call on G polynomials. The bytes are
    the inputs and outputs only, the traffic any implementation must have:
    x read once, the key's β digits over T = L+α rows read once, the
    Q_ℓ∪P twiddle tables of both directions read once, e0 and e1 written
    once (int64); no intermediate counts, whichever route a kernel takes, so
    the bound is one yardstick for every design. The operations: per
    coefficient the decomposition and mod-up, the β·T-row forward NTT, the
    inner product, the 2T-row inverse NTT and the mod-down."""
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
    """Bytes and operations of one B4 call. The bytes are the inputs and
    outputs only, the traffic any implementation must have: dq and da read
    once, both rings' inverse twiddle tables read once, the output written
    once (int64); no intermediate counts, whichever route a kernel takes, so
    the bound is one yardstick for every design. The operations: the
    inverse NTT with its epilogue over L+T rows, then per coefficient
    [tX]_Q, the conversion to the aux basis, the Q^-1 scale and
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


def ptxas_summary(log: str, keep) -> dict:
    """ptxas's report of one library in brief: how many kernels and device
    functions it compiled, the largest stack frame and spill among them,
    each one that has a stack frame or spills, and the registers, stack and
    spills of the kernels ``keep(name)`` picks (the main path's instances).
    The whole report is written to ``build/kernels/ptxas/<lib>.log``."""
    funcs, cur = {}, None
    for ln in log.splitlines():
        if 'Function properties for ' in ln:
            cur = ln.split('Function properties for ')[1].strip()
            funcs.setdefault(cur, {})
        elif cur and 'bytes stack frame' in ln:
            nums = [int(w) for w in ln.replace(',', ' ').split() if w.isdigit()]
            funcs[cur].update(stack=nums[0], spill_stores=nums[1], spill_loads=nums[2])
        elif cur and 'Used' in ln and 'registers' in ln:
            funcs[cur]['registers'] = int(ln.split('Used')[1].split()[0])
            if 'bytes smem' in ln:
                funcs[cur]['static_smem'] = int(ln.split('bytes smem')[0].split()[-1])
    heavy = {k: v for k, v in funcs.items()
             if v.get('stack', 0) or v.get('spill_stores', 0) or v.get('spill_loads', 0)}
    return {'functions': len(funcs),
            'max_stack': max((v.get('stack', 0) for v in funcs.values()), default=0),
            'max_spill': max((v.get('spill_stores', 0) for v in funcs.values()), default=0),
            'with_stack_or_spill': heavy,
            'main_path': {k: v for k, v in funcs.items() if keep(k)}}


def main_path_instance(lib: str, name: str) -> bool:
    """The template instances the paths run: the NTT-sized kernels at 2^14
    and 2^15, B1's and B5's cluster kernels and B3's cluster route, B2's
    extension and B4's scale-back at L = 8, B6's compile-time (L, T)
    instances (its run-time-T ones are <L, 0>), B7's compile-time beta
    instances."""
    if lib in ('ntt32', 'ntt64', 'ksw32'):
        return 'Li14E' in name or 'Li15E' in name or 'cluster_kernel' in name
    if lib == 'behz32':
        return 'Li14E' in name or 'Li8E' in name
    return 'Li0EE' not in name


def sass_imad(cuda_build) -> dict:
    """IMAD-family instructions (IMAD, IMAD.WIDE, IMAD.HI, IMAD.X, IMAD.MOV,
    IMAD.SHL, IMAD.IADD, ...: each issues on the integer multiply-add pipe)
    in the SASS of every function of the 64-bit word's libraries, by mangled
    name, from ``cuobjdump -sass`` of the built library (the toolkit's, beside
    nvcc); empty where the toolkit has no cuobjdump."""
    tool = os.path.join(os.path.dirname(cuda_build.nvcc_path()), 'cuobjdump')
    if not os.path.exists(tool):
        return {}
    counts = {}
    for lib in ('ntt64', 'bconv64', 'ksw64'):
        text = subprocess.run([tool, '-sass', cuda_build.library_path(lib)], capture_output=True,
                              text=True, timeout=600, check=True).stdout
        cur = None
        for ln in text.splitlines():
            if 'Function : ' in ln:
                cur = ln.split('Function : ')[1].strip()
                counts[cur] = 0
            elif cur and re.match(r'\s*/\*[0-9a-f]+\*/\s+(@!?U?P[T0-9]\s+)?IMAD', ln):
                counts[cur] += 1
    return counts


def time_ms(torch, fn, iters: int, warmup: int = WARMUP) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(torch, fn, per_call: int, parts: dict, reps: int = 5) -> dict:
    """Device milliseconds per call of each kernel of ``parts`` (part name ->
    a substring of the kernel's name), each launched ``per_call`` times by
    ``fn``, from torch.profiler: the mean over the launches it traced (it
    may trace fewer than it ran), times ``per_call``; and the traced and run
    counts."""
    fn()
    torch.cuda.synchronize()
    act = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us, traced = dict.fromkeys(parts, 0.0), dict.fromkeys(parts, 0)
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            for part, kernel in parts.items():
                if kernel in e.key:
                    us[part] += e.device_time_total
                    traced[part] += e.count
    out = {part: us[part] / 1e3 / traced[part] * per_call if traced[part] else None
           for part in us}
    return {**out, 'traced': traced, 'ran': reps * per_call}


def flat_outputs(out: dict) -> list:
    """A task's outputs in output-id order, list outputs flattened."""
    def flat(v):
        return [e for x in v for e in flat(x)] if isinstance(v, list) else [v]
    return [v for k in sorted(out) for v in flat(out[k])]


def outputs_equal(torch, a: dict, b: dict) -> bool:
    fa, fb = flat_outputs(a), flat_outputs(b)
    return len(fa) == len(fb) and all(
        torch.equal(x.data.cpu(), y.data.cpu()) and (x.level, x.is_ntt, x.is_mform, x.scale)
        == (y.level, y.is_ntt, y.is_mform, y.scale) for x, y in zip(fa, fb))


def busy_and_top(torch, fn, reps: int = 5, top: int = 0, host_ops: bool = True):
    """Device time a call of ``fn`` (every kernel and copy on the card): the
    self device time of ``reps`` calls in one torch.profiler window over
    ``reps``, after a warm-up call, None if it traced none; and the ``top``
    kernels by device time, [name, ms a call, launches a call]. Without
    ``host_ops`` the window records the device's activity only: a bootstrap
    launches ~37 000 kernels and several times as many host ops, whose
    records cost the window tens of seconds; the device times are the same."""
    fn()
    torch.cuda.synchronize()
    act = [torch.profiler.ProfilerActivity.CUDA]
    if host_ops:
        act.append(torch.profiler.ProfilerActivity.CPU)
    with torch.profiler.profile(activities=act) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    us = sum(e.self_device_time_total for e in dev)
    best = sorted(dev, key=lambda e: -e.self_device_time_total)[:top]
    return (us / 1e3 / reps if us else None,
            [[e.key[:80], e.self_device_time_total / 1e3 / reps, e.count / reps] for e in best])


def busy_ms(torch, fn, reps: int = 5) -> float | None:
    return busy_and_top(torch, fn, reps)[0]


def idle_share(busy: float | None, wall_ms: float) -> float | None:
    return None if busy is None else 1 - busy / wall_ms


class TimedRng:
    """A party's generator that adds the host seconds of each draw to
    ``spent``: a protocol round's sampling, apart from its device work."""

    def __init__(self, rng):
        self.rng, self.spent = rng, 0.0

    def __getattr__(self, name):
        fn = getattr(self.rng, name)

        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.spent += time.perf_counter() - t0
        return timed


def event_ms(torch, fn):
    """(fn(), the ms between CUDA events around it, its host work included)."""
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    stop.synchronize()
    return out, start.elapsed_time(stop)


def read_csv(path: str) -> tuple[list[str], list[list[str]]]:
    with open(path) as f:
        header = f.readline().strip().split(',')
        return header, [line.strip().split(',') for line in f if line.strip()]


def banded_matrix(np, s: int, n1: int, rng):
    """An s × s matrix with 32 nonzero diagonals, {0..15} ∪ {n1·k, k = 1..16}:
    15 hoisted baby rotations and 16 giant ones in ``EncryptedMatVec``'s BSGS
    split (n1 its baby-step count), 31 Galois keys."""
    A = np.zeros((s, s))
    k = np.arange(s)
    for d in list(range(16)) + [n1 * j for j in range(1, 17)]:
        A[k, (k + d) % s] = rng.uniform(-1, 1, s)
    return A


def model_specs(np, full: bool, slots: int):
    """The model lines: label → (chain kind, make(models, fe, matrix) →
    model, pack(model, ctx, rng) → (inputs, oracle), decoded-error bound,
    sizes). At full width the JAX examples' sizes; at the toy chain
    (``full`` False) the sizes of ``tests/test_models.py``."""
    skip = slots // 8
    n_feat = 30 if full else 13
    shape, pack_c = ((32, 32), max(1, min(4, slots // 1024))) if full else ((4, 4), 2)

    def logistic(M, fe, A):
        return M.LogisticRegressionScore(fe, n_features=n_feat, level=3)

    def pack_logistic(m, c, rng):
        xv, wv = rng.uniform(-1, 1, n_feat), rng.uniform(-1, 1, n_feat)
        return m.pack_inputs(c, xv, wv, 0.25), xv @ wv + 0.25

    def distance(M, fe, A):
        return M.PackedEuclideanDistance(fe, pack=4, skip=skip, level=3)

    def pack_distance(m, c, rng):
        xv, wv = rng.uniform(-1, 1, 4 * skip), rng.uniform(-1, 1, 4 * skip)
        return m.pack_inputs(c, xv, wv), ((xv - wv).reshape(4, skip) ** 2).sum(axis=0)

    def conv(M, fe, A):
        return M.PackedConv2d(fe, pack=pack_c, input_shape=shape, kernel_shape=(3, 3), level=2)

    def pack_conv(m, c, rng):
        img = rng.uniform(-1, 1, pack_c * shape[0] * shape[1])
        w, bias = rng.uniform(-1, 1, (pack_c, 9)), float(rng.uniform(-1, 1))
        inputs, xv = m.pack_inputs(c, img, w, bias)
        return inputs, m.reference_conv(xv, w, bias)

    def poly(M, fe, A):
        return M.PolynomialEvaluator(fe, degree=7, top_level=4)

    def pack_poly(m, c, rng):
        xv = rng.integers(0, 50, c.params.n, dtype=np.uint64)
        coeffs = [int(v) for v in rng.integers(1, 50, 8)]
        x = xv.astype(object)
        return (m.pack_inputs(c, xv, coeffs),
                (sum(a * x ** i for i, a in enumerate(coeffs)) % c.params.t).astype(np.uint64))

    def matvec(M, fe, A):
        return M.EncryptedMatVec(fe, A, level=2)

    def pack_matvec(m, c, rng):
        xv = rng.uniform(-1, 1, m.slots)
        return m.pack_inputs(c, xv), m.matrix @ xv
    return {
        'model_logistic_path': ('c', logistic, pack_logistic, 1e-2,
                                {'features': n_feat, 'level': 3}),
        'model_distance_path': ('c', distance, pack_distance, 1e-2,
                                {'pack': 4, 'skip': skip, 'level': 3}),
        'model_conv_path': ('c', conv, pack_conv, 1e-2,
                            {'input': list(shape), 'kernel': [3, 3], 'pack': pack_c,
                             'level': 2}),
        'model_poly_path': ('b', poly, pack_poly, 0, {'degree': 7, 'top_level': 4}),
        'model_matvec_path': ('c', matvec, pack_matvec, 5e-3,
                              {'slots': slots, 'diagonals': 32, 'level': 2}),
        'model_matvec_w32_path': ('w', matvec, pack_matvec, 5e-2,
                                  {'slots': slots, 'diagonals': 32, 'level': 2}),
    }


def model_chains(n: int, full: bool):
    """Chain kind → runtime parameters: at full width ``CkksParams.create``,
    ``BfvParams.create`` and ``CkksParams.create_tpu_param``; at the toy
    width the chains of ``tests/test_models.py`` (``_ckks_toy``,
    ``_bfv_toy``, ``test_encrypted_matvec_w32``)."""
    from lattisense_torch.core.modring import gen_ntt_primes
    from lattisense_torch.params import BfvParams, CkksParams
    if full:
        return {'c': CkksParams.create(n), 'b': BfvParams.create(n),
                'w': CkksParams.create_tpu_param(n)}
    q = gen_ntt_primes(n, 50, 5)
    p = gen_ntt_primes(n, 51, 1, exclude=tuple(q))
    w = gen_ntt_primes(n, 31, 10)
    return {'c': CkksParams.create_custom(n, q, p, scale=float(1 << 40)),
            'b': BfvParams.create_custom(n, 65537, q, p),
            'w': CkksParams.create_custom(n, w[:7], w[7:], scale=float(1 << 30), word_bits=32)}


def frontend_param(params):
    """The frontend parameter of a runtime chain."""
    from lattisense_torch.frontend import custom_task as fe
    if params.algo == 'BFV':
        return fe.BfvParam.create_custom_param(n=params.n, q=list(params.q),
                                               p=list(params.p), t=params.t)
    return fe.CkksParam.create_custom_param(params.n, list(params.q), list(params.p),
                                            slots=params.slots, scale=params.scale)


def model_key_bytes(c, m) -> tuple[int, int]:
    """(bytes of the relinearization key and of the Galois keys the model
    needs, the number of those Galois keys) on context c."""
    from lattisense_torch.schemes.galois import col_sub_steps, galois_elt_col
    n = c.params.n
    elts = ({galois_elt_col(ss, n) for st in m.required_rotations() for ss in col_sub_steps(st, n)}
            | set(m.required_galois_elements()))
    keys = [c.rlk] + [c.glk.keys[e] for e in elts]
    return sum((k.key_q.numel() + k.key_p.numel()) * 8 for k in keys), len(elts)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        return fail('torch.cuda.is_available() is false; this script needs a CUDA card')
    sys.path.insert(0, HERE)
    try:
        import lattisense_torch
    except ImportError as exc:
        return fail(f'lattisense_torch not found beside this script ({exc})')
    if os.path.dirname(os.path.dirname(os.path.abspath(lattisense_torch.__file__))) != HERE:
        return fail('lattisense_torch was imported from outside this checkout')

    from lattisense_torch import abi
    from lattisense_torch.core.modring import gen_ntt_primes, get_rns_ring
    from lattisense_torch.ops import (bconv_cuda, behz_cuda, cuda_build, ksw64_cuda, ksw_cuda,
                                      ntt64_cuda, ntt_cuda, ntt_mxu, plugin_build)
    from lattisense_torch.parallel.launch import World
    from lattisense_torch.tools import mesh_paths
    from lattisense_torch.params import BfvParams, CkksParams
    from lattisense_torch.parallel.batch import (bfv_mult_relin, ckks_composite_params,
                                                 ckks_mult_relin_rescale,
                                                 ckks_mult_relin_rescale2, key_tree,
                                                 make_batched_step, make_rotate_step)
    from lattisense_torch.runtime import BfvContext, CkksContext, FheTask, tasks
    from lattisense_torch.schemes.bfv import BfvEngine
    from lattisense_torch.schemes.ckks import CkksEngine
    from lattisense_torch.plugin import ForeignTask, ForeignVectorArgument
    from lattisense_torch.plugin import fixture as pfx
    from lattisense_torch.schemes import multiparty as mp
    from lattisense_torch.schemes.galois import galois_elt_col
    from lattisense_torch.schemes.keys import SecretKey
    from lattisense_torch.schemes.keyswitch import KeySwitcher
    from lattisense_torch.schemes.types import Ciphertext, GaloisKeys, KeySwitchKey
    from lattisense_torch.tools.profile_step import (bootstrap_context, bootstrap_input,
                                                     bootstrap_segments, key_bytes)
    from lattisense_torch.utils.precision import get_precision_stats

    counts = (ntt_cuda.launches, behz_cuda.launches, ksw_cuda.launches, ntt64_cuda.launches,
              bconv_cuda.launches, ksw64_cuda.launches, ntt_mxu.launches)
    w32_kernels = [k for c in counts[:3] for k in c]
    u64_kernel_counts = [k for c in counts[3:] for k in c]

    def reset_counts():
        for c in counts:
            for k in c:
                c[k] = 0

    def require(what, launches, must_launch, must_not_launch):
        missing = [k for k in must_launch if launches.get(k, 0) == 0]
        if missing:
            raise AssertionError(f'{what} launched no {missing}')
        stray = {k: launches[k] for k in must_not_launch if launches.get(k, 0)}
        if stray:
            raise AssertionError(f'{what} launched {stray}')

    def read_counts():
        return {k: v for c in counts for k, v in c.items()}

    marks = [time.perf_counter()]

    def phase_done(name):
        """Print the seconds since the last phase ended, on a line of its own."""
        marks.append(time.perf_counter())
        print(json.dumps({'phase_s': {name: marks[-1] - marks[-2],
                                      'since_start': marks[-1] - marks[0]}}), flush=True)

    # ---- 1. set-up --------------------------------------------------------
    t0 = time.perf_counter()
    reports = cuda_build.build_all()
    build_s = time.perf_counter() - t0
    gpu = nvidia_smi()
    name_gpu, power = (s.strip() for s in gpu.split(',', 1))
    dev = torch.device('cuda', torch.cuda.current_device())
    os.makedirs(os.path.join(cuda_build.BUILD_DIR, 'ptxas'), exist_ok=True)
    for lib, log in reports.items():
        with open(os.path.join(cuda_build.BUILD_DIR, 'ptxas', f'{lib}.log'), 'w') as f:
            f.write(log)
    ptxas = {lib: ptxas_summary(log, lambda k, lib=lib: main_path_instance(lib, k))
             for lib, log in reports.items()}
    logn = N.bit_length() - 1
    occupancy = {f'{word}_{d}': {'n': N, 'threads': N >> ntt_cuda.schedule(logn)[0],
                                 'blocks_per_sm': mod.blocks_per_sm(logn, d == 'inv')}
                 for word, mod in (('ntt32', ntt_cuda), ('ntt64', ntt64_cuda))
                 for d in ('fwd', 'inv')}
    # B5's and B1's cluster kernels and B3's cluster route: clusters of 2^k
    # blocks over sub-rows of 2^SUB_LOGN that the card runs at once
    # (cudaOccupancyMaxActiveClusters)
    def cluster_entry(sub, lg, smem, fit):
        return {'blocks': 1 << (lg - sub), 'sub_row': 1 << sub,
                'threads': 1 << (sub - ntt_cuda.schedule(sub)[0]), 'dynamic_smem': smem << sub,
                'active_clusters': fit}
    clusters = {f'ntt64_{d}_cluster_n{1 << lg}': cluster_entry(
        ntt64_cuda.SUB_LOGN, lg, 8, ntt64_cuda.cluster_fit(lg, d == 'inv'))
        for lg in (15, 16) for d in ('fwd', 'inv')}
    clusters.update({f'ntt32_{d}_cluster_n65536': cluster_entry(
        ntt_cuda.SUB_LOGN, 16, 4, ntt_cuda.cluster_fit(16, d == 'inv')) for d in ('fwd', 'inv')})
    clusters.update({f'ksw32_cluster_n{1 << lg}': cluster_entry(
        ntt_cuda.SUB_LOGN, lg, 12, ksw_cuda.cluster_fit(1 << lg)) for lg in (15, 16)})
    # the integer multiply-add pipe's rate, and the IMAD-family instructions
    # of the 64-bit kernels' instances in the SASS
    clock_mhz = float(subprocess.run(
        ['nvidia-smi', '--query-gpu=clocks.max.sm', '--format=csv,noheader,nounits'],
        capture_output=True, text=True, timeout=60, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    imad_rate = IMAD_PER_CLOCK_SM * sms * clock_mhz * 1e6
    imad = sass_imad(cuda_build)

    def imad_per(patterns, units_per_body):
        """IMAD-family instructions a unit (a butterfly or a Montgomery
        product) in the one function whose name holds every pattern: its
        static count over the units its straight-line body does per thread
        (one iteration of its outer loop, where it has one; address and
        epilogue instructions fall on the units too); None without SASS."""
        hits = [c for f, c in imad.items() if all(p in f for p in patterns)]
        return hits[0] / units_per_body if len(hits) == 1 else None

    def imad_bound_ms(terms):
        """The IMAD pipe's least time for [(IMAD a unit, units), ...]."""
        if not terms or any(per is None for per, _ in terms):
            return None
        return sum(per * units for per, units in terms) / imad_rate * 1e3

    def b5_imad(logn, inverse):
        """IMAD a butterfly of B5's instance at 2^logn: the row kernel (8
        butterflies a stage a thread, 16 residues) or the cluster kernel."""
        inv = 'Lb1E' if inverse else 'Lb0E'
        k = ntt64_cuda.cluster_depth(logn)
        if k:
            return imad_per(['cluster_kernel', f'W64ELi{ntt64_cuda.SUB_LOGN}ELi{k}E{inv}'],
                            8 * logn)
        return imad_per(['ntt_kernel', f'W64ELi{logn}E{inv}Lb0ENS_8StoreRow'], 8 * logn)

    def b6_imad(L, T, specific):
        """IMAD a Montgomery product of B6's <L, T> (or run-time-T <L, 0>)
        instance: two coefficients, T outputs (one a loop turn at <L, 0>)."""
        TT = T if specific else 0
        return imad_per(['bconv64_kernel', f'ILi{L}ELi{TT}EE'], 2 * L * (TT or 1))

    def b7_imad(beta):
        """IMAD a Montgomery product of B7's compile-time-beta instance: a
        polynomial a loop turn, two components of two coefficients."""
        return imad_per(['ksw64_inner_kernel', f'ILi{beta}EE'], 4 * beta)

    def butterflies(shapes, n):
        return sum(math.prod(sh) // n for sh, _ in shapes) * (n // 2) * (n.bit_length() - 1)

    imad_table = {'clock_max_mhz': clock_mhz, 'sms': sms, 'per_clock_sm': IMAD_PER_CLOCK_SM,
                  'sass_functions': len(imad),
                  'b5_per_butterfly': {f'{"inv" if inv else "fwd"}_n{1 << lg}': b5_imad(lg, inv)
                                       for lg in (14, 15, 16) for inv in (False, True)},
                  'b7_per_product': {f'beta{b}': b7_imad(b) for b in (2, 4)}}
    params = BfvParams.create_tpu_param(N)
    eng_c = BfvEngine(params, 'cpu')
    bz_c = eng_c.behz(LEVEL)
    L, T = LEVEL + 1, len(bz_c.ring_aux.moduli)
    # B3's route and blocks per SM at the main path's shapes (B4 runs B1's
    # kernel body with its own row ends, at B1's occupancy)
    fused = {'ksw_switch32': {'route': ksw_cuda.switch_route(N), 'n': N,
                              'threads': N >> ntt_cuda.schedule(logn)[0],
                              'blocks_per_sm': ksw_cuda.rows_blocks_per_sm(N)},
             'behz_finish32': {'route': 'chain', 'n': N, 'L': L, 'T': T}}
    print(json.dumps({'setup': {'torch': torch.__version__, 'cuda': torch.version.cuda,
                                'nvcc': cuda_build.nvcc_path(), 'gpu': gpu,
                                'build_s': round(build_s, 3), 'ptxas': ptxas,
                                'ntt_occupancy': occupancy, 'clusters': clusters,
                                'imad': imad_table, 'fused': fused}}), flush=True)

    t1 = time.perf_counter()
    ctx = BfvContext.create_random_context(params, seed=SEED, device=dev)
    keygen_s = time.perf_counter() - t1
    eng_g = ctx.engine
    bz_g = eng_g.behz(LEVEL)
    sw_g, sw_c = eng_g.switcher, eng_c.switcher
    alpha, beta = sw_g.alpha, sw_g.beta(LEVEL)
    qp = tuple(params.q[:L]) + tuple(params.p)
    rings = {  # name -> (gpu ring, cpu ring)
        'q': (bz_g.ring_q, bz_c.ring_q),
        'aux': (bz_g.ring_aux, bz_c.ring_aux),
        'qp': (get_rns_ring(qp, N, dev), get_rns_ring(qp, N, 'cpu')),
    }
    rng = np.random.default_rng(SEED)

    def residues(moduli, lead):
        cols = [rng.integers(0, q, (*lead, N), dtype=np.int64) for q in moduli]
        return torch.from_numpy(np.stack(cols, axis=-2))

    def cpu_key(k):
        return KeySwitchKey(key_q=k.key_q.cpu(), key_p=k.key_p.cpu())

    def max_err(pairs):
        return max(int((g.cpu() - w).abs().max()) for g, w in pairs)

    phase_done('setup')

    # ---- 2. kernels against their plain twins -----------------------------
    # B1 at the row stacks of one batched mult_relin's NTTs, which B2, B3
    # and B4 run inside their own kernels: forward over the 4 polynomials
    # (q and aux) and the β digits over q∪p; inverse over the 3 products (q
    # and aux) and the 2 components over q∪p; on no path at the main path's
    # shapes, which must launch neither
    fwd_calls = [('q', (BATCH, 4)), ('aux', (BATCH, 4)), ('qp', (BATCH, beta))]
    inv_calls = [('q', (BATCH, 3)), ('aux', (BATCH, 3)), ('qp', (BATCH, 2))]

    def check_ntt(name, calls, kernel, plain, work):
        """Each (ring, lead) call on the card against the twin on a CPU copy."""
        inputs, pairs = [], []
        for ring_name, lead in calls:
            rg, rc = rings[ring_name]
            x = residues(rc.moduli, lead)
            got = kernel(x.to(dev), rg)
            torch.cuda.synchronize()
            want = plain(x, rc)
            if not torch.equal(got.cpu(), want):
                raise AssertionError(f'{name} differs from its plain twin on {ring_name} {lead}')
            pairs.append((got, want))
            inputs.append((x.to(dev), rg))
        ms = time_ms(torch, lambda: [kernel(x, r) for x, r in inputs], ITERS)
        plain_ms = time_ms(torch, lambda: [plain(x, r) for x, r in inputs], ITERS)
        wk = [work(x.numel() // N, len(r.moduli), N) for x, r in inputs]
        bound_ms, bound_by = bound(sum(w[0] for w in wk), sum(w[1] for w in wk))
        return {'shapes': [[list(x.shape), len(r.moduli)] for x, r in inputs],
                'equal': True, 'max_abs_err': max_err(pairs), 'ms': ms, 'plain_ms': plain_ms,
                'bound_ms': bound_ms, 'bound_by': bound_by}

    kernels = {
        'ntt32_fwd': dict(route='cuda', source='lattisense_torch/csrc/ntt32.cu',
                          replaces='lattisense_tpu/ops/ntt_pallas32.py:101',
                          replaces_function='ntt_fused32 (_fwd_kernel)', path=None,
                          **check_ntt('ntt32_fwd', fwd_calls, ntt_cuda.ntt32_fwd,
                                      ntt_cuda.ntt_plain, ntt_work)),
        'ntt32_inv': dict(route='cuda', source='lattisense_torch/csrc/ntt32.cu',
                          replaces='lattisense_tpu/ops/ntt_pallas32.py:173',
                          replaces_function='intt_fused32 (_inv_kernel)', path=None,
                          **check_ntt('ntt32_inv', inv_calls, ntt_cuda.ntt32_inv,
                                      ntt_cuda.intt_plain, ntt_work)),
    }

    # B2 on the 4 input polynomials of each operation; it launches none of
    # B1's entries
    x = residues(rings['q'][1].moduli, (BATCH, 4))
    xg = x.to(dev)
    before = dict(ntt_cuda.launches)
    fq, fa = behz_cuda.behz_prep32(xg, bz_g)
    torch.cuda.synchronize()
    want_fq, want_fa = behz_cuda.behz_prep_plain(x, bz_c)
    if not (torch.equal(fq.cpu(), want_fq) and torch.equal(fa.cpu(), want_fa)):
        raise AssertionError('behz_prep32 differs from its plain twin')
    if ntt_cuda.launches != before:
        raise AssertionError('behz_prep32 launched a B1 entry')
    bound_ms, bound_by = bound(*behz_work(BATCH * 4, L, T, N))
    kernels['behz_prep32'] = dict(
        route='cuda', source='lattisense_torch/csrc/behz32.cu',
        design='extend32 + joint rows: L-templated extension into a uint32 scratch, then '
               "B1's row loop over the L+T rows of the joint ring q ∪ aux",
        replaces='lattisense_tpu/ops/behz_pallas32.py:55',
        replaces_function='behz_prep32 (_k1_kernel)', path='main_path',
        shapes=[[list(x.shape), L, T]], equal=True,
        max_abs_err=max_err([(fq, want_fq), (fa, want_fa)]),
        ms=time_ms(torch, lambda: behz_cuda.behz_prep32(xg, bz_g), ITERS),
        plain_ms=time_ms(torch, lambda: behz_cuda.behz_prep_plain(xg, bz_g), ITERS),
        bound_ms=bound_ms, bound_by=bound_by)
    del x, xg, fq, fa, want_fq, want_fa

    # B3 with the relinearization key on the (B, L, n) third component; the
    # output-NTT variant and a level with a ragged last digit are checked
    rlk_c = cpu_key(ctx.rlk)
    x = residues(params.q[:L], (BATCH,))
    xg = x.to(dev)
    e = ksw_cuda.ksw_switch32(xg, ctx.rlk, sw_g, LEVEL)
    e_ntt = ksw_cuda.ksw_switch32(xg, ctx.rlk, sw_g, LEVEL, output_ntt=True)
    torch.cuda.synchronize()
    want = sw_c.switch_plain(x, rlk_c, LEVEL)
    want_ntt = tuple(ntt_cuda.ntt_plain(w, rings['q'][1]) for w in want)
    pairs = list(zip(e, want)) + list(zip(e_ntt, want_ntt))
    low = 5                                        # L = 6: the second digit is ragged
    x_low = residues(params.q[:low + 1], (4,))
    e_low = ksw_cuda.ksw_switch32(x_low.to(dev), ctx.rlk, sw_g, low)
    torch.cuda.synchronize()
    pairs += list(zip(e_low, sw_c.switch_plain(x_low, rlk_c, low)))
    if not all(torch.equal(g.cpu(), w) for g, w in pairs):
        raise AssertionError('ksw_switch32 differs from its plain twin')
    bound_ms, bound_by = bound(*ksw_work(BATCH, L, alpha, beta, N))
    kernels['ksw_switch32'] = dict(
        route='cuda', source='lattisense_torch/csrc/ksw32.cu',
        design=fused['ksw_switch32']['route'], cluster=None,
        replaces='lattisense_tpu/ops/ksw_pallas32.py:207',
        replaces_function='ksw_switch32 (_ksw_kernel)', path='main_path',
        shapes=[{'x': list(x.shape), 'level': LEVEL, 'alpha': alpha, 'beta': beta,
                 'T': L + alpha, 'output_ntt': [False, True]},
                {'x': list(x_low.shape), 'level': low, 'beta': sw_g.beta(low)}],
        equal=True, max_abs_err=max_err(pairs),
        ms=time_ms(torch, lambda: ksw_cuda.ksw_switch32(xg, ctx.rlk, sw_g, LEVEL), ITERS),
        plain_ms=time_ms(torch, lambda: sw_g.switch_plain(xg, ctx.rlk, LEVEL), ITERS),
        bound_ms=bound_ms, bound_by=bound_by)
    del x, xg, e, e_ntt, want, want_ntt, pairs, x_low, e_low

    # B4 on the (B, 3, L, n) and (B, 3, T, n) tensor products
    dq, da = residues(rings['q'][1].moduli, (BATCH, 3)), residues(rings['aux'][1].moduli,
                                                                  (BATCH, 3))
    dqg, dag = dq.to(dev), da.to(dev)
    got = behz_cuda.behz_finish32(dqg, dag, bz_g)
    torch.cuda.synchronize()
    want = behz_cuda.behz_finish_plain(dq, da, bz_c)
    if not torch.equal(got.cpu(), want):
        raise AssertionError('behz_finish32 differs from its plain twin')
    bound_ms, bound_by = bound(*finish_work(BATCH * 3, L, T, N))
    kernels['behz_finish32'] = dict(
        route='cuda', source='lattisense_torch/csrc/behz32.cu',
        design='chain', cluster=None,
        replaces='lattisense_tpu/ops/behz_pallas32.py:368',
        replaces_function='behz_finish32 (_k3_kernel)', path='main_path',
        shapes=[[list(dq.shape), list(da.shape)]], equal=True,
        max_abs_err=max_err([(got, want)]),
        ms=time_ms(torch, lambda: behz_cuda.behz_finish32(dqg, dag, bz_g), ITERS),
        plain_ms=time_ms(torch, lambda: behz_cuda.behz_finish_plain(dqg, dag, bz_g), ITERS),
        bound_ms=bound_ms, bound_by=bound_by)
    del dq, da, dqg, dag, got, want

    # B1-r4 and the perm entries at B1's forward / inverse shapes over q; on
    # no path of this script (launches 0), each held against its twin
    perm_twins = {
        'ntt32_fwd_r4': (ntt_cuda.ntt32_fwd_r4, ntt_cuda.ntt_plain, 614,
                         'ntt_fused32_r4 (_fwd_kernel4)'),
        'ntt32_inv_r4': (ntt_cuda.ntt32_inv_r4, ntt_cuda.intt_plain, 666,
                         'intt_fused32_r4 (_inv_kernel4)'),
        'ntt32_fwd_perm': (ntt_cuda.ntt32_fwd_perm,
                           lambda x, r: ntt_cuda.perm_layout(ntt_cuda.ntt_plain(x, r)),
                           532, 'ntt_fused32_perm (_fwd_kernel, perm_out)'),
        'ntt32_inv_perm': (ntt_cuda.ntt32_inv_perm,
                           lambda x, r: ntt_cuda.intt_plain(ntt_cuda.unperm_layout(x), r),
                           539, 'intt_fused32_perm (_inv_kernel, perm_in)'),
    }
    for kname, (kernel, plain, line, fn) in perm_twins.items():
        calls = [('q', (BATCH, 4))] if 'fwd' in kname else [('q', (BATCH, 3))]
        kernels[kname] = dict(route='cuda', source='lattisense_torch/csrc/ntt32.cu',
                              replaces=f'lattisense_tpu/ops/ntt_pallas32.py:{line}',
                              replaces_function=fn, path=None,
                              **check_ntt(kname, calls, kernel, plain, ntt_work))

    phase_done('kernels_w32')

    # ---- 2b. the 64-bit word's kernels at the u64 path's shapes -----------
    params64 = BfvParams.create(N)
    t1 = time.perf_counter()
    ctx64 = BfvContext.create_random_context(params64, seed=SEED, device=dev)
    keygen64_s = time.perf_counter() - t1
    eng64_g, eng64_c = ctx64.engine, BfvEngine(params64, 'cpu')
    bz64_g, bz64_c = eng64_g.behz(LEVEL64), eng64_c.behz(LEVEL64)
    sw64_g, sw64_c = eng64_g.switcher, eng64_c.switcher
    L64, T64 = LEVEL64 + 1, len(bz64_g.ring_aux.moduli)
    alpha64, beta64 = sw64_g.alpha, sw64_g.beta(LEVEL64)
    rings.update({
        'q64': (bz64_g.ring_q, bz64_c.ring_q),
        'aux64': (bz64_g.ring_aux, bz64_c.ring_aux),
        'qp64': (sw64_g.ring_qp(LEVEL64), sw64_c.ring_qp(LEVEL64)),
    })
    # B5 forward: the 4 polynomials over q and over aux (mult), the β digits
    # over q∪p (key switch); inverse: the 3 products over q and aux, the 2
    # key components over q∪p
    kernels['ntt64_fwd'] = dict(
        route='cuda', source='lattisense_torch/csrc/ntt64.cu',
        replaces='lattisense_tpu/ops/ntt_pallas64f.py:48',
        replaces_function='ntt_fused64 (_fwd_kernel); also ntt_pallas.py:134 ntt_fused',
        path='u64_path',
        **check_ntt('ntt64_fwd', [('q64', (BATCH, 4)), ('aux64', (BATCH, 4)),
                                  ('qp64', (BATCH, beta64))],
                    ntt64_cuda.ntt64_fwd, ntt64_cuda.ntt64_plain,
                    lambda r, lb, n: ntt64_work(r, lb, n, False)))
    kernels['ntt64_inv'] = dict(
        route='cuda', source='lattisense_torch/csrc/ntt64.cu',
        replaces='lattisense_tpu/ops/ntt_pallas64f.py:98',
        replaces_function=('intt_fused64 (_inv_kernel); also ntt_pallas.py:471 '
                           '_intt_fused_impl, ntt_pallas.py:745 intt_fused'),
        path='u64_path',
        **check_ntt('ntt64_inv', [('q64', (BATCH, 3)), ('aux64', (BATCH, 3)),
                                  ('qp64', (BATCH, 2))],
                    ntt64_cuda.ntt64_inv, ntt64_cuda.intt64_plain,
                    lambda r, lb, n: ntt64_work(r, lb, n, True)))
    for kname in ('ntt64_fwd', 'ntt64_inv'):
        kernels[kname]['imad_bound_ms'] = imad_bound_ms(
            [(b5_imad(logn, kname == 'ntt64_inv'), butterflies(kernels[kname]['shapes'], N))])

    # B6 convert on the four conversions of the path: the BEHZ extension,
    # scale_and_back's Q → aux, Shenoy's B → Q ∪ m_sk, RoundDivP's P → Q;
    # each shape timed alone and the four together
    rdp_g, rdp_c = sw64_g._level_pre(LEVEL64)[5], sw64_c._level_pre(LEVEL64)[5]
    convs = [('extend', bz64_g.extend.conv, bz64_c.extend.conv, (BATCH, 4)),
             ('scale_and_back', bz64_g.conv_q_to_aux, bz64_c.conv_q_to_aux, (BATCH, 3)),
             ('shenoy', bz64_g.shenoy.conv, bz64_c.shenoy.conv, (BATCH, 3)),
             ('round_div_p', rdp_g.conv, rdp_c.conv, (BATCH, 2))]
    ins, pairs, per_shape, wk, imad_terms = [], [], [], [], []
    for cname, cg, cc, lead in convs:
        y = cc.decompose(residues(cc.src, lead))
        got = bconv_cuda.bconv64_convert(y.to(dev), cg)
        torch.cuda.synchronize()
        want = bconv_cuda.bconv64_plain(y, cc.qhat_dst_mont, cc.dst_q, cc.dst_pinv)
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f'bconv64_convert differs from its plain twin ({cname})')
        yg = y.to(dev)
        pairs.append((got, want))
        ins.append((yg, cg))
        Ls, Ts = len(cc.src), len(cc.dst)
        w = bconv64_work(y.numel() // (Ls * N), Ls, Ts, N)
        wk.append(w)
        b_ms, b_by = bound(*w)
        inst = bconv_cuda.instance(Ls, Ts, max(cc.src) - 1)
        imad_terms.append((b6_imad(Ls, Ts, inst == 'specific'), y.numel() // Ls * Ts * Ls))
        per_shape.append({
            'conversion': cname, 'in': list(y.shape), 'out': list(got.shape),
            'instance': inst, 'imad_bound_ms': imad_bound_ms(imad_terms[-1:]),
            'fold': bconv_cuda.lazy_fold(Ls, max(cc.src) - 1),
            'ms': time_ms(torch, lambda yg=yg, cg=cg: bconv_cuda.bconv64_convert(yg, cg), ITERS),
            'plain_ms': time_ms(torch, lambda yg=yg, cg=cg: bconv_cuda.bconv64_plain(
                yg, cg.qhat_dst_mont, cg.dst_q, cg.dst_pinv), ITERS),
            'bound_ms': b_ms, 'bound_by': b_by})
    bound_ms, bound_by = bound(sum(w[0] for w in wk), sum(w[1] for w in wk))
    kernels['bconv64_convert'] = dict(
        route='cuda', source='lattisense_torch/csrc/bconv64.cu',
        design='lazy: compile-time (L, T) instances, one Montgomery reduction an output',
        replaces='lattisense_tpu/ops/bconv_pallas.py:57',
        replaces_function='bconv_convert_fused (_bconv_kernel)', path='u64_path',
        shapes=[{s['conversion']: [s['in'], s['out']]} for s in per_shape],
        per_shape=per_shape, equal=True, max_abs_err=max_err(pairs),
        ms=time_ms(torch, lambda: [bconv_cuda.bconv64_convert(y, c) for y, c in ins], ITERS),
        plain_ms=time_ms(torch, lambda: [bconv_cuda.bconv64_plain(
            y, c.qhat_dst_mont, c.dst_q, c.dst_pinv) for y, c in ins], ITERS),
        bound_ms=bound_ms, bound_by=bound_by, imad_bound_ms=imad_bound_ms(imad_terms))
    del ins, pairs

    # B6 raw: the key switch's mod-up of all β digits in one launch
    pre_g, pre_c = sw64_g._level_pre(LEVEL64), sw64_c._level_pre(LEVEL64)
    rq_g, rq_c = rings['qp64']
    y = residues(params64.q[:L64], (BATCH,)).reshape(BATCH, beta64, alpha64, N)
    yg = y.to(dev)
    got = bconv_cuda.bconv64_raw(yg, pre_g[4], rq_g.q, rq_g.pinv)
    torch.cuda.synchronize()
    want = bconv_cuda.bconv64_plain(y, pre_c[4], rq_c.q, rq_c.pinv)
    if not torch.equal(got.cpu(), want):
        raise AssertionError('bconv64_raw differs from its plain twin')
    bound_ms, bound_by = bound(*bconv64_work(BATCH * beta64, alpha64, L64 + alpha64, N))
    kernels['bconv64_raw'] = dict(
        route='cuda', source='lattisense_torch/csrc/bconv64.cu',
        design='lazy: compile-time (L, T) instances, one Montgomery reduction an output',
        instance=bconv_cuda.instance(alpha64, L64 + alpha64, bconv_cuda.WORD_GUARD),
        fold=bconv_cuda.lazy_fold(alpha64, bconv_cuda.WORD_GUARD),
        replaces='lattisense_tpu/ops/bconv_pallas.py:57',
        replaces_function='bconv_raw_fused (_bconv_kernel), all beta digits per launch',
        path='u64_path', shapes=[[list(y.shape), list(got.shape)]], equal=True,
        max_abs_err=max_err([(got, want)]),
        ms=time_ms(torch, lambda: bconv_cuda.bconv64_raw(yg, pre_g[4], rq_g.q, rq_g.pinv),
                   ITERS),
        plain_ms=time_ms(torch, lambda: bconv_cuda.bconv64_plain(yg, pre_g[4], rq_g.q,
                                                                 rq_g.pinv), ITERS),
        bound_ms=bound_ms, bound_by=bound_by,
        imad_bound_ms=imad_bound_ms([(b6_imad(
            alpha64, L64 + alpha64,
            bconv_cuda.instance(alpha64, L64 + alpha64, bconv_cuda.WORD_GUARD) == 'specific'),
            y.numel() * (L64 + alpha64))]))
    del y, yg, got, want

    # B7: the relinearization key's inner product with (B, β, T, n) digits
    rlk64_c = cpu_key(ctx64.rlk)
    d = residues(rq_c.moduli, (BATCH, beta64))
    dg = d.to(dev)
    got = ksw64_cuda.ksw_inner64(dg, ctx64.rlk, LEVEL64, rq_g)
    torch.cuda.synchronize()
    want = ksw64_cuda.ksw_inner64_plain(d, rlk64_c, LEVEL64, rq_c)
    if not torch.equal(got.cpu(), want):
        raise AssertionError('ksw_inner64 differs from its plain twin')
    bound_ms, bound_by = bound(*ksw64_work(BATCH, beta64, L64 + alpha64, N))
    kernels['ksw_inner64'] = dict(
        route='cuda', source='lattisense_torch/csrc/ksw64.cu',
        replaces='lattisense_tpu/ops/ksw_pallas.py:29',
        replaces_function='ksw_inner_fused (_ksw_kernel)', path='u64_path',
        shapes=[{'digits': list(d.shape), 'key_q': list(ctx64.rlk.key_q.shape),
                 'key_p': list(ctx64.rlk.key_p.shape), 'out': list(got.shape)}],
        equal=True, max_abs_err=max_err([(got, want)]),
        ms=time_ms(torch, lambda: ksw64_cuda.ksw_inner64(dg, ctx64.rlk, LEVEL64, rq_g), ITERS),
        plain_ms=time_ms(torch, lambda: ksw64_cuda.ksw_inner64_plain(dg, ctx64.rlk, LEVEL64,
                                                                     rq_g), ITERS),
        bound_ms=bound_ms, bound_by=bound_by,
        imad_bound_ms=imad_bound_ms([(b7_imad(beta64), got.numel() * beta64)]))
    del d, dg, got, want
    torch.cuda.empty_cache()

    phase_done('kernels_u64')

    # ---- 3.-6. the paths --------------------------------------------------
    def run_path(label, c, eng_cpu, level, step_fn, n_inputs, keys, cpu_keys, msgs, expect,
                 must_launch, must_not_launch, extra, iters=MAIN_ITERS, judge=None):
        """Warm up, run once between a reset and a read of every count, time
        the step, check element 0 against the port's plain path on the CPU
        and the decryption of the outputs, and print the path's line. By
        default every output must decrypt to ``expect(i)`` (BFV);
        ``judge(out, cpu_out)`` → (correct, the line's fields) replaces that
        check. The line holds the device's busy ms a step and idle share."""
        n = c.params.n
        t1 = time.perf_counter()
        cts = [c.encrypt(c.encode(m, level)) for m in msgs]
        encrypt_s = time.perf_counter() - t1
        args = [torch.stack([ct.data for ct in cts[i * BATCH:(i + 1) * BATCH]])
                for i in range(n_inputs)]
        is_ntt, scale = cts[0].is_ntt, cts[0].scale
        step = make_batched_step(c.engine, step_fn, level, n_inputs=n_inputs, is_ntt=is_ntt)
        step(*args, keys)                                  # warm-up: tables, caches
        torch.cuda.synchronize()
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        out = step(*args, keys)
        torch.cuda.synchronize()
        launches = read_counts()
        peak_mem = torch.cuda.max_memory_allocated()
        missing = [k for k in must_launch if launches.get(k, 0) == 0]
        if missing:
            raise AssertionError(f'the {label} launched no {missing}')
        stray = {k: launches[k] for k in must_not_launch if launches.get(k, 0)}
        if stray:
            raise AssertionError(f'the {label} launched {stray}')
        step_ms = time_ms(torch, lambda: step(*args, keys), iters)
        busy = busy_ms(torch, lambda: step(*args, keys))
        out_cpu = step_fn(eng_cpu, *[Ciphertext(data=a[:1].cpu(), level=level, is_ntt=is_ntt,
                                                scale=scale) for a in args], cpu_keys)
        if out.shape != (BATCH, 2, out_cpu.level + 1, n):
            raise AssertionError(f'{label} output shape {tuple(out.shape)}')
        if judge is None:
            fields = {}
            correct = all(np.array_equal(c.decrypt_decode(Ciphertext(data=out[i], level=level)),
                                         expect(i)) for i in range(BATCH))
        else:
            correct, fields = judge(out, out_cpu)
        bit_exact = torch.equal(out_cpu.data[0], out[0].cpu())
        print(json.dumps({label: {
            **extra, **fields, 'n': n, 'level': level, 'batch': BATCH, 'limbs': level + 1,
            'correct': correct, 'bit_exact_vs_plain': bit_exact,
            'ms_per_step': step_ms, 'ops_per_s': BATCH * 1e3 / step_ms,
            'busy_ms': busy, 'idle_share': idle_share(busy, step_ms),
            'launches_per_step': launches, 'peak_mem_bytes': peak_mem,
            'encrypt_s': encrypt_s, 'gpu': name_gpu, 'power_limit': power}}), flush=True)
        if not (correct and bit_exact):
            raise AssertionError(f'{label} correct={correct} bit_exact_vs_plain={bit_exact}')
        return {'launches': launches, 'args': args, 'out': out, 'ms_per_step': step_ms}

    def cpu_context(c):
        """A CPU context holding c's keys."""
        twin = type(c).from_arrays(c.params, c.sk.coeffs, c.pk.data.cpu(), c.rlk.key_q.cpu(),
                                   c.rlk.key_p.cpu(), device='cpu')
        for e, k in c.glk.keys.items():
            twin.add_galois_key_arrays(e, k.key_q.cpu(), k.key_p.cpu())
        return twin

    def on_cpu(v):
        return dataclasses.replace(v, data=v.data.cpu())

    def run_task(label, c, name, online, offline, must_launch, must_not_launch):
        """The committed task ``name`` on context c, eager and as a graph
        replay: a warm-up eager run (the task engine's constants), one eager
        run between a reset and a read of every count, the graph's warm-up
        and capture (``compile``), one replay that must equal eager bit for
        bit, the runtime's ms per run of each, and each one's idle share of
        the device; → (eager outputs, the line's entries, the eager task, the
        jit task)."""
        d = tasks.task_dir(name)
        eager, jit = FheTask(d, mode='eager'), FheTask(d, mode='jit')
        for t in (eager, jit):
            t.preload(c, offline)
        eager.run(c, online)
        torch.cuda.synchronize()
        reset_counts()
        out_e, _ = eager.run(c, online)
        launches = read_counts()
        missing = [k for k in must_launch if launches.get(k, 0) == 0]
        if missing:
            raise AssertionError(f'the eager {label} launched no {missing}')
        stray = {k: launches[k] for k in must_not_launch if launches.get(k, 0)}
        if stray:
            raise AssertionError(f'the eager {label} launched {stray}')
        t1 = time.perf_counter()
        jit.compile(c, online)
        compile_s = time.perf_counter() - t1
        out_j, _ = jit.run(c, online)
        if not outputs_equal(torch, out_j, out_e):
            raise AssertionError(f'{label}: the graph replay differs from the eager run')
        ms = {}
        for mode, t in (('eager', eager), ('replay', jit)):
            ms[mode] = sum(t.run(c, online)[1] for _ in range(TASK_ITERS)) / TASK_ITERS / 1e6
        busy = {mode: busy_ms(torch, lambda t=t: t.run(c, online))
                for mode, t in (('eager', eager), ('replay', jit))}
        return out_e, {
            'task': name, 'compute_nodes': len(eager.mag['compute']),
            'plan_steps': {'eager': len(eager.plan), 'jit': len(jit.plan)},
            'eager_ms_per_run': ms['eager'], 'replay_ms_per_run': ms['replay'],
            'eager_busy_ms': busy['eager'], 'replay_busy_ms': busy['replay'],
            'eager_idle_share': idle_share(busy['eager'], ms['eager']),
            'replay_idle_share': idle_share(busy['replay'], ms['replay']),
            'compile_s': compile_s, 'replay_equals_eager': True, 'launches_eager': launches,
            'gpu': name_gpu, 'power_limit': power}, eager, jit

    def run_mix(label, c, level, must_launch, must_not_launch, name):
        """The op-mix task on context c at ``level``: every output of the eager
        run equals the port's CPU run bit for bit and decrypts to its NumPy
        plaintext; the line's entries."""
        with open(os.path.join(tasks.task_dir(name), 'task_signature.json')) as f:
            c.gen_galois_keys_for_elements([int(e) for e in json.load(f)['key']['glk']])
        msgs = tasks.mix_messages(c.params.t, c.params.n, SEED)
        online, offline = tasks.mix_arguments(c, level, msgs)
        out_e, entry, _, _ = run_task(label, c, name, online, offline, must_launch,
                                      must_not_launch)
        twin = cpu_context(c)
        cpu_task = FheTask(tasks.task_dir(name), mode='eager', device='cpu')
        cpu_task.preload(twin, {k: on_cpu(v) for k, v in offline.items()})
        t1 = time.perf_counter()
        out_c, _ = cpu_task.run(twin, {k: on_cpu(v) for k, v in online.items()})
        cpu_s = time.perf_counter() - t1
        bit_exact = outputs_equal(torch, out_e, out_c)
        expected = tasks.mix_expected(msgs, c.params.t)
        wrong = [k for k in tasks.MIX_OUTPUTS
                 for v, m in zip(out_e[k] if isinstance(out_e[k], list) else [out_e[k]],
                                 expected[k] if isinstance(expected[k], list) else [expected[k]])
                 if not np.array_equal(c.decrypt_decode(tasks.coefficient_form(c.engine, v)), m)]
        print(json.dumps({label: {
            **entry, 'n': c.params.n, 'level': level, 'word_bits': c.params.word_bits,
            'outputs': len(flat_outputs(out_e)), 'correct': not wrong,
            'bit_exact_vs_cpu': bit_exact, 'cpu_run_s': cpu_s}}), flush=True)
        if wrong or not bit_exact:
            raise AssertionError(f'{label}: wrong outputs {wrong}, bit_exact_vs_cpu={bit_exact}')

    path_launches = {}
    # no path at n=16384 runs B1's or B5's cluster kernel; the w32 paths run
    # no B1 entry and B3's fused route
    wide_ntts = ['ntt32_fwd_cluster', 'ntt32_inv_cluster', 'ntt64_fwd_cluster', 'ntt64_inv_cluster']
    if [k for k in read_counts() if k.endswith('_cols') or k.startswith('ksw32_split')]:
        raise AssertionError('a kernel still counts a columns or split route')
    no_b1 = ['ntt32_fwd', 'ntt32_inv'] + wide_ntts
    msgs = rng.integers(0, params.t, (2 * BATCH, N))
    main = run_path(
        'main_path', ctx, eng_c, LEVEL, bfv_mult_relin, 2, key_tree(ctx), {'rlk': rlk_c}, msgs,
        lambda i: (msgs[i] * msgs[BATCH + i]) % params.t,
        [k for k, v in kernels.items() if v['path'] == 'main_path'], no_b1,
        {'op': 'mult_relin', 'params': 'BfvParams.create_tpu_param(16384)', 'word_bits': 32,
         'aux_limbs': T, 'alpha': alpha, 'beta': beta, 'keygen_s': keygen_s})
    path_launches['main_path'] = main['launches']

    elt = galois_elt_col(1, N)
    t1 = time.perf_counter()
    ctx.gen_galois_keys_for_elements([elt])
    galois_keygen_s = time.perf_counter() - t1
    rkeys = key_tree(ctx, galois_elts=[elt])

    def rolled(m):
        half = len(m) // 2
        return np.concatenate([np.roll(m[:half], -1), np.roll(m[half:], -1)])

    rot = run_path('rotate_path', ctx, eng_c, LEVEL, make_rotate_step(elt), 1, rkeys,
                   {'glk': {elt: cpu_key(rkeys['glk'][elt])}}, msgs[:BATCH],
                   lambda i: rolled(msgs[i]), ['ksw_switch32'], no_b1,
                   {'op': 'rotate_col', 'step': 1, 'galois_elt': elt,
                    'galois_keygen_s': galois_keygen_s})
    # what the mesh paths' ranks load (18.): the context's keys and each
    # path's inputs and single-card output
    mesh_dir = tempfile.mkdtemp(prefix='lattisense_mesh_')
    mesh_paths.save(mesh_dir, 'ctx32', mesh_paths.save_context(ctx, [elt]))
    mesh_paths.save(mesh_dir, 'main', {'a': main['args'][0].cpu(), 'b': main['args'][1].cpu(),
                                       'out': main['out'].cpu()})
    mesh_paths.save(mesh_dir, 'rotate', {'a': rot['args'][0].cpu(), 'out': rot['out'].cpu()})
    single_ms = {'main_path': main['ms_per_step'], 'rotate_path': rot['ms_per_step']}
    del rot

    # 10. the 32-mult_relin task on the main path's context and ciphertexts
    a_data, b_data = main['args']
    online = tasks.mult_relin_arguments(
        [Ciphertext(data=a_data[i], level=LEVEL) for i in range(BATCH)],
        [Ciphertext(data=b_data[i], level=LEVEL) for i in range(BATCH)])
    out_t, entry, _, _ = run_task('task_path', ctx, tasks.MULT_RELIN, online, {},
                                  ['behz_prep32', 'ksw_switch32', 'behz_finish32'], no_b1)
    if entry['plan_steps']['jit'] != 2:
        raise AssertionError(f"task_path: the fused plan has {entry['plan_steps']['jit']} steps")
    zs = [out_t[f'z{k}'] for k in range(BATCH)]
    equal_main = all(torch.equal(z.data, main['out'][k]) for k, z in enumerate(zs))
    correct = all(np.array_equal(ctx.decrypt_decode(z), (msgs[k] * msgs[BATCH + k]) % params.t)
                  for k, z in enumerate(zs))
    print(json.dumps({'task_path': {
        **entry, 'n': N, 'level': LEVEL, 'word_bits': 32, 'batch': BATCH,
        'correct': correct, 'bit_exact_vs_main_path': equal_main,
        'eager_ops_per_s': BATCH * 1e3 / entry['eager_ms_per_run'],
        'replay_ops_per_s': BATCH * 1e3 / entry['replay_ms_per_run'],
        'main_path_ms_per_step': main['ms_per_step']}}), flush=True)
    if not (correct and equal_main):
        raise AssertionError(f'task_path correct={correct} bit_exact_vs_main_path={equal_main}')
    del main, online, out_t, zs
    run_mix('task_mix_path', ctx, LEVEL, ['ntt32_fwd', 'ntt32_inv', 'behz_prep32', 'ksw_switch32',
                                          'behz_finish32'], u64_kernel_counts, tasks.MIX_W32)
    del ctx, rkeys
    torch.cuda.empty_cache()

    u64_kernels = [k for k, v in kernels.items() if v['path'] == 'u64_path']
    msgs64 = rng.integers(0, params64.t, (2 * BATCH, N))
    u64 = run_path(
        'u64_path', ctx64, eng64_c, LEVEL64, bfv_mult_relin, 2, key_tree(ctx64),
        {'rlk': rlk64_c}, msgs64, lambda i: (msgs64[i] * msgs64[BATCH + i]) % params64.t,
        u64_kernels, w32_kernels + wide_ntts,
        {'op': 'mult_relin', 'params': 'BfvParams.create(16384)', 'word_bits': 64,
         'aux_limbs': T64, 'alpha': alpha64, 'beta': beta64, 'keygen_s': keygen64_s})
    path_launches['u64_path'] = u64['launches']
    mesh_paths.save(mesh_dir, 'ctx64', mesh_paths.save_context(ctx64))
    mesh_paths.save(mesh_dir, 'u64', {'a': u64['args'][0].cpu(), 'b': u64['args'][1].cpu(),
                                      'out': u64['out'].cpu()})
    single_ms['u64_path'] = u64['ms_per_step']
    phase_done('paths_to_u64')

    # ---- 17. the MXU NTT: the four-step NTT as tensor-core matrix products --
    # each transform of u64_path's shapes against B5 bit for bit, on both
    # routes (bf16 bmm with float32 sums, int8 _int_mm), beside B5's ms
    mxu_rows = []
    for direction, calls, route, b5 in (
            ('fwd', [('q64', (BATCH, 4)), ('aux64', (BATCH, 4)), ('qp64', (BATCH, beta64))],
             ntt_mxu.ntt, ntt64_cuda.ntt64_fwd),
            ('inv', [('q64', (BATCH, 3)), ('aux64', (BATCH, 3)), ('qp64', (BATCH, 2))],
             ntt_mxu.intt, ntt64_cuda.ntt64_inv)):
        for rname, lead in calls:
            rg = rings[rname][0]
            x = residues(rg.moduli, lead).to(dev)
            want = b5(x, rg)
            macs = ntt_mxu.macs(x.numel() // N, N, ntt_mxu.planes_of(rg.moduli))
            row = {'dir': direction, 'ring': rname, 'shape': list(x.shape), 'macs': macs,
                   'b5_ms': time_ms(torch, lambda x=x, rg=rg, b5=b5: b5(x, rg), ITERS),
                   # the least time of the products alone at the dense peaks
                   'bound_ms_int8': macs * 2 / PEAK_INT8_OPS_S * 1e3,
                   'bound_ms_bf16': macs * 2 / PEAK_BF16_OPS_S * 1e3}
            for i8 in (False, True):
                ntt_mxu.I8DOT = i8
                try:
                    got = route(x, rg)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise AssertionError(f'mxu_path: {direction} {rname} '
                                             f'{"int8" if i8 else "bf16"} differs from B5')
                    row['int8_ms' if i8 else 'bf16_ms'] = time_ms(
                        torch, lambda x=x, rg=rg, route=route: route(x, rg), MXU_ITERS, 1)
                finally:
                    ntt_mxu.I8DOT = False
            mxu_rows.append(row)
            del x, want, got
    torch.cuda.empty_cache()

    # the batched mult_relin with the gate on: B6 and B7 as before, every NTT
    # as matrix products, no B5
    macs_step = [0]

    def counting(fn):
        def run(x, ring):
            macs_step[0] += ntt_mxu.macs(x.numel() // x.shape[-1], x.shape[-1],
                                         ntt_mxu.planes_of(ring.moduli))
            return fn(x, ring)
        return run
    mxu_real = ntt_mxu.ntt, ntt_mxu.intt
    ntt_mxu.ENABLED = True
    try:
        step = make_batched_step(ctx64.engine, bfv_mult_relin, LEVEL64)
        keys64 = key_tree(ctx64)
        step(*u64['args'], keys64)
        torch.cuda.synchronize()
        reset_counts()
        ntt_mxu.ntt, ntt_mxu.intt = counting(mxu_real[0]), counting(mxu_real[1])
        try:
            out = step(*u64['args'], keys64)
            torch.cuda.synchronize()
        finally:
            ntt_mxu.ntt, ntt_mxu.intt = mxu_real
        launches = read_counts()
        mxu_ms = time_ms(torch, lambda: step(*u64['args'], keys64), MXU_ITERS, 1)
        mxu_busy = busy_ms(torch, lambda: step(*u64['args'], keys64), reps=2)
    finally:
        ntt_mxu.ENABLED = False
    equal = torch.equal(out, u64['out'])
    correct = all(np.array_equal(ctx64.decrypt_decode(Ciphertext(data=out[i], level=LEVEL64)),
                                 (msgs64[i] * msgs64[BATCH + i]) % params64.t)
                  for i in range(BATCH))
    b5_launches = {k: launches.get(k, 0) for k in ntt64_cuda.launches}
    missing = [k for k in ('bconv64_convert', 'bconv64_raw', 'ksw_inner64', 'mxu_bmm')
               if not launches.get(k)]
    print(json.dumps({'mxu_path': {
        'transforms': mxu_rows, 'op': 'mult_relin', 'params': 'BfvParams.create(16384)',
        'n': N, 'level': LEVEL64, 'batch': BATCH, 'word_bits': 64, 'correct': correct,
        'bit_exact_vs_u64_path': equal, 'ms_per_step': mxu_ms,
        'u64_path_ms_per_step': u64['ms_per_step'], 'busy_ms': mxu_busy,
        'idle_share': idle_share(mxu_busy, mxu_ms), 'macs_per_step': macs_step[0],
        'launches_per_step': launches, 'b5_launches': b5_launches,
        'gpu': name_gpu, 'power_limit': power}}), flush=True)
    if not (equal and correct) or any(b5_launches.values()) or missing:
        raise AssertionError(f'mxu_path equal={equal} correct={correct} B5={b5_launches} '
                             f'missing={missing}')
    del u64, out, step
    phase_done('mxu')

    t1 = time.perf_counter()
    ctx64.gen_galois_keys_for_elements([elt])
    galois_keygen64_s = time.perf_counter() - t1
    rkeys64 = key_tree(ctx64, galois_elts=[elt])
    run_path('u64_rotate_path', ctx64, eng64_c, LEVEL64, make_rotate_step(elt), 1, rkeys64,
             {'glk': {elt: cpu_key(rkeys64['glk'][elt])}}, msgs64[:BATCH],
             lambda i: rolled(msgs64[i]), u64_kernels, w32_kernels + wide_ntts,
             {'op': 'rotate_col', 'step': 1, 'galois_elt': elt,
              'params': 'BfvParams.create(16384)', 'word_bits': 64,
              'galois_keygen_s': galois_keygen64_s})
    run_mix('task_mix64_path', ctx64, LEVEL64, u64_kernels, w32_kernels + wide_ntts,
            tasks.MIX_U64)

    del ctx64, rkeys64
    torch.cuda.empty_cache()

    phase_done('paths_n16384')

    # ---- 18. the mesh paths: one world of 2 ranks sharing the card over gloo
    # (NCCL refuses two ranks on one device), each rank loading the main
    # path's context and inputs saved above; then a world of 1 over NCCL
    mesh_runs = [
        ('mesh_op_path', 'mesh_op', 'ctx32', 'main', (2, 1, 1), LEVEL, 'main_path'),
        ('limb_tp_path', 'limb_tp', 'ctx32', 'main', (1, 2, 1), LEVEL, 'main_path'),
        ('limb_tp_path_u64', 'limb_tp', 'ctx64', 'u64', (1, 2, 1), LEVEL64, 'u64_path'),
        ('limb_tp_rotate_path', 'limb_tp_rotate', 'ctx32', 'rotate', (1, 2, 1), LEVEL,
         'rotate_path'),
        ('coeff_ksw_path', 'coeff_ksw', 'ctx32', 'main', (1, 1, 2), LEVEL, 'main_path'),
        ('mesh_task_path', 'task_eager', 'ctx32', 'main', (2, 1, 1), LEVEL, 'main_path'),
        ('mesh_task_path', 'task_jit', 'ctx32', 'main', (2, 1, 1), LEVEL, 'main_path')]

    def mesh_line(label, path, world, res, level, like, n=N, batch=BATCH, extra=None):
        fields = {
            **(extra or {}),
            'path': path, 'world': world, 'backend': res[0]['backend'], 'mesh': res[0]['mesh'],
            'n': n, 'level': level, 'batch': batch,
            'bit_exact_vs': like, 'bit_exact': all(r['equal'] for r in res),
            'ms_per_step': res[0]['ms_per_step'],
            'ms_per_step_ranks': [r['ms_per_step'] for r in res],
            'single_card_ms_per_step': single_ms.get(like),
            'collectives_per_step': res[0]['collectives'],
            'staged_bytes_per_step': res[0]['collectives']['staged_bytes'],
            'launches_per_rank': [r['launches'] for r in res], 'graphs': res[0]['graphs'],
            'gpu': name_gpu, 'power_limit': power}
        print(json.dumps({label: fields}), flush=True)
        if not fields['bit_exact']:
            raise AssertionError(f'{label} ({path}) differs from {like}')
        return fields

    t1 = time.perf_counter()
    with World(2, backend='gloo', device=dev, timeout_s=600) as world2:
        world_s = time.perf_counter() - t1
        for label, path, cname, dname, shape, level, like in mesh_runs:
            res = world2.run(mesh_paths.rank_path, mesh_dir, path, cname, dname, shape, level,
                             MESH_ITERS, elt)
            mesh_line(label, path, 2, res, level, like)
    t1 = time.perf_counter()
    with World(1, backend='nccl', device=dev, timeout_s=600) as world1:
        world1_s = time.perf_counter() - t1
        res = world1.run(mesh_paths.rank_path, mesh_dir, 'limb_tp', 'ctx32', 'main', (1, 1, 1),
                         LEVEL, MESH_ITERS)
        nccl = mesh_line('limb_tp_path_nccl', 'limb_tp', 1, res, LEVEL, 'main_path')
    print(json.dumps({'mesh_worlds': {'gloo_world_start_s': world_s,
                                      'nccl_world_start_s': world1_s,
                                      'nccl_collectives': nccl['collectives_per_step']}}),
          flush=True)
    phase_done('mesh')

    # ---- 7.-9. n=32768 and n=2^16 -----------------------------------------
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def card_residues(moduli, lead, n):
        """(*lead, len(moduli), n) residues made on the card from the seed."""
        q = torch.tensor(moduli, dtype=torch.int64, device=dev).reshape(-1, 1)
        return torch.randint(0, 1 << 62, (*lead, len(moduli), n), generator=gen, device=dev) % q

    def hold(kernel_fn, plain_fn, works, iters=ITERS_32K):
        """The kernel's outputs (a list of tensors) against its plain twin's on
        the same inputs, both on the card; times and the bound of ``works``
        (a list of (bytes, operations))."""
        got, want = kernel_fn(), plain_fn()
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError('differs from its plain twin')
        bound_ms, bound_by = bound(sum(w[0] for w in works), sum(w[1] for w in works))
        err = max(int((g - w).abs().max()) for g, w in zip(got, want))
        return {'equal': True, 'max_abs_err': err,
                'ms': time_ms(torch, kernel_fn, ITERS),
                'plain_ms': time_ms(torch, plain_fn, iters, warmup=1),
                'bound_ms': bound_ms, 'bound_by': bound_by}

    def hold_ntt(name, calls, kernel, plain, work, parts):
        """B1 or B5 on each (ring, lead) stack, with the device time of each
        kernel of ``parts`` (see ``device_ms``); B5's with its IMAD bound."""
        inputs = [(card_residues(r.moduli, lead, r.n), r) for r, lead in calls]
        try:
            entry = hold(lambda: [kernel(x, r) for x, r in inputs],
                         lambda: [plain(x, r) for x, r in inputs],
                         [work(x.numel() // r.n, len(r.moduli), r.n) for x, r in inputs])
        except AssertionError as exc:
            raise AssertionError(f'{name} {exc}') from None
        entry['shapes'] = [[list(x.shape), len(r.moduli)] for x, r in inputs]
        entry['device_ms'] = device_ms(torch, lambda: [kernel(x, r) for x, r in inputs],
                                       len(inputs), parts)
        if name.startswith('ntt64'):
            n = inputs[0][1].n
            entry['imad_bound_ms'] = imad_bound_ms(
                [(b5_imad(n.bit_length() - 1, kernel is ntt64_cuda.ntt64_inv),
                  butterflies(entry['shapes'], n))])
        return entry

    def fwd64(r, lb, n):
        return ntt64_work(r, lb, n, False)

    def inv64(r, lb, n):
        return ntt64_work(r, lb, n, True)

    # 7. the u64 chain at n=32768, level 11
    params_u = BfvParams.create(N32K)
    t1 = time.perf_counter()
    ctx_u = BfvContext.create_random_context(params_u, seed=SEED, device=dev)
    keygen_u_s = time.perf_counter() - t1
    eng_u_g, eng_u_c = ctx_u.engine, BfvEngine(params_u, 'cpu')
    bz_u = eng_u_g.behz(LEVEL_U32K)
    sw_u = eng_u_g.switcher
    L_u, T_u = LEVEL_U32K + 1, len(bz_u.ring_aux.moduli)
    alpha_u, beta_u = sw_u.alpha, sw_u.beta(LEVEL_U32K)
    rq_u = sw_u.ring_qp(LEVEL_U32K)
    # B5's cluster kernel on the stacks of the u64 path above, at this
    # chain's widths
    cluster = {'cluster': 'cluster_kernel'}
    design = (f'cluster: {1 << ntt64_cuda.cluster_depth(15)} blocks a row over sub-rows of '
              f'2^{ntt64_cuda.SUB_LOGN}, the cross stages through distributed shared memory')
    kernels['ntt64_fwd_split'] = dict(
        route='cuda', source='lattisense_torch/csrc/ntt_cluster.cuh + csrc/ntt64.cu',
        design=design, replaces='lattisense_tpu/ops/ntt_pallas.py:134',
        replaces_function='ntt_fused: _launch (:326) with _phase1_kernel :134, _phase2_kernel :167',
        path='u64_32k_path', counted_as='ntt64_fwd_cluster',
        **hold_ntt('ntt64_fwd_split', [(bz_u.ring_q, (BATCH, 4)), (bz_u.ring_aux, (BATCH, 4)),
                                       (rq_u, (BATCH, beta_u))],
                   ntt64_cuda.ntt64_fwd, ntt64_cuda.ntt64_plain, fwd64, cluster))
    kernels['ntt64_inv_split'] = dict(
        route='cuda', source='lattisense_torch/csrc/ntt_cluster.cuh + csrc/ntt64.cu',
        design=design,
        replaces='lattisense_tpu/ops/ntt_pallas.py:471',
        replaces_function=('_intt_fused_impl: _ilaunch (:546) with _iphase_a_kernel :471, '
                           '_iphase_b_kernel :509; intt_fused: _claunch (:820) with '
                           '_cinv1_kernel :745, _cinv2_kernel :779'),
        path='u64_32k_path', counted_as='ntt64_inv_cluster',
        **hold_ntt('ntt64_inv_split', [(bz_u.ring_q, (BATCH, 3)), (bz_u.ring_aux, (BATCH, 3)),
                                       (rq_u, (BATCH, 2))],
                   ntt64_cuda.ntt64_inv, ntt64_cuda.intt64_plain, inv64, cluster))
    # B6 on the path's four conversions and its mod-up, B7 on the path's digits
    rdp_u = sw_u._level_pre(LEVEL_U32K)[5]
    convs = [(bz_u.extend.conv, (BATCH, 4)), (bz_u.conv_q_to_aux, (BATCH, 3)),
             (bz_u.shenoy.conv, (BATCH, 3)), (rdp_u.conv, (BATCH, 2))]
    ins = [(cv.decompose(card_residues(cv.src, lead, N32K)), cv) for cv, lead in convs]
    kernels['bconv64_convert_32k'] = dict(
        route='cuda', source='lattisense_torch/csrc/bconv64.cu',
        replaces='lattisense_tpu/ops/bconv_pallas.py:57',
        replaces_function='bconv_convert_fused (_bconv_kernel)', path='u64_32k_path',
        counted_as='bconv64_convert',
        shapes=[[list(y.shape), len(cv.dst)] for y, cv in ins],
        instances=[bconv_cuda.instance(len(cv.src), len(cv.dst), max(cv.src) - 1) for _, cv in ins],
        imad_bound_ms=imad_bound_ms([(b6_imad(len(cv.src), len(cv.dst), bconv_cuda.instance(
            len(cv.src), len(cv.dst), max(cv.src) - 1) == 'specific'), y.numel() * len(cv.dst))
            for y, cv in ins]),
        **hold(lambda: [bconv_cuda.bconv64_convert(y, cv) for y, cv in ins],
               lambda: [bconv_cuda.bconv64_plain(y, cv.qhat_dst_mont, cv.dst_q, cv.dst_pinv)
                        for y, cv in ins],
               [bconv64_work(y.numel() // (len(cv.src) * N32K), len(cv.src), len(cv.dst), N32K)
                for y, cv in ins]))
    del ins
    pre_u = sw_u._level_pre(LEVEL_U32K)
    y = card_residues(params_u.q[:L_u], (BATCH,), N32K).reshape(BATCH, beta_u, alpha_u, N32K)
    kernels['bconv64_raw_32k'] = dict(
        route='cuda', source='lattisense_torch/csrc/bconv64.cu',
        replaces='lattisense_tpu/ops/bconv_pallas.py:57',
        replaces_function='bconv_raw_fused (_bconv_kernel), all beta digits per launch',
        path='u64_32k_path', counted_as='bconv64_raw', shapes=[list(y.shape)],
        instance=bconv_cuda.instance(alpha_u, L_u + alpha_u, bconv_cuda.WORD_GUARD),
        imad_bound_ms=imad_bound_ms([(b6_imad(alpha_u, L_u + alpha_u, bconv_cuda.instance(
            alpha_u, L_u + alpha_u, bconv_cuda.WORD_GUARD) == 'specific'),
            y.numel() * (L_u + alpha_u))]),
        **hold(lambda: [bconv_cuda.bconv64_raw(y, pre_u[4], rq_u.q, rq_u.pinv)],
               lambda: [bconv_cuda.bconv64_plain(y, pre_u[4], rq_u.q, rq_u.pinv)],
               [bconv64_work(BATCH * beta_u, alpha_u, L_u + alpha_u, N32K)]))
    d = card_residues(rq_u.moduli, (BATCH, beta_u), N32K)
    kernels['ksw_inner64_32k'] = dict(
        route='cuda', source='lattisense_torch/csrc/ksw64.cu',
        replaces='lattisense_tpu/ops/ksw_pallas.py:29',
        replaces_function='ksw_inner_fused (_ksw_kernel)', path='u64_32k_path',
        counted_as='ksw_inner64', shapes=[list(d.shape)],
        imad_bound_ms=imad_bound_ms([(b7_imad(beta_u),
                                      BATCH * 2 * (L_u + alpha_u) * N32K * beta_u)]),
        **hold(lambda: [ksw64_cuda.ksw_inner64(d, ctx_u.rlk, LEVEL_U32K, rq_u)],
               lambda: [ksw64_cuda.ksw_inner64_plain(d, ctx_u.rlk, LEVEL_U32K, rq_u)],
               [ksw64_work(BATCH, beta_u, L_u + alpha_u, N32K)]))
    del y, d
    torch.cuda.empty_cache()

    # the cluster kernel, B6 and B7; no 32-bit kernel and not B5's row kernel
    u32k_kernels = [v['counted_as'] for v in kernels.values() if v['path'] == 'u64_32k_path']
    no_u32k = w32_kernels + ['ntt64_fwd', 'ntt64_inv']
    msgs_u = rng.integers(0, params_u.t, (2 * BATCH, N32K))
    path_launches['u64_32k_path'] = run_path(
        'u64_32k_path', ctx_u, eng_u_c, LEVEL_U32K, bfv_mult_relin, 2, key_tree(ctx_u),
        {'rlk': cpu_key(ctx_u.rlk)}, msgs_u, lambda i: (msgs_u[i] * msgs_u[BATCH + i]) % params_u.t,
        u32k_kernels, no_u32k,
        {'op': 'mult_relin', 'params': 'BfvParams.create(32768)', 'word_bits': 64,
         'aux_limbs': T_u, 'alpha': alpha_u, 'beta': beta_u, 'keygen_s': keygen_u_s},
        iters=ITERS_32K)['launches']
    elt_u = galois_elt_col(1, N32K)
    t1 = time.perf_counter()
    ctx_u.gen_galois_keys_for_elements([elt_u])
    galois_keygen_u_s = time.perf_counter() - t1
    rkeys_u = key_tree(ctx_u, galois_elts=[elt_u])
    run_path('u64_32k_rotate_path', ctx_u, eng_u_c, LEVEL_U32K, make_rotate_step(elt_u), 1,
             rkeys_u, {'glk': {elt_u: cpu_key(rkeys_u['glk'][elt_u])}}, msgs_u[:BATCH],
             lambda i: rolled(msgs_u[i]), u32k_kernels, no_u32k,
             {'op': 'rotate_col', 'step': 1, 'galois_elt': elt_u,
              'params': 'BfvParams.create(32768)', 'word_bits': 64, 'aux_limbs': T_u,
              'alpha': alpha_u, 'beta': beta_u, 'galois_keygen_s': galois_keygen_u_s},
             iters=ITERS_32K)
    del ctx_u, rkeys_u
    torch.cuda.empty_cache()

    # 8. the 31-bit profile at n=32768, level 21
    params_w = BfvParams.create_tpu_param(N32K)
    t1 = time.perf_counter()
    ctx_w = BfvContext.create_random_context(params_w, seed=SEED, device=dev)
    keygen_w_s = time.perf_counter() - t1
    eng_w_g, eng_w_c = ctx_w.engine, BfvEngine(params_w, 'cpu')
    bz_w = eng_w_g.behz(LEVEL_W32K)
    sw_w = eng_w_g.switcher
    L_w, T_w = LEVEL_W32K + 1, len(bz_w.ring_aux.moduli)
    alpha_w, beta_w = sw_w.alpha, sw_w.beta(LEVEL_W32K)
    x = card_residues(bz_w.ring_q.moduli, (BATCH, 4), N32K)
    kernels['behz_prep32_32k'] = dict(
        route='cuda', source='lattisense_torch/csrc/behz32.cu',
        replaces='lattisense_tpu/ops/behz_pallas32.py:55',
        replaces_function='behz_prep32 (_k1_kernel)', path='w32_32k_path',
        counted_as='behz_prep32', shapes=[[list(x.shape), L_w, T_w]],
        **hold(lambda: list(behz_cuda.behz_prep32(x, bz_w)),
               lambda: list(behz_cuda.behz_prep_plain(x, bz_w)),
               [behz_work(BATCH * 4, L_w, T_w, N32K)]))
    x = card_residues(params_w.q[:L_w], (BATCH,), N32K)
    kernels['ksw_switch32_32k'] = dict(
        route='cuda', source='lattisense_torch/csrc/ksw32.cu + csrc/ntt_cluster.cuh',
        design=ksw_cuda.switch_route(N32K), cluster=clusters['ksw32_cluster_n32768'],
        replaces='lattisense_tpu/ops/ksw_pallas32.py:207',
        replaces_function='ksw_switch32 (_ksw_kernel)', path='w32_32k_path',
        counted_as='ksw_switch32',
        shapes=[{'x': list(x.shape), 'level': LEVEL_W32K, 'alpha': alpha_w, 'beta': beta_w,
                 'T': L_w + alpha_w}],
        **hold(lambda: list(ksw_cuda.ksw_switch32(x, ctx_w.rlk, sw_w, LEVEL_W32K)),
               lambda: list(sw_w.switch_plain(x, ctx_w.rlk, LEVEL_W32K)),
               [ksw_work(BATCH, L_w, alpha_w, beta_w, N32K)]))
    dq = card_residues(bz_w.ring_q.moduli, (BATCH, 3), N32K)
    da = card_residues(bz_w.ring_aux.moduli, (BATCH, 3), N32K)
    kernels['behz_finish32_32k'] = dict(
        route='cuda', source='lattisense_torch/csrc/behz32.cu',
        replaces='lattisense_tpu/ops/behz_pallas32.py:368',
        replaces_function='behz_finish32 (_k3_kernel)', path='w32_32k_path',
        counted_as='behz_finish32', shapes=[[list(dq.shape), list(da.shape)]],
        **hold(lambda: [behz_cuda.behz_finish32(dq, da, bz_w)],
               lambda: [behz_cuda.behz_finish_plain(dq, da, bz_w)],
               [finish_work(BATCH * 3, L_w, T_w, N32K)]))
    del x, dq, da
    torch.cuda.empty_cache()

    msgs_w = rng.integers(0, params_w.t, (2 * BATCH, N32K))
    w32k_kernels = [v['counted_as'] for v in kernels.values() if v['path'] == 'w32_32k_path']
    path_launches['w32_32k_path'] = run_path(
        'w32_32k_path', ctx_w, eng_w_c, LEVEL_W32K, bfv_mult_relin, 2, key_tree(ctx_w),
        {'rlk': cpu_key(ctx_w.rlk)}, msgs_w, lambda i: (msgs_w[i] * msgs_w[BATCH + i]) % params_w.t,
        w32k_kernels, [k for k in w32_kernels if k not in w32k_kernels] + u64_kernel_counts,
        {'op': 'mult_relin', 'params': 'BfvParams.create_tpu_param(32768)', 'word_bits': 32,
         'aux_limbs': T_w, 'alpha': alpha_w, 'beta': beta_w,
         'ksw_route': ksw_cuda.switch_route(N32K), 'keygen_s': keygen_w_s},
        iters=ITERS_32K)['launches']
    del ctx_w
    torch.cuda.empty_cache()

    # 9. B5 and B1 at n = 2^16 on a card-test stack (37, 12, n), on no path
    r64 = get_rns_ring([p for bits in (61, 60) for p in gen_ntt_primes(N64K, bits, 6)], N64K,
                       dev, 64)
    r32 = get_rns_ring(gen_ntt_primes(N64K, 31, 12), N64K, dev)
    for kname, ring, kernel, plain, work, fn, line in (
            ('ntt64_fwd_n65536', r64, ntt64_cuda.ntt64_fwd, ntt64_cuda.ntt64_plain, fwd64,
             'ntt_fused: _phase1_kernel / _phase2_kernel', 'ntt_pallas.py:134'),
            ('ntt64_inv_n65536', r64, ntt64_cuda.ntt64_inv, ntt64_cuda.intt64_plain, inv64,
             '_intt_fused_impl / intt_fused: _iphase_a/_b, _cinv1/_cinv2', 'ntt_pallas.py:471'),
            ('ntt32_fwd_n65536', r32, ntt_cuda.ntt32_fwd, ntt_cuda.ntt_plain, ntt_work,
             'ntt_fused32 (_fwd_kernel)', 'ntt_pallas32.py:101'),
            ('ntt32_inv_n65536', r32, ntt_cuda.ntt32_inv, ntt_cuda.intt_plain, ntt_work,
             'intt_fused32 (_inv_kernel)', 'ntt_pallas32.py:173')):
        # the cluster kernels, clusters of 2^(16 - SUB_LOGN) blocks
        source = ('lattisense_torch/csrc/ntt_cluster.cuh + csrc/'
                  + ('ntt64.cu' if ring is r64 else 'ntt32.cu'))
        counted, parts = kname.replace('_n65536', '_cluster'), cluster
        kernels[kname] = dict(
            route='cuda', source=source, replaces=f'lattisense_tpu/ops/{line}',
            replaces_function=fn, path=None, counted_as=counted,
            **hold_ntt(kname, [(ring, (37,))], kernel, plain, work, parts))
    torch.cuda.empty_cache()

    phase_done('paths_n32768')

    # 9b. the n = 2^16 repairs, each against its plain twin: B1-r4/perm on
    # the same (37, 12, n) stack (B1's cluster kernel; the perm entries add
    # their transpose pass), B2 and B4 on a custom 31-bit BFV chain (the
    # route around B1's cluster kernel), B3's cluster route at the shapes of
    # create_tpu_btp_param() (the top level and level 9, both outputs) and
    # create_tpu_param(65536) (the top level), batch 2 each
    wide_parts = {'cluster': 'cluster_kernel', 'perm': 'perm_kernel'}
    for kname, (kernel, plain, line, fn) in perm_twins.items():
        kernels[f'{kname}_n65536'] = dict(
            route='cuda', design="B1's cluster kernel" + (
                ', then or after it the transpose pass (perm_kernel)' if 'perm' in kname else ''),
            source='lattisense_torch/csrc/ntt32.cu + csrc/ntt_cluster.cuh',
            replaces=f'lattisense_tpu/ops/ntt_pallas32.py:{line}', replaces_function=fn,
            path=None, counted_as=kname,
            **hold_ntt(kname, [(r32, (37,))], kernel, plain, ntt_work, wide_parts))
    chain16 = gen_ntt_primes(N64K, 31, 24)
    bz16 = BfvEngine(BfvParams.create_custom(N64K, 65537, chain16[:22], chain16[22:],
                                             word_bits=32), dev).behz(21)
    L16, T16 = len(bz16.ring_q.moduli), len(bz16.ring_aux.moduli)
    x = card_residues(bz16.ring_q.moduli, (4, 4), N64K)
    kernels['behz_prep32_n65536'] = dict(
        route='cuda', source='lattisense_torch/csrc/behz32.cu + csrc/ntt32.cu',
        design="the extension into int64 aux rows, then B1's cluster kernel forward with the "
               'to-Montgomery epilogue over q and over aux',
        replaces='lattisense_tpu/ops/behz_pallas32.py:55',
        replaces_function='behz_prep32 (_k1_kernel)', path=None, counted_as='behz_prep32',
        shapes=[[list(x.shape), L16, T16]],
        **hold(lambda: list(behz_cuda.behz_prep32(x, bz16)),
               lambda: list(behz_cuda.behz_prep_plain(x, bz16)),
               [behz_work(16, L16, T16, N64K)]))
    dq = card_residues(bz16.ring_q.moduli, (4, 3), N64K)
    da = card_residues(bz16.ring_aux.moduli, (4, 3), N64K)
    kernels['behz_finish32_n65536'] = dict(
        route='cuda', source='lattisense_torch/csrc/behz32.cu + csrc/ntt32.cu',
        design="B1's cluster kernel inverse (from-Montgomery folded into n^-1) over q and "
               'over aux, then the scale-back from the int64 rows',
        replaces='lattisense_tpu/ops/behz_pallas32.py:368',
        replaces_function='behz_finish32 (_k3_kernel)', path=None, counted_as='behz_finish32',
        shapes=[[list(dq.shape), list(da.shape)]],
        **hold(lambda: [behz_cuda.behz_finish32(dq, da, bz16)],
               lambda: [behz_cuda.behz_finish_plain(dq, da, bz16)],
               [finish_work(12, L16, T16, N64K)]))
    del x, dq, da, bz16
    ksw16, ksw16_shapes, ksw16_work = [], [], []
    for prm, levels in ((CkksParams.create_tpu_btp_param(N64K), (47, 9)),
                        (CkksParams.create_tpu_param(N64K), (43,))):
        q16, p16 = tuple(prm.q), tuple(prm.p)
        sw16 = KeySwitcher(q16, p16, N64K, dev, 32)
        beta16 = (len(q16) + len(p16) - 1) // len(p16)
        key16 = KeySwitchKey(key_q=card_residues(q16, (beta16, 2), N64K),
                             key_p=card_residues(p16, (beta16, 2), N64K))
        for lv in levels:
            x16 = card_residues(q16[:lv + 1], (2,), N64K)
            for out_ntt in ((False, True) if len(levels) > 1 else (False,)):
                ksw16.append((x16, key16, sw16, lv, out_ntt))
                ksw16_shapes.append({'x': list(x16.shape), 'level': lv, 'alpha': len(p16),
                                     'beta': sw16.beta(lv), 'T': lv + 1 + len(p16),
                                     'output_ntt': out_ntt})
                ksw16_work.append(ksw_work(2, lv + 1, len(p16), sw16.beta(lv), N64K,
                                           output_ntt=out_ntt))
    kernels['ksw_switch32_n65536'] = dict(
        route='cuda', source='lattisense_torch/csrc/ksw32.cu + csrc/ntt_cluster.cuh',
        design=ksw_cuda.switch_route(N64K), cluster=clusters['ksw32_cluster_n65536'],
        replaces='lattisense_tpu/ops/ksw_pallas32.py:207',
        replaces_function='ksw_switch32 (_ksw_kernel)', path='btp_w32_path',
        counted_as='ksw_switch32', shapes=ksw16_shapes,
        **hold(lambda: [e for c in ksw16 for e in ksw_cuda.ksw_switch32(*c)],
               lambda: [e for c in ksw16 for e in c[2].switch_plain(c[0], c[1], c[3], c[4])],
               ksw16_work))
    del ksw16, key16, x16
    torch.cuda.empty_cache()
    phase_done('repairs_n65536')

    # ---- 11. CKKS ----------------------------------------------------------
    # two contexts, made once: the u64 chain and the composite 2^60 chain on
    # the 31-bit primes of create_tpu_param(16384) (two primes a level)
    params_c64, params_c32 = CkksParams.create(N), ckks_composite_params(N)
    t1 = time.perf_counter()
    ctx_c64 = CkksContext.create_random_context(params_c64, seed=SEED, device=dev)
    keygen_c64_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    ctx_c32 = CkksContext.create_random_context(params_c32, seed=SEED, device=dev)
    keygen_c32_s = time.perf_counter() - t1
    e64, e32 = ctx_c64.engine, ctx_c32.engine
    sw_c64, sw_c32 = e64.switcher, e32.switcher
    alpha_c64, beta_c64 = sw_c64.alpha, sw_c64.beta(LEVEL_C64)
    alpha_c32, beta_c32 = sw_c32.alpha, sw_c32.beta(LEVEL_C32)
    rows = {'rows': 'ntt_kernel'}
    # B1 at ckks_w32_path's shapes: forward at B3's output NTT (2 components
    # over q_11) and at each rescale's NTT (over q_10, then q_9); inverse on
    # c2 and at each rescale (over q_11, then q_10)
    q11, q10, q9 = (e32.ring(LEVEL_C32 - k) for k in range(3))
    kernels['ntt32_fwd_ckks'] = dict(
        route='cuda', source='lattisense_torch/csrc/ntt32.cu',
        replaces='lattisense_tpu/ops/ntt_pallas32.py:101',
        replaces_function='ntt_fused32 (_fwd_kernel)', path='ckks_w32_path',
        counted_as='ntt32_fwd',
        **hold_ntt('ntt32_fwd_ckks', [(q11, (BATCH, 2)), (q10, (BATCH, 2)), (q9, (BATCH, 2))],
                   ntt_cuda.ntt32_fwd, ntt_cuda.ntt_plain, ntt_work, rows))
    kernels['ntt32_inv_ckks'] = dict(
        route='cuda', source='lattisense_torch/csrc/ntt32.cu',
        replaces='lattisense_tpu/ops/ntt_pallas32.py:173',
        replaces_function='intt_fused32 (_inv_kernel)', path='ckks_w32_path',
        counted_as='ntt32_inv',
        **hold_ntt('ntt32_inv_ckks', [(q11, (BATCH,)), (q11, (BATCH, 2)), (q10, (BATCH, 2))],
                   ntt_cuda.ntt32_inv, ntt_cuda.intt_plain, ntt_work, rows))
    # B3 with an NTT-domain output: the relinearization of (B, 11, n) at level 10
    x = card_residues(q11.moduli, (BATCH,), N)
    kernels['ksw_switch32_ckks'] = dict(
        route='cuda', source='lattisense_torch/csrc/ksw32.cu', design=ksw_cuda.switch_route(N),
        replaces='lattisense_tpu/ops/ksw_pallas32.py:207',
        replaces_function='ksw_switch32 (_ksw_kernel), output_ntt=True', path='ckks_w32_path',
        counted_as='ksw_switch32',
        shapes=[{'x': list(x.shape), 'level': LEVEL_C32, 'alpha': alpha_c32, 'beta': beta_c32,
                 'T': LEVEL_C32 + 1 + alpha_c32, 'output_ntt': True}],
        **hold(lambda: list(ksw_cuda.ksw_switch32(x, ctx_c32.rlk, sw_c32, LEVEL_C32, True)),
               lambda: list(sw_c32.switch_plain(x, ctx_c32.rlk, LEVEL_C32, True)),
               [ksw_work(BATCH, LEVEL_C32 + 1, alpha_c32, beta_c32, N, output_ntt=True)]))
    del x
    # B5, B6 and B7 at ckks_path's shapes: forward on the β digits over
    # q_4 ∪ P, the switch's output over q_4 and the rescale's over q_3;
    # inverse on c2, the 2 key components over q_4 ∪ P and the rescale's
    # input; RoundDivP's P → Q conversion, the mod-up, the inner product
    q4, q3, qp_c64 = e64.ring(LEVEL_C64), e64.ring(LEVEL_C64 - 1), sw_c64.ring_qp(LEVEL_C64)
    T_c64 = LEVEL_C64 + 1 + alpha_c64
    kernels['ntt64_fwd_ckks'] = dict(
        route='cuda', source='lattisense_torch/csrc/ntt64.cu',
        replaces='lattisense_tpu/ops/ntt_pallas64f.py:48',
        replaces_function='ntt_fused64 (_fwd_kernel)', path='ckks_path', counted_as='ntt64_fwd',
        **hold_ntt('ntt64_fwd_ckks', [(qp_c64, (BATCH, beta_c64)), (q4, (BATCH, 2)),
                                      (q3, (BATCH, 2))],
                   ntt64_cuda.ntt64_fwd, ntt64_cuda.ntt64_plain, fwd64, rows))
    kernels['ntt64_inv_ckks'] = dict(
        route='cuda', source='lattisense_torch/csrc/ntt64.cu',
        replaces='lattisense_tpu/ops/ntt_pallas64f.py:98',
        replaces_function='intt_fused64 (_inv_kernel)', path='ckks_path', counted_as='ntt64_inv',
        **hold_ntt('ntt64_inv_ckks', [(q4, (BATCH,)), (qp_c64, (BATCH, 2)), (q4, (BATCH, 2))],
                   ntt64_cuda.ntt64_inv, ntt64_cuda.intt64_plain, inv64, rows))
    pre_c64 = sw_c64._level_pre(LEVEL_C64)
    rdp_c64 = pre_c64[5].conv
    y = rdp_c64.decompose(card_residues(rdp_c64.src, (BATCH, 2), N))
    kernels['bconv64_convert_ckks'] = dict(
        route='cuda', source='lattisense_torch/csrc/bconv64.cu',
        replaces='lattisense_tpu/ops/bconv_pallas.py:57',
        replaces_function='bconv_convert_fused (_bconv_kernel): RoundDivP P -> Q',
        path='ckks_path', counted_as='bconv64_convert', shapes=[list(y.shape)],
        instance=bconv_cuda.instance(alpha_c64, LEVEL_C64 + 1, max(rdp_c64.src) - 1),
        imad_bound_ms=imad_bound_ms([(b6_imad(alpha_c64, LEVEL_C64 + 1, bconv_cuda.instance(
            alpha_c64, LEVEL_C64 + 1, max(rdp_c64.src) - 1) == 'specific'),
            y.numel() * (LEVEL_C64 + 1))]),
        **hold(lambda: [bconv_cuda.bconv64_convert(y, rdp_c64)],
               lambda: [bconv_cuda.bconv64_plain(y, rdp_c64.qhat_dst_mont, rdp_c64.dst_q,
                                                 rdp_c64.dst_pinv)],
               [bconv64_work(BATCH * 2, alpha_c64, LEVEL_C64 + 1, N)]))
    y = card_residues(params_c64.q[:LEVEL_C64 + 1], (BATCH,), N).reshape(
        BATCH, beta_c64, alpha_c64, N)
    inst = bconv_cuda.instance(alpha_c64, T_c64, bconv_cuda.WORD_GUARD)
    kernels['bconv64_raw_ckks'] = dict(
        route='cuda', source='lattisense_torch/csrc/bconv64.cu',
        replaces='lattisense_tpu/ops/bconv_pallas.py:57',
        replaces_function='bconv_raw_fused (_bconv_kernel), all beta digits per launch',
        path='ckks_path', counted_as='bconv64_raw', shapes=[list(y.shape)], instance=inst,
        imad_bound_ms=imad_bound_ms([(b6_imad(alpha_c64, T_c64, inst == 'specific'),
                                      y.numel() * T_c64)]),
        **hold(lambda: [bconv_cuda.bconv64_raw(y, pre_c64[4], qp_c64.q, qp_c64.pinv)],
               lambda: [bconv_cuda.bconv64_plain(y, pre_c64[4], qp_c64.q, qp_c64.pinv)],
               [bconv64_work(BATCH * beta_c64, alpha_c64, T_c64, N)]))
    d = card_residues(qp_c64.moduli, (BATCH, beta_c64), N)
    kernels['ksw_inner64_ckks'] = dict(
        route='cuda', source='lattisense_torch/csrc/ksw64.cu',
        replaces='lattisense_tpu/ops/ksw_pallas.py:29',
        replaces_function='ksw_inner_fused (_ksw_kernel)', path='ckks_path',
        counted_as='ksw_inner64', shapes=[list(d.shape)],
        imad_bound_ms=imad_bound_ms([(b7_imad(beta_c64), BATCH * 2 * T_c64 * N * beta_c64)]),
        **hold(lambda: [ksw64_cuda.ksw_inner64(d, ctx_c64.rlk, LEVEL_C64, qp_c64)],
               lambda: [ksw64_cuda.ksw_inner64_plain(d, ctx_c64.rlk, LEVEL_C64, qp_c64)],
               [ksw64_work(BATCH, beta_c64, T_c64, N)]))
    del y, d
    torch.cuda.empty_cache()

    def ckks_judge(c, want):
        """Elements 0 and BATCH - 1 of a CKKS path decode within CKKS_TOL of
        ``want(i)``, their float64 slots."""
        def judge(out, out_cpu):
            got, err = {}, {}
            for i in (0, BATCH - 1):
                got[i] = c.decrypt_decode(Ciphertext(data=out[i], level=out_cpu.level,
                                                     is_ntt=True, scale=out_cpu.scale))
                err[i] = float(np.abs(got[i] - want(i)).max())
            prec = get_precision_stats(want(0), got[0]).mean_precision
            return max(err.values()) < CKKS_TOL, {
                'out_level': out_cpu.level, 'out_scale': out_cpu.scale,
                'max_abs_err_element0': err[0], 'max_abs_err_last': err[BATCH - 1],
                'mean_log2_precision_element0': {'real': float(prec.real),
                                                 'imag': float(prec.imag),
                                                 'l2': float(prec.l2)}}
        return judge

    def complex_slots(count, slots):
        return rng.uniform(-1, 1, (count, slots)) + 1j * rng.uniform(-1, 1, (count, slots))

    ckks_paths = ['ckks_path', 'ckks_w32_path', 'ckks_rotate_path', 'ckks_task_mix_path',
                  'ckks_task_mix64_path']
    c64_kernels = ['ntt64_fwd', 'ntt64_inv', 'bconv64_convert', 'bconv64_raw', 'ksw_inner64']
    c32_kernels = ['ntt32_fwd', 'ntt32_inv', 'ksw_switch32']
    no_c32 = ([k for k in w32_kernels if k not in c32_kernels] + u64_kernel_counts + wide_ntts)
    msgs_c = complex_slots(2 * BATCH, params_c64.slots)
    ckks_res = run_path(
        'ckks_path', ctx_c64, CkksEngine(params_c64, 'cpu'), LEVEL_C64, ckks_mult_relin_rescale,
        2, key_tree(ctx_c64), {'rlk': cpu_key(ctx_c64.rlk)}, msgs_c, None, c64_kernels,
        w32_kernels + wide_ntts,
        {'op': 'mult_relin_rescale', 'params': 'CkksParams.create(16384)', 'word_bits': 64,
         'scale': params_c64.scale, 'alpha': alpha_c64, 'beta': beta_c64,
         'keygen_s': keygen_c64_s},
        judge=ckks_judge(ctx_c64, lambda i, m=msgs_c: m[i] * m[BATCH + i]))
    path_launches['ckks_path'] = ckks_res['launches']
    # what the coefficient view's CKKS run (19.) loads
    mesh_paths.save(mesh_dir, 'ctxc64', mesh_paths.save_context(ctx_c64))
    mesh_paths.save(mesh_dir, 'ckks', {'a': ckks_res['args'][0].cpu(),
                                       'b': ckks_res['args'][1].cpu(),
                                       'out': ckks_res['out'].cpu(), 'scale': params_c64.scale})
    single_ms['ckks_path'] = ckks_res['ms_per_step']
    del ckks_res
    msgs_c = complex_slots(2 * BATCH, params_c32.slots)
    path_launches['ckks_w32_path'] = run_path(
        'ckks_w32_path', ctx_c32, CkksEngine(params_c32, 'cpu'), LEVEL_C32,
        ckks_mult_relin_rescale2, 2, key_tree(ctx_c32), {'rlk': cpu_key(ctx_c32.rlk)}, msgs_c,
        None, c32_kernels, no_c32,
        {'op': 'mult_relin_rescale2', 'params': 'CkksParams.create_custom(16384, '
         'create_tpu_param(16384) primes, scale=2**60, word_bits=32)', 'word_bits': 32,
         'scale': params_c32.scale, 'alpha': alpha_c32, 'beta': beta_c32,
         'keygen_s': keygen_c32_s},
        judge=ckks_judge(ctx_c32, lambda i, m=msgs_c: m[i] * m[BATCH + i]))['launches']
    t1 = time.perf_counter()
    ctx_c32.gen_galois_keys_for_elements([elt])
    galois_keygen_c32_s = time.perf_counter() - t1
    rkeys_c = key_tree(ctx_c32, galois_elts=[elt])
    path_launches['ckks_rotate_path'] = run_path(
        'ckks_rotate_path', ctx_c32, CkksEngine(params_c32, 'cpu'), LEVEL_C32,
        make_rotate_step(elt), 1, rkeys_c, {'glk': {elt: cpu_key(rkeys_c['glk'][elt])}},
        msgs_c[:BATCH], None, c32_kernels, no_c32,
        {'op': 'rotate', 'step': 1, 'galois_elt': elt, 'word_bits': 32,
         'galois_keygen_s': galois_keygen_c32_s},
        judge=ckks_judge(ctx_c32, lambda i, m=msgs_c: np.roll(m[i], -1)))['launches']
    del msgs_c, rkeys_c

    def run_ckks_mix(label, c, level, must_launch, must_not_launch, name):
        """The CKKS op-mix task on context c at ``level`` at the task's scale:
        every output of the eager run equals the port's CPU run bit for bit
        (data, level and scale) and decodes within CKKS_TOL; then a second
        set of input scales (1.5 times the first) through the same task objects
        captures a second graph, whose replay equals eager at those scales
        and decodes within CKKS_TOL; the line's entries."""
        with open(os.path.join(tasks.task_dir(name), 'task_signature.json')) as f:
            c.gen_galois_keys_for_elements([int(e) for e in json.load(f)['key']['glk']])
        with open(os.path.join(tasks.task_dir(name), 'mega_ag.json')) as f:
            scale = float(json.load(f)['parameter']['scale'])
        msgs = tasks.ckks_mix_messages(c.params.slots, SEED)
        expected = tasks.ckks_mix_expected(msgs)

        def worst(out):
            errs = [float(np.abs(c.decrypt_decode(v) - m).max()) for k in tasks.CKKS_MIX_OUTPUTS
                    for v, m in zip(out[k] if isinstance(out[k], list) else [out[k]],
                                    expected[k] if isinstance(expected[k], list)
                                    else [expected[k]])]
            return max(errs)
        online, offline = tasks.ckks_mix_arguments(c, level, msgs, scale)
        out_e, entry, eager, jit = run_task(label, c, name, online, offline, must_launch,
                                            must_not_launch)
        twin = cpu_context(c)
        cpu_task = FheTask(tasks.task_dir(name), mode='eager', device='cpu')
        cpu_task.preload(twin, {k: on_cpu(v) for k, v in offline.items()})
        t1 = time.perf_counter()
        out_c, _ = cpu_task.run(twin, {k: on_cpu(v) for k, v in online.items()})
        cpu_s = time.perf_counter() - t1
        bit_exact = outputs_equal(torch, out_e, out_c)
        err = worst(out_e)
        # the second set of scales: its own graph
        online2, offline2 = tasks.ckks_mix_arguments(c, level, msgs, scale * 1.5)
        for t in (eager, jit):
            t.preload(c, offline2)
        out_j2, _ = jit.run(c, online2)
        out_e2, _ = eager.run(c, online2)
        graphs = len(jit._graphs)
        second_equal = outputs_equal(torch, out_j2, out_e2)
        err2 = worst(out_j2)
        print(json.dumps({label: {
            **entry, 'n': c.params.n, 'level': level, 'word_bits': c.params.word_bits,
            'scale': scale, 'outputs': len(flat_outputs(out_e)),
            'correct': err < CKKS_TOL and err2 < CKKS_TOL, 'max_abs_err': err,
            'bit_exact_vs_cpu': bit_exact, 'cpu_run_s': cpu_s,
            'second_scales': {'scale': scale * 1.5, 'graphs_captured': graphs,
                              'replay_equals_eager': second_equal, 'max_abs_err': err2}}}),
              flush=True)
        if not (err < CKKS_TOL and err2 < CKKS_TOL and bit_exact and second_equal
                and graphs == 2):
            raise AssertionError(f'{label}: max_abs_err {err} / {err2}, bit_exact_vs_cpu='
                                 f'{bit_exact}, second scales replay_equals_eager='
                                 f'{second_equal} with {graphs} graphs')
        return entry['launches_eager']

    path_launches['ckks_task_mix_path'] = run_ckks_mix(
        'ckks_task_mix_path', ctx_c32, LEVEL_C32, c32_kernels, no_c32, tasks.CKKS_MIX_W32)
    del ctx_c32
    torch.cuda.empty_cache()
    path_launches['ckks_task_mix64_path'] = run_ckks_mix(
        'ckks_task_mix64_path', ctx_c64, LEVEL_C64, c64_kernels, w32_kernels + wide_ntts,
        tasks.CKKS_MIX_U64)
    del ctx_c64
    torch.cuda.empty_cache()

    phase_done('ckks')

    # ---- 12. CKKS bootstrapping ---------------------------------------------
    # the JAX package's three bootstrap runs (schemes/bootstrap_params.py
    # reference_run), one context at a time, freed before the next
    btp_paths = ['btp_toy_path', 'btp_full_path', 'btp_w32_path']
    path_ms = {}

    def run_bootstrap(label, name, must_launch, must_not_launch, holds, cpu_segments=(),
                      task=None, save_as=None):
        """Keygen, a warm-up bootstrap (the host encoding of the transforms'
        diagonals, timed again alone as ``encode_s``), one bootstrap between
        a reset and a read of every count,
        CUDA-event ms a bootstrap (3 timed), the busy ms and idle share over
        two bootstraps in one profiler window, each segment's ms; the
        kernels of ``holds(ctx)`` against their twins at the path's shapes;
        the segments of ``cpu_segments`` on the CPU twin from the card's own
        input, bit for bit; the task ``task`` eager, replayed and
        partitioned against ``ctx.bootstrap``; with ``save_as``, the input
        and output for the sharded views (19.). Prints the path's line."""
        ctx, run, keygen_s = bootstrap_context(name, dev)
        eng = ctx.engine
        kbytes = key_bytes(ctx)
        msg, ct = bootstrap_input(ctx, run)
        t1 = time.perf_counter()
        want = ctx.bootstrap(ct)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t1
        # the host encoding of the transforms' diagonals, which the first
        # bootstrap did: each (level, scale) it encoded, encoded once more
        btp = eng.bootstrapper
        t1 = time.perf_counter()
        for lt in btp.cts + [btp.cts_last_re, btp.cts_last_im] + btp.stc:
            for _lv, sc in list(lt._plain_cache):
                for v in lt.raw.values():
                    eng.encode_mul(v, lt.level, sc)
        torch.cuda.synchronize()
        encode_s = time.perf_counter() - t1
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        out = ctx.bootstrap(ct)
        torch.cuda.synchronize()
        launches = read_counts()
        peak_mem = torch.cuda.max_memory_allocated()
        missing = [k for k in must_launch if launches.get(k, 0) == 0]
        if missing:
            raise AssertionError(f'the {label} launched no {missing}')
        stray = {k: launches[k] for k in must_not_launch if launches.get(k, 0)}
        if stray:
            raise AssertionError(f'the {label} launched {stray}')
        if not torch.equal(out.data, want.data):
            raise AssertionError(f'{label}: two bootstraps of one input differ')
        if save_as:
            mesh_paths.save(mesh_dir, save_as, {'a': ct.data.cpu(), 'level': ct.level,
                                                'scale': ct.scale, 'out': out.data.cpu()})
        btp_ms = time_ms(torch, lambda: ctx.bootstrap(ct), 3, warmup=0)
        t1 = time.perf_counter()
        busy, top = busy_and_top(torch, lambda: ctx.bootstrap(ct), BTP_PROFILE_REPS, top=12,
                                 host_ops=False)
        profile_s = time.perf_counter() - t1
        seg_ms, seg_out, kept = bootstrap_segments(ctx, ct, keep=cpu_segments)
        if not torch.equal(seg_out.data, out.data):
            raise AssertionError(f'{label}: the segment walk differs from ctx.bootstrap')
        err = float(np.abs(ctx.decrypt_decode(out).real - msg).max())
        correct = err < run['max_err'] and out.level >= run['min_level']
        line = {'profile': name, 'n': ctx.params.n, 'word_bits': ctx.params.word_bits,
                'q_limbs': len(ctx.params.q), 'p_limbs': len(ctx.params.p),
                'slots': ctx.params.slots, 'h': run['h'], 'seed': run['seed'],
                'config': dataclasses.asdict(run['config']), 'in_level': run['level'],
                'in_scale': run['scale'], 'out_level': out.level, 'out_scale': out.scale,
                'max_abs_err': err, 'bounds': {'max_abs_err': run['max_err'],
                                               'min_level': run['min_level']},
                'correct': correct, 'ms_per_bootstrap': btp_ms, 'busy_ms': busy,
                'idle_share': idle_share(busy, btp_ms), 'top_kernels': top,
                'profile_window_s': profile_s, 'segments_ms': seg_ms,
                'launches_per_bootstrap': launches, 'galois_keys': len(ctx.glk.keys),
                'key_bytes': kbytes, 'keygen_s': keygen_s, 'encode_s': encode_s,
                'first_bootstrap_s': first_s,
                'peak_mem_bytes': peak_mem, 'bootstrap_extra_peak_bytes': peak_mem - base_mem,
                'gpu': name_gpu, 'power_limit': power}
        for kname, entry in holds(ctx).items():
            kernels[kname] = entry
        if cpu_segments:
            # the CPU twin: the card context's keys on the CPU
            twin = type(ctx).from_arrays(ctx.params, ctx.sk.coeffs, ctx.pk.data.cpu(),
                                         ctx.rlk.key_q.cpu(), ctx.rlk.key_p.cpu(), device='cpu')
            for e, k in ctx.glk.keys.items():
                twin.add_galois_key_arrays(e, k.key_q.cpu(), k.key_p.cpu())
            twin.swk = {k: dataclasses.replace(v, key_q=v.key_q.cpu(), key_p=v.key_p.cpu())
                        for k, v in ctx.swk.items()}
            twin.create_bootstrapper(run['config'])
            segs = dict(twin.engine.bootstrapper.segments(
                ct.scale, twin.swk.get('swk_dts'), twin.swk.get('swk_std')))
            t1 = time.perf_counter()
            twin_equal = {}
            for sname in cpu_segments:
                ins, outs = kept[sname]
                got = segs[sname](tuple(on_cpu(c) for c in ins), twin.rlk, twin.glk.keys)
                twin_equal[sname] = all(
                    torch.equal(g.data, o.data.cpu()) and (g.level, g.scale) == (o.level, o.scale)
                    for g, o in zip(got, outs)) and len(got) == len(outs)
            line['segments_vs_cpu_twin'] = twin_equal
            line['cpu_twin_s'] = time.perf_counter() - t1
            correct = correct and all(twin_equal.values())
            del twin, segs
        if task is not None:
            d = tasks.task_dir(task)
            with open(os.path.join(d, 'task_signature.json')) as f:
                ctx.gen_galois_keys_for_elements([int(e) for e in json.load(f)['key']['glk']])
            runs = {}
            for mode in ('eager', 'jit', 'partitioned'):
                t = FheTask(d, mode=mode)
                torch.cuda.synchronize()
                before = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                t1 = time.perf_counter()
                t.compile(ctx, {'x': ct})
                if mode == 'eager':
                    t.run(ctx, {'x': ct})
                capture_s = time.perf_counter() - t1
                got, _ = t.run(ctx, {'x': ct})
                extra = torch.cuda.max_memory_allocated() - before
                same_out = (torch.equal(got['z'].data, out.data)
                            and (got['z'].level, got['z'].scale) == (out.level, out.scale))
                ms = sum(t.run(ctx, {'x': ct})[1] for _ in range(3)) / 3 / 1e6
                t1 = time.perf_counter()
                tb = busy_and_top(torch, lambda t=t: t.run(ctx, {'x': ct}), BTP_PROFILE_REPS,
                                  host_ops=False)[0]
                profile_s = time.perf_counter() - t1
                runs[mode] = {'equals_ctx_bootstrap': same_out, 'ms_per_run': ms, 'busy_ms': tb,
                              'idle_share': idle_share(tb, ms), 'warmup_or_capture_s': capture_s,
                              'extra_peak_bytes': extra, 'profile_window_s': profile_s,
                              'graphs': len(t._graphs), 'plan_steps': len(t.plan)}
                correct = correct and same_out
                del t
                torch.cuda.empty_cache()
            line['task'] = {'name': task, **runs}
        print(json.dumps({label: line}), flush=True)
        phase_done(label)
        if not correct:
            raise AssertionError(f'{label}: max_abs_err {err} (bound {run["max_err"]}), level '
                                 f'{out.level} (at least {run["min_level"]}), '
                                 f'{line.get("segments_vs_cpu_twin")}, '
                                 f'{ {m: r["equals_ctx_bootstrap"] for m, r in line.get("task", {}).items() if m != "name"} }')
        path_launches[label] = launches
        path_ms[label] = btp_ms
        del ctx, want, out, seg_out, kept
        torch.cuda.empty_cache()

    def btp64_holds(suffix, path, cluster_n):
        """B5, B6 and B7 at a u64 bootstrap's key-switch shapes at the top
        level: the mod-up of β = 5 digits of 5 limbs to 30 rows, their
        forward NTT, the inner product, the inverse NTT of the two
        components, RoundDivP's P → Q conversion; batch 2 (the EvalMod
        pair)."""
        def holds(ctx):
            eng = ctx.engine
            lv = ctx.params.max_level
            sw = eng.switcher
            rq = sw.ring_qp(lv)
            al, be = sw.alpha, sw.beta(lv)
            nn = ctx.params.n
            pre = sw._level_pre(lv)
            rdp = pre[5].conv
            ntt_parts = {'cluster': 'cluster_kernel'} if cluster_n else {'rows': 'ntt_kernel'}
            src = ('lattisense_torch/csrc/ntt_cluster.cuh + csrc/ntt64.cu' if cluster_n
                   else 'lattisense_torch/csrc/ntt64.cu')
            out = {}
            for kname, kernel, plain, work, lead in (
                    ('ntt64_fwd', ntt64_cuda.ntt64_fwd, ntt64_cuda.ntt64_plain, fwd64, (2, be)),
                    ('ntt64_inv', ntt64_cuda.ntt64_inv, ntt64_cuda.intt64_plain, inv64, (2, 2))):
                out[f'{kname}_{suffix}'] = dict(
                    route='cuda', source=src,
                    replaces=('lattisense_tpu/ops/ntt_pallas.py:134' if cluster_n else
                              f'lattisense_tpu/ops/ntt_pallas64f.py:{48 if "fwd" in kname else 98}'),
                    replaces_function=kname, path=path,
                    counted_as=kname + ('_cluster' if cluster_n else ''),
                    **hold_ntt(f'{kname}_{suffix}', [(rq, lead)], kernel, plain, work, ntt_parts))
            y = rdp.decompose(card_residues(rdp.src, (2, 2), nn))
            out[f'bconv64_convert_{suffix}'] = dict(
                route='cuda', source='lattisense_torch/csrc/bconv64.cu',
                replaces='lattisense_tpu/ops/bconv_pallas.py:57',
                replaces_function='bconv_convert_fused (_bconv_kernel): RoundDivP P -> Q',
                path=path, counted_as='bconv64_convert', shapes=[list(y.shape)],
                instance=bconv_cuda.instance(al, lv + 1, max(rdp.src) - 1),
                **hold(lambda: [bconv_cuda.bconv64_convert(y, rdp)],
                       lambda: [bconv_cuda.bconv64_plain(y, rdp.qhat_dst_mont, rdp.dst_q,
                                                         rdp.dst_pinv)],
                       [bconv64_work(4, al, lv + 1, nn)]))
            ym = card_residues(ctx.params.q[:lv + 1], (2,), nn).reshape(2, be, al, nn)
            out[f'bconv64_raw_{suffix}'] = dict(
                route='cuda', source='lattisense_torch/csrc/bconv64.cu',
                replaces='lattisense_tpu/ops/bconv_pallas.py:57',
                replaces_function='bconv_raw_fused (_bconv_kernel), all beta digits per launch',
                path=path, counted_as='bconv64_raw', shapes=[list(ym.shape)],
                instance=bconv_cuda.instance(al, lv + 1 + al, bconv_cuda.WORD_GUARD),
                **hold(lambda: [bconv_cuda.bconv64_raw(ym, pre[4], rq.q, rq.pinv)],
                       lambda: [bconv_cuda.bconv64_plain(ym, pre[4], rq.q, rq.pinv)],
                       [bconv64_work(2 * be, al, lv + 1 + al, nn)]))
            dg = card_residues(rq.moduli, (2, be), nn)
            out[f'ksw_inner64_{suffix}'] = dict(
                route='cuda', source='lattisense_torch/csrc/ksw64.cu',
                replaces='lattisense_tpu/ops/ksw_pallas.py:29',
                replaces_function='ksw_inner_fused (_ksw_kernel)', path=path,
                counted_as='ksw_inner64', shapes=[list(dg.shape)],
                **hold(lambda: [ksw64_cuda.ksw_inner64(dg, ctx.rlk, lv, rq)],
                       lambda: [ksw64_cuda.ksw_inner64_plain(dg, ctx.rlk, lv, rq)],
                       [ksw64_work(2, be, lv + 1 + al, nn)]))
            return out
        return holds

    def btp32_holds(ctx):
        """B1's cluster kernel at the w32 bootstrap's key-switch shapes, top
        level, batch 2: the inverse of the (2, 48, n)
        component switched, the forward of the (2, 2, 48, n) output over
        Q."""
        lv = ctx.params.max_level
        rq = get_rns_ring(tuple(ctx.params.q[:lv + 1]), ctx.params.n, dev)
        return {f'{k}_btp_w32': dict(
            route='cuda', source='lattisense_torch/csrc/ntt_cluster.cuh + csrc/ntt32.cu',
            replaces=f'lattisense_tpu/ops/ntt_pallas32.py:{line}', replaces_function=fn,
            path='btp_w32_path', counted_as=f'{k}_cluster',
            **hold_ntt(f'{k}_btp_w32', [(rq, lead)], kern, plain, ntt_work,
                       {'cluster': 'cluster_kernel'}))
            for k, kern, plain, lead, line, fn in (
                ('ntt32_fwd', ntt_cuda.ntt32_fwd, ntt_cuda.ntt_plain, (2, 2), 101,
                 'ntt_fused32 (_fwd_kernel)'),
                ('ntt32_inv', ntt_cuda.ntt32_inv, ntt_cuda.intt_plain, (2,), 173,
                 'intt_fused32 (_inv_kernel)'))}

    u64_btp = ['bconv64_convert', 'bconv64_raw', 'ksw_inner64']
    run_bootstrap('btp_toy_path', 'toy', ['ntt64_fwd', 'ntt64_inv'] + u64_btp,
                  w32_kernels + wide_ntts, btp64_holds('btp_toy', 'btp_toy_path', False),
                  cpu_segments=('raise', 'cts0', 'evalmod_da', 'stc2'),
                  task=tasks.CKKS_BOOTSTRAP_TOY, save_as='btp_toy')
    single_ms['btp_toy_path'] = path_ms['btp_toy_path']
    run_bootstrap('btp_full_path', 'full', ['ntt64_fwd_cluster', 'ntt64_inv_cluster'] + u64_btp,
                  w32_kernels + ['ntt64_fwd', 'ntt64_inv'],
                  btp64_holds('btp_full', 'btp_full_path', True))
    run_bootstrap('btp_w32_path', 'w32',
                  ['ntt32_fwd', 'ntt32_inv', 'ntt32_fwd_cluster', 'ntt32_inv_cluster',
                   'ksw_switch32'],
                  u64_kernel_counts + ['behz_prep32', 'behz_finish32'], btp32_holds)

    # ---- 19. the sharded views: worlds of ranks sharing the card over gloo,
    # each loading what 18. saved (the toy bootstrap's context from its seed)
    N_TOY = 8192
    # what each rank must and must not launch: B1 on its degree-C ring and
    # none of the fused B2/B3/B4, which hold a full-length NTT (32-bit
    # views); B5, B6 and B7 (64-bit views)
    w32_view = (['ntt32_fwd', 'ntt32_inv'],
                ['behz_prep32', 'ksw_switch32', 'behz_finish32', 'behz32_split_fwd',
                 'behz32_split_inv']
                + wide_ntts + u64_kernel_counts)
    u64_view = (['ntt64_fwd', 'ntt64_inv', 'bconv64_convert', 'bconv64_raw', 'ksw_inner64'],
                w32_kernels + wide_ntts)
    view_runs = [
        ('coeff_engine_path', 'coeff_engine', 'ctx32', 'main', (1, 1, 2), LEVEL, 'main_path',
         {'scheme': 'BFV', 'op': 'mult_relin', 'word_bits': 32}, w32_view),
        ('coeff_engine_path', 'coeff_engine', 'ctxc64', 'ckks', (1, 1, 2), LEVEL_C64,
         'ckks_path', {'scheme': 'CKKS', 'op': 'mult_relin_rescale', 'word_bits': 64},
         u64_view),
        ('mesh_task_coeff_path', 'task_eager', 'ctx32', 'main', (1, 1, 2), LEVEL, 'main_path',
         {'task': tasks.MULT_RELIN}, w32_view),
        ('mesh_task_coeff_path', 'task_jit', 'ctx32', 'main', (1, 1, 2), LEVEL, 'main_path',
         {'task': tasks.MULT_RELIN}, w32_view),
        ('coeff_btp_path', 'coeff_btp', 'btp:toy', 'btp_toy', (1, 1, 2), 0, 'btp_toy_path',
         {'profile': 'toy'}, u64_view),
        ('limb_btp_path', 'limb_btp', 'btp:toy', 'btp_toy', (1, 2, 1), 0, 'btp_toy_path',
         {'profile': 'toy'}, u64_view),
        ('mesh_task_coeff_path', 'btp_task', 'btp:toy', 'btp_toy', (1, 1, 2), 0,
         'btp_toy_path', {'task': tasks.CKKS_BOOTSTRAP_TOY}, u64_view)]

    def view_line(label, path, world, res, level, like, extra, must):
        """Print the line and hold every rank's launches to ``must`` (must,
        must not): those of the counted step, or of a captured task's
        capture, since its replays launch nothing through a wrapper."""
        toy = like == 'btp_toy_path'
        captured = res[0]['graphs'] is not None
        if captured:
            extra = {**extra, 'capture_launches_per_rank': [r['warmup_launches'] for r in res]}
        mesh_line(label, path, world, res, level, like, n=N_TOY if toy else N,
                  batch=1 if toy else BATCH,
                  extra={**extra, 'ms_per': 'bootstrap' if toy else 'step'})
        for rank, r in enumerate(res):
            require(f'{label} ({path}) rank {rank}' + (' in its capture' if captured else ''),
                    r['warmup_launches'] if captured else r['launches'], *must)

    t1 = time.perf_counter()
    with World(2, backend='gloo', device=dev, timeout_s=900) as world2:
        world_s = time.perf_counter() - t1
        for label, path, cname, dname, shape, level, like, extra, must in view_runs:
            res = world2.run(mesh_paths.rank_path, mesh_dir, path, cname, dname, shape, level,
                             VIEW_ITERS)
            view_line(label, path, 2, res, level, like, extra, must)
    t1 = time.perf_counter()
    with World(4, backend='gloo', device=dev, timeout_s=900) as world4:
        world4_s = time.perf_counter() - t1
        res = world4.run(mesh_paths.rank_path, mesh_dir, 'limb_btp', 'btp:toy', 'btp_toy',
                         (1, 2, 2), 0, VIEW_ITERS)
        view_line('limb_coeff_btp_path', 'limb_btp', 4, res, 0, 'btp_toy_path',
                  {'profile': 'toy'}, u64_view)
    print(json.dumps({'view_worlds': {'gloo_world2_start_s': world_s,
                                      'gloo_world4_start_s': world4_s}}), flush=True)

    # frontend_path: the port's frontend compiles two committed graphs
    from lattisense_torch.frontend import custom_task as fe
    t1 = time.perf_counter()
    fe_dir = tempfile.mkdtemp(prefix='lattisense_frontend_')
    p32 = BfvParams.create_tpu_param(N)
    fe.set_fhe_param(fe.BfvParam.create_custom_param(n=N, q=list(p32.q), p=list(p32.p),
                                                     t=p32.t))
    ins, outs = [], []
    for k in range(tasks.MULT_RELIN_COUNT):        # tests/test_torch_task.py build_mult_relin
        x, y = fe.BfvCiphertextNode(f'x{k}', LEVEL), fe.BfvCiphertextNode(f'y{k}', LEVEL)
        outs.append(fe.Argument(f'z{k}', fe.mult_relin(x, y, f'z{k}')))
        ins += [fe.Argument(x.id, x), fe.Argument(y.id, y)]
    fe.process_custom_task(input_args=ins, output_args=outs,
                           output_instruction_path=os.path.join(fe_dir, 'mult_relin'))
    fe.set_fhe_param(fe.CkksBtpParam.create_toy_param())
    x = fe.CkksCiphertextNode('x', 0)
    fe.process_custom_task(input_args=[fe.Argument('x', x)],
                           output_args=[fe.Argument('z', fe.bootstrap(x, 'z'))],
                           output_instruction_path=os.path.join(fe_dir, 'btp_toy'))
    compile_s = time.perf_counter() - t1
    same_dirs = {name: tasks.normalize(os.path.join(fe_dir, sub))
                 == tasks.normalize(tasks.task_dir(name))
                 for name, sub in ((tasks.MULT_RELIN, 'mult_relin'),
                                   (tasks.CKKS_BOOTSTRAP_TOY, 'btp_toy'))}
    ctx32 = mesh_paths.load(mesh_dir, 'ctx32', dev)
    main_io = mesh_paths.load(mesh_dir, 'main', dev)
    ft = FheTask(os.path.join(fe_dir, 'mult_relin'), mode='jit')
    online = tasks.mult_relin_arguments(
        [Ciphertext(data=main_io['a'][k], level=LEVEL) for k in range(BATCH)],
        [Ciphertext(data=main_io['b'][k], level=LEVEL) for k in range(BATCH)])
    ft.run(ctx32, online)
    got, _ = ft.run(ctx32, online)
    fe_ms = sum(ft.run(ctx32, online)[1] for _ in range(TASK_ITERS)) / TASK_ITERS / 1e6
    fe_equal = all(torch.equal(got[f'z{k}'].data, main_io['out'][k]) for k in range(BATCH))
    print(json.dumps({'frontend_path': {
        'graphs': list(same_dirs), 'equals_committed_after_id_mapping': same_dirs,
        'compile_s': compile_s, 'run_task': tasks.MULT_RELIN, 'mode': 'jit',
        'bit_exact_vs': 'main_path', 'bit_exact': fe_equal, 'ms_per_run': fe_ms,
        'main_path_ms_per_step': single_ms['main_path'], 'gpu': name_gpu,
        'power_limit': power}}), flush=True)
    if not (all(same_dirs.values()) and fe_equal):
        raise AssertionError(f'frontend_path: {same_dirs}, bit_exact={fe_equal}')
    del ft, online, got, ctx32, main_io
    mesh_paths._loaded.clear()
    shutil.rmtree(fe_dir, ignore_errors=True)
    shutil.rmtree(mesh_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    phase_done('views')

    # ---- 13. threshold BFV: collective keys, the batched path on them -----
    def mpc_holds(label, params, level, word, kernel_names, fwd, inv, plain_fwd, plain_inv,
                  work, source, lines):
        """The share NTTs' kernel on the card against its twin at the
        protocols' shapes: forward over Q∪P (the keys) and Q_ℓ (E2S, S2E),
        inverse over Q_ℓ."""
        qp, ql = tuple(params.q) + tuple(params.p), tuple(params.q[:level + 1])
        for name, moduli in ((f'qp_{label}', qp), (f'ql_{label}', ql)):
            rings[name] = (get_rns_ring(moduli, N, dev, word), get_rns_ring(moduli, N, 'cpu', word))
        out = {}
        for kname, kern, plain, calls, line in (
                (kernel_names[0], fwd, plain_fwd, [(f'qp_{label}', ()), (f'ql_{label}', ())],
                 lines[0]),
                (kernel_names[1], inv, plain_inv, [(f'ql_{label}', ())], lines[1])):
            out[f'{kname}_{label}'] = dict(
                route='cuda', source=source, replaces=line[0], replaces_function=line[1],
                path=label, counted_as=kname,
                **check_ntt(f'{kname}_{label}', calls, kern, plain,
                            lambda r, lb, n, k=kname: work(r, lb, n, k.endswith('inv'))))
        return out

    def run_mpc(label, params, level, ntt_kernels, step_kernels, must_not_launch, iters):
        """Three parties (seeds 100 + i) build the public, relinearization and
        Galois (rotate_col by 1) keys on the card, every share through
        serialize / deserialize, and the same protocol on a CPU copy must
        give the same keys bit for bit. Then the batched mult_relin and
        rotate_col on those keys (element 0 against the CPU plain path),
        threshold decryption of elements 0 and 31 of both outputs by E2S, S2E
        back, refresh and refresh-and-permute of element 0, each decrypting
        right under the joint secret Σ s_i. The counts are read after the key
        generation (the forward NTT of ``ntt_kernels`` must rise), after the
        step and after the threshold decryptions (both of ``ntt_kernels``).
        Prints the path's line."""
        n, t = params.n, params.t
        elt = galois_elt_col(1, n)

        def collective(device, rounds=None):
            """(parties, pk, rlk, glk); with ``rounds``, each party's share of
            each round timed (CUDA events, the host's sampling apart)."""
            parties = [mp.DBfvParty(params, seed=100 + i, sigma_smudging=SIGMA_SMUDGING,
                                    device=device) for i in range(PARTIES)]

            def exchange(name, cls, gen):
                shares = []
                for p in parties:
                    if rounds is None:
                        shares.append(gen(p))
                        continue
                    p.rng = TimedRng(p.rng)
                    share, ms = event_ms(torch, lambda p=p: gen(p))
                    t1 = time.perf_counter()
                    blob = share.serialize()
                    shares.append(cls.deserialize(blob, device=device))
                    r = rounds.setdefault(name, {'ms': [], 'sampling_ms': [], 'wire_ms': [],
                                                 'share_bytes': len(blob)})
                    r['ms'].append(ms)
                    r['sampling_ms'].append(p.rng.spent * 1e3)
                    r['wire_ms'].append((time.perf_counter() - t1) * 1e3)
                    p.rng = p.rng.rng
                return shares

            ckg = mp.CkgProtocol(params, 7, device=device)
            pk = ckg.aggregate(exchange('ckg', mp.PublicKeyShare, ckg.gen_share))
            rkg = mp.RkgProtocol(params, 11, device=device)
            agg1 = rkg.aggregate_round1(exchange('rkg1', mp.RelinKeyShareRound1,
                                                 rkg.gen_share_round1))
            rlk = rkg.aggregate_round2(exchange('rkg2', mp.RelinKeyShareRound2,
                                                lambda p: rkg.gen_share_round2(p, agg1)), agg1)
            rtg = mp.RtgProtocol(params, elt, 13, device=device)
            glk = rtg.aggregate(exchange('rtg', mp.GaloisKeyShare, rtg.gen_share))
            return parties, pk, rlk, glk

        rounds = {}
        torch.cuda.synchronize()
        reset_counts()
        t1 = time.perf_counter()
        parties, pk, rlk, glk = collective(dev, rounds)
        torch.cuda.synchronize()
        keys_s = time.perf_counter() - t1
        key_launches = read_counts()
        require(f'the {label} key generation', key_launches, ntt_kernels[:1], must_not_launch)
        t1 = time.perf_counter()
        _, pk_c, rlk_c, glk_c = collective('cpu')
        cpu_keys_s = time.perf_counter() - t1
        if not (torch.equal(pk.data.cpu(), pk_c.data) and all(
                torch.equal(g.key_q.cpu(), c.key_q) and torch.equal(g.key_p.cpu(), c.key_p)
                for g, c in ((rlk, rlk_c), (glk, glk_c)))):
            raise AssertionError(f'{label}: the collective keys differ from the CPU copy')

        ctx = BfvContext.create_empty_context(params, device=dev)
        ctx.pk, ctx.rlk, ctx.glk = pk, rlk, GaloisKeys({elt: glk})
        eng, eng_c = ctx.engine, BfvEngine(params, 'cpu')
        msgs = rng.integers(0, t, (2 * BATCH, n))
        t1 = time.perf_counter()
        cts = [ctx.encrypt(ctx.encode(m, level)) for m in msgs]
        encrypt_s = time.perf_counter() - t1
        a = torch.stack([c.data for c in cts[:BATCH]])
        b = torch.stack([c.data for c in cts[BATCH:]])
        keys = key_tree(ctx, galois_elts=[elt])
        mult = make_batched_step(eng, bfv_mult_relin, level)
        rot = make_batched_step(eng, make_rotate_step(elt), level, n_inputs=1)
        mult(a, b, keys)
        rot(a, keys)                                        # warm-up
        torch.cuda.synchronize()
        reset_counts()
        out_m, out_r = mult(a, b, keys), rot(a, keys)
        torch.cuda.synchronize()
        step_launches = read_counts()
        require(f'the {label} step', step_launches, step_kernels, must_not_launch)
        mult_ms = time_ms(torch, lambda: mult(a, b, keys), iters)
        rot_ms = time_ms(torch, lambda: rot(a, keys), iters)
        busy = busy_ms(torch, lambda: mult(a, b, keys))
        cpu_keys = {'rlk': rlk_c, 'glk': {elt: glk_c}}
        x0, y0 = (Ciphertext(data=v[:1].cpu(), level=level) for v in (a, b))
        bit_exact = (torch.equal(bfv_mult_relin(eng_c, x0, y0, cpu_keys).data[0], out_m[0].cpu())
                     and torch.equal(make_rotate_step(elt)(eng_c, x0, cpu_keys).data[0],
                                     out_r[0].cpu()))

        e2s = mp.E2sProtocol(eng, level)

        def e2s_decrypt(ct):
            """→ (residual + Σ masks mod t, the masks, the residual)."""
            out = [e2s.gen_share(p, ct) for p in parties]
            residual = e2s.aggregate(ct, [mp.DecryptionShare.deserialize(s.serialize(), device=dev)
                                          for s, _ in out])
            total = residual.astype(np.int64)
            for _, mk in out:
                total = (total + mk.astype(np.int64)) % t
            return total, [mk for _, mk in out], residual

        want = [msgs[i] * msgs[BATCH + i] % t for i in range(BATCH)]
        checks, e2s_ms, first = {}, [], None
        torch.cuda.synchronize()
        reset_counts()
        for i in (0, BATCH - 1):
            for kind, out, expect in (('mult', out_m, want[i]),
                                      ('rotate', out_r, rolled(msgs[i]))):
                res, ms = event_ms(torch,
                                   lambda: e2s_decrypt(Ciphertext(data=out[i], level=level)))
                e2s_ms.append(ms)
                checks[f'e2s_{kind}_{i}'] = bool(np.array_equal(res[0], expect))
                first = first or res
        joint = SecretKey(sum(p.sk.coeffs for p in parties))
        s2e = mp.S2eProtocol(eng, level, 17)
        ct_s2e, s2e_ms = event_ms(torch, lambda: s2e.aggregate(
            [mp.EncryptionShare.deserialize(s2e.gen_share(p, mk).serialize(), device=dev)
             for p, mk in zip(parties, first[1])], first[2]))
        checks['s2e'] = bool(np.array_equal(eng.decrypt_decode(joint, ct_s2e), want[0]))
        ct0 = Ciphertext(data=out_m[0], level=level)
        refresh_ms = {}
        for name, perm in (('refresh', None), ('refresh_permute', np.roll(np.arange(n), 5))):
            proto = mp.RefreshProtocol(eng, level, 19, permutation=perm)
            fresh, refresh_ms[name] = event_ms(torch, lambda: proto.finalize(
                ct0, [mp.RefreshShare.deserialize(proto.gen_share(p, ct0).serialize(), device=dev)
                      for p in parties]))
            checks[name] = bool(np.array_equal(eng.decrypt_decode(joint, fresh),
                                               want[0] if perm is None else want[0][perm]))
        torch.cuda.synchronize()
        decrypt_launches = read_counts()
        require(f'the {label} threshold decryption', decrypt_launches, ntt_kernels,
                must_not_launch)
        correct = all(checks.values())
        print(json.dumps({label: {
            'n': n, 'level': level, 'batch': BATCH, 'word_bits': params.word_bits,
            'parties': PARTIES, 'sigma_smudging': SIGMA_SMUDGING, 'galois_elt': elt,
            'rounds': {k: {'ms_per_party': v['ms'], 'sampling_ms_per_party': v['sampling_ms'],
                           'wire_ms_per_party': v['wire_ms'], 'share_bytes': v['share_bytes']}
                       for k, v in rounds.items()},
            'keys_s': keys_s, 'cpu_copy_keys_s': cpu_keys_s, 'keys_equal_cpu_copy': True,
            'encrypt_s': encrypt_s, 'mult_relin_ms_per_step': mult_ms,
            'mult_relin_ops_per_s': BATCH * 1e3 / mult_ms, 'rotate_ms_per_step': rot_ms,
            'busy_ms': busy, 'idle_share': idle_share(busy, mult_ms),
            'e2s_ms': e2s_ms, 's2e_ms': s2e_ms, 'refresh_ms': refresh_ms,
            'checks': checks, 'correct': correct, 'bit_exact_vs_plain': bit_exact,
            'launches_keys': key_launches, 'launches_step': step_launches,
            'launches_decrypt': decrypt_launches, 'gpu': name_gpu, 'power_limit': power}}),
              flush=True)
        if not (correct and bit_exact):
            raise AssertionError(f'{label} correct={correct} {checks} '
                                 f'bit_exact_vs_plain={bit_exact}')
        return {'ctx': ctx, 'a': a, 'b': b, 'out': out_m, 'glk': glk, 'elt': elt, 'msgs': msgs,
                'joint': joint,
                'launches': {k: sum(c.get(k, 0) for c in (key_launches, step_launches,
                                                          decrypt_launches))
                             for k in set(key_launches) | set(step_launches)}}

    mpc_paths = ['mpc_path', 'mpc64_path']
    kernels.update(mpc_holds(
        'mpc_path', params, LEVEL, 32, ('ntt32_fwd', 'ntt32_inv'), ntt_cuda.ntt32_fwd,
        ntt_cuda.ntt32_inv, ntt_cuda.ntt_plain, ntt_cuda.intt_plain,
        lambda r, lb, n, inv: ntt_work(r, lb, n), 'lattisense_torch/csrc/ntt32.cu',
        [('lattisense_tpu/ops/ntt_pallas32.py:101', 'ntt_fused32 (_fwd_kernel)'),
         ('lattisense_tpu/ops/ntt_pallas32.py:173', 'intt_fused32 (_inv_kernel)')]))
    mpc = run_mpc('mpc_path', params, LEVEL, ['ntt32_fwd', 'ntt32_inv'],
                  ['behz_prep32', 'ksw_switch32', 'behz_finish32'], u64_kernel_counts + wide_ntts,
                  MAIN_ITERS)
    path_launches['mpc_path'] = mpc['launches']
    torch.cuda.empty_cache()
    holds64 = mpc_holds(
        'mpc64_path', params64, LEVEL64, 64, ('ntt64_fwd', 'ntt64_inv'), ntt64_cuda.ntt64_fwd,
        ntt64_cuda.ntt64_inv, ntt64_cuda.ntt64_plain, ntt64_cuda.intt64_plain, ntt64_work,
        'lattisense_torch/csrc/ntt64.cu',
        [('lattisense_tpu/ops/ntt_pallas64f.py:48', 'ntt_fused64 (_fwd_kernel)'),
         ('lattisense_tpu/ops/ntt_pallas64f.py:98', 'intt_fused64 (_inv_kernel)')])
    for kname, entry in holds64.items():
        entry['imad_bound_ms'] = imad_bound_ms(
            [(b5_imad(logn, 'inv' in kname), butterflies(entry['shapes'], N))])
    kernels.update(holds64)
    path_launches['mpc64_path'] = run_mpc(
        'mpc64_path', params64, LEVEL64, ['ntt64_fwd', 'ntt64_inv'],
        ['ntt64_fwd', 'ntt64_inv', 'bconv64_convert', 'bconv64_raw', 'ksw_inner64'],
        w32_kernels + wide_ntts, MPC64_ITERS)['launches']
    torch.cuda.empty_cache()
    phase_done('mpc')

    # ---- 14. the foreign-library boundary ---------------------------------
    def foreign_args(task, structs):
        """{id: C struct} as the task's ForeignVectorArguments, in signature order."""
        return [ForeignVectorArgument(r['id'], structs[r['id']])
                for r in task.signature['online'] if r['phase'] == 'in']

    def foreign_runs(task, rlk, glk, args, mf_nbits):
        """One run that captures the task's graph, then TASK_ITERS timed
        runs; → (the outputs, ms per run: the runtime's ``duration_ns``, the
        task's run, import and export)."""
        task.run(rlk=rlk, glk=glk, args=args, mf_nbits=mf_nbits)
        ns, parts = [], []
        for _ in range(TASK_ITERS):
            out, t_ns = task.run(rlk=rlk, glk=glk, args=args, mf_nbits=mf_nbits)
            ns.append(t_ns)
            parts.append(task.timing)
        return out, {'task_ms': sum(ns) / len(ns) / 1e6,
                     **{f'{k[:-2]}_ms': sum(p[k] for p in parts) / len(parts) * 1e3
                        for k in ('import_s', 'run_s', 'export_s')}}

    def imported(exp):
        return abi.import_ciphertext(exp.struct, device='cpu').data

    ctx_m = mpc['ctx']
    qp32 = get_rns_ring(tuple(params.q) + tuple(params.p), N, dev, 32)
    ft = ForeignTask(tasks.task_dir(tasks.MULT_RELIN), mode='jit', device=dev, word_bits=32)
    t1 = time.perf_counter()
    held = {f'{v}{k}': abi.export_ciphertext(Ciphertext(data=d[k], level=LEVEL))
            for v, d in (('x', mpc['a']), ('y', mpc['b'])) for k in range(BATCH)}
    export_inputs_s = time.perf_counter() - t1
    structs = {k: e.struct for k, e in held.items()}
    foreign = {}
    for mf in (0, 64):
        rlk_e = abi.export_keyswitch_key(ctx_m.rlk, mf, qp32)
        out, timing = foreign_runs(ft, rlk_e.struct, None, foreign_args(ft, structs), mf)
        foreign[f'mult_relin_mf{mf}'] = {**timing, 'equal_to_mpc_path_step': all(
            torch.equal(imported(out[f'z{k}']), mpc['out'][k].cpu()) for k in range(BATCH))}
    graphs = len(ft.task._graphs)
    # the mult-rotate task on task_mix_path's context (seed SEED, its Galois
    # keys and the rotation's) and its x, y
    with open(os.path.join(tasks.task_dir(tasks.MIX_W32), 'task_signature.json')) as f:
        mix_elts = {int(e) for e in json.load(f)['key']['glk']}
    cm = BfvContext.create_random_context(params, seed=SEED, device=dev)
    cm.gen_galois_keys_for_elements(sorted(mix_elts | {mpc['elt']}))
    mix_msgs = tasks.mix_messages(params.t, N, SEED)
    xm, ym = (cm.encrypt(cm.encode(mix_msgs[k], LEVEL)) for k in ('x', 'y'))
    want_w, _ = FheTask(tasks.task_dir(tasks.MULT_ROTATE), mode='eager', device=dev).run(
        cm, {'x': xm, 'y': ym})
    ft2 = ForeignTask(tasks.task_dir(tasks.MULT_ROTATE), mode='jit', device=dev, word_bits=32)
    held2 = {'x': abi.export_ciphertext(xm), 'y': abi.export_ciphertext(ym)}
    for mf in (0, 64):
        rlk_e = abi.export_keyswitch_key(cm.rlk, mf, qp32)
        glk_e = abi.export_galois_keys(cm.glk.keys, mf, qp32)
        out, timing = foreign_runs(ft2, rlk_e.struct, glk_e.struct,
                                   foreign_args(ft2, {k: e.struct for k, e in held2.items()}), mf)
        w = imported(out['w'])
        got = cm.decrypt_decode(Ciphertext(data=w.to(dev), level=LEVEL))
        foreign[f'mult_rotate_mf{mf}'] = {
            **timing, 'galois_keys': len(cm.glk.keys),
            'equal_to_fhe_task': torch.equal(w, want_w['w'].data.cpu()),
            'correct': bool(np.array_equal(got, rolled(mix_msgs['x'] * mix_msgs['y'] % params.t)))}
    ok = graphs == 1 and all(v.get('equal_to_mpc_path_step', True) and
                             v.get('equal_to_fhe_task', True) and v.get('correct', True)
                             for v in foreign.values())
    print(json.dumps({'foreign_path': {
        'tasks': [tasks.MULT_RELIN, tasks.MULT_ROTATE], 'word_bits': 32, 'runs': foreign,
        'graphs_captured_mult_relin': graphs, 'export_inputs_s': export_inputs_s,
        'correct': ok, 'gpu': name_gpu, 'power_limit': power}}), flush=True)
    if not ok:
        raise AssertionError(f'foreign_path: {foreign}, graphs {graphs}')
    del cm, ft2, held2
    phase_done('foreign')

    # ---- 15. the C ABI shim driven by the reference client -----------------
    t1 = time.perf_counter()
    _, client = plugin_build.build()
    shim_build_s = time.perf_counter() - t1
    x0, y0 = (Ciphertext(data=d[0], level=LEVEL) for d in (mpc['a'], mpc['b']))
    glk_m = {mpc['elt']: mpc['glk']}
    with tempfile.TemporaryDirectory() as fix:
        pfx.write_ct(os.path.join(fix, 'x.ct'), x0)
        pfx.write_ct(os.path.join(fix, 'y.ct'), y0)
        pfx.write_ct(os.path.join(fix, 'x_badlevel.ct'),
                     ctx_m.encrypt(ctx_m.encode(mpc['msgs'][0], LEVEL - 1)))
        pfx.write_ksk(os.path.join(fix, 'rlk.key'), ctx_m.rlk, qp32)
        pfx.write_glk(os.path.join(fix, 'glk.key'), glk_m, qp32)
        out_path = os.path.join(fix, 'w.ct')
        t1 = time.perf_counter()
        proc = subprocess.run([client, tasks.task_dir(tasks.MULT_ROTATE), fix, out_path],
                              capture_output=True, text=True, env=plugin_build.client_env(),
                              timeout=600)
        client_s = time.perf_counter() - t1
        if proc.returncode != 0:
            raise AssertionError(f'capi_path: the client exited {proc.returncode}\n'
                                 f'{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}')
        lines = [ln for ln in ('negative wrong-level: OK', 'negative swapped-id: OK', 'CLIENT OK')
                 if ln in proc.stdout]
        w_client = pfx.read_ct(out_path, device=dev)
    # the same structs through the in-process ForeignTask on the shim's word
    ft3 = ForeignTask(tasks.task_dir(tasks.MULT_ROTATE), mode='jit', device=dev)
    held3 = {'x': abi.export_ciphertext(x0), 'y': abi.export_ciphertext(y0)}
    rlk_e = abi.export_keyswitch_key(ctx_m.rlk, 0, qp32)
    glk_e = abi.export_galois_keys(glk_m, 0, qp32)
    out, _ = ft3.run(rlk=rlk_e.struct, glk=glk_e.struct, mf_nbits=0,
                     args=foreign_args(ft3, {k: e.struct for k, e in held3.items()}))
    equal = torch.equal(imported(out['w']), w_client.data.cpu())
    correct = bool(np.array_equal(
        ctx_m.engine.decrypt_decode(mpc['joint'], w_client),
        rolled(mpc['msgs'][0] * mpc['msgs'][BATCH] % params.t)))
    print(json.dumps({'capi_path': {
        'task': tasks.MULT_ROTATE, 'python_h': plugin_build.python_header(),
        'shim_build_s': shim_build_s, 'client_s': client_s, 'client_lines': lines,
        'equal_to_foreign_task': equal, 'correct': correct, 'word_bits': ft3.params.word_bits,
        'gpu': name_gpu, 'power_limit': power}}), flush=True)
    if not (equal and correct and len(lines) == 3):
        raise AssertionError(f'capi_path equal={equal} correct={correct} lines={lines}')
    del ft3, held3
    phase_done('capi')

    # ---- 16. the LATTISENSE_DEV memory monitor on a task run ---------------
    dev_task = FheTask(tasks.task_dir(tasks.MULT_RELIN), mode='jit', device=dev)
    online = tasks.mult_relin_arguments(
        [Ciphertext(data=mpc['a'][k], level=LEVEL) for k in range(BATCH)],
        [Ciphertext(data=mpc['b'][k], level=LEVEL) for k in range(BATCH)])
    dev_task.compile(ctx_m, online)                     # the capture, outside the monitor
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as mon_dir:
        os.chdir(mon_dir)
        os.environ['LATTISENSE_DEV'] = '1'
        try:
            out, run_ns = dev_task.run(ctx_m, online)
        finally:
            del os.environ['LATTISENSE_DEV']
            os.chdir(cwd)
        header, rows = read_csv(os.path.join(mon_dir, 'mem_usage_gpu_0.csv'))
    col = header.index('device_bytes_in_use') if 'device_bytes_in_use' in header else None
    device_bytes = [int(r[col]) for r in rows] if col is not None else []
    equal = all(torch.equal(out[f'z{k}'].data, mpc['out'][k]) for k in range(BATCH))
    ok = bool(device_bytes) and min(device_bytes) > 0 and len(rows) >= 2 and equal
    print(json.dumps({'dev_monitor': {
        'task': tasks.MULT_RELIN, 'header': header, 'rows': len(rows),
        'device_bytes_in_use': [min(device_bytes), max(device_bytes)] if device_bytes else None,
        'run_ms': run_ns / 1e6, 'equal_to_mpc_path_step': equal, 'correct': ok,
        'gpu': name_gpu, 'power_limit': power}}), flush=True)
    if not ok:
        raise AssertionError(f'dev_monitor: rows {len(rows)}, header {header}, equal {equal}')
    del mpc, ctx_m, ft, dev_task, online, out
    torch.cuda.empty_cache()
    phase_done('dev_monitor')

    # ---- 20. the model zoo and the example runners --------------------------
    # each model of lattisense_torch.models at the JAX example's size on one
    # context a chain (the union of the models' keys), eager and replayed;
    # then on its toy chain at n=1024, card against the CPU twin bit for bit
    from lattisense_torch import models as zoo
    u64_model = (['ntt64_fwd', 'ntt64_inv', 'bconv64_convert', 'bconv64_raw', 'ksw_inner64'],
                 w32_kernels + wide_ntts)
    w32_model = (['ntt32_fwd', 'ntt32_inv', 'ksw_switch32'],
                 ['behz_prep32', 'behz_finish32'] + u64_kernel_counts + wide_ntts)
    slots = N // 2
    n1 = 1 << max(0, math.isqrt(slots).bit_length() - 1)
    t1 = time.perf_counter()
    matrix = banded_matrix(np, slots, n1, rng)
    matrix_s = time.perf_counter() - t1
    specs = model_specs(np, True, slots)
    chains = model_chains(N, True)
    ctxs, keygen_s = {}, {}
    for kind, params_m in chains.items():
        t1 = time.perf_counter()
        ctxs[kind] = (BfvContext if kind == 'b' else CkksContext).create_random_context(
            params_m, seed=SEED, device=dev)
        keygen_s[kind] = time.perf_counter() - t1
    built = {}
    for label, (kind, make, _, _, _) in specs.items():
        t1 = time.perf_counter()
        m = make(zoo, frontend_param(chains[kind]), matrix)
        m.compile()
        eager = m.load(ctxs[kind], mode='eager')
        built[label] = (m, eager, FheTask(m.task_dir, mode='jit', device=dev),
                        time.perf_counter() - t1)
    model_paths = list(specs)
    for label, (kind, _, pack, tol, sizes) in specs.items():
        c = ctxs[kind]
        m, eager, jit, load_s = built[label]
        must = w32_model if kind == 'w' else u64_model
        inputs, oracle = pack(m, c, rng)
        eager.run(c, inputs)                      # warm-up: the task engine's tables
        torch.cuda.synchronize()
        reset_counts()
        out_e, _ = eager.run(c, inputs)
        launches = read_counts()
        require(f'the eager {label}', launches, *must)
        t1 = time.perf_counter()
        jit.compile(c, inputs)
        compile_s = time.perf_counter() - t1
        out_j, _ = jit.run(c, inputs)
        if not outputs_equal(torch, out_j, out_e):
            raise AssertionError(f'{label}: the graph replay differs from the eager run')
        ms, busy, top = {}, {}, {}
        for mode, t in (('eager', eager), ('replay', jit)):
            ms[mode] = sum(t.run(c, inputs)[1] for _ in range(MODEL_ITERS)) / MODEL_ITERS / 1e6
            busy[mode], top[mode] = busy_and_top(torch, lambda t=t: t.run(c, inputs),
                                                 reps=MODEL_REPS, top=5, host_ops=False)
        got = np.asarray(m.decode_output(c, out_e), dtype=float)
        err = float(np.abs(got - np.asarray(oracle, dtype=float)).max())
        key_bytes, n_keys = model_key_bytes(c, m)
        path_launches[label] = launches
        line = {
            'model': type(m).__name__, 'params': {'c': 'CkksParams.create(16384)',
                                                  'b': 'BfvParams.create(16384)',
                                                  'w': 'CkksParams.create_tpu_param(16384)'}[kind],
            'word_bits': c.params.word_bits, 'n': c.params.n, **sizes,
            'compute_nodes': len(eager.mag['compute']),
            'plan_steps': {'eager': len(eager.plan), 'jit': len(jit.plan)},
            'eager_ms_per_run': ms['eager'], 'replay_ms_per_run': ms['replay'],
            'eager_busy_ms': busy['eager'], 'replay_busy_ms': busy['replay'],
            'eager_idle_share': idle_share(busy['eager'], ms['eager']),
            'replay_idle_share': idle_share(busy['replay'], ms['replay']),
            'top_kernels_eager': top['eager'], 'launches_eager': launches,
            'max_abs_err': err, 'bound': tol, 'correct': err <= tol,
            'replay_equals_eager': True, 'galois_keys': n_keys, 'key_bytes': key_bytes,
            'load_s': load_s, 'compile_s': compile_s, 'gpu': name_gpu, 'power_limit': power}
        if label.startswith('model_matvec'):
            line.update(matrix='banded: diagonals {0..15} and {n1*k, k = 1..16}', n1=n1,
                        matrix_s=matrix_s, dense='left out for time: 190 Galois keys and '
                        '8 192 plaintexts at 8 192 slots')
        print(json.dumps({label: line}), flush=True)
        if err > tol:
            raise AssertionError(f'{label}: decoded error {err} above {tol}')
        del inputs, out_e, out_j
    print(json.dumps({'model_contexts': {
        kind: {'params': chains[kind].__class__.__name__, 'n': c.params.n,
               'q_limbs': len(c.params.q), 'p_limbs': len(c.params.p),
               'word_bits': c.params.word_bits, 'keygen_s': keygen_s[kind],
               'galois_keys': len(c.glk.keys),
               'key_bytes': sum((k.key_q.numel() + k.key_p.numel()) * 8
                                for k in [c.rlk, *c.glk.keys.values()])}
        for kind, c in ctxs.items()}}), flush=True)
    # B5, B6, B7 (u64) and B1, B3 (w32) at the matvec lines' shapes, batch 1,
    # level 2: the hoisted digits over q_2 ∪ P, the switch's outputs over q_2,
    # the rescale's over q_1; RoundDivP's P → Q conversion, the mod-up, the
    # inner product; B3 with an NTT-domain output
    LM = 2
    for kind, label in (('c', 'model_matvec_path'), ('w', 'model_matvec_w32_path')):
        c = ctxs[kind]
        eng, sw = c.engine, c.engine.switcher
        alpha_m, beta_m = sw.alpha, sw.beta(LM)
        q2, q1, qp_m = eng.ring(LM), eng.ring(LM - 1), sw.ring_qp(LM)
        rows = {'rows': 'ntt_kernel'}
        if kind == 'w':
            kernels['ntt32_fwd_model'] = dict(
                route='cuda', source='lattisense_torch/csrc/ntt32.cu',
                replaces='lattisense_tpu/ops/ntt_pallas32.py:101',
                replaces_function='ntt_fused32 (_fwd_kernel)', path=label,
                counted_as='ntt32_fwd',
                **hold_ntt('ntt32_fwd_model', [(qp_m, (1, beta_m)), (q2, (1, 2)), (q1, (1, 2))],
                           ntt_cuda.ntt32_fwd, ntt_cuda.ntt_plain, ntt_work, rows))
            kernels['ntt32_inv_model'] = dict(
                route='cuda', source='lattisense_torch/csrc/ntt32.cu',
                replaces='lattisense_tpu/ops/ntt_pallas32.py:173',
                replaces_function='intt_fused32 (_inv_kernel)', path=label,
                counted_as='ntt32_inv',
                **hold_ntt('ntt32_inv_model', [(q2, (1,)), (qp_m, (1, 2)), (q2, (1, 2))],
                           ntt_cuda.ntt32_inv, ntt_cuda.intt_plain, ntt_work, rows))
            x = card_residues(q2.moduli, (1,), N)
            kernels['ksw_switch32_model'] = dict(
                route='cuda', source='lattisense_torch/csrc/ksw32.cu',
                design=ksw_cuda.switch_route(N), replaces='lattisense_tpu/ops/ksw_pallas32.py:207',
                replaces_function='ksw_switch32 (_ksw_kernel), output_ntt=True', path=label,
                counted_as='ksw_switch32',
                shapes=[{'x': list(x.shape), 'level': LM, 'alpha': alpha_m, 'beta': beta_m,
                         'T': LM + 1 + alpha_m, 'output_ntt': True}],
                **hold(lambda: list(ksw_cuda.ksw_switch32(x, c.rlk, sw, LM, True)),
                       lambda: list(sw.switch_plain(x, c.rlk, LM, True)),
                       [ksw_work(1, LM + 1, alpha_m, beta_m, N, output_ntt=True)]))
            del x
            continue
        T_m = LM + 1 + alpha_m
        kernels['ntt64_fwd_model'] = dict(
            route='cuda', source='lattisense_torch/csrc/ntt64.cu',
            replaces='lattisense_tpu/ops/ntt_pallas64f.py:48',
            replaces_function='ntt_fused64 (_fwd_kernel)', path=label, counted_as='ntt64_fwd',
            **hold_ntt('ntt64_fwd_model', [(qp_m, (1, beta_m)), (q2, (1, 2)), (q1, (1, 2))],
                       ntt64_cuda.ntt64_fwd, ntt64_cuda.ntt64_plain, fwd64, rows))
        kernels['ntt64_inv_model'] = dict(
            route='cuda', source='lattisense_torch/csrc/ntt64.cu',
            replaces='lattisense_tpu/ops/ntt_pallas64f.py:98',
            replaces_function='intt_fused64 (_inv_kernel)', path=label, counted_as='ntt64_inv',
            **hold_ntt('ntt64_inv_model', [(q2, (1,)), (qp_m, (1, 2)), (q2, (1, 2))],
                       ntt64_cuda.ntt64_inv, ntt64_cuda.intt64_plain, inv64, rows))
        pre_m = sw._level_pre(LM)
        rdp_m = pre_m[5].conv
        y = rdp_m.decompose(card_residues(rdp_m.src, (1, 2), N))
        inst = bconv_cuda.instance(alpha_m, LM + 1, max(rdp_m.src) - 1)
        kernels['bconv64_convert_model'] = dict(
            route='cuda', source='lattisense_torch/csrc/bconv64.cu',
            replaces='lattisense_tpu/ops/bconv_pallas.py:57',
            replaces_function='bconv_convert_fused (_bconv_kernel): RoundDivP P -> Q',
            path=label, counted_as='bconv64_convert', shapes=[list(y.shape)], instance=inst,
            imad_bound_ms=imad_bound_ms([(b6_imad(alpha_m, LM + 1, inst == 'specific'),
                                          y.numel() * (LM + 1))]),
            **hold(lambda: [bconv_cuda.bconv64_convert(y, rdp_m)],
                   lambda: [bconv_cuda.bconv64_plain(y, rdp_m.qhat_dst_mont, rdp_m.dst_q,
                                                     rdp_m.dst_pinv)],
                   [bconv64_work(2, alpha_m, LM + 1, N)]))
        # the digits of the mod-up, the ragged last one padded with zeros
        y = torch.nn.functional.pad(card_residues(chains[kind].q[:LM + 1], (1,), N),
                                    (0, 0, 0, beta_m * alpha_m - LM - 1))
        y = y.reshape(1, beta_m, alpha_m, N)
        inst = bconv_cuda.instance(alpha_m, T_m, bconv_cuda.WORD_GUARD)
        kernels['bconv64_raw_model'] = dict(
            route='cuda', source='lattisense_torch/csrc/bconv64.cu',
            replaces='lattisense_tpu/ops/bconv_pallas.py:57',
            replaces_function='bconv_raw_fused (_bconv_kernel), all beta digits per launch',
            path=label, counted_as='bconv64_raw', shapes=[list(y.shape)], instance=inst,
            imad_bound_ms=imad_bound_ms([(b6_imad(alpha_m, T_m, inst == 'specific'),
                                          y.numel() * T_m)]),
            **hold(lambda: [bconv_cuda.bconv64_raw(y, pre_m[4], qp_m.q, qp_m.pinv)],
                   lambda: [bconv_cuda.bconv64_plain(y, pre_m[4], qp_m.q, qp_m.pinv)],
                   [bconv64_work(beta_m, alpha_m, T_m, N)]))
        d = card_residues(qp_m.moduli, (1, beta_m), N)
        kernels['ksw_inner64_model'] = dict(
            route='cuda', source='lattisense_torch/csrc/ksw64.cu',
            replaces='lattisense_tpu/ops/ksw_pallas.py:29',
            replaces_function='ksw_inner_fused (_ksw_kernel)', path=label,
            counted_as='ksw_inner64', shapes=[list(d.shape)],
            imad_bound_ms=imad_bound_ms([(b7_imad(beta_m), 2 * T_m * N * beta_m)]),
            **hold(lambda: [ksw64_cuda.ksw_inner64(d, c.rlk, LM, qp_m)],
                   lambda: [ksw64_cuda.ksw_inner64_plain(d, c.rlk, LM, qp_m)],
                   [ksw64_work(1, beta_m, T_m, N)]))
        del y, d
    del built, matrix
    ctxs.clear()
    torch.cuda.empty_cache()

    # the same models on their toy chains at n=1024: the card's output data
    # equals the port's CPU run of the same task bit for bit
    toy_chains = model_chains(MODEL_TOY_N, False)
    toy_specs = model_specs(np, False, MODEL_TOY_N // 2)
    toy_n1 = 1 << max(0, math.isqrt(MODEL_TOY_N // 2).bit_length() - 1)
    toy_matrix = banded_matrix(np, MODEL_TOY_N // 2, toy_n1, rng)
    toy_ctx = {kind: (BfvContext if kind == 'b' else CkksContext).create_random_context(
        p, seed=SEED, device=dev) for kind, p in toy_chains.items()}
    toy_models = {}
    for label, (kind, make, _, _, _) in toy_specs.items():
        m = make(zoo, frontend_param(toy_chains[kind]), toy_matrix)
        toy_models[label] = (m, m.load(toy_ctx[kind], mode='eager'))
    twins = {kind: cpu_context(c) for kind, c in toy_ctx.items()}

    def to_cpu(v):
        return [to_cpu(e) for e in v] if isinstance(v, list) else on_cpu(v)
    toy_line = {}
    for label, (kind, _, pack, tol, sizes) in toy_specs.items():
        m, task = toy_models[label]
        inputs, oracle = pack(m, toy_ctx[kind], rng)
        out, _ = task.run(toy_ctx[kind], inputs)
        t1 = time.perf_counter()
        want, _ = FheTask(m.task_dir, mode='eager', device='cpu').run(
            twins[kind], {k: to_cpu(v) for k, v in inputs.items()})
        cpu_s = time.perf_counter() - t1
        err = float(np.abs(np.asarray(m.decode_output(toy_ctx[kind], out), dtype=float)
                           - np.asarray(oracle, dtype=float)).max())
        toy_line[label] = {'bit_exact_vs_cpu': outputs_equal(torch, out, want),
                           'max_abs_err': err, 'correct': err <= tol, 'cpu_run_s': cpu_s, **sizes}
    print(json.dumps({'model_toy_paths': {'n': MODEL_TOY_N, 'lines': toy_line}}), flush=True)
    bad = [k for k, v in toy_line.items() if not (v['bit_exact_vs_cpu'] and v['correct'])]
    if bad:
        raise AssertionError(f'model_toy_paths: {bad}')
    del toy_models, toy_ctx, twins, toy_matrix
    torch.cuda.empty_cache()
    phase_done('models')

    # examples_path: every runner's main(['--toy']) in this process on the
    # card; each must print OK last, and each but multichip_sharding (whose
    # ranks are processes of their own) must launch the kernels
    import contextlib
    import importlib
    import io
    runners = [('bfv_mult', []), ('ckks_mult', []), ('project_template', []),
               ('ckks_logistic_regression', []), ('ckks_euclidean_distance', []),
               ('bfv_poly_7', []), ('benchmark_convolution', []),
               ('ckks_mult_serialization', []), ('ckks_bootstrap', []),
               ('ckks_bootstrap', ['--w32']), ('benchmark', []), ('multichip_sharding', [])]

    def scalars(d):
        out = {}
        for k, v in d.items():
            if isinstance(v, dict):
                out[k] = scalars(v)
            elif isinstance(v, (bool, int, float, np.floating, np.integer, np.bool_)):
                out[k] = v.item() if hasattr(v, 'item') else v
        return out
    ex_line = {}
    for name, flags in runners:
        mod = importlib.import_module(f'lattisense_torch.examples.{name}')
        buf = io.StringIO()
        reset_counts()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            vals = mod.main(['--toy'] + flags)
        secs = time.perf_counter() - t1
        launched = {k: v for k, v in read_counts().items() if v}
        printed = buf.getvalue().rstrip().splitlines()
        ex_line[name + ''.join(f.replace('--', '_') for f in flags)] = {
            's': secs, 'ok': printed[-1].endswith('OK'), 'last_line': printed[-1][-120:],
            'values': scalars(vals), 'launches': launched}
    torch.cuda.empty_cache()
    bad = [k for k, v in ex_line.items()
           if not v['ok'] or (k != 'multichip_sharding' and not v['launches'])]
    print(json.dumps({'examples_path': {'runners': ex_line, 'all_ok': not bad, 'gpu': name_gpu,
                                        'power_limit': power}}), flush=True)
    if bad:
        raise AssertionError(f'examples_path: {bad}')
    phase_done('examples')

    # launches on the path a kernel serves (B1's entries and the n = 2^16
    # holds: on the main path, 0), and on each CKKS,
    # bootstrap and threshold path
    for kname, entry in kernels.items():
        counted = entry.pop('counted_as', kname)
        entry['launches'] = path_launches[entry['path'] or 'main_path'][counted]
        entry['ckks_launches'] = {p: path_launches[p][counted] for p in ckks_paths
                                  if path_launches[p].get(counted)}
        entry['btp_launches'] = {p: path_launches[p][counted] for p in btp_paths
                                 if path_launches[p].get(counted)}
        entry['mpc_launches'] = {p: path_launches[p][counted] for p in mpc_paths
                                 if path_launches[p].get(counted)}
        entry['models_launches'] = {p: path_launches[p][counted] for p in model_paths
                                    if path_launches[p].get(counted)}
        entry['library_ms'] = None
        entry.setdefault('imad_bound_ms', None)
    print(json.dumps({'kernels': [{'name': k, **v} for k, v in kernels.items()]}), flush=True)
    print(gpu, flush=True)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
