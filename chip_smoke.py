#!/usr/bin/env python3
"""On-card check of the PyTorch port's main path (libmultiviewnative_torch).

Run from the repository root on a host with one NVIDIA GPU (H100):

    python3 chip_smoke.py

Phases, each raising on failure (there is no CPU fallback):

1. device: the card's name and power limit from nvidia-smi, versions;
2. build: nvcc builds the hand-written kernels from ops/csrc/;
3. kernels: each kernel (K1 rl_update, K2 quotient, K3 spectral_multiply)
   against its plain PyTorch version on the card, at the main path's shapes,
   with the error and the CUDA-event times (median) of both, and of the one
   PyTorch call that computes the same function where there is one (K2
   ``torch.div``, K3 the complex ``*``): its ``library_ms``; K2 bitwise,
   also at an odd shape and on unaligned operands (its scalar loop); K1 and
   K2 also with the operand a batch shares, psi and the integral (4, 256,
   256, 256) against one 256³ weight volume or view (phase 27's launches;
   K2 bitwise, against ``torch.div`` broadcasting) and at (3, 7, 9, 13);
4. golden: the golden pack (tests/data/golden_mv6.npz) at 2 and 5
   iterations under the gates of tests/test_golden_regression.py;
5. headline: 4 views at 256³ (bench.py's config 1) through ``deconvolve``
   on the fft engine, with the launch counts of one call (40/40/80), it/s and
   the slope;
6. prepared: the same data through prepare_workspace + deconvolve_prepared;
7. 512³: 4 views with adjoint_kernel2 and scalar weights, fft engine;
8. cross-check: CUDA against the port's CPU path at 4 views × 64³;
9. fused kernels: K4 pass A, K6 pass B, K8 pass CQA and K9 pass CU against
   their plain versions on the card at the 256³ and 512³ main-path shapes;
   K4 also against ``torch.fft.rfft2``; K9 bitwise against K1 of K7's
   output (``rl_update(psi, pass_c(v))``);
10. fused headline: phase 5's data through ``deconvolve(algorithm="fused")``,
    with the launch counts of one call (K4 42, K6 80, K8 40, K9 40, K1-K3 0;
    the forwarding's gather and contraction 2 each),
    it/s and the slope, and held against the fft engine after 10 iterations;
11. fused prepared: prepare_workspace(algorithm="fused") + deconvolve_prepared
    (K4 40 per call);
12. fused 512³: phase 7's configuration through the fused engine (K4 41);
13. fused cross-check: CUDA against the fused CPU path at 4 views × 64³;
14. fused limits: the seven passes against their plain versions at the edges
    of the FFT stages' widest tiles (small shapes: X = 1816, where 16
    sequences of the x stage fill a block's shared memory, Y = 3632 for 8
    rows, Z = 736, and Y = 384, X = 840) and one step past each (X = 1824,
    Y = 3640, Z = 744, where a narrower tile takes over), K4 and K7 at
    lengths with odd prime factors (the FFT stages' radix-3/5 and generic
    stages), K8, K9 and K10 there too and at every y split R from 1 to 8
    with X = 40 and 264, out of place and in place, and K5 and K6 at Z of
    200, 264, 712 and 736 (radices 5, 11, 89 and 23);
15. K5 pass BF, K7 pass C and K10 pass CUA against their plain versions at
    256³ and 512³ (K5 also against ``torch.fft.fft`` over z, K7 against
    ``torch.fft.irfft2``), K10's psi' bitwise against K9's, and the dense
    spectrum forwarding (pass A + BF) against the z-sparse one for the bench
    kernels at 256³;
16. carried chain: phases 10 and 12's configurations with
    ``LMVN_FUSED_CARRY=1`` (K10 40, K9 0, K6 80, K8 40, K4 3 per 256³
    call), it/s, slope, and psi against the plain chain (within 1e-5: K10's
    forward x FFT runs the transposed stages, K4's the stages after a
    digit-reversed load, so the two round apart);
17. dense forwarding on the main path: 4 views at (32, 512, 512) through
    ``deconvolve(algorithm="fused")`` (K5 8 per call), against the fft
    engine, each timed over one call after a warm-up;
18. the interleaved rung at full width (benchmarks/bench_streamed.py's
    configuration: 4 views 512³, per-voxel weights, chunk_z 64) on both
    engines: s/iteration, launch counts, the copy and compute of one view
    step timed alone beside the measured step, peak memory, and psi against
    the in-core ``deconvolve``;
19. gradients and the fp32 contract: gradients through K1-K3 at 16³ on the
    card against the port's CPU gradients (``fft_convolve3d`` with respect
    to the kernel, ``rl_view_step`` with respect to psi), with one K3 launch
    in the backward for each K3 product of the forward; in λ and the
    weights (``rl_view_step`` with a weight volume, ``deconvolve`` on fft, 2
    iterations, with (V,) weights), gate 1e-5 of max|g|; a fused pass on an
    operand that requires grad raises; and the
    z-sparse spectrum forwarding under a caller's TF32 setting against its
    fp32 result;
20. dft engine: phase 5's data through ``deconvolve(algorithm="dft")``
    (K1 40, K2 40, K3 0 per call), it/s and slope, psi against the fft engine
    after 10 iterations (1e-3); 512³ adjoint on the FullDFTPlan at 3
    iterations; CUDA against the port's CPU dft path at 4 × 64³ (1e-4);
21. direct engine: 4 views 64³ with 5³ kernels (shift-and-add) and 9³
    kernels (cuDNN ``conv3d``) against the fft engine (1e-4), and the conv
    under a caller's ``cudnn.allow_tf32 = True`` against the fp32
    shift-and-add (1e-5), the caller's setting kept;
22. the ``auto`` table: fft, dft and fused in turns at 4 views 64³ and 128³,
    the 256³ headline and its prepared path, 512³ adjoint and (32, 512,
    512), and fft and fused alone at phase 29's (256, 1024, 2048) and
    (1024, 512, 512), medians of two turns and each engine's peak memory
    beside ``resolve_algorithm``'s pick (printed, not asserted);
23. the dispatch ladder: ``deconvolve_auto`` at 4 views 512³ with per-voxel
    weights on pinned host tensors, 3 iterations, on its natural rung (in-core) and
    on the interleaved and the streamed rung forced by ``headroom`` (from the
    port's own estimates and ``device_capacity_bytes``), each shown by its
    ``LMVN_TRACE`` line and held against in-core at rtol 2e-5, atol 2e-4,
    with s/iteration and peak memory;
24. models: ``RichardsonLucy().run`` on the headline data equals
    ``deconvolve_auto`` bit for bit; ``WienerFilter`` on the card against
    the CPU path (1e-4);
25. the front ends, on phase 5's configuration as host numpy arrays:
    ``api.deconvolve_flat`` against ``deconvolve`` on data already on the
    card (1e-6 of max, bitwise expected; K1/K2/K3 40/40/80), both timed
    with the upload and the download apart; the single-step helpers
    (``quotient_flat`` bitwise, ``final_values_flat`` at λ 0 and 0.006,
    ``convolution3d``, ``iterate_fft_*``) against their plain versions on
    the card, each through its kernels; the C ABI library (``g++``) in
    process through ctypes, every GPU-named symbol bitwise its flat
    counterpart, the device queries (the card's name and memory,
    capability 9.0, one device, no error recorded); the C host smoke with
    ``--gpu`` (where the interpreter has a shared libpython), its K1-K3
    launches counted at its interpreter's exit;
    ``deconvolve_checkpointed`` on the fused engine, resumed from psi_4,
    and ``deconvolve_resilient`` through one injected failure, against the
    uninterrupted run; ``debug_context`` raising on K2's 0·(1/0); and the
    CLI at 64³ against ``deconvolve_auto`` where imageio is installed;
26. the ('view', 'z') mesh of ``parallel/`` on the one card, every cell the
    card: ``describe_topology``, then ``initialize_multihost`` over NCCL at
    world size 1, one ``all_reduce`` through ``view_sum`` and
    ``destroy_process_group``; the three z-block convolves of a 1×4 mesh at
    256³ (Bz 64, halo 12 + 12, fused extent 88) against the in-core convolve
    of their engine (1e-5 of max; fft K3 4, fused K4/K6/K7 4 each); bench
    config 1 in the simultaneous order on 2×2 and 4×1 meshes, fft and
    fused, against in-core ``deconvolve(view_order="simultaneous")`` (rtol
    2e-5, atol 2e-4), each call's launches counted; the mesh layer's own
    cost, a 1×1 mesh against in-core at the headline on fft and fused
    (it/s, slope and their ratio, with the card's name and power limit: one
    card shows overhead, not scaling); ``deconvolve_auto`` told of two
    devices (the card twice) with a ``headroom`` that refuses in-core,
    taking the z-only rung (its ``LMVN_TRACE`` line) and held against
    in-core; and bench config 3 (4 views 512³, kernel2 the flipped kernel1,
    scalar weights, 2 iterations) in the sequential order on a 1×2 z-only
    mesh (fused extent 280), fft and fused, against in-core, with the peak
    device memory;
27. batched volumes: 4 volumes of the headline configuration (shared views
    and weights) in one ``deconvolve(algorithm="auto")`` call, which runs
    fft; each entry against the single-volume fft call on it (1e-6 of
    max|psi|, bitwise expected: the batch is transformed one entry at a
    time), the launches of one call (K1/K2/K3 40/40/80, as for one volume),
    volumes/s against 4 single calls on fft and on fused in turns, and the
    peak memory; then 2 volumes at 64³ with (V, B, Z, Y, X) views on fft
    (both orders), dft and direct, ``deconvolve_auto`` (in-core, by its
    ``LMVN_TRACE`` line) and ``RichardsonLucy.run``, each against the
    single-volume calls (1e-5 where the batch is transformed at once);
28. bf16 storage of the fused spectra (``LMVN_FUSED_SPEC_BF16=1``) and the
    dense forwarding: a. K4-K10's bf16 instantiations (``pass_*_bf16``)
    against their plain versions on the same bf16 inputs at 256³ and 512³,
    a spectrum they write within one bf16 step elementwise (``BF16_STEP``,
    ``BF16_FLOOR``), a volume within 1e-5, and each bit for bit its f32
    entry on the widened inputs with the spectrum rounded once; timed in
    turns with the f32 kernel, each with its bf16 byte bound (2 bytes a
    stored spectral value); K5 and K6 also timed on random spectra; b.
    ``deconvolve_auto`` on the headline and on the 512³ adjoint
    configuration, through ``prepare_workspace`` + ``deconvolve_prepared``
    and the carried chain, each with the knob on and off: launches (every
    fused launch a bf16 one with the knob on), it/s, slope, peak memory, the
    max-relative and relative-L2 difference of the two after 10 iterations
    (finite; a second bf16 call bitwise the first), one view step at 256³
    against the f32 step within JAX's 2e-2 envelope, and the forwarding of
    the headline's 8 spectra timed in both storages; c. the dense
    forwarding of the headline's kernels at f32 (K5 8 launches at 256³; the
    spectra within 1e-5 of the z-sparse ones, and 10 iterations on them
    within 1e-5 of the run on the z-sparse ones) and (32, 512, 512) in bf16
    (K5 bf16 8 a call); d. the interleaved rung at 256³ in bf16 (K4, K6, K7
    bf16; finite, a second call bitwise), against f32; e. a 1×1 mesh in
    bf16 against in-core;
29. the fused engine past the old limits (X > 1816, Y > 3632, Z > 736), where
    the FFT stages narrow their tiles: 4 views with the bench kernels,
    per-voxel weights and 10 iterations at (256, 1024, 2048) and (1024,
    512, 512) through ``deconvolve(algorithm="fused")`` (K4 42, K6 80, K8
    40, K9 40) against fft (1e-3) and ``deconvolve_auto`` (in-core, its
    pick against phase 22's turns there), the interleaved rung on fused at
    (256, 1024, 2048), 2 iterations, against in-core (rtol 2e-5, atol
    2e-4); then the seven passes at both shapes, and at X of 1824, 2048,
    2304, 3640, 7272 and 14528, Y of 3640, 4608, 7272 and 14528, Z of 744,
    1024, 1816, 1824, 3640, 7272 and 14528, and 8168 = 8·1021 on each axis
    (the other axes 8 to 24), against their plain versions evaluated in
    float64 (1e-5; the float32 plain versions' own deviation logged
    beside), each with its time and byte bound; the bf16 twins at one such shape per axis, held as
    in phase 28;
30. the fused passes at every axis length the JAX engine takes, a long axis
    run through HBM (four-step past 14528, Bluestein for a prime factor over
    1024): a. 4 views with the bench kernels, per-voxel weights and 10
    iterations at (64, 512, 16384) (four-step x, 2 GiB a volume) and (64,
    512, 8248) (Bluestein x) through ``deconvolve(algorithm="fused")`` (K4
    42, K6 80, K8 40, K9 40) against fft (1e-3), fused and fft in turns,
    the peak memory beside its prediction, ``auto``'s pick (fft by rule)
    and ``fused_eligible``; b. every pass there and at 14536, 16384, 17280,
    8248 and 116152 on each axis (the other axes 8 to 24) against its
    float64 plain version, or the same function through ``torch.fft`` in
    float64 where the plain version's matrices or splits are too large
    (1e-5), each with its time and byte bound; c. the bf16 twins at one long
    shape per axis, held as in phase 28; d. an axis past 2^25 refused before
    any launch; the phase's seconds against its budget of 60;
31. the forwarding of a whole kernel stack (``kernel_stack_spectrum_fused``)
    at the benchmark's shapes, 4 views: 256³ with the 21³ and the 25³
    stacks, 512³ with the 21³ stack (the adjoint's one stack): the gather
    bitwise its plain version (``wrap_kernel`` view by view), the one K4
    over the V·Zs gathered planes bitwise each view's own K4,
    ``spectrum_zsparse`` within 1e-6 of max of its plain version in float64
    and timed against its bound, its plain version in float32 and the
    einsum chain it replaced (``library_ms``), its bf16 twin bitwise the f32
    entry on the widened spectrum rounded once and within one bf16 step of
    the einsum chain under bf16 storage, the whole forwarding within 1e-6 of
    max of the einsum chain of each view (the parent's path) and timed
    against it, and the launches of one stack (a gather, one K4, one
    contraction).

Every kernel's record carries its bound: the larger of the bytes its
function must move (each input read once, each output written once; a
spectrum input's pad rows not at all) over 3.35 TB/s and the operations the
function needs over 67 TFLOP/s (fp32 outside the tensor cores; transforms
counted as FFTs, whatever the kernel runs), at the main-path shape of its
timing, logged with each kernel's share of it.  The line before the
last is one JSON object with every kernel's record (256³; the bf16
instantiations as entries of their own, ``pass_*_bf16``); the last line is
``{"ok": true, "device": {...}}``.  The script imports no JAX.
"""

import contextlib
import copy
import ctypes
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

V = 4
LAM = 0.006
MIN_VALUE = 1e-4
ITERS = 10
HEADLINE_N = 256  # bench.py's config 1
BIG_N = 512  # bench.py's config 2
CROSS_N = 64
TIMED_LAUNCHES = 10  # per turn; two turns each of kernel and plain version
THIN_SHAPE = (32, 512, 512)  # both bench kernels take the dense forwarding
CHUNK_Z = 64  # benchmarks/bench_streamed.py's documented chunk

SOURCE = "libmultiviewnative_torch/ops/csrc/elementwise.cu"
FFT_SOURCE = "libmultiviewnative_torch/ops/csrc/fft_stage.cuh"
FUSED_PASSES = ("pass_a", "pass_bf", "pass_b", "pass_c", "pass_cqa", "pass_cu", "pass_cua")
# each fused pass's bf16-spectrum instantiation (phase 28) is an entry of its own
BF16_PASSES = tuple(f"{name}_bf16" for name in FUSED_PASSES)
SOURCES = {name: FFT_SOURCE for name in FUSED_PASSES + BF16_PASSES}
REPLACES = {
    "rl_update": "libmultiviewnative_tpu/ops/pallas/elementwise.py:68",
    "quotient": "libmultiviewnative_tpu/ops/pallas/elementwise.py:101",
    "spectral_multiply": "libmultiviewnative_tpu/ops/pallas/elementwise.py:130",
    "pass_a": "libmultiviewnative_tpu/ops/pallas/fused_dft2.py:1703",
    "pass_bf": "libmultiviewnative_tpu/ops/pallas/fused_dft2.py:1764",
    "pass_b": "libmultiviewnative_tpu/ops/pallas/fused_dft2.py:1735",
    "pass_c": "libmultiviewnative_tpu/ops/pallas/fused_dft2.py:1825",
    "pass_cqa": "libmultiviewnative_tpu/ops/pallas/fused_dft2.py:1854",
    "pass_cu": "libmultiviewnative_tpu/ops/pallas/fused_dft2.py:1909",
    "pass_cua": "libmultiviewnative_tpu/ops/pallas/fused_dft2.py:1950",
}
REPLACES.update({f"{name}_bf16": REPLACES[name] for name in FUSED_PASSES})
# the z-sparse forwarding of a kernel stack (phase 31): the gather and the
# contraction (and its bf16 twin) of ops/csrc/spectrum.cu, which replace the
# z-sparse branch of the JAX package's kernel_spectrum_fused (an XLA einsum)
FORWARD_KERNELS = ("spectrum_gather", "spectrum_zsparse", "spectrum_zsparse_bf16")
SOURCES.update({name: "libmultiviewnative_torch/ops/csrc/spectrum.cu" for name in FORWARD_KERNELS})
REPLACES.update({name: "libmultiviewnative_tpu/ops/pallas/fused_dft2.py:1642"
                 for name in FORWARD_KERNELS})
KERNEL_NAMES = (("rl_update", "quotient", "spectral_multiply") + FUSED_PASSES + BF16_PASSES
                + FORWARD_KERNELS)
# a kernel agrees with its plain version when max|kernel - plain| is within
# this share of max|plain|: -fmad=false gives the plain versions' rounding,
# so K1 is expected bitwise (K2 is held to 0); PyTorch's own complex
# multiply may contract to FMA, an ulp of |x||k| at most
TOLERANCE = 1e-6
# the fused passes against their plain versions (cuBLAS fp32 matmuls): sums
# of up to 2·Kxp products taken in another order, ~1e-6 of max|plain| seen on
# the CPU against the JAX package; the gate is 1e-5
FUSED_TOLERANCE = 1e-5
# a bf16-stored spectrum against its plain version rounded the same way
# (phase 28): elementwise |a - b| <= 2^-7·max(|a|, |b|) + 2e-6·max|b|, one
# bf16 step where the two f32 values round apart, plus the f32 passes' own
# disagreement near zero; tests/test_torch_spec_bf16.py's gate
BF16_STEP = 2.0**-7
BF16_FLOOR = 2e-6
# one RL view step in bf16 storage against the f32 step: the JAX package's
# envelope (tests/test_pallas_ops.py:538-573)
BF16_VIEW_STEP = 2e-2
BF16_ITERS = 2  # phase 28's interleaved and mesh runs
# (Z, Y, X) at the edges of the widest tiles of the FFT stages: Z = 736 (the
# z stage's edge before its tile narrowed by length), a 5-way split z stage,
# an 8-way split y stage, X at the x stage's bound for 16 sequences (1816),
# an unsplit Y at the y stage's for 8 rows (3632), a 3-way split y stage and
# X = 840; then one step past each of those old edges, where a narrower tile
# takes over
EDGE_SHAPES = ((736, 8, 8), (640, 8, 8), (16, 1024, 8), (16, 8, 1816), (8, 3632, 8),
               (8, 384, 8), (8, 8, 840), (744, 8, 8), (8, 8, 1824), (8, 3640, 8))
# past ops/fused.py's fused_limit on the card (phase 30 d): an axis past 2^25
OVER_LENGTH = 2**25 + 8
OVER_SHAPES = ((OVER_LENGTH, 8, 8), (8, OVER_LENGTH, 8), (8, 8, OVER_LENGTH))
# lengths for K5 and K6's FFT z stage: Z = 200 (8·5·5), 264 (8·3·11), 712
# (8·89), 736 (32·23), with Y a whole, a partial and a single column tile
Z_SHAPES = ((200, 64, 8), (264, 48, 16), (712, 40, 8), (736, 24, 16))
GRAD_N = 16
# phase 29: (Z, Y, X) with the long axis at each narrow tile of its FFT stage
# and the other two at 8-24 (a few MiB): X past 1816 (8 sequences to 3632, 4
# to 7264, 2 to 14528), Y past 3632 (4 rows to 7264, 2 to 14528), Z past the
# old edge of 736 (16 columns to 1816, 8 to 3632, 4 to 7264, 2 to 14528), and
# 8168 = 8·1021, the largest generic radix, on each axis; Y = 24 leaves a
# partial tile where one is 16 or 32 columns wide
NARROW_SHAPES = (
    tuple((8, 24, x) for x in (1824, 2048, 2304, 3640, 7272, 14528, 8168))
    + tuple((8, y, 16) for y in (3640, 4608, 7272, 14528, 8168))
    + tuple((z, 24, 8) for z in (744, 1024, 1816, 1824, 3640, 7272, 14528, 8168))
)
NARROW_BF16_SHAPES = ((8, 24, 3640), (8, 7272, 16), (1824, 24, 8))  # one per axis
# phase 29's main path, 4 views, the bench kernels, per-voxel weights: a
# 2048-wide sCMOS frame cropped to 1024 rows with 256 planes (2 GiB a
# volume), and a 1024-plane stack
WIDE_SHAPES = ((256, 1024, 2048), (1024, 512, 512))
WIDE_INTERLEAVED_ITERS = 2
# phase 30's main path, 4 views, the bench kernels, per-voxel weights: a row
# of eight 2048-wide sCMOS tiles stitched, 512 rows, 64 planes (X = 16384, a
# four-step x stage of 128·128; 2 GiB a volume), and X = 8248 = 8·1031 (a
# Bluestein x stage padded to 32768)
LONG_SHAPES = ((64, 512, 16384), (64, 512, 8248))
# phase 30's long lengths on each axis, the other two at 8-24: four-step
# 14536 = 92·158 (one step past the shared-memory stages), 16384 = 128·128
# and 17280 = 128·135 (factors not powers of two); Bluestein 8248 = 8·1031
# (a prime factor over 1024, padded to 32768) and 116152 = 8·14519 (no split
# into two shared-memory lengths, padded to 262144 = 512·512; Z = 116152
# also launches the direct x stage's planes in two slices of grid y)
LONG_LENGTHS = (14536, 16384, 17280, 8248, 116152)
LONG_EDGE_SHAPES = (tuple((8, 24, n) for n in LONG_LENGTHS)
                    + tuple((8, n, 16) for n in LONG_LENGTHS)
                    + tuple((n, 24, 8) for n in LONG_LENGTHS))
LONG_BF16_SHAPES = ((8, 24, 16384), (8, 8248, 16), (17280, 24, 8))  # one per axis
# a pass is held against its float64 plain version where the plan's dense
# matrices take at most this many bytes in float64 and its y and z splits at
# most PLAIN_SPLIT_MAX blocks (a split stage runs R² block products in
# Python: 10-20 s a shape at R = 128 or 135), else against the same function
# through torch.fft in float64 (phase 30)
PLAIN_DENSE_MAX = 8e9
PLAIN_SPLIT_MAX = 16
# the predicted peak device memory of phase 30's fused main path, GiB
LONG_PEAK_GIB = {LONG_SHAPES[0]: 62.0, LONG_SHAPES[1]: 36.0}
BATCH = 4  # phase 27: volumes in one call of the headline configuration
BATCH_N = 64  # phase 27's other batched cases, BATCH_SMALL volumes each
BATCH_SMALL = 2
BATCH_ITERS = 3
# lengths with odd prime factors for K4 and K7's FFT stages: X = 264 (8·3·11),
# 808 (8·101), 832 (64·13); Y = 200 (8·5·5), 1016 (8·127), both at R = 1
ODD_SHAPES = ((16, 200, 264), (8, 1016, 808), (8, 200, 832), (8, 1016, 264))
# K8, K9 and K10 (C's y stage, the x stage, A's y stage) at a y split of
# R = 1, 2, 4 and 8, and of R = 3, 5, 6 and 7 with X of 40 (8·5) and 264,
# beside ODD_SHAPES
SPLIT_SHAPES = ((8, 200, 40), (8, 256, 40), (8, 512, 40), (16, 1024, 264)) + tuple(
    (8, y, x) for y in (384, 640, 768, 896) for x in (40, 264))
# the H100 SXM's published peaks: HBM3 bytes/s and fp32 FLOP/s outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12


def tikhonov_atol(lam):
    """Extra absolute slack for K1 with λ > 0: one ulp of sqrt(1 + 2λv) near
    1 becomes ulp(1)/λ after the "- 1" and the "/ λ"; four are allowed, for
    a plain version whose sqrt is not correctly rounded."""
    return 4 * float(np.finfo(np.float32).eps) / lam if lam > 0 else 0.0


def log(*parts):
    print(*parts, flush=True)


def phase_device(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this check runs only on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    log("# phase 1: device")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}"
        f" device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return torch.device("cuda", 0)


def phase_build():
    from libmultiviewnative_torch.ops import _build

    log("# phase 2: build")
    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    log(f"built {path} in {time.perf_counter() - t0:.2f} s")
    report = path.parent / "nvcc.log"
    if report.exists():
        kernel = "?"
        for line in report.read_text().splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1] if "'" in line else line.strip()
            elif "registers" in line or "spill" in line:
                log(f"  ptxas: {kernel}: {line.strip()}")


@contextlib.contextmanager
def knobs(**values):
    """Set environment variables (None unsets) for a ``with`` block and put
    back what was there."""
    saved = {k: os.environ.get(k) for k in values}

    def put(pairs):
        for k, v in pairs.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    put(values)
    try:
        yield
    finally:
        put(saved)


def event_times_ms(torch, fn, n=TIMED_LAUNCHES):
    """CUDA-event times (ms) of ``n`` calls, after one warm-up."""
    fn()
    events = [
        (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        for _ in range(n)
    ]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(end) for start, end in events]


def compare(torch, name, got, ref):
    """(max|got - ref|, max|ref|) over the finite values of a kernel's output
    and its plain version; non-finite values must sit at the same places.
    A pair of outputs (a split re/im spectrum) is compared as one."""
    torch.cuda.synchronize()
    if isinstance(got, tuple):
        got = torch.cat([g.flatten() for g in got])
        ref = torch.cat([r.flatten() for r in ref])
    if got.is_complex():
        got, ref = torch.view_as_real(got), torch.view_as_real(ref)
    for pred in (torch.isnan, torch.isposinf, torch.isneginf):
        if not torch.equal(pred(got), pred(ref)):
            raise AssertionError(f"{name}: non-finite values differ from the plain version")
    fin = torch.isfinite(ref)
    abs_err = float((got[fin] - ref[fin]).abs().max()) if bool(fin.any()) else 0.0
    scale = float(ref[fin].abs().max()) if bool(fin.any()) else 1.0
    return abs_err, max(scale, 1e-30)


def bound(nbytes, ops):
    """(ms, what sets it): the least time the card could take to move
    ``nbytes`` and perform ``ops`` fp32 operations."""
    by_bytes, by_ops = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / FP32_FLOPS
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def check_kernel(torch, records, name, label, kernel, plain, nbytes, atol=0.0,
                 tol=TOLERANCE, groups=lambda out: (out,), library=None):
    """Hold one kernel call against its plain version, time both (median
    CUDA-event ms, in turns plain, kernel, kernel, plain; with ``library``,
    the PyTorch call computing the same function, in turns plain, kernel,
    library, library, kernel, plain) and log GB/s of ``nbytes``; fold the
    error into ``records[name]``.  ``groups`` splits an output into parts
    held each against its own scale (K10's psi' and its spectrum pair).
    Returns (ms, plain_ms, library_ms or None)."""
    got, ref = kernel(), plain()
    errs = [compare(torch, f"{name} {label}", g, r) for g, r in zip(groups(got), groups(ref))]
    del got, ref
    ok = all(err <= tol * sc + atol for err, sc in errs)
    abs_err, scale = max(errs, key=lambda e: e[0] / e[1])
    turns = (plain, kernel, kernel, plain) if library is None else (
        plain, kernel, library, library, kernel, plain)
    samples = {fn: [] for fn in turns}
    for fn in turns:
        samples[fn] += event_times_ms(torch, fn)
    ms, plain_ms = statistics.median(samples[kernel]), statistics.median(samples[plain])
    lib_ms = None if library is None else statistics.median(samples[library])
    log(f"{name:17s} {label:34s} max_abs_err {abs_err:.3e} rel {abs_err / scale:.3e}"
        f" (tol {tol:g} of max|plain| + {atol:.2e})"
        f" kernel {ms:.4f} ms {nbytes / ms / 1e6:8.1f} GB/s"
        f" | plain {plain_ms:.4f} ms {nbytes / plain_ms / 1e6:8.1f} GB/s"
        + ("" if lib_ms is None else f" | library {lib_ms:.4f} ms"))
    if not ok:
        raise AssertionError(f"{name} {label}: error {abs_err:.3e} beyond tolerance")
    rec = records.setdefault(name, {"max_abs_err": 0.0})
    rec["max_abs_err"] = max(rec["max_abs_err"], abs_err)
    return ms, plain_ms, lib_ms


def keep_timing(records, name, size, times, nbytes, ops, key=None):
    """Store one kernel's main-path timing at ``size``³ with its bound: the
    256³ numbers are the record's own keys, the 512³ ones under "512", and
    another launch's under ``key`` (the batch broadcast's, "broadcast")."""
    ms, plain_ms, lib_ms = times
    bound_ms, bound_by = bound(nbytes, ops)
    log(f"{name:17s} {key or f'{size}^3 main path'}: bound {bound_ms:.4f} ms ({bound_by};"
        f" {nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP); kernel at {bound_ms / ms:.3f} of it,"
        f" plain at {bound_ms / plain_ms:.3f}")
    entry = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
             "bound_by": bound_by}
    if key is not None:
        records[name][key] = entry
    elif size == HEADLINE_N:
        records[name].update(entry)
    else:
        records[name]["512"] = entry


def phase_kernels(torch, dev):
    from libmultiviewnative_torch.ops import elementwise as ew

    log("# phase 3: kernels vs plain versions on the card")
    gen = torch.Generator(device=dev).manual_seed(0)
    records = {}

    def rand(shape, lo, hi, dtype=torch.float32):
        return torch.rand(shape, generator=gen, device=dev, dtype=dtype) * (hi - lo) + lo

    for n in (HEADLINE_N, BIG_N):
        shape = (n, n, n)
        psi = rand(shape, 1.0, 100.0)
        integral = rand(shape, -0.2, 2.0)  # some <= 0: the clamp path
        w = rand(shape, 0.0, 0.5)
        vox = psi.numel() * 4
        for lam in (0.0, LAM):
            for weights, wlabel, nbytes in ((w, "voxel-w", 4 * vox), (0.25, "scalar-w", 3 * vox)):
                out = torch.empty_like(psi)
                t = check_kernel(
                    torch, records, "rl_update", f"{n}^3 {wlabel} lam={lam}",
                    lambda: ew.rl_update(psi, integral, weights, lam, MIN_VALUE, out=out),
                    lambda: ew.rl_update_plain(psi, integral, weights, lam, MIN_VALUE),
                    nbytes, atol=tikhonov_atol(lam),
                )
                # the main path's update: per-voxel weights at 256³, scalar
                # at 512³ (bench.py's configs), λ > 0; ~10 operations a voxel
                if lam == LAM and (wlabel == "voxel-w") == (n == HEADLINE_N):
                    keep_timing(records, "rl_update", n, t, nbytes, 10 * psi.numel())
        view = rand(shape, 0.0, 200.0)
        denom = rand(shape, 0.5, 1.5)
        out = torch.empty_like(view)
        t = check_kernel(
            torch, records, "quotient", f"{n}^3",
            lambda: ew.quotient(view, denom, out=out),
            lambda: ew.quotient_plain(view, denom),
            3 * vox, tol=0.0, library=lambda: torch.div(view, denom),
        )
        keep_timing(records, "quotient", n, t, 3 * vox, 2 * view.numel())
        del psi, integral, w, view, denom, out

        spec = (n, n, n // 2 + 1)
        x = torch.complex(rand(spec, -1.0, 1.0), rand(spec, -1.0, 1.0))
        k = torch.complex(rand(spec, -1.0, 1.0), rand(spec, -1.0, 1.0))
        out = torch.empty_like(x)
        for conj in (False, True):
            t = check_kernel(
                torch, records, "spectral_multiply", f"{spec} conj={conj}",
                lambda: ew.spectral_multiply(x, k, conj_k=conj, out=out),
                lambda: ew.spectral_multiply_plain(x, k, conj),
                24 * k.numel(), library=(lambda: x * k.conj()) if conj else (lambda: x * k),
            )
            # the main path's product: plain at 256³, conj_k at 512³ (adjoint)
            if conj == (n == BIG_N):
                keep_timing(records, "spectral_multiply", n, t, 24 * k.numel(), 6 * k.numel())
        del x, k, out
        torch.cuda.empty_cache()

    phase_broadcast_kernels(torch, records, rand)

    # the batch broadcast of the simultaneous view order, and odd sizes that
    # take the scalar (unaligned-tail) loops
    xb = torch.complex(rand((V, 64, 64, 33), -1, 1), rand((V, 64, 64, 33), -1, 1))
    kb = torch.complex(rand((64, 64, 33), -1, 1), rand((64, 64, 33), -1, 1))
    check_kernel(torch, records, "spectral_multiply", f"batch {tuple(xb.shape)}",
                 lambda: ew.spectral_multiply(xb, kb), lambda: ew.spectral_multiply_plain(xb, kb),
                 8 * (2 * xb.numel() + kb.numel()))
    xo = torch.complex(rand((7, 9, 7), -1, 1), rand((7, 9, 7), -1, 1))
    check_kernel(torch, records, "spectral_multiply", "odd (7, 9, 7) conj",
                 lambda: ew.spectral_multiply(xo, xo, conj_k=True),
                 lambda: ew.spectral_multiply_plain(xo, xo, True), 24 * xo.numel())
    a, b = rand((7, 9, 13), 0.5, 2.0), rand((7, 9, 13), -1.0, 2.0)
    check_kernel(torch, records, "quotient", "odd (7, 9, 13)",
                 lambda: ew.quotient(a, b), lambda: ew.quotient_plain(a, b), 12 * a.numel(),
                 tol=0.0)
    # 4 bytes past a 16-byte boundary: the scalar loop alone
    ua, ub = rand((4099,), 0.5, 2.0)[1:], rand((4099,), 0.5, 2.0)[1:]
    check_kernel(torch, records, "quotient", "unaligned (4098,)",
                 lambda: ew.quotient(ua, ub), lambda: ew.quotient_plain(ua, ub), 12 * ua.numel(),
                 tol=0.0)
    for lam in (0.0, LAM):
        check_kernel(torch, records, "rl_update", f"odd (7, 9, 13) lam={lam}",
                     lambda: ew.rl_update(a, b, b.abs(), lam, MIN_VALUE),
                     lambda: ew.rl_update_plain(a, b, b.abs(), lam, MIN_VALUE), 16 * a.numel(),
                     atol=tikhonov_atol(lam))
        edge_psi = torch.tensor([[1.0, 1.0, 1.0, 0.0]], device=dev)
        edge_int = torch.tensor([[float("nan"), float("inf"), -2.0, 3.0]], device=dev)
        check_kernel(torch, records, "rl_update", f"edge values lam={lam}",
                     lambda: ew.rl_update(edge_psi, edge_int, 1.0, lam, MIN_VALUE),
                     lambda: ew.rl_update_plain(edge_psi, edge_int, 1.0, lam, MIN_VALUE), 48)
    return records


def phase_broadcast_kernels(torch, records, rand):
    """K1 and K2 with the operand that a batch of volumes shares: psi and
    the integral (BATCH, n, n, n) against one (n, n, n) weight volume or
    view at the headline n (phase 27's launches), and at an odd shape that
    takes the scalar loops.  The shared operand is read once: 4n³(3B + 1)
    bytes for K1, 4n³(2B + 1) for K2."""
    from libmultiviewnative_torch.ops import elementwise as ew

    shape = (BATCH, HEADLINE_N, HEADLINE_N, HEADLINE_N)
    psi = rand(shape, 1.0, 100.0)
    integral = rand(shape, -0.2, 2.0)
    w = rand(shape[1:], 0.0, 0.5)
    n = w.numel()
    out = torch.empty_like(psi)
    for lam in (0.0, LAM):
        nbytes = 4 * n * (3 * BATCH + 1)
        t = check_kernel(
            torch, records, "rl_update", f"{shape} shared w lam={lam}",
            lambda: ew.rl_update(psi, integral, w, lam, MIN_VALUE, out=out),
            lambda: ew.rl_update_plain(psi, integral, w, lam, MIN_VALUE),
            nbytes, atol=tikhonov_atol(lam),
        )
        if lam == LAM:
            keep_timing(records, "rl_update", HEADLINE_N, t, nbytes, 10 * psi.numel(),
                        key="broadcast")
    del psi, w
    view = rand(shape[1:], 0.0, 200.0)
    denom = rand(shape, 0.5, 1.5)
    nbytes = 4 * n * (2 * BATCH + 1)
    t = check_kernel(
        torch, records, "quotient", f"{shape} shared view",
        lambda: ew.quotient(view, denom, out=out),
        lambda: ew.quotient_plain(view, denom),
        nbytes, tol=0.0, library=lambda: torch.div(view, denom),
    )
    keep_timing(records, "quotient", HEADLINE_N, t, nbytes, 2 * denom.numel(), key="broadcast")
    del view, denom, out, integral
    torch.cuda.empty_cache()
    a, b = rand((3, 7, 9, 13), 0.5, 2.0), rand((3, 7, 9, 13), -1.0, 2.0)
    v, wo = rand((7, 9, 13), 0.5, 2.0), rand((7, 9, 13), 0.0, 1.0)
    check_kernel(torch, records, "quotient", "odd (3, 7, 9, 13) shared view",
                 lambda: ew.quotient(v, b), lambda: ew.quotient_plain(v, b),
                 4 * v.numel() * 7, tol=0.0)
    for lam in (0.0, LAM):
        check_kernel(torch, records, "rl_update", f"odd (3, 7, 9, 13) shared w lam={lam}",
                     lambda: ew.rl_update(a, b, wo, lam, MIN_VALUE),
                     lambda: ew.rl_update_plain(a, b, wo, lam, MIN_VALUE), 4 * wo.numel() * 10,
                     atol=tikhonov_atol(lam))


def phase_golden(torch, dev):
    from libmultiviewnative_torch.deconv.rl import deconvolve
    from libmultiviewnative_torch.deconv.workspace import MultiViewData, View
    from libmultiviewnative_torch.reference.oracle import (
        l2norm, l2norm_within_limits, rms_within_limits,
    )

    log("# phase 4: golden pack on the card")
    pack_path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data", "golden_mv6.npz")
    with np.load(pack_path) as z:
        pack = {k: z[k] for k in z.files}
    data = MultiViewData.from_views(
        [View(pack[f"view_{v}"], pack[f"kernel1_{v}"], pack[f"kernel2_{v}"], pack[f"weights_{v}"])
         for v in range(6)],
        device=dev,
    )
    psi0 = torch.as_tensor(pack["psi_0_start"], device=dev)
    for iters, key, gate in ((2, "psi_1", 1e-3), (5, "psi_4", 2e-3)):
        out = deconvolve(psi0, data, iters, lam=float(pack["lambda"]),
                         min_value=float(pack["min_value"])).cpu().numpy()
        g = pack[key]
        norms = (l2norm(out, g), l2norm_within_limits(out, g, 0.3, 0.7),
                 rms_within_limits(out, g, 0.3, 0.7))
        log(f"golden {iters} it vs {key}: l2norm {norms[0]:.3e} central {norms[1]:.3e}"
            f" rms {norms[2]:.3e} (gates {gate:g}, {gate:g}, 5e-3)")
        if not (norms[0] < gate and norms[1] < gate and norms[2] < 5e-3):
            raise AssertionError(f"golden pack at {iters} iterations fails its gates: {norms}")


def bench_kernels():
    """bench.py's kernels: Gaussian 21³ kernel1 (σ = 2 + 0.5 v) and the
    flipped kernel padded to 25³ as kernel2."""
    from libmultiviewnative_torch.deconv.workspace import pad_kernel_to
    from libmultiviewnative_torch.utils.synthetic import gaussian_kernel

    k1 = np.stack([gaussian_kernel((21,) * 3, 2.0 + 0.5 * v) for v in range(V)])
    k2 = np.stack([pad_kernel_to(np.flip(k).copy(), (25,) * 3) for k in k1])
    return k1, k2


def rate(torch, run_n, reps):
    """bench.py's two numbers: ITERS over the best of ``reps`` timed calls,
    and the slope (ITERS - ITERS//3) / (t_ITERS - t_{ITERS//3}), best of 2
    each, with the per-call constants cancelled."""

    def timed(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_n(n)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    timed(ITERS)
    value = ITERS / min(timed(ITERS) for _ in range(reps))
    lo = max(1, ITERS // 3)
    t = {}
    for n in (lo, ITERS):
        timed(n)
        t[n] = min(timed(n) for _ in range(2))
    slope = (ITERS - lo) / (t[ITERS] - t[lo])
    return value, slope


def check_output(torch, out, shape, what):
    if tuple(out.shape) != shape or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{what}: output is not a finite {shape} volume")


def headline_data(torch, dev, rng):
    """bench.py's config 1: 4 views of gamma(2, 20) data at 256³, per-voxel
    weights 1/V, psi0 the mean."""
    return cube_data(torch, dev, rng, HEADLINE_N)


def cube_data(torch, dev, rng, n):
    """4 views of gamma(2, 20) data at n³ with the bench kernels, per-voxel
    weights 1/V, psi0 the mean."""
    return shaped_data(torch, dev, rng, (n,) * 3)


def shaped_data(torch, dev, rng, shape):
    """4 views of gamma(2, 20) data of ``shape`` with the bench kernels,
    per-voxel weights 1/V, psi0 the mean."""
    from libmultiviewnative_torch.deconv.workspace import MultiViewData

    k1, k2 = bench_kernels()
    views = torch.from_numpy(rng.gamma(2.0, 20.0, (V,) + shape).astype(np.float32)).to(dev)
    data = MultiViewData(views, torch.from_numpy(k1).to(dev), torch.from_numpy(k2).to(dev),
                         torch.full((V,) + shape, 1.0 / V, device=dev))
    return data, torch.full(shape, float(views.mean()), device=dev)


def thin_data(torch, dev, rng):
    """Phase 17's stack, (32, 512, 512), where both bench kernels take the
    dense forwarding."""
    return shaped_data(torch, dev, rng, THIN_SHAPE)


def phase_headline(torch, dev, rng, launches_out):
    from libmultiviewnative_torch.deconv.rl import (
        deconvolve, deconvolve_prepared, prepare_workspace,
    )
    from libmultiviewnative_torch.ops import elementwise as ew

    log(f"# phase 5: headline, 4 views at {HEADLINE_N}^3, 10 iterations, algorithm='fft'")
    shape = (HEADLINE_N,) * 3
    data, psi0 = headline_data(torch, dev, rng)

    def run_n(n):
        return deconvolve(psi0, data, n, lam=LAM, min_value=MIN_VALUE, algorithm="fft")

    torch.cuda.synchronize()
    ew.reset_launches()
    out = run_n(ITERS)
    torch.cuda.synchronize()
    launches_out.update(ew.launches)
    want = {"rl_update": V * ITERS, "quotient": V * ITERS, "spectral_multiply": 2 * V * ITERS}
    log(f"launches in one call: {dict(launches_out)} (expected {want})")
    if launches_out != want:
        raise AssertionError(f"the main path did not run through the kernels: {launches_out}")
    check_output(torch, out, shape, "headline")
    value, slope = rate(torch, run_n, reps=4)
    log(f"headline 4view {HEADLINE_N}^3: {value!r} it/s, slope {slope!r} it/s")

    log("# phase 6: prepared, the same data through prepare_workspace + deconvolve_prepared")
    prepared = prepare_workspace(data, shape, algorithm="fft")

    def run_prepared_n(n):
        return deconvolve_prepared(psi0, data, prepared, n, lam=LAM, min_value=MIN_VALUE)

    out_p = run_prepared_n(ITERS)
    diff = float((out_p - out).abs().max()) / float(out.abs().max())
    log(f"prepared vs headline: max|diff|/max|psi| = {diff:.3e} (tol 1e-6)")
    if diff > 1e-6:
        raise AssertionError(f"prepared path disagrees with the headline: {diff:.3e}")
    value_p, slope_p = rate(torch, run_prepared_n, reps=4)
    log(f"prepared 4view {HEADLINE_N}^3: {value_p!r} it/s, slope {slope_p!r} it/s")
    return {"headline": (value, slope), "prepared": (value_p, slope_p)}


def big_data(torch, dev, rng):
    """Phase 7's 512³ data: 4 views of gamma(2, 20) drawn on the card from a
    seed of ``rng``, bench kernel1 (used as its own adjoint), scalar weights
    1/V, psi0 the mean."""
    from libmultiviewnative_torch.deconv.workspace import MultiViewData

    shape = (BIG_N,) * 3
    k1, _ = bench_kernels()
    torch.manual_seed(int(rng.integers(2**31)))
    gamma = torch.distributions.Gamma(torch.tensor(2.0, device=dev), torch.tensor(1 / 20, device=dev))
    views = gamma.sample((V,) + shape)
    k1_t = torch.from_numpy(k1).to(dev)
    data = MultiViewData(views, k1_t, k1_t, torch.full((V,), 1.0 / V, device=dev))
    return data, torch.full(shape, float(views.mean()), device=dev)


def phase_512(torch, dev, rng):
    from libmultiviewnative_torch.deconv.rl import deconvolve

    log(f"# phase 7: 4 views at {BIG_N}^3, adjoint_kernel2, scalar weights, 10 iterations")
    shape = (BIG_N,) * 3
    data, psi0 = big_data(torch, dev, rng)

    def run_n(n):
        return deconvolve(psi0, data, n, lam=LAM, min_value=MIN_VALUE, algorithm="fft",
                          adjoint_kernel2=True)

    torch.cuda.reset_peak_memory_stats(dev)
    check_output(torch, run_n(ITERS), shape, f"{BIG_N}^3")
    value, slope = rate(torch, run_n, reps=2)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"4view {BIG_N}^3 adjoint: {value!r} it/s, slope {slope!r} it/s, peak {peak:.2f} GiB")
    return {"big": (value, slope)}


def phase_cross_check(torch, dev):
    from libmultiviewnative_torch.deconv.rl import deconvolve
    from libmultiviewnative_torch.deconv.workspace import Workspace, initial_psi
    from libmultiviewnative_torch.utils.synthetic import multiview_data

    log(f"# phase 8: CUDA vs the port's CPU path, 4 views at {CROSS_N}^3, 2 iterations")
    ws = Workspace.from_views(
        multiview_data(V, (CROSS_N,) * 3, (9, 9, 9), (9, 9, 9), kernel="gaussian", seed=1),
        device="cpu",
    )
    psi0 = initial_psi(ws.data)
    cpu = deconvolve(psi0, ws.data, 2, lam=LAM, min_value=MIN_VALUE)
    gpu = deconvolve(psi0.to(dev), ws.data.to(dev), 2, lam=LAM, min_value=MIN_VALUE).cpu()
    err = float((gpu - cpu).abs().max()) / float(cpu.abs().max())
    log(f"cuda vs cpu: max|diff|/max|psi| = {err:.3e} (tol 1e-4)")
    if not err <= 1e-4:
        raise AssertionError(f"CUDA and CPU paths disagree: {err:.3e}")


def fused_flops(plan):
    """The operations each fused pass's function needs, whatever algorithm
    its kernel runs: its transforms as FFTs, 5 n log2 n per complex length-n
    transform (Y/2 of length X per plane along x, two real columns each;
    Kx·Z of length Y along y; Kx·Y of length Z along z), plus its pointwise
    work (pass B's complex product, CQA's quotient, CU's and CUA's update at
    K1's 10 operations a voxel)."""
    Z, Y, X = plan.shape
    kx = plan.kxh
    xy = Z * (Y // 2) * 5 * X * math.log2(X) + kx * Z * 5 * Y * math.log2(Y)
    z = kx * Y * 5 * Z * math.log2(Z)
    return {"pass_a": xy, "pass_bf": z, "pass_b": 2 * z + 6 * kx * Z * Y, "pass_c": xy,
            "pass_cqa": 2 * xy + X * Y * Z, "pass_cu": xy + 10 * X * Y * Z,
            "pass_cua": 2 * xy + 10 * X * Y * Z}


def check_fp32_matmuls(torch):
    """The plain versions are cuBLAS matmuls: held and timed in full fp32."""
    if torch.backends.cuda.matmul.allow_tf32 is not False:
        raise AssertionError("torch.backends.cuda.matmul.allow_tf32 must be False")
    if torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("torch.get_float32_matmul_precision() must be 'highest'")


def phase_fused_kernels(torch, dev, records):
    from libmultiviewnative_torch.ops import elementwise as ew, fused as fu
    from libmultiviewnative_torch.ops.fused_plan import make_fused_plan

    log("# phase 9: fused kernels vs plain versions on the card")
    check_fp32_matmuls(torch)
    gen = torch.Generator(device=dev).manual_seed(1)
    k1, _ = bench_kernels()
    kernel = torch.from_numpy(k1[0]).to(dev)

    def rand(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    for size in (HEADLINE_N, BIG_N):
        shape = (size,) * 3
        Z, Y, X = shape
        label = "x".join(map(str, shape))
        plan = make_fused_plan(shape)
        c = fu.plan_tensors(plan, dev)
        psi = rand((Z, X, Y), 1.0, 100.0)
        view = rand((Z, X, Y), 1.0, 200.0)
        kre, kim = fu.kernel_spectrum_fused(kernel[: min(21, Z // 2)], shape)
        u = fu.pass_a_plain(psi, c)
        v = fu.pass_b_plain(*u, kre, kim, c)
        buf = (torch.empty_like(u[0]), torch.empty_like(u[1]))
        out = torch.empty_like(psi)
        conj = size == BIG_N
        weights = 0.25 if size == BIG_N else rand((Z, X, Y), 0.0, 0.5)
        # bytes the functions need: a spectrum input's Kx rows (its pad rows
        # carry nothing), a spectrum output's Kxp rows (pad rows written)
        vol, spec, spec_in = 4 * psi.numel(), 8 * u[0].numel(), 8 * plan.kxh * Z * Y
        flops = fused_flops(plan)
        checks = (
            ("pass_a", label, lambda: fu.pass_a(psi, plan, out=buf),
             lambda: fu.pass_a_plain(psi, c), vol + spec, 0.0,
             lambda: torch.fft.rfft2(psi, dim=(2, 1))),
            ("pass_b", f"{label} conj={conj}",
             lambda: fu.pass_b(*u, kre, kim, plan, conj_k=conj, out=buf),
             lambda: fu.pass_b_plain(*u, kre, kim, c, conj), 2 * spec_in + spec, 0.0, None),
            ("pass_cqa", f"{label} FFT stages", lambda: fu.pass_cqa(*v, view, plan, out=buf),
             lambda: fu.pass_cqa_plain(*v, view, c), spec_in + vol + spec, 0.0, None),
            ("pass_cu", f"{label} {'scalar' if conj else 'voxel'}-w lam={LAM}",
             lambda: fu.pass_cu(*v, psi, weights, plan, LAM, MIN_VALUE, out=out),
             lambda: fu.pass_cu_plain(*v, psi, weights, c, LAM, MIN_VALUE),
             spec_in + (2 if conj else 3) * vol, tikhonov_atol(LAM), None),
        )
        for name, what, kernel_fn, plain_fn, nbytes, atol, library in checks:
            t = check_kernel(torch, records, name, what, kernel_fn, plain_fn, nbytes,
                             atol=atol, tol=FUSED_TOLERANCE, library=library)
            keep_timing(records, name, size, t, nbytes, flops[name])
        # K9 runs K7's stages and K1's lmvn::rl_one on the value K7 stores
        k9 = fu.pass_cu(*v, psi, weights, plan, LAM, MIN_VALUE)
        k1_of_k7 = ew.rl_update(psi, fu.pass_c(*v, plan), weights, LAM, MIN_VALUE)
        same = bool(torch.equal(k9, k1_of_k7))
        log(f"pass_cu {label}: K9 equals K1 of K7's output bit for bit: {same}")
        if not same:
            raise AssertionError(f"pass_cu {label} differs from rl_update(pass_c(v))")
        del psi, view, u, v, buf, out, kre, kim, k9, k1_of_k7
        torch.cuda.empty_cache()


def reset_counts():
    from libmultiviewnative_torch.ops import elementwise as ew, fused as fu

    ew.reset_launches()
    fu.reset_launches()


def read_counts():
    from libmultiviewnative_torch.ops import elementwise as ew, fused as fu

    return {**ew.launches, **fu.launches}


def expect_counts(counts, want, what):
    full = {name: 0 for name in KERNEL_NAMES}
    full.update(want)
    log(f"{what}: launches in one call {counts} (expected {full})")
    if counts != full:
        raise AssertionError(f"{what}: the main path did not run through the kernels: {counts}")


def forwarded(stacks, sfx=""):
    """The launches besides K4 of the z-sparse forwarding of ``stacks``
    kernel stacks (a single kernel is a stack of one): a gather and a
    contraction each; K4 once a stack, counted with the passes."""
    return {"spectrum_gather": stacks, "spectrum_zsparse" + sfx: stacks}


def phase_fused_headline(torch, dev, rng, launches_out):
    from libmultiviewnative_torch.deconv.rl import (
        deconvolve, deconvolve_prepared, prepare_workspace,
    )

    log(f"# phase 10: fused headline, 4 views at {HEADLINE_N}^3, 10 iterations,"
        " algorithm='fused'")
    shape = (HEADLINE_N,) * 3
    data, psi0 = headline_data(torch, dev, rng)

    def run_n(n):
        return deconvolve(psi0, data, n, lam=LAM, min_value=MIN_VALUE, algorithm="fused")

    run_n(1)  # builds nothing new, but loads the plan constants
    torch.cuda.synchronize()
    reset_counts()
    out = run_n(ITERS)
    torch.cuda.synchronize()
    counts = read_counts()
    expect_counts(counts, {"pass_a": V * ITERS + 2, "pass_b": 2 * V * ITERS,
                           "pass_cqa": V * ITERS, "pass_cu": V * ITERS, **forwarded(2)},
                  "fused headline")
    launches_out.update({k: counts[k] for k in ("pass_a", "pass_b", "pass_cqa", "pass_cu",
                                                "spectrum_gather", "spectrum_zsparse")})
    check_output(torch, out, shape, "fused headline")
    value, slope = rate(torch, run_n, reps=4)
    log(f"fused headline 4view {HEADLINE_N}^3: {value!r} it/s, slope {slope!r} it/s")

    fft = deconvolve(psi0, data, ITERS, lam=LAM, min_value=MIN_VALUE, algorithm="fft")
    diff = float((out - fft).abs().max()) / float(fft.abs().max())
    log(f"fused vs fft after {ITERS} iterations: max|diff|/max|psi| = {diff:.3e} (tol 1e-3)")
    if not diff <= 1e-3:
        raise AssertionError(f"fused and fft engines disagree: {diff:.3e}")
    del fft

    log("# phase 11: fused prepared, prepare_workspace(algorithm='fused') + deconvolve_prepared")
    prepared = prepare_workspace(data, shape, algorithm="fused")

    def run_prepared_n(n):
        return deconvolve_prepared(psi0, data, prepared, n, lam=LAM, min_value=MIN_VALUE)

    torch.cuda.synchronize()
    reset_counts()
    out_p = run_prepared_n(ITERS)
    torch.cuda.synchronize()
    expect_counts(read_counts(), {"pass_a": V * ITERS, "pass_b": 2 * V * ITERS,
                                  "pass_cqa": V * ITERS, "pass_cu": V * ITERS}, "fused prepared")
    diff = float((out_p - out).abs().max()) / float(out.abs().max())
    log(f"fused prepared vs fused headline: max|diff|/max|psi| = {diff:.3e} (tol 1e-6)")
    if not diff <= 1e-6:
        raise AssertionError(f"fused prepared path disagrees with the headline: {diff:.3e}")
    value_p, slope_p = rate(torch, run_prepared_n, reps=4)
    log(f"fused prepared 4view {HEADLINE_N}^3: {value_p!r} it/s, slope {slope_p!r} it/s")
    return {"fused_headline": (value, slope), "fused_prepared": (value_p, slope_p)}


def phase_fused_512(torch, dev, rng):
    from libmultiviewnative_torch.deconv.rl import deconvolve

    log(f"# phase 12: fused, 4 views at {BIG_N}^3, adjoint_kernel2, scalar weights,"
        " 10 iterations")
    shape = (BIG_N,) * 3
    data, psi0 = big_data(torch, dev, rng)

    def run_n(n):
        return deconvolve(psi0, data, n, lam=LAM, min_value=MIN_VALUE, algorithm="fused",
                          adjoint_kernel2=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    out = run_n(ITERS)
    torch.cuda.synchronize()
    expect_counts(read_counts(), {"pass_a": V * ITERS + 1, "pass_b": 2 * V * ITERS,
                                  "pass_cqa": V * ITERS, "pass_cu": V * ITERS, **forwarded(1)},
                  "fused 512^3")
    check_output(torch, out, shape, f"fused {BIG_N}^3")
    value, slope = rate(torch, run_n, reps=2)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"fused 4view {BIG_N}^3 adjoint: {value!r} it/s, slope {slope!r} it/s,"
        f" peak {peak:.2f} GiB")
    return {"fused_big": (value, slope)}


def phase_fused_cross_check(torch, dev):
    from libmultiviewnative_torch.deconv.rl import deconvolve
    from libmultiviewnative_torch.deconv.workspace import Workspace, initial_psi
    from libmultiviewnative_torch.utils.synthetic import multiview_data

    log(f"# phase 13: fused CUDA vs the fused CPU path, 4 views at {CROSS_N}^3, 2 iterations")
    ws = Workspace.from_views(
        multiview_data(V, (CROSS_N,) * 3, (9, 9, 9), (9, 9, 9), kernel="gaussian", seed=1),
        device="cpu",
    )
    psi0 = initial_psi(ws.data)
    kw = dict(lam=LAM, min_value=MIN_VALUE, algorithm="fused")
    cpu = deconvolve(psi0, ws.data, 2, **kw)
    gpu = deconvolve(psi0.to(dev), ws.data.to(dev), 2, **kw).cpu()
    err = float((gpu - cpu).abs().max()) / float(cpu.abs().max())
    log(f"fused cuda vs cpu: max|diff|/max|psi| = {err:.3e} (tol 1e-4)")
    if not err <= 1e-4:
        raise AssertionError(f"fused CUDA and CPU paths disagree: {err:.3e}")


def phase_fused_limits(torch, dev):
    """The kernels run at the edges of their widest tiles and one step past
    each (phase 29 runs the narrow tiles and the shapes refused)."""
    from libmultiviewnative_torch.ops import fused as fu
    from libmultiviewnative_torch.ops.fused_plan import fft_radices, make_fused_plan
    from libmultiviewnative_torch.utils.synthetic import gaussian_kernel

    log("# phase 14: fused kernels at the edges of their widest tiles, K4/K7 at odd lengths,"
        " K8-K10 there and at every y split")
    gen = torch.Generator(device=dev).manual_seed(2)
    kernel = torch.from_numpy(gaussian_kernel((3, 3, 3), 1.0)).to(dev)
    for shape in EDGE_SHAPES:
        Z, Y, X = shape
        plan = make_fused_plan(shape)
        c = fu.plan_tensors(plan, dev)
        psi = torch.rand((Z, X, Y), generator=gen, device=dev) * 99.0 + 1.0
        view = torch.rand((Z, X, Y), generator=gen, device=dev) * 199.0 + 1.0
        k = fu.kernel_spectrum_fused(kernel, shape)
        u = fu.pass_a_plain(psi, c)
        v = fu.pass_b_plain(*u, *k, c)
        cua, cua_plain = (
            fu.pass_cua(*v, psi, 0.25, plan, 0.0, MIN_VALUE),
            fu.pass_cua_plain(*v, psi, 0.25, c, 0.0, MIN_VALUE),
        )
        for name, got, want in (
            ("pass_a", fu.pass_a(psi, plan), u),
            ("pass_bf", fu.pass_bf(*u, plan), fu.pass_bf_plain(*u, c)),
            ("pass_b", fu.pass_b(*u, *k, plan), v),
            ("pass_c", fu.pass_c(*v, plan), fu.pass_c_plain(*v, c)),
            ("pass_cqa", fu.pass_cqa(*v, view, plan), fu.pass_cqa_plain(*v, view, c)),
            ("pass_cu", fu.pass_cu(*v, psi, 0.25, plan, 0.0, MIN_VALUE),
             fu.pass_cu_plain(*v, psi, 0.25, c, 0.0, MIN_VALUE)),
            ("pass_cua psi'", cua[0], cua_plain[0]),
            ("pass_cua u", cua[1], cua_plain[1]),
        ):
            err, scale = compare(torch, f"{name} {shape}", got, want)
            log(f"{name:13s} ZYX={shape}: max_abs_err {err:.3e} rel {err / scale:.3e}"
                f" (tol {FUSED_TOLERANCE:g})")
            if not err <= FUSED_TOLERANCE * scale:
                raise AssertionError(f"{name} at ZYX={shape}: error {err:.3e} beyond tolerance")
    for shape in ODD_SHAPES + SPLIT_SHAPES:
        Z, Y, X = shape
        plan = make_fused_plan(shape)
        c = fu.plan_tensors(plan, dev)
        psi = torch.rand((Z, X, Y), generator=gen, device=dev) * 99.0 + 1.0
        view = torch.rand((Z, X, Y), generator=gen, device=dev) * 199.0 + 1.0
        w = torch.rand((Z, X, Y), generator=gen, device=dev) * 0.5
        v = tuple(torch.randn((plan.kxp, Z, Y), generator=gen, device=dev) for _ in range(2))
        # the input of K8, K9 and K10: pass A of psi, so the blurred estimate
        # and the integral are psi, away from 0
        u = fu.pass_a_plain(psi, c)
        cqa = fu.pass_cqa_plain(*u, view, c)
        cu, cua_u = fu.pass_cua_plain(*u, psi, w, c, 0.0, MIN_VALUE)  # K10's psi' is K9's
        # in place: K8's u over v, K9's psi' over psi, K10's both
        u_in, p_in, p_in2, u_in2 = (tuple(t.clone() for t in u), psi.clone(), psi.clone(),
                                    tuple(t.clone() for t in u))
        k10_in = fu.pass_cua(*u_in2, p_in2, w, plan, 0.0, MIN_VALUE, out=p_in2, u_out=u_in2)
        k10 = fu.pass_cua(*u, psi, w, plan, 0.0, MIN_VALUE)
        checks = (
            ("pass_cqa", fu.pass_cqa(*u, view, plan), cqa),
            ("pass_cqa in place", fu.pass_cqa(*u_in, view, plan, out=u_in), cqa),
            ("pass_cu", fu.pass_cu(*u, psi, w, plan, 0.0, MIN_VALUE), cu),
            ("pass_cu in place", fu.pass_cu(*u, p_in, w, plan, 0.0, MIN_VALUE, out=p_in), cu),
            ("pass_cua psi'", k10[0], cu),
            ("pass_cua u", k10[1], cua_u),
            ("pass_cua in place psi'", k10_in[0], cu),
            ("pass_cua in place u", k10_in[1], cua_u),
        )
        if shape in ODD_SHAPES:
            checks += (
                ("pass_a", fu.pass_a(psi, plan), fu.pass_a_plain(psi, c)),
                ("pass_c", fu.pass_c(*v, plan), fu.pass_c_plain(*v, c)),
            )
        for name, got, want in checks:
            err, scale = compare(torch, f"{name} {shape}", got, want)
            log(f"{name:22s} ZYX={shape} R={plan.sy.R} (FFT radices x {fft_radices(X)},"
                f" y {fft_radices(Y)}):"
                f" max_abs_err {err:.3e} rel {err / scale:.3e} (tol {FUSED_TOLERANCE:g})")
            if not err <= FUSED_TOLERANCE * scale:
                raise AssertionError(f"{name} at ZYX={shape}: error {err:.3e} beyond tolerance")
    for shape in Z_SHAPES:
        Z, Y, X = shape
        plan = make_fused_plan(shape)
        c = fu.plan_tensors(plan, dev)
        u = tuple(torch.randn((plan.kxp, Z, Y), generator=gen, device=dev) for _ in range(2))
        k = tuple(torch.randn((plan.kxp, Z, Y), generator=gen, device=dev) for _ in range(2))
        for t in u + k:
            t[plan.kxh:] = 0.0  # pad rows, as pass A leaves them
        inplace = tuple(t.clone() for t in u)
        for name, got, want in (
            ("pass_bf", fu.pass_bf(*u, plan), fu.pass_bf_plain(*u, c)),
            ("pass_b", fu.pass_b(*u, *k, plan), fu.pass_b_plain(*u, *k, c)),
            ("pass_b conj", fu.pass_b(*u, *k, plan, conj_k=True), fu.pass_b_plain(*u, *k, c, True)),
            ("pass_b in place", fu.pass_b(*inplace, *k, plan, out=inplace),
             fu.pass_b_plain(*u, *k, c)),
        ):
            err, scale = compare(torch, f"{name} {shape}", got, want)
            log(f"{name:15s} ZYX={shape} (FFT radices z {fft_radices(Z)}): max_abs_err {err:.3e}"
                f" rel {err / scale:.3e} (tol {FUSED_TOLERANCE:g})")
            if not err <= FUSED_TOLERANCE * scale:
                raise AssertionError(f"{name} at ZYX={shape}: error {err:.3e} beyond tolerance")

def phase_rest_kernels(torch, dev, records):
    """K5, K7 and K10 against their plain versions at the main-path shapes,
    and the two spectrum forwardings against each other."""
    from libmultiviewnative_torch.core.wrap import wrap_kernel
    from libmultiviewnative_torch.ops import fused as fu
    from libmultiviewnative_torch.ops.fused_plan import make_fused_plan, split_perm

    log("# phase 15: K5 pass BF, K7 pass C and K10 pass CUA vs plain versions on the card")
    check_fp32_matmuls(torch)
    gen = torch.Generator(device=dev).manual_seed(3)
    k1, k2 = bench_kernels()
    kernel = torch.from_numpy(k1[0]).to(dev)

    def rand(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    for size in (HEADLINE_N, BIG_N):
        shape = (size,) * 3
        Z, Y, X = shape
        label = "x".join(map(str, shape))
        plan = make_fused_plan(shape)
        c = fu.plan_tensors(plan, dev)
        psi = rand((Z, X, Y), 1.0, 100.0)
        kre, kim = fu.kernel_spectrum_fused(kernel, shape)
        v = fu.pass_b_plain(*fu.pass_a_plain(psi, c), kre, kim, c)
        uk = fu.pass_a_plain(wrap_kernel(kernel, shape).transpose(1, 2).contiguous(), c)
        scalar = size == BIG_N
        weights, lam = (0.25, LAM) if scalar else (rand((Z, X, Y), 0.0, 0.5), 0.0)
        out = torch.empty_like(psi)
        buf = (torch.empty_like(v[0]), torch.empty_like(v[1]))
        vol, spec, spec_in = 4 * psi.numel(), 8 * v[0].numel(), 8 * plan.kxh * Z * Y
        flops = fused_flops(plan)
        # the library calls' inputs: K5's pair as one complex tensor; K7's
        # spectrum with y in natural order, (Z, Kx, Y) with x the halved axis
        uk_c = torch.complex(*uk)
        natural = torch.empty((plan.kxh, Z, Y), dtype=torch.complex64, device=dev)
        natural[..., torch.as_tensor(split_perm(Y, (plan.sy.R, plan.sy.M)), device=dev)] = (
            torch.complex(*v)[: plan.kxh])
        natural = natural.transpose(0, 1).contiguous()
        checks = (
            ("pass_bf", f"{label} kernel1 21^3", lambda: fu.pass_bf(*uk, plan),
             lambda: fu.pass_bf_plain(*uk, c), spec_in + spec, 0.0, None,
             lambda: torch.fft.fft(uk_c, dim=1)),
            ("pass_c", label, lambda: fu.pass_c(*v, plan),
             lambda: fu.pass_c_plain(*v, c), spec_in + vol, 0.0, None,
             lambda: torch.fft.irfft2(natural, s=(Y, X), dim=(2, 1))),
            ("pass_cua", f"{label} {'scalar' if scalar else 'voxel'}-w lam={lam}",
             lambda: fu.pass_cua(*v, psi, weights, plan, lam, MIN_VALUE, out=out, u_out=buf),
             lambda: fu.pass_cua_plain(*v, psi, weights, c, lam, MIN_VALUE),
             spec_in + spec + (2 if scalar else 3) * vol, tikhonov_atol(lam), lambda o: o, None),
        )
        for name, what, kernel_fn, plain_fn, nbytes, atol, groups, library in checks:
            t = check_kernel(torch, records, name, what, kernel_fn, plain_fn, nbytes,
                             atol=atol, tol=FUSED_TOLERANCE,
                             groups=groups or (lambda o: (o,)), library=library)
            keep_timing(records, name, size, t, nbytes, flops[name])
        # K10's psi' comes out of the same x stage and update as K9's
        k10, _ = fu.pass_cua(*v, psi, weights, plan, lam, MIN_VALUE)
        same = bool(torch.equal(k10, fu.pass_cu(*v, psi, weights, plan, lam, MIN_VALUE)))
        log(f"pass_cua {label}: K10's psi' equals K9's bit for bit: {same}")
        if not same:
            raise AssertionError(f"pass_cua {label}: psi' differs from pass_cu's")
        del psi, v, uk, out, buf, kre, kim, weights, uk_c, natural, k10
        torch.cuda.empty_cache()

    shape = (HEADLINE_N,) * 3
    for which, k in (("kernel1 21^3", k1[0]), ("kernel2 25^3", k2[0])):
        k = torch.from_numpy(k).to(dev)
        dense, sparse = fu._spectrum_dense(k, shape), fu._spectrum_sparse(k, shape)
        err, scale = compare(torch, f"dense vs sparse {which}", dense, sparse)
        log(f"spectrum forwarding {which} at {shape}: dense vs sparse max_abs_err {err:.3e}"
            f" rel {err / scale:.3e} (tol {FUSED_TOLERANCE:g})")
        if not err <= FUSED_TOLERANCE * scale:
            raise AssertionError(f"dense and sparse forwarding disagree for {which}: {err:.3e}")


def phase_carried(torch, dev, rng, launches_out):
    from libmultiviewnative_torch.deconv.rl import deconvolve

    log("# phase 16: carried chain (LMVN_FUSED_CARRY=1), phases 10 and 12's configurations")
    rates = {}
    for label, make, kw, reps, want in (
        (f"{HEADLINE_N}^3", headline_data, {}, 4,
         {"pass_a": 2 + 1, "pass_b": 2 * V * ITERS, "pass_cqa": V * ITERS,
          "pass_cua": V * ITERS, **forwarded(2)}),
        (f"{BIG_N}^3 adjoint", big_data, {"adjoint_kernel2": True}, 2,
         {"pass_a": 1 + 1, "pass_b": 2 * V * ITERS, "pass_cqa": V * ITERS,
          "pass_cua": V * ITERS, **forwarded(1)}),
    ):
        data, psi0 = make(torch, dev, rng)

        def run_n(n):
            return deconvolve(psi0, data, n, lam=LAM, min_value=MIN_VALUE,
                              algorithm="fused", **kw)

        with knobs(LMVN_FUSED_CARRY="1"):
            torch.cuda.synchronize()
            reset_counts()
            carried = run_n(ITERS)
            torch.cuda.synchronize()
            counts = read_counts()
            expect_counts(counts, want, f"carried {label}")
            if label.startswith(str(HEADLINE_N)):
                launches_out["pass_cua"] = counts["pass_cua"]
            check_output(torch, carried, psi0.shape, f"carried {label}")
            value, slope = rate(torch, run_n, reps=reps)
        log(f"carried 4view {label}: {value!r} it/s, slope {slope!r} it/s")
        rates[f"carried_{label.split('^')[0]}"] = (value, slope)
        with knobs(LMVN_FUSED_CARRY="0"):
            plain = run_n(ITERS)
        diff = float((carried - plain).abs().max()) / float(plain.abs().max())
        # not bitwise: K10's forward x FFT runs the transposed stages,
        # the plain chain's K4 the stages after a digit-reversed load
        log(f"carried vs plain chain {label} after {ITERS} iterations: max|diff|/max|psi| ="
            f" {diff:.3e} (tol 1e-5)")
        if not diff <= 1e-5:
            raise AssertionError(f"carried and plain chains disagree at {label}: {diff:.3e}")
        del data, psi0, carried, plain
        torch.cuda.empty_cache()
    return rates


def phase_thin(torch, dev, rng, launches_out):
    from libmultiviewnative_torch.deconv.rl import deconvolve

    log(f"# phase 17: dense spectrum forwarding on the main path, 4 views at {THIN_SHAPE},"
        " algorithm='fused'")
    data, psi0 = thin_data(torch, dev, rng)

    def run(engine):
        return deconvolve(psi0, data, ITERS, lam=LAM, min_value=MIN_VALUE, algorithm=engine)

    run("fused")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = run("fused")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    expect_counts(counts, {"pass_a": V * ITERS + 2 * V, "pass_bf": 2 * V, "pass_b": 2 * V * ITERS,
                           "pass_cqa": V * ITERS, "pass_cu": V * ITERS}, f"fused {THIN_SHAPE}")
    launches_out["pass_bf"] = counts["pass_bf"]
    check_output(torch, out, THIN_SHAPE, f"fused {THIN_SHAPE}")
    run("fft")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fft = run("fft")
    torch.cuda.synchronize()
    fft_seconds = time.perf_counter() - t0
    diff = float((out - fft).abs().max()) / float(fft.abs().max())
    log(f"fused {THIN_SHAPE}: {ITERS / seconds!r} it/s in one call, fft {ITERS / fft_seconds!r};"
        f" fused vs fft after {ITERS} iterations: max|diff|/max|psi| = {diff:.3e} (tol 1e-3)")
    if not diff <= 1e-3:
        raise AssertionError(f"fused (dense forwarding) and fft engines disagree: {diff:.3e}")


def phase_interleaved(torch, dev, launches_out):
    """benchmarks/bench_streamed.py's interleaved configuration on both
    engines; the data is drawn on the card from a seed and kept on the host."""
    from libmultiviewnative_torch.deconv.engines import TABLE, forward
    from libmultiviewnative_torch.deconv.interleaved import (
        chunk_bounds, deconvolve_interleaved, view_step,
    )
    from libmultiviewnative_torch.deconv.rl import deconvolve
    from libmultiviewnative_torch.deconv.workspace import MultiViewData
    from libmultiviewnative_torch.utils.synthetic import gaussian_kernel

    shape = (BIG_N,) * 3
    log(f"# phase 18: interleaved rung, 4 views at {BIG_N}^3, per-voxel weights 1/V,"
        f" chunk_z {CHUNK_Z}, lam {LAM}")
    torch.manual_seed(18)
    gamma = torch.distributions.Gamma(torch.tensor(2.0, device=dev), torch.tensor(1 / 20, device=dev))
    views = [gamma.sample(shape).cpu().numpy() for _ in range(V)]
    k1 = [gaussian_kernel((21,) * 3, 2.0 + 0.5 * v) for v in range(V)]
    k2 = [np.flip(k).copy() for k in k1]
    weights = [np.full(shape, 1.0 / V, np.float32) for _ in range(V)]
    psi0 = np.full(shape, float(np.mean(views[0])), np.float32)
    bounds = chunk_bounds(BIG_N, CHUNK_Z)
    # pinned once here, as a caller streaming many stacks keeps them; the
    # rung pins numpy input itself, once per call (timed below as well)
    pinned_views = [torch.from_numpy(a).pin_memory() for a in views]
    pinned_weights = [torch.from_numpy(a).pin_memory() for a in weights]
    results = {}
    for engine in ("fft", "fused"):
        def timed(n, host_views=pinned_views, host_weights=pinned_weights):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = deconvolve_interleaved(psi0, host_views, k1, k2, host_weights, n, lam=LAM,
                                         min_value=MIN_VALUE, chunk_z=CHUNK_Z,
                                         algorithm=engine, device=dev)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

        timed(1)  # warm-up
        _, t1 = timed(1)
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        got, t3 = timed(3)
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        _, t2_numpy = timed(2, views, weights)
        n_chunks = len(bounds)
        want = {"quotient": 3 * V * n_chunks, "rl_update": 3 * V * n_chunks}
        if engine == "fft":
            want["spectral_multiply"] = 2 * 3 * V
        else:
            want.update(pass_a=2 * 3 * V + 2, pass_b=2 * 3 * V, pass_c=2 * 3 * V,
                        **forwarded(2))
            launches_out["pass_c"] = counts["pass_c"]
        expect_counts(counts, want, f"interleaved {engine} 3 iterations")
        step_s = (t3 - t1) / 2
        log(f"interleaved {engine}: {step_s!r} s/iteration (2 timed iterations after one"
            f" warm-up: t3 {t3!r} s - t1 {t1!r} s, pinned input); a 2-iteration call on numpy"
            f" input, pinning included, {t2_numpy!r} s; peak device memory {peak:.2f} GiB")

        # the in-core reference on the same engine and data
        data = MultiViewData(
            torch.from_numpy(np.stack(views)).to(dev),
            torch.from_numpy(np.stack(k1)).to(dev),
            torch.from_numpy(np.stack(k2)).to(dev),
            torch.from_numpy(np.stack(weights)).to(dev),
        )
        incore = deconvolve(torch.from_numpy(psi0).to(dev), data, 3, lam=LAM,
                            min_value=MIN_VALUE, algorithm=engine)
        got_t = torch.from_numpy(got).to(dev)
        excess = float(((got_t - incore).abs() - (2e-4 + 2e-5 * incore.abs())).max())
        rel = float((got_t - incore).abs().max()) / float(incore.abs().max())
        log(f"interleaved {engine} vs in-core after 3 iterations: max|diff|/max|psi| {rel:.3e};"
            f" within rtol 2e-5, atol 2e-4: {excess <= 0}")
        if not excess <= 0:
            raise AssertionError(f"interleaved {engine} disagrees with the in-core engine")

        # one view step's copies alone (pinned host -> device), and its
        # compute alone with the chunks already on the card
        pinned = (pinned_views[0], pinned_weights[0])
        dst = [torch.empty(shape, device=dev) for _ in pinned]

        def copies():
            for z0, z1 in bounds:
                for d, h in zip(dst, pinned):
                    d[z0:z1].copy_(h[z0:z1], non_blocking=True)

        ops1, ops2, _ = forward(engine, [torch.from_numpy(k1[0]).to(dev)],
                                [torch.from_numpy(k2[0]).to(dev)], shape, dev, per_view=True)
        convolve = TABLE[engine].convolve
        psi = torch.from_numpy(psi0).to(dev)

        def compute():
            view_step(psi, ops1[0], ops2[0], convolve, bounds,
                      lambda i: (dst[0][bounds[i][0]:bounds[i][1]],
                                 dst[1][bounds[i][0]:bounds[i][1]]),
                      dst[1], LAM, MIN_VALUE)

        copy_ms = statistics.median(event_times_ms(torch, copies))
        compute_ms = statistics.median(event_times_ms(torch, compute))
        step_ms = 1e3 * step_s / V
        gbs = 2 * psi.numel() * 4 / copy_ms / 1e6
        log(f"interleaved {engine} overlap: one view's copies alone {copy_ms:.3f} ms ({gbs:.2f} GB/s),"
            f" one view step's compute alone {compute_ms:.3f} ms, sum {copy_ms + compute_ms:.3f} ms,"
            f" max {max(copy_ms, compute_ms):.3f} ms; measured view step {step_ms:.3f} ms")
        results[engine] = {"s_per_iteration": step_s, "call_2_iterations_numpy_s": t2_numpy,
                           "peak_gib": peak, "copy_ms": copy_ms, "compute_ms": compute_ms,
                           "step_ms": step_ms}
        del data, incore, got_t, pinned, dst, ops1, ops2, psi
        torch.cuda.empty_cache()
    del pinned_views, pinned_weights
    log("interleaved: " + json.dumps(results))


def phase_grad(torch, dev):
    """Gradients through K1-K3 on the card against the port's CPU
    gradients, and the z-sparse spectrum forwarding's fp32 contraction under
    a caller's TF32 setting."""

    from libmultiviewnative_torch.core.convolve import fft_convolve3d
    from libmultiviewnative_torch.deconv.rl import deconvolve, prepare_spectra, rl_view_step
    from libmultiviewnative_torch.deconv.workspace import MultiViewData
    from libmultiviewnative_torch.ops import fused as fu
    from libmultiviewnative_torch.utils.synthetic import gaussian_kernel

    log(f"# phase 19: gradients through K1-K3 at {GRAD_N}^3, and the fp32 contract")
    shape = (GRAD_N,) * 3
    rng = np.random.default_rng(19)
    x = rng.normal(size=shape).astype(np.float32)
    psi = rng.gamma(2.0, 5.0, shape).astype(np.float32)
    view = rng.gamma(2.0, 5.0, shape).astype(np.float32)
    weights = np.full(shape, 0.5, np.float32)
    kern = gaussian_kernel((3, 3, 3), 1.0)

    def conv_loss(device):
        k = torch.from_numpy(kern).to(device).requires_grad_()
        return (fft_convolve3d(torch.from_numpy(x).to(device), k) ** 2).sum(), k

    def rl_loss(device):
        p = torch.from_numpy(psi).to(device).requires_grad_()
        k1 = prepare_spectra(torch.from_numpy(kern[None]).to(device), shape)[0]
        v = torch.from_numpy(view).to(device)
        out = rl_view_step(p, v, k1, k1, torch.from_numpy(weights).to(device), LAM, MIN_VALUE,
                           conj_k2=True, out=p)
        return ((out - v) ** 2).mean(), p

    # (loss, K3 products in its forward, launches of its forward)
    for what, make, products, forward_want in (
        ("sum(fft_convolve3d(x, k)^2) d/dk", conv_loss, 1, {"spectral_multiply": 1}),
        ("rl_view_step conj_k2 lam=0.006 d/dpsi", rl_loss, 2,
         {"spectral_multiply": 2, "quotient": 1, "rl_update": 1}),
    ):
        loss, leaf = make("cpu")
        loss.backward()
        want = leaf.grad
        torch.cuda.synchronize()
        reset_counts()
        loss, leaf = make(dev)
        torch.cuda.synchronize()
        expect_counts(read_counts(), forward_want, f"forward of {what}")
        reset_counts()
        loss.backward()
        torch.cuda.synchronize()
        # K3's backward launches K3 once per product; K1's and K2's are
        # PyTorch ops (the plain version's vjp)
        expect_counts(read_counts(), {"spectral_multiply": products}, f"backward of {what}")
        err = float((leaf.grad.cpu() - want).abs().max()) / float(want.abs().max())
        log(f"gradient of {what}: card vs CPU max|diff|/max|g| = {err:.3e} (tol 1e-5)")
        if not err <= 1e-5:
            raise AssertionError(f"gradient of {what} disagrees with the CPU: {err:.3e}")

    # F10: gradients in λ and the weights, through K1's backward (the plain
    # version's vjp): one view step, and deconvolve on the fft engine with
    # (V,) weights that require grad
    views = rng.gamma(2.0, 5.0, (2,) + shape).astype(np.float32)
    kerns = np.stack([gaussian_kernel((3, 3, 3), 1.0 + 0.25 * v) for v in range(2)])

    def lam_w_step(device):
        lam = torch.tensor(LAM, device=device, requires_grad=True)
        w = torch.from_numpy(weights).to(device).requires_grad_()
        k1 = prepare_spectra(torch.from_numpy(kern[None]).to(device), shape)[0]
        v = torch.from_numpy(view).to(device)
        out = rl_view_step(torch.from_numpy(psi).to(device), v, k1, k1, w, lam, MIN_VALUE,
                           conj_k2=True)
        return ((out - v) ** 2).mean(), (lam, w)

    def lam_w_deconvolve(device):
        lam = torch.tensor(LAM, device=device, requires_grad=True)
        w = torch.full((2,), 0.5, device=device, requires_grad=True)
        t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
        data = MultiViewData(t(views), t(kerns), t(np.flip(kerns, axis=(1, 2, 3)).copy()), w)
        out = deconvolve(t(psi), data, 2, lam=lam, min_value=MIN_VALUE, algorithm="fft")
        return ((out - t(views[0])) ** 2).mean(), (lam, w)

    for what, make, forward_want in (
        ("rl_view_step conj_k2 d/dlam, d/dw (voxel)", lam_w_step,
         {"spectral_multiply": 2, "quotient": 1, "rl_update": 1}),
        ("deconvolve fft 2 it d/dlam, d/dw (V,)", lam_w_deconvolve,
         {"spectral_multiply": 8, "quotient": 4, "rl_update": 4}),
    ):
        loss, leaves = make("cpu")
        loss.backward()
        want = [t.grad for t in leaves]
        torch.cuda.synchronize()
        reset_counts()
        loss, leaves = make(dev)
        torch.cuda.synchronize()
        expect_counts(read_counts(), forward_want, f"forward of {what}")
        loss.backward()
        torch.cuda.synchronize()
        for name, leaf, ref in zip(("lam", "w"), leaves, want):
            err = float((leaf.grad.cpu() - ref).abs().max()) / float(ref.abs().max())
            log(f"gradient of {what} in {name}: card vs CPU max|diff|/max|g| = {err:.3e}"
                f" (tol 1e-5; max|g| {float(ref.abs().max()):.4e})")
            if not err <= 1e-5:
                raise AssertionError(f"gradient of {what} in {name} disagrees with the CPU")

    p = torch.ones(shape, device=dev, requires_grad=True)
    what = "fused pass A of a volume that requires grad"
    reset_counts()
    try:
        fu.pass_a(p)
    except NotImplementedError as e:
        log(f"{what}: raises ({e})")
    else:
        raise AssertionError(f"{what} did not raise")
    expect_counts(read_counts(), {}, what)

    # F5: the caller enables TF32 matmuls; the sparse forwarding stays fp32:
    # on the card it runs no matmul (spectrum_zsparse is CUDA-core fp32), so
    # its result must not move at all
    k1, _ = bench_kernels()
    kernel = torch.from_numpy(k1[0]).to(dev)
    shape = (HEADLINE_N,) * 3
    if not fu.sparse_prep_ok(kernel.shape[0], HEADLINE_N):
        raise AssertionError("the bench kernel should take the z-sparse forwarding at 256^3")
    check_fp32_matmuls(torch)
    ref = fu.kernel_spectrum_fused(kernel, shape)
    saved = torch.get_float32_matmul_precision()
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        got = fu.kernel_spectrum_fused(kernel, shape)
        kept = torch.backends.cuda.matmul.allow_tf32
        guard = fu._fp32_matmuls
        fu._fp32_matmuls = contextlib.nullcontext  # what the plain chain's pin prevents
        try:
            tf32 = fu._spectrum_sparse(kernel, shape)
        finally:
            fu._fp32_matmuls = guard
    finally:
        torch.set_float32_matmul_precision(saved)
    check_fp32_matmuls(torch)
    same = all(bool(torch.equal(g, r)) for g, r in zip(got, ref))
    unpinned, scale = compare(torch, "sparse forwarding, einsum chain in TF32", tf32, ref)
    log(f"kernel_spectrum_fused at {shape} with allow_tf32 = True: bitwise its fp32 result:"
        f" {same}; the caller's setting kept: {kept}; the einsum chain it replaced, left to"
        f" TF32: {unpinned / scale:.3e}")
    if not (same and kept):
        raise AssertionError("the sparse forwarding moved under allow_tf32")
    # the control: the setting was on, so a contraction through cuBLAS would
    # have shown TF32, and this check could tell
    if not unpinned > 1e-6 * scale:
        raise AssertionError(
            f"allow_tf32 = True did not reach the unpinned contraction ({unpinned / scale:.3e}"
            " against fp32): the check cannot see TF32")


def timed_call(torch, fn):
    """Seconds of one call that ends in a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_dft(torch, dev, rng):
    """The matmul-DFT engine on the main path, its FullDFTPlan at 512³, and
    CUDA against the port's CPU path."""
    from libmultiviewnative_torch.core.dft import FullDFTPlan, make_plan
    from libmultiviewnative_torch.deconv.rl import deconvolve
    from libmultiviewnative_torch.deconv.workspace import Workspace, initial_psi
    from libmultiviewnative_torch.utils.synthetic import multiview_data

    log(f"# phase 20: dft engine, 4 views at {HEADLINE_N}^3, 10 iterations, algorithm='dft'")
    check_fp32_matmuls(torch)
    shape = (HEADLINE_N,) * 3
    data, psi0 = headline_data(torch, dev, rng)

    def run_n(n):
        return deconvolve(psi0, data, n, lam=LAM, min_value=MIN_VALUE, algorithm="dft")

    run_n(1)
    torch.cuda.synchronize()
    reset_counts()
    out = run_n(ITERS)
    torch.cuda.synchronize()
    expect_counts(read_counts(), {"rl_update": V * ITERS, "quotient": V * ITERS}, "dft headline")
    check_output(torch, out, shape, "dft headline")
    value, slope = rate(torch, run_n, reps=2)
    log(f"dft headline 4view {HEADLINE_N}^3: {value!r} it/s, slope {slope!r} it/s")
    fft = deconvolve(psi0, data, ITERS, lam=LAM, min_value=MIN_VALUE, algorithm="fft")
    diff = float((out - fft).abs().max()) / float(fft.abs().max())
    log(f"dft vs fft after {ITERS} iterations: max|diff|/max|psi| = {diff:.3e} (tol 1e-3)")
    if not diff <= 1e-3:
        raise AssertionError(f"dft and fft engines disagree: {diff:.3e}")
    del data, psi0, out, fft
    torch.cuda.empty_cache()

    big = (BIG_N,) * 3
    if isinstance(make_plan(big, dev), FullDFTPlan) != (BIG_N > 256):
        raise AssertionError(f"{big}: the FullDFTPlan serves every axis over 256, only those")
    data, psi0 = big_data(torch, dev, rng)

    def run_big(n):
        return deconvolve(psi0, data, n, lam=LAM, min_value=MIN_VALUE, algorithm="dft",
                          adjoint_kernel2=True)

    torch.cuda.reset_peak_memory_stats(dev)
    out, t3 = timed_call(torch, lambda: run_big(3))
    check_output(torch, out, big, f"dft {BIG_N}^3")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"dft 4view {BIG_N}^3 adjoint (FullDFTPlan): 3 iterations in {t3!r} s (the first call,"
        f" plans included), peak {peak:.2f} GiB")
    del data, psi0, out
    torch.cuda.empty_cache()

    ws = Workspace.from_views(
        multiview_data(V, (CROSS_N,) * 3, (9, 9, 9), (9, 9, 9), kernel="gaussian", seed=1),
        device="cpu",
    )
    psi_c = initial_psi(ws.data)
    kw = dict(lam=LAM, min_value=MIN_VALUE, algorithm="dft")
    cpu = deconvolve(psi_c, ws.data, 2, **kw)
    gpu = deconvolve(psi_c.to(dev), ws.data.to(dev), 2, **kw).cpu()
    err = float((gpu - cpu).abs().max()) / float(cpu.abs().max())
    log(f"dft cuda vs cpu at 4 x {CROSS_N}^3, 2 iterations: max|diff|/max|psi| = {err:.3e}"
        " (tol 1e-4)")
    if not err <= 1e-4:
        raise AssertionError(f"dft CUDA and CPU paths disagree: {err:.3e}")
    return {"dft_headline": (value, slope), "dft_big_3_iterations_s": t3}


def phase_direct(torch, dev):
    """The direct engine at 64³: the shift-and-add stencil (5³) and cuDNN's
    conv3d (9³) against the fft engine, and the conv held to fp32 under a
    caller's ``cudnn.allow_tf32 = True``."""

    from libmultiviewnative_torch.core import convolve as cv
    from libmultiviewnative_torch.deconv.rl import deconvolve
    from libmultiviewnative_torch.deconv.workspace import Workspace, initial_psi
    from libmultiviewnative_torch.utils.synthetic import multiview_data

    log(f"# phase 21: direct engine, 4 views at {CROSS_N}^3, 2 iterations")
    iters = 2
    for k in (5, 9):
        ws = Workspace.from_views(
            multiview_data(V, (CROSS_N,) * 3, (k,) * 3, (k,) * 3, kernel="gaussian", seed=2),
            device=dev,
        )
        psi0 = initial_psi(ws.data)

        def run(engine):
            return deconvolve(psi0, ws.data, iters, lam=LAM, min_value=MIN_VALUE, algorithm=engine)

        run("direct")
        torch.cuda.synchronize()
        reset_counts()
        out, seconds = timed_call(torch, lambda: run("direct"))
        expect_counts(read_counts(), {"rl_update": V * iters, "quotient": V * iters},
                      f"direct {k}^3")
        fft, fft_seconds = timed_call(torch, lambda: run("fft"))
        diff = float((out - fft).abs().max()) / float(fft.abs().max())
        path = "shift-and-add" if k**3 <= cv._STENCIL_TAP_LIMIT else "conv3d"
        log(f"direct {k}^3 ({path}): {seconds / iters!r} s/iteration in one call, fft"
            f" {fft_seconds / iters!r}; direct vs fft: max|diff|/max|psi| = {diff:.3e} (tol 1e-4)")
        if not diff <= 1e-4:
            raise AssertionError(f"direct ({path}) and fft engines disagree: {diff:.3e}")

    cudnn = torch.backends.cudnn
    gen = torch.Generator(device=dev).manual_seed(21)
    x = torch.rand((CROSS_N,) * 3, generator=gen, device=dev) * 100.0
    kern = torch.rand((9, 9, 9), generator=gen, device=dev)
    exact = cv.direct_convolve3d(x, kern, stencil="rolls")  # fp32 multiply-adds
    saved = cudnn.allow_tf32
    try:
        cudnn.allow_tf32 = True
        got = cv.direct_convolve3d(x, kern, stencil="conv")
        kept = cudnn.allow_tf32
        guard = cv.fp32_convs
        cv.fp32_convs = contextlib.nullcontext  # what the pin prevents
        try:
            unpinned = cv.direct_convolve3d(x, kern, stencil="conv")
        finally:
            cv.fp32_convs = guard
    finally:
        cudnn.allow_tf32 = saved
    err, scale = compare(torch, "conv3d under allow_tf32", got, exact)
    loose, _ = compare(torch, "conv3d, TF32 allowed", unpinned, exact)
    log(f"direct conv3d 9^3 at {CROSS_N}^3 with cudnn.allow_tf32 = True: max|diff|/max = "
        f"{err / scale:.3e} against the fp32 shift-and-add (tol 1e-5); the caller's setting kept:"
        f" {kept}; the same conv left to the caller's setting: {loose / scale:.3e} (logged only:"
        " cuDNN may run fp32 there anyway)")
    if not (err <= 1e-5 * scale and kept):
        raise AssertionError(f"the direct conv left fp32 under allow_tf32: {err / scale:.3e}")


AUTO_ENGINES = ("fft", "dft", "fused")
# phase 22's rows: (label, data maker, deconvolve keywords, prepared,
# iterations a call, engines); 3 at 512³, where the dft engine takes a second
# an iteration and the per-call constants are under 2 % of a call; fft and
# fused alone at phase 29's shapes (dft made 0.90 it/s at 512³)
AUTO_ROWS = (
    ("4 views 64^3", lambda t, d, r: cube_data(t, d, r, 64), {}, False, ITERS, AUTO_ENGINES),
    ("4 views 128^3", lambda t, d, r: cube_data(t, d, r, 128), {}, False, ITERS, AUTO_ENGINES),
    (f"4 views {HEADLINE_N}^3 headline", headline_data, {}, False, ITERS, AUTO_ENGINES),
    (f"4 views {HEADLINE_N}^3 prepared", headline_data, {}, True, ITERS, AUTO_ENGINES),
    (f"4 views {BIG_N}^3 adjoint", big_data, {"adjoint_kernel2": True}, False, 3, AUTO_ENGINES),
    (f"4 views {THIN_SHAPE}", thin_data, {}, False, ITERS, AUTO_ENGINES),
) + tuple(
    (f"4 views {shape}", lambda t, d, r, shape=shape: wide_data(t, d, r, shape), {}, False, ITERS,
     ("fft", "fused"))
    for shape in WIDE_SHAPES
)


def phase_auto_table(torch, dev, rng):
    """The row's engines in turns (fft, dft, fused, fused, dft, fft), one
    timed call per turn after a warm-up, at each row of AUTO_ROWS; the median
    of the two turns (it/s: iterations over the call's seconds) beside
    ``resolve_algorithm``'s pick, and each engine's peak device memory in
    its turns (the inputs included).  Printed, not asserted: the evidence
    for the committed rule."""
    from libmultiviewnative_torch.deconv import rl

    log("# phase 22: the auto table, fft / dft / fused in turns, it/s of one call")
    table = {}
    for label, make, kw, prepared, iters, engines in AUTO_ROWS:
        data, psi0 = make(torch, dev, rng)
        shape = tuple(psi0.shape)
        spectra = {}
        if prepared:
            for engine in engines:
                spectra[engine] = rl.prepare_workspace(data, shape, algorithm=engine)

        def call(engine):
            if prepared:
                return rl.deconvolve_prepared(psi0, data, spectra[engine], iters, lam=LAM,
                                              min_value=MIN_VALUE)
            return rl.deconvolve(psi0, data, iters, lam=LAM, min_value=MIN_VALUE,
                                 algorithm=engine, **kw)

        turns = {engine: [] for engine in engines}
        peaks = {engine: 0.0 for engine in engines}
        for engine in engines:
            call(engine)  # warm-up: plans, cuFFT plans, cuBLAS handles
        for engine in engines + engines[::-1]:
            torch.cuda.reset_peak_memory_stats(dev)
            out, seconds = timed_call(torch, lambda: call(engine))
            del out  # not held into the next turn's peak
            turns[engine].append(iters / seconds)
            peaks[engine] = max(peaks[engine], torch.cuda.max_memory_allocated(dev) / 2**30)
        rates = {engine: statistics.median(t) for engine, t in turns.items()}
        pick = rl.resolve_algorithm("auto", shape, dev)
        best = max(rates, key=rates.get)
        spread = {engine: abs(t[0] - t[1]) / statistics.median(t) for engine, t in turns.items()}
        log(f"auto table {label}, {iters} iterations a call: " + ", ".join(
            f"{e} {rates[e]!r} it/s (turns {turns[e][0]:.2f}, {turns[e][1]:.2f};"
            f" peak {peaks[e]:.2f} GiB)" for e in engines)
            + f"; fastest {best}, auto picks {pick} ({rates[pick] / rates[best]:.3f} of the"
              " fastest)")
        table[label] = {"it_s": rates, "turns": turns, "spread": spread, "pick": pick,
                        "fastest": best, "peak_gib": peaks}
        del data, psi0, spectra
        torch.cuda.empty_cache()
    log("auto table: " + json.dumps(table))
    return table


def phase_ladder(torch, dev):
    """``deconvolve_auto`` at 4 views 512³ with per-voxel weights on each rung
    of the ladder: its natural decision, then the interleaved and the
    streamed rung forced by ``headroom``, each against in-core sequential."""
    import io

    from libmultiviewnative_torch.deconv import dispatch
    from libmultiviewnative_torch.deconv.workspace import MultiViewData

    shape = (BIG_N,) * 3
    iters = 3
    log(f"# phase 23: the dispatch ladder, 4 views at {BIG_N}^3, per-voxel weights 1/V,"
        f" {iters} iterations, lam {LAM}")
    torch.manual_seed(23)
    gamma = torch.distributions.Gamma(torch.tensor(2.0, device=dev), torch.tensor(1 / 20, device=dev))
    k1, k2 = bench_kernels()
    # the stacks live on the host, as a caller with a stack larger than the
    # card holds them, pinned once as one streaming many stacks keeps them;
    # the in-core rung moves them to the card
    data = MultiViewData(
        torch.stack([gamma.sample(shape).cpu() for _ in range(V)]).pin_memory(),
        torch.from_numpy(k1), torch.from_numpy(k2),
        torch.full((V,) + shape, 1.0 / V).pin_memory(),
    )
    psi0 = torch.full(shape, float(data.views[0].mean()))
    capacity = dispatch.device_capacity_bytes(dev)
    est = dispatch.estimate_workspace_bytes(data, "auto", dev)
    est_il = dispatch.estimate_interleaved_bytes(data, "auto", dev)
    log(f"device capacity {capacity >> 20} MiB; in-core estimate {est >> 20} MiB, interleaved"
        f" {est_il >> 20} MiB")
    headrooms = {"in-core": 0.9, "interleaved": (est_il + est) / 2 / capacity,
                 "streamed": est_il / 2 / capacity}
    results, incore = {}, None
    with knobs(LMVN_TRACE="1"):
        for rung, headroom in headrooms.items():
            def run(n):
                return dispatch.deconvolve_auto(psi0, data, n, lam=LAM, min_value=MIN_VALUE,
                                                headroom=headroom, device=dev)

            lines = io.StringIO()
            with contextlib.redirect_stdout(lines):
                run(1)  # warm-up: plans, first pinning, the allocator's pools
                _, t1 = timed_call(torch, lambda: run(1))
            torch.cuda.reset_peak_memory_stats(dev)
            out, t3 = timed_call(torch, lambda: run(iters))
            peak = torch.cuda.max_memory_allocated(dev) / 2**30
            step = (t3 - t1) / (iters - 1)
            trace = [ln for ln in lines.getvalue().splitlines() if ln.startswith("[lmvn-trace]")]
            log(f"ladder headroom {headroom:.4f}: " + " | ".join(trace))
            if not any(f"dispatch: {rung} on one device" in ln for ln in trace):
                raise AssertionError(f"headroom {headroom:.4f} did not select the {rung} rung")
            if out.device.type != "cpu":
                raise AssertionError(f"the {rung} rung returned a tensor on {out.device}")
            check_output(torch, out, shape, f"ladder {rung}")
            if incore is None:
                incore = out
            excess = float(((out - incore).abs() - (2e-4 + 2e-5 * incore.abs())).max())
            rel = float((out - incore).abs().max()) / float(incore.abs().max())
            log(f"ladder {rung}: {step!r} s/iteration ((t{iters} - t1) / {iters - 1}; t{iters}"
                f" {t3!r} s), peak device memory {peak:.2f} GiB; against in-core: max|diff|/max|psi|"
                f" {rel:.3e}, within rtol 2e-5, atol 2e-4: {excess <= 0}")
            if not excess <= 0:
                raise AssertionError(f"the {rung} rung disagrees with in-core sequential")
            results[rung] = {"s_per_iteration": step, "peak_gib": peak, "rel": rel}
            torch.cuda.empty_cache()
    log("ladder: " + json.dumps(results))
    return results


def phase_models(torch, dev, rng):
    """RichardsonLucy().run on the headline data is deconvolve_auto, bitwise;
    WienerFilter on the card against the CPU path."""
    from libmultiviewnative_torch.deconv.dispatch import deconvolve_auto
    from libmultiviewnative_torch.deconv.workspace import Workspace, initial_psi
    from libmultiviewnative_torch.models import RichardsonLucy, WienerFilter
    from libmultiviewnative_torch.utils.synthetic import multiview_data

    log(f"# phase 24: models, RichardsonLucy on the {HEADLINE_N}^3 headline data, WienerFilter")
    data, _ = headline_data(torch, dev, rng)
    model = RichardsonLucy(num_iterations=ITERS, lambda_=LAM, min_value=MIN_VALUE, device=dev)
    model.run(data)
    got, seconds = timed_call(torch, lambda: model.run(data))
    want = deconvolve_auto(initial_psi(data), data, ITERS, lam=LAM, min_value=MIN_VALUE, device=dev)
    same = bool(torch.equal(got, want))
    log(f"RichardsonLucy().run at {HEADLINE_N}^3 ({ITERS / seconds!r} it/s in one call after a"
        " warm-up) equals"
        f" deconvolve_auto bit for bit: {same}")
    if not same:
        raise AssertionError("RichardsonLucy().run differs from deconvolve_auto")
    WienerFilter().run(data)
    wiener, w_seconds = timed_call(torch, lambda: WienerFilter().run(data))
    check_output(torch, wiener, tuple(got.shape), "WienerFilter")
    del data, got, want, wiener
    ws = Workspace.from_views(
        multiview_data(V, (CROSS_N,) * 3, (9, 9, 9), (9, 9, 9), kernel="gaussian", seed=1),
        device="cpu",
    )
    cpu = WienerFilter().run(ws.data)
    gpu = WienerFilter().run(ws.data.to(dev)).cpu()
    err = float((gpu - cpu).abs().max()) / float(cpu.abs().max())
    log(f"WienerFilter at {HEADLINE_N}^3: {1e3 * w_seconds:.3f} ms in one call; cuda vs cpu at"
        f" 4 x {CROSS_N}^3: max|diff|/max = {err:.3e} (tol 1e-4)")
    if not err <= 1e-4:
        raise AssertionError(f"WienerFilter CUDA and CPU paths disagree: {err:.3e}")


def front_end_data(rng):
    """Phase 5's configuration as host numpy: 4 views of gamma(2, 20) at
    256³, the bench kernels, per-voxel weights 1/V, psi0 the mean."""
    shape = (HEADLINE_N,) * 3
    k1, k2 = bench_kernels()
    views = [rng.gamma(2.0, 20.0, shape).astype(np.float32) for _ in range(V)]
    weights = [np.full(shape, 1.0 / V, np.float32) for _ in range(V)]
    psi0 = np.full(shape, float(np.mean([v.mean() for v in views])), np.float32)
    return psi0, views, list(k1), list(k2), weights


def best_of(torch, fn, reps=3):
    """(result of the last call, best seconds of ``reps`` calls ending in a
    synchronise), after one warm-up call."""
    fn()
    best, out = math.inf, None
    for _ in range(reps):
        out, seconds = timed_call(torch, fn)
        best = min(best, seconds)
    return out, best


def same_or_close(what, got, want, tol=TOLERANCE):
    """Log max|got - want| / max|want| and whether they are bitwise equal;
    raise beyond ``tol``."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"{what}: not a finite {want.shape} result")
    diff = float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)
    log(f"{what}: max|diff|/max = {diff:.3e}, bitwise {np.array_equal(got, want)} (tol {tol:g})")
    if not diff <= tol:
        raise AssertionError(f"{what}: {diff:.3e} beyond {tol:g}")


def plain_view_step(psi, view, k1_hat, k2_hat, w, lam):
    """One RL view step from the kernels' plain versions (rfft, the complex
    ``*``, irfft, ``view * (1/integral)``, the plain update)."""
    from libmultiviewnative_torch.core.fft import irfft3, rfft3
    from libmultiviewnative_torch.ops import elementwise as ew

    shape = psi.shape
    integral = irfft3(ew.spectral_multiply_plain(rfft3(psi), k1_hat), shape)
    integral = ew.quotient_plain(view, integral)
    integral = irfft3(ew.spectral_multiply_plain(rfft3(integral), k2_hat), shape)
    return ew.rl_update_plain(psi, integral, w, lam, MIN_VALUE)


def phase_front_ends(torch, dev):
    """The flat API, the C ABI in process and from a C host, checkpoint and
    resume, debug_context and the CLI, on phase 5's data as host arrays."""
    import importlib.util
    import tempfile

    from libmultiviewnative_torch import api, native_client
    from libmultiviewnative_torch.core.fft import irfft3, rfft3
    from libmultiviewnative_torch.core.wrap import wrap_kernel
    from libmultiviewnative_torch.deconv.rl import deconvolve
    from libmultiviewnative_torch.deconv.workspace import MultiViewData
    from libmultiviewnative_torch.io import checkpoint as ckpt
    from libmultiviewnative_torch.native import _build as native_build
    from libmultiviewnative_torch.ops import elementwise as ew
    from libmultiviewnative_torch.utils.trace import debug_context

    log(f"# phase 25: the front ends, 4 views at {HEADLINE_N}^3 as host arrays, {ITERS} iterations")
    t_phase = time.perf_counter()
    shape = (HEADLINE_N,) * 3
    psi0, views, k1s, k2s, weights = front_end_data(np.random.default_rng(25))
    want_fft = {"rl_update": V * ITERS, "quotient": V * ITERS, "spectral_multiply": 2 * V * ITERS}

    # a. flat API against deconvolve on data already on the card
    def flat():
        return api.deconvolve_flat(psi0, views, k1s, k2s, weights, ITERS, LAM, MIN_VALUE)

    torch.cuda.synchronize()
    reset_counts()
    flat_out = flat()
    torch.cuda.synchronize()
    expect_counts(read_counts(), want_fft, "deconvolve_flat")
    flat_out, flat_s = best_of(torch, flat)

    def upload():
        return (api._tensor(psi0, dev), MultiViewData(
            api._stack(views, dev), api._stack(k1s, dev), api._stack(k2s, dev),
            api._stack(weights, dev)))

    (psi_d, data), up_s = best_of(torch, upload)
    dev_out, dev_s = best_of(torch, lambda: deconvolve(psi_d, data, ITERS, lam=LAM,
                                                       min_value=MIN_VALUE, algorithm="fft"))
    _, down_s = best_of(torch, lambda: dev_out.cpu().numpy())
    same_or_close("deconvolve_flat vs deconvolve on the card", flat_out, dev_out.cpu().numpy())
    log(f"deconvolve_flat {1e3 * flat_s:.3f} ms; on the card: upload {1e3 * up_s:.3f} ms,"
        f" deconvolve {1e3 * dev_s:.3f} ms, download {1e3 * down_s:.3f} ms;"
        f" host share {1e3 * (flat_s - dev_s):.3f} ms, flat / device {flat_s / dev_s:.3f}"
        " (best of 3 each)")

    # b. the single-step helpers against their plain versions on the card
    rng = np.random.default_rng(26)
    integral = rng.uniform(-0.2, 2.0, shape).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)  # noqa: E731
    reset_counts()
    q = api.quotient_flat(views[0], integral)
    expect_counts(read_counts(), {"quotient": 1}, "quotient_flat")
    same_or_close("quotient_flat vs plain", q, ew.quotient_plain(t(views[0]), t(integral)).cpu(),
                  tol=0.0)
    for lam in (0.0, LAM):
        reset_counts()
        fv = api.final_values_flat(psi0, integral, weights[0], lam, MIN_VALUE)
        expect_counts(read_counts(), {"rl_update": 1}, f"final_values_flat lam={lam}")
        same_or_close(f"final_values_flat lam={lam} vs plain", fv, ew.rl_update_plain(
            t(psi0), t(integral), t(weights[0]), lam, MIN_VALUE).cpu())
    k_hat = rfft3(wrap_kernel(t(k1s[0]), shape))
    reset_counts()
    conv = api.convolution3d(views[0], k1s[0])
    expect_counts(read_counts(), {"spectral_multiply": 1}, "convolution3d")
    same_or_close("convolution3d vs plain", conv,
                  irfft3(ew.spectral_multiply_plain(rfft3(t(views[0])), k_hat), shape).cpu())
    flip = np.flip(k1s[0]).copy()
    k2_hat = rfft3(wrap_kernel(t(flip), shape))
    ones = np.ones(shape, np.float32)
    steps = {}
    for lam in (0.0, LAM):
        name = "iterate_fft_tikhonov" if lam else "iterate_fft_plain"
        reset_counts()
        if lam:
            steps[name] = api.iterate_fft_tikhonov(views[0], views[0], k1s[0], flip, ones, LAM,
                                                   MIN_VALUE)
        else:
            steps[name] = api.iterate_fft_plain(views[0], views[0], k1s[0], flip, ones, MIN_VALUE)
        expect_counts(read_counts(), {"rl_update": 1, "quotient": 1, "spectral_multiply": 2},
                      name)
        same_or_close(f"{name} vs plain", steps[name], plain_view_step(
            t(views[0]), t(views[0]), k_hat, k2_hat, t(ones), lam).cpu())

    # c. the C ABI in process, through ctypes
    t0 = time.perf_counter()
    lib = native_client.load_native()
    log(f"C ABI library {native_client.build_native()} built and loaded in"
        f" {time.perf_counter() - t0:.2f} s; python flags {native_build.python_flags()}")
    nw = native_client.NativeWorkspace(views, k1s, k2s, weights, LAM, MIN_VALUE, ITERS)
    reset_counts()
    abi_out = native_client.native_deconvolve(lib, psi0.copy(), nw, device="cuda:0")
    expect_counts(read_counts(), want_fft, "inplace_gpu_deconvolve")
    abi_s = math.inf
    for _ in range(3):  # the caller's psi buffer is filled before the clock starts
        buf = psi0.copy()
        abi_out, seconds = timed_call(
            torch, lambda: native_client.native_deconvolve(lib, buf, nw, device="cuda:0"))
        abi_s = min(abi_s, seconds)
    same_or_close("inplace_gpu_deconvolve vs deconvolve_flat", abi_out, flat_out, tol=0.0)
    log(f"inplace_gpu_deconvolve {1e3 * abi_s:.3f} ms against deconvolve_flat"
        f" {1e3 * flat_s:.3f} ms (best of 3 each)")
    same_or_close("inplace_gpu_convolution vs convolution3d",
                  native_client.native_convolution(lib, views[0].copy(), k1s[0]), conv, tol=0.0)
    fptr = native_client._fptr
    out = integral.copy()
    lib.compute_quotient(fptr(views[0]), fptr(out), out.size, 0)
    same_or_close("compute_quotient vs quotient_flat", out, q, tol=0.0)
    for lam in (0.0, LAM):
        out = psi0.copy()
        lib.compute_final_values(fptr(out), fptr(integral), fptr(weights[0]), out.size,
                                 MIN_VALUE, lam, 0)
        same_or_close(f"compute_final_values lam={lam} vs final_values_flat", out,
                      api.final_values_flat(psi0, integral, weights[0], lam, MIN_VALUE), tol=0.0)
    dims = ((ctypes.c_int * 3)(*shape), (ctypes.c_int * 3)(*k1s[0].shape))
    out = np.full(shape, np.nan, np.float32)
    lib.iterate_fft_plain(fptr(views[0]), fptr(k1s[0]), fptr(out), *dims, 0)
    same_or_close("iterate_fft_plain (ABI) vs flat", out, steps["iterate_fft_plain"], tol=0.0)
    out = np.full(shape, np.nan, np.float32)
    lib.iterate_fft_tikhonov(fptr(views[0]), fptr(k1s[0]), fptr(out), *dims, out.size,
                             MIN_VALUE, LAM, 0)
    same_or_close("iterate_fft_tikhonov (ABI) vs flat", out, steps["iterate_fft_tikhonov"],
                  tol=0.0)
    name = ctypes.create_string_buffer(256)
    lib.getNameDeviceCUDA(0, name)
    queries = {
        "getNumDevicesCUDA": (lib.getNumDevicesCUDA(), torch.cuda.device_count()),
        "getNameDeviceCUDA": (name.value.decode(), torch.cuda.get_device_name(0)),
        "getMemDeviceCUDA": (lib.getMemDeviceCUDA(0),
                             torch.cuda.get_device_properties(0).total_memory),
        "capability": ((lib.getCUDAcomputeCapabilityMajorVersion(0),
                        lib.getCUDAcomputeCapabilityMinorVersion(0)), (9, 0)),
        "selectDeviceWithHighestComputeCapability": (
            lib.selectDeviceWithHighestComputeCapability(), 0),
        "mvn_tpu_last_error": (lib.mvn_tpu_last_error(), b""),
    }
    log(f"ABI device queries (got, want): {queries}")
    bad = {k: v for k, v in queries.items() if v[0] != v[1]}
    if bad:
        raise AssertionError(f"ABI device queries disagree: {bad}")

    # d. the C host: a C program that embeds the interpreter, on the card
    flags = native_build.python_flags()
    if not flags["shared"]:
        log(f"C host smoke not run: this interpreter has no shared libpython ({flags});"
            " the in-process ABI (c) ran instead")
    else:
        phase_c_host(native_build)

    # e. checkpoint and resume on the fused engine
    whole = deconvolve(psi_d, data, ITERS, lam=LAM, min_value=MIN_VALUE, algorithm="auto").cpu()
    kw = dict(lam=LAM, min_value=MIN_VALUE, checkpoint_every=5, algorithm="auto")
    with tempfile.TemporaryDirectory() as tmp:
        mgr = ckpt.CheckpointManager(os.path.join(tmp, "run"))
        reset_counts()
        t0 = time.perf_counter()
        got = ckpt.deconvolve_checkpointed(psi0, data, ITERS, mgr, **kw)
        torch.cuda.synchronize()
        counts = read_counts()
        log(f"deconvolve_checkpointed, 2 chunks of 5: {time.perf_counter() - t0:.3f} s,"
            f" launches {counts}")
        if not all(counts[k] > 0 for k in ("pass_a", "pass_b", "pass_cqa", "pass_cu")):
            raise AssertionError(f"checkpointed run did not take the fused engine: {counts}")
        same_or_close("checkpointed vs uninterrupted", got.cpu(), whole)
        os.remove(mgr.path(ITERS - 1))
        if mgr.latest()[0] != 4:
            raise AssertionError("psi_4 is not the newest snapshot after deleting psi_9")
        same_or_close("resumed from psi_4 vs uninterrupted",
                      ckpt.deconvolve_checkpointed(psi0, data, ITERS, mgr, **kw).cpu(), whole)
        real, calls = ckpt.deconvolve_checkpointed, []

        def flaky(p, d, n, m, **k):
            calls.append(n)
            if len(calls) == 1:
                real(p, d, 5, m, **k)
                raise RuntimeError("injected failure after the first chunk")
            return real(p, d, n, m, **k)

        ckpt.deconvolve_checkpointed = flaky
        try:
            got = ckpt.deconvolve_resilient(psi0, data, ITERS, ckpt.CheckpointManager(
                os.path.join(tmp, "resilient")), **kw)
        finally:
            ckpt.deconvolve_checkpointed = real
        if len(calls) != 2:
            raise AssertionError(f"deconvolve_resilient made {len(calls)} attempts, expected 2")
        same_or_close("resilient (one failure) vs uninterrupted", got.cpu(), whole)

    # f. debug_context on the card: K2's 0 * (1/0)
    zeros = torch.zeros(shape, device=dev)
    if not bool(torch.isnan(ew.quotient(zeros, zeros)).all()):
        raise AssertionError("K2's quotient of zeros by zeros is not NaN")
    reset_counts()
    try:
        with debug_context():
            ew.quotient(zeros, zeros)
        raise AssertionError("debug_context did not raise on K2's NaN")
    except FloatingPointError as exc:
        log(f"debug_context: {exc!r} (K2 launches {read_counts()['quotient']}); outside it"
            " the same call returns NaN")

    # g. the CLI, where imageio is installed
    if importlib.util.find_spec("imageio") is None:
        log("CLI not run: imageio is not installed here, so cli.main cannot read a TIFF;"
            " its engine calls are phases 10 and 23's")
    else:
        phase_cli(torch, dev)
    log(f"phase 25 took {time.perf_counter() - t_phase:.1f} s")


# Put first on the C host's PYTHONPATH: at interpreter exit (mvn_tpu_finalize)
# it prints the kernels' launch counts, then it runs the sitecustomize it
# shadows, if there is one.
C_HOST_SITECUSTOMIZE = """
import atexit, importlib.machinery, importlib.util, os, sys


def _report():
    ew = sys.modules.get("libmultiviewnative_torch.ops.elementwise")
    print("kernel launches", dict(ew.launches) if ew else {}, flush=True)


atexit.register(_report)
_here = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.machinery.PathFinder.find_spec(
    "sitecustomize", [p for p in sys.path if os.path.abspath(p or ".") != _here])
if _spec is not None:
    _spec.loader.exec_module(importlib.util.module_from_spec(_spec))
"""


def phase_c_host(native_build):
    """abi_smoke --gpu in a subprocess: it must exit 0, print OK, finite=1
    and changed=1, and its interpreter must have launched K1-K3 (2 views x 2
    iterations, and one convolution)."""
    import ast
    import tempfile

    t0 = time.perf_counter()
    exe = native_build.build_smoke()
    log(f"C host smoke built in {time.perf_counter() - t0:.2f} s")
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "sitecustomize.py"), "w") as f:
            f.write(C_HOST_SITECUSTOMIZE)
        env = native_build.smoke_env(os.path.dirname(os.path.abspath(__file__)),
                                     [tmp] + sys.path)
        t0 = time.perf_counter()
        res = subprocess.run([str(exe), "--gpu"], env=env, capture_output=True, text=True,
                             timeout=300)
    log(f"C host smoke --gpu: rc {res.returncode} in {time.perf_counter() - t0:.2f} s\n"
        + res.stdout.strip())
    if res.returncode != 0 or not all(s in res.stdout for s in ("OK", "finite=1", "changed=1")):
        raise AssertionError(f"C host smoke failed: rc {res.returncode}\n{res.stderr[-3000:]}")
    counts = [ast.literal_eval(line.split("kernel launches", 1)[1].strip())
              for line in res.stdout.splitlines() if line.startswith("kernel launches")]
    want = {"rl_update": 4, "quotient": 4, "spectral_multiply": 9}
    if counts != [want]:
        raise AssertionError(f"C host: kernel launches {counts}, expected [{want}]")



MESH_TOL = (2e-5, 2e-4)  # rtol, atol: tests/test_multihost.py's gate


def within(out, ref, what):
    """Hold ``out`` against ``ref`` at MESH_TOL; log and raise outside it."""
    rtol, atol = MESH_TOL
    excess = float(((out - ref).abs() - (atol + rtol * ref.abs())).max())
    rel = float((out - ref).abs().max()) / float(ref.abs().max())
    log(f"{what}: max|diff|/max|ref| {rel:.3e}, within rtol {rtol:g}, atol {atol:g}: {excess <= 0}")
    if not excess <= 0:
        raise AssertionError(f"{what}: disagrees with in-core beyond rtol {rtol:g}, atol {atol:g}")
    return rel


def card_line():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return smi.stdout.strip().splitlines()[0]


def mesh_counts(engine, full_volume, zp, views, iters):
    """The kernel launches of one mesh call: per cell and view step, two
    z-block convolves (fft: K3 twice; fused: K4, K6, K7 each), K2 and K1;
    with one z block on the fused engine, the fused step (K4, K6, K8, K6,
    K9).  Every cell holds a z block of each of its views, so a call makes
    zp·V view steps an iteration.  The fused spectra: one z-sparse forwarding
    (a gather, one K4, a contraction) per kernel, shared by the cells of one
    device."""
    steps = zp * views * iters
    if engine == "fft":
        return {"rl_update": steps, "quotient": steps, "spectral_multiply": 2 * steps}
    if full_volume:
        return {"pass_a": steps + 2 * views, "pass_b": 2 * steps, "pass_cqa": steps,
                "pass_cu": steps, **forwarded(2 * views)}
    return {"pass_a": 2 * steps + 2 * views, "pass_b": 2 * steps, "pass_c": 2 * steps,
            "quotient": steps, "rl_update": steps, **forwarded(2 * views)}


def phase_mesh(torch, dev, rng):
    """The ('view', 'z') mesh of parallel/ on one card: every cell is the
    card (a device repeats in make_mesh's list), so this shows the mesh
    layer's results and its own cost, not scaling."""
    import io
    import socket

    import torch.distributed as tdist

    from libmultiviewnative_torch.core.dft import dft_convolve_spectrum, kernel_spectrum_split
    from libmultiviewnative_torch.core.convolve import convolve_spectrum
    from libmultiviewnative_torch.core.fft import rfft3
    from libmultiviewnative_torch.core.shapes import halo_widths
    from libmultiviewnative_torch.core.wrap import wrap_kernel
    from libmultiviewnative_torch.deconv import dispatch
    from libmultiviewnative_torch.deconv.rl import deconvolve
    from libmultiviewnative_torch.deconv.workspace import MultiViewData
    from libmultiviewnative_torch.ops.fused import fused_convolve_transposed, kernel_spectrum_fused
    from libmultiviewnative_torch.parallel import distributed as pdist, halo, sharded

    out = {"card": card_line()}
    log(f"# phase 26: the mesh on one card ({out['card']}); every cell is {dev}")

    # a. topology, and one all_reduce over NCCL at world size 1
    topo = pdist.describe_topology()
    log(f"topology: {json.dumps(topo)}")
    if (topo["process_count"], topo["local_devices"][:1], topo["platform"]) != (1, ["cuda:0"], "cuda"):
        raise AssertionError(f"describe_topology: {topo}")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(dev)
    pdist.initialize_multihost(f"127.0.0.1:{port}", 1, 0, backend="nccl")
    try:
        mesh = sharded.make_mesh(1, 1, devices=[dev])
        got = sharded.view_sum({(0, 0): torch.full((1024,), 3.0, device=dev)}, mesh)[(0, 0)]
        torch.cuda.synchronize()
        log(f"NCCL world size {tdist.get_world_size()}: view_sum through all_reduce on"
            f" {tdist.get_backend()} gives {float(got[0])} (want 3.0)")
        if not bool((got == 3.0).all()):
            raise AssertionError("view_sum over NCCL at world size 1 changed the block")
    finally:
        tdist.destroy_process_group()

    # b. the z-block convolves of a 1x4 mesh at the headline's shapes
    n = HEADLINE_N
    shape = (n,) * 3
    _, k2 = bench_kernels()
    k = torch.from_numpy(k2[0]).to(dev)  # 25^3: lo = hi = 12
    (lo, _, _), (hi, _, _) = halo_widths(tuple(k.shape))
    x = torch.from_numpy(rng.gamma(2.0, 20.0, shape).astype(np.float32)).to(dev)
    mesh = sharded.make_mesh(1, 4, devices=[dev] * 4)
    local = (n // 4, n, n)
    log(f"z-block convolves on a 1x4 mesh: Bz {local[0]}, halo {lo}+{hi}, fused extent"
        f" {halo.zblock_fused_extent(local[0], lo, hi)}")
    xt = x.transpose(1, 2).contiguous()
    cases = {
        "fft": (lambda: convolve_spectrum(x, rfft3(wrap_kernel(k, shape))),
                lambda b: halo.convolve_zblock(b, halo.zblock_kernel_spectrum(k, local), lo, hi,
                                               mesh), x, {"spectral_multiply": 4}),
        "dft": (lambda: dft_convolve_spectrum(x, *kernel_spectrum_split(k, shape)),
                lambda b: halo.convolve_zblock_dft(b, halo.zblock_kernel_spectrum_split(k, local),
                                                   lo, hi, mesh), x, {}),
        "fused": (lambda: fused_convolve_transposed(xt, *kernel_spectrum_fused(k, shape)),
                  lambda b: halo.convolve_zblock_fused(b, halo.zblock_kernel_spectrum_fused(
                      k, local), lo, hi, mesh), xt, {"pass_a": 4, "pass_b": 4, "pass_c": 4}),
    }
    for engine, (whole, zblock, vol, want) in cases.items():
        ref = whole()
        blocks = sharded.shard_tensor(vol, mesh, sharded.PSI).blocks
        if engine == "fused":  # the spectrum's forwarding is counted apart
            spec = halo.zblock_kernel_spectrum_fused(k, local)
            zblock = lambda b: halo.convolve_zblock_fused(b, spec, lo, hi, mesh)  # noqa: E731
        torch.cuda.synchronize()
        reset_counts()
        res = zblock(blocks)
        torch.cuda.synchronize()
        counts = {key: c for key, c in read_counts().items() if c}
        got = sharded.MeshTensor(mesh, vol.shape, sharded.PSI, res).full()
        err = float((got - ref).abs().max()) / float(ref.abs().max())
        log(f"convolve_zblock {engine:5s}: max|diff|/max|in-core| {err:.3e} (tol 1e-5),"
            f" launches {counts}")
        if not err <= 1e-5:
            raise AssertionError(f"convolve_zblock ({engine}) disagrees with in-core: {err:.3e}")
        if engine != "dft" and counts != want:
            raise AssertionError(f"convolve_zblock ({engine}): launches {counts}, want {want}")
        del ref, got, res, blocks
    del x, xt
    torch.cuda.empty_cache()

    def run_mesh(vp, zp, data, psi0, iters, engine, order, lam=LAM):
        m = sharded.make_mesh(vp, zp, devices=[dev] * (vp * zp))
        psi_s, data_s = sharded.shard_workspace(data, psi0, m)
        torch.cuda.synchronize()
        reset_counts()
        res, secs = timed_call(torch, lambda: sharded.deconvolve_sharded(
            psi_s, data_s, iters, m, lam=lam, min_value=MIN_VALUE, algorithm=engine,
            view_order=order))
        counts = {key: c for key, c in read_counts().items() if c}
        want = mesh_counts(engine, zp == 1, zp, data.num_views, iters)
        log(f"mesh {vp}x{zp} {engine:5s} {order}: {secs:.3f} s for {iters} iterations,"
            f" launches {counts}")
        if counts != want:
            raise AssertionError(f"mesh {vp}x{zp} {engine}: launches {counts}, want {want}")
        return res.full(dev)

    # c. bench config 1 in the simultaneous order on 2x2 and 4x1 meshes
    data, psi0 = headline_data(torch, dev, rng)
    log(f"bench config 1, simultaneous: 4 views at {n}^3, per-voxel weights 1/V, lam {LAM},"
        f" {ITERS} iterations")
    for engine in ("fft", "fused"):
        ref = deconvolve(psi0, data, ITERS, lam=LAM, min_value=MIN_VALUE,
                         view_order="simultaneous", algorithm=engine)
        for vp, zp in ((2, 2), (4, 1)):
            res = run_mesh(vp, zp, data, psi0, ITERS, engine, "simultaneous")
            check_output(torch, res, shape, f"mesh {vp}x{zp} {engine}")
            out[f"sim_{vp}x{zp}_{engine}"] = within(res, ref, f"mesh {vp}x{zp} {engine} vs in-core")
        del ref, res
        torch.cuda.empty_cache()

    # e. the mesh layer's own cost: a 1x1 mesh against in-core, sequential
    log(f"mesh layer cost at {n}^3 (sequential, {ITERS} iterations) on {out['card']}: one card"
        " shows the layer's overhead, not scaling")
    m11 = sharded.make_mesh(1, 1, devices=[dev])
    psi_11, data_11 = sharded.shard_workspace(data, psi0, m11)
    for engine in ("fft", "fused"):
        def incore(k):
            return deconvolve(psi0, data, k, lam=LAM, min_value=MIN_VALUE, algorithm=engine)

        def on_mesh(k):
            return sharded.deconvolve_sharded(psi_11, data_11, k, m11, lam=LAM,
                                              min_value=MIN_VALUE, algorithm=engine,
                                              view_order="sequential")

        within(on_mesh(ITERS).full(dev), incore(ITERS), f"mesh 1x1 {engine} vs in-core")
        r_in, r_mesh = rate(torch, incore, reps=3), rate(torch, on_mesh, reps=3)
        r_in2 = rate(torch, incore, reps=3)
        log(f"mesh 1x1 {engine}: {r_mesh[0]!r} it/s (slope {r_mesh[1]!r}); in-core"
            f" {r_in[0]!r} and {r_in2[0]!r} it/s (slopes {r_in[1]!r}, {r_in2[1]!r}); ratio"
            f" {r_mesh[0] / max(r_in[0], r_in2[0]):.4f} ({out['card']})")
        out[f"cost_{engine}"] = {"mesh_its": r_mesh[0], "incore_its": [r_in[0], r_in2[0]],
                                 "mesh_slope": r_mesh[1], "incore_slope": [r_in[1], r_in2[1]]}

    # f. the ladder: two "devices" (the card twice), in-core refused
    saved = (dispatch.mesh_device_count, dispatch.mesh_devices)
    dispatch.mesh_device_count = lambda: 2
    dispatch.mesh_devices = lambda k: [dev] * k
    try:
        capacity = dispatch.device_capacity_bytes(dev)
        est = dispatch.estimate_workspace_bytes(data, "auto", dev)
        cell = dispatch._zonly_cell_bytes(data, "auto", 2, dev)
        headroom = (est + cell) / 2 / capacity
        lines = io.StringIO()
        with knobs(LMVN_TRACE="1"), contextlib.redirect_stdout(lines):
            res = dispatch.deconvolve_auto(psi0, data, 3, lam=LAM, min_value=MIN_VALUE,
                                           headroom=headroom, device=dev)
        trace = [ln for ln in lines.getvalue().splitlines() if ln.startswith("[lmvn-trace]")]
        log(f"ladder headroom {headroom:.5f} (in-core est {est >> 20} MiB, z-only cell"
            f" {cell >> 20} MiB): " + " | ".join(trace))
        if not any("sequential parity on z-only mesh {'view': 1, 'z': 2}" in ln for ln in trace):
            raise AssertionError("deconvolve_auto did not take the z-only mesh rung")
        ref = deconvolve(psi0, data, 3, lam=LAM, min_value=MIN_VALUE, algorithm="auto")
        out["ladder_zonly"] = within(res, ref, "ladder z-only rung vs in-core")
    finally:
        dispatch.mesh_device_count, dispatch.mesh_devices = saved
    del data, psi0, data_11, psi_11, res, ref
    torch.cuda.empty_cache()

    # d. bench config 3 in the sequential order on a 1x2 z-only mesh, 512^3
    big, psi_big = big_data(torch, dev, rng)
    big = MultiViewData(big.views, big.kernel1, torch.flip(big.kernel1, dims=(-3, -2, -1)),
                        big.weights)
    log(f"bench config 3, sequential: 4 views at {BIG_N}^3, kernel2 = flipped kernel1, scalar"
        " weights 1/V, 2 iterations, on a 1x2 z-only mesh (fused extent"
        f" {halo.zblock_fused_extent(BIG_N // 2, 10, 10)})")
    for engine in ("fft", "fused"):
        ref = deconvolve(psi_big, big, 2, lam=LAM, min_value=MIN_VALUE, algorithm=engine)
        torch.cuda.reset_peak_memory_stats(dev)
        res = run_mesh(1, 2, big, psi_big, 2, engine, "sequential")
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        check_output(torch, res, (BIG_N,) * 3, f"mesh 1x2 {engine}")
        out[f"seq_1x2_{engine}"] = within(res, ref, f"mesh 1x2 {engine} {BIG_N}^3 vs in-core")
        log(f"mesh 1x2 {engine} {BIG_N}^3: peak device memory {peak:.2f} GiB"
            " (max_memory_allocated, in-core data and reference included)")
        out[f"peak_gib_1x2_{engine}"] = peak
        del ref, res
        torch.cuda.empty_cache()
    log("mesh: " + json.dumps(out))
    return out


# a batched call's entries against the single-volume calls: the fft engine's
# sequential order transforms a batch one entry at a time (core/convolve.py),
# so bitwise is expected and 1e-6 of max|psi| is the gate; the dft and direct
# engines and the simultaneous order transform the batch at once (cuBLAS's and
# cuDNN's algorithms for the batch, per-view transforms in place of the
# V-batched ones), whose sums may run in another order: 1e-5, as the fused
# passes against their plain versions
BATCH_TOL = 1e-6
BATCHED_TRANSFORM_TOL = 1e-5


def hold_batch(torch, what, batched, singles, shape, tol=BATCH_TOL):
    """The worst entry b of max|batched[b] - singles[b]| / max|singles[b]|,
    held to ``tol``; logs whether every entry is bitwise its single call."""
    check_output(torch, batched, shape, what)
    err = max(float((batched[b] - one).abs().max()) / float(one.abs().max())
              for b, one in enumerate(singles))
    bitwise = all(bool(torch.equal(batched[b], one)) for b, one in enumerate(singles))
    log(f"{what}: worst entry against its single-volume call max|diff|/max|psi| = {err:.3e}"
        f" (gate {tol:g}), bitwise {bitwise}")
    if not err <= tol:
        raise AssertionError(f"{what}: an entry disagrees with its single-volume call: {err:.3e}")
    return err


def phase_batched(torch, dev, rng):
    """Phase 27: batches of volumes (F9).  BATCH volumes of the headline
    configuration in one ``deconvolve(algorithm="fft")`` call (the batched
    fft path), each entry against the single-volume fft call on it,
    the launches of one call (K1 40, K2 40, K3 80: one launch covers the
    batch), volumes per second against BATCH single calls in turns (batched,
    single, single, batched; single calls on fft, and inside them on fused,
    which ``"auto"`` gives one volume) and the peak memory; then the same
    batch through ``deconvolve_auto``, which gives it the fused engine of one
    volume: one forwarding, BATCH times one volume's passes, each entry
    bitwise the single fused call on it; then BATCH_SMALL volumes at
    BATCH_N³ with (V, B, Z, Y, X) views through the simultaneous order, the
    dft and direct engines, ``deconvolve_auto`` and ``RichardsonLucy.run``."""
    import io

    from libmultiviewnative_torch.deconv import rl
    from libmultiviewnative_torch.deconv.dispatch import deconvolve_auto
    from libmultiviewnative_torch.deconv.workspace import MultiViewData
    from libmultiviewnative_torch.models import RichardsonLucy

    shape = (HEADLINE_N,) * 3
    log(f"# phase 27: batched volumes, {BATCH} x the headline ({V} views at {HEADLINE_N}^3,"
        f" shared views and per-voxel weights, lam {LAM}, {ITERS} iterations)")
    data, psi_one = headline_data(torch, dev, rng)
    # one start per entry, so that the entries differ
    psi0 = torch.stack([psi_one * (1.0 + 0.05 * b) for b in range(BATCH)])
    engine = "fft"
    log(f"algorithm='auto' on a batch or one volume resolves to "
        f"{rl.resolve_algorithm('auto', shape, dev)!r}; this phase runs the batched fft path")

    def batched():
        return rl.deconvolve(psi0, data, ITERS, lam=LAM, min_value=MIN_VALUE, algorithm=engine)

    def singles(algorithm=engine):
        # the engine the batch ran; "auto" gives one volume the fused engine
        return [rl.deconvolve(psi0[b], data, ITERS, lam=LAM, min_value=MIN_VALUE,
                              algorithm=algorithm) for b in range(BATCH)]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    reset_counts()
    out = batched()
    torch.cuda.synchronize()
    counts = read_counts()
    peak = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
    expect_counts(counts, {"rl_update": V * ITERS, "quotient": V * ITERS,
                           "spectral_multiply": 2 * V * ITERS},
                  f"deconvolve of {BATCH} volumes at {HEADLINE_N}^3")
    result = {"launches": counts, "peak_gib_above_inputs": peak}
    result["worst_entry"] = hold_batch(torch, f"batch of {BATCH} at {HEADLINE_N}^3", out,
                                       singles(), (BATCH,) + shape)
    del out
    # turns batched, single, single, batched; the single calls on fft (the
    # batch's engine) and on fused ("auto" for one volume) inside them
    times = {"batched": [], "single": [], "single_fused": []}
    calls = {"batched": batched, "single": singles, "single_fused": lambda: singles("fused")}
    for turn in ("batched", "single", "single_fused", "single_fused", "single", "batched"):
        _, sec = timed_call(torch, calls[turn])
        times[turn].append(sec)
    vps = {k: [BATCH / t for t in v] for k, v in times.items()}
    ratio = statistics.median(vps["batched"]) / statistics.median(vps["single"])
    log(f"volumes/s at {HEADLINE_N}^3, {ITERS} iterations: batched call {vps['batched']!r},"
        f" {BATCH} single calls on fft {vps['single']!r} (ratio of the medians {ratio:.4f}), on"
        f" fused {vps['single_fused']!r}; peak device memory of the batched call {peak:.3f} GiB"
        f" above its inputs ({card_line()})")
    result["volumes_per_s"] = vps

    # the main path: "auto" gives the batch the fused engine of one volume,
    # the kernel stacks forwarded once, then each entry through the passes
    lines = io.StringIO()
    torch.cuda.synchronize()
    reset_counts()
    with knobs(LMVN_TRACE="1"), contextlib.redirect_stdout(lines):
        out = deconvolve_auto(psi0, data, ITERS, lam=LAM, min_value=MIN_VALUE, device=dev)
    torch.cuda.synchronize()
    steps = BATCH * V * ITERS
    expect_counts(read_counts(), {"pass_a": steps + 2, "pass_b": 2 * steps, "pass_cqa": steps,
                                  "pass_cu": steps, **forwarded(2)},
                  f"deconvolve_auto of {BATCH} volumes at {HEADLINE_N}^3")
    trace = [ln for ln in lines.getvalue().splitlines() if ln.startswith("[lmvn-trace]")]
    log("deconvolve_auto on the batch: " + " | ".join(trace))
    if not any(f"a batch of {BATCH} on fused" in ln for ln in trace):
        raise AssertionError(f"deconvolve_auto did not run the batch of {BATCH} on fused")
    # gate 0: each entry bitwise its single fused call
    result["auto_fused_worst_entry"] = hold_batch(
        torch, f"deconvolve_auto batch of {BATCH} at {HEADLINE_N}^3 on fused", out,
        singles("fused"), (BATCH,) + shape, tol=0.0)
    del data, psi0, psi_one, out
    torch.cuda.empty_cache()

    # BATCH_SMALL volumes at BATCH_N³ with per-entry views (V, B, Z, Y, X)
    small = (BATCH_N,) * 3
    k1, k2 = bench_kernels()
    views = torch.from_numpy(
        rng.gamma(2.0, 20.0, (V, BATCH_SMALL) + small).astype(np.float32)).to(dev)
    data = MultiViewData(views, torch.from_numpy(k1).to(dev), torch.from_numpy(k2).to(dev),
                         torch.full((V,) + small, 1.0 / V, device=dev))
    psi0 = views.mean(dim=0)
    one = [MultiViewData(views[:, b].contiguous(), data.kernel1, data.kernel2, data.weights)
           for b in range(BATCH_SMALL)]
    kw = dict(lam=LAM, min_value=MIN_VALUE)
    for engine, order in (("fft", "sequential"), ("fft", "simultaneous"), ("dft", "sequential"),
                          ("direct", "sequential")):
        reset_counts()
        out = rl.deconvolve(psi0, data, BATCH_ITERS, algorithm=engine, view_order=order, **kw)
        torch.cuda.synchronize()
        # one launch of K1 and K2 a view step, of K3 a product, for the batch;
        # the simultaneous order takes a batch one view at a time (2V K3)
        steps = V * BATCH_ITERS
        expect_counts(read_counts(), {"rl_update": steps, "quotient": steps,
                                      "spectral_multiply": 2 * steps if engine == "fft" else 0},
                      f"{engine} {order}, {BATCH_SMALL} x {BATCH_N}^3, (V, B, Z, Y, X) views")
        refs = [rl.deconvolve(psi0[b], one[b], BATCH_ITERS, algorithm=engine, view_order=order,
                              **kw) for b in range(BATCH_SMALL)]
        per_entry = engine == "fft" and order == "sequential"
        result[f"{engine}_{order}"] = hold_batch(
            torch, f"{engine} {order} {BATCH_SMALL} x {BATCH_N}^3", out, refs,
            (BATCH_SMALL,) + small, BATCH_TOL if per_entry else BATCHED_TRANSFORM_TOL)
    lines = io.StringIO()
    with knobs(LMVN_TRACE="1"), contextlib.redirect_stdout(lines):
        auto = deconvolve_auto(psi0, data, BATCH_ITERS, device=dev, **kw)
    trace = [ln for ln in lines.getvalue().splitlines() if ln.startswith("[lmvn-trace]")]
    log("deconvolve_auto on the batch: " + " | ".join(trace))
    if not any("dispatch: in-core on one device" in ln for ln in trace):
        raise AssertionError("deconvolve_auto did not serve the batch in-core")
    refs = [rl.deconvolve(psi0[b], one[b], BATCH_ITERS, algorithm="fft", **kw)
            for b in range(BATCH_SMALL)]
    result["deconvolve_auto"] = hold_batch(torch, "deconvolve_auto batch", auto, refs,
                                           (BATCH_SMALL,) + small)
    model = RichardsonLucy(num_iterations=BATCH_ITERS, lambda_=LAM, min_value=MIN_VALUE,
                           device=dev)
    same = bool(torch.equal(model.run(data, psi0), auto))
    log(f"RichardsonLucy().run on the batch equals deconvolve_auto bit for bit: {same}")
    if not same:
        raise AssertionError("RichardsonLucy().run on a batch differs from deconvolve_auto")
    log("batched: " + json.dumps(result))
    return result


def bf16_steps(torch, got, ref):
    """(worst |got - ref| over its one-bf16-step allowance BF16_STEP·max(|got|,
    |ref|) + BF16_FLOOR·max|ref|, max|got - ref|, max|ref|) over a bf16
    spectrum pair and its plain version; both must be finite."""
    torch.cuda.synchronize()
    g = torch.cat([x.float().flatten() for x in got])
    r = torch.cat([x.float().flatten() for x in ref])
    if not (bool(torch.isfinite(g).all()) and bool(torch.isfinite(r).all())):
        raise AssertionError("a bf16 spectrum holds non-finite values")
    diff = (g - r).abs()
    scale = float(r.abs().max())
    lim = BF16_STEP * torch.maximum(g.abs(), r.abs()) + BF16_FLOOR * scale
    return float((diff / lim).max()), float(diff.max()), scale


def hold_bf16_twin(torch, name, label, kernel, plain, f32_kernel, split, atol):
    """Hold one bf16-storage pass against its plain version on the same bf16
    inputs: a spectrum it writes within one bf16 step elementwise
    (:func:`bf16_steps`), a volume it writes within FUSED_TOLERANCE (+
    ``atol``).  Hold it also bit for bit against its f32 entry on the
    widened inputs (``f32_kernel``, under the knob's "0"), whose spectrum is
    rounded once to nearest even: the twin differs from that entry only in
    its loads and stores.  ``split(out)`` is (volumes, spectrum pair or
    ()).  Returns (max_abs_err, worst bf16 steps)."""
    with knobs(LMVN_FUSED_SPEC_BF16="1"):
        vols, spec = (tuple(t.clone() for t in part) for part in split(kernel()))
    with knobs(LMVN_FUSED_SPEC_BF16="0"):
        f32_vols, f32_spec = split(f32_kernel())
        twin = (all(torch.equal(g, r) for g, r in zip(vols, f32_vols))
                and all(torch.equal(g, r.to(torch.bfloat16)) for g, r in zip(spec, f32_spec)))
    if not twin:
        raise AssertionError(f"{name} {label}: not bitwise its f32 entry, rounded once")
    del f32_vols, f32_spec
    ref_vols, ref_spec = split(plain())
    abs_err, worst = 0.0, 0.0
    for g, r in zip(vols, ref_vols):
        err, scale = compare(torch, f"{name} {label}", g, r)
        if not err <= FUSED_TOLERANCE * scale + atol:
            raise AssertionError(f"{name} {label}: volume error {err:.3e} beyond tolerance")
        abs_err = max(abs_err, err)
    if spec:
        if any(t.dtype != torch.bfloat16 for t in spec):
            raise AssertionError(f"{name} {label}: the spectrum it wrote is not bf16")
        worst, err, scale = bf16_steps(torch, spec, ref_spec)
        if not worst <= 1.0:
            raise AssertionError(f"{name} {label}: {worst:.3f} bf16 steps from its plain version")
        abs_err = max(abs_err, err)
    return abs_err, worst


def check_bf16_kernel(torch, records, name, label, kernel, plain, f32_kernel, nbytes, ops,
                      size, split, atol):
    """:func:`hold_bf16_twin`, then time the bf16 kernel, its plain version
    and the f32 kernel in turns (plain, bf16, f32, f32, bf16, plain; medians
    of 20 CUDA-event launches each) and keep the record under ``name`` with
    its bf16 byte bound."""
    abs_err, worst = hold_bf16_twin(torch, name, label, kernel, plain, f32_kernel, split, atol)
    samples = {fn: [] for fn in (plain, kernel, f32_kernel)}
    for fn in (plain, kernel, f32_kernel, f32_kernel, kernel, plain):
        with knobs(LMVN_FUSED_SPEC_BF16="0" if fn is f32_kernel else "1"):
            samples[fn] += event_times_ms(torch, fn)
    ms, plain_ms, f32_ms = (statistics.median(samples[fn]) for fn in (kernel, plain, f32_kernel))
    log(f"{name:17s} {label:34s} max_abs_err {abs_err:.3e}, worst {worst:.3f} bf16 steps,"
        f" bitwise its f32 entry rounded; bf16 {ms:.4f} ms {nbytes / ms / 1e6:8.1f} GB/s"
        f" | f32 kernel {f32_ms:.4f} ms (bf16 at {f32_ms / ms:.3f}x) | plain {plain_ms:.4f} ms")
    rec = records.setdefault(name, {"max_abs_err": 0.0})
    rec["max_abs_err"] = max(rec["max_abs_err"], abs_err)
    keep_timing(records, name, size, (ms, plain_ms, None), nbytes, ops)
    entry = rec if size == HEADLINE_N else rec["512"]
    entry.update(f32_ms=f32_ms, bf16_steps=worst)


def time_in_turns(torch, label, bf16_fn, f32_fn):
    """Median CUDA-event ms of one call with bf16 and with f32 storage, in
    turns f32, bf16, bf16, f32; logged, not recorded."""
    samples = {"0": [], "1": []}
    for knob in "0110":
        with knobs(LMVN_FUSED_SPEC_BF16=knob):
            samples[knob] += event_times_ms(torch, bf16_fn if knob == "1" else f32_fn)
    f32_ms, ms = (statistics.median(samples[k]) for k in "01")
    log(f"{label}: bf16 {ms:.4f} ms, f32 {f32_ms:.4f} ms (bf16 at {f32_ms / ms:.3f}x)")


def phase_bf16_kernels(torch, dev, records):
    """28 a: K4-K10 in bf16 storage against their plain versions and their
    f32 entries, 256³ and 512³; K5 and K6 also timed on random spectra."""
    from libmultiviewnative_torch.core.wrap import wrap_kernel
    from libmultiviewnative_torch.ops import fused as fu
    from libmultiviewnative_torch.ops.fused_plan import make_fused_plan

    log("# phase 28 a: K4-K10 with bf16 spectra (LMVN_FUSED_SPEC_BF16) vs their plain versions")
    check_fp32_matmuls(torch)
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(28)
    k1, _ = bench_kernels()
    kernel = torch.from_numpy(k1[0]).to(dev)

    def rand(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    def wide(pair):
        return tuple(t.float() for t in pair)

    spectrum = lambda o: ((), o)  # noqa: E731
    volume = lambda o: ((o,), ())  # noqa: E731
    both = lambda o: ((o[0],), o[1])  # noqa: E731
    for size in (HEADLINE_N, BIG_N):
        shape = (size,) * 3
        Z, Y, X = shape
        label = "x".join(map(str, shape))
        plan = make_fused_plan(shape)
        c = fu.plan_tensors(plan, dev)
        psi = rand((Z, X, Y), 1.0, 100.0)
        view = rand((Z, X, Y), 1.0, 200.0)
        conj = size == BIG_N
        weights = 0.25 if conj else rand((Z, X, Y), 0.0, 0.5)
        with knobs(LMVN_FUSED_SPEC_BF16="1"):
            k16 = fu.kernel_spectrum_fused(kernel, shape)
        u16 = fu.pass_a_plain(psi, c, bf16)
        v16 = fu.pass_b_plain(*u16, *k16, c, conj, bf16)
        uk16 = fu.pass_a_plain(wrap_kernel(kernel, shape).transpose(1, 2).contiguous(), c, bf16)
        k32, u32, v32, uk32 = map(wide, (k16, u16, v16, uk16))
        buf16 = tuple(torch.empty_like(t) for t in u16)
        buf32 = tuple(torch.empty_like(t) for t in u32)
        out = torch.empty_like(psi)
        # bytes the functions need at 2 bytes a stored spectral value: a
        # spectrum input's Kx rows, a spectrum output's Kxp rows
        vol, spec, spec_in = 4 * psi.numel(), 4 * u16[0].numel(), 4 * plan.kxh * Z * Y
        w_vols = 2 if conj else 3
        flops = fused_flops(plan)
        w_label = f"{'scalar' if conj else 'voxel'}-w lam={LAM}"
        checks = (
            ("pass_a", label, lambda: fu.pass_a(psi, plan, out=buf16),
             lambda: fu.pass_a_plain(psi, c, bf16),
             lambda: fu.pass_a(psi, plan, out=buf32), vol + spec, spectrum, 0.0),
            ("pass_bf", f"{label} kernel1 21^3", lambda: fu.pass_bf(*uk16, plan),
             lambda: fu.pass_bf_plain(*uk16, c, bf16),
             lambda: fu.pass_bf(*uk32, plan), spec_in + spec, spectrum, 0.0),
            ("pass_b", f"{label} conj={conj}",
             lambda: fu.pass_b(*u16, *k16, plan, conj_k=conj, out=buf16),
             lambda: fu.pass_b_plain(*u16, *k16, c, conj, bf16),
             lambda: fu.pass_b(*u32, *k32, plan, conj_k=conj, out=buf32),
             2 * spec_in + spec, spectrum, 0.0),
            ("pass_c", label, lambda: fu.pass_c(*v16, plan), lambda: fu.pass_c_plain(*v16, c),
             lambda: fu.pass_c(*v32, plan), spec_in + vol, volume, 0.0),
            ("pass_cqa", label, lambda: fu.pass_cqa(*v16, view, plan, out=buf16),
             lambda: fu.pass_cqa_plain(*v16, view, c, bf16),
             lambda: fu.pass_cqa(*v32, view, plan, out=buf32),
             spec_in + vol + spec, spectrum, 0.0),
            ("pass_cu", f"{label} {w_label}",
             lambda: fu.pass_cu(*v16, psi, weights, plan, LAM, MIN_VALUE, out=out),
             lambda: fu.pass_cu_plain(*v16, psi, weights, c, LAM, MIN_VALUE),
             lambda: fu.pass_cu(*v32, psi, weights, plan, LAM, MIN_VALUE, out=out),
             spec_in + w_vols * vol, volume, tikhonov_atol(LAM)),
            ("pass_cua", f"{label} {w_label}",
             lambda: fu.pass_cua(*v16, psi, weights, plan, LAM, MIN_VALUE, out=out, u_out=buf16),
             lambda: fu.pass_cua_plain(*v16, psi, weights, c, LAM, MIN_VALUE, bf16),
             lambda: fu.pass_cua(*v32, psi, weights, plan, LAM, MIN_VALUE, out=out, u_out=buf32),
             spec_in + spec + w_vols * vol, both, tikhonov_atol(LAM)),
        )
        fu.reset_launches()
        for name, what, kernel_fn, plain_fn, f32_fn, nbytes, split, atol in checks:
            check_bf16_kernel(torch, records, f"{name}_bf16", what, kernel_fn, plain_fn, f32_fn,
                              nbytes, flops[name], size, split, atol)
        ran = {k: v for k, v in fu.launches.items() if v}
        if set(ran) != set(FUSED_PASSES + BF16_PASSES):
            raise AssertionError(f"phase 28 a {label}: launches {ran}")
        # the wrapped kernel's spectrum is zero in most z planes; K5 and K6
        # also on spectra with none (pass A of psi, a random kernel spectrum)
        kr16 = fu.pass_a_plain(rand((Z, X, Y), 1.0, 100.0), c, bf16)
        kr32 = wide(kr16)
        time_in_turns(torch, f"pass_bf_bf16      {label} on pass A of psi",
                      lambda: fu.pass_bf(*u16, plan), lambda: fu.pass_bf(*u32, plan))
        time_in_turns(torch, f"pass_b_bf16       {label} conj={conj} random K",
                      lambda: fu.pass_b(*u16, *kr16, plan, conj_k=conj, out=buf16),
                      lambda: fu.pass_b(*u32, *kr32, plan, conj_k=conj, out=buf32))
        del psi, view, k16, u16, v16, uk16, k32, u32, v32, uk32, kr16, kr32, buf16, buf32, out
        del weights
        torch.cuda.empty_cache()


def phase_bf16_main(torch, dev, rng, launches_out):
    """28 b-e: the main path with bf16 spectra beside the f32 one, the dense
    forwarding on request, the interleaved rung and a 1×1 mesh."""
    from libmultiviewnative_torch.deconv.dispatch import deconvolve_auto
    from libmultiviewnative_torch.deconv.interleaved import deconvolve_interleaved
    from libmultiviewnative_torch.deconv.rl import (
        FUSED_XMODE, PreparedSpectra, deconvolve, deconvolve_prepared, prepare_spectra_fused,
        prepare_workspace, rl_view_step_fused,
    )
    from libmultiviewnative_torch.ops import fused as fu
    from libmultiviewnative_torch.parallel import sharded

    out = {"card": card_line()}
    log(f"# phase 28 b: the main path with LMVN_FUSED_SPEC_BF16=1 beside f32 ({out['card']})")
    for label, make, kw, reps, n_fwd in (
        (f"{HEADLINE_N}^3", headline_data, {}, 4, 2),
        (f"{BIG_N}^3 adjoint", big_data, {"adjoint_kernel2": True}, 2, 1),
    ):
        data, psi0 = make(torch, dev, rng)
        shape = tuple(psi0.shape)
        steps = {"pass_b": 2 * V * ITERS, "pass_cqa": V * ITERS}
        prep = {}
        paths = (
            ("auto", lambda n: deconvolve_auto(psi0, data, n, lam=LAM, min_value=MIN_VALUE,
                                               device=dev, **kw),
             {"pass_a": V * ITERS + n_fwd, "pass_cu": V * ITERS, "spectrum_zsparse": n_fwd,
              **steps}, "0"),
            ("prepared", lambda n: deconvolve_prepared(psi0, data, prep["spectra"], n, lam=LAM,
                                                       min_value=MIN_VALUE),
             {"pass_a": V * ITERS, "pass_cu": V * ITERS, **steps}, "0"),
            ("carried", lambda n: deconvolve_auto(psi0, data, n, lam=LAM, min_value=MIN_VALUE,
                                                  device=dev, **kw),
             {"pass_a": n_fwd + 1, "pass_cua": V * ITERS, "spectrum_zsparse": n_fwd, **steps},
             "1"),
        )
        for path, run_n, want, carry in paths:
            res = {}
            for knob in ("0", "1"):
                with knobs(LMVN_FUSED_SPEC_BF16=knob, LMVN_FUSED_CARRY=carry):
                    if path == "prepared":
                        prep["spectra"] = prepare_workspace(data, shape, algorithm="fused",
                                                            adjoint_kernel2=bool(kw))
                    run_n(1)
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats(dev)
                    reset_counts()
                    got = run_n(ITERS)
                    torch.cuda.synchronize()
                    counts = read_counts()
                    peak = torch.cuda.max_memory_allocated(dev) / 2**30
                    sfx = "_bf16" if knob == "1" else ""
                    gathers = want.get("spectrum_zsparse", 0)  # the gather has one form
                    expect_counts(counts, {**{k + sfx: v for k, v in want.items()},
                                           **({"spectrum_gather": gathers} if gathers else {})},
                                  f"{label} {path} bf16={knob}")
                    check_output(torch, got, shape, f"{label} {path} bf16={knob}")
                    if knob == "1":
                        if label.startswith(str(HEADLINE_N)) and path == "auto":
                            launches_out.update({k: v for k, v in counts.items() if v})
                        elif label.startswith(str(HEADLINE_N)) and path == "carried":
                            launches_out["pass_cua_bf16"] = counts["pass_cua_bf16"]
                        again = run_n(ITERS)
                        if not torch.equal(again, got):
                            raise AssertionError(f"{label} {path}: a second bf16 call differs")
                        del again
                    value, slope = rate(torch, run_n, reps=reps)
                    res[knob] = (got, value, slope, peak)
                    log(f"{label} {path} bf16={knob}: {value!r} it/s, slope {slope!r} it/s,"
                        f" peak {peak:.3f} GiB")
            (p32, v32, s32, m32), (p16, v16, s16, m16) = res["0"], res["1"]
            d = p16 - p32
            max_rel = float(d.abs().max()) / float(p32.abs().max())
            l2 = float(torch.linalg.vector_norm(d)) / float(torch.linalg.vector_norm(p32))
            log(f"{label} {path}: bf16 against f32 after {ITERS} iterations: max-relative"
                f" {max_rel:.4e}, relative L2 {l2:.4e}; it/s {v16 / v32:.4f}x, slope"
                f" {s16 / s32:.4f}x, peak {m16:.3f} against {m32:.3f} GiB")
            if not (math.isfinite(max_rel) and math.isfinite(l2)):
                raise AssertionError(f"{label} {path}: non-finite difference")
            out[f"{label.split('^')[0]}_{path}"] = {
                "its": [v32, v16], "slope": [s32, s16], "peak_gib": [m32, m16],
                "max_rel": max_rel, "rel_l2": l2}
            del res, p32, p16, d
        prep.clear()
        if label.startswith(str(HEADLINE_N)):
            # one view step in bf16 against the f32 step: JAX's envelope
            psi_t = psi0.transpose(-1, -2).contiguous()
            view_t = data.views[0].transpose(-1, -2).contiguous()
            w_t = data.weights[0].transpose(-1, -2).contiguous()
            step = {}
            for knob in ("0", "1"):
                with knobs(LMVN_FUSED_SPEC_BF16=knob):
                    ks = [fu.kernel_spectrum_fused(k[0], shape) for k in (data.kernel1,
                                                                        data.kernel2)]
                    step[knob] = rl_view_step_fused(psi_t, view_t, *ks, w_t, LAM, MIN_VALUE)
            rel = float((step["1"] - step["0"]).abs().max()) / float(step["0"].abs().max())
            log(f"one view step at {label}, bf16 against f32: max-relative {rel:.4e}"
                f" (envelope {BF16_VIEW_STEP:g})")
            if not rel < BF16_VIEW_STEP:
                raise AssertionError(f"bf16 view step beyond the envelope: {rel:.3e}")
            out["view_step_rel"] = rel
            # the forwarding of the call's 8 spectra, in both storages
            forward = lambda: [prepare_spectra_fused(k, shape)  # noqa: E731
                               for k in (data.kernel1, data.kernel2)]
            time_in_turns(torch, f"forwarding of {2 * V} spectra at {label}", forward, forward)
            headline = (data, psi0)
        del data, psi0
        torch.cuda.empty_cache()

    data, psi0 = headline
    shape = tuple(psi0.shape)
    log(f"# phase 28 c: the dense forwarding at {shape} (f32), and {THIN_SHAPE} in bf16")
    reset_counts()
    dense = [[fu._spectrum_dense(k, shape) for k in ks] for ks in (data.kernel1, data.kernel2)]
    torch.cuda.synchronize()
    expect_counts(read_counts(), {"pass_a": 2 * V, "pass_bf": 2 * V}, f"dense forwarding {shape}")
    dense = [tuple(torch.stack(part) for part in zip(*ks)) for ks in dense]
    sparse = [prepare_spectra_fused(k, shape) for k in (data.kernel1, data.kernel2)]
    for which, dn, sp in zip(("kernel1", "kernel2"), dense, sparse):
        err, scale = compare(torch, f"dense vs sparse {which}", dn, sp)
        log(f"spectra {which} {shape}: dense against sparse max_abs_err {err:.3e} rel"
            f" {err / scale:.3e} (tol {FUSED_TOLERANCE:g})")
        if not err <= FUSED_TOLERANCE * scale:
            raise AssertionError(f"dense and sparse forwarding disagree for {which}")
    runs = [deconvolve_prepared(psi0, data, PreparedSpectra("fused", shape, *ks,
                                                            xmode=FUSED_XMODE),
                                ITERS, lam=LAM, min_value=MIN_VALUE) for ks in (dense, sparse)]
    rel = float((runs[0] - runs[1]).abs().max()) / float(runs[1].abs().max())
    log(f"{ITERS} iterations on the dense against the z-sparse spectra: max-relative {rel:.3e}"
        f" (tol {FUSED_TOLERANCE:g})")
    check_output(torch, runs[0], shape, "dense forwarding")
    if not rel <= FUSED_TOLERANCE:
        raise AssertionError(f"the run on the dense spectra differs: {rel:.3e}")
    out["dense_run_rel"] = rel
    del dense, sparse, runs
    thin, thin_psi0 = thin_data(torch, dev, rng)
    with knobs(LMVN_FUSED_SPEC_BF16="1"):
        reset_counts()
        got = deconvolve(thin_psi0, thin, ITERS, lam=LAM, min_value=MIN_VALUE, algorithm="fused")
        torch.cuda.synchronize()
        counts = read_counts()
        expect_counts(counts, {"pass_a_bf16": V * ITERS + 2 * V, "pass_bf_bf16": 2 * V,
                               "pass_b_bf16": 2 * V * ITERS, "pass_cqa_bf16": V * ITERS,
                               "pass_cu_bf16": V * ITERS}, f"bf16 {THIN_SHAPE}")
        launches_out["pass_bf_bf16"] = counts["pass_bf_bf16"]
    check_output(torch, got, THIN_SHAPE, f"bf16 {THIN_SHAPE}")
    del thin, thin_psi0, got
    torch.cuda.empty_cache()

    log(f"# phase 28 d: the interleaved rung with bf16 spectra, 4 views at {shape},"
        f" chunk_z {CHUNK_Z}, {BF16_ITERS} iterations")
    host = [list(x.cpu().numpy()) for x in (data.views, data.kernel1, data.kernel2, data.weights)]
    n_chunks = -(-shape[0] // CHUNK_Z)
    res = {}
    for knob in ("1", "0"):
        with knobs(LMVN_FUSED_SPEC_BF16=knob):
            def run():
                return deconvolve_interleaved(psi0.cpu().numpy(), *host, BF16_ITERS, lam=LAM,
                                              min_value=MIN_VALUE, chunk_z=CHUNK_Z,
                                              algorithm="fused", device=dev)
            reset_counts()
            res[knob] = run()
            counts = read_counts()
            if knob == "1":
                sfx, it = "_bf16", BF16_ITERS
                expect_counts(counts, {"pass_a" + sfx: 2 * V * it + 2, "pass_b" + sfx: 2 * V * it,
                                       "pass_c" + sfx: 2 * V * it, "quotient": V * it * n_chunks,
                                       "rl_update": V * it * n_chunks, **forwarded(2, sfx)},
                              "interleaved bf16")
                launches_out["pass_c_bf16"] = counts["pass_c_bf16"]
                if not (np.isfinite(res[knob]).all() and np.array_equal(run(), res[knob])):
                    raise AssertionError("interleaved bf16: not finite, or a second call differs")
    rel = float(np.abs(res["1"] - res["0"]).max() / np.abs(res["0"]).max())
    log(f"interleaved bf16 against f32 after {BF16_ITERS} iterations: max-relative {rel:.4e}")
    out["interleaved_max_rel"] = rel

    log(f"# phase 28 e: a 1x1 mesh with bf16 spectra against in-core, {BF16_ITERS} iterations")
    with knobs(LMVN_FUSED_SPEC_BF16="1"):
        mesh = sharded.make_mesh(1, 1, devices=[dev])
        psi_m, data_m = sharded.shard_workspace(data, psi0, mesh)
        reset_counts()
        got = sharded.deconvolve_sharded(psi_m, data_m, BF16_ITERS, mesh, lam=LAM,
                                         min_value=MIN_VALUE, algorithm="fused",
                                         view_order="sequential").full(dev)
        counts = read_counts()
        if counts["pass_cu_bf16"] != V * BF16_ITERS or any(counts[k] for k in FUSED_PASSES):
            raise AssertionError(f"mesh 1x1 bf16: launches {counts}")
        ref = deconvolve(psi0, data, BF16_ITERS, lam=LAM, min_value=MIN_VALUE, algorithm="fused")
        out["mesh_1x1_rel"] = within(got, ref, "mesh 1x1 bf16 vs in-core")
        log(f"mesh 1x1 bf16 bitwise in-core: {bool(torch.equal(got, ref))}")
    del data, psi0, got, ref, psi_m, data_m
    torch.cuda.empty_cache()
    log("bf16: " + json.dumps(out))
    return out



def wide_data(torch, dev, rng, shape):
    """4 views of gamma(2, 20) data of ``shape`` drawn on the card from a
    seed of ``rng`` (drawn on the host, 4 volumes of 2 GiB take tens of
    seconds), the bench kernels, per-voxel weights 1/V, psi0 the mean."""
    from libmultiviewnative_torch.deconv.workspace import MultiViewData

    k1, k2 = bench_kernels()
    torch.manual_seed(int(rng.integers(2**31)))
    gamma = torch.distributions.Gamma(torch.tensor(2.0, device=dev), torch.tensor(1 / 20, device=dev))
    views = gamma.sample((V,) + shape)
    data = MultiViewData(views, torch.from_numpy(k1).to(dev), torch.from_numpy(k2).to(dev),
                         torch.full((V,) + shape, 1.0 / V, device=dev))
    return data, torch.full(shape, float(views.mean()), device=dev)


def fused_bytes(plan):
    """(volume, spectrum out, spectrum in) bytes of a fused pass at f32: a
    spectrum output's Kxp rows (pad rows written), an input's Kx rows."""
    Z, Y, X = plan.shape
    return 4 * Z * X * Y, 8 * plan.kxp * Z * Y, 8 * plan.kxh * Z * Y


def plain_plan(shape):
    """The fused plan of ``shape`` with the dense matrices the plain passes
    read built (a plan builds them at their first read)."""
    from libmultiviewnative_torch.ops.fused_plan import make_fused_plan

    plan = make_fused_plan(shape)
    plan.fxp, plan.sy, plan.sz  # noqa: B018
    return plan


def plain_f64(c):
    """A plan's plain-version constants (their float32 values) widened to
    float64: the plain passes then sum their dense DFTs in float64."""
    d = copy.copy(c)
    d.fxp, d.bxp = c.fxp.double(), c.bxp.double()
    for name in ("wfy", "wiy", "wfz", "wiz"):
        setattr(d, name, tuple(t.double() for t in getattr(c, name)))
    return d


def dense_bytes(plan):
    """Bytes of a plan's dense plain-version matrices in float64, as the
    float64 plain versions hold them: fxp and bxp, and the forward and
    inverse Karatsuba triples of the y and z stages."""
    Z, Y, X = plan.shape
    return 8 * (4 * plan.kxp * X + 6 * Y * plan.split_y[1] + 6 * Z * plan.split_z[1])


def plain_ok(plan):
    """Whether phase 30 holds a plan's passes against their float64 plain
    versions (PLAIN_DENSE_MAX, PLAIN_SPLIT_MAX)."""
    return (dense_bytes(plan) <= PLAIN_DENSE_MAX
            and max(plan.split_y[0], plan.split_z[0]) <= PLAIN_SPLIT_MAX)


def fft64_passes(torch, dev, plan):
    """The seven passes' functions in float64 through torch.fft, in the fused
    layout ((Kxp, Z, Y) pairs, y and K5's z in the split order of
    ``split_perm``, pad rows zero; volumes (Z, X, Y)): a reference inside the
    check where the plain versions' dense matrices are too large, never on
    the main path.  Returns a namespace of a, bf, b, c, cqa, cu, cua taking
    the passes' arguments."""
    import types

    from libmultiviewnative_torch.core.kernels import compute_quotient, rl_update
    from libmultiviewnative_torch.ops.fused_plan import split_perm

    Z, Y, X = plan.shape
    kx, kxp = plan.kxh, plan.kxp
    perm_y = torch.as_tensor(split_perm(Y, plan.split_y), device=dev)
    perm_z = torch.as_tensor(split_perm(Z, plan.split_z), device=dev)

    def pair(s):  # (Kx, Z, Y) complex -> a float64 (Kxp, Z, Y) pair, pad rows zero
        out = torch.zeros((2, kxp, Z, Y), dtype=torch.float64, device=dev)
        out[0, :kx], out[1, :kx] = s.real, s.imag
        return out[0], out[1]

    def cplx(re, im):
        return torch.complex(re[:kx].double(), im[:kx].double())

    def natural(c, perm, dim):  # split order -> natural along dim
        out = torch.empty_like(c)
        out.index_copy_(dim, perm, c)
        return out

    def a(xt):
        s = torch.fft.fft(torch.fft.rfft(xt.double(), dim=1), dim=2).transpose(0, 1)
        return pair(s.index_select(2, perm_y))

    def c(re, im):
        s = torch.fft.ifft(natural(cplx(re, im), perm_y, 2), dim=2).transpose(0, 1)
        return torch.fft.irfft(s, n=X, dim=1)

    def bf(re, im):
        return pair(torch.fft.fft(cplx(re, im), dim=1).index_select(1, perm_z))

    def b(re, im, kre, kim, conj=False):
        k = natural(cplx(kre, kim), perm_z, 1)
        return pair(torch.fft.ifft(torch.fft.fft(cplx(re, im), dim=1) * (k.conj() if conj else k),
                                   dim=1))

    def cu(re, im, psi, w):
        return rl_update(psi.double(), c(re, im), w.double(), LAM, MIN_VALUE)

    return types.SimpleNamespace(
        a=a, bf=bf, b=b, c=c, cu=cu,
        cqa=lambda re, im, view: a(compute_quotient(view.double(), c(re, im))),
        cua=lambda re, im, psi, w: (lambda new: (new, a(new)))(cu(re, im, psi, w)))


def hold_passes(torch, dev, gen, shape, plan, timed=TIMED_LAUNCHES, plain32=True):
    """The seven passes at one of WIDE_SHAPES, NARROW_SHAPES, LONG_SHAPES or
    LONG_EDGE_SHAPES against their plain versions evaluated in float64 on
    the same inputs and the plan's float32 constants (FUSED_TOLERANCE of
    max|plain|; psi' at λ 0.006 plus tikhonov_atol), or, where the plan's
    dense matrices or splits are too large for that (:func:`plain_ok`),
    against the same functions through torch.fft in float64
    (:func:`fft64_passes`), each timed (median
    CUDA-event ms of ``timed`` launches) beside its byte bound.  In float32
    the plain versions' dense DFTs of up to 14528 terms carry up to 1e-5 of
    max|·| themselves (cuBLAS; pass B at Z = 14528), so that deviation is
    logged beside, not gated.  K8-K10 take pass A of psi, so the blurred
    estimate and the integral are psi, away from 0.  A check widens its own
    inputs to float64, so at a main-path shape (2 GiB a volume) only one
    pass's float64 operands are held.  ``plain32=False`` skips the float32
    plain versions."""
    from libmultiviewnative_torch.ops import fused as fu

    Z, Y, X = shape
    c = fu.plan_tensors(plan, dev)
    f64 = torch.float64
    by_fft = not plain_ok(plan)

    def rand(shp, lo, hi):
        return torch.rand(shp, generator=gen, device=dev) * (hi - lo) + lo

    psi, view, w = rand((Z, X, Y), 1.0, 100.0), rand((Z, X, Y), 1.0, 200.0), rand((Z, X, Y), 0.0, 0.5)
    k = tuple(torch.randn((plan.kxp, Z, Y), generator=gen, device=dev) for _ in "ri")
    for t in k:
        t[plan.kxh:] = 0.0  # pad rows, as pass A leaves them
    vol, spec, spec_in = fused_bytes(plan)
    flops = fused_flops(plan)
    atol = tikhonov_atol(LAM)
    f32 = lambda pair: tuple(t.float() for t in pair)  # noqa: E731
    if by_fft:
        r = fft64_passes(torch, dev, plan)
        u = f32(r.a(psi))
        v = f32(r.b(*u, *k))
        checks = (
            ("pass_a", lambda: fu.pass_a(psi, plan), None, lambda: r.a(psi), vol + spec, 0.0),
            ("pass_bf", lambda: fu.pass_bf(*u, plan), None, lambda: r.bf(*u), spec_in + spec, 0.0),
            ("pass_b", lambda: fu.pass_b(*u, *k, plan), None, lambda: r.b(*u, *k),
             2 * spec_in + spec, 0.0),
            ("pass_c", lambda: fu.pass_c(*v, plan), None, lambda: r.c(*v), spec_in + vol, 0.0),
            ("pass_cqa", lambda: fu.pass_cqa(*u, view, plan), None, lambda: r.cqa(*u, view),
             spec_in + vol + spec, 0.0),
            ("pass_cu", lambda: fu.pass_cu(*u, psi, w, plan, LAM, MIN_VALUE), None,
             lambda: r.cu(*u, psi, w), spec_in + 3 * vol, atol),
            ("pass_cua", lambda: fu.pass_cua(*u, psi, w, plan, LAM, MIN_VALUE), None,
             lambda: r.cua(*u, psi, w), spec_in + spec + 3 * vol, atol),
        )
        return _hold_checks(torch, shape, plan, checks, flops, timed, "torch.fft float64")
    c64 = plain_f64(c)
    u = fu.pass_a_plain(psi, c)
    v = fu.pass_b_plain(*u, *k, c)
    d = lambda *ts: tuple(t.double() for t in ts)  # noqa: E731
    checks = (
        ("pass_a", lambda: fu.pass_a(psi, plan), lambda: fu.pass_a_plain(psi, c),
         lambda: fu.pass_a_plain(*d(psi), c64, f64), vol + spec, 0.0),
        ("pass_bf", lambda: fu.pass_bf(*u, plan), lambda: fu.pass_bf_plain(*u, c),
         lambda: fu.pass_bf_plain(*d(*u), c64, f64), spec_in + spec, 0.0),
        ("pass_b", lambda: fu.pass_b(*u, *k, plan), lambda: fu.pass_b_plain(*u, *k, c),
         lambda: fu.pass_b_plain(*d(*u, *k), c64, False, f64), 2 * spec_in + spec, 0.0),
        ("pass_c", lambda: fu.pass_c(*v, plan), lambda: fu.pass_c_plain(*v, c),
         lambda: fu.pass_c_plain(*d(*v), c64), spec_in + vol, 0.0),
        ("pass_cqa", lambda: fu.pass_cqa(*u, view, plan), lambda: fu.pass_cqa_plain(*u, view, c),
         lambda: fu.pass_cqa_plain(*d(*u, view), c64, f64), spec_in + vol + spec, 0.0),
        ("pass_cu", lambda: fu.pass_cu(*u, psi, w, plan, LAM, MIN_VALUE),
         lambda: fu.pass_cu_plain(*u, psi, w, c, LAM, MIN_VALUE),
         lambda: fu.pass_cu_plain(*d(*u, psi, w), c64, LAM, MIN_VALUE), spec_in + 3 * vol, atol),
        ("pass_cua", lambda: fu.pass_cua(*u, psi, w, plan, LAM, MIN_VALUE),
         lambda: fu.pass_cua_plain(*u, psi, w, c, LAM, MIN_VALUE),
         lambda: fu.pass_cua_plain(*d(*u, psi, w), c64, LAM, MIN_VALUE, f64),
         spec_in + spec + 3 * vol, atol),
    )
    if not plain32:
        checks = tuple((n, k, None, r, b, a) for n, k, _, r, b, a in checks)
    return _hold_checks(torch, shape, plan, checks, flops, timed, "float64 plain")


def _hold_checks(torch, shape, plan, checks, flops, timed, against):
    """Run :func:`hold_passes`' checks: (name, kernel, float32 plain or None,
    float64 reference, bytes, absolute slack) each."""
    from libmultiviewnative_torch.ops import fused as fu
    from libmultiviewnative_torch.ops.fused_plan import make_fft_stages

    Z, Y, X = shape
    kinds = "/".join(make_fft_stages(n).kind for n in (X, Y, Z))
    tiles = f"tiles x {fu._x_seq(X)}, y {fu._y_rows(Y)}, z {fu._z_cols(Z)}; x/y/z {kinds}"
    out = {}
    for name, kernel, plain32, plain, nbytes, slack in checks:
        got, want = kernel(), plain()
        want32 = plain32() if plain32 is not None else None
        # (output, f64 reference, f32 plain, absolute slack): K10's psi'
        # takes K1's Tikhonov slack, its spectrum none
        parts = ([(got[0], want[0], None if want32 is None else want32[0], slack),
                  (got[1], want[1], None if want32 is None else want32[1], 0.0)]
                 if name == "pass_cua" else [(got, want, want32, slack)])
        rel = rel32 = 0.0
        for g, r, r32, extra in parts:
            err, scale = compare(torch, f"{name} {shape}", g, r)
            if not err <= FUSED_TOLERANCE * scale + extra:
                raise AssertionError(f"{name} at ZYX={shape}: error {err:.3e} beyond tolerance"
                                     f" of max {scale:.3e} ({against})")
            rel = max(rel, err / scale)
            if r32 is not None:
                rel32 = max(rel32, compare(torch, f"{name} {shape} f32", r32, r)[0] / scale)
        del got, want, want32, parts
        ms = statistics.median(event_times_ms(torch, kernel, timed))
        bound_ms, bound_by = bound(nbytes, flops[name])
        beside = (f"the float32 plain version {rel32:.3e} off" if plain32 is not None
                  else "no float32 plain version")
        log(f"{name:9s} ZYX={shape} ({tiles}): rel {rel:.3e} against {against} (tol"
            f" {FUSED_TOLERANCE:g}; {beside}); {ms:.4f} ms, bound {bound_ms:.4f} ms"
            f" ({bound_by}), {bound_ms / ms:.3f} of it")
        out[name] = {"rel": rel, "plain_f32_rel": rel32, "ms": ms, "bound_ms": bound_ms,
                     "against": against}
    return out


def narrow_bf16_twins(torch, dev, gen, shape, plan, phase=29):
    """The seven bf16 twins at one of NARROW_BF16_SHAPES or LONG_BF16_SHAPES
    (``phase`` 29 or 30; against torch.fft in float64 where
    :func:`plain_ok` does not hold), held as phase 28
    holds them (:func:`hold_bf16_twin`), against their plain versions
    evaluated in float64 (:func:`plain_f64`; in float32 the plain pass B
    is 5e-6 of max|·| off at Z = 1824 itself, past BF16_FLOOR) and rounded
    to bf16 where they store a spectrum."""
    from libmultiviewnative_torch.ops import fused as fu

    Z, Y, X = shape
    bf16 = torch.bfloat16

    def rand(shp, lo, hi):
        return torch.rand(shp, generator=gen, device=dev) * (hi - lo) + lo

    def wide(pair, dtype=torch.float32):
        return tuple(t.to(dtype) for t in pair)

    psi, view, w = rand((Z, X, Y), 1.0, 100.0), rand((Z, X, Y), 1.0, 200.0), rand((Z, X, Y), 0.0, 0.5)
    spectrum = lambda o: ((), o)  # noqa: E731
    volume = lambda o: ((o,), ())  # noqa: E731
    both = lambda o: ((o[0],), o[1])  # noqa: E731
    atol = tikhonov_atol(LAM)
    if not plain_ok(plan):
        r = fft64_passes(torch, dev, plan)
        k16, u16 = wide(r.a(rand((Z, X, Y), 0.0, 1.0)), bf16), wide(r.a(psi), bf16)
        k32, u32 = wide(k16), wide(u16)
        rounded = lambda pair: wide(pair, bf16)  # noqa: E731
        checks = (
            ("pass_a", lambda: fu.pass_a(psi, plan), lambda: rounded(r.a(psi)),
             lambda: fu.pass_a(psi, plan), spectrum, 0.0),
            ("pass_bf", lambda: fu.pass_bf(*u16, plan), lambda: rounded(r.bf(*u16)),
             lambda: fu.pass_bf(*u32, plan), spectrum, 0.0),
            ("pass_b", lambda: fu.pass_b(*u16, *k16, plan), lambda: rounded(r.b(*u16, *k16)),
             lambda: fu.pass_b(*u32, *k32, plan), spectrum, 0.0),
            ("pass_c", lambda: fu.pass_c(*u16, plan), lambda: r.c(*u16),
             lambda: fu.pass_c(*u32, plan), volume, 0.0),
            ("pass_cqa", lambda: fu.pass_cqa(*u16, view, plan),
             lambda: rounded(r.cqa(*u16, view)), lambda: fu.pass_cqa(*u32, view, plan),
             spectrum, 0.0),
            ("pass_cu", lambda: fu.pass_cu(*u16, psi, w, plan, LAM, MIN_VALUE),
             lambda: r.cu(*u16, psi, w), lambda: fu.pass_cu(*u32, psi, w, plan, LAM, MIN_VALUE),
             volume, atol),
            ("pass_cua", lambda: fu.pass_cua(*u16, psi, w, plan, LAM, MIN_VALUE),
             lambda: (lambda o: (o[0], rounded(o[1])))(r.cua(*u16, psi, w)),
             lambda: fu.pass_cua(*u32, psi, w, plan, LAM, MIN_VALUE), both, atol),
        )
        return _hold_bf16_checks(torch, fu, shape, checks, phase)
    c = fu.plan_tensors(plan, dev)
    c64 = plain_f64(c)
    k16 = fu.pass_a_plain(rand((Z, X, Y), 0.0, 1.0), c, bf16)
    u16 = fu.pass_a_plain(psi, c, bf16)
    k32, u32 = wide(k16), wide(u16)
    k64, u64 = wide(k16, torch.float64), wide(u16, torch.float64)
    psi64, view64, w64 = psi.double(), view.double(), w.double()
    checks = (
        ("pass_a", lambda: fu.pass_a(psi, plan), lambda: fu.pass_a_plain(psi64, c64, bf16),
         lambda: fu.pass_a(psi, plan), spectrum, 0.0),
        ("pass_bf", lambda: fu.pass_bf(*u16, plan), lambda: fu.pass_bf_plain(*u64, c64, bf16),
         lambda: fu.pass_bf(*u32, plan), spectrum, 0.0),
        ("pass_b", lambda: fu.pass_b(*u16, *k16, plan),
         lambda: fu.pass_b_plain(*u64, *k64, c64, False, bf16),
         lambda: fu.pass_b(*u32, *k32, plan), spectrum, 0.0),
        ("pass_c", lambda: fu.pass_c(*u16, plan), lambda: fu.pass_c_plain(*u64, c64),
         lambda: fu.pass_c(*u32, plan), volume, 0.0),
        ("pass_cqa", lambda: fu.pass_cqa(*u16, view, plan),
         lambda: fu.pass_cqa_plain(*u64, view64, c64, bf16),
         lambda: fu.pass_cqa(*u32, view, plan), spectrum, 0.0),
        ("pass_cu", lambda: fu.pass_cu(*u16, psi, w, plan, LAM, MIN_VALUE),
         lambda: fu.pass_cu_plain(*u64, psi64, w64, c64, LAM, MIN_VALUE),
         lambda: fu.pass_cu(*u32, psi, w, plan, LAM, MIN_VALUE), volume, atol),
        ("pass_cua", lambda: fu.pass_cua(*u16, psi, w, plan, LAM, MIN_VALUE),
         lambda: fu.pass_cua_plain(*u64, psi64, w64, c64, LAM, MIN_VALUE, bf16),
         lambda: fu.pass_cua(*u32, psi, w, plan, LAM, MIN_VALUE), both, atol),
    )
    return _hold_bf16_checks(torch, fu, shape, checks, phase)


def _hold_bf16_checks(torch, fu, shape, checks, phase):
    """Run :func:`narrow_bf16_twins`' checks and hold its launches."""
    fu.reset_launches()
    for name, kernel, plain, f32_kernel, split, slack in checks:
        err, worst = hold_bf16_twin(torch, f"{name}_bf16", str(shape), kernel, plain, f32_kernel,
                                    split, slack)
        log(f"{name}_bf16 ZYX={shape}: max_abs_err {err:.3e}, worst {worst:.3f} bf16 steps,"
            " bitwise its f32 entry rounded")
    ran = {k for k, n in fu.launches.items() if n}
    if ran != set(FUSED_PASSES + BF16_PASSES):
        raise AssertionError(f"phase {phase} bf16 twins at {shape}: launches {sorted(ran)}")


def refuse_over_shapes(torch, dev):
    """Each shape past fused_limit (an axis past 2^25) is refused by every
    entry before a launch (a plan of the refused shape holds no dense matrix
    until a plain pass reads one, and no FFT plan until the card's tables
    are made).  The operands are left uninitialised: 8.6 GB a volume."""
    from libmultiviewnative_torch.ops import fused as fu
    from libmultiviewnative_torch.ops.fused_plan import make_fused_plan

    for shape in OVER_SHAPES:
        Z, Y, X = shape
        plan = make_fused_plan(shape)
        vol = torch.empty((Z, X, Y), device=dev)
        spec = torch.empty((plan.kxp, Z, Y), device=dev)
        for name, call in (
            ("pass_a", lambda: fu.pass_a(vol)),
            ("pass_bf", lambda: fu.pass_bf(spec, spec, plan)),
            ("pass_c", lambda: fu.pass_c(spec, spec, plan)),
            ("pass_cua", lambda: fu.pass_cua(spec, spec, vol, 0.25, plan, 0.0, MIN_VALUE)),
        ):
            before = dict(fu.launches)
            try:
                call()
            except NotImplementedError as e:
                log(f"{name} ZYX={shape} refused: {e}")
            else:
                raise AssertionError(f"{name} at ZYX={shape} was not refused")
            if fu.launches != before:
                raise AssertionError(f"{name} at ZYX={shape} counted a launch")
        del vol, spec
        torch.cuda.empty_cache()


def phase_wide(torch, dev, rng, auto_table):
    """29: the fused engine past the old limits: the main path at
    WIDE_SHAPES through ``deconvolve`` and ``deconvolve_auto`` (launches,
    fused against fft after 10 iterations, ``auto``'s pick beside phase 22's
    turns, the interleaved rung at the first shape), then every pass at
    WIDE_SHAPES and NARROW_SHAPES against its plain version with its time
    and byte bound (:func:`hold_passes`) and the bf16 twins at
    NARROW_BF16_SHAPES.  The narrow shapes' plans (dense plain-version matrices of up
    to 14528² values, seconds of host time each) are built on a host thread
    while the card runs the main path."""
    import io
    from concurrent.futures import ThreadPoolExecutor

    from libmultiviewnative_torch.deconv.dispatch import deconvolve_auto
    from libmultiviewnative_torch.deconv.interleaved import deconvolve_interleaved
    from libmultiviewnative_torch.deconv.rl import deconvolve, resolve_algorithm
    from libmultiviewnative_torch.ops import fused as fu
    from libmultiviewnative_torch.ops import fused_plan as fp

    log("# phase 29: the fused engine past the old limits (X > 1816, Y > 3632, Z > 736)")
    t0 = time.perf_counter()
    builder = ThreadPoolExecutor(1)
    plans = {shape: builder.submit(plain_plan, shape) for shape in NARROW_SHAPES + NARROW_BF16_SHAPES}
    kw = dict(lam=LAM, min_value=MIN_VALUE)
    gen = torch.Generator(device=dev).manual_seed(29)
    results = {}
    for shape in WIDE_SHAPES:
        label = f"4 views {shape}"
        data, psi0 = wide_data(torch, dev, rng, shape)
        reset_counts()
        fused = deconvolve(psi0, data, ITERS, algorithm="fused", **kw)
        torch.cuda.synchronize()
        expect_counts(read_counts(), {"pass_a": V * ITERS + 2, "pass_b": 2 * V * ITERS,
                                      "pass_cqa": V * ITERS, "pass_cu": V * ITERS,
                                      **forwarded(2)}, f"fused {shape}")
        check_output(torch, fused, shape, f"fused {shape}")
        fft = deconvolve(psi0, data, ITERS, algorithm="fft", **kw)
        diff = float((fused - fft).abs().max()) / float(fft.abs().max())
        log(f"fused vs fft at {shape} after {ITERS} iterations: max|diff|/max|psi| = {diff:.3e}"
            " (tol 1e-3)")
        if not diff <= 1e-3:
            raise AssertionError(f"fused and fft engines disagree at {shape}: {diff:.3e}")
        pick = resolve_algorithm("auto", shape, dev)
        lines = io.StringIO()
        with knobs(LMVN_TRACE="1"), contextlib.redirect_stdout(lines):
            auto = deconvolve_auto(psi0, data, ITERS, device=dev, **kw)
        trace = [ln for ln in lines.getvalue().splitlines() if ln.startswith("[lmvn-trace]")]
        same = {"fused": fused, "fft": fft}[pick]
        exact = bool(torch.equal(auto, same))
        rel = float((auto - same).abs().max()) / float(same.abs().max())
        log(f"deconvolve_auto at {shape}: " + " | ".join(trace) + f"; picks {pick}, against"
            f" deconvolve(algorithm={pick!r}) max|diff|/max|psi| {rel:.3e}, bitwise {exact}")
        if not any("dispatch: in-core on one device" in ln for ln in trace) or not rel <= 1e-6:
            raise AssertionError(f"deconvolve_auto at {shape} did not run {pick} in-core")
        row = auto_table.get(label)
        if row is not None:
            best, spread = row["fastest"], max(row["spread"].values())
            gap = 1.0 - row["it_s"][pick] / row["it_s"][best]
            log(f"auto at {shape}: phase 22's turns {json.dumps(row['it_s'])} it/s, fastest"
                f" {best}, spread up to {spread:.3f}; the pick {pick} trails the fastest by"
                f" {gap:.3f}: {'within' if gap <= spread else 'beyond'} the spread")
        results[label] = {"fused_vs_fft": diff, "pick": pick, "auto_bitwise": exact}
        if shape == WIDE_SHAPES[0]:
            results[label]["interleaved"] = wide_interleaved(
                torch, dev, data, psi0, deconvolve, deconvolve_interleaved)
        del data, psi0, fused, fft, auto, same
        torch.cuda.empty_cache()
        results[label]["kernels"] = hold_passes(torch, dev, gen, shape, fp.make_fused_plan(shape))
        fu._tensors.clear()
        torch.cuda.empty_cache()
    log(f"phase 29 main path: {time.perf_counter() - t0:.1f} s")

    narrow = {}
    for shape in NARROW_SHAPES:
        narrow[str(shape)] = hold_passes(torch, dev, gen, shape, plans[shape].result())
        fu._tensors.clear()  # the plain versions' constants, up to 5 GB a shape on the card
        torch.cuda.empty_cache()
    for shape in NARROW_BF16_SHAPES:
        narrow_bf16_twins(torch, dev, gen, shape, plans[shape].result())
        fu._tensors.clear()
    builder.shutdown()
    del plans
    fp._make_fused_plan.cache_clear()
    log("narrow tiles: " + json.dumps(narrow))
    log("phase 29: " + json.dumps(results) + f"; {time.perf_counter() - t0:.1f} s")
    return results


def long_plan(shape):
    """The fused plan of ``shape``, its dense plain-version matrices built
    where phase 30 reads them (:func:`plain_ok`)."""
    from libmultiviewnative_torch.ops.fused_plan import make_fused_plan

    plan = make_fused_plan(shape)
    return plain_plan(shape) if plain_ok(plan) else plan


def phase_long(torch, dev, rng):
    """30: the fused passes at every axis length the JAX engine takes: a
    four-step FFT through HBM past 14528, Bluestein for a prime factor over
    1024.  a. The main path at LONG_SHAPES through
    ``deconvolve(algorithm="fused")`` (K4 42, K6 80, K8 40, K9 40) against
    fft (1e-3), fft and fused in turns, the peak memory beside
    LONG_PEAK_GIB, and ``auto``'s pick (fft by rule: no such class was
    timed); every pass there against its float64 reference, timed beside
    its byte bound.  b. Every pass at LONG_EDGE_SHAPES.  c. The bf16 twins
    at LONG_BF16_SHAPES.  d. An axis past 2^25 refused before any launch.
    The edge shapes' plans (dense plain-version matrices up to 5 GB) are
    built on a host thread while the card runs the main path."""
    from concurrent.futures import ThreadPoolExecutor

    from libmultiviewnative_torch.deconv.rl import deconvolve, fused_eligible, resolve_algorithm
    from libmultiviewnative_torch.ops import fused as fu
    from libmultiviewnative_torch.ops import fused_plan as fp

    log("# phase 30: the fused passes at every axis length: four-step past 14528, Bluestein"
        " for a prime factor over 1024")
    start = time.perf_counter()
    pool = ThreadPoolExecutor(1)
    plans = {shape: pool.submit(long_plan, shape)
             for shape in dict.fromkeys(LONG_SHAPES + LONG_EDGE_SHAPES + LONG_BF16_SHAPES)}
    kw = dict(lam=LAM, min_value=MIN_VALUE)
    gen = torch.Generator(device=dev).manual_seed(30)
    results = {}
    for shape in LONG_SHAPES:
        t0 = time.perf_counter()
        label = f"4 views {shape}"
        kinds = "/".join(fp.make_fft_stages(n).kind for n in shape[::-1])
        data, psi0 = wide_data(torch, dev, rng, shape)
        run = {e: (lambda e=e: deconvolve(psi0, data, ITERS, algorithm=e, **kw))
               for e in ("fused", "fft")}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        fused, fused_s = timed_call(torch, run["fused"])
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        expect_counts(counts, {"pass_a": V * ITERS + 2, "pass_b": 2 * V * ITERS,
                               "pass_cqa": V * ITERS, "pass_cu": V * ITERS, **forwarded(2)},
                      f"fused {shape}")
        check_output(torch, fused, shape, f"fused {shape}")
        torch.cuda.reset_peak_memory_stats(dev)
        fft, fft_s = timed_call(torch, run["fft"])
        fft_peak = torch.cuda.max_memory_allocated(dev) / 2**30
        diff = float((fused - fft).abs().max()) / float(fft.abs().max())
        del fused, fft
        log(f"fused vs fft at {shape} (x/y/z {kinds}) after {ITERS} iterations:"
            f" max|diff|/max|psi| = {diff:.3e} (tol 1e-3)")
        if not diff <= 1e-3:
            raise AssertionError(f"fused and fft engines disagree at {shape}: {diff:.3e}")
        # turns: fused, fft (above), fft, fused
        turns = {"fused": [fused_s], "fft": [fft_s]}
        for engine in ("fft", "fused"):
            out, sec = timed_call(torch, run[engine])
            turns[engine].append(sec)
            del out
        it_s = {e: [ITERS / t for t in ts] for e, ts in turns.items()}
        pick = resolve_algorithm("auto", shape, dev)
        eligible = fused_eligible(shape, dev)
        log(f"{label}: it/s in turns fused {it_s['fused'][0]:.4f}, fft {it_s['fft'][0]:.4f},"
            f" fft {it_s['fft'][1]:.4f}, fused {it_s['fused'][1]:.4f}; peak device memory fused"
            f" {peak:.2f} GiB (predicted under {LONG_PEAK_GIB[shape]:.1f}), fft {fft_peak:.2f};"
            f" fused_eligible {eligible}, auto picks {pick} (fft by rule: untimed class)")
        if pick != "fft" or not eligible:
            raise AssertionError(f"auto at {shape}: pick {pick}, fused_eligible {eligible}")
        results[label] = {"fused_vs_fft": diff, "it_s": it_s, "peak_gib": peak,
                          "fft_peak_gib": fft_peak, "pick": pick}
        del data, psi0, run
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        plan = plans[shape].result()
        t2 = time.perf_counter()
        results[label]["kernels"] = hold_passes(torch, dev, gen, shape, plan, timed=3,
                                                plain32=False)
        fu._tensors.clear()
        torch.cuda.empty_cache()
        log(f"phase 30 {shape}: main path {t1 - t0:.1f} s, waited {t2 - t1:.1f} s for its plan,"
            f" passes {time.perf_counter() - t2:.1f} s")
    log(f"phase 30 main path: {time.perf_counter() - start:.1f} s")

    edges = {}
    for shape in LONG_EDGE_SHAPES:
        t1 = time.perf_counter()
        plan = plans[shape].result()
        t2 = time.perf_counter()
        edges[str(shape)] = hold_passes(torch, dev, gen, shape, plan)
        fu._tensors.clear()
        torch.cuda.empty_cache()
        log(f"phase 30 {shape}: waited {t2 - t1:.1f} s for its plan, passes"
            f" {time.perf_counter() - t2:.1f} s")
    t1 = time.perf_counter()
    for shape in LONG_BF16_SHAPES:
        narrow_bf16_twins(torch, dev, gen, shape, plans[shape].result(), phase=30)
        fu._tensors.clear()
    pool.shutdown()
    del plans
    fp._make_fused_plan.cache_clear()
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    refuse_over_shapes(torch, dev)
    log(f"phase 30 bf16 twins {t2 - t1:.1f} s, refusals {time.perf_counter() - t2:.1f} s")
    seconds = time.perf_counter() - start
    log("long edges: " + json.dumps(edges))
    log("phase 30: " + json.dumps(results) + f"; {seconds:.1f} s (budget 60 s)")
    return results


def wide_interleaved(torch, dev, data, psi0, deconvolve, deconvolve_interleaved):
    """The interleaved rung on the fused engine at the first of WIDE_SHAPES,
    WIDE_INTERLEAVED_ITERS iterations with the stacks in pinned host memory,
    against in-core (rtol 2e-5, atol 2e-4)."""
    shape, iters = tuple(psi0.shape), WIDE_INTERLEAVED_ITERS
    kw = dict(lam=LAM, min_value=MIN_VALUE)
    incore = deconvolve(psi0, data, iters, algorithm="fused", **kw)
    host = lambda t: torch.empty(shape, pin_memory=True).copy_(t)  # noqa: E731
    views = [host(data.views[v]) for v in range(V)]
    weights = [host(data.weights[v]) for v in range(V)]
    k1 = [data.kernel1[v].cpu().numpy() for v in range(V)]
    k2 = [data.kernel2[v].cpu().numpy() for v in range(V)]
    start = psi0.cpu()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    got, seconds = timed_call(torch, lambda: deconvolve_interleaved(
        start, views, k1, k2, weights, iters, chunk_z=CHUNK_Z, algorithm="fused", device=dev,
        **kw))
    counts = {k: n for k, n in read_counts().items() if n}
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    got = torch.from_numpy(got).to(dev)
    excess = float(((got - incore).abs() - (2e-4 + 2e-5 * incore.abs())).max())
    rel = float((got - incore).abs().max()) / float(incore.abs().max())
    log(f"interleaved fused at {shape}, {iters} iterations: {seconds!r} s, launches {counts},"
        f" peak device memory {peak:.2f} GiB (the in-core stacks still held); against in-core"
        f" max|diff|/max|psi| {rel:.3e}, within rtol 2e-5, atol 2e-4: {excess <= 0}")
    if not excess <= 0 or counts.get("pass_a", 0) == 0:
        raise AssertionError(f"the interleaved rung at {shape} disagrees with in-core")
    return {"seconds": seconds, "rel": rel, "peak_gib": peak}


def phase_cli(torch, dev):
    """cli.main on TIFFs at 64³ with --dispatch auto against deconvolve_auto."""
    import tempfile

    from libmultiviewnative_torch import cli
    from libmultiviewnative_torch.deconv.dispatch import deconvolve_auto
    from libmultiviewnative_torch.deconv.workspace import MultiViewData, initial_psi
    from libmultiviewnative_torch.io.stacks import read_tiff_stack, write_tiff_stack
    from libmultiviewnative_torch.utils.synthetic import gaussian_kernel

    rng = np.random.default_rng(27)
    shape = (CROSS_N,) * 3
    views = [rng.gamma(2.0, 20.0, shape).astype(np.float32) for _ in range(V)]
    psfs = [gaussian_kernel((9, 9, 9), 1.0 + 0.3 * v) for v in range(V)]
    with tempfile.TemporaryDirectory() as tmp:
        argv = []
        for v in range(V):
            for kind, a in (("view", views[v]), ("psf", psfs[v])):
                path = os.path.join(tmp, f"{kind}{v}.tif")
                write_tiff_stack(path, a)
                argv += [f"--{kind}", path]
        out_path = os.path.join(tmp, "out.tif")
        cli.main(argv + ["-o", out_path, "-i", str(ITERS), "--dispatch", "auto"])
        got = read_tiff_stack(out_path)
    t = lambda a: torch.as_tensor(np.stack(a), device=dev)  # noqa: E731
    data = MultiViewData(t(views), t(psfs), t([np.flip(k).copy() for k in psfs]),
                         torch.full((V,), 1.0 / V, device=dev))
    want = deconvolve_auto(initial_psi(data), data, ITERS, lam=LAM, min_value=MIN_VALUE,
                           device=dev).cpu().numpy()
    same_or_close(f"CLI at {CROSS_N}^3 vs deconvolve_auto", got, want)


def phase_forward_stack(torch, dev, records):
    """31: the z-sparse forwarding of a whole kernel stack against the
    per-view einsum chain it replaced, at the benchmark's shapes, then with
    kernels that fold (:func:`forward_folding`)."""
    from libmultiviewnative_torch.ops import fused as fu
    from libmultiviewnative_torch.ops.fused_plan import make_fused_plan

    log("# phase 31: the forwarding of a kernel stack, gather + one K4 + spectrum_zsparse")
    check_fp32_matmuls(torch)
    k1, k2 = (torch.from_numpy(k).to(dev) for k in bench_kernels())
    for n, ks in ((HEADLINE_N, k1), (HEADLINE_N, k2), (BIG_N, k1)):
        shape = (n,) * 3
        kz = int(ks.shape[1])
        zs = fu._ceil8(kz)
        label = f"{n}^3 {kz}^3 x{V}"
        plan, small = make_fused_plan(shape), make_fused_plan((zs, n, n))
        g = fu._gathered(ks, zs, n, n, dev)
        same = bool(torch.equal(g, fu._gathered_plain(ks, zs, n, n)))
        log(f"spectrum_gather {label}: bitwise wrap_kernel view by view: {same}")
        if not same:
            raise AssertionError(f"spectrum_gather {label} differs from its plain version")
        u = fu.pass_a(g, make_fused_plan((V * zs, n, n)))
        for v in range(V):
            one = fu.pass_a(g[v * zs:(v + 1) * zs].contiguous(), small)
            if not all(torch.equal(a[:, v * zs:(v + 1) * zs], b) for a, b in zip(u, one)):
                raise AssertionError(f"K4 over the stacked planes {label}: view {v} is not its own K4")
        log(f"pass_a {label}: one K4 over {V * zs} planes is each view's K4 bit for bit")
        table = fu._sparse_table(n, kz, *plan.split_z, str(dev))
        ops = 8 * kz * V * plan.kxh * n * n  # 4 multiply-adds a complex output and plane
        # the stacks written, the occupied planes of u's live rows and the table read
        spec_bytes = V * plan.kxp * n * n * 8 + plan.kxh * V * kz * n * 8 + n * kz * 8
        wide = tuple(t.double() for t in (*u, *table))
        t = check_kernel(
            torch, records, "spectrum_zsparse", label,
            lambda: fu.spectrum_zsparse(*u, V, kz, plan),
            lambda: fu.spectrum_zsparse_plain(*wide, V, torch.float64),
            spec_bytes, tol=TOLERANCE,
            library=lambda: fu.spectrum_zsparse_plain(*u, *table, V))
        if kz == 21:
            keep_timing(records, "spectrum_zsparse", n, t, spec_bytes, ops)
        del wide
        # the bf16 twin on bf16 u: the f32 entry on the widened u, rounded once
        u16 = tuple(x.to(torch.bfloat16) for x in u)
        twin = fu.spectrum_zsparse(*u16, V, kz, plan)
        rounded = tuple(x.to(torch.bfloat16) for x in
                        fu.spectrum_zsparse(*(x.float() for x in u16), V, kz, plan))
        same = all(bool(torch.equal(a, b)) for a, b in zip(twin, rounded))
        log(f"spectrum_zsparse_bf16 {label}: bitwise the f32 entry rounded once: {same}")
        if not same:
            raise AssertionError(f"spectrum_zsparse_bf16 {label} differs from the f32 entry")
        bytes16 = V * plan.kxp * n * n * 4 + plan.kxh * V * kz * n * 4 + n * kz * 8
        t16 = check_kernel(
            torch, records, "spectrum_zsparse_bf16", label,
            lambda: fu.spectrum_zsparse(*u16, V, kz, plan),
            lambda: fu.spectrum_zsparse_plain(*u16, *table, V, torch.bfloat16),
            bytes16, tol=BF16_STEP, atol=0.0)
        if kz == 21:
            keep_timing(records, "spectrum_zsparse_bf16", n, t16, bytes16, ops)
        del u16, twin, rounded
        gather_bytes = 4 * V * zs * n * n + 4 * ks.numel()
        tg = check_kernel(torch, records, "spectrum_gather", label,
                          lambda: fu._gathered(ks, zs, n, n, dev),
                          lambda: fu._gathered_plain(ks, zs, n, n), gather_bytes, tol=0.0)
        if kz == 21:
            keep_timing(records, "spectrum_gather", n, tg, gather_bytes, 0)
        del g, u, one
        # the whole forwarding of the stack against the parent's chain
        chain = lambda: fu._stacked([fu._spectrum_sparse(k, shape) for k in ks])  # noqa: E731
        stack = lambda: fu.kernel_stack_spectrum_fused(ks, shape)  # noqa: E731
        for knob in ("0", "1"):
            with knobs(LMVN_FUSED_SPEC_BF16=knob):
                reset_counts()
                got = stack()
                torch.cuda.synchronize()
                sfx = "_bf16" if knob == "1" else ""
                expect_counts(read_counts(), {"pass_a" + sfx: 1, **forwarded(1, sfx)},
                              f"forwarding {label} bf16={knob}")
                ref = chain()
                if knob == "0":
                    err, scale = compare(torch, f"forwarding {label}", got, ref)
                    log(f"forwarding {label}: stack against the einsum chain max|diff|/max"
                        f" {err / scale:.3e} (tol 1e-6)")
                    ok = err <= 1e-6 * scale
                else:
                    a, b = (torch.cat([x.float().flatten() for x in p]) for p in (got, ref))
                    step = BF16_STEP * torch.maximum(a.abs(), b.abs()) + BF16_FLOOR * float(
                        b.abs().max())
                    ok = bool(((a - b).abs() <= step).all())
                    log(f"forwarding {label} in bf16: within one bf16 step of the einsum chain"
                        f" in bf16: {ok}")
                    del a, b, step
                if not ok:
                    raise AssertionError(f"forwarding {label} bf16={knob} off the einsum chain")
                del got, ref
        samples = {"stack": [], "chain": []}
        for which in ("chain", "stack", "stack", "chain"):
            samples[which] += event_times_ms(torch, stack if which == "stack" else chain, n=5)
        ms = {k: statistics.median(v) for k, v in samples.items()}
        log(f"forwarding {label}: stack {ms['stack']:.4f} ms, the einsum chain view by view"
            f" {ms['chain']:.4f} ms (device time on the stream, medians of 10)")
        torch.cuda.empty_cache()
    forward_folding(torch, dev)


def forward_folding(torch, dev):
    """Kernels wider than the volume: the gather folds them as wrap_kernel
    does, bit for bit where at most two alias blocks meet (a sum of two is
    the same in any order), else within 1e-6 of max of the float64 fold
    (torch's reduction adds the blocks in an order of its own); the whole
    forwarding within 1e-6 of max of the einsum chain."""
    from libmultiviewnative_torch.ops import fused as fu

    gen = torch.Generator().manual_seed(31)
    shape = (32, 24, 32)
    Z, Y, X = shape
    for kshape in ((5, 29, 9), (3, 5, 37), (5, 29, 37), (3, 70, 90)):
        ks = torch.rand((V,) + kshape, generator=gen).to(dev)
        zs = fu._ceil8(kshape[0])
        blocks = -(-kshape[1] // Y) * -(-kshape[2] // X)
        label = f"{shape} kernel {kshape} x{V} ({blocks} alias blocks)"
        g = fu._gathered(ks, zs, Y, X, dev)
        if blocks <= 2:
            ok = bool(torch.equal(g, fu._gathered_plain(ks, zs, Y, X)))
            log(f"spectrum_gather {label}: bitwise wrap_kernel: {ok}")
        else:
            wide = fu._gathered_plain(ks.double(), zs, Y, X)
            rel = float((g.double() - wide).abs().max() / wide.abs().max())
            ok = rel <= 1e-6
            log(f"spectrum_gather {label}: max|diff|/max against the float64 fold {rel:.3e}"
                f" (tol 1e-6)")
        if not ok:
            raise AssertionError(f"spectrum_gather {label} off wrap_kernel")
        reset_counts()
        got = fu.kernel_stack_spectrum_fused(ks, shape)
        torch.cuda.synchronize()
        expect_counts(read_counts(), {"pass_a": 1, **forwarded(1)}, f"forwarding {label}")
        err, scale = compare(torch, f"forwarding {label}", got,
                             fu._stacked([fu._spectrum_sparse(k, shape) for k in ks]))
        log(f"forwarding {label}: against the einsum chain max|diff|/max {err / scale:.3e}"
            f" (tol 1e-6)")
        if not err <= 1e-6 * scale:
            raise AssertionError(f"forwarding {label} off the einsum chain")


def main():
    import torch

    t_start = time.perf_counter()
    dev = phase_device(torch)
    phase_build()
    records = phase_kernels(torch, dev)
    torch.cuda.empty_cache()
    phase_golden(torch, dev)
    rng = np.random.default_rng(0)
    launches = {}
    rates = phase_headline(torch, dev, rng, launches)
    torch.cuda.empty_cache()
    rates.update(phase_512(torch, dev, rng))
    torch.cuda.empty_cache()
    phase_cross_check(torch, dev)

    phase_fused_kernels(torch, dev, records)
    rates.update(phase_fused_headline(torch, dev, rng, launches))
    torch.cuda.empty_cache()
    rates.update(phase_fused_512(torch, dev, rng))
    torch.cuda.empty_cache()
    phase_fused_cross_check(torch, dev)
    phase_fused_limits(torch, dev)

    phase_rest_kernels(torch, dev, records)
    torch.cuda.empty_cache()
    rates.update(phase_carried(torch, dev, rng, launches))
    phase_thin(torch, dev, rng, launches)
    torch.cuda.empty_cache()
    phase_interleaved(torch, dev, launches)
    torch.cuda.empty_cache()
    phase_grad(torch, dev)
    torch.cuda.empty_cache()

    rates.update(phase_dft(torch, dev, rng))
    phase_direct(torch, dev)
    torch.cuda.empty_cache()
    auto_table = phase_auto_table(torch, dev, rng)
    phase_ladder(torch, dev)
    torch.cuda.empty_cache()
    phase_models(torch, dev, rng)
    torch.cuda.empty_cache()
    phase_front_ends(torch, dev)
    torch.cuda.empty_cache()
    phase_mesh(torch, dev, rng)
    torch.cuda.empty_cache()
    phase_batched(torch, dev, rng)
    torch.cuda.empty_cache()
    phase_bf16_kernels(torch, dev, records)
    rates["bf16"] = phase_bf16_main(torch, dev, rng, launches)
    torch.cuda.empty_cache()
    phase_wide(torch, dev, rng, auto_table)
    torch.cuda.empty_cache()
    phase_long(torch, dev, rng)
    torch.cuda.empty_cache()
    phase_forward_stack(torch, dev, records)

    log("rates (it/s, slope): " + json.dumps(rates))
    log("kernel timings at 256^3 and 512^3: " + json.dumps(records))
    log(f"chip_smoke total {time.perf_counter() - t_start:.1f} s")
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": SOURCES.get(name, SOURCE),
            "replaces": REPLACES[name],
            "launches": launches[name],
            **{key: records[name][key] for key in keys},
        }
        for name in KERNEL_NAMES
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)


if __name__ == "__main__":
    main()
