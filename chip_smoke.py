#!/usr/bin/env python3
"""Smoke test of heat_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. build every CUDA kernel of the package from ``heat_tpu_torch/csrc`` and
   print the registers and spills the compiler reports for the flash and
   pairwise kernels;
2. hold the Lloyd kernel against its plain PyTorch version on the card, at
   the shapes of the main path and at the edges of its range;
3. drive the k-means path, ``KMeans(n_clusters=8).fit`` on 10,000,000 x 16
   float32 samples split along the rows, for 30 iterations from a
   precomputed init; check that every iteration went through the kernel and
   that the result agrees with the torch path (``use_fused=False``) on the
   same card; run ``predict`` and a fit with ``init="random"``; hold the
   kernel against its plain version at the inputs of the fit's first
   launch; time it;
4. hold the flash-attention kernel against its plain PyTorch version on the
   card, at the attention path's shapes (f32 and bf16) and at the edges of
   its range, naming the design each shape runs (tensor cores for D <= 128,
   CUDA cores above); check that the main shape repeats bit for bit;
5. drive the attention path, the forward of the README's
   ``TransformerLM(vocab=50257, dim=768, depth=12, heads=12, max_len=32768)``
   with ``flash_attention(impl="pallas")`` in every block, over three
   requests of 4 x 4096 tokens; check that every block went through the
   kernel (12 launches per forward), that the logits are finite, repeat bit
   for bit and agree with the dense attention path on the same card; hold
   the kernel against its plain version at layer 0's own q, k, v; check the
   gradient through the kernel's autograd function; time the forward, the
   kernel, its plain version and ``scaled_dot_product_attention``;
6. hold the pairwise-distance kernel against its plain PyTorch version on
   the card, at ragged shapes, f from 1 to 600, n = 1, m = 0 (no launch),
   float64, strided operands, column blocks of a wider output (misaligned
   and 16-byte aligned) and an output whose row stride is not a multiple
   of 16 bytes;
7. drive the distance path on BASELINE's config 2, 100,000 x 64 float32
   points split along the rows: ``cdist`` (first and warm), ``manhattan``,
   ``rbf`` and ``cdist(quadratic_expansion=True)``, one 40 GB result at a
   time; check one kernel launch per exact call and about 2,000 sampled
   rows of each result against the plain version and a float64 version,
   the exact symmetry and the diagonal; time the kernel, its plain version
   and ``torch.cdist``;
8. run the ring schedules on a mesh of four shards on the one card:
   ``cdist`` and ``manhattan`` symmetric at n = 20,001 and ``cdist``
   general at 20,001 x 12,345, equal bit for bit to the one-shard results,
   with 12 and 16 launches; the quadratic expansion's ring within its
   tolerance;
9. drive the array library (no kernel of its own): the README quickstart
   (``README.md:29-33``) against float64; BASELINE config 1 (mean and std of
   1000 x 1000 float32, split=0, the protocol of
   ``benchmarks/statistical_moments.py``); sum, mean, var and std (ddof 0
   and 1), min, max, argmin and argmax over axis None/0/1 of 10,000,000 x
   16 and 32,768 x 32,768 float32 (normal + 3), each against float64 within
   its stated bound, timed beside its HBM bound and the one torch call, and
   the warm calls under ``torch.cuda.set_sync_debug_mode("error")``; on the
   tall array ``cumsum(axis=0)`` and the z-score; then four shards on the
   card with NaN padding, equal to one shard;
10. drive the linear algebra (no kernel of its own): BASELINE config 4,
   ``ht.linalg.qr`` of 10,000,000 x 512 float32, split=0, uncut, method
   'auto' (CholeskyQR2): the first call, the warm median of 3 and
   ``calc_q=False``, ‖A − QR‖_F/‖A‖_F, ‖QᵀQ − I‖_F and R's triangle in
   float64 row blocks within stated bounds, beside its FP32 and HBM
   bounds, the Gram as one GEMM, and ``torch.linalg.qr`` on the same A
   (the port's residual within 10x of it); peak ~61.5 GB (A, Q₁, Q); the
   probe's fallback to Householder on 1,000,000 x 512 with cond 1e5,
   where ``method='cholqr2'`` raises; then four shards on the card: TSQR
   and CholeskyQR2 on 2,000,003 x 512, the split-1 panel QR on 65,536 x
   2,048, matmul at all nine split pairs on 8,191 x 4,096 @ 4,096 x 2,047
   with NaN in every padding and the collectives of the case table, and
   the blocked ``solve_triangular`` at n = 8,192;
11. drive the training stack (no kernel of its own), BASELINE config 5:
   ``ResNet50(num_classes=10)`` at its published widths under
   ``DataParallel`` with ``SGD(0.05)`` on a synthetic CIFAR batch of 256
   (32 x 32 x 3 NHWC float32, 10 classes): one step against a plain
   PyTorch step from the same weights, the first step, the warm median of
   20 steps beside the step's FP32 and TF32 bounds, the same with
   ``cudnn.allow_tf32``, the peak memory, a profiled step by op kind and
   the loss falling over 30 steps; then four shards of the card:
   DataParallel on a ragged batch of 254 against one shard, DASO's cadence
   sweep against four-shard DataParallel with the collectives of each
   step type, and the README's Deep learning snippet;
12. print the phase-9, 10 and 11 numbers with the card, the card's name
   and power limit, one JSON line of per-kernel numbers, and the result
   line ``{"ok": true, "device": {...}}`` last.

It needs CUDA and the package beside it, and fails without either.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from functools import partial

SEED = 20261016
N, F, K = 10_000_000, 16, 8
ITERS = 30
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
TF32_FLOP_PER_S = 495e12  # H100 SXM, dense TF32 on the tensor cores
BF16_FLOP_PER_S = 989e12  # H100 SXM, dense bfloat16 on the tensor cores

# Tolerances, kernel against its plain version on the same inputs:
# * labels: the two sum a dot product in different orders, so a row whose
#   two best scores are within rounding may flip: at least 99.99% agree;
# * counts: exact, against the counts of the kernel's own labels;
# * sums: |d| <= 1e-4 |ref| + 1e-4 max|ref|, against the one-hot sums of the
#   kernel's own labels: f32 sums of ~1e5 terms in another order, where a
#   sum that cancels keeps an absolute error of the size of its terms;
# * inertia: |d| <= 1e-4 sum|min score|, normwise for the same reason.
# bfloat16 data is held to the same bounds: its products with bfloat16
# centers are exact in f32, so it differs from f32 only in the inputs.
LABEL_AGREEMENT = 0.9999
RTOL = 1e-4
# main path, fused fit against the torch fit from one init: the same
# iteration with its sums in another order, so rows whose two best scores
# tie to rounding (~0.005% of them here) may take the other label, each
# moving a center by |x|/count. Held normwise: max|dc| <= 1e-4 max|c|
# (an element of a mean of 10^6 rows that lies near 0 has no meaningful
# relative error), and the inertia within 1e-4 relative.
FIT_RTOL = 1e-4

# the attention path: the README's TransformerLM, requests of 4 x 4096 tokens
LM = dict(vocab=50257, dim=768, depth=12, heads=12, max_len=32768)
BATCH, SEQ, REQUESTS = 4, 4096, 3
# Tolerances, attention kernel against its plain version on the same inputs:
# * float32: |d| <= 2e-4 (1 + |ref|), the bound tests/test_attention.py holds
#   the TPU kernel to: the same math, its sums (over D, over the keys, and
#   the online rescaling) in another order;
# * float16 in and out: computed in f32 as above, then rounded to f16, where
#   an f32 difference may flip one rounding: the f32 bound plus one f16 ulp,
#   2^-10 |ref|;
# * bfloat16: both round q, p and the output to bf16 at the same points, but
#   the kernel rounds p against the running max of its key tiles and the
#   plain version against the row's max, so a rounding may go the other way:
#   |d| <= 2^-8 (max|v| + |ref|), two bf16 ulps of a weighted mean of v; and
#   against f32 dense attention within 0.05, the bound of
#   tests/test_attention.py for the TPU kernel in bf16.
ATTN_F32_TOL = 2e-4
F16_ULP = 2.0**-10
BF16_ULPS = 2.0**-8
BF16_VS_DENSE = 0.05
# main path, logits of the kernel path against the dense attention path on
# the same weights and tokens: 12 layers of the same f32 math with the
# attention summed in another order (and the scale folded into q before the
# product instead of after it): ||d||_F <= 1e-4 ||ref||_F.
LOGITS_RTOL = 1e-4
# the gradient through the kernel's autograd function (its backward re-runs
# the scan path) against autograd through dense attention: rtol = atol = 1e-4,
# the bound tests/test_ops_pallas.py holds the JAX custom VJP to.
GRAD_TOL = 1e-4

# the distance path: BASELINE's config 2 (BASELINE.md:26), cdist on
# 100,000 x 64 float32 points split along the rows
DIST_N, DIST_F = 100_000, 64
DIST_SIGMA = 8.0  # standard normal rows: E d² = 2f = 128, so rbf ≈ e^-1
SAMPLE_ROWS = 2000
PLAIN_BLOCK_ROWS = 4096
# torch.cdist launches one block per output element, so its grid of n·m
# blocks must fit in 32 bits: one call over the 10^10 elements here is
# wrong (printed by the main phase), and it is timed over row blocks of
# 20,000 (2·10^9 elements each) that cover the whole matrix
LIBRARY_BLOCK_ROWS = 20_000
RING_P, RING_N, RING_M = 4, 20_001, 12_345
F32_LANE_OPS_PER_S = F32_FLOP_PER_S / 2  # one FSUB, FADD or FFMA per lane; the flop rate counts an FMA as two
# Tolerances, with u the unit roundoff (2^-24 in float32, 2^-53 in float64):
# * the pairwise kernel against its plain version on the same inputs:
#   |d| <= 2(f+1)u|ref|. Both sum f nonnegative terms (squares or absolute
#   values of the same rounded differences), the kernel in sequence with
#   FMA and the plain version in torch's order; recursive summation of
#   nonnegative terms errs by at most (f+1)u of the sum, so each is within
#   (f+1)u|ref| of the exact sum. The same bound holds against a float64
#   version of the same rows, which is exact to f32 precision.
# * rbf against a float64 version: the argument -d²/(2σ²) inherits the
#   bound above, the exponential multiplies it by the value, and exp rounds
#   within 2u: |d| <= (2(f+1)u|arg| + 4u) |ref|.
# * the quadratic expansion against a float64 version, on d²: the product
#   x·y and the norms each err by at most (f+2)u(|x|² + |y|²), so
#   |d_q² − d²| <= 4(f+2)u(|x|² + |y|²); its ring against one shard, whose
#   products run in other blocks, within twice that.
def _unit(dtype) -> float:
    import torch

    return 2.0**-53 if dtype == torch.float64 else 2.0**-24


def _time_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def compare_lloyd(name, n, f, k, dtype, n_valid=None, nan_pad=False, misalign=False):
    """Kernel against plain on random inputs of one shape; see check_lloyd."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + n + f + k)
    x = torch.randn(n, f, generator=gen, device="cuda")
    centers = torch.randn(k, f, generator=gen, device="cuda")
    nv = n if n_valid is None else n_valid
    if nan_pad:
        x[nv:] = float("nan")
    x = x.to(dtype).contiguous()
    if misalign:  # a view one element past a 16-byte boundary: no vector loads
        buf = torch.empty(n * f + 1, dtype=dtype, device="cuda")
        buf[1:] = x.reshape(-1)
        x = buf[1:].view(n, f)
    return check_lloyd(name, x, centers, nv)


def check_lloyd(name, x, centers, nv):
    """Kernel against plain on the given inputs; raises on disagreement,
    returns the errors and the kernel's time per launch."""
    import torch
    import torch.nn.functional as Fn

    from heat_tpu_torch.ops import lloyd

    n, f = x.shape
    k = centers.shape[0]
    dtype = x.dtype
    sums, counts, inertia, labels = lloyd.lloyd_accumulate(x, centers, nv, return_labels=True)
    p_sums, p_counts, p_inertia, p_labels = lloyd.lloyd_accumulate_plain(
        x, centers, nv, return_labels=True
    )
    torch.cuda.synchronize()
    x32 = x[:nv].float()
    onehot = Fn.one_hot(labels.long(), k).float()
    ref_sums = onehot.T @ x32
    ref_counts = onehot.sum(0)
    scale = torch.amin(lloyd._scores(x32, centers, dtype == torch.bfloat16), 1).abs().sum()
    agree = (labels == p_labels).float().mean().item()
    err_sums = (sums - ref_sums).abs()
    err = {
        "sums_abs": err_sums.max().item(),
        "sums_rel": (err_sums / ref_sums.abs().clamp(min=1e-30)).max().item(),
        "counts_abs": (counts - ref_counts).abs().max().item(),
        "counts_vs_plain": (counts - p_counts).abs().sum().item(),
        "inertia_abs": abs(inertia.item() - p_inertia.item()),
        "inertia_rel": abs(inertia.item() - p_inertia.item()) / max(scale.item(), 1e-30),
        "label_agreement": agree,
    }
    err["ms"] = _time_ms(lambda: lloyd.lloyd_accumulate(x, centers, nv), 10)
    err["bound_ms"] = nv * f * x.element_size() / HBM_BYTES_PER_S * 1e3
    print(f"  {name}: n={n} n_valid={nv} f={f} k={k} {dtype}: {json.dumps(err)}")
    finite = all(bool(torch.isfinite(t).all()) for t in (sums, counts, inertia))
    ok = (
        finite
        and agree >= LABEL_AGREEMENT
        and err["counts_abs"] == 0
        and bool((err_sums <= RTOL * ref_sums.abs() + RTOL * ref_sums.abs().max()).all())
        and err["inertia_rel"] <= RTOL
    )
    if not ok:
        raise AssertionError(f"Lloyd kernel disagrees with its plain version on {name}")
    err["max_abs_err"] = max(err["sums_abs"], err["counts_abs"], err["inertia_abs"])
    return err


def profile_fit(ht, init, x) -> None:
    """One warm fit under torch.profiler: device time by kernel and the
    device's busy share of the fit's wall time."""
    import torch

    with _profiled() as prof:
        t0 = time.perf_counter()
        ht.cluster.KMeans(n_clusters=K, init=init, max_iter=ITERS, tol=-1.0).fit(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = _device_rows(prof)
    busy = sum(r[0] for r in rows)
    print(
        f"  profile of a warm fit: wall {wall_ms:.3f} ms (profiler on), device busy "
        f"{busy:.3f} ms ({100 * busy / wall_ms:.1f}%)"
    )
    for ms, count, key in rows[:8]:
        print(f"    {ms:9.3f} ms  {count:4d}x  {key[:90]}")


def _profiled():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _device_rows(prof):
    """(ms, count, name) of each kernel in a profile, by device time."""
    import torch

    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0) or getattr(ev, "self_cuda_time_total", 0)
        if us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    return rows


def kmeans_path(ht) -> dict:
    """Phases 2 and 3: the Lloyd kernel against plain, then the k-means
    path; returns the kernel's entry of the kernels line."""
    import torch

    from heat_tpu_torch.ops import lloyd

    # 2. kernel against plain
    print("phase kernels: lloyd against lloyd_accumulate_plain", flush=True)
    f32, bf16 = torch.float32, torch.bfloat16
    compare_lloyd("ragged f32", 1_000_003, 16, 8, f32)
    compare_lloyd("ragged bf16", 1_000_003, 16, 8, bf16)
    compare_lloyd("f=16 k=5 ragged", 999_999, 16, 5, f32)
    compare_lloyd("f=16 k=9 (tiled kernel)", 1_000_003, 16, 9, f32)
    compare_lloyd("f=64 k=17", 262_144, 64, 17, f32)
    compare_lloyd("f=16 k=8 misaligned", 100_003, 16, 8, bf16, misalign=True)
    compare_lloyd("f=64 k=17 misaligned", 10_001, 64, 17, bf16, misalign=True)
    compare_lloyd("f=16 k=8 n=5", 5, 16, 8, f32)
    compare_lloyd("f=512 k=128", 65_536, 512, 128, f32)
    compare_lloyd("f=512 k=128 bf16", 65_536, 512, 128, bf16)
    compare_lloyd("NaN padding", 100_037, 16, 8, f32, n_valid=100_000, nan_pad=True)
    torch.cuda.empty_cache()

    # 3. main path
    print(f"phase main: KMeans(n_clusters={K}).fit on {N} x {F} float32, split=0", flush=True)
    ht.use_device("gpu")
    ht.random.seed(SEED)
    noise = ht.random.randn(N, F, split=0)
    member = ht.random.randint(0, K, (N,), split=0)
    means = ht.random.randn(K, F)
    data = noise.larray + 8.0 * means.larray[member.larray.long()]
    del noise, member
    x = ht.array(data, split=0, copy=False)
    rows = ht.random.randint(0, N, (K,)).larray.long()
    init = ht.array(x.larray[rows])
    torch.cuda.synchronize()

    lloyd.LAUNCHES = 0
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fused = ht.cluster.KMeans(n_clusters=K, init=init, max_iter=ITERS, tol=-1.0).fit(x)
    stop.record()
    torch.cuda.synchronize()
    launches = lloyd.LAUNCHES
    fit_ms = start.elapsed_time(stop)
    if launches != ITERS:
        raise AssertionError(f"main path launched the Lloyd kernel {launches} times, not {ITERS}")

    oracle = ht.cluster.KMeans(
        n_clusters=K, init=init, max_iter=ITERS, tol=-1.0, use_fused=False
    ).fit(x)
    c_f, c_o = fused.cluster_centers_.larray, oracle.cluster_centers_.larray
    center_err = (c_f - c_o).abs().max().item()
    inertia_rel = abs(fused.inertia_ - oracle.inertia_) / abs(oracle.inertia_)
    label_agree = (fused.labels_.larray == oracle.labels_.larray).float().mean().item()
    print(
        f"  fused vs torch path: max|centers| diff {center_err:.3e}, inertia rel diff "
        f"{inertia_rel:.3e}, labels agree {label_agree:.7f}, n_iter {fused.n_iter_}",
        flush=True,
    )
    if not (
        torch.isfinite(c_f).all()
        and tuple(c_f.shape) == (K, F)
        and fused.labels_.shape == (N,)
        and fused.n_iter_ == ITERS
        and center_err <= FIT_RTOL * c_o.abs().max().item()
        and inertia_rel <= FIT_RTOL
    ):
        raise AssertionError("fused KMeans.fit disagrees with the torch path")
    pred = fused.predict(x)
    if pred.shape != (N,) or not bool((pred.larray == fused.labels_.larray).float().mean() > 0.999):
        raise AssertionError("predict disagrees with the fit's labels")
    # warm: the same fit again, allocator and plans in place
    start.record()
    ht.cluster.KMeans(n_clusters=K, init=init, max_iter=ITERS, tol=-1.0).fit(x)
    stop.record()
    torch.cuda.synchronize()
    warm_ms = start.elapsed_time(stop)
    profile_fit(ht, init, x)

    rnd = ht.cluster.KMeans(n_clusters=K, init="random", max_iter=ITERS, random_state=SEED).fit(x)
    if not (torch.isfinite(rnd.cluster_centers_.larray).all() and rnd.inertia_ > 0):
        raise AssertionError("KMeans(init='random') gave no finite result")
    print(f"  init='random': inertia {rnd.inertia_:.6e} after {rnd.n_iter_} iterations")

    # kernel against its plain version at the main path's inputs: the shard
    # and the centers of the fit's first launch
    xs = lloyd.stream_operand(x.shards[0])
    c32 = init.larray.float().contiguous()
    main_err = check_lloyd("main path inputs", xs, c32, N)
    kernel_ms = main_err["ms"]
    plain_ms = _time_ms(lambda: lloyd.lloyd_accumulate_plain(xs, c32, N), 5)
    data_bytes = N * F * 4
    bytes_moved = data_bytes + K * F * 4 + (K * F + K + 1) * 4
    flops = 2 * N * K * F + N * F + N * K
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    ms_iter = fit_ms / ITERS
    warm_iter = warm_ms / ITERS
    print(
        f"  fit: {ms_iter:.4f} ms/iteration first fit, {warm_iter:.4f} warm "
        f"({data_bytes / (warm_iter * 1e-3) / 1e9:.1f} GB/s of samples); kernel alone {kernel_ms:.4f} ms ({data_bytes / (kernel_ms * 1e-3) / 1e9:.1f} "
        f"GB/s); HBM bound {t_bytes:.4f} ms at 3.35 TB/s; plain {plain_ms:.4f} ms",
        flush=True,
    )
    return {
        "name": "lloyd",
        "route": "cuda",
        "source": "heat_tpu_torch/csrc/lloyd.cu",
        "replaces": "heat_tpu/ops/lloyd.py:105",
        "launches": launches,
        "max_abs_err": main_err["max_abs_err"],
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "fit_ms_per_iter": ms_iter,
        "warm_fit_ms_per_iter": warm_iter,
    }


def attention_bound(q, k, causal: bool, design: str) -> dict:
    """The least time the card could take for one attention forward on these
    inputs: the larger of the bytes (q, k, v read once, the output written
    once) and the operations the design does on them (4·D flops per (query,
    key) pair the mask keeps) at the card's peak for their type. All three
    operation bounds are returned; the kernel is held to its design's:
    ``wgmma_3xtf32`` runs three TF32 products per f32 product (3 x flops at
    495 TFLOP/s), ``mma_bf16`` one bf16 product (989 TFLOP/s),
    ``cuda_cores`` one f32 FMA per multiply-add (67 TFLOP/s)."""
    B, S, H, D = q.shape
    sk = k.shape[1]
    if causal:  # query i keeps keys 0..min(i, sk-1)
        pairs = sum(min(i + 1, sk) for i in range(S))
    else:
        pairs = S * sk
    flops = 4 * B * H * pairs * D
    bounds = {
        "bound_3xtf32_ms": 3 * flops / TF32_FLOP_PER_S * 1e3,
        "bound_cuda_cores_ms": flops / F32_FLOP_PER_S * 1e3,
        "bound_bf16_ms": flops / BF16_FLOP_PER_S * 1e3,
    }
    held_to = {"wgmma_3xtf32": "bound_3xtf32_ms", "mma_bf16": "bound_bf16_ms",
               "cuda_cores": "bound_cuda_cores_ms"}[design]
    t_ops = bounds[held_to]
    t_bytes = (2 * q.numel() * q.element_size() + 2 * k.numel() * k.element_size()) / HBM_BYTES_PER_S * 1e3
    return {
        "flops": flops,
        **bounds,
        "bound_held_to": held_to,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
    }


def check_flash(name, q, k, v, causal: bool, reps: int = 10, repeat: bool = False) -> dict:
    """Attention kernel against its plain version on the given inputs; raises
    on disagreement, returns the design, the errors, the kernel's time per
    launch and its bounds. With ``repeat``, a second launch must equal the
    first bit for bit."""
    import torch

    from heat_tpu_torch.nn.attention import dot_product_attention
    from heat_tpu_torch.ops import flash

    design = flash.kernel_design(q.shape[-1], q.dtype)
    out = flash.flash_attention_kernel(q, k, v, causal=causal)
    ref = flash.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    if out.shape != q.shape or out.dtype != q.dtype:
        raise AssertionError(f"attention kernel gave {tuple(out.shape)} {out.dtype} on {name}")
    o32, r32 = out.float(), ref.float()
    d = (o32 - r32).abs()
    if q.dtype == torch.bfloat16:
        bound = BF16_ULPS * (v.float().abs().max() + r32.abs())
    elif q.dtype == torch.float16:
        bound = ATTN_F32_TOL * (1 + r32.abs()) + F16_ULP * r32.abs()
    else:
        bound = ATTN_F32_TOL * (1 + r32.abs())
    ok = bool(torch.isfinite(o32).all()) and bool((d <= bound).all())
    err = {
        "design": design,
        "max_abs_err": d.max().item() if d.numel() else 0.0,
        "max_rel_err": (d / r32.abs().clamp(min=1e-6)).max().item() if d.numel() else 0.0,
    }
    if repeat:
        err["repeats_bit_for_bit"] = bool(torch.equal(out, flash.flash_attention_kernel(q, k, v, causal=causal)))
        ok = ok and err["repeats_bit_for_bit"]
    if q.dtype == torch.bfloat16:
        dense = dot_product_attention(q.float(), k.float(), v.float(), causal=causal)
        err["vs_f32_dense"] = (o32 - dense).abs().max().item()
        ok = ok and err["vs_f32_dense"] <= BF16_VS_DENSE
    err["ms"] = _time_ms(lambda: flash.flash_attention_kernel(q, k, v, causal=causal), reps)
    err.update(attention_bound(q, k, causal, design))
    err["tflops"] = err["flops"] / (err["ms"] * 1e-3) / 1e12
    print(
        f"  {name}: q {tuple(q.shape)} k {tuple(k.shape)} {q.dtype} causal={causal}: "
        f"{json.dumps(err)}",
        flush=True,
    )
    if not ok:
        raise AssertionError(f"attention kernel disagrees with its plain version on {name}")
    return err


def compare_flash(name, B, S, H, D, dtype, causal, sk=None, reps=10, repeat=False, row_pad=0) -> dict:
    """Kernel against plain on random inputs of one shape; see check_flash.
    ``row_pad`` > 0 makes q, k and v views of [..., D + row_pad] arrays, so
    their head stride is D + row_pad elements."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + S + D)
    sk = S if sk is None else sk
    q, k, v = (
        torch.randn(B, n, H, D + row_pad, generator=gen, device="cuda").to(dtype)[..., :D]
        for n in (S, sk, sk)
    )
    return check_flash(name, q, k, v, causal, reps, repeat)


def check_flash_gradient() -> None:
    """The gradient through the kernel's autograd function against autograd
    through dense attention, at (1, 512, 4, 64) causal float32."""
    import torch

    from heat_tpu_torch.nn.attention import dot_product_attention, flash_attention

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    inputs = [torch.randn(1, 512, 4, 64, generator=gen, device="cuda") for _ in range(3)]
    grads = []
    for fn in (partial(flash_attention, impl="pallas"), dot_product_attention):
        leaves = [t.clone().requires_grad_() for t in inputs]
        out = fn(*leaves, causal=True)
        (out**2).sum().backward()
        grads.append([t.grad for t in leaves])
    diffs = ", ".join(
        f"{name} {(a - b).abs().max().item():.3e} (max|ref| {b.abs().max().item():.3e})"
        for name, a, b in zip("qkv", *grads)
    )
    print(f"  gradient through the kernel vs dense, max|d|: {diffs}", flush=True)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=GRAD_TOL, atol=GRAD_TOL)


def profile_forward(model, tokens) -> None:
    """One warm forward under torch.profiler: device time by kernel, the
    attention kernel's share and the matrix products' share."""
    import torch

    with _profiled() as prof:
        t0 = time.perf_counter()
        model(tokens)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = _device_rows(prof)
    busy = sum(r[0] for r in rows)
    attn = sum(r[0] for r in rows if "flash_fwd_kernel" in r[2])
    gemm = sum(r[0] for r in rows if "gemm" in r[2].lower() or "cutlass" in r[2].lower())
    # the Dense layers' products: q, k, v, out and the MLP (12 dim² per
    # block) and the head, 2 flops per multiply-add per token
    dim = LM["dim"]
    gemm_flops = 2 * tokens.numel() * (LM["depth"] * 12 * dim * dim + dim * LM["vocab"])
    print(
        f"  profile of a warm forward: wall {wall_ms:.3f} ms (profiler on), device busy "
        f"{busy:.3f} ms ({100 * busy / wall_ms:.1f}%); attention kernel {attn:.3f} ms "
        f"({100 * attn / busy:.1f}%), matrix products {gemm:.3f} ms ({100 * gemm / busy:.1f}%) "
        f"against their bound {gemm_flops / F32_FLOP_PER_S * 1e3:.3f} ms "
        f"({gemm_flops / 1e12:.3f} TFLOP at 67 TFLOP/s f32)",
        flush=True,
    )
    for ms, count, key in rows[:10]:
        print(f"    {ms:9.3f} ms  {count:4d}x  {key[:90]}")


def attention_path(ht) -> dict:
    """Phases 4 and 5: the attention kernel against plain, then the
    TransformerLM forward; returns the kernel's entry of the kernels line."""
    import torch
    import torch.nn.functional as Fn

    from heat_tpu_torch.nn.attention import flash_attention
    from heat_tpu_torch.ops import flash

    # 4. kernel against plain
    print("phase kernels: flash against flash_attention_plain", flush=True)
    f32, bf16 = torch.float32, torch.bfloat16
    head_dim = LM["dim"] // LM["heads"]
    compare_flash("main shape", BATCH, SEQ, LM["heads"], head_dim, f32, True, reps=3, repeat=True)
    compare_flash("main shape bf16", BATCH, SEQ, LM["heads"], head_dim, bf16, True, reps=3, repeat=True)
    compare_flash("4k D=96", 1, 4096, 8, 96, f32, True, reps=3)
    compare_flash("4k D=128", 1, 4096, 8, 128, f32, True, reps=3)
    compare_flash("4k D=128 non-causal", 1, 4096, 8, 128, f32, False, reps=3)
    compare_flash("4k D=128 bf16", 1, 4096, 8, 128, bf16, True, reps=3)
    compare_flash("ragged S", 2, 1000, 4, 64, f32, False)
    compare_flash("cross", 1, 70, 2, 16, f32, False, sk=300)
    compare_flash("cross causal", 1, 70, 2, 16, f32, True, sk=300)
    compare_flash("D=8", 1, 130, 2, 8, f32, True)
    compare_flash("D=24", 1, 517, 2, 24, f32, False)
    compare_flash("D=24, head stride 25 (element-wise loads)", 1, 517, 2, 24, f32, True, row_pad=1)
    compare_flash("D=40 bf16, head stride 44 (element-wise loads)", 1, 300, 3, 40, bf16, True, row_pad=4)
    compare_flash("D=256", 1, 1024, 2, 256, f32, True)
    compare_flash("D=512", 1, 1024, 2, 512, f32, True)
    compare_flash("D=512 bf16", 1, 1024, 2, 512, bf16, False)
    compare_flash("S=1", 3, 1, 4, 64, f32, False)
    compare_flash("S=1 causal", 3, 1, 4, 64, f32, True)
    compare_flash("f16", 2, 333, 3, 40, torch.float16, True)
    torch.cuda.empty_cache()

    # 5. main path
    print(
        f"phase main: TransformerLM({', '.join(f'{k}={v}' for k, v in LM.items())}) forward, "
        f"{REQUESTS} requests of {BATCH} x {SEQ} tokens, attention through the kernel",
        flush=True,
    )
    model = ht.nn.TransformerLM(
        **LM, attention_fn=partial(flash_attention, impl="pallas"), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(SEED),
    )
    n_params = sum(p.numel() for p in model.parameters())
    requests = [
        torch.randint(0, LM["vocab"], (BATCH, SEQ), device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(SEED + i))
        for i in range(REQUESTS)
    ]
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in requests]
    with torch.inference_mode():
        flash.LAUNCHES = 0
        finite = []
        for i, (tokens, (start, stop)) in enumerate(zip(requests, events)):
            start.record()
            logits = model(tokens)
            stop.record()
            if i == 0:
                first = logits
            finite.append(tuple(logits.shape) == (BATCH, SEQ, LM["vocab"]) and torch.isfinite(logits).all())
        torch.cuda.synchronize()
        launches = flash.LAUNCHES
        forward_ms = [a.elapsed_time(b) for a, b in events]
        del logits
        if launches != LM["depth"] * REQUESTS:
            raise AssertionError(
                f"the forwards launched the attention kernel {launches} times, not "
                f"{LM['depth']} per forward"
            )
        if not all(bool(f) for f in finite):
            raise AssertionError("a forward gave logits of the wrong shape or not finite")
        again = model(requests[0])
        if not torch.equal(first, again):
            raise AssertionError("two forwards on the same tokens differ")
        del again
        # the same model with the dense attention path (attention_fn=None)
        for block in model.blocks:
            block.attn.attention_fn = None
        dense = model(requests[0])
        rel = ((first - dense).norm() / dense.norm()).item()
        max_abs = (first - dense).abs().max().item()
        print(
            f"  logits, kernel path vs dense path: ||d||_F/||ref||_F {rel:.3e}, max|d| "
            f"{max_abs:.3e} (max|ref| {dense.abs().max().item():.3e})",
            flush=True,
        )
        if not rel <= LOGITS_RTOL:
            raise AssertionError("the kernel path's logits disagree with the dense path's")
        del dense, first
        torch.cuda.empty_cache()
        # layer 0's own q, k, v
        captured = []

        def capture(q, k, v, causal):
            captured.append((q, k, v))
            return flash_attention(q, k, v, causal=causal, impl="pallas")

        for block in model.blocks:
            block.attn.attention_fn = partial(flash_attention, impl="pallas")
        model.blocks[0].attn.attention_fn = capture
        model(requests[0])
        model.blocks[0].attn.attention_fn = partial(flash_attention, impl="pallas")
        q, k, v = captured[0]
        main = check_flash("main path layer 0 inputs", q, k, v, True, reps=5)
        plain_ms = _time_ms(lambda: flash.flash_attention_plain(q, k, v, causal=True), 3)
        scale = 1.0 / math.sqrt(q.shape[-1])
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        library_ms = _time_ms(
            lambda: Fn.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=scale), 5
        )
        profile_forward(model, requests[1])
    torch.cuda.empty_cache()
    check_flash_gradient()

    warm_ms = sorted(forward_ms[1:])[len(forward_ms[1:]) // 2]
    tokens_per_s = BATCH * SEQ / (warm_ms * 1e-3)
    print(
        f"  forward: {n_params} parameters; {forward_ms[0]:.3f} ms first, {warm_ms:.3f} ms warm "
        f"(requests {', '.join(f'{t:.3f}' for t in forward_ms)} ms), {tokens_per_s:.1f} tokens/s; "
        f"kernel ({main['design']}) {main['ms']:.4f} ms per launch at {tuple(q.shape)} causal f32 "
        f"({main['tflops']:.2f} TFLOP/s), held to {main['bound_ms']:.4f} ms ({main['bound_by']}: "
        f"3 x {main['flops'] / 1e9:.1f} GFLOP at 495 TFLOP/s TF32); CUDA-core bound "
        f"{main['bound_cuda_cores_ms']:.4f} ms (67 TFLOP/s f32), bf16 bound {main['bound_bf16_ms']:.4f} ms "
        f"(989 TFLOP/s); plain {plain_ms:.4f} ms; scaled_dot_product_attention {library_ms:.4f} ms",
        flush=True,
    )
    return {
        "name": "flash",
        "route": "cuda",
        "source": "heat_tpu_torch/csrc/flash.cu",
        "replaces": "heat_tpu/ops/flash.py:53",
        "launches": launches,
        "max_abs_err": main["max_abs_err"],
        "ms": main["ms"],
        "plain_ms": plain_ms,
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": library_ms,
        "design": main["design"],
        "bound_held_to": main["bound_held_to"],
        "bound_3xtf32_ms": main["bound_3xtf32_ms"],
        "bound_cuda_cores_ms": main["bound_cuda_cores_ms"],
        "bound_bf16_ms": main["bound_bf16_ms"],
        "forward_ms_first": forward_ms[0],
        "forward_ms_warm": warm_ms,
        "tokens_per_s": tokens_per_s,
    }


def pairwise_bound(n: int, m: int, f: int, itemsize: int) -> dict:
    """The least time the card could take for an (n, m) distance matrix over
    f features: the larger of the bytes (x and y read once, the output
    written once) over HBM and 2·n·m·f lane instructions over the f32 rate."""
    t_ops = 2 * n * m * f / F32_LANE_OPS_PER_S * 1e3
    t_bytes = ((n + m) * f + n * m) * itemsize / HBM_BYTES_PER_S * 1e3
    return {
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
    }


def _rbf_finish(d2, sigma: float = DIST_SIGMA):
    return d2.div_(-(2.0 * sigma * sigma)).exp_()


def check_within(name, got, ref, bound) -> float:
    """Raise unless |got - ref| <= bound everywhere and got is finite; return
    the largest |got - ref|."""
    import torch

    d = (got.double() - ref.double()).abs()
    if not (bool(torch.isfinite(got).all()) and bool((d <= bound).all())):
        worst = (d - bound).argmax().item()
        raise AssertionError(
            f"{name}: |d| {d.flatten()[worst].item():.3e} exceeds its bound "
            f"{torch.as_tensor(bound).double().expand_as(d).flatten()[worst].item():.3e}"
        )
    return d.max().item() if d.numel() else 0.0


def compare_pairwise(name, x, y, out=None) -> float:
    """The kernel against its plain version on x and y, for L2 with and
    without the sqrt and for L1; raises on disagreement, returns the largest
    absolute error."""
    import torch

    from heat_tpu_torch.ops import pairwise

    u = _unit(x.dtype)
    f = x.shape[1]
    errs = []
    for p, post in ((2, True), (2, False), (1, False)):
        got = pairwise.pairwise_kernel(x, y, p, post, out)
        ref = pairwise.pairwise_plain(x, y, p, post)
        torch.cuda.synchronize()
        errs.append(check_within(f"{name} p={p} sqrt={post}", got, ref, 2 * (f + 1) * u * ref.double().abs()))
    item = x.element_size()
    ldo = y.shape[0] if out is None or x.shape[0] <= 1 else out.stride(0)
    paths = {
        "x": pairwise.aligned16(x.data_ptr(), x.stride(0), item),
        "y": pairwise.aligned16(y.data_ptr(), y.stride(0), item),
        "out": out is None or pairwise.aligned16(out.data_ptr(), ldo, item),
    }
    print(
        f"  {name}: x {tuple(x.shape)} y {tuple(y.shape)} {x.dtype}: max|d| {max(errs):.3e} "
        f"(bound 2(f+1)u|ref|, 2(f+1)u = {2 * (f + 1) * u:.3e}); 16-byte access "
        + ", ".join(f"{k} {'yes' if v else 'no'}" for k, v in paths.items()),
        flush=True,
    )
    return max(errs)


def distance_kernel_phase() -> None:
    """Phase 6: the pairwise kernel against its plain version at the edges
    of its range."""
    import torch

    from heat_tpu_torch.ops import pairwise

    print("phase kernels: pairwise against pairwise_plain", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    compare_pairwise("ragged n, m", randn(1000, 7), randn(1303, 7))
    compare_pairwise("f=1", randn(1000, 1), randn(1303, 1))
    compare_pairwise("f=33", randn(1000, 33), randn(1303, 33))
    compare_pairwise("f=600", randn(517, 600), randn(300, 600))
    compare_pairwise("n=1", randn(1, 64), randn(1303, 64))
    compare_pairwise("m=1", randn(129, 64), randn(1, 64))
    compare_pairwise("float64", randn(1000, 33, dtype=torch.float64), randn(1303, 33, dtype=torch.float64))
    base = randn(3000, 64)
    compare_pairwise("strided row blocks", base[100:1100, :33], base[::3, :33])
    for c0 in (650, 1024):  # a misaligned and a 16-byte aligned column block
        wide = torch.full((1000, 2000), float("nan"), device="cuda")
        compare_pairwise(f"column block at {c0} of a wider output", base[:1000], base[1000:1700],
                         wide[:, c0:c0 + 700])
        if not (bool(torch.isnan(wide[:, :c0]).all()) and bool(torch.isnan(wide[:, c0 + 700:]).all())):
            raise AssertionError("the kernel wrote outside its column block")
    odd = torch.full((1000, 1305), float("nan"), device="cuda")
    compare_pairwise("f=64, output row stride 1305", randn(1000, 64), randn(1303, 64), odd[:, :1303])
    if not bool(torch.isnan(odd[:, 1303:]).all()):
        raise AssertionError("the kernel wrote past its output's columns")
    before = pairwise.LAUNCHES
    empty = pairwise.pairwise_kernel(base[:5], base[:0], 2, True)
    if pairwise.LAUNCHES != before or tuple(empty.shape) != (5, 0):
        raise AssertionError("m = 0 launched the kernel or gave the wrong shape")
    print("  m=0: no launch, shape (5, 0)", flush=True)
    torch.cuda.synchronize()


def _time_once_ms(fn) -> float:
    import torch

    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop)


def check_sampled_rows(name, D, x, idx, p: int, post: bool, rbf: bool) -> float:
    """Sampled rows of a full exact result against the plain version and a
    float64 version of the same rows; the exact symmetry on sampled pairs and
    the diagonal. Returns the largest error against the plain version."""
    import torch

    from heat_tpu_torch.ops import pairwise

    f = x.shape[1]
    u = _unit(x.dtype)
    got = D[idx]
    plain = pairwise.pairwise_plain(x[idx], x, p, post)
    exact = pairwise.pairwise_plain(x[idx].double(), x.double(), p, post)
    if rbf:
        arg = exact / (2.0 * DIST_SIGMA * DIST_SIGMA)
        plain, exact = _rbf_finish(plain), _rbf_finish(exact)
        bound = (2 * (f + 1) * u * arg + 4 * u) * exact.abs()
        err_plain = check_within(f"{name} vs plain", got, plain, 2 * bound)
    else:
        bound = 2 * (f + 1) * u * exact.abs()
        err_plain = check_within(f"{name} vs plain", got, plain, 2 * (f + 1) * u * plain.double().abs())
    err_exact = check_within(f"{name} vs float64", got, exact, bound)
    del plain, exact
    jdx = idx.flip(0)
    pairs_equal = bool(torch.equal(D[idx, jdx], D[jdx, idx]))
    diag = D[idx, idx]
    diag_ok = bool((diag == (1.0 if rbf else 0.0)).all())
    print(
        f"  {name}: {idx.numel()} sampled rows, max|d| vs plain {err_plain:.3e}, vs float64 "
        f"{err_exact:.3e}; sampled pairs symmetric bit for bit: {pairs_equal}; diagonal "
        f"{'1' if rbf else '0'}: {diag_ok}",
        flush=True,
    )
    if not (pairs_equal and diag_ok):
        raise AssertionError(f"{name}: not exactly symmetric or a wrong diagonal")
    return err_plain


def distance_main_phase(ht) -> dict:
    """Phase 7: the distance path at 100,000 x 64; returns the kernel's entry
    of the kernels line."""
    import torch

    from heat_tpu_torch.ops import pairwise

    n, f = DIST_N, DIST_F
    print(
        f"phase main: cdist, manhattan, rbf(sigma={DIST_SIGMA}) and cdist(quadratic_expansion=True) "
        f"on {n} x {f} float32, split=0",
        flush=True,
    )
    ht.use_device("gpu")
    ht.random.seed(SEED)
    X = ht.random.randn(n, f, split=0)
    x = X.larray
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    idx = torch.randperm(n, generator=gen, device="cuda")[:SAMPLE_ROWS].sort().values
    xn = (x.double() ** 2).sum(1)
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    out_gbps = lambda ms: n * n * 4 / (ms * 1e-3) / 1e9  # noqa: E731

    timings, errs = {}, {}
    pairwise.LAUNCHES = 0
    calls = [
        ("cdist", lambda: ht.spatial.cdist(X), 2, True, False),
        ("cdist warm", lambda: ht.spatial.cdist(X), 2, True, False),
        ("manhattan", lambda: ht.spatial.manhattan(X), 1, False, False),
        ("rbf", lambda: ht.spatial.rbf(X, sigma=DIST_SIGMA), 2, False, True),
    ]
    for name, call, p, post, rbf in calls:
        before = pairwise.LAUNCHES
        start.record()
        D = call()
        stop.record()
        torch.cuda.synchronize()
        timings[name] = start.elapsed_time(stop)
        if pairwise.LAUNCHES - before != 1:
            raise AssertionError(f"{name} launched the kernel {pairwise.LAUNCHES - before} times, not once")
        if D.shape != (n, n) or D.split != 0 or D.larray.dtype != torch.float32:
            raise AssertionError(f"{name} gave {D.shape} split={D.split} {D.larray.dtype}")
        errs[name] = check_sampled_rows(name, D.larray, x, idx, p, post, rbf)
        print(
            f"  {name}: {timings[name]:.3f} ms, {out_gbps(timings[name]):.1f} GB/s of output written",
            flush=True,
        )
        del D
    launches = pairwise.LAUNCHES
    before = launches
    start.record()
    Q = ht.spatial.cdist(X, quadratic_expansion=True)
    stop.record()
    torch.cuda.synchronize()
    timings["cdist quadratic"] = start.elapsed_time(stop)
    if pairwise.LAUNCHES != before:
        raise AssertionError("the quadratic expansion launched the pairwise kernel")
    exact2 = pairwise.pairwise_plain(x[idx].double(), x.double(), 2, False)
    q_err = check_within(
        "cdist quadratic vs float64, on d²", Q.larray[idx].double() ** 2, exact2,
        4 * (f + 2) * _unit(torch.float32) * (xn[idx, None] + xn[None, :]),
    )
    del Q, exact2
    print(
        f"  cdist quadratic: {timings['cdist quadratic']:.3f} ms, "
        f"{out_gbps(timings['cdist quadratic']):.1f} GB/s of output written; max|d²| vs float64 {q_err:.3e}",
        flush=True,
    )
    torch.cuda.empty_cache()

    # yardsticks, never on the path
    out = torch.empty((n, n), device="cuda")
    kernel_ms = _time_ms(lambda: pairwise.pairwise_kernel(x, x, 2, True, out), 3)
    kernel_l1_ms = _time_ms(lambda: pairwise.pairwise_kernel(x, x, 1, False, out), 3)
    block = x[:PLAIN_BLOCK_ROWS]
    plain_block_ms = _time_ms(lambda: pairwise.pairwise_plain(block, x, 2, True), 1)
    plain_ms = _time_once_ms(lambda: pairwise.pairwise_plain(x, x, 2, True, out))
    del out
    torch.cuda.empty_cache()
    library_ms = {}
    for p in (2.0, 1.0):
        head = torch.cdist(x[:256], x, p=p, compute_mode="donot_use_mm_for_euclid_dist")
        check_within(
            f"torch.cdist p={p}", head, pairwise.pairwise_plain(x[:256], x, int(p), p == 2.0),
            2 * (f + 1) * _unit(torch.float32) * head.double().abs(),
        )
        del head

        def library(p=p):
            for r0 in range(0, n, LIBRARY_BLOCK_ROWS):
                torch.cdist(x[r0 : r0 + LIBRARY_BLOCK_ROWS], x, p=p, compute_mode="donot_use_mm_for_euclid_dist")

        library_ms[p] = _time_once_ms(library)
        torch.cuda.empty_cache()
    # why the row blocks: one call over the whole matrix, checked on the
    # sampled rows (a record of torch.cdist's limit, not a check of the port)
    whole = torch.cdist(x, x, p=2.0, compute_mode="donot_use_mm_for_euclid_dist")
    ref = pairwise.pairwise_plain(x[idx], x, 2, True)
    row_ok = ((whole[idx] - ref).abs() <= 2 * (f + 1) * _unit(torch.float32) * ref.abs()).all(1)
    del whole, ref
    torch.cuda.empty_cache()
    bad = idx[~row_ok]
    print(
        f"  one torch.cdist call over the whole matrix: {int(row_ok.sum())} of {idx.numel()} sampled "
        f"rows right; first wrong sampled row {bad[0].item() if bad.numel() else None} "
        f"(n² mod 2^32 elements end in row {n * n % 2**32 // n})",
        flush=True,
    )
    bound = pairwise_bound(n, n, f, 4)
    info = pairwise.kernel_info()
    print(
        f"  kernel alone: L2 {kernel_ms:.3f} ms ({out_gbps(kernel_ms):.1f} GB/s of output), L1 "
        f"{kernel_l1_ms:.3f} ms ({out_gbps(kernel_l1_ms):.1f} GB/s); bound {bound['bound_ms']:.3f} ms "
        f"({bound['bound_by']}: 2·n²·f lane instructions at 33.5 T/s; the {n * n * 4 / 1e9:.0f} GB "
        f"output takes {n * n * 4 / HBM_BYTES_PER_S * 1e3:.3f} ms at 3.35 TB/s); plain {plain_ms:.3f} ms for the "
        f"whole matrix, {plain_block_ms:.3f} ms for a block of {PLAIN_BLOCK_ROWS} rows; torch.cdist "
        f"(donot_use_mm_for_euclid_dist, row blocks of {LIBRARY_BLOCK_ROWS}) p=2 {library_ms[2.0]:.3f} ms, "
        f"p=1 {library_ms[1.0]:.3f} ms; build: {info['registers']} registers, {info['local_bytes']} "
        f"bytes spilled per thread, {info['ctas_per_sm']} CTAs per SM",
        flush=True,
    )
    return {
        "name": "pairwise",
        "route": "cuda",
        "source": "heat_tpu_torch/csrc/pairwise.cu",
        "replaces": "heat_tpu/ops/pairwise.py:58",
        "launches": launches,
        "max_abs_err": max(errs.values()),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound["bound_ms"],
        "bound_by": bound["bound_by"],
        "library_ms": library_ms[2.0],
        **info,
        "l1_ms": kernel_l1_ms,
        "l1_library_ms": library_ms[1.0],
        "library_one_call_rows_right": int(row_ok.sum()),
        "plain_block_ms": plain_block_ms,
        "plain_block_rows": PLAIN_BLOCK_ROWS,
        "cdist_ms_first": timings["cdist"],
        "cdist_ms_warm": timings["cdist warm"],
        "manhattan_ms": timings["manhattan"],
        "rbf_ms": timings["rbf"],
        "cdist_quadratic_ms": timings["cdist quadratic"],
    }


def distance_ring_phase(ht) -> None:
    """Phase 8: the two ring schedules over four shards on the one card,
    against the one-shard results."""
    import torch

    from heat_tpu_torch.core.communication import MeshCommunication
    from heat_tpu_torch.ops import pairwise

    card = torch.device("cuda", 0)
    mesh1 = MeshCommunication([card])
    mesh4 = MeshCommunication([card] * RING_P)
    print(
        f"phase rings: {RING_P} shards on one card, symmetric at n={RING_N}, general at "
        f"{RING_N} x {RING_M}, f={DIST_F}",
        flush=True,
    )
    ht.random.seed(SEED + 1)
    a = ht.random.randn(RING_N, DIST_F, comm=mesh1).larray
    b = ht.random.randn(RING_M, DIST_F, comm=mesh1).larray
    A1, B1 = ht.array(a, split=0, comm=mesh1), ht.array(b, split=0, comm=mesh1)
    ht.use_comm(mesh4)
    try:
        A4, B4 = ht.array(a, split=0), ht.array(b, split=0)
        if A4.comm.size != RING_P or not A4.padded:
            raise AssertionError("the ring operand is not split over four padded shards")
        paired, self_paired = ht.spatial.distance._sym_schedule(RING_P)
        sym_launches = RING_P * (1 + len(paired) + int(self_paired))
        cases = [
            ("cdist symmetric", ht.spatial.cdist, (A4,), (A1,), sym_launches),
            ("manhattan symmetric", ht.spatial.manhattan, (A4,), (A1,), sym_launches),
            ("cdist general", ht.spatial.cdist, (A4, B4), (A1, B1), RING_P * RING_P),
        ]
        for name, fn, ring_args, one_args, expected in cases:
            pairwise.LAUNCHES = 0
            t0 = time.perf_counter()
            ring = fn(*ring_args)
            torch.cuda.synchronize()
            ring_ms = (time.perf_counter() - t0) * 1e3
            launches = pairwise.LAUNCHES
            one = fn(*one_args)
            same = ring.shape == one.shape and bool(torch.equal(ring.larray, one.larray))
            print(
                f"  {name}: {ring.shape}, {launches} launches (schedule: {expected}), {ring_ms:.3f} ms "
                f"wall; equal to one shard bit for bit: {same}",
                flush=True,
            )
            if launches != expected or not same or ring.split != 0:
                raise AssertionError(f"{name}: the ring disagrees with one shard")
            del ring, one
        ring = ht.spatial.cdist(A4, quadratic_expansion=True).larray.double() ** 2
        one = ht.spatial.cdist(A1, quadratic_expansion=True).larray.double() ** 2
        norms = (a.double() ** 2).sum(1)
        err = check_within(
            "cdist quadratic ring vs one shard, on d²", ring, one,
            8 * (DIST_F + 2) * _unit(torch.float32) * (norms[:, None] + norms[None, :]),
        )
        print(f"  cdist quadratic symmetric: max|d²| against one shard {err:.3e}", flush=True)
        del ring, one
    finally:
        ht.use_comm(None)
    torch.cuda.empty_cache()


def distance_path(ht) -> dict:
    """Phases 6 to 8; returns the pairwise kernel's entry of the kernels line."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    distance_kernel_phase()
    torch.cuda.empty_cache()
    entry = distance_main_phase(ht)
    distance_ring_phase(ht)
    peak = torch.cuda.max_memory_allocated()
    print(f"  distance path: peak device memory {peak / 1e9:.3f} GB", flush=True)
    entry["peak_memory_gb"] = peak / 1e9
    return entry


# the array library's path (phase 9): the README quickstart (README.md:29-33)
# and BASELINE config 1 (BASELINE.md:22: statistical moments of 1000 x 1000
# float32, split=0, the protocol of benchmarks/statistical_moments.py), then
# the moments on two arrays of the size users hold on one card: a tall
# feature table (the k-means configuration's) and a square 4 GiB matrix,
# standard normal + 3.0 so that a variance computed as E[x²] - E[x]² would
# cancel; and a four-shard mesh on the one card with a padded last shard
MOMENT_ARRAYS = {"tall": (10_000_000, 16), "square": (32_768, 32_768)}
MOMENT_OFFSET = 3.0
MOMENT_REPS = 10
MESH_ROWS = 10_000_003  # 4 shards of 2,500,001 rows: one padding row
MESH_P = 4
U32 = 2.0**-24
# Tolerances of phase 9, each result against float64 on the same card, with
# L = ceil(log2 n) for n reduced elements and u = 2^-24:
# * sum: |d| <= 4·L·u·Σ|x|. Pairwise summation errs by at most L·u·Σ|x|;
#   torch's CUDA reduction adds short sequential runs in each thread before
#   its tree, which the factor 4 covers at their typical (√k) error;
# * mean: the sum's bound over n, plus u|mean| for the division;
# * var: the deviations d = x - μ carry u(|x| + |μ|) each, their squares
#   2|d|u(|x| + |μ|), and their sum the sum's bound:
#   |d_var|·(n - ddof) <= 4·L·u·(Σd² + 2Σ|d|(|x| + |μ|)), plus u·var;
# * std: the var bound over 2·std, plus 2u·std;
# * min, max, argmin, argmax: exact (every f32 value is exact in f64);
# * cumsum along n rows: the engine scans blocks of b = ⌈√n⌉ rows, then the
#   c blocks' totals, each as torch's CUDA scan along dim 0 does it, one
#   sequential chain per column; a prefix so carries two chains, of at most
#   b and c terms, and one addition. A chain of k terms errs by at most
#   (k-1)·u·Σ|x| and, its rounding errors being of either sign, by λ·√k·u·Σ|x|
#   with probability 1 - 2k·exp(-λ²/2) (Higham and Mary, 2019): the bound is
#   8·(√b + √c + 1)·u times the running Σ|x| (λ = 8: 1 - 1e-10 at k = 3163);
# * the z-score (x - mean(x, 0)) / std(x, 0): the mean's and std's bounds
#   carried through, plus 4u for the subtraction and the division.
MOMENT_OPS = ("sum", "mean", "var", "var ddof=1", "std", "std ddof=1", "min", "max", "argmin", "argmax")


def _moment_fns(ht, name: str):
    """The port's call and the one torch call over the whole tensor that
    computes the same thing, each as f(x, axis)."""
    import torch

    base, _, ddof = name.partition(" ddof=")
    kwargs = {"ddof": int(ddof or 0)} if base in ("var", "std") else {}
    torch_fn = {"sum": torch.sum, "mean": torch.mean, "min": torch.amin, "max": torch.amax}.get(base)

    def mine(x, axis):
        return getattr(ht, base)(x, axis, **kwargs)

    def lib(t, axis):
        if base in ("var", "std"):
            return getattr(torch, base)(t, dim=axis, correction=kwargs["ddof"])
        if base in ("argmin", "argmax"):
            return getattr(torch, base)(t, dim=axis)
        return torch_fn(t, dim=() if axis is None else axis)

    return mine, lib


class Moments64:
    """float64 references and bounds of the moments of one f32 tensor."""

    def __init__(self, t):
        self.t64 = t.double()

    def of(self, axis):
        import torch

        t64 = self.t64
        dim = tuple(range(t64.ndim)) if axis is None else (axis,)
        n = math.prod(t64.shape[d] for d in dim)
        level = math.ceil(math.log2(max(n, 2)))
        abs_sum = t64.abs().sum(dim)
        total = t64.sum(dim)
        mean = total / n
        kept = mean.reshape([1 if d in dim else s for d, s in enumerate(t64.shape)])
        dev = t64 - kept
        sq = dev.square().sum(dim)
        weight = t64.abs().add_(kept.abs())
        cross = dev.abs_().mul_(weight).sum(dim)
        del dev, weight
        out = {
            "sum": (total, 4 * level * U32 * abs_sum),
            "mean": (mean, 4 * level * U32 * abs_sum / n + U32 * mean.abs()),
        }
        for ddof in (0, 1):
            var = sq / (n - ddof)
            var_bound = 4 * level * U32 * (sq + 2 * cross) / (n - ddof) + U32 * var
            std = var.sqrt()
            suffix = "" if ddof == 0 else " ddof=1"
            out["var" + suffix] = (var, var_bound)
            out["std" + suffix] = (std, var_bound / (2 * std) + 2 * U32 * std)
        for name, fn in (("min", torch.amin), ("max", torch.amax)):
            out[name] = (fn(t64, dim=dim), None)
        for name, fn in (("argmin", torch.argmin), ("argmax", torch.argmax)):
            out[name] = (fn(t64) if axis is None else fn(t64, dim=axis), None)
        return out


def scan_bound(n: int) -> float:
    """The cumsum bound of phase 9 over n rows, per unit of the running Σ|x|."""
    from heat_tpu_torch.core.arithmetics import scan_blocks

    b, c = scan_blocks(n)
    return 8 * (math.sqrt(b) + math.sqrt(c) + 1) * U32


def _check_moment(label, got, ref_and_bound) -> float:
    import torch

    ref, bound = ref_and_bound
    got = got.reshape(ref.shape)
    if bound is None:
        if not torch.equal(got.to(ref.dtype), ref):
            raise AssertionError(f"{label}: not equal to the float64 result")
        return 0.0
    return check_within(label, got, ref, bound)


def _median_ms(fn, reps: int = MOMENT_REPS) -> float:
    """Warm median of one call, CUDA events around each."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return sorted(times)[len(times) // 2]


def quickstart_phase(ht):
    """README.md:29-33 verbatim, checked against float64 on the card."""
    import torch

    print("phase moments: the README quickstart (README.md:29-33)", flush=True)
    ht.random.seed(SEED)
    x = ht.arange(1_000_000, dtype=ht.float32, split=0)
    y = ht.random.randn(1_000_000, split=0)
    z = x * 2 + y
    s = ht.sum(z)
    m = ht.mean(z.reshape((1000, 1000)), axis=0)
    if z.larray.device.type != "cuda" or s.larray.device.type != "cuda":
        raise AssertionError("the quickstart did not run on the card")
    z64 = torch.arange(1_000_000, dtype=torch.float64, device=z.larray.device) * 2 + y.larray.double()
    # z rounds once to f32 (u|z|) before the sums of phase 9's bounds
    s_err = check_within("quickstart sum", s.larray, z64.sum(), (4 * 20 + 1) * U32 * z64.abs().sum())
    cols = z64.reshape(1000, 1000)
    m64 = cols.mean(0)
    m_err = check_within("quickstart mean", m.larray, m64, (4 * 10 + 1) * U32 * cols.abs().mean(0) + U32 * m64.abs())
    print(
        f"  z = x * 2 + y {z.gshape} split={z.split}; s = {s.item():.6e} (|d| {s_err:.3e} against float64); "
        f"m {m.gshape} split={m.split} (max|d| {m_err:.3e})",
        flush=True,
    )
    return z


def baseline_moments_phase(ht) -> dict:
    """BASELINE config 1 with the protocol of benchmarks/statistical_moments.py:
    a warm-up, 10 trials of the call and its read-back, the minimum."""
    import torch

    print("phase moments: BASELINE config 1, mean and std of 1000 x 1000 float32, split=0", flush=True)
    ht.random.seed(SEED)
    x = ht.random.randn(1000, 1000, split=0)
    ref64 = Moments64(x.larray)
    results = {}
    for name, fn in (("mean", ht.mean), ("std", ht.std)):
        for axis in (None, 0, 1):
            fn(x, axis)
            times = []
            for _ in range(MOMENT_REPS):
                start = time.perf_counter()
                r = fn(x, axis)
                r.numpy() if r.ndim else float(r.larray)
                times.append(time.perf_counter() - start)
            _check_moment(f"baseline {name} axis={axis}", fn(x, axis).larray, ref64.of(axis)[name])
            results[f"{name}_axis{axis}"] = min(times) * 1e3
    print(f"  ms (minimum of {MOMENT_REPS} trials, the call and its read-back): {json.dumps(results)}", flush=True)
    return results


def moments_at_size(ht, label: str, shape) -> dict:
    """Every moment over axis None/0/1 against float64, timed beside its HBM
    bound and the whole-tensor torch call; the warm calls must not sync."""
    import torch

    ht.random.seed(SEED + 2)
    x = ht.random.randn(*shape, split=0) + MOMENT_OFFSET
    t = x.larray
    ref64 = Moments64(t)
    print(f"phase moments: {label} {shape[0]} x {shape[1]} float32 (normal + {MOMENT_OFFSET}), split=0", flush=True)
    rows = {}
    for axis in (None, 0, 1):
        refs = ref64.of(axis)
        for name in MOMENT_OPS:
            mine, lib = _moment_fns(ht, name)
            result = mine(x, axis)
            err = _check_moment(f"{label} {name} axis={axis}", result.larray, refs[name])
            ms = _median_ms(lambda: mine(x, axis))
            lib_ms = _median_ms(lambda: lib(t, axis))
            out_bytes = result.larray.numel() * result.larray.element_size()
            bound_ms = (t.numel() * t.element_size() + out_bytes) / HBM_BYTES_PER_S * 1e3
            rows[f"{name} axis={axis}"] = {"ms": ms, "torch_ms": lib_ms, "bound_ms": bound_ms, "max_abs_err": err}
            print(
                f"  {name} axis={axis}: {ms:.4f} ms, torch {lib_ms:.4f} ms, HBM bound {bound_ms:.4f} ms "
                f"({t.numel() * 4 / ms / 1e6:.1f} GB/s read); max|d| against float64 {err:.3e}",
                flush=True,
            )
    # the warm calls under the sync check: any wait for the host raises
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for axis in (None, 0, 1):
            for name in MOMENT_OPS:
                _moment_fns(ht, name)[0](x, axis)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print(f"  {len(MOMENT_OPS) * 3} warm calls ran under set_sync_debug_mode('error'): no host sync", flush=True)
    if label == "tall":
        ref_cum = ref64.t64.cumsum(0)
        bound = scan_bound(shape[0]) * ref64.t64.abs().cumsum(0)
        err = check_within("tall cumsum axis=0", ht.cumsum(x, 0).larray, ref_cum, bound)
        del ref_cum, bound
        mean0, std0 = ht.mean(x, 0), ht.std(x, 0)
        z = (x - mean0) / std0
        refs = ref64.of(0)
        (m64, m_bound), (s64, s_bound) = refs["mean"], refs["std"]
        z64 = (ref64.t64 - m64) / s64
        z_bound = (m_bound + 4 * U32 * (ref64.t64.abs() + m64.abs())) / s64 + z64.abs() * (s_bound / s64 + 4 * U32)
        z_err = check_within("tall z-score", z.larray, z64, z_bound)
        rows["cumsum axis=0"] = {"ms": _median_ms(lambda: ht.cumsum(x, 0)), "max_abs_err": err}
        rows["z-score"] = {"ms": _median_ms(lambda: (x - ht.mean(x, 0)) / ht.std(x, 0)), "max_abs_err": z_err}
        print(
            f"  cumsum axis=0: {rows['cumsum axis=0']['ms']:.4f} ms, max|d| {err:.3e}; z-score: "
            f"{rows['z-score']['ms']:.4f} ms, max|d| {z_err:.3e}",
            flush=True,
        )
    del ref64
    return rows


def moments_mesh_phase(ht, z) -> None:
    """Four shards on the one card, the last one padded and its padding NaN:
    every reduction equals the one-shard result (exactly for min, max,
    argmin, argmax; within twice the float64 bound for the rest)."""
    import torch

    from heat_tpu_torch.core.communication import MeshCommunication

    card = z.larray.device
    mesh1, mesh4 = MeshCommunication([card]), MeshCommunication([card] * MESH_P)
    print(f"phase moments: {MESH_P} shards on one card, {MESH_ROWS} x 16 float32 with NaN padding", flush=True)
    ht.random.seed(SEED + 3)
    x1 = ht.random.randn(MESH_ROWS, 16, split=0, comm=mesh1) + MOMENT_OFFSET
    ht.use_comm(mesh4)
    try:
        x4 = ht.array(x1.larray, split=0)
        pad = x4.shards[-1].shape[0] * MESH_P - MESH_ROWS
        if not x4.padded or pad < 1:
            raise AssertionError("the four-shard operand has no padding")
        x4.shards[-1][-pad:] = float("nan")
        ref64 = Moments64(x1.larray)
        for axis in (None, 0, 1):
            refs = ref64.of(axis)
            for name in MOMENT_OPS:
                mine = _moment_fns(ht, name)[0]
                r4, r1 = mine(x4, axis).larray, mine(x1, axis).larray
                if not bool(torch.isfinite(r4.double()).all()):
                    raise AssertionError(f"four shards, {name} axis={axis}: not finite")
                ref, bound = refs[name]
                if bound is None:
                    same = torch.equal(r4, r1)
                else:
                    same = bool(((r4.double() - r1.double()).abs().reshape(ref.shape) <= 2 * bound).all())
                if not same:
                    raise AssertionError(f"four shards, {name} axis={axis}: differs from one shard")
        # each against float64 within its bound, the four shards' with
        # their exscan of four totals on top
        cum_bound = (2 * scan_bound(MESH_ROWS) + 4 * U32) * ref64.t64.abs().cumsum(0)
        cum_err = check_within("four shards cumsum axis=0", ht.cumsum(x4, 0).larray, ht.cumsum(x1, 0).larray, cum_bound)
        del cum_bound, ref64
        x4_cols = ht.resplit(x4, 1)
        if not torch.equal((x4 * x4_cols).larray, (x1 * x1).larray) or (x4 * x4_cols).split != 0:
            raise AssertionError("four shards: split=0 times split=1 differs from one split")
        z4 = ht.array(z.larray, split=0)
        if not torch.equal(z4.reshape((1000, 1000)).larray, z.reshape((1000, 1000)).larray):
            raise AssertionError("four shards: the quickstart's reshape differs from one shard")
    finally:
        ht.use_comm(None)
    print(
        f"  {len(MOMENT_OPS) * 3} reductions equal one shard (exact or within twice their bound), all finite; "
        f"cumsum max|d| {cum_err:.3e}; split 0 x split 1 equal to one split; reshape(1000, 1000) equal",
        flush=True,
    )


def moments_path(ht, smi: str) -> dict:
    """Phase 9: the array library on the card; returns its numbers."""
    import torch

    z = quickstart_phase(ht)
    numbers = {"card": smi, "baseline_config_1_ms": baseline_moments_phase(ht)}
    for label, shape in MOMENT_ARRAYS.items():
        numbers[label] = moments_at_size(ht, label, shape)
        torch.cuda.empty_cache()
    moments_mesh_phase(ht, z)
    return numbers



# the linear algebra path (phase 10): no kernel of its own. heat_tpu hands
# every product and small factorization of heat_tpu/core/linalg to XLA, so
# the port runs torch.matmul and torch.linalg on the card (ROADMAP.md:15-16).
# BASELINE.md:28, tracked config 4: qr of a 10^7 x 512 float32 array,
# split=0, uncut; then CholeskyQR2's probe on an ill-conditioned operand, and
# four shards on the one card for TSQR, CholeskyQR2, the split-1 panel QR,
# matmul at every split pair and the blocked triangular solve.
QR_SHAPE = (10_000_000, 512)
QR_REPS = 3
# the yardstick, torch.linalg.qr, on the same A when A, its working copy
# and its Q fit beside the port's memory; else on the first 4,000,000 rows
# (m n below 2^31, 8 GB per copy), the port measured on those rows too
YARDSTICK_ROWS = 4_000_000
FALLBACK_SHAPE, FALLBACK_COND = (1_000_000, 512), 1e5
LINALG_P = 4
TSQR_SHAPE = (2_000_003, 512)  # 4 shards of 500,001 rows: one padding row
PANEL_SHAPE = (65_536, 2_048)
MATMUL_SHAPE = (8_191, 4_096, 2_047)  # (m, k, n): m and n ragged over 4 shards
TRI_N, TRI_K = 8_192, 16
F64_ROWS = 262_144  # rows per float64 block of the QR checks
# Bounds of phase 10, in float64 on the card, u = 2^-24, for an m x n QR:
# * ‖A − QR‖_F / ‖A‖_F <= 4 √n u (5.4e-6 at n = 512). Q R reproduces each
#   element as an n-term sum whose rounding errors have random signs, ~√n u
#   (Higham §3.5's probabilistic bound); Householder's backward error and
#   CholeskyQR2's residual are both of that order in practice (the worst
#   cases, c m n u, lie far above); and the port within 10x of
#   torch.linalg.qr's on the same A.
# * ‖QᵀQ − I‖_F <= 16 √n u (2.2e-5 at n = 512): each of the n² entries of
#   QᵀQ is an inner product of computed columns, in error by ~u/√n each for
#   Householder, whose Frobenius norm is then ~√n u; CholeskyQR2's second
#   pass restores the same order once its first pass's error is below 1
#   (the probe's 0.5), if its Gram matrix is accurate: hence the Gram in row
#   chunks (qr._GRAM_ROWS), held here against one GEMM over all rows.
# * R upper triangular: exactly zero below the diagonal.
QR_RESIDUAL_UNITS = 4  # times √n u
QR_ORTHOGONALITY_UNITS = 16  # times √n u
QR_VS_HOUSEHOLDER = 10
# * four-shard R against the one-shard R of the same method (TSQR against
#   Householder, the panel QR against torch.linalg.qr), normwise: two
#   backward-stable factorizations of one A, their sums in other orders, so
#   ‖ΔR‖_F / ‖R‖_F <= 16 √n u (cond(A) <= 1.4 for these normal operands,
#   so no conditioning factor).
# * matmul: |C − C64| <= k u (|A| |B|) elementwise, the rigorous bound of a
#   k-term float32 dot product in any order (γ_k, Higham §3.5).
# * triangular solve: the componentwise backward error
#   |b − T x| <= 2 n u (|T| |x|): substitution errs by γ_n (Higham §8.1);
#   the blocked schedule's folds are GEMMs of the same terms, hence 2.


def _qr_module():
    import importlib

    return importlib.import_module("heat_tpu_torch.core.linalg.qr")


def _timed(fn):
    """(result, ms) of one call, CUDA events around it."""
    import torch

    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def qr_errors(a, q, r) -> dict:
    """‖A − QR‖_F / ‖A‖_F, ‖QᵀQ − I‖_F and the largest |R| below the
    diagonal, in float64, F64_ROWS rows at a time (a 10^7 x 512 A alone is
    41 GB in float64)."""
    import torch

    m, n = a.shape
    r64 = r.double()
    gram = torch.zeros((n, n), dtype=torch.float64, device=a.device)
    res2 = torch.zeros((), dtype=torch.float64, device=a.device)
    a2 = torch.zeros((), dtype=torch.float64, device=a.device)
    for i in range(0, m, F64_ROWS):
        a64, q64 = a[i:i + F64_ROWS].double(), q[i:i + F64_ROWS].double()
        res2 += (a64 - q64 @ r64).square().sum()
        a2 += a64.square().sum()
        gram += q64.mT @ q64
    eye = torch.eye(n, dtype=torch.float64, device=a.device)
    return {
        "residual": (res2 / a2).sqrt().item(),
        "orthogonality": torch.linalg.matrix_norm(gram - eye).item(),
        "below_diagonal": r.tril(-1).abs().max().item(),
    }


def check_qr(label, errs, n) -> None:
    """Raise unless errs lie within phase 10's QR bounds."""
    residual = QR_RESIDUAL_UNITS * math.sqrt(n) * U32
    orthogonality = QR_ORTHOGONALITY_UNITS * math.sqrt(n) * U32
    if not (errs["residual"] <= residual and errs["orthogonality"] <= orthogonality and errs["below_diagonal"] == 0):
        raise AssertionError(
            f"{label}: residual {errs['residual']:.3e} (bound {residual:.3e}), orthogonality "
            f"{errs['orthogonality']:.3e} (bound {orthogonality:.3e}), below the diagonal {errs['below_diagonal']}"
        )


def _r_difference(r, r_ref) -> float:
    """‖s R − R_ref‖_F / ‖R_ref‖_F, s = sign(diag R) sign(diag R_ref): two
    QR factorizations agree up to the signs of R's rows."""
    import torch

    s = torch.sign(torch.diagonal(r)) * torch.sign(torch.diagonal(r_ref))
    return (torch.linalg.matrix_norm(s[:, None] * r.double() - r_ref.double()) / torch.linalg.matrix_norm(r_ref.double())).item()


def qr_main_phase(ht) -> dict:
    """BASELINE config 4: ht.linalg.qr of 10^7 x 512 float32, split=0,
    method 'auto' (CholeskyQR2 here): the first call, the warm median, R
    alone; the errors in float64; torch.linalg.qr beside it."""
    import torch

    m, n = QR_SHAPE
    methods = _qr_module()._METHODS
    print(f"phase linalg: BASELINE config 4, qr of {m} x {n} float32, split=0, method='auto'", flush=True)
    ht.random.seed(SEED + 4)
    x = ht.random.randn(m, n, split=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    methods.clear()
    (q, r), first_ms = _timed(lambda: ht.linalg.qr(x))
    peak = torch.cuda.max_memory_allocated()
    if dict(methods) != {"cholqr2": 1} or q.split != 0 or r.split is not None:
        raise AssertionError(f"qr took {dict(methods)}, Q split {q.split}, R split {r.split}: not CholeskyQR2")
    errs = qr_errors(x.larray, q.larray, r.larray)
    check_qr("qr 10^7 x 512", errs, n)
    r_full = r.larray.clone()
    del q, r
    warm_ms = _median_ms(lambda: ht.linalg.qr(x), QR_REPS)
    q_none, r_only = ht.linalg.qr(x, calc_q=False)
    if q_none is not None or not torch.equal(r_only.larray, r_full):
        raise AssertionError("qr(calc_q=False): Q not None, or R differs from the full call's")
    r_only_ms = _median_ms(lambda: ht.linalg.qr(x, calc_q=False), QR_REPS)
    flops = 4 * 2 * m * n * n  # four GEMMs of 2 m n² (two Grams, two formations)
    hbm = 6 * m * n * 4  # A read twice, Q1 written and read twice, Q written
    numbers = {
        "shape": [m, n], "method": "cholqr2", "first_ms": first_ms, "warm_ms": warm_ms,
        "r_only_ms": r_only_ms, "peak_memory_gb": peak / 1e9, **errs,
        "fp32_bound_ms": flops / F32_FLOP_PER_S * 1e3, "hbm_bound_ms": hbm / HBM_BYTES_PER_S * 1e3,
        "gram_rows": _qr_module()._GRAM_ROWS,
    }
    print(
        f"  qr: first {first_ms:.1f} ms, warm {warm_ms:.1f} ms (median of {QR_REPS}), R only {r_only_ms:.1f} ms; "
        f"bounds: fp32 {numbers['fp32_bound_ms']:.1f} ms ({flops / 1e12:.1f} TFLOP), HBM "
        f"{numbers['hbm_bound_ms']:.1f} ms ({hbm / 1e9:.1f} GB); peak {peak / 1e9:.2f} GB; residual "
        f"{errs['residual']:.3e}, orthogonality {errs['orthogonality']:.3e}",
        flush=True,
    )
    numbers["gram_in_one_gemm"] = gram_in_one_gemm(ht, x)
    numbers["torch_linalg_qr"] = householder_yardstick(ht, x, errs)
    return numbers


def gram_in_one_gemm(ht, x) -> dict:
    """The same qr with each Gram matrix as one GEMM over all rows, for the
    record: its orthogonality and warm time beside the chunked default."""
    qr_module = _qr_module()
    chunk = qr_module._GRAM_ROWS
    qr_module._GRAM_ROWS = x.gshape[0]
    try:
        q, r = ht.linalg.qr(x)
        errs = qr_errors(x.larray, q.larray, r.larray)
        del q, r
        ms = _median_ms(lambda: ht.linalg.qr(x), QR_REPS)
    finally:
        qr_module._GRAM_ROWS = chunk
    print(
        f"  the Gram as one GEMM over all {x.gshape[0]} rows instead of chunks of {chunk}: warm {ms:.1f} ms, "
        f"residual {errs['residual']:.3e}, orthogonality {errs['orthogonality']:.3e}",
        flush=True,
    )
    return {"warm_ms": ms, **errs}


def householder_yardstick(ht, x, port_errs) -> dict:
    """torch.linalg.qr on the same A when it fits, else on its first
    YARDSTICK_ROWS rows (the port timed and checked there too); the port's
    residual within QR_VS_HOUSEHOLDER of Householder's."""
    import torch

    t = x.larray
    m, n = t.shape
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    rows = m if free > 2.25 * t.numel() * t.element_size() else YARDSTICK_ROWS
    a = t[:rows]
    (qh, rh), first_ms = _timed(lambda: torch.linalg.qr(a))
    errs = qr_errors(a, qh, rh)
    del qh, rh
    ms = _median_ms(lambda: torch.linalg.qr(a), 1)
    out = {"rows": rows, "first_ms": first_ms, "ms": ms, **errs}
    if rows != m:
        sub = ht.array(a, split=0, copy=False)
        port_errs = qr_errors(a, *(f.larray for f in ht.linalg.qr(sub)))
        out["port_ms"] = _median_ms(lambda: ht.linalg.qr(sub), QR_REPS)
        out["port_residual"] = port_errs["residual"]
    if port_errs["residual"] > QR_VS_HOUSEHOLDER * errs["residual"]:
        raise AssertionError(
            f"qr: residual {port_errs['residual']:.3e} exceeds {QR_VS_HOUSEHOLDER}x torch.linalg.qr's {errs['residual']:.3e}"
        )
    print(
        f"  torch.linalg.qr on {rows} x {n}: first {first_ms:.1f} ms, then {ms:.1f} ms; residual "
        f"{errs['residual']:.3e}, orthogonality {errs['orthogonality']:.3e}"
        + (f"; the port there {out['port_ms']:.1f} ms" if rows != m else ""),
        flush=True,
    )
    return out


def qr_fallback_phase(ht) -> dict:
    """CholeskyQR2's probe on cond(A) = 1e5, past its ~3e3 float32 limit:
    'auto' falls back to Householder, 'cholqr2' raises."""
    import torch

    m, n = FALLBACK_SHAPE
    methods = _qr_module()._METHODS
    print(f"phase linalg: the probe's fallback, {m} x {n} float32 with cond {FALLBACK_COND:.0e}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    u = torch.linalg.qr(torch.randn(m, n, generator=gen, device="cuda"))[0]
    v = torch.linalg.qr(torch.randn(n, n, generator=gen, device="cuda"))[0]
    s = torch.logspace(0, -math.log10(FALLBACK_COND), n, device="cuda")
    a = (u * s) @ v.mT
    del u, v
    x = ht.array(a, split=0, copy=False)
    methods.clear()
    (q, r), ms = _timed(lambda: ht.linalg.qr(x))
    if dict(methods) != {"householder": 1}:
        raise AssertionError(f"qr of an ill-conditioned operand took {dict(methods)}, not the Householder fallback")
    errs = qr_errors(a, q.larray, r.larray)
    check_qr("qr fallback", errs, n)
    try:
        ht.linalg.qr(x, method="cholqr2")
    except ValueError:
        pass
    else:
        raise AssertionError("qr(method='cholqr2') did not raise on cond 1e5")
    print(
        f"  'auto' fell back to Householder ({dict(methods)}) in {ms:.1f} ms; residual {errs['residual']:.3e}, "
        f"orthogonality {errs['orthogonality']:.3e}; 'cholqr2' raised",
        flush=True,
    )
    return {"ms": ms, "method": "householder", **errs}


def counting_mesh(devices):
    """A MeshCommunication that counts its collectives and the bytes put
    into each."""
    import collections

    from heat_tpu_torch.core.communication import MeshCommunication

    class CountingMesh(MeshCommunication):
        def __init__(self, devices):
            super().__init__(devices)
            self.calls, self.bytes = collections.Counter(), collections.Counter()

        def _count(self, verb, shards):
            self.calls[verb] += 1
            self.bytes[verb] += sum(
                t.numel() * t.element_size() for s in shards for t in (s if isinstance(s, tuple) else (s,))
            )

        def allgather(self, shards, dim=0):
            self._count("allgather", shards)
            return super().allgather(shards, dim)

        def allreduce(self, shards, op="sum"):
            self._count("allreduce", shards)
            return super().allreduce(shards, op)

        def bcast(self, shards, root=0):
            self._count("bcast", shards[root:root + 1])
            return super().bcast(shards, root)

        def sub(self, ranks):
            # a group counts into its parent's counters
            group = CountingMesh([self.devices[r] for r in ranks])
            group.calls, group.bytes = self.calls, self.bytes
            return group

    return CountingMesh(devices)


def _poison_padding(x) -> int:
    """NaN into the padding of each shard; returns the padding's length."""
    if x.split is None or not x.padded:
        return 0
    for s, c in zip(x.shards, x.counts_displs()[0]):
        s.narrow(x.split, c, s.shape[x.split] - c).fill_(float("nan"))
    return x.shards[0].shape[x.split] * x.comm.size - x.gshape[x.split]


def linalg_mesh_phase(ht) -> dict:
    """Four shards on the one card: TSQR, CholeskyQR2 and the panel QR
    against one shard or torch.linalg.qr; matmul at all nine split pairs
    against float64, each with its collectives; the blocked triangular
    solve. NaN fills every padding, so a padded row or column that entered
    a contraction would show."""
    import torch

    from heat_tpu_torch.core.communication import MeshCommunication

    card = torch.device("cuda", 0)
    mesh1, mesh4 = MeshCommunication([card]), counting_mesh([card] * LINALG_P)
    methods = _qr_module()._METHODS
    out = {}
    r_bound = 16 * math.sqrt(TSQR_SHAPE[1]) * U32
    print(f"phase linalg: {LINALG_P} shards on one card", flush=True)
    ht.random.seed(SEED + 6)
    a1 = ht.random.randn(*TSQR_SHAPE, split=0, comm=mesh1)
    a4 = ht.array(a1.larray, split=0, comm=mesh4)
    pad = _poison_padding(a4)
    for method in ("tsqr", "cholqr2"):
        methods.clear()
        mesh4.calls.clear()
        (q4, r4), ms = _timed(lambda: ht.linalg.qr(a4, method=method))
        if dict(methods) != {method: 1}:
            raise AssertionError(f"four shards, method={method!r} ran {dict(methods)}")
        errs = qr_errors(a1.larray, q4.larray, r4.larray)
        check_qr(f"four shards {method}", errs, TSQR_SHAPE[1])
        r1 = (torch.linalg.qr(a1.larray, mode="r")[1] if method == "tsqr" else ht.linalg.qr(a1, method=method)[1].larray)
        diff = _r_difference(r4.larray, r1)
        if diff > r_bound:
            raise AssertionError(f"four shards {method}: R differs from one shard by {diff:.3e} (bound {r_bound:.3e})")
        if method == "tsqr" and not bool((q4.shards[-1][-pad:] == 0).all()):
            raise AssertionError("four shards tsqr: the padding rows of Q are not zero")
        out[method] = {"shape": list(TSQR_SHAPE), "ms": ms, "r_difference": diff, "collectives": dict(mesh4.calls), **errs}
        print(
            f"  {method} on {TSQR_SHAPE[0]} x {TSQR_SHAPE[1]} ({pad} NaN padding row): {ms:.1f} ms, residual "
            f"{errs['residual']:.3e}, orthogonality {errs['orthogonality']:.3e}, R against one shard "
            f"{diff:.3e}; collectives {dict(mesh4.calls)}",
            flush=True,
        )
        del q4, r4
    del a1, a4

    m, n = PANEL_SHAPE
    p1 = ht.random.randn(m, n, split=1, comm=mesh1)
    p4 = ht.array(p1.larray, split=1, comm=mesh4)
    methods.clear()
    mesh4.calls.clear()
    (q4, r4), ms = _timed(lambda: ht.linalg.qr(p4))
    if dict(methods) != {"panel": 1} or q4.split != 1 or r4.split != 1:
        raise AssertionError(f"four shards split=1 ran {dict(methods)}, Q split {q4.split}, R split {r4.split}")
    errs = qr_errors(p1.larray, q4.larray, r4.larray)
    check_qr("four shards panel", errs, n)
    (_, rh), h_ms = _timed(lambda: torch.linalg.qr(p1.larray))
    diff = _r_difference(r4.larray, rh)
    panel_bound = 16 * math.sqrt(n) * U32  # cond of a 32:1 normal matrix ≈ 1.4
    if diff > panel_bound:
        raise AssertionError(f"four shards panel: R differs from torch.linalg.qr's by {diff:.3e} (bound {panel_bound:.3e})")
    out["panel"] = {"shape": [m, n], "ms": ms, "torch_linalg_qr_ms": h_ms, "r_difference": diff, "collectives": dict(mesh4.calls), **errs}
    print(
        f"  panel QR on {m} x {n} split=1: {ms:.1f} ms (torch.linalg.qr {h_ms:.1f} ms), residual {errs['residual']:.3e}, "
        f"orthogonality {errs['orthogonality']:.3e}, R against Householder {diff:.3e}; collectives {dict(mesh4.calls)}",
        flush=True,
    )
    del p1, p4, q4, r4, rh

    mm, k, nn = MATMUL_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    a = torch.randn(mm, k, generator=gen, device="cuda")
    b = torch.randn(k, nn, generator=gen, device="cuda")
    c64 = a.double() @ b.double()
    bound = k * U32 * (a.double().abs() @ b.double().abs())
    a_bytes, b_bytes = a.numel() * 4, b.numel() * 4
    expected = {  # (split of C, collectives) of the reference's case table
        (None, None): (None, {}), (0, None): (0, {}), (None, 1): (1, {}),
        (0, 0): (0, {"allgather": b_bytes}), (0, 1): (0, {"allgather": b_bytes}),
        (1, 1): (1, {"allgather": a_bytes}),
        (1, None): (None, {"allreduce": None}), (None, 0): (None, {"allreduce": None}), (1, 0): (None, {"allreduce": None}),
    }
    mm_out = {}
    for (sa, sb), (split, comms) in expected.items():
        A4, B4 = ht.array(a, split=sa, comm=mesh4), ht.array(b, split=sb, comm=mesh4)
        _poison_padding(A4)
        _poison_padding(B4)
        mesh4.calls.clear()
        mesh4.bytes.clear()
        c, ms = _timed(lambda: A4 @ B4)
        err = check_within(f"matmul split {sa} x {sb}", c.larray, c64, bound)
        seen = {v: mesh4.bytes[v] for v in mesh4.calls}
        want = {v: (seen.get(v) if nbytes is None else nbytes) for v, nbytes in comms.items()}
        if c.split != split or seen != want or any(mesh4.calls[v] != 1 for v in comms):
            raise AssertionError(f"matmul split {sa} x {sb}: split {c.split}, collectives {dict(mesh4.calls)} {seen}")
        mm_out[f"{sa}x{sb}"] = {"ms": ms, "max_abs_err": err, "split": c.split, "collectives": dict(mesh4.calls)}
        del A4, B4, c
    lib_ms = _median_ms(lambda: a @ b, 3)
    print(
        f"  matmul {mm} x {k} @ {k} x {nn}, nine split pairs within k u |A||B| of float64, splits and collectives "
        f"as the case table: " + ", ".join(f"{key} {v['ms']:.2f} ms" for key, v in mm_out.items())
        + f"; torch.matmul one shard {lib_ms:.2f} ms",
        flush=True,
    )
    out["matmul"] = {"shape": list(MATMUL_SHAPE), "pairs": mm_out, "torch_matmul_ms": lib_ms}
    del a, b, c64, bound

    n, kk = TRI_N, TRI_K
    t = torch.triu(torch.randn(n, n, generator=gen, device="cuda"), 1) / n
    t += torch.diag(1 + torch.rand(n, generator=gen, device="cuda"))
    rhs = torch.randn(n, kk, generator=gen, device="cuda")
    T4, b4 = ht.array(t, split=0, comm=mesh4), ht.array(rhs, split=0, comm=mesh4)
    mesh4.calls.clear()
    x4, ms = _timed(lambda: ht.linalg.solve_triangular(T4, b4))
    x1, lib = _timed(lambda: torch.linalg.solve_triangular(t, rhs, upper=True))
    errs = []
    for label, x in (("four shards", x4.larray), ("torch.linalg.solve_triangular", x1)):
        back = (rhs.double() - t.double() @ x.double()).abs()
        scale = 2 * n * U32 * (t.double().abs() @ x.double().abs())
        if not bool(torch.isfinite(x).all()) or not bool((back <= scale).all()):
            raise AssertionError(f"solve_triangular {label}: backward error beyond 2 n u |T||x|")
        errs.append((back / scale).max().item())
    if x4.split != 0 or mesh4.calls["allreduce"] != LINALG_P:
        raise AssertionError(f"solve_triangular: split {x4.split}, collectives {dict(mesh4.calls)}")
    out["solve_triangular"] = {"n": n, "k": kk, "ms": ms, "torch_ms": lib, "backward_share": errs, "collectives": dict(mesh4.calls)}
    print(
        f"  solve_triangular n={n}, {kk} right-hand sides: {ms:.1f} ms (torch {lib:.1f} ms), backward error "
        f"{errs[0]:.3f} of its bound (torch {errs[1]:.3f}); collectives {dict(mesh4.calls)}",
        flush=True,
    )
    torch.cuda.empty_cache()
    return out


def linalg_path(ht, smi: str) -> dict:
    """Phase 10: the linear algebra on the card; returns its numbers."""
    import torch

    numbers = {"card": smi, "qr": qr_main_phase(ht)}
    torch.cuda.empty_cache()
    numbers["qr_fallback"] = qr_fallback_phase(ht)
    torch.cuda.empty_cache()
    numbers["mesh"] = linalg_mesh_phase(ht)
    return numbers


# the training path (phase 11): BASELINE config 5, DataParallel and DASO on
# ResNet-50/CIFAR. No kernel of its own: heat_tpu's models and trainers are
# flax and optax on XLA, so the port's convolutions, batch norm and updates
# are torch ops that cuDNN and cuBLAS serve (ROADMAP.md:15-16).
TRAIN_BATCH = 256
TRAIN_IMAGE = (32, 32, 3)  # NHWC, CIFAR's shape
TRAIN_CLASSES = 10
TRAIN_LR = 0.05
FALL_STEPS = 30  # on one fixed batch; the last TRAIN_STEPS of them are timed
TRAIN_STEPS = 20
MESH_BATCH = 254  # 64, 64, 64, 62 rows over four shards
MESH_STEPS = 3
TRAIN_P = 4
SWEEP = ((0, 0), (2, 1), (4, 1), (8, 2))  # (global_skip, local_skip)
SWEEP_STEPS = 6
README_FILTERS = 64
# Bounds of phase 11, float32 on the card with TF32 off, on the parameters
# and on the buffers (the running averages), each on the scale of its
# largest entry: max|a - b| <= bound * max|b| over all of them, and on the
# losses. A tensor whose gradient is rounding noise (a BatchNorm bias that
# the next BatchNorm cancels) differs by its own size, which is not a
# disagreement, so no bound is taken per tensor.
# * DataParallel at p = 1 against a plain step (the same modules,
#   F.cross_entropy, torch.optim.SGD) from the same weights: the two run the
#   same kernels, and cuDNN's weight gradients may sum their 262,144 terms
#   per filter in another order; one step of lr 0.05 moves a weight by
#   0.05 |g|, so 1e-5 bounds it with room;
# * four shards against one after 3 steps: the BatchNorm sums and the
#   gradient run over the shards and then in shard order, and cuDNN picks
#   other algorithms for 64 rows than for 254: float32 rounding in other
#   orders through ~160 layers, a few 1e-7 per step on this scale (1.2e-7
#   on the CPU at small sizes), so 1e-4.
PLAIN_STEP_BOUND = 1e-5
MESH_TRAIN_BOUND = 1e-4


def _op_kind(name: str) -> str:
    """The kind of work a profiled torch op does."""
    n = name.lower()
    if "conv" in n:
        return "convolution"
    if "batch_norm" in n:
        return "batch_norm"
    if "_foreach" in n or "sgd" in n:
        return "optimizer"
    if "mm" in n or "linear" in n:
        return "matmul"
    return "elementwise"


def _time_step(fn) -> float:
    """Host milliseconds of one call that ends in a device sync."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def training_flops(model, image) -> dict:
    """Multiply-adds of one sample's forward through every Conv2d and Linear
    (forward hooks on one image), and the floating-point operations of one
    training step of TRAIN_BATCH samples: the forward, the weight gradients
    and the input gradients of every layer but the stem, whose input needs
    none; 2 operations per multiply-add. Batch norm, ReLU and the optimizer
    are left out: they are bytes, not operations, on this scale."""
    import torch

    macs, stem = [], []

    def conv(m, inp, out):
        macs.append(out.numel() * m.in_channels // m.groups * m.kernel_size[0] * m.kernel_size[1])
        if not stem:
            stem.append(macs[-1])

    def dense(m, inp, out):
        macs.append(out.numel() * m.in_features)

    hooks = [
        m.register_forward_hook(conv if isinstance(m, torch.nn.Conv2d) else dense)
        for m in model.modules() if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))
    ]
    with torch.no_grad():
        model(image, train=False)
    for h in hooks:
        h.remove()
    per_sample = sum(macs)
    step = 2 * TRAIN_BATCH * (3 * per_sample - stem[0])
    return {"forward_gmac_per_sample": per_sample / 1e9, "step_tflop": step / 1e12,
            "fp32_bound_ms": step / F32_FLOP_PER_S * 1e3, "tf32_bound_ms": step / TF32_FLOP_PER_S * 1e3}


def _tensor_errors(got, want) -> float:
    """max|a - b| / max|b| over the parameters of two modules, and the same
    over their buffers; the larger of the two."""
    worst = 0.0
    for named in ("named_parameters", "named_buffers"):
        a, b = dict(getattr(got, named)()), dict(getattr(want, named)())
        diff = max((a[k] - b[k]).abs().max().item() for k in b)
        worst = max(worst, diff / max(t.abs().max().item() for t in b.values()))
    return worst


def profile_step(step) -> dict:
    """One warm step under torch.profiler: the device's busy share of the
    step's wall time and the device time by op kind (each kernel counted
    once, under the innermost torch op that launched it)."""
    import collections

    import torch

    step()
    with _profiled() as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = sum(r[0] for r in _device_rows(prof))
    kinds = collections.Counter()
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0) or getattr(ev, "self_cuda_time_total", 0)
        if us > 0 and ev.device_type == torch.autograd.DeviceType.CPU:
            kinds[_op_kind(ev.key)] += us / 1e3
    print(f"  profile of a warm step: wall {wall_ms:.3f} ms (profiler on), device busy {busy:.3f} ms "
          f"({100 * busy / wall_ms:.1f}%)", flush=True)
    for kind, ms in kinds.most_common():
        print(f"    {ms:9.3f} ms  {kind}")
    return {"wall_ms": wall_ms, "busy_ms": busy, "busy_share": busy / wall_ms, "by_kind_ms": dict(kinds)}


def _cifar(n: int, seed: int):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((n,) + TRAIN_IMAGE, generator=gen, device="cuda")
    y = torch.randint(0, TRAIN_CLASSES, (n,), generator=gen, device="cuda")
    return x, y


def resnet50_phase(ht, pristine, x, y) -> dict:
    """(a) ResNet-50 under DataParallel on one shard of the card."""
    import copy

    import torch
    import torch.nn.functional as Fn

    from heat_tpu_torch.core.communication import MeshCommunication

    out = {"flops": training_flops(pristine, x[:1])}
    print(f"phase training: ResNet50(num_classes={TRAIN_CLASSES}) under DataParallel, SGD({TRAIN_LR}), "
          f"batch {TRAIN_BATCH} of {TRAIN_IMAGE} float32; {json.dumps(out['flops'])}", flush=True)
    model = copy.deepcopy(pristine)
    dp = ht.nn.DataParallel(model, comm=MeshCommunication([torch.device("cuda", 0)]),
                            optimizer=ht.optim.SGD(TRAIN_LR))
    dp.init(SEED, x[:2])
    plain = copy.deepcopy(model)
    plain_opt = torch.optim.SGD(plain.parameters(), lr=TRAIN_LR)

    losses = []
    out["first_step_ms"] = _time_step(lambda: losses.append(dp.train_step(x, y)))
    plain_loss = Fn.cross_entropy(plain(x, train=True), y)
    plain_loss.backward()
    plain_opt.step()
    out["vs_plain_step"] = _tensor_errors(model, plain)
    out["loss_vs_plain"] = abs(losses[0] - plain_loss.item()) / abs(plain_loss.item())
    print(f"  first step {out['first_step_ms']:.1f} ms; against a plain PyTorch step: "
          f"{out['vs_plain_step']:.3e} of the largest weight (bound {PLAIN_STEP_BOUND:g}), "
          f"loss {out['loss_vs_plain']:.3e}", flush=True)
    if not (out["vs_plain_step"] <= PLAIN_STEP_BOUND and out["loss_vs_plain"] <= PLAIN_STEP_BOUND):
        raise AssertionError("DataParallel's step disagrees with a plain PyTorch step")
    del plain, plain_opt

    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(FALL_STEPS - 1):
        ms = _time_step(lambda: losses.append(dp.train_step(x, y)))
        if i >= FALL_STEPS - 1 - TRAIN_STEPS:
            times.append(ms)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["ms"] = sorted(times)[len(times) // 2]
    out["samples_per_s"] = TRAIN_BATCH / out["ms"] * 1e3
    out["losses"] = losses
    print(f"  warm median of {TRAIN_STEPS} steps: {out['ms']:.2f} ms, {out['samples_per_s']:.1f} samples/s "
          f"(FP32 bound {out['flops']['fp32_bound_ms']:.2f} ms); peak {out['peak_gb']:.2f} GB; "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f} over {FALL_STEPS} steps", flush=True)
    if not (all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"the loss does not fall on one fixed batch: {losses}")

    torch.backends.cudnn.allow_tf32 = True
    try:
        for _ in range(3):
            dp.train_step(x, y)
        tf32 = sorted(_time_step(lambda: dp.train_step(x, y)) for _ in range(TRAIN_STEPS))
    finally:
        torch.backends.cudnn.allow_tf32 = False
    out["tf32_ms"] = tf32[len(tf32) // 2]
    out["tf32_samples_per_s"] = TRAIN_BATCH / out["tf32_ms"] * 1e3
    print(f"  with cudnn.allow_tf32: warm median {out['tf32_ms']:.2f} ms, {out['tf32_samples_per_s']:.1f} "
          f"samples/s (TF32 bound {out['flops']['tf32_bound_ms']:.2f} ms)", flush=True)
    out["profile"] = profile_step(lambda: dp.train_step(x, y))
    return out


def mesh_training_phase(ht, pristine, x, y) -> dict:
    """(b) Four shards of the card: DataParallel on a ragged batch against
    one shard, then DASO's cadence sweep against four-shard DataParallel."""
    import collections
    import copy

    import torch

    from heat_tpu_torch.core.communication import MeshCommunication

    card = torch.device("cuda", 0)
    out = {}
    print(f"phase training: {TRAIN_P} shards on one card, DataParallel on {MESH_BATCH} rows against one shard",
          flush=True)
    xb, yb = x[:MESH_BATCH], y[:MESH_BATCH]
    one = ht.nn.DataParallel(copy.deepcopy(pristine), comm=MeshCommunication([card]),
                             optimizer=ht.optim.SGD(TRAIN_LR)).init(SEED, x[:2])
    four = ht.nn.DataParallel(copy.deepcopy(pristine), comm=counting_mesh([card] * TRAIN_P),
                              optimizer=ht.optim.SGD(TRAIN_LR)).init(SEED, x[:2])
    loss_err = 0.0
    for _ in range(MESH_STEPS):
        a, b = four.train_step(xb, yb), one.train_step(xb, yb)
        loss_err = max(loss_err, abs(a - b) / abs(b))
    out["dp_vs_one_shard"] = _tensor_errors(four.module, one.module)
    out["dp_loss_vs_one_shard"] = loss_err
    out["dp_collectives_per_step"] = {k: v / MESH_STEPS for k, v in four.comm.calls.items()}
    print(f"  after {MESH_STEPS} steps: {out['dp_vs_one_shard']:.3e} of the largest weight, losses "
          f"{loss_err:.3e} (bound {MESH_TRAIN_BOUND:g}); collectives per step "
          f"{out['dp_collectives_per_step']}", flush=True)
    if not (out["dp_vs_one_shard"] <= MESH_TRAIN_BOUND and loss_err <= MESH_TRAIN_BOUND):
        raise AssertionError("four-shard DataParallel disagrees with one shard")
    del one
    for _ in range(2):
        four.train_step(x, y)
    dp_ms = sorted(_time_step(lambda: four.train_step(x, y)) for _ in range(SWEEP_STEPS))
    out["dp_samples_per_s"] = TRAIN_BATCH / dp_ms[len(dp_ms) // 2] * 1e3
    print(f"  four-shard DataParallel (full sync), batch {TRAIN_BATCH}: {out['dp_samples_per_s']:.1f} samples/s",
          flush=True)
    out["dp_profile"] = profile_step(lambda: four.train_step(x, y))
    del four

    sweep = []
    for gs, ls in SWEEP:
        mesh = counting_mesh([card] * TRAIN_P)
        daso = ht.optim.DASO(ht.optim.SGD(TRAIN_LR), total_epochs=10, comm=mesh, nodes=2,
                             warmup_epochs=0, cooldown_epochs=0)
        daso.add_model(copy.deepcopy(pristine), SEED, x[:TRAIN_P])
        daso.global_skip, daso.local_skip, daso.batches_to_wait = gs, ls, 1 if gs else 0
        for _ in range(2):
            daso.step(x, y)
        kinds = collections.defaultdict(collections.Counter)
        times = []
        for _ in range(SWEEP_STEPS):
            before, solo = collections.Counter(mesh.calls), daso._solo_steps
            times.append(_time_step(lambda: daso.step(x, y)))
            merged = gs == 0 or daso.current_batch % (gs + 1) == 0
            kind = ("solo" if daso._solo_steps > solo else "synced") + ("+merge" if merged else "")
            kinds[kind] = mesh.calls - before
        if gs == 0:
            first = [p.detach() for p in daso.replicas[0].parameters()]
            for replica in daso.replicas[1:]:
                if not all(torch.equal(a, b) for a, b in zip(first, replica.parameters())):
                    raise AssertionError("DASO's replicas differ after a full merge")
        times.sort()
        point = {"global_skip": gs, "local_skip": ls, "samples_per_s": TRAIN_BATCH / times[len(times) // 2] * 1e3,
                 "solo_steps": daso._solo_steps, "collectives": {k: dict(v) for k, v in kinds.items()}}
        sweep.append(point)
        print(f"  DASO (global_skip={gs}, local_skip={ls}): {point['samples_per_s']:.1f} samples/s, "
              f"{daso._solo_steps} solo steps, collectives {point['collectives']}", flush=True)
        del daso
    out["daso_sweep"] = sweep
    print("  after every full merge (global_skip 0) the four replicas are equal bit for bit", flush=True)
    return out


def readme_training_phase(ht, x, y) -> dict:
    """(c) The README's "Deep learning" snippet on the card."""
    import torch

    print("phase training: the README's Deep learning snippet (README.md:78-91)", flush=True)
    dp = ht.nn.DataParallel(ht.nn.MLP(features=(128, 10)), optimizer=ht.optim.Adam(1e-3))
    dp.init(0, x[:2])
    mlp_loss = dp.train_step(x, y)
    card = torch.device("cuda", 0)
    daso = ht.optim.DASO(local_optimizer=ht.optim.SGD(0.1), total_epochs=90, nodes=TRAIN_P,
                         comm=counting_mesh([card] * TRAIN_P))
    daso.add_model(ht.nn.ResNet(stage_sizes=(2, 2, 2, 2), num_classes=10, num_filters=README_FILTERS), 0, x[:2])
    loss = daso.step(x, y)
    daso.epoch_loss_logic(loss)
    print(f"  DataParallel(MLP((128, 10)), Adam(1e-3)) loss {mlp_loss:.4f}; DASO on ResNet(2, 2, 2, 2) "
          f"with nodes={TRAIN_P} on {TRAIN_P} shards: loss {loss:.4f}, epoch {daso.epoch}", flush=True)
    if not (math.isfinite(mlp_loss) and math.isfinite(loss) and daso.epoch == 1):
        raise AssertionError("the README's Deep learning snippet failed")
    return {"mlp_loss": mlp_loss, "daso_loss": loss}


def training_path(ht, smi: str) -> dict:
    """Phase 11: the training stack on the card; returns its numbers."""
    import torch

    x, y = _cifar(TRAIN_BATCH, SEED + 11)
    pristine = ht.nn.ResNet50(num_classes=TRAIN_CLASSES, generator=torch.Generator("cuda").manual_seed(SEED))
    numbers = {"card": smi, "resnet50": resnet50_phase(ht, pristine, x, y)}
    torch.cuda.empty_cache()
    numbers["mesh"] = mesh_training_phase(ht, pristine, x, y)
    torch.cuda.empty_cache()
    numbers["readme"] = readme_training_phase(ht, x, y)
    return numbers


def print_build_report(name: str, log: str) -> None:
    """Registers and spills of each kernel of one source, from ptxas -v."""
    kernel = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif kernel and ("spill" in line or "Used" in line):
            print(f"  {name}: {kernel[:90]}: {line.strip()}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import heat_tpu_torch as ht
    from heat_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]

    # 1. build
    sources = sorted(p.stem for p in _build.SOURCE_DIR.glob("*.cu"))
    t0 = time.perf_counter()
    _build.build(sources)
    for name in sources:
        _build.library(name)
    print(f"phase build: {sources} built in {time.perf_counter() - t0:.1f} s", flush=True)
    for name in ("flash", "pairwise"):
        print_build_report(name, _build.build_log(name))

    kernels = [kmeans_path(ht)]
    torch.cuda.empty_cache()
    kernels.append(attention_path(ht))
    torch.cuda.empty_cache()
    kernels.append(distance_path(ht))
    torch.cuda.empty_cache()
    moments = moments_path(ht, smi)
    torch.cuda.empty_cache()
    linalg = linalg_path(ht, smi)
    torch.cuda.empty_cache()
    training = training_path(ht, smi)

    print("moments: " + json.dumps(moments))
    print("linalg: " + json.dumps(linalg))
    print("training: " + json.dumps(training))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
