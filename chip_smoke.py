#!/usr/bin/env python3
"""Smoke test of heat_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. build every CUDA kernel of the package from ``heat_tpu_torch/csrc``;
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes of the main path and at the edges of its range;
3. drive the main path, ``KMeans(n_clusters=8).fit`` on 10,000,000 x 16
   float32 samples split along the rows, for 30 iterations from a
   precomputed init; check that every iteration went through the kernel and
   that the result agrees with the torch path (``use_fused=False``) on the
   same card; run ``predict`` and a fit with ``init="random"``; hold the
   kernel against its plain version at the inputs of the fit's first
   launch; time it;
4. print the card's name and power limit, one JSON line of per-kernel
   numbers, and the result line ``{"ok": true, "device": {...}}`` last.

It needs CUDA and the package beside it, and fails without either.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

SEED = 20261016
N, F, K = 10_000_000, 16, 8
ITERS = 30
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores

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
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ht.cluster.KMeans(n_clusters=K, init=init, max_iter=ITERS, tol=-1.0).fit(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0) or getattr(ev, "self_cuda_time_total", 0)
        if us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(
        f"  profile of a warm fit: wall {wall_ms:.3f} ms (profiler on), device busy "
        f"{busy:.3f} ms ({100 * busy / wall_ms:.1f}%)"
    )
    for ms, count, key in rows[:8]:
        print(f"    {ms:9.3f} ms  {count:4d}x  {key[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import heat_tpu_torch as ht
    from heat_tpu_torch.ops import _build, lloyd

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

    print(smi)
    print(json.dumps({"kernels": [{
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
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
