#!/usr/bin/env python3
"""Smoke test of heat_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero. Every phase runs as a user
gets the package, with the fusion recorder and its collective nodes on
(the defaults): each path's seconds, program builds, forces, multi-root
batches and degraded forces are printed, and a degraded force fails it.
Phases 9, 12 and 13, where the array engines do most of the work, run
again with the collective nodes off and with the recorder off, the
compared legs; phase 18 holds the recorder itself, phase 19 its
collective nodes.

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
12. drive the array layer (no kernel of its own): the README quickstart
   from ``README.md:36`` to ``:50`` against float64, ``ht.save`` read back;
   indexing on BASELINE config 3's table, 10,000,000 x 16 float32: basic,
   negative-step, int, boolean-mask and fancy keys and setitem by slice,
   mask and fancy key with a broadcast and a cast, each bit for bit
   against the same torch indexing of the shard; the sorting family on
   10^8 float32: ``sort`` both ways with its indices, ``topk``,
   ``unique``, ``percentile`` under every interpolation and ``median``
   (their order statistics the sorted elements themselves, the warm calls
   under ``set_sync_debug_mode("error")``), ``bincount``, ``histc``,
   ``histogram`` and ``digitize`` against independent torch counts, the
   draws' moments and their values on four shards; each call timed beside
   its torch call and its HBM bound; then four shards of the card: the
   merge-exchange sort with NaN padding equal to one shard with 2p
   ``ppermute``s and its peak memory, topk's one-``allreduce`` merge,
   ``unique``, ``median``, getitem and setitem across shard boundaries,
   halos, ``pad``, ``roll`` and ``diag``;
13. drive the estimators (no kernel of their own; Spectral's KMeans runs
   the Lloyd kernel): KMedians and KMedoids on BASELINE config 3's table
   (10,000,000 x 16 float32, k = 8, 8 iterations from a precomputed init),
   centers against float64 medians, labels against a float64 argmin,
   medoids rows of the data, peak memory under half the k·n·f copy of
   heat_tpu's form, beside torch.sort of the same values; Spectral on
   40,000 x 16 (8 blobs, n_lanczos 300) with the Lloyd kernel's launches
   counted over the fit, the blobs recovered and T's 8 smallest
   eigenvalues against float64 subspace iteration on L, each stage timed;
   KNN (k = 5) on BASELINE config 2's 100,000 x 64 with 10,000 queries
   against a float64 vote; GaussianNB on 10,000,000 x 16 against float64
   moments and partial_fit in two halves; Lasso by benchmarks/lasso.py's
   protocol, at 10,000,000 x 64 (Gram mode) and 200,000 x 2,100 (residual
   mode) against float64 coordinate descent; the steps of
   examples/cluster_demo.py, knn_demo.py and lasso_demo.py; then four
   shards of the card against one (NaN padding, two allreduces for a
   Gram-mode Lasso fit) and the batch-parallel init's one allgather;
14. drive the rest of nn (the flash kernel is the only kernel on it): the
   README's ``TransformerLM`` trains under ``DataParallel`` with Adam on
   4 x 4096 tokens, the next-token loss, the kernel in every block, in
   float32 and in bfloat16: the first step against a plain PyTorch step
   (dense attention, ``torch.optim.Adam``) from the same weights, 12
   kernel launches per step, the warm median of 9 steps beside the step's
   FP32 and bf16 bounds, the peak memory, a profiled step with the
   kernel's backward (the scan path) called out, the loss falling over 10
   steps; the bfloat16 forward on phase 5's requests against the float32
   logits, and the kernel in bf16 beside ``scaled_dot_product_attention``;
   ring and Ulysses attention on four shards of the card against dense
   attention at (4, 4096, 12, 64) in f32 and bf16, the ring's gradient,
   and the trained model at S = 32,768 through both against its
   single-shard forward through the kernel, with their collectives
   counted; one bfloat16 ResNet-50 step at batch 256 against the float32
   model's loss; ``parallel/`` on four shards: the tensor-parallel MLP at
   GPT-2 small's widths (one ``allreduce``), a 2 x 2 dp x tp step, a
   4-stage pipeline of ``TransformerBlock(768)`` and 4 experts, each
   against its dense oracle;
15. I/O and checkpointing (no kernel of its own; the disk-loaded fit runs
   the Lloyd kernel, the LM's checkpoint step the flash kernel): print
   whether h5py and scipy import, the g++ version and the free disk space;
   save and load BASELINE config 3's table (10,000,000 x 16 float32,
   split=0) as .npy, .h5 (where h5py imports), classic netCDF3 and .csv
   (through the native codec, whose calls are counted; cut to 10^6 rows,
   said on a line, when the whole table would take over 20 s), each load
   at split 0 and None equal to the table bit for bit, with save and load
   GB/s beside np.save/np.load of the same host bytes; fit KMeans for 30
   iterations from phase 3's centres on the table read from .npy (and .h5):
   30 Lloyd launches, centres, labels and inertia equal to the in-memory
   fit bit for bit; save from four shards of the card and load into one,
   and back; then checkpoints: ResNet-50 under DataParallel at batch 256,
   DASO on four shards and the README's TransformerLM (f32, 4 x 4096
   tokens, Adam, 12 flash launches in the restored step's forward) step
   twice, save, step; a fresh trainer restores, its state equal to the
   saved one bit for bit, and its next step equal to the uninterrupted
   third step (bit for bit where the card repeats a step exactly, else
   within four times the run-to-run difference); the checkpoint's bytes,
   save and restore GB/s, ``verify_checkpoint``; finally ``convolve`` of
   10^8 float32 with a 9-tap filter in every mode against float64, four
   shards equal to one bit for bit;
16. the runtime's observability and robustness layer (no kernel of its
   own; the traced fit runs the Lloyd kernel, the traced LM step the flash
   kernel, the four-shard cdist the pairwise kernel): with the table on the
   card, ``device_memory_stats`` and ``report()["memory"]``; phase 3's fit
   with telemetry off, at mode 1 and verbose, 30 Lloyd launches each and
   the results equal bit for bit; the 10-op chain's ops/s at 1,000 x 16
   (eager there by the card's default) and on the table (recorded) in the
   three modes, mode 1 at least 0.9 of off at the small size; a warm
   reduction chain under ``set_sync_debug_mode("error")`` with telemetry
   verbose, and under ``errstate("warn")`` one sync per check (per forced
   chain with the recorder on, per op with it off); a NaN on the card
   raising ``NonFiniteError``; on four shards of the card the symmetric ring
   ``cdist``, ``qr`` of a tall split-0 matrix, one DASO step of ResNet-50
   and ring attention, each with ``collective_counts()`` equal to a
   counting mesh's, the ring's ppermute bytes against its shards'; one
   README TransformerLM f32 step (12 flash launches) and the fit at
   verbose, the exported trace validated, the fit under
   ``profiling.trace`` with its Lloyd kernels inside the ``annotate``
   region, a ``timed`` fit within 5% of its CUDA events; an ``io.write``
   fault every second attempt on the table's ``.npy`` saves, a hard
   ``checkpoint.commit`` fault on ResNet-50's second checkpoint (the first
   restores bit for bit) and a ``collective.allreduce`` fault on a
   four-shard sum with the recorder off (the next call equal to the
   fault-free one; a recorded sum combines inside its program and passes
   no site); the metrics
   sink in a subprocess, whose ``report()`` leaves CUDA uninitialized;
17. memory and health on the card (no kernel of its own; the fit runs the
   Lloyd kernel, the LM step the flash kernel): phase 3's fit with the
   memory ledger and the flight ring on, 30 Lloyd launches, the ledger's
   ``dndarray`` bytes equal to the live arrays' shard storages, its total
   within one allocator block per buffer of ``memory_allocated()``, the
   watermark between the table's bytes and ``max_memory_allocated()``; the
   fit's ms per iteration and the host-bound 10-op chain's ops/s with the
   hooks on and off, and the p50/p90/p99 of the host waits that end the
   fits; the README TransformerLM f32 step (12 flash launches) saved and
   restored, the ledger's owner split printed, the table restored from a
   checkpoint and loaded from ``.npy`` on four shards of the card with its
   staged shards under ``checkpoint`` and ``io``; a ``watchdog.stall``
   injected at ``numpy()`` of the fitted centres under a 200 ms deadline in
   the ``warn``, ``raise`` and ``dump`` policies (the dump's trace accepted
   by ``python -m heat_tpu_torch.telemetry validate-trace``);
   ``ping_mesh`` on one and four shards of the card and
   ``memory_report()`` against the ledger; a fresh process whose
   ``report()``, ``ledger()`` and ``ht.flight.health_block()`` leave CUDA
   uninitialized;
18. the fusion recorder on the card (``core/fusion.py``: each recorded
   chain one program, Inductor over its GraphModule; no kernel of its own,
   the fit runs the Lloyd kernel): heat_tpu's 10-op chain at 1,000 x 16
   and on BASELINE config 3's table (two 10,000,000 x 16 float32
   operands), fused and with the recorder off: the first build's seconds,
   ops/s with a host read per chain, device ms per chain by CUDA events
   beside the bytes bounds of the two (the fused chain reads its two
   operands once, the eager one moves each op's operands and result);
   one fused dispatch per chain, one build per signature over 100 warm
   chains and no Dynamo graph added, fused against eager and the compiled
   module against its plain GraphModule element by element (in units of
   u times each element's first-order error scale) and on the sum, within
   bounds that a bfloat16 control of the chain exceeds; four
   shards of the card with NaN in the padding against one shard; no host
   sync before the read under ``set_sync_debug_mode("error")`` and at most
   one at it; phase 3's fit with the recorder on (30 Lloyd launches)
   against the fit with it off; ``fusion.compile``, ``fusion.execute`` and
   ``memory.exhausted`` injected, each degrading bit for bit to the eager
   result with its signature quarantined, its flight dump validated and
   the OOM forensic written; a budget under the chain's static peak
   raising ``MemoryBudgetExceeded`` with the chain left pending; the
   report's fusion blocks, the dispatch and compile histograms and the
   exported trace's dispatch-to-sync pairs; ``degraded`` 0 in every step
   that injected nothing (these steps record at every size); then the
   chain's ops/s over sizes from 1,000 x 16 to 10^7 x 16, recorded, eager
   and as the card's default chooses, and a one-op program run without an
   Inductor build, equal to the eager op bit for bit;
19. the recorder's collective nodes on four shards of the card (no
   kernel of its own; the four-shard paths run the Lloyd and pairwise
   kernels): each item with the collective nodes on, off and the recorder
   off, its dispatches, roots, multi-root batches, Inductor builds and
   device ms (median of three calls) beside its bytes bound: ``mean``,
   ``var`` and ``std`` of BASELINE config 3's table along the split as one
   dispatch of three roots; a z-score through ``resplit_(1)``, column sums
   and ``resplit_(0)``, pending throughout, its shards equal to the
   collectives-off leg's; ``argmax``/``argmin`` along the split equal to
   the eager leg's; ``z @ W`` pending at split 0 and ``zᵀ z`` within k u of
   float64; CholeskyQR2 and TSQR of a pending column scale at 2.5·10^6 x
   512 within phase 10's bounds; ``convolve`` of a pending 10^8 signal with
   9 taps within phase 15's bound; ``cg`` on an 8,192² SPD matrix declined
   by name, its residual checked; then phases 9, 10, 12, 16, 4 and 13's
   four-shard steps again, each path's programs, builds and batches;
20. the numerics lens and the serving layer (no kernel of their own; the
   LM steps run the flash kernel, the ninth tenant's fit the Lloyd
   kernel): the 10-op chain and the column moments of config 3's table
   with the lens off, sampling and full, ms per chain; each root's
   statistics against a float64 computation (counts, histogram and absmax
   exact, rms within NS_RMS_ULPS); the drift of Inductor's code against
   the plain module; four NaN-padded shards (the padding not counted); the
   SDC canary on one and four shards, clean and with ``numeric.sdc.1``;
   the README's LM under DataParallel with the lens off and on (12 flash
   launches per step, the stream's loss the step's, the update ratio
   against float64 norms) and DASO's merges on four shards; eight
   sessions on eight threads with a table each and a ninth running the
   fit (30 Lloyd launches), p50/p99 per session, cross-session batches,
   0 retraces after the warm-up; admission under ``raise`` (the refused
   chain dispatched after the refill bit for bit), ``wait`` (neighbours'
   p99 under the sleep) and ``memledger.admission_hold``; a cold and a
   warm fresh process on one new cache directory (``disk_hit`` and no
   compile for every signature, Inductor's FX graph cache hit, results
   bit for bit);
21. the trace analyzer and the live ops plane (no kernel of their own; the
   analyzed fit and the scraped ninth tenant run the Lloyd kernel), with
   the timeline verbose: the ops server at an ephemeral port, its sampler
   every 0.25 s, every route answering once with a 640 MB chain left
   pending and no dispatch added, ``ops check`` in its own process; eight
   sessions with a table each and a ninth fitting config 3, twice scraped
   at 10 Hz (every exposition valid and inside the schema, the nine
   tenants labelled, no counter falling) and twice not, in the order A B
   B A, p50/p99 of the reads and the scrapes, the per-tenant counters
   equal to the sessions' billing; a dispatch SLO of 1 µs under the tenants' traffic firing the
   two-window burn alert (the gauge, /healthz 503, ``ops check`` exit 1,
   ``slo_burn``), cleared within the fast window once lifted, the
   sampler's series at its cadence; then phase 18's 10-op chain on config
   3's table, one cold signature and 50 warm chains each read, analyzed:
   at most 5% unattributed, one dispatch and one sync per chain, the
   per-program keys the cache's, ``device_execute`` against the programs'
   CUDA-event time, the compile bucket against the cold chain's extra
   wall time, the exported file's analysis by ``python -m
   heat_tpu_torch.telemetry analyze --json`` in its own process (CUDA
   untouched there) equal to the live one, the flight bundle's diagnosis;
   the sync storm, retrace storm, resplit ping-pong (four shards) and
   injected SDC detectors, each in its own window; the fit's buckets
   beside the profiler's busy share; the static analyzer's leg after the
   warm chains, building nothing: ``audit_programs()`` over the programs
   those chains cached (no replication error, the cache's compiles
   unchanged), ``lint_paths`` and ``verify_paths`` over
   ``heat_tpu_torch`` (0 unsuppressed findings; they run in a process of
   their own, started with the script, that touches no device and loads
   neither jax nor heat_tpu; their times are printed) and
   ``drift_report()`` on the card's mesh and on four shards of it (every
   workload within 2x, eager there: nothing built);
22. the multi-process runtime (no kernel of its own; the fit across two
   processes runs the Lloyd kernel): a one-process NCCL world on the card,
   each verb of the process-spanning mesh against the in-process mesh bit
   for bit, a named barrier, a hung barrier's ``StallError``, the report's
   multihost block and the ops plane's peer gauges; one attempt at a
   two-rank NCCL world on the one card, with NCCL's answer printed; the
   lstsq trainer in two processes on the card over gloo (and over NCCL
   where it accepts two ranks), clean against one process (rtol 1e-5) and
   numpy's float64 descent, rank 1 SIGKILLed at step 3 (one reform into a
   world of one under epoch 1, the final w within 1e-5 of the clean run,
   at most 2 steps replayed) and rank 1 hung at step 3 (detected, reaped,
   its generation under 60 s); config 3's fit across two processes, 30
   Lloyd launches in each, centers, inertia and labels equal bit for bit
   to the one-process fit of the same two shards, ms per iteration and
   the cross-process allreduce's beside that fit's;
23. the elastic supervisor and the autoscale controller (no kernel of
   their own; the LM steps run the flash kernel, the interactive tenant's
   fit the Lloyd kernel): the README's TransformerLM in float32 under
   ``DataParallel`` with Adam on four shards of the card, eight batches of
   4 x 4096 tokens, uninterrupted, then through ``DataParallel.fit`` with
   ``elastic.preempt`` injected at the fifth poll, a checkpoint every 3
   steps and two ranks lost: one preemption, one reform onto two shards,
   at most 3 steps replayed, 12 flash launches per replica per step
   forward, each commit's bytes and seconds, the losses within
   EL_LOSS_RTOL of the uninterrupted run's; the DASO kill-a-host case of
   tests/test_elastic.py at p = 4 within 1e-5 of its uninterrupted run;
   then eight tenants (four interactive with a 100 ms deadline, four
   batch), a 10^7 x 16 table each on four shards of the card, under a
   1 ms dispatch SLO and its burn alert: the armed controller sheds the
   batch tier and shrinks the mesh to three shards while a ninth,
   interactive tenant fits config 3 on the card (30 Lloyd launches,
   centers equal bit for bit to the unloaded fit), then recovers to four
   shards once the burn has cleared: exactly one shed_on, shed_off,
   shrink and recover, no error, no failed interactive read, at least one
   refused batch read, the reforms' wall ms and the interactive reads'
   p50/p99 and deadline misses before, while shedding and after (a read
   misses its deadline only behind a program built in its leg: on the
   shrunk, ragged mesh each new batch of the tenants' small roots is one,
   so the shedding leg's times are mostly those builds);
24. print the phase-9 to 23 numbers with the card, the collectives-off and
   recorder-off legs of phases 9, 12 and 13, each path's seconds and
   program builds, the card's name and power limit, one JSON line of
   per-kernel numbers, and the result line ``{"ok": true, "device":
   {...}}`` last.

It needs CUDA and the package beside it, and fails without either.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
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


def _dispatched(out):
    """``out`` with every pending array in it forced: dispatched to the card,
    not read. With the recorder on, a call of the array library returns a
    recorded chain, and a timing has to hold the chain's run."""
    from heat_tpu_torch.core import fusion

    if isinstance(out, (tuple, list)):
        for o in out:
            _dispatched(o)
    elif isinstance(out, dict):
        for o in out.values():
            _dispatched(o)
    elif fusion.is_deferred(out):
        out.shards
    return out


def _time_ms(fn, reps: int) -> float:
    import torch

    _dispatched(fn())
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        _dispatched(fn())
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


def _device_rows(prof, ranges=()):
    """(ms, count, name) of each kernel in a profile, by device time. The
    named ranges of ``ranges`` (``record_function``) also appear on the
    device's timeline, as spans over their kernels: they are no kernels."""
    import torch

    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0) or getattr(ev, "self_cuda_time_total", 0)
        if us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA and ev.key not in ranges:
            rows.append((us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    return rows


def kmeans_table(ht):
    """BASELINE config 3's table, N x F float32 blobs split along the rows,
    and the K rows of it that start every fit, drawn from SEED (phases 3
    and 15)."""
    import torch

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
    return x, init


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
    x, init = kmeans_table(ht)

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
    _dispatched(fn())
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

    _dispatched(fn())
    times = []
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        _dispatched(fn())
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
            _dispatched(fn(x, axis))
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
    out = _dispatched(fn())
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

        def ppermute(self, shards, shift=1, perm=None):
            self._count("ppermute", shards)
            return super().ppermute(shards, shift, perm)

        def alltoall(self, shards, split_axis=0, concat_axis=0):
            self._count("alltoall", shards)
            return super().alltoall(shards, split_axis, concat_axis)

        def sub(self, ranks):
            # a group counts into its parent's counters
            group = CountingMesh([self.devices[r] for r in ranks])
            group.calls, group.bytes = self.calls, self.bytes
            return group

    return CountingMesh(devices)


@contextlib.contextmanager
def program_verbs(fusion):
    """Count the verbs that recorded schedules run inside their programs
    (``fusion._ProgramComm``'s shard-order arithmetic), not the record-time
    runs on meta tensors; yields the Counter."""
    import collections

    calls = collections.Counter()
    originals = {}
    for verb in ("allgather", "allreduce", "bcast", "ppermute", "alltoall"):
        originals[verb] = getattr(fusion._ProgramComm, verb)

        def counted(self, shards, *args, _verb=verb, **kwargs):
            if shards[0].device.type != "meta":
                calls[_verb] += 1
            return originals[_verb](self, shards, *args, **kwargs)

        setattr(fusion._ProgramComm, verb, counted)
    try:
        yield calls
    finally:
        for verb, fn in originals.items():
            setattr(fusion._ProgramComm, verb, fn)


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
    fusion = ht.core.fusion
    recorded = fusion.collectives_active()  # T is above the 192 MiB rule: the default records the solve

    def solve():
        x = ht.linalg.solve_triangular(T4, b4)
        if recorded and not fusion.is_deferred(x):
            raise AssertionError("solve_triangular: the default did not record the solve")
        return x

    # the default leg, as a user gets it (the schedule recorded, its verbs
    # run inside the program), then the collectives-off leg, whose verbs
    # the counting mesh counts: the compared one. Each leg's first call is
    # counted (the default's records and builds its program), its second
    # timed warm
    mesh4.calls.clear()
    with program_verbs(fusion) as in_program:
        x_on, cold_on = _timed(solve)
    legs = {"default": (x_on, cold_on, dict(mesh4.calls), dict(in_program))}
    x_on, ms_on = _timed(solve)
    mesh4.calls.clear()
    with fusion.collectives_disabled():
        with program_verbs(fusion) as in_program:
            x4, cold = _timed(lambda: ht.linalg.solve_triangular(T4, b4))
        legs["collectives off"] = (x4, cold, dict(mesh4.calls), dict(in_program))
        x4, ms = _timed(lambda: ht.linalg.solve_triangular(T4, b4))
    x1, lib = _timed(lambda: torch.linalg.solve_triangular(t, rhs, upper=True))
    errs = []
    for label, x in (("default", x_on.larray), ("collectives off", x4.larray), ("torch.linalg.solve_triangular", x1)):
        back = (rhs.double() - t.double() @ x.double()).abs()
        scale = 2 * n * U32 * (t.double().abs() @ x.double().abs())
        if not bool(torch.isfinite(x).all()) or not bool((back <= scale).all()):
            raise AssertionError(f"solve_triangular {label}: backward error beyond 2 n u |T||x|")
        errs.append((back / scale).max().item())
    # the program's verbs run only where the default recorded the solve
    want = {"default": ({}, {"allreduce": LINALG_P}) if recorded else ({"allreduce": LINALG_P}, {}),
            "collectives off": ({"allreduce": LINALG_P}, {})}
    for label, (first, _, eager_verbs, program_verbs_seen) in legs.items():
        if first.split != 0 or (eager_verbs, program_verbs_seen) != want[label]:
            raise AssertionError(f"solve_triangular {label}: split {first.split}, verbs {eager_verbs} eager, "
                                 f"{program_verbs_seen} in the program")
    bitwise = torch.equal(x_on.larray, x4.larray) and torch.equal(legs["default"][0].larray, x_on.larray)
    diff = (x_on.larray.double() - x4.larray.double()).abs().max().item()
    out["solve_triangular"] = {
        "n": n, "k": kk, "ms": ms, "default_ms": ms_on, "first_call_ms": cold, "default_first_call_ms": cold_on,
        "torch_ms": lib, "recorded": recorded,
        "backward_share": errs, "collectives": legs["collectives off"][2], "program_collectives": legs["default"][3],
        "default_equal_to_off": bitwise, "default_max_abs_diff": diff,
    }
    print(
        f"  solve_triangular n={n}, {kk} right-hand sides: default (recorded: {recorded}) {ms_on:.1f} ms (first "
        f"call {cold_on:.1f}), collectives off {ms:.1f} ms (first call {cold:.1f}; torch {lib:.1f} ms); backward "
        f"error {errs[0]:.3f}, {errs[1]:.3f} of its bound (torch {errs[2]:.3f}); default against off: bit for bit "
        f"{bitwise}, max |d| {diff:.3e}; verbs "
        f"{legs['collectives off'][2]} eager off, {legs['default'][3]} in the default's program",
        flush=True,
    )
    del T4, b4, x_on, x4, x1, legs
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
SWEEP_STEPS = 3
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
    if "_foreach" in n or "sgd" in n or "adam" in n:
        return "optimizer"
    if "flashpallas" in n:
        return "attention kernel"
    if "mm" in n or "linear" in n:
        return "matmul"
    if "layer_norm" in n:
        return "layer_norm"
    if "softmax" in n or "nll_loss" in n:
        return "softmax and loss"
    return "elementwise"


def _time_step(fn) -> float:
    """Host milliseconds of one call that ends in a device sync."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _dispatched(fn())
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


def profile_step(step, ranges=()) -> dict:
    """One warm step under torch.profiler: the device's busy share of the
    step's wall time, the device time by op kind (each kernel counted
    once, under the innermost torch op that launched it) and the device
    time under each named range of ``ranges`` (``record_function``)."""
    import collections

    import torch

    step()
    with _profiled() as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = sum(r[0] for r in _device_rows(prof, ranges))
    kinds = collections.Counter()
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0) or getattr(ev, "self_cuda_time_total", 0)
        if us > 0 and ev.device_type == torch.autograd.DeviceType.CPU:
            kinds[_op_kind(ev.key)] += us / 1e3
    # a range's host-side event holds the device time of the kernels
    # launched inside it
    in_range = {name: sum(getattr(ev, "device_time_total", 0) or getattr(ev, "cuda_time_total", 0)
                          for ev in prof.key_averages()
                          if ev.key == name and ev.device_type == torch.autograd.DeviceType.CPU) / 1e3
                for name in ranges}
    print(f"  profile of a warm step: wall {wall_ms:.3f} ms (profiler on), device busy {busy:.3f} ms "
          f"({100 * busy / wall_ms:.1f}%)", flush=True)
    for kind, ms in kinds.most_common():
        print(f"    {ms:9.3f} ms  {kind}")
    return {"wall_ms": wall_ms, "busy_ms": busy, "busy_share": busy / wall_ms, "by_kind_ms": dict(kinds),
            "ranges_ms": in_range}


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


# the array layer's path (phase 12): no kernel of its own. heat_tpu runs
# indexing, sorting, order statistics, histograms and random draws as jnp
# calls and shard_map programs, so the port's are torch ops over the shards.
# Sizes: the README quickstart (README.md:36-50) as written; BASELINE config
# 3's table (10^7 x 16 float32, 640 MB) for indexing; 10^8 float32 (400 MB)
# for the sorting family; four shards of the card at cut sizes for the
# merge-exchange sort and the rest of the shard bookkeeping.
TABLE_SHAPE = (10_000_000, 16)
SORT_N = 100_000_000
UNIQUE_HIGH = 1_000_000
TOPK_K = 1000
PERCENTILES = [1.0, 50.0, 99.0]
INTERPOLATIONS = ("linear", "lower", "higher", "midpoint", "nearest")
HIST_BINS, HIST_RANGE = 128, (-8.0, 8.0)  # a power of two over a power of two: exact bin arithmetic
RANDPERM_N = 10_000_000
LAYER_REPS = 5
LAYER_P = 4
MESH_SORT_N = 25_000_003  # 4 shards of 6,250,001: one padding slot
MESH_EVEN_N = 25_000_000  # unpadded: topk's merge path and median's bisection
MESH_TABLE = (1_000_003, 16)
MESH_DIAG = 4_099
# Bounds of the quickstart, each against float64 on the card, n = 64
# columns, m = 1000 rows, u = 2^-24:
# * cdist: the difference first, then a chain of n squares: d² errs by at
#   most (n + 2)·u·d², d by half that plus the square root's 2u (rsqrt and
#   a Newton step): (n/2 + 4)·u·d;
# * qr (both methods): phase 10's bounds (residual 4√n·u, orthogonality
#   16√n·u, R upper triangular);
# * cholesky of G = aᵀa: ‖LLᵀ − G‖_F <= 4(n + 1)·u·‖L‖_F² (the backward
#   error of Cholesky, |L||Lᵀ| <= ‖L‖_F²);
# * svd: ‖U diag(s) Vh − A‖_F / ‖A‖_F <= 64√n·u (the TSQR's residual and
#   the core SVD's n·u), |s − s64| <= 64√n·u·s_max (Weyl);
# * lstsq: ‖δx‖/‖x‖ <= 8n·u·(κ + κ²·‖r‖/(‖A‖‖x‖)), the least-squares
#   perturbation bound, κ and r from float64;
# * solve(G, coef): ‖δx‖/‖x‖ <= 8n·u·κ(G), against float64 on the same
#   float32 G and coef;
# * slogdet(G): |δ log det| <= n·κ(G)·8n·u, against float64 on the same G;
# * einsum (a matmul, k = 64 terms): |δ| <= (k + 1)·u·(|a| @ |b|);
# * KMeans: finite centers, and the labels are the nearest center in
#   float64 for at least 99.9% of the rows (ties at f32 resolution aside).


def _bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def _equal(label, got, want) -> None:
    """Raise unless got equals want: type, shape and every value, NaN where
    NaN is."""
    import torch

    same = got.shape == want.shape and got.dtype == want.dtype
    if same and got.is_floating_point():
        same = torch.equal(torch.isnan(got), torch.isnan(want)) and torch.equal(got.nan_to_num(0.0), want.nan_to_num(0.0))
    elif same:
        same = torch.equal(got, want)
    if not same:
        raise AssertionError(f"{label}: not equal ({tuple(got.shape)} {got.dtype} against {tuple(want.shape)} {want.dtype})")


def _relative(got, want) -> float:
    import torch

    return (torch.linalg.vector_norm(got.double() - want) / torch.linalg.vector_norm(want)).item()


def quickstart_layer_phase(ht) -> dict:
    """README.md:36-50 on the card, each result against float64 within the
    bounds above; ht.save (README.md:47) into a temporary directory, read
    back bit for bit."""
    import torch

    from heat_tpu_torch.cluster import KMeans

    print("phase layer: the README quickstart (README.md:36-50)", flush=True)
    ht.random.seed(SEED)
    a = ht.random.randn(1000, 64, split=0)
    d = ht.spatial.cdist(a)
    q, r = ht.linalg.qr(a)
    q2, r2 = ht.linalg.qr(a, method="tsqr")
    L = ht.linalg.cholesky(a.T @ a)
    u, s, vh = ht.linalg.svd(a, full_matrices=False)
    coef = ht.linalg.lstsq(a, d[:, 0])
    x = ht.linalg.solve(a.T @ a, coef)
    sgn, logdet = ht.linalg.slogdet(a.T @ a)
    b = ht.random.randn(64, 8)
    c = ht.einsum("ij,jk->ik", a, b)
    with tempfile.TemporaryDirectory(prefix="heat_quickstart_") as tmp:
        ht.save(a, os.path.join(tmp, "a.npy"))
        back = ht.load(os.path.join(tmp, "a.npy"), split=0)
        if not (back.gshape == a.gshape and torch.equal(back.larray, a.larray)):
            raise AssertionError("ht.save(a, 'a.npy') did not read back bit for bit")
    print("  ht.save(a, 'a.npy') (README.md:47): written and read back bit for bit", flush=True)
    km = KMeans(n_clusters=8).fit(a)
    if a.larray.device.type != "cuda" or km.cluster_centers_.larray.device.type != "cuda":
        raise AssertionError("the quickstart did not run on the card")
    m, n = a.gshape
    a64 = a.larray.double()
    out = {}
    d64 = torch.cdist(a64, a64, compute_mode="donot_use_mm_for_euclid_dist")
    out["cdist"] = check_within("quickstart cdist", d.larray, d64, (n / 2 + 4) * U32 * d64 + 1e-30)
    for label, (qq, rr) in (("qr", (q, r)), ("qr tsqr", (q2, r2))):
        errs = qr_errors(a.larray, qq.larray, rr.larray)
        check_qr(f"quickstart {label}", errs, n)
        out[label] = errs["residual"]
    g = (a.T @ a).larray
    l64 = L.larray.double()
    chol = torch.linalg.matrix_norm(l64 @ l64.T - g.double()).item()
    if not chol <= 4 * (n + 1) * U32 * torch.linalg.matrix_norm(l64).item() ** 2:
        raise AssertionError(f"quickstart cholesky: ‖LLᵀ − G‖ {chol:.3e} out of bound")
    out["cholesky"] = chol
    svd_res = _relative(u.larray.double() @ torch.diag(s.larray.double()) @ vh.larray.double(), a64)
    s64 = torch.linalg.svdvals(a64)
    if not (svd_res <= 64 * math.sqrt(n) * U32 and (s.larray.double() - s64).abs().max().item() <= 64 * math.sqrt(n) * U32 * s64[0].item()):
        raise AssertionError(f"quickstart svd: residual {svd_res:.3e} or singular values out of bound")
    out["svd"] = svd_res
    kappa = (s64[0] / s64[-1]).item()
    rhs64 = d.larray[:, 0].double()
    coef64 = torch.linalg.lstsq(a64, rhs64[:, None]).solution[:, 0]
    resid = torch.linalg.vector_norm(a64 @ coef64 - rhs64).item()
    rho = resid / (s64[0].item() * torch.linalg.vector_norm(coef64).item())
    lstsq_err = _relative(coef.larray, coef64)
    if not lstsq_err <= 8 * n * U32 * (kappa + kappa**2 * rho):
        raise AssertionError(f"quickstart lstsq: {lstsq_err:.3e} out of bound")
    out["lstsq"] = lstsq_err
    g64 = g.double()
    kappa_g = torch.linalg.cond(g64).item()
    solve_err = _relative(x.larray, torch.linalg.solve(g64, coef.larray.double()))
    if not solve_err <= 8 * n * U32 * kappa_g:
        raise AssertionError(f"quickstart solve: {solve_err:.3e} out of bound")
    out["solve"] = solve_err
    sign64, logdet64 = torch.linalg.slogdet(g64)
    logdet_err = abs(float(logdet.item()) - logdet64.item())
    if float(sgn.item()) != sign64.item() or not logdet_err <= n * kappa_g * 8 * n * U32:
        raise AssertionError(f"quickstart slogdet: sign {sgn.item()} or |d| {logdet_err:.3e} out of bound")
    out["slogdet"] = logdet_err
    b64 = b.larray.double()
    out["einsum"] = check_within("quickstart einsum", c.larray, a64 @ b64, (n + 1) * U32 * (a64.abs() @ b64.abs()))
    centers = km.cluster_centers_.larray
    if not bool(torch.isfinite(centers).all()) or tuple(centers.shape) != (8, n):
        raise AssertionError("quickstart KMeans: centers not finite or of the wrong shape")
    nearest = torch.cdist(a64, centers.double()).argmin(1)
    agree = (nearest == km.labels_.larray.reshape(-1).to(nearest.dtype)).double().mean().item()
    if agree < 0.999:
        raise AssertionError(f"quickstart KMeans: labels agree with the nearest center on {agree:.4f} of the rows")
    out["kmeans_label_agreement"] = agree
    print(f"  README.md:36-50 on the card within their float64 bounds: {json.dumps(out)}", flush=True)
    return out


def _timed_pair(mine, lib, reps: int = LAYER_REPS) -> tuple:
    """(port ms, torch ms), in turns: port, torch, torch, port."""
    a = _median_ms(mine, reps)
    b = _median_ms(lib, reps)
    b = min(b, _median_ms(lib, reps))
    a = min(a, _median_ms(mine, reps))
    return a, b


def indexing_phase(ht) -> dict:
    """BASELINE config 3's table at p = 1: getitem and setitem, each bit for
    bit against the same torch indexing of the one shard, timed beside it
    and its HBM bound (bytes read plus bytes written)."""
    import torch

    rows, cols = TABLE_SHAPE
    print(f"phase layer: indexing on {rows} x {cols} float32, split=0 (BASELINE config 3's table)", flush=True)
    ht.random.seed(SEED + 12)
    x = ht.random.randn(rows, cols, split=0)
    perm = ht.random.randperm(rows)
    idx = perm[: rows // 10]
    t = x.larray  # the one shard, not a copy
    it = idx.larray
    mask_t = t[:, 0] > 1.0
    mask = x[:, 0] > 1.0
    row_bytes = cols * 4
    row, stop = rows // 8 + 7, rows // 5  # an int key; a written block of rows
    sel = int(mask_t.sum())
    cases = {
        "x[::3, 2:9]": (lambda: x[::3, 2:9], lambda: t[::3, 2:9].contiguous(), 2 * (-(-rows // 3)) * 7 * 4),
        "x[-5:]": (lambda: x[-5:], lambda: t[-5:].clone(), 2 * 5 * row_bytes),
        "x[::-1]": (lambda: x[::-1], lambda: t.flip(0), 2 * rows * row_bytes),
        "x[row]": (lambda: x[row], lambda: t[row].clone(), 2 * row_bytes),
        "x[mask]": (lambda: x[mask], lambda: t[mask_t], rows + 2 * sel * row_bytes),
        "x[perm[:10^6]]": (lambda: x[idx], lambda: t[it], it.numel() * 8 + 2 * it.numel() * row_bytes),
    }
    out = {"selected_rows": sel}
    for label, (mine, lib, nbytes) in cases.items():
        got = mine()
        _equal(label, got.larray, lib())
        if got.split != (None if label == "x[row]" else 0):
            raise AssertionError(f"{label}: split {got.split}")
        ms, lib_ms = _timed_pair(mine, lib)
        out[label] = {"ms": ms, "torch_ms": lib_ms, "bound_ms": _bound_ms(nbytes)}
    shadow = t.clone()
    value_row = ht.arange(cols, dtype=ht.int64)  # a cast and a broadcast
    value_col = ht.array(torch.arange(it.numel(), dtype=torch.int32, device=t.device)[:, None] % 97)  # (10^6, 1) int32
    sets = {
        "x[100:rows/5] = 2.5": (
            lambda: x.__setitem__(slice(100, stop), 2.5),
            lambda: shadow.__setitem__(slice(100, stop), 2.5),
            (stop - 100) * row_bytes,
        ),
        "x[mask] = arange(16)": (
            lambda: x.__setitem__(mask, value_row),
            lambda: shadow.__setitem__(mask_t, torch.arange(cols, device=t.device).float()),
            rows + sel * row_bytes + cols * 8,
        ),
        "x[perm[:10^6]] = int32 column": (
            lambda: x.__setitem__(idx, value_col),
            lambda: shadow.__setitem__(it, value_col.larray.float()),
            it.numel() * 8 + it.numel() * 4 + it.numel() * row_bytes,
        ),
    }
    for label, (mine, lib, nbytes) in sets.items():
        mine()
        lib()
        if x.larray.data_ptr() != t.data_ptr():
            raise AssertionError(f"{label}: the write copied the table")
        _equal(label, x.larray, shadow)
        ms, lib_ms = _timed_pair(mine, lib)
        out[label] = {"ms": ms, "torch_ms": lib_ms, "bound_ms": _bound_ms(nbytes)}
    _equal("after the writes", x.larray, shadow)
    print(f"  {len(cases)} getitem and {len(sets)} setitem equal torch bit for bit; ms: {json.dumps(out)}", flush=True)
    return out


def _order_statistic(sorted_v, pos: float, method: str):
    """The percentile at position pos from the sorted values, in their type,
    as the port's bisection path interpolates."""
    lo, hi = sorted_v[math.floor(pos)], sorted_v[math.ceil(pos)]
    if method == "lower":
        return lo
    if method == "higher":
        return hi
    if method == "nearest":
        return lo if round(pos) <= math.floor(pos) else hi
    if method == "midpoint":
        return (lo + hi) * 0.5
    return lo + (hi - lo) * (pos - math.floor(pos))


def sorting_phase(ht) -> dict:
    """The sorting family on 10^8 float32 at p = 1, each against torch."""
    import torch

    print(f"phase layer: the sorting family on {SORT_N} float32, split=0, normal(3, 2)", flush=True)
    ht.random.seed(SEED + 13)
    v = ht.random.normal(3.0, 2.0, (SORT_N,), split=0)
    t = v.larray
    n = SORT_N
    out = {}
    sorted_t = None
    for descending in (False, True):
        label = "sort descending" if descending else "sort"
        values, indices = ht.sort(v, descending=descending)
        tv, ti = torch.sort(t, descending=descending, stable=True)
        _equal(label + " values", values.larray, tv)
        _equal(label + " indices", indices.larray, ti)
        if not descending:
            sorted_t = tv
        del values, indices, ti
        ms, lib_ms = _timed_pair(lambda: ht.sort(v, descending=descending), lambda: torch.sort(t, descending=descending, stable=True))
        out[label] = {"ms": ms, "torch_ms": lib_ms, "bound_ms": _bound_ms(n * 4 + n * 12)}
    top = ht.topk(v, TOPK_K)
    _equal("topk values", top[0].larray, torch.topk(t, TOPK_K)[0])
    ms, lib_ms = _timed_pair(lambda: ht.topk(v, TOPK_K), lambda: torch.topk(t, TOPK_K))
    out["topk"] = {"ms": ms, "torch_ms": lib_ms, "bound_ms": _bound_ms(n * 4 + TOPK_K * 12)}
    # percentiles: the order statistics are the sorted elements themselves
    pcts = {}
    for method in INTERPOLATIONS:
        got = ht.percentile(v, PERCENTILES, interpolation=method).larray
        want = torch.stack([_order_statistic(sorted_t, q / 100.0 * (n - 1), method) for q in PERCENTILES])
        _equal(f"percentile {method}", got, want)
        pcts[method] = got.tolist()
    med = ht.median(v).larray
    _equal("median", med, _order_statistic(sorted_t, 0.5 * (n - 1), "linear"))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for method in INTERPOLATIONS:
            ht.percentile(v, PERCENTILES, interpolation=method)
        ht.median(v)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    ms, lib_ms = _timed_pair(lambda: ht.percentile(v, PERCENTILES), lambda: torch.sort(t), reps=3)
    out["percentile [1, 50, 99]"] = {"ms": ms, "torch_sort_ms": lib_ms, "bound_ms": _bound_ms(n * 4), "values": pcts["linear"]}
    ms = _median_ms(lambda: ht.median(v), 3)
    out["median"] = {"ms": ms, "bound_ms": _bound_ms(n * 4), "value": med.item()}
    print(f"  sort (both orders, values and int64 indices), topk, {len(INTERPOLATIONS)} percentile interpolations and "
          f"median equal torch bit for bit; warm percentiles and median ran under set_sync_debug_mode('error')", flush=True)
    del sorted_t
    # counting
    ints = ht.random.randint(0, UNIQUE_HIGH, (n,), split=0)
    it = ints.larray
    uniq = ht.unique(ints)
    _equal("unique", uniq.larray, torch.unique(it, sorted=True))
    ms, lib_ms = _timed_pair(lambda: ht.unique(ints), lambda: torch.unique(it, sorted=True), reps=3)
    out["unique"] = {"ms": ms, "torch_ms": lib_ms, "bound_ms": _bound_ms(n * 4 + uniq.gnbytes), "count": uniq.gshape[0]}
    counts = ht.bincount(ints)
    values_present, present_counts = torch.unique(it, return_counts=True)
    independent = torch.zeros(UNIQUE_HIGH, dtype=torch.int64, device=it.device)
    independent[values_present.long()] = present_counts
    _equal("bincount", counts.larray, independent)
    ms, lib_ms = _timed_pair(lambda: ht.bincount(ints), lambda: torch.bincount(it), reps=3)
    out["bincount"] = {"ms": ms, "torch_ms": lib_ms, "bound_ms": _bound_ms(n * 4 + UNIQUE_HIGH * 8)}
    del ints, it, uniq, counts, independent, values_present, present_counts
    lo, hi = HIST_RANGE
    hc = ht.histc(v, HIST_BINS, lo, hi)
    _equal("histc", hc.larray, torch.histc(t, HIST_BINS, lo, hi))
    ms, lib_ms = _timed_pair(lambda: ht.histc(v, HIST_BINS, lo, hi), lambda: torch.histc(t, HIST_BINS, lo, hi))
    out["histc"] = {"ms": ms, "torch_ms": lib_ms, "bound_ms": _bound_ms(n * 4 + HIST_BINS * 4)}
    hist, edges = ht.histogram(v, bins=HIST_BINS, range=HIST_RANGE)
    e = torch.linspace(lo, hi, HIST_BINS + 1, device=t.device)
    _equal("histogram edges", edges.larray, e)
    bucket = torch.bucketize(t, e, right=True) - 1  # numpy's bins, the last one closed
    bucket = torch.where(t == hi, HIST_BINS - 1, bucket)
    keep = (bucket >= 0) & (bucket < HIST_BINS)
    b_values, b_counts = torch.unique(bucket[keep], return_counts=True)
    independent = torch.zeros(HIST_BINS, dtype=torch.int64, device=t.device)
    independent[b_values] = b_counts
    _equal("histogram counts", hist.larray, independent)
    ms = _median_ms(lambda: ht.histogram(v, bins=HIST_BINS, range=HIST_RANGE))
    out["histogram"] = {"ms": ms, "bound_ms": _bound_ms(n * 4 + HIST_BINS * 8)}
    dig = ht.digitize(v, e)
    _equal("digitize", dig.larray, torch.bucketize(t, e, right=True))
    ms, lib_ms = _timed_pair(lambda: ht.digitize(v, e), lambda: torch.bucketize(t, e, right=True))
    out["digitize"] = {"ms": ms, "torch_ms": lib_ms, "bound_ms": _bound_ms(n * 4 + n * 8)}
    del hc, hist, edges, dig, bucket, keep
    print("  unique, bincount, histc, histogram and digitize equal independent torch counts", flush=True)
    # the draws
    draws = {}
    for label, draw, mean, std in (
        ("normal(3, 2)", lambda comm=None: ht.random.normal(3.0, 2.0, (n,), split=0, comm=comm), 3.0, 2.0),
        ("uniform(-2, 5)", lambda comm=None: ht.random.uniform(-2.0, 5.0, (n,), split=0, comm=comm), 1.5, 7.0 / math.sqrt(12)),
    ):
        ht.random.seed(SEED + 14)
        sample = draw()
        s64 = sample.larray.double()
        got_mean, got_std = s64.mean().item(), s64.std().item()
        if abs(got_mean - mean) > 6 * std / math.sqrt(n) or abs(got_std - std) > 6 * std / math.sqrt(n):
            raise AssertionError(f"{label}: mean {got_mean}, std {got_std} beyond 6σ/√n")
        ht.random.seed(SEED + 14)
        ms = _median_ms(lambda: draw(), 3)
        draws[label] = {"mean": got_mean, "std": got_std, "ms": ms, "bound_ms": _bound_ms(n * 4)}
        del sample, s64
    ht.random.seed(SEED + 15)
    perm = ht.random.randperm(RANDPERM_N)
    _equal("randperm sorted", torch.sort(perm.larray)[0], torch.arange(RANDPERM_N, device=t.device))
    card = t.device
    from heat_tpu_torch.core.communication import MeshCommunication

    for label, draw in (("normal", lambda c: ht.random.normal(3.0, 2.0, (MESH_SORT_N,), split=0, comm=c)),
                        ("uniform", lambda c: ht.random.uniform(-2.0, 5.0, (MESH_SORT_N,), split=0, comm=c)),
                        ("randperm", lambda c: ht.random.randperm(RANDPERM_N, split=0, comm=c))):
        ht.random.seed(SEED + 16)
        one = draw(MeshCommunication([card])).larray
        ht.random.seed(SEED + 16)
        four = draw(MeshCommunication([card] * LAYER_P)).larray
        _equal(f"{label} on four shards", four, one)
    out["draws"] = draws
    print(f"  normal and uniform within 6σ/√n, randperm({RANDPERM_N}) sorted is arange, and one seed gives the "
          f"same values on {LAYER_P} shards as on one", flush=True)
    return out


def layer_mesh_phase(ht) -> dict:
    """Four shards on the one card against one shard, through a mesh that
    counts its collectives: the merge-exchange sort with NaN in the data
    and in every padding slot, topk's merge path, unique, median, getitem
    and setitem across shard boundaries, halos, pad, roll and diag."""
    import torch

    from heat_tpu_torch.core.communication import MeshCommunication

    card = torch.device("cuda", 0)
    mesh1, mesh4 = MeshCommunication([card]), counting_mesh([card] * LAYER_P)
    print(f"phase layer: {LAYER_P} shards on one card against one shard", flush=True)
    ht.random.seed(SEED + 17)
    base = ht.random.normal(3.0, 2.0, (MESH_SORT_N,), split=0, comm=mesh1)
    t = base.larray
    t[torch.arange(0, MESH_SORT_N, 1_000_003, device=card)] = float("nan")
    out = {}
    ht.use_comm(mesh4)
    try:
        x4 = ht.array(t, split=0)
        pad = _poison_padding(x4)
        if pad < 1:
            raise AssertionError("the four-shard operand has no padding")
        for descending in (False, True):
            v1, i1 = ht.sort(ht.array(t, split=0, comm=mesh1), descending=descending)
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            mesh4.calls.clear()
            v4, i4 = ht.sort(x4, descending=descending)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - before
            _equal("four-shard sort values", v4.larray, v1.larray)
            _equal("four-shard sort indices", i4.larray, i1.larray)
            if dict(mesh4.calls) != {"ppermute": 2 * LAYER_P}:
                raise AssertionError(f"four-shard sort: collectives {dict(mesh4.calls)}")
            data_and_indices = MESH_SORT_N * (4 + 8)
            if peak + MESH_SORT_N * 4 >= 3 * data_and_indices:
                raise AssertionError(f"four-shard sort: peak {peak} bytes")
            out["sort descending" if descending else "sort"] = {
                "ppermutes": mesh4.calls["ppermute"], "peak_over_data_and_indices": (peak + MESH_SORT_N * 4) / data_and_indices,
                "ms": _median_ms(lambda: ht.sort(x4, descending=descending), 3),
            }
            del v1, i1, v4, i4
        even1 = ht.array(t[:MESH_EVEN_N].nan_to_num(3.0), split=0, comm=mesh1)
        even4 = ht.array(even1.larray, split=0)
        mesh4.calls.clear()
        top4 = ht.topk(even4, TOPK_K)
        calls = dict(mesh4.calls)
        top1 = ht.topk(even1, TOPK_K)
        _equal("four-shard topk values", top4[0].larray, top1[0].larray)
        _equal("four-shard topk indices", top4[1].larray, top1[1].larray)
        if calls != {"allreduce": 1}:
            raise AssertionError(f"four-shard topk: collectives {calls}")
        _equal("four-shard median", ht.median(even4).larray, ht.median(even1).larray)
        ints1 = ht.random.randint(0, UNIQUE_HIGH, (MESH_SORT_N,), split=0, comm=mesh1)
        mesh4.calls.clear()
        u4 = ht.unique(ht.array(ints1.larray, split=0))
        _equal("four-shard unique", u4.larray, ht.unique(ints1).larray)
        out["topk_collectives"], out["unique_collectives"] = calls, dict(mesh4.calls)
        del even1, even4, ints1, u4, x4
        # indexing across the shard boundaries of a ragged table
        table = t[: MESH_TABLE[0] * MESH_TABLE[1]].nan_to_num(0.0).reshape(MESH_TABLE).clone()
        y1 = ht.array(table, split=0, comm=mesh1)
        y4 = ht.array(table, split=0)
        _poison_padding(y4)
        m = MESH_TABLE[0]  # keys whose rows cross the shard boundaries at m/4, m/2, 3m/4
        keys = [slice(m // 500, 4 * m // 5, 7), (slice(None, None, -3), 5), slice(m // 4 - 5, m // 4 + 5),
                torch.arange(0, MESH_TABLE[0], 997, device=card), table[:, 0] > 4.0, -1, (slice(None), slice(3, 9))]
        for key in keys:
            _equal(f"four-shard getitem {key}", y4[key].larray, y1[key].larray)
        writes = [(slice(m // 4 - 10, 3 * m // 4 + 10), 1.5), (table[:, 1] < 0.0, ht.arange(16, dtype=ht.int32, comm=mesh1)),
                  (torch.arange(3, MESH_TABLE[0], 1013, device=card), -7.0), ((slice(None), 2), 0.25), (slice(None, None, -5), 9.0)]
        for key, value in writes:
            y4[key] = value
            y1[key] = value
            _equal(f"four-shard setitem {key}", y4.larray, y1.larray)
        # halos, pad, roll, diag
        mesh4.calls.clear()
        y4.get_halo(2)
        if dict(mesh4.calls) != {"ppermute": 2}:
            raise AssertionError(f"halos: collectives {dict(mesh4.calls)}")
        block = y4.shards[0].shape[0]
        from_prev, from_next = y4.halos
        logical = y4.larray
        for r in range(LAYER_P):
            start = r * block
            want_prev = logical[start - 2:start] if r else torch.zeros_like(from_prev[r])
            nxt = logical[start + block:start + block + 2]
            want_next = torch.cat([nxt, nxt.new_zeros((2 - nxt.shape[0], MESH_TABLE[1]))]) if r < LAYER_P - 1 else torch.zeros_like(from_next[r])
            _equal(f"halo from_prev of shard {r}", from_prev[r], want_prev)
            _equal(f"halo from_next of shard {r}", from_next[r], want_next)
        _equal("four-shard pad", ht.pad(y4, ((2, 3), (1, 1)), mode="reflect").larray, ht.pad(y1, ((2, 3), (1, 1)), mode="reflect").larray)
        _equal("four-shard roll", ht.roll(y4, 12345, 0).larray, ht.roll(y1, 12345, 0).larray)
        square = torch.randn(MESH_DIAG, MESH_DIAG, device=card, generator=torch.Generator(card).manual_seed(SEED))
        _equal("four-shard diagonal", ht.diag(ht.array(square, split=0)).larray, ht.diag(ht.array(square, split=0, comm=mesh1)).larray)
        _equal("four-shard diag of a vector", ht.diag(ht.array(square[:, 0], split=0)).larray,
               ht.diag(ht.array(square[:, 0], split=0, comm=mesh1)).larray)
    finally:
        ht.use_comm(None)
    print(f"  sort (NaN data, NaN padding) equal bit for bit with 2p ppermutes and its peak under 3x data and indices; "
          f"topk one allreduce, unique, median, getitem/setitem across boundaries, halos, pad, roll, diag equal one shard: "
          f"{json.dumps(out)}", flush=True)
    return out


def array_layer_path(ht, smi: str) -> dict:
    """Phase 12: the array layer on the card; returns its numbers."""
    import torch

    numbers = {"card": smi, "peak_gb": {}}
    for label, phase in (("quickstart", quickstart_layer_phase), ("indexing", indexing_phase),
                         ("sorting", sorting_phase), ("mesh", layer_mesh_phase)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        numbers[label] = phase(ht)
        numbers["peak_gb"][label] = torch.cuda.max_memory_allocated() / 1e9
    return numbers


# ---------------------------------------------------------------------------
# Phase 13: the estimators (no kernel of their own; Spectral reaches B1)
# ---------------------------------------------------------------------------
EST_TABLE = (10_000_000, 16)  # BASELINE config 3
EST_K = 8
EST_ITERS = 8
EST_F64_ROWS = 1_000_000  # rows per float64 block of the checks
SPECTRAL_N = 40_000  # the strong size of BASELINE's distance protocol (BASELINE.md:15)
SPECTRAL_F = 16
SPECTRAL_SPREAD = 4.8  # blob means ~ N(0, 4.8²) per feature, unit noise
SPECTRAL_GAMMA = 1.0 / 32.0  # rbf sigma = sqrt(1/(2 gamma)) = 4
SPECTRAL_LANCZOS = 300
SUBSPACE_BLOCK, SUBSPACE_STEPS = 16, 80
KNN_TRAIN = (100_000, 64)  # BASELINE config 2
KNN_QUERIES, KNN_K, KNN_CLASSES, KNN_BLOCK = 10_000, 5, 8, 1_000
NB_CLASSES = 8
LASSO_PROTOCOL = (100_000, 64, 0.1, 20)  # benchmarks/lasso.py: n, f, lambda, sweeps
LASSO_GRAM = (10_000_000, 64, 0.1, 20)
LASSO_RESIDUAL = (200_000, 2_100, 0.1, 3)  # m² > 2^22: the incremental-residual sweep
DEMO_SEEDS, DEMO_MIN_MET = 20, 10
EST_P = 4
EST_MESH_TABLE = (1_000_003, 16)  # 4 shards of 250,001 rows: one padding row
EST_MESH_QUERIES = 1_000
BATCHPARALLEL_ROWS = 1_000_000  # 4 unpadded shards
# blob means ~ N(0, 30²) per feature: the init's last kmeans++ runs over
# only p·k candidates, ~4 per blob, unweighted, and puts two centers into
# one blob often unless the blobs lie far apart; heat_tpu recovers 8 blobs
# of means ~ N(0, 3²) from 8 of 20 draws, of N(0, 30²) from 20 of 20
# (4 CPU devices), the port from 13 and 40 of 40
BATCHPARALLEL_SPREAD = 30.0
# Bounds of phase 13, with u = 2^-24:
# * KMedians' centers against float64 midpoints of each cluster's sorted
#   columns: the port rounds (a + b)·0.5 of two float32 values once, so
#   |c − m| <= u|m|;
# * labels against float64 distances to the last iteration's input
#   centers: rows whose two nearest squared distances lie within twice the
#   quadratic expansion's bound, 4(f+2)u(|x|² + |c|²), may go either way;
# * a medoid against the member nearest the float64 median: its distance
#   exceeds the least by at most 2((f+2)u·d + 2u|m|√d), d its distance;
# * T's 8 smallest eigenvalues against float64 subspace iteration on L:
#   1e-5, Lanczos in float32 on a matrix of norm <= 2 (~80u);
# * GaussianNB's moments against float64: float32 sums of 1.25·10⁶ terms,
#   |d| <= 1e-4 (|μ| + σ) for theta_ and 1e-4 σ² for var_; partial_fit in
#   two halves against fit within the same bounds; probability rows sum to
#   1 within 1e-5;
# * Lasso's θ against a float64 coordinate descent on the float64 Gram:
#   float32 sums over n samples err by ~u√n of their terms, so
#   |d| <= 8u√n · max(1, max|θ64|);
# * examples/cluster_demo.py: an init draw that puts two centers into one
#   class is the algorithm's local minimum, not a fault: heat_tpu itself
#   meets tests/test_ml.py's thresholds on 17 of 20 kmeans++ draws and on
#   37 of 50 of Spectral's random ones on the CPU, so at least half of
#   DEMO_SEEDS = 20 draws must (a 0.5% chance of failing at 74%);
# * four shards of the card against one: KMedians, KMedoids and GaussianNB
#   bit for bit (the same logical rows); Lasso within the bound above;
#   KNN equal but for queries within twice the expansion's bound of a tie.
LASSO_UNITS = 8
NB_BOUND = 1e-4
EIGEN_BOUND = 1e-5


def _same_partition(a, b) -> bool:
    """True when the labels a and b split the rows alike, up to renaming."""
    import torch

    pairs = torch.unique(a.long() * (int(b.max()) + 1) + b.long()).numel()
    return pairs == torch.unique(a).numel() == torch.unique(b).numel()


def _blobs_on_card(n, f, k, spread, seed):
    """(data f32, blob ids int64, blob means) made on the card from seed."""
    import torch

    card = torch.device("cuda", 0)
    gen = torch.Generator(card).manual_seed(seed)
    means = torch.randn(k, f, device=card, generator=gen) * spread
    ids = torch.randint(0, k, (n,), device=card, generator=gen)
    data = torch.randn(n, f, device=card, generator=gen)
    data += means[ids]
    return data, ids, means


def _midpoint_medians64(data, labels, k):
    """(k, f) float64 medians of each cluster's columns, the mean of the two
    middle values for an even count."""
    import torch

    out = []
    for c in range(k):
        v = torch.sort(data[labels == c].double(), dim=0)[0]
        m = v.shape[0]
        out.append((v[(m - 1) // 2] + v[m // 2]) / 2)
    return torch.stack(out)


def _check_labels64(label, data, centers, labels) -> int:
    """Labels against float64 distances to ``centers``; returns the rows
    exempt as near ties."""
    import torch

    f = data.shape[1]
    c64 = centers.double()
    cn = (c64 * c64).sum(1)
    exempt = 0
    for r0 in range(0, data.shape[0], EST_F64_ROWS):
        x = data[r0:r0 + EST_F64_ROWS].double()
        d2 = ((x[:, None, :] - c64[None]) ** 2).sum(-1)
        two = torch.topk(d2, 2, dim=1, largest=False)
        bound = 8 * (f + 2) * 2.0**-24 * ((x * x).sum(1) + cn[two.indices[:, 0]])
        tie = (two.values[:, 1] - two.values[:, 0]) <= bound
        wrong = (labels[r0:r0 + EST_F64_ROWS] != two.indices[:, 0]) & ~tie
        if bool(wrong.any()):
            raise AssertionError(f"{label}: {int(wrong.sum())} labels differ from the float64 argmin")
        exempt += int(tie.sum())
    return exempt


def kmedians_phase(ht) -> dict:
    """KMedians and KMedoids on BASELINE config 3's table from a precomputed
    init: centers against float64 medians, labels against a float64
    argmin, medoids rows of the data; time, peak memory and torch.sort of
    the same 1.6·10⁸ values."""
    import torch

    from heat_tpu_torch.cluster.kmedians import _value_orders

    n, f = EST_TABLE
    k = EST_K
    print(f"phase estimators: KMedians and KMedoids on {n} x {f} float32, k={k}, {EST_ITERS} iterations", flush=True)
    data, ids, means = _blobs_on_card(n, f, k, 3.0, SEED + 31)
    x = ht.array(data, split=0, copy=False)
    init = ht.array(means + 0.5)
    u = 2.0**-24
    out = {"reference_copy_gb": k * n * f * 4 / 1e9}
    for name in ("KMedians", "KMedoids"):
        cls = getattr(ht.cluster, name)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        est, first_ms = _timed(lambda: cls(n_clusters=k, init=init, max_iter=EST_ITERS).fit(x))
        peak = torch.cuda.max_memory_allocated() - base
        _, warm_ms = _timed(lambda: cls(n_clusters=k, init=init, max_iter=EST_ITERS).fit(x))
        before = cls(n_clusters=k, init=init, max_iter=EST_ITERS - 1).fit(x)
        centers, labels = est.cluster_centers_.larray, est.labels_.larray
        if est.n_iter_ != EST_ITERS or tuple(centers.shape) != (k, f) or not bool(torch.isfinite(centers).all()):
            raise AssertionError(f"{name}: n_iter {est.n_iter_}, centers {tuple(centers.shape)}")
        exempt = _check_labels64(name, data, before.cluster_centers_.larray, labels)
        med64 = _midpoint_medians64(data, labels, k)
        if name == "KMedians":
            err = (centers.double() - med64).abs()
            if not bool((err <= u * med64.abs()).all()):
                raise AssertionError(f"{name}: centers differ from the float64 medians by {err.max().item():.3e}")
            check = float(err.max())
        else:
            check = 0.0
            for c in range(k):
                member = data[labels == c].double()
                d = ((member - med64[c]) ** 2).sum(1)
                chosen = ((centers[c].double() - med64[c]) ** 2).sum()
                if not bool((member == centers[c].double()).all(1).any()):
                    raise AssertionError(f"{name}: center {c} is not a row of its cluster")
                slack = 2 * ((f + 2) * u * chosen + 2 * u * med64[c].norm() * chosen.sqrt())
                if not bool(chosen - d.min() <= slack):
                    raise AssertionError(f"{name}: medoid {c} is {float(chosen - d.min()):.3e} farther than the nearest member")
                check = max(check, float(chosen - d.min()))
        if not _same_partition(labels, ids):
            raise AssertionError(f"{name}: the labels do not recover the blobs")
        if peak >= k * n * f * 4 / 2:
            raise AssertionError(f"{name}: peak {peak / 1e9:.2f} GB, not under half the reference's {k * n * f * 4 / 1e9:.2f} GB copy")
        out[name] = {"first_ms": first_ms, "warm_ms": warm_ms, "ms_per_iteration": warm_ms / EST_ITERS,
                     "peak_gb": peak / 1e9, "label_rows_exempt": exempt, "check": check, "inertia": est.inertia_}
        print(f"  {name}: first fit {first_ms:.1f} ms, warm {warm_ms:.1f} ms ({warm_ms / EST_ITERS:.2f} ms/iteration), "
              f"peak {peak / 1e9:.3f} GB above the data; labels = float64 argmin ({exempt} near-tie rows), "
              f"{'centers within u|m| of float64 medians' if name == 'KMedians' else 'medoids rows of the data, nearest the median'} "
              f"({check:.3e})", flush=True)
        del est, before, centers, labels
    out["value_orders_ms"] = _median_ms(lambda: _value_orders(data), 3)
    out["torch_sort_ms"] = _median_ms(lambda: torch.sort(data.reshape(-1)), 3)
    print(f"  per fit: the columns' value orders {out['value_orders_ms']:.2f} ms; torch.sort of the same "
          f"{n * f:.3e} values {out['torch_sort_ms']:.2f} ms", flush=True)
    return out


def _smallest_eigenvalues64(L, count):
    """The ``count`` smallest eigenvalues of the symmetric ``L`` (spectrum in
    [0, 2]) in float64: subspace iteration on 2I − L over a block of
    SUBSPACE_BLOCK vectors, then eigvalsh of the Rayleigh quotient QᵀLQ;
    returns (values, the largest residual ‖Ly − θy‖ of their Ritz pairs)."""
    import torch

    B = L.double()
    gen = torch.Generator(B.device).manual_seed(SEED)
    Q = torch.linalg.qr(torch.randn(B.shape[0], SUBSPACE_BLOCK, dtype=B.dtype, device=B.device, generator=gen))[0]
    for _ in range(SUBSPACE_STEPS):
        Q = torch.linalg.qr(2.0 * Q - B @ Q)[0]
    BQ = B @ Q
    theta, s = torch.linalg.eigh(Q.T @ BQ)
    y = Q @ s[:, :count]
    residual = torch.linalg.vector_norm(B @ y - y * theta[:count], dim=0).max().item()
    return theta[:count], residual


def spectral_phase(ht) -> dict:
    """Spectral on 40,000 x 16 float32, 8 blobs: the fit through B1 (the
    Lloyd kernel's launches counted), the labels against the blobs, T's
    smallest eigenvalues against float64, each stage timed."""
    import torch

    from heat_tpu_torch.ops import lloyd

    n, f, k = SPECTRAL_N, SPECTRAL_F, EST_K
    print(f"phase estimators: Spectral on {n} x {f} float32, {k} blobs, gamma {SPECTRAL_GAMMA}, n_lanczos {SPECTRAL_LANCZOS}", flush=True)
    data, ids, _ = _blobs_on_card(n, f, k, SPECTRAL_SPREAD, SEED + 37)
    x = ht.array(data, split=0, copy=False)
    sp = ht.cluster.Spectral(n_clusters=k, gamma=SPECTRAL_GAMMA, n_lanczos=SPECTRAL_LANCZOS, init="kmeans++", random_state=SEED)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    lloyd.LAUNCHES = 0
    _, fit_ms = _timed(lambda: sp.fit(x))
    launches = lloyd.LAUNCHES
    peak = torch.cuda.max_memory_allocated() - base
    if launches != sp._cluster.n_iter_ or launches < 1:
        raise AssertionError(f"Spectral.fit launched the Lloyd kernel {launches} times over {sp._cluster.n_iter_} iterations")
    if not _same_partition(sp.labels_.larray, ids):
        raise AssertionError("Spectral: the labels do not recover the blobs")
    sigma = math.sqrt(1.0 / (2.0 * SPECTRAL_GAMMA))
    S, sim_ms = _timed(lambda: ht.spatial.rbf(x, sigma=sigma, quadratic_expansion=True))
    L, lap_ms = _timed(lambda: ht.graph.Laplacian(lambda _: S).construct(x))
    del S
    (V, T), lanczos_ms = _timed(lambda: ht.linalg.lanczos(L, SPECTRAL_LANCZOS))
    evals, evecs = torch.linalg.eigh(T.larray)
    components = ht.array((V.larray @ evecs)[:, :k], split=0)
    _, kmeans_ms = _timed(lambda: ht.cluster.KMeans(n_clusters=k, init="kmeans++", random_state=SEED).fit(components))
    want, residual = _smallest_eigenvalues64(L.larray, k)
    err = (evals[:k].double() - want).abs().max().item()
    del L, V, T
    if not (err <= EIGEN_BOUND and residual <= 1e-8):
        raise AssertionError(f"Spectral: T's smallest eigenvalues {err:.3e} from float64 (residual {residual:.3e})")
    out = {"fit_ms": fit_ms, "similarity_ms": sim_ms, "laplacian_ms": lap_ms, "lanczos_ms": lanczos_ms,
           "kmeans_ms": kmeans_ms, "lloyd_launches": launches, "kmeans_iterations": sp._cluster.n_iter_,
           "peak_gb": peak / 1e9, "eigenvalue_err": err, "ritz_residual64": residual,
           "smallest_eigenvalues": [float(v) for v in want]}
    print(f"  fit {fit_ms:.1f} ms, {launches} Lloyd launches over {sp._cluster.n_iter_} iterations, blobs recovered; "
          f"similarity {sim_ms:.1f} ms, Laplacian {lap_ms:.1f}, Lanczos {lanczos_ms:.1f}, KMeans {kmeans_ms:.1f}; "
          f"peak {peak / 1e9:.2f} GB; T's {k} smallest eigenvalues within {err:.3e} of float64 (Ritz residual {residual:.1e})",
          flush=True)
    return out


def _knn_vote64(train, labels, queries, k, classes):
    """(m,) labels of a float64 vote over the k smallest float64 distances
    and the (m,) mask of queries whose k-th and (k+1)-th squared distances
    lie within twice the float32 expansion's bound."""
    import torch

    f = train.shape[1]
    t64 = train.double()
    tn = (t64 * t64).sum(1)
    onehot = torch.nn.functional.one_hot(labels.long(), classes).double()
    votes, exempt = [], []
    block = max(1, min(KNN_BLOCK, (1 << 27) // train.shape[0]))
    for r0 in range(0, queries.shape[0], block):
        q = queries[r0:r0 + block].double()
        qn = (q * q).sum(1)
        d2 = torch.clamp(qn[:, None] + tn[None, :] - 2.0 * (q @ t64.T), min=0.0)
        near = torch.topk(d2, k + 1, dim=1, largest=False)
        edge = torch.maximum(tn[near.indices[:, k - 1]], tn[near.indices[:, k]])
        bound = 8 * (f + 2) * 2.0**-24 * (qn + edge)
        exempt.append(near.values[:, k] - near.values[:, k - 1] <= bound)
        votes.append(torch.argmax(onehot[near.indices[:, :k]].sum(1), dim=1))
    return torch.cat(votes), torch.cat(exempt)


def knn_phase(ht) -> dict:
    """KNN on BASELINE config 2's 100,000 x 64 float32 with 8 classes,
    10,000 queries, k = 5: labels against a float64 vote; predict timed."""
    import torch

    n, f = KNN_TRAIN
    print(f"phase estimators: KNeighborsClassifier(k={KNN_K}) on {n} x {f} float32, {KNN_QUERIES} queries", flush=True)
    data, ids, _ = _blobs_on_card(n + KNN_QUERIES, f, KNN_CLASSES, 1.0, SEED + 41)
    train, queries = data[:n], data[n:]
    knn = ht.classification.KNeighborsClassifier(KNN_K).fit(ht.array(train, split=0), ht.array(ids[:n], split=0))
    xq = ht.array(queries, split=0)
    pred, first_ms = _timed(lambda: knn.predict(xq))
    warm_ms = _median_ms(lambda: knn.predict(xq), 3)
    want, exempt = _knn_vote64(train, ids[:n], queries, KNN_K, KNN_CLASSES)
    wrong = (pred.larray != want) & ~exempt
    if bool(wrong.any()) or pred.shape != (KNN_QUERIES,):
        raise AssertionError(f"KNN: {int(wrong.sum())} labels differ from the float64 vote")
    accuracy = float((pred.larray == ids[n:]).float().mean())
    print(f"  predict first {first_ms:.1f} ms, warm {warm_ms:.2f} ms; labels = float64 vote "
          f"({int(exempt.sum())} near-tie queries exempt); accuracy {accuracy:.4f}", flush=True)
    return {"first_ms": first_ms, "warm_ms": warm_ms, "exempt": int(exempt.sum()), "accuracy": accuracy}


def gaussian_nb_phase(ht) -> dict:
    """GaussianNB on 10⁷ x 16 float32, 8 classes: moments against float64,
    partial_fit in two halves against fit, probabilities summing to 1."""
    import torch

    n, f = EST_TABLE
    c = NB_CLASSES
    print(f"phase estimators: GaussianNB on {n} x {f} float32, {c} classes", flush=True)
    data, ids, _ = _blobs_on_card(n, f, c, 2.0, SEED + 43)
    data *= 1.0 + ids[:, None] / 4.0
    x, y = ht.array(data, split=0, copy=False), ht.array(ids, split=0)
    nb, first_ms = _timed(lambda: ht.naive_bayes.GaussianNB().fit(x, y))
    _, warm_ms = _timed(lambda: ht.naive_bayes.GaussianNB().fit(x, y))
    theta_err = var_err = 0.0
    for k in range(c):
        rows = data[ids == k].double()
        var64, mu64 = torch.var_mean(rows, dim=0, correction=0)
        d_mu = (nb.theta_[k].double() - mu64).abs() / (mu64.abs() + var64.sqrt())
        d_var = (nb.var_[k].double() - nb.epsilon_ - var64).abs() / var64
        theta_err, var_err = max(theta_err, d_mu.max().item()), max(var_err, d_var.max().item())
    if not (theta_err <= NB_BOUND and var_err <= NB_BOUND):
        raise AssertionError(f"GaussianNB: moments {theta_err:.3e} / {var_err:.3e} from float64")
    half = n // 2
    two = ht.naive_bayes.GaussianNB()
    two.partial_fit(ht.array(data[:half], split=0), ht.array(ids[:half], split=0), classes=ht.arange(c))
    two.partial_fit(ht.array(data[half:], split=0), ht.array(ids[half:], split=0))
    merge_err = max(((two.theta_ - nb.theta_).abs() / (nb.theta_.abs() + nb.var_.sqrt())).max().item(),
                    ((two.var_ - nb.var_).abs() / nb.var_).max().item())
    if not merge_err <= NB_BOUND or not torch.equal(two.class_count_, nb.class_count_):
        raise AssertionError(f"GaussianNB: partial_fit in two halves {merge_err:.3e} from fit")
    proba, proba_ms = _timed(lambda: nb.predict_proba(x))
    sum_err = (proba.larray.double().sum(1) - 1.0).abs().max().item()
    if not sum_err <= 1e-5:
        raise AssertionError(f"GaussianNB: probability rows sum to 1 within {sum_err:.3e}")
    accuracy = float((nb.predict(x).larray == ids).float().mean())
    print(f"  fit first {first_ms:.1f} ms, warm {warm_ms:.1f}; theta_ {theta_err:.2e}, var_ {var_err:.2e} from float64; "
          f"two halves {merge_err:.2e} from fit; predict_proba {proba_ms:.1f} ms, rows sum to 1 within {sum_err:.1e}; "
          f"accuracy {accuracy:.4f}", flush=True)
    return {"first_ms": first_ms, "warm_ms": warm_ms, "theta_err": theta_err, "var_err": var_err,
            "partial_fit_err": merge_err, "predict_proba_ms": proba_ms, "accuracy": accuracy}


def _lasso64(X, y, lam, sweeps):
    """θ of the reference's coordinate descent in float64 on the host, from
    the float64 Gram X'X and X'y made on the card in row blocks."""
    import numpy as np
    import torch

    n, m = X.shape
    G = X.new_zeros((m, m), dtype=torch.float64)
    cy = X.new_zeros((m,), dtype=torch.float64)
    step = max(1, EST_F64_ROWS * 64 // m)
    for r0 in range(0, n, step):
        xb = X[r0:r0 + step].double()
        G += xb.T @ xb
        cy += xb.T @ y[r0:r0 + step].double()
    G, cy = G.cpu().numpy(), cy.cpu().numpy()
    theta = np.zeros(m)
    for _ in range(sweeps):
        c = cy - G @ theta
        for j in range(m):
            rho = (c[j] + theta[j] * G[j, j]) / n
            new = rho if j == 0 else np.sign(rho) * max(abs(rho) - lam, 0.0)
            c -= (new - theta[j]) * G[j]
            theta[j] = new
    return theta


def _lasso_case(ht, label, X, y, lam, sweeps, trials=1) -> dict:
    """Fit, time and hold θ against float64 coordinate descent."""
    import numpy as np

    x, yv = ht.array(X, split=0, copy=False), ht.array(y, split=0, copy=False)
    times = []
    for _ in range(trials):
        lasso, ms = _timed(lambda: ht.regression.Lasso(lam=lam, max_iter=sweeps, tol=None).fit(x, yv))
        float(lasso.theta.larray[0, 0])
        times.append(ms)
    n, m = X.shape
    gram = m * m <= (1 << 22) and n >= m
    gram_ms = _timed(lambda: (X.T @ X, X.T @ y))[1] if gram else 0.0
    want = _lasso64(X, y, lam, sweeps)
    got = lasso.theta.larray.reshape(-1).double().cpu().numpy()
    err = float(np.abs(got - want).max())
    bound = LASSO_UNITS * 2.0**-24 * math.sqrt(n) * max(1.0, float(np.abs(want).max()))
    if lasso.n_iter != sweeps or not err <= bound:
        raise AssertionError(f"Lasso {label}: θ {err:.3e} from float64 (bound {bound:.3e}), n_iter {lasso.n_iter}")
    fit_ms = min(times)
    sweep_ms = (fit_ms - gram_ms) / sweeps
    print(f"  Lasso {label} ({n} x {m}, {'Gram' if gram else 'residual'} mode): fit {fit_ms:.1f} ms"
          f"{f' (of which X^T X and X^T y {gram_ms:.2f} ms)' if gram else ''}, {sweep_ms:.2f} ms/sweep; "
          f"θ within {err:.2e} of float64 (bound {bound:.2e}), {int(np.count_nonzero(got))} nonzero", flush=True)
    return {"fit_ms": fit_ms, "sweep_ms": sweep_ms, "gram_ms": gram_ms, "theta_err": err, "bound": bound,
            "mode": "gram" if gram else "residual"}


def lasso_phase(ht) -> dict:
    """benchmarks/lasso.py's protocol, 10⁷ x 64 in Gram mode and
    200,000 x 2,100 in residual mode, each against float64."""
    import torch

    print("phase estimators: Lasso", flush=True)
    out = {}
    n, f, lam, sweeps = LASSO_PROTOCOL
    ht.random.seed(0)
    X = ht.random.randn(n, f, split=0).larray
    y = ht.random.randn(n, split=0).larray
    out["protocol"] = _lasso_case(ht, "benchmarks/lasso.py", X, y, lam, sweeps, trials=3)
    card = torch.device("cuda", 0)
    for label, (n, m, lam, sweeps) in (("gram", LASSO_GRAM), ("residual", LASSO_RESIDUAL)):
        gen = torch.Generator(card).manual_seed(SEED + m)
        X = torch.randn(n, m, device=card, generator=gen)
        w = torch.zeros(m, device=card)
        w[: min(m, 8)] = torch.tensor([0.5, 2.0, -1.5, 0.0, 1.0, -0.7, 0.3, 1.2], device=card)[: min(m, 8)]
        y = X @ w + 0.1 * torch.randn(n, device=card, generator=gen)
        out[label] = _lasso_case(ht, label, X, y, lam, sweeps)
        del X, y
        torch.cuda.empty_cache()
    return out


def _best_accuracy(labels, truth, k) -> float:
    """Accuracy of the best matching of k clusters to k classes."""
    import itertools

    import numpy as np

    return max(float(np.mean(np.array(p)[labels] == truth)) for p in itertools.permutations(range(k)))


def examples_phase(ht) -> dict:
    """The examples' steps on the card, their lines reproduced:
    examples/cluster_demo.py's four estimators over DEMO_SEEDS draws of
    their init, knn_demo.py's five folds, lasso_demo.py's λ sweep."""
    import numpy as np

    print("phase estimators: examples/cluster_demo.py, knn_demo.py and lasso_demo.py on the card", flush=True)
    out = {}
    x, y = ht.datasets.iris_like(split=0, return_labels=True)
    truth = y.numpy()
    demo = [
        ("KMeans", lambda s: ht.cluster.KMeans(n_clusters=3, init="kmeans++", random_state=s), 0.9),
        ("KMedians", lambda s: ht.cluster.KMedians(n_clusters=3, init="kmeans++", random_state=s), 0.9),
        ("KMedoids", lambda s: ht.cluster.KMedoids(n_clusters=3, init="kmeans++", random_state=s), 0.9),
        ("Spectral", lambda s: ht.cluster.Spectral(n_clusters=3, gamma=0.5, n_lanczos=50, random_state=s), 0.85),
    ]
    for name, make, least in demo:
        accuracies = []
        for seed in range(DEMO_SEEDS):
            est = make(seed).fit(x)
            if est.labels_.larray.device.type != "cuda":
                raise AssertionError(f"cluster_demo {name}: labels off the card")
            accuracies.append(_best_accuracy(est.labels_.numpy(), truth, 3))
        met = sum(a > least for a in accuracies)
        out[name] = {"met": met, "accuracies": accuracies}
        if met < DEMO_MIN_MET:
            raise AssertionError(f"cluster_demo {name}: {met} of {DEMO_SEEDS} draws above {least}")
    X, Y = ht.datasets.iris_like(split=0, return_labels=True)
    n = X.shape[0]
    fold = n // 5
    folds = []
    for k in range(5):
        mask = np.ones(n, dtype=bool)
        mask[k * fold:(k + 1) * fold] = False
        train, test = np.nonzero(mask)[0], np.arange(k * fold, (k + 1) * fold)
        pred = ht.classification.KNeighborsClassifier(n_neighbors=5).fit(X[train], Y[train]).predict(X[test])
        folds.append(float((pred.numpy() == Y[test].numpy()).mean()))
    out["knn_folds"] = folds
    if np.mean(folds) <= 0.9:
        raise AssertionError(f"knn_demo: mean accuracy {np.mean(folds):.3f}")
    X = ht.datasets.diabetes_like(split=0)
    rng = np.random.default_rng(0)
    w = np.zeros(X.shape[1], np.float32)
    w[[1, 4, 7]] = [2.5, -1.5, 3.0]
    y_np = X.numpy() @ w + 0.05 * rng.standard_normal(X.shape[0]).astype(np.float32)
    yv = ht.array(y_np[:, None], split=0)
    X = X / ht.sqrt(ht.mean(X**2, axis=0))
    sweep = {}
    for lam in (0.001, 0.01, 0.1, 0.5, 1.0):
        est = ht.regression.Lasso(lam=lam, max_iter=200).fit(X, yv)
        coef = np.asarray(est.coef_.numpy()).ravel()
        # float64 coordinate descent for as many sweeps as the fit took
        want = _lasso64(X.larray, yv.larray.reshape(-1), lam, est.n_iter)
        err = float(np.abs(est.theta.numpy().ravel() - want).max())
        if not err <= 1e-3:
            raise AssertionError(f"lasso_demo λ={lam}: θ {err:.3e} from float64 coordinate descent")
        sweep[lam] = {"nonzero": int(np.count_nonzero(np.abs(coef) > 1e-3)), "theta_err": err, "n_iter": est.n_iter}
    out["lasso_sweep"] = sweep
    print(f"  cluster_demo draws above test_ml.py's thresholds {({k: out[k]['met'] for k, _, _ in demo})} of {DEMO_SEEDS}; "
          f"knn_demo folds {folds}; lasso_demo {sweep}", flush=True)
    return out


def estimators_mesh_phase(ht) -> dict:
    """Four shards of the card against one, through a mesh that counts its
    collectives: KMedians, KMedoids, GaussianNB, Lasso and KNN on a ragged
    table with NaN in the padding; the batch-parallel init on 8 blobs."""
    import numpy as np
    import torch

    from heat_tpu_torch.core.communication import MeshCommunication

    card = torch.device("cuda", 0)
    mesh1, mesh4 = MeshCommunication([card]), counting_mesh([card] * EST_P)
    n, f = EST_MESH_TABLE
    k = EST_K
    print(f"phase estimators: {EST_P} shards on one card against one shard, {n} x {f}", flush=True)
    data, ids, means = _blobs_on_card(n, f, k, 3.0, SEED + 47)
    x1, x4 = ht.array(data, split=0, comm=mesh1), ht.array(data, split=0, comm=mesh4)
    y1, y4 = ht.array(ids, split=0, comm=mesh1), ht.array(ids, split=0, comm=mesh4)
    if _poison_padding(x4) < 1:
        raise AssertionError("the four-shard table has no padding")
    out = {}
    for name in ("KMedians", "KMedoids"):
        cls = getattr(ht.cluster, name)
        one = cls(n_clusters=k, init=ht.array(means, comm=mesh1), max_iter=EST_ITERS).fit(x1)
        four = cls(n_clusters=k, init=ht.array(means, comm=mesh4), max_iter=EST_ITERS).fit(x4)
        _equal(f"four-shard {name} centers", four.cluster_centers_.larray, one.cluster_centers_.larray)
        _equal(f"four-shard {name} labels", four.labels_.larray, one.labels_.larray)
        if four.n_iter_ != one.n_iter_ or four.inertia_ != one.inertia_ or four.labels_.split != 0:
            raise AssertionError(f"four-shard {name}: n_iter/inertia/split differ")
    nb1 = ht.naive_bayes.GaussianNB().fit(x1, y1)
    nb4 = ht.naive_bayes.GaussianNB().fit(x4, y4)
    _equal("four-shard GaussianNB theta_", nb4.theta_, nb1.theta_)
    _equal("four-shard GaussianNB var_", nb4.var_, nb1.var_)
    _equal("four-shard GaussianNB predict", nb4.predict(x4).larray, nb1.predict(x1).larray)
    # coordinate descent wants columns of mean square 1, as lasso_demo.py makes them
    unit = data / data.square().mean(0).sqrt()
    target = unit @ torch.linspace(-1.0, 1.0, f, device=card) + 0.1
    u1, u4 = ht.array(unit, split=0, comm=mesh1), ht.array(unit, split=0, comm=mesh4)
    _poison_padding(u4)
    t1, t4 = ht.array(target, split=0, comm=mesh1), ht.array(target, split=0, comm=mesh4)
    mesh4.calls.clear()
    l4 = ht.regression.Lasso(lam=0.01, max_iter=30).fit(u4, t4)
    calls = dict(mesh4.calls)
    l1 = ht.regression.Lasso(lam=0.01, max_iter=30).fit(u1, t1)
    if calls != {"allreduce": 2}:
        raise AssertionError(f"four-shard Lasso in Gram mode: collectives {calls}")
    lasso_err = (l4.theta.larray - l1.theta.larray).abs().max().item()
    lasso_bound = LASSO_UNITS * 2.0**-24 * math.sqrt(n) * max(1.0, l1.theta.larray.abs().max().item())
    if not lasso_err <= lasso_bound or l4.n_iter != l1.n_iter:
        raise AssertionError(f"four-shard Lasso: θ {lasso_err:.3e} from one shard (bound {lasso_bound:.3e})")
    out["lasso"] = {"collectives": calls, "theta_err": lasso_err, "n_iter": l1.n_iter}
    queries = data[:: n // EST_MESH_QUERIES][:EST_MESH_QUERIES] + 0.25
    q1, q4 = ht.array(queries, split=0, comm=mesh1), ht.array(queries, split=0, comm=mesh4)
    p1 = ht.classification.KNeighborsClassifier(KNN_K).fit(x1, y1).predict(q1)
    p4 = ht.classification.KNeighborsClassifier(KNN_K).fit(x4, y4).predict(q4)
    _, exempt = _knn_vote64(data, ids, queries, KNN_K, k)
    differ = (p4.larray != p1.larray) & ~exempt
    if bool(differ.any()):
        raise AssertionError(f"four-shard KNN: {int(differ.sum())} labels differ from one shard")
    out["knn_exempt"] = int(exempt.sum())
    del x1, x4, y1, y4, data
    torch.cuda.empty_cache()
    # the batch-parallel init: one allgather of the 4·k candidates
    blobs, blob_ids, _ = _blobs_on_card(BATCHPARALLEL_ROWS, f, k, BATCHPARALLEL_SPREAD, SEED + 53)
    xb = ht.array(blobs, split=0, comm=mesh4)
    mesh4.calls.clear()
    km = ht.cluster.KMeans(n_clusters=k, init="batchparallel", random_state=SEED, max_iter=30).fit(xb)
    gathers = mesh4.calls["allgather"]
    if gathers != 1 or not _same_partition(km.labels_.larray, blob_ids):
        raise AssertionError(f"batch-parallel init: {gathers} allgathers, blobs recovered: {_same_partition(km.labels_.larray, blob_ids)}")
    out["batchparallel"] = {"allgathers": gathers, "collectives_of_fit": dict(mesh4.calls), "n_iter": km.n_iter_}
    print(f"  KMedians, KMedoids and GaussianNB equal one shard bit for bit (NaN padding); Lasso {calls} within "
          f"{lasso_err:.2e}; KNN equal ({out['knn_exempt']} near-tie queries exempt); batch-parallel init "
          f"{gathers} allgather, 8 blobs recovered", flush=True)
    return out


def estimators_path(ht, smi: str) -> dict:
    """Phase 13: the estimators on the card; returns their numbers."""
    import torch

    numbers = {"card": smi, "peak_gb": {}}
    for label, phase in (("kmedians", kmedians_phase), ("spectral", spectral_phase), ("knn", knn_phase),
                         ("gaussian_nb", gaussian_nb_phase), ("lasso", lasso_phase), ("examples", examples_phase),
                         ("mesh", estimators_mesh_phase)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        numbers[label] = phase(ht)
        numbers.setdefault("seconds", {})[label] = time.perf_counter() - t0
        numbers["peak_gb"][label] = torch.cuda.max_memory_allocated() / 1e9
    return numbers


# ---------------------------------------------------------------------------
# the rest of nn (phase 14): the README's TransformerLM trains through the
# attention kernel (B3) in float32 and bfloat16 and serves sequence-parallel
# through ring and Ulysses attention; the bfloat16 ResNet-50; parallel/.
# B3 is the only kernel on this path: heat_tpu runs the ring and Ulysses
# schedules, tensor parallelism, the pipeline and the experts on XLA, so the
# port runs them as torch ops over its in-process collectives.
LM_BATCH, LM_SEQ = 4, 4096  # the README's requests, 4 x 4096 tokens
LM_LR = 3e-4  # Adam
LM_STEPS = 5  # on one repeated batch; the warm median is over steps 2..5
LONG_SEQ = 32_768  # the README model's max_len, batch 1
MID_SEQ = 16_384  # a second reading of the long forward's error, batch 1
SP_P = 4  # ring and Ulysses shards on the one card
SP_BLOCK = 512  # Ulysses' local blockwise attention
SP_SMALL = (LM_BATCH, LM_SEQ, 12, 64)  # (B, S, H, D) against dense attention
SP_GRAD = (1, 512, 4, 64)
CNN_BF16_STEPS = 5
CNN_LOGIT_ROWS = 32  # images whose eval logits hold the bf16 ResNet-50 against f32
TP_ROWS = 4096  # tokens through the tensor-parallel MLP, the experts and the pipeline
TP_SHAPE = (768, 3072)  # GPT-2 small's MLP: dim and hidden
PP_SEQ, PP_BATCH = 512, 8
# Bounds of phase 14 (float32 with TF32 off, as main sets it):
# * the first training step through the kernel against a plain step (dense
#   attention, torch.optim.Adam) from the same weights: the forward differs
#   as phase 5's logits do (the attention summed in another order, 3xTF32
#   products), so the loss within LOGITS_RTOL relative and the gradient
#   within it normwise over all parameters; Adam's first step moves each
#   weight by lr g/(|g| + eps), about ±lr, so a gradient element within
#   rounding of 0 may take the other sign and move by 2 lr: the update
#   normwise within UPDATE_F32 of its norm (1% admits a few in 10^5 flips);
# * the same in bfloat16, against a plain bfloat16 step: each of the two
#   computes the README model within ~1% of float32 normwise (~2.3 bf16
#   ulps; 0.8-0.9% measured on the CPU at depth 2 to 12), and the two round
#   at other points (the kernel's p against its running max), so the loss
#   within one bf16 ulp (2^-8) relative, the gradient within 2^-4 normwise
#   and the update, with more sign flips at that noise, within 1/4;
# * the same model on four shards of the card against one shard, first
#   step: phase 11's MESH_TRAIN_BOUND on the loss and normwise on the
#   gradient in f32 (products over other row counts, the gradient summed
#   over the shards), the bf16 bounds above in bf16;
# * the bf16 forward against the f32 model's logits: 4 bf16 ulps, 2^-6,
#   normwise (~2.3 ulps measured on the CPU), and at least BF16_FLOOR,
#   2^-12: a model that computed in float32 and cast its outputs would
#   sit at the f32 model's rounding noise (~1e-6), one that rounds as
#   flax does at ~1e-2 (9.5e-3 measured on an H100); the bf16 ResNet-50's
#   eval logits the same (3.4e-3 on the CPU at the full width);
# * ring and Ulysses at the README's width and S = 32,768 against the
#   single-shard forward through the kernel: float32 attention in other
#   orders, where the kernel's 3xTF32 sums run over up to S keys (phase 5
#   measures 1.9e-5 over 4,096). An H100 at 700 W measured 1.095e-4 for
#   both at S = 32,768 (three runs) and 5.43e-5 for the ring at MID_SEQ,
#   linear in S. A control must fail the bound: the same forward with B3's
#   bf16 design in every layer (q, k, v rounded to bf16), 7.28e-4 on that
#   card. LONG_LOGITS_RTOL, 2.5e-4, sits between the two, 2.3 times the
#   largest sound reading and 1/2.9 of the control's. Ring against
#   Ulysses, both exact f32 einsums in other blocks, LOGITS_RTOL;
#   the kernel against its plain version at layer 0's q, k, v of that
#   forward, check_flash's bound; at (4, 4096, 12, 64) against dense
#   attention 1e-5 (the CPU tests' bound) in f32 and 0.05 in bf16; the
#   ring's gradient GRAD_TOL;
# * the bf16 ResNet-50's first loss against the f32 model's from the same
#   weights: one bf16 ulp, 2^-8 relative (1.6e-4 measured on the CPU at
#   8 filters);
# * parallel/: float32 products over other row counts (cuBLAS may pick
#   another algorithm) and sums in shard order, PARALLEL_RTOL normwise.
UPDATE_F32 = 1e-2
BF16_LOSS = 2.0**-8
BF16_GRAD = 2.0**-4
UPDATE_BF16 = 0.25
BF16_LOGITS = 2.0**-6
BF16_FLOOR = 2.0**-12
SP_SMALL_TOL = 1e-5
LONG_LOGITS_RTOL = 2.5e-4
PARALLEL_RTOL = 1e-5


def _relative(got, want) -> float:
    """||got − want||_F / ||want||_F, in float64."""
    return ((got.double() - want.double()).norm() / want.double().norm()).item()


def next_token_loss(logits, labels):
    """examples/long_context_lm.py:40-43: cross entropy of each position's
    logits against the next token."""
    import torch.nn.functional as Fn

    return Fn.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]), labels[:, 1:].reshape(-1))


def lm_step_flops(batch: int, seq: int) -> dict:
    """Floating-point operations of one training step of the README model on
    batch x seq tokens: the Dense layers' products (12 dim² per block and the
    head, 2 per multiply-add per token) and the causal attention's (4·D per
    kept (query, key) pair), each three times (forward, input and weight
    gradients; the kernel's backward recomputes its forward, which is not
    counted as needed work). LayerNorm, softmax, the loss and Adam are
    bytes, not operations, on this scale."""
    dim, depth, heads = LM["dim"], LM["depth"], LM["heads"]
    gemm = 2 * batch * seq * (depth * 12 * dim * dim + dim * LM["vocab"])
    attn = 4 * batch * heads * (seq * (seq + 1) // 2) * (dim // heads) * depth
    step = 3 * (gemm + attn)
    return {"step_tflop": step / 1e12, "fp32_bound_ms": step / F32_FLOP_PER_S * 1e3,
            "bf16_bound_ms": step / BF16_FLOP_PER_S * 1e3}


def _lm(ht, dtype, attention=True):
    """The README's TransformerLM from the seed of phase 5 (the same
    weights whatever the dtype), with the kernel in every block or dense
    attention."""
    import torch

    from heat_tpu_torch.nn.attention import flash_attention

    return ht.nn.TransformerLM(
        **LM, dtype=dtype, attention_fn=partial(flash_attention, impl="pallas") if attention else None,
        device="cuda", generator=torch.Generator(device="cuda").manual_seed(SEED),
    )


def _flat(tensors):
    import torch

    return torch.cat([t.detach().reshape(-1).double() for t in tensors])


def _checkpointed(block):
    """``block`` recomputed in the backward (torch.utils.checkpoint), so the
    plain step's dense attention keeps one layer's S x S scores at a time."""
    import torch

    class Checkpointed(torch.nn.Module):
        def __init__(self, inner):
            super().__init__()
            self.inner = inner

        def forward(self, x):
            return torch.utils.checkpoint.checkpoint(self.inner, x, use_reentrant=False)

    return Checkpointed(block)


def plain_lm_step(ht, dtype, tokens) -> dict:
    """One plain PyTorch step: dense attention, the next-token loss and a bare
    torch.optim.Adam loop (optax's adam: the same rule). Returns the loss,
    the gradient and the parameters after the step, flat in float64."""
    import torch

    model = _lm(ht, dtype, attention=False)
    start = _flat(model.parameters())
    for i, block in enumerate(model.blocks):
        model.blocks[i] = _checkpointed(block)
    opt = torch.optim.Adam(model.parameters(), lr=LM_LR, betas=(0.9, 0.999), eps=1e-8)
    loss = next_token_loss(model(tokens), tokens)
    loss.backward()
    grads = _flat(p.grad for p in model.parameters())
    opt.step()
    out = {"loss": loss.item(), "grad": grads, "update": _flat(model.parameters()) - start}
    del model, opt, loss
    torch.cuda.empty_cache()
    return out


def lm_training_phase(ht, dtype, tokens, flops) -> tuple:
    """(a) The README model under DataParallel with Adam through the kernel:
    the first step against a plain step, LM_STEPS on a repeated batch, the
    warm median, the peak, a profiled step. Returns its numbers and the
    trained module."""
    import torch

    from heat_tpu_torch.core.communication import MeshCommunication
    from heat_tpu_torch.ops import flash

    name = "f32" if dtype == torch.float32 else "bf16"
    bounds = ((LOGITS_RTOL, LOGITS_RTOL, UPDATE_F32) if dtype == torch.float32
              else (BF16_LOSS, BF16_GRAD, UPDATE_BF16))
    print(f"phase nn: the README's TransformerLM trains in {name} under DataParallel, Adam({LM_LR}), "
          f"{LM_BATCH} x {LM_SEQ} tokens, the next-token loss, attention through the kernel", flush=True)
    plain = plain_lm_step(ht, dtype, tokens)
    model = _lm(ht, dtype)
    start = _flat(model.parameters())
    forward_launches = []

    def loss_fn(logits, labels):
        # the loss is taken between the forward and the backward: the count
        # so far is the forward's, and from 0 again it is the backward's
        forward_launches.append(flash.LAUNCHES)
        flash.LAUNCHES = 0
        return next_token_loss(logits, labels)

    dp = ht.nn.DataParallel(model, comm=MeshCommunication([torch.device("cuda", 0)]),
                            optimizer=ht.optim.Adam(LM_LR), loss_fn=loss_fn)
    dp.init(SEED, tokens[:1])
    torch.cuda.reset_peak_memory_stats()
    losses = []
    flash.LAUNCHES = 0
    out = {"first_step_ms": _time_step(lambda: losses.append(dp.train_step(tokens, tokens)))}
    out["launches_forward"], out["launches_backward"] = forward_launches[0], flash.LAUNCHES
    out["launches_per_step"] = out["launches_forward"] + out["launches_backward"]
    first_grad = _flat(p.grad for p in model.parameters())
    out["loss_vs_plain"] = abs(losses[0] - plain["loss"]) / abs(plain["loss"])
    out["grad_vs_plain"] = _relative(first_grad, plain["grad"])
    out["update_vs_plain"] = _relative(_flat(model.parameters()) - start, plain["update"])
    del plain, start
    print(f"  first step {out['first_step_ms']:.1f} ms, {out['launches_forward']} kernel launches in its forward, "
          f"{out['launches_backward']} in its backward; against a "
          f"plain step: loss {out['loss_vs_plain']:.3e} (bound {bounds[0]:g}), gradient "
          f"{out['grad_vs_plain']:.3e} normwise (bound {bounds[1]:g}), update {out['update_vs_plain']:.3e} "
          f"(bound {bounds[2]:g})", flush=True)
    if out["launches_forward"] != LM["depth"] or out["launches_backward"] != 0:
        raise AssertionError(f"a training step launched the kernel {out['launches_forward']} times in its "
                             f"forward and {out['launches_backward']} in its backward, not {LM['depth']} and 0")
    if not (out["loss_vs_plain"] <= bounds[0] and out["grad_vs_plain"] <= bounds[1]
            and out["update_vs_plain"] <= bounds[2]):
        raise AssertionError(f"the {name} training step disagrees with a plain PyTorch step")
    times = [_time_step(lambda: losses.append(dp.train_step(tokens, tokens))) for _ in range(LM_STEPS - 1)]
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["ms"] = sorted(times)[len(times) // 2]
    out["tokens_per_s"] = LM_BATCH * LM_SEQ / out["ms"] * 1e3
    out["losses"] = losses
    bound = flops["fp32_bound_ms"] if dtype == torch.float32 else flops["bf16_bound_ms"]
    print(f"  warm median of {LM_STEPS - 1} steps: {out['ms']:.2f} ms, {out['tokens_per_s']:.1f} tokens/s "
          f"(bound {bound:.2f} ms: {flops['step_tflop']:.2f} TFLOP at "
          f"{'67 TFLOP/s f32' if dtype == torch.float32 else '989 TFLOP/s bf16'}); peak {out['peak_gb']:.2f} GB; "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f} over {LM_STEPS} steps", flush=True)
    if not (all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"the {name} loss does not fall on one repeated batch: {losses}")
    out["profile"] = profile_lm_step(lambda: dp.train_step(tokens, tokens))
    del dp
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    out["four_shards"] = four_shard_lm_step(ht, dtype, tokens, losses[0], first_grad)
    return out, model


def four_shard_lm_step(ht, dtype, tokens, first_loss, first_grad) -> dict:
    """The same model from the same weights under DataParallel on four
    shards of the card: its first step against one shard's, the kernel's
    launches (12 per replica) and the collectives counted."""
    import torch

    from heat_tpu_torch.ops import flash

    mesh = counting_mesh([torch.device("cuda", 0)] * TRAIN_P)
    model = _lm(ht, dtype)
    dp = ht.nn.DataParallel(model, comm=mesh, optimizer=ht.optim.Adam(LM_LR), loss_fn=next_token_loss)
    dp.init(SEED, tokens[:1])
    mesh.calls.clear()
    flash.LAUNCHES = 0
    loss = dp.train_step(tokens, tokens)
    out = {"launches": flash.LAUNCHES, "collectives": dict(mesh.calls),
           "loss_vs_one_shard": abs(loss - first_loss) / abs(first_loss),
           "grad_vs_one_shard": _relative(_flat(p.grad for p in model.parameters()), first_grad)}
    del dp, model
    torch.cuda.empty_cache()
    loss_bound, grad_bound = (MESH_TRAIN_BOUND, MESH_TRAIN_BOUND) if dtype == torch.float32 else (BF16_LOSS, BF16_GRAD)
    print(f"  {TRAIN_P} shards of the card against one: first loss {out['loss_vs_one_shard']:.3e} (bound "
          f"{loss_bound:g}), gradient {out['grad_vs_one_shard']:.3e} normwise (bound {grad_bound:g}); "
          f"{out['launches']} kernel launches, collectives {out['collectives']}", flush=True)
    if out["launches"] != min(TRAIN_P, len(tokens)) * LM["depth"] or out["collectives"] != {"allreduce": 1}:
        raise AssertionError(f"the four-shard step launched {out['launches']} kernels, {out['collectives']}")
    if not (out["loss_vs_one_shard"] <= loss_bound and out["grad_vs_one_shard"] <= grad_bound):
        raise AssertionError("the four-shard training step disagrees with one shard's")
    return out


def profile_lm_step(step) -> dict:
    """profile_step, with the device time under the kernel's backward range
    (the scan path's recompute and backward) called out."""
    from heat_tpu_torch.nn.attention import BACKWARD_RANGE

    out = profile_step(step, ranges=(BACKWARD_RANGE,))
    scan = out["ranges_ms"][BACKWARD_RANGE]
    out["scan_backward_share"] = scan / out["busy_ms"] if out["busy_ms"] else 0.0
    print(f"    {scan:9.3f} ms  of it under the kernel's backward (the scan path, recompute included): "
          f"{100 * out['scan_backward_share']:.1f}% of the busy time", flush=True)
    return out


def lm_bf16_forward_phase(ht) -> dict:
    """(b) The README forward in bf16 on phase 5's three requests; logits
    against the f32 model's; B3 bf16 at layer 0's q, k, v beside
    scaled_dot_product_attention on the same inputs."""
    import torch
    import torch.nn.functional as Fn

    from heat_tpu_torch.nn.attention import flash_attention
    from heat_tpu_torch.ops import flash

    print(f"phase nn: the README's TransformerLM forward in bf16, {REQUESTS} requests of {BATCH} x {SEQ} tokens",
          flush=True)
    requests = [
        torch.randint(0, LM["vocab"], (BATCH, SEQ), device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(SEED + i))
        for i in range(REQUESTS)
    ]
    out = {}
    with torch.inference_mode():
        reference = _lm(ht, torch.float32)(requests[0])
        model = _lm(ht, torch.bfloat16)
        torch.cuda.synchronize()
        flash.LAUNCHES = 0
        times, logits = [], None
        for tokens in requests:
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            result = model(tokens)
            stop.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(stop))
            if not (result.dtype == torch.float32 and torch.isfinite(result).all()):
                raise AssertionError("the bf16 forward gave logits that are not finite float32")
            logits = result if logits is None else logits
            del result
        out["launches"] = flash.LAUNCHES
        out["forward_ms_first"] = times[0]
        out["forward_ms_warm"] = sorted(times[1:])[len(times[1:]) // 2]
        out["logits_vs_f32"] = _relative(logits, reference)
        del logits, reference
        print(f"  {out['launches']} kernel launches; forward {out['forward_ms_first']:.3f} ms first, "
              f"{out['forward_ms_warm']:.3f} ms warm (f32 114.2 ms, PERF.md §5); logits against the f32 "
              f"model's {out['logits_vs_f32']:.3e} normwise (bounds {BF16_FLOOR:g} and {BF16_LOGITS:g})", flush=True)
        if out["launches"] != LM["depth"] * REQUESTS:
            raise AssertionError(f"the bf16 forwards launched the kernel {out['launches']} times")
        if not BF16_FLOOR <= out["logits_vs_f32"] <= BF16_LOGITS:
            raise AssertionError("the bf16 forward's logits are not as far from the f32 model's as bf16 "
                                 "rounding puts them")
        captured = []

        def capture(q, k, v, causal):
            captured.append((q, k, v))
            return flash_attention(q, k, v, causal=causal, impl="pallas")

        model.blocks[0].attn.attention_fn = capture
        model(requests[0])
        q, k, v = captured[0]
        del model, captured
        torch.cuda.empty_cache()
        kernel = check_flash("bf16 main path layer 0 inputs", q, k, v, True, reps=5)
        out["kernel_ms"], out["kernel_bound_ms"] = kernel["ms"], kernel["bound_ms"]
        out["kernel_max_abs_err"] = kernel["max_abs_err"]
        out["plain_ms"] = _time_ms(lambda: flash.flash_attention_plain(q, k, v, causal=True), 3)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        scale = 1.0 / math.sqrt(q.shape[-1])
        out["library_ms"] = _time_ms(
            lambda: Fn.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=scale), 5)
    print(f"  kernel (mma_bf16) {out['kernel_ms']:.4f} ms per launch at {tuple(q.shape)} causal bf16, bound "
          f"{out['kernel_bound_ms']:.4f} ms; plain {out['plain_ms']:.4f} ms; scaled_dot_product_attention "
          f"{out['library_ms']:.4f} ms on the same bf16 q, k, v", flush=True)
    return out


def sequence_parallel_phase(ht, trained) -> dict:
    """(c) Ring and Ulysses over four shards of the card: the README model at
    max_len with the trained parameters against its single-shard forward
    through the kernel; both schedules against dense attention at
    SP_SMALL; the ring's gradient."""
    import torch

    from heat_tpu_torch.nn.attention import (
        dot_product_attention,
        flash_attention,
        ring_attention,
        ulysses_attention,
    )
    from heat_tpu_torch.ops import flash

    card = torch.device("cuda", 0)
    out = {}
    print(f"phase nn: ring and Ulysses attention on {SP_P} shards of the card against dense at {SP_SMALL}",
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    mesh = counting_mesh([card] * SP_P)
    q, k, v = (torch.randn(SP_SMALL, generator=gen, device="cuda") for _ in range(3))
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (False, True):
            qd, kd, vd = (t.to(dtype) for t in (q, k, v))
            dense = dot_product_attention(qd.float(), kd.float(), vd.float(), causal=causal)
            for name, fn in (("ring", ring_attention), ("ulysses", ulysses_attention)):
                got = fn(qd, kd, vd, causal=causal, comm=mesh)
                err = (got.float() - dense).abs().max().item()
                label = f"{name}_{'f32' if dtype == torch.float32 else 'bf16'}_{'causal' if causal else 'full'}"
                out[label] = err
                tol = SP_SMALL_TOL * (1 + dense.abs().max().item()) if dtype == torch.float32 else BF16_VS_DENSE
                if got.dtype != dtype or not err <= tol:
                    raise AssertionError(f"{label}: max|d| {err:.3e} against dense (bound {tol:.3e})")
            del dense
    print(f"  max|d| against dense attention: {json.dumps(out)}", flush=True)
    grads = []
    small = [t[: SP_GRAD[0], : SP_GRAD[1], : SP_GRAD[2]].contiguous() for t in (q, k, v)]
    for fn in (partial(ring_attention, comm=mesh), dot_product_attention):
        leaves = [t.clone().requires_grad_() for t in small]
        (fn(*leaves, causal=True) ** 2).sum().backward()
        grads.append([t.grad for t in leaves])
    out["ring_grad_max_abs"] = max((a - b).abs().max().item() for a, b in zip(*grads))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=GRAD_TOL, atol=GRAD_TOL)
    print(f"  the ring's gradient at {SP_GRAD} causal against dense: max|d| {out['ring_grad_max_abs']:.3e}",
          flush=True)
    del q, k, v, small, grads
    torch.cuda.empty_cache()

    print(f"phase nn: the README's TransformerLM (trained in f32) at batch 1, S = {LONG_SEQ}: ring and Ulysses "
          f"(block_size={SP_BLOCK}) on {SP_P} shards of the card against one shard through the kernel", flush=True)
    tokens = torch.randint(0, LM["vocab"], (1, LONG_SEQ), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(SEED + 15))
    forwards = {
        "kernel": partial(flash_attention, impl="pallas"),
        "ring": partial(ring_attention, comm=mesh),
        "ulysses": partial(ulysses_attention, comm=mesh, block_size=SP_BLOCK),
    }
    logits, captured = {}, []

    def capture(q, k, v, causal):
        captured.append((q, k, v))
        return forwards["kernel"](q, k, v, causal=causal)

    def bf16_kernel(q, k, v, causal):
        """The control: B3's bf16 design on q, k, v rounded to bf16."""
        return flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), causal=causal, impl="pallas").to(q.dtype)

    def attend(fn):
        for block in trained.blocks:
            block.attn.attention_fn = fn

    with torch.inference_mode():
        for name, fn in forwards.items():
            attend(fn)
            if name == "kernel":
                trained.blocks[0].attn.attention_fn = capture
            mesh.calls.clear()
            flash.LAUNCHES = 0
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            ms = _time_step(lambda: logits.__setitem__(name, trained(tokens)))
            out[f"{name}_forward_ms"] = ms
            out[f"{name}_peak_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
            out[f"{name}_collectives"] = dict(mesh.calls)
            out[f"{name}_kernel_launches"] = flash.LAUNCHES
            if not torch.isfinite(logits[name]).all():
                raise AssertionError(f"the {name} forward at S = {LONG_SEQ} is not finite")
            if name != "kernel":
                out[f"{name}_vs_kernel"] = _relative(logits[name], logits["kernel"])
            print(f"  {name}: {ms:.1f} ms, peak {out[f'{name}_peak_gb']:.2f} GB above the model, collectives "
                  f"{out[f'{name}_collectives']}, kernel launches {flash.LAUNCHES}"
                  + (f", logits against one shard {out[f'{name}_vs_kernel']:.3e} normwise (bound "
                     f"{LONG_LOGITS_RTOL:g})" if name != "kernel" else ""), flush=True)
        out["ring_vs_ulysses"] = _relative(logits["ring"], logits["ulysses"])
        del logits["ring"], logits["ulysses"]
        torch.cuda.empty_cache()
        attend(bf16_kernel)
        out["control_bf16_attention_vs_kernel"] = _relative(trained(tokens), logits["kernel"])
        del logits
        torch.cuda.empty_cache()
        mid = {}
        for name in ("kernel", "ring"):
            attend(forwards[name])
            mid[name] = trained(tokens[:, :MID_SEQ])
        out["ring_vs_kernel_mid"] = _relative(mid["ring"], mid["kernel"])
        attend(forwards["kernel"])
        del mid
        torch.cuda.empty_cache()
        print(f"  ring against Ulysses {out['ring_vs_ulysses']:.3e} normwise (bound {LOGITS_RTOL:g}); the ring "
              f"against one shard at S = {MID_SEQ} {out['ring_vs_kernel_mid']:.3e} (bound {LONG_LOGITS_RTOL:g}); "
              f"the control, B3's bf16 design in every layer at S = {LONG_SEQ}, "
              f"{out['control_bf16_attention_vs_kernel']:.3e} (must exceed {LONG_LOGITS_RTOL:g})", flush=True)
        out["kernel_at_long_shape"] = check_flash("long forward layer 0 inputs", *captured[0], True, reps=1)
    del captured
    torch.cuda.empty_cache()
    if out["kernel_kernel_launches"] != LM["depth"]:
        raise AssertionError("the single-shard long forward did not launch the kernel once per block")
    if out["ring_collectives"] != {"ppermute": 2 * (SP_P - 1) * LM["depth"]}:
        raise AssertionError(f"the ring issued {out['ring_collectives']}")
    if out["ulysses_collectives"] != {"alltoall": 4 * LM["depth"]}:
        raise AssertionError(f"Ulysses issued {out['ulysses_collectives']}")
    if not (out["ring_vs_kernel"] <= LONG_LOGITS_RTOL and out["ulysses_vs_kernel"] <= LONG_LOGITS_RTOL
            and out["ring_vs_ulysses"] <= LOGITS_RTOL and out["ring_vs_kernel_mid"] <= LONG_LOGITS_RTOL):
        raise AssertionError("a sequence-parallel forward disagrees with the single-shard forward")
    if not out["control_bf16_attention_vs_kernel"] > LONG_LOGITS_RTOL:
        raise AssertionError("the long forward's bound admits bf16 attention: it cannot tell a wrong forward")
    return out


def cnn_bf16_phase(ht) -> dict:
    """(d) One bf16 ResNet-50 step under DataParallel at BASELINE config 5's
    batch, its first loss against the f32 model's from the same weights,
    and the warm step time."""
    import torch

    from heat_tpu_torch.core.communication import MeshCommunication

    print(f"phase nn: ResNet50(num_classes={TRAIN_CLASSES}, dtype=bfloat16) under DataParallel, SGD({TRAIN_LR}), "
          f"batch {TRAIN_BATCH}", flush=True)
    x, y = _cifar(TRAIN_BATCH, SEED + 11)
    card = MeshCommunication([torch.device("cuda", 0)])
    losses, logits = {}, {}
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = ht.nn.ResNet50(num_classes=TRAIN_CLASSES, dtype=dtype,
                               generator=torch.Generator("cuda").manual_seed(SEED))
        dp = ht.nn.DataParallel(model, comm=card, optimizer=ht.optim.SGD(TRAIN_LR)).init(SEED, x[:2])
        with torch.no_grad():
            logits[dtype] = dp(x[:CNN_LOGIT_ROWS]).double()
        losses[dtype] = [dp.train_step(x, y)]
        if dtype == torch.bfloat16:
            times = [_time_step(lambda: losses[dtype].append(dp.train_step(x, y))) for _ in range(CNN_BF16_STEPS)]
            out["ms"] = sorted(times)[len(times) // 2]
            out["samples_per_s"] = TRAIN_BATCH / out["ms"] * 1e3
        del dp, model
        torch.cuda.empty_cache()
    first32, first16 = losses[torch.float32][0], losses[torch.bfloat16][0]
    out["loss_f32"], out["loss_bf16"] = first32, first16
    out["loss_vs_f32"] = abs(first16 - first32) / abs(first32)
    out["losses"] = losses[torch.bfloat16]
    out["logits_vs_f32"] = _relative(logits[torch.bfloat16], logits[torch.float32])
    print(f"  first loss {first16:.5f} against the f32 model's {first32:.5f}: {out['loss_vs_f32']:.3e} (bound "
          f"{BF16_LOSS:g}); warm median of {CNN_BF16_STEPS} steps {out['ms']:.2f} ms, "
          f"{out['samples_per_s']:.1f} samples/s (f32 106.19 ms, PERF.md §5); eval logits of {CNN_LOGIT_ROWS} "
          f"images against the f32 model's {out['logits_vs_f32']:.3e} normwise (bounds {BF16_FLOOR:g} and "
          f"{BF16_LOGITS:g})", flush=True)
    if not (out["loss_vs_f32"] <= BF16_LOSS and all(math.isfinite(v) for v in out["losses"])
            and BF16_FLOOR <= out["logits_vs_f32"] <= BF16_LOGITS):
        raise AssertionError("the bf16 ResNet-50 step disagrees with the f32 model's")
    return out


def parallel_phase(ht) -> dict:
    """(e) parallel/ on four shards of the card at cut sizes: the Megatron
    pair, a dp x tp step, the GPipe schedule and the experts, each against
    its dense oracle, with the collectives counted."""
    import torch
    from torch.func import functional_call

    from heat_tpu_torch import parallel

    card = torch.device("cuda", 0)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
    dim, hidden = TP_SHAPE
    x = torch.randn(TP_ROWS, dim, generator=gen, device="cuda")
    out = {}
    print(f"phase nn: parallel/ on {SP_P} shards of the card", flush=True)

    mesh = counting_mesh([card] * SP_P)
    tp = parallel.TPMLPBlock(hidden, dim, dim, comm=mesh, generator=torch.Generator("cuda").manual_seed(SEED))
    dense = parallel.TPMLPBlock(hidden, dim, dim, generator=torch.Generator("cuda").manual_seed(SEED))
    with torch.no_grad():
        got = tp(x)
        out["tp_collectives"] = dict(mesh.calls)
        out["tp_vs_dense"] = _relative(got, dense(x))
    if out["tp_collectives"] != {"allreduce": 1} or not out["tp_vs_dense"] <= PARALLEL_RTOL:
        raise AssertionError(f"TPMLPBlock on {SP_P} shards: {out['tp_collectives']}, {out['tp_vs_dense']:.3e}")

    grid = parallel.make_mesh([("dp", 2), ("tp", 2)], devices=[card] * 4)
    block = parallel.TPMLPBlock(hidden, dim, dim, comm=grid, generator=torch.Generator("cuda").manual_seed(SEED))
    oracle = parallel.TPMLPBlock(hidden, dim, dim, generator=torch.Generator("cuda").manual_seed(SEED))
    target = torch.randn(TP_ROWS, dim, generator=gen, device="cuda")
    ((block(x) - target) ** 2).mean().backward()
    ((oracle(x) - target) ** 2).mean().backward()
    pairs = [(torch.cat([k.grad for k in block.up.kernel], 1), oracle.up.kernel[0].grad),
             (torch.cat([k.grad for k in block.down.kernel], 0), oracle.down.kernel[0].grad),
             (torch.cat([b.grad for b in block.up.bias]), oracle.up.bias[0].grad),
             (block.down.bias.grad, oracle.down.bias.grad)]
    out["dp_tp_grad_vs_dense"] = max(_relative(a, b) for a, b in pairs)
    if not out["dp_tp_grad_vs_dense"] <= PARALLEL_RTOL or len(block.up.kernel) != 2:
        raise AssertionError(f"the dp x tp step's gradient: {out['dp_tp_grad_vs_dense']:.3e}")

    mesh = counting_mesh([card] * SP_P)
    blocks = [ht.nn.TransformerBlock(dim, heads=LM["heads"], generator=torch.Generator("cuda").manual_seed(SEED + s))
              for s in range(SP_P)]
    acts = torch.randn(PP_BATCH, PP_SEQ, dim, generator=gen, device="cuda")
    with torch.no_grad():
        stacked = parallel.pipeline_stage_params([dict(b.named_parameters()) for b in blocks])
        got = parallel.pipeline_apply(lambda p, a: functional_call(blocks[0], p, (a,)), stacked, acts, mesh)
        want = acts
        for b in blocks:
            want = b(want)
        out["pipeline_collectives"] = dict(mesh.calls)
        out["pipeline_vs_sequential"] = _relative(got, want)
    if (out["pipeline_collectives"] != {"ppermute": 2 * SP_P - 1, "bcast": 1}
            or not out["pipeline_vs_sequential"] <= PARALLEL_RTOL):
        raise AssertionError(f"pipeline_apply: {out['pipeline_collectives']}, {out['pipeline_vs_sequential']:.3e}")

    mesh = counting_mesh([card] * SP_P)
    moe = parallel.MoELayer(SP_P, hidden, dim, generator=torch.Generator("cuda").manual_seed(SEED))
    with torch.no_grad():
        got = moe(x, mesh=mesh)
        out["moe_collectives"] = dict(mesh.calls)
        out["moe_vs_dense"] = _relative(got, moe(x))
    if out["moe_collectives"] != {"alltoall": 2} or not out["moe_vs_dense"] <= PARALLEL_RTOL:
        raise AssertionError(f"moe_apply: {out['moe_collectives']}, {out['moe_vs_dense']:.3e}")
    print(f"  {json.dumps(out)}", flush=True)
    return out


def nn_path(ht, smi: str) -> dict:
    """Phase 14: the rest of nn on the card; returns its numbers."""
    import torch

    numbers = {"card": smi, "seconds": {}}
    tokens = torch.randint(0, LM["vocab"], (LM_BATCH, LM_SEQ), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(SEED + 14))
    numbers["flops"] = lm_step_flops(LM_BATCH, LM_SEQ)
    t0 = time.perf_counter()
    numbers["train_f32"], trained = lm_training_phase(ht, torch.float32, tokens, numbers["flops"])
    numbers["train_bf16"], _ = lm_training_phase(ht, torch.bfloat16, tokens, numbers["flops"])
    numbers["seconds"]["training"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    for label, phase in (("forward_bf16", lm_bf16_forward_phase),
                         ("sequence_parallel", lambda ht: sequence_parallel_phase(ht, trained)),
                         ("resnet50_bf16", cnn_bf16_phase), ("parallel", parallel_phase)):
        t0 = time.perf_counter()
        numbers[label] = phase(ht)
        numbers["seconds"][label] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    return numbers


# ---------------------------------------------------------------------------
# I/O and checkpointing (phase 15): no kernel of its own. BASELINE config 3's
# table goes to disk and back in every format whose library imports, then
# from disk into KMeans.fit through the Lloyd kernel; the trainers (and the
# README's TransformerLM through the flash kernel) save, restore and step;
# convolve runs over halos.
# ---------------------------------------------------------------------------
IO_P = 4  # shards of the card for the mesh checks
CSV_TRIAL_ROWS = 1_000_000  # the CSV cut, kept when the whole table would take longer than CSV_BUDGET_S
CSV_BUDGET_S = 20.0
CKPT_BATCH = 256  # BASELINE config 5's batch for ResNet-50 and DASO
CONV_N, CONV_TAPS = 100_000_000, 9
# Bounds of phase 15: the formats, the disk-loaded fit, the restored states
# and (where the card repeats a step bit for bit) the next step are exact.
# Where two steps from the restored state differ, the next step is held to
# RUN_TO_RUN_FACTOR times that difference (relative to the largest value),
# named in the output. convolve against float64 on the card: each output
# is a sum of k products, every one rounded once and added in k - 1
# roundings, so |d| <= (k + 1) u Σ_j |v_j x_{i-j}| (u = 2^-24).
RUN_TO_RUN_FACTOR = 4.0


def io_environment(ht, tmp: str) -> dict:
    """What the machine offers the I/O layer, printed before anything is
    written: the optional libraries, the compiler of the CSV codec and the
    free space where the files go."""
    from heat_tpu_torch import _native
    from heat_tpu_torch.ops import _build

    gxx = subprocess.run([_build.gxx(), "--version"], capture_output=True, text=True, timeout=60).stdout.splitlines()[0]
    env = {
        "supports_hdf5": ht.supports_hdf5(), "supports_netcdf": ht.supports_netcdf(), "gxx": gxx,
        "free_gb": shutil.disk_usage(tmp).free / 1e9, "directory": tmp,
    }
    t0 = time.perf_counter()
    if not _native.native_available():
        raise AssertionError("the native CSV codec is not available: no g++ or HEAT_TPU_NO_NATIVE is set")
    env["codec_build_s"] = time.perf_counter() - t0
    print(f"phase io: h5py imports: {env['supports_hdf5']}; netCDF: {env['supports_netcdf']} (classic "
          f"netCDF3 through scipy); g++: {gxx}; {env['free_gb']:.1f} GB free in {tmp}; the CSV codec built "
          f"into heat_tpu_torch/_build in {env['codec_build_s']:.1f} s", flush=True)
    return env


def _file_bytes(path: str) -> int:
    if os.path.isdir(path):
        return sum(os.path.getsize(os.path.join(root, n)) for root, _, names in os.walk(path) for n in names)
    return os.path.getsize(path)


def _round_trip(ht, fmt: str, x, tmp: str) -> dict:
    """Save ``x`` in one format and load it at split 0 and split None; each
    load must equal ``x`` bit for bit. Host clock, a device sync at each
    end."""
    import torch

    path = os.path.join(tmp, f"table.{fmt}")
    save, load = {
        "npy": (lambda: ht.save_npy(x, path), lambda s: ht.load_npy(path, split=s)),
        "h5": (lambda: ht.save_hdf5(x, path, "data"), lambda s: ht.load_hdf5(path, "data", split=s)),
        "nc": (lambda: ht.save_netcdf(x, path, "data", format="NETCDF3_64BIT"),
               lambda s: ht.load_netcdf(path, "data", split=s)),
        "csv": (lambda: ht.save_csv(x, path), lambda s: ht.load_csv(path, split=s)),
    }[fmt]
    out = {"rows": x.gshape[0], "save_s": _time_step(save) / 1e3, "file_bytes": _file_bytes(path)}
    for split in (0, None):
        box = []
        out[f"load_s_split_{split}"] = _time_step(lambda: box.append(load(split))) / 1e3
        got = box[0]
        if not (got.gshape == x.gshape and got.split == split and got.larray.device.type == "cuda"
                and torch.equal(got.larray, x.larray)):
            raise AssertionError(f"{fmt}: the table loaded at split={split} is not the saved one bit for bit")
        del box, got
    os.remove(path)
    return out


def formats_phase(ht, x, tmp: str, env: dict) -> dict:
    """(1) The table in every format that imports, bit for bit, with save
    and load GB/s beside np.save/np.load of the same host bytes."""
    import numpy as np

    from heat_tpu_torch import _native

    table_gb = x.nbytes / 1e9
    print(f"phase io: BASELINE config 3's table, {x.gshape[0]} x {x.gshape[1]} float32 ({table_gb:.3f} GB), "
          "split=0, saved and loaded in each format; reads may come from the page cache", flush=True)
    out = {}
    host = x.larray.cpu().numpy()
    yard = os.path.join(tmp, "yardstick.npy")
    t0 = time.perf_counter()
    np.save(yard, host)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    np.load(yard)
    load_s = time.perf_counter() - t0
    os.remove(yard)
    del host
    out["np"] = {"save_gb_per_s": table_gb / save_s, "load_gb_per_s": table_gb / load_s}
    print(f"  np.save {out['np']['save_gb_per_s']:.2f} GB/s, np.load {out['np']['load_gb_per_s']:.2f} GB/s "
          "(the same host bytes, the yardstick)", flush=True)
    formats = ["npy", "h5", "nc", "csv"]
    if not env["supports_hdf5"]:
        print("  h5: skipped, h5py does not import on this machine", flush=True)
        formats.remove("h5")
    calls = dict(_native.CALLS)
    for fmt in formats:
        if fmt == "csv":
            trial = _round_trip(ht, "csv", x[:CSV_TRIAL_ROWS], tmp)
            seconds = trial["save_s"] + trial["load_s_split_0"] + trial["load_s_split_None"]
            projected = seconds * x.gshape[0] / CSV_TRIAL_ROWS
            fits = 2.5 * trial["file_bytes"] * x.gshape[0] / CSV_TRIAL_ROWS < env["free_gb"] * 1e9
            if projected > CSV_BUDGET_S or not fits:
                print(f"  csv: cut to {CSV_TRIAL_ROWS} rows: the whole table would take ~{projected:.1f} s "
                      f"(budget {CSV_BUDGET_S:g} s) or more disk than is free", flush=True)
                r = trial
            else:
                r = _round_trip(ht, "csv", x, tmp)
        else:
            r = _round_trip(ht, fmt, x, tmp)
        gb = table_gb * r["rows"] / x.gshape[0]
        r.update({"save_gb_per_s": gb / r["save_s"], "load_gb_per_s": gb / r["load_s_split_0"],
                  "load_gb_per_s_replicated": gb / r["load_s_split_None"]})
        out[fmt] = r
        print(f"  {fmt}: {r['rows']} rows, file {r['file_bytes'] / 1e9:.3f} GB; save {r['save_gb_per_s']:.2f} GB/s, "
              f"load {r['load_gb_per_s']:.2f} GB/s (split 0), {r['load_gb_per_s_replicated']:.2f} GB/s "
              "(split None); both loads equal the table bit for bit", flush=True)
    out["csv_codec_calls"] = {k: _native.CALLS[k] - calls[k] for k in calls}
    if not (out["csv_codec_calls"]["csv_write"] >= 1 and out["csv_codec_calls"]["csv_parse"] >= 2):
        raise AssertionError(f"the CSV round trip did not go through the native codec: {out['csv_codec_calls']}")
    print(f"  native CSV codec calls: {out['csv_codec_calls']}", flush=True)
    return out


def disk_fit_phase(ht, x, init, tmp: str, env: dict) -> dict:
    """(2) KMeans from the disk: the .npy (and .h5) table at split=0 through
    the Lloyd kernel, equal bit for bit to the fit on the in-memory table;
    then four shards of the card save and load against one."""
    import torch

    from heat_tpu_torch.core.communication import MeshCommunication
    from heat_tpu_torch.ops import lloyd

    print(f"phase io: KMeans(n_clusters={K}) for {ITERS} iterations from phase 3's centres on the table "
          "read from disk, against the fit on the in-memory table", flush=True)
    KMeans = ht.cluster.KMeans
    memory = KMeans(n_clusters=K, init=init, max_iter=ITERS, tol=-1.0).fit(x)
    out = {}
    paths = {"npy": os.path.join(tmp, "fit.npy")}
    ht.save_npy(x, paths["npy"])
    if env["supports_hdf5"]:
        paths["h5"] = os.path.join(tmp, "fit.h5")
        ht.save_hdf5(x, paths["h5"], "data")
    for fmt, path in paths.items():
        loaded = ht.load_npy(path, split=0) if fmt == "npy" else ht.load_hdf5(path, "data", split=0)
        lloyd.LAUNCHES = 0
        fit = KMeans(n_clusters=K, init=init, max_iter=ITERS, tol=-1.0).fit(loaded)
        torch.cuda.synchronize()
        launches = lloyd.LAUNCHES
        same = (torch.equal(fit.cluster_centers_.larray, memory.cluster_centers_.larray)
                and torch.equal(fit.labels_.larray, memory.labels_.larray) and fit.inertia_ == memory.inertia_)
        out[fmt] = {"launches": launches, "equal": same, "inertia": fit.inertia_}
        print(f"  {fmt}: {launches} Lloyd kernel launches; centres, labels and inertia "
              f"({fit.inertia_:.9e}) equal to the in-memory fit bit for bit: {same}", flush=True)
        if launches != ITERS or not same:
            raise AssertionError(f"the fit on the {fmt} table differs from the in-memory fit or missed the kernel")
        del loaded, fit
        os.remove(path)
    card = torch.device("cuda", 0)
    mesh = MeshCommunication([card] * IO_P)
    x4 = ht.array(x.larray, split=0, comm=mesh)
    four, one = os.path.join(tmp, "four.npy"), os.path.join(tmp, "one.npy")
    ht.save_npy(x4, four)
    ht.save_npy(x, one)
    into_one = ht.load_npy(four, split=0, comm=MeshCommunication([card]))
    into_four = ht.load_npy(one, split=0, comm=mesh)
    equal = (torch.equal(into_one.larray, x.larray) and torch.equal(into_four.larray, x4.larray)
             and all(torch.equal(a.narrow(0, 0, c), b.narrow(0, 0, c)) for a, b, c in
                     zip(into_four.shards, x4.shards, x4.counts_displs()[0])))
    out["mesh"] = {"equal": equal, "files_equal": open(four, "rb").read(1 << 20) == open(one, "rb").read(1 << 20)
                   and os.path.getsize(four) == os.path.getsize(one)}
    print(f"  {IO_P} shards of the card: saved from four and loaded into one, and back, equal bit for bit: "
          f"{equal}; the two files the same size and header: {out['mesh']['files_equal']}", flush=True)
    if not (equal and out["mesh"]["files_equal"]):
        raise AssertionError("the table saved from four shards and loaded into one (or back) differs")
    os.remove(four)
    os.remove(one)
    return out


def _leaves(tree, prefix=""):
    """(path, leaf) pairs of a state dict, dicts in sorted key order."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree, key=str) for pair in _leaves(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [pair for i, v in enumerate(tree) for pair in _leaves(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _state_diff(a, b) -> float:
    """0.0 when two states are equal bit for bit (tensors with their
    dtypes), else the largest |d| / max|b| over their tensors; inf when the
    structure or a plain value differs."""
    import torch

    la, lb = _leaves(a), _leaves(b)
    if [p for p, _ in la] != [p for p, _ in lb]:
        return math.inf
    worst = 0.0
    for (_, x), (_, y) in zip(la, lb):
        if isinstance(y, torch.Tensor):
            if not isinstance(x, torch.Tensor) or x.dtype != y.dtype or x.shape != y.shape:
                return math.inf
            x, y = x.detach().to(y.device), y.detach()
            if not torch.equal(x, y):
                scale = y.double().abs().max().item() or 1.0
                worst = max(worst, (x.double() - y.double()).abs().max().item() / scale)
        elif x != y:
            return math.inf
    return worst


def _checkpoint_case(ht, label: str, make, step, tmp: str, count=None) -> dict:
    """Step twice, save, step once more; a fresh trainer restores (its state
    must equal the saved one bit for bit) and steps; a second restored
    trainer steps from the same state, which shows whether the card repeats
    the step bit for bit here, and sets the bound otherwise."""
    import copy

    import torch

    directory = os.path.join(tmp, label.replace(" ", "_"))
    first = make()
    for _ in range(2):
        step(first)
    saved = copy.deepcopy(first.state_dict())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = first.save(directory, step=2)
    save_s = time.perf_counter() - t0
    nbytes = _file_bytes(directory)
    t0 = time.perf_counter()
    problems = ht.utils.checkpoint.verify_checkpoint(directory, 2)
    verify_s = time.perf_counter() - t0
    third_loss = step(first)
    third = copy.deepcopy(first.state_dict())
    del first
    torch.cuda.empty_cache()
    restored = make()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored.restore(directory)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    state_diff = _state_diff(restored.state_dict(), saved)
    twin = make()
    twin.load_state_dict(copy.deepcopy(restored.state_dict()))
    if count is not None:
        count(reset=True)
    loss = step(restored)
    launches = count() if count is not None else None
    loss_twin = step(twin)
    run_to_run = max(_state_diff(twin.state_dict(), restored.state_dict()), abs(loss_twin - loss) / abs(loss))
    next_diff = max(_state_diff(restored.state_dict(), third), abs(loss - third_loss) / abs(third_loss))
    bound = RUN_TO_RUN_FACTOR * run_to_run
    out = {"path": os.path.basename(path), "bytes": nbytes, "save_gb_per_s": nbytes / save_s / 1e9,
           "restore_s": restore_s, "restore_gb_per_s": nbytes / restore_s / 1e9, "verify_s": verify_s,
           "verify": problems, "restored_state_diff": state_diff, "next_step_diff": next_diff,
           "run_to_run": run_to_run, "bit_for_bit": run_to_run == 0.0, "launches": launches}
    held = "bit for bit (two steps from the restored state repeat exactly)" if run_to_run == 0.0 else (
        f"within {RUN_TO_RUN_FACTOR:g} x the run-to-run difference {run_to_run:.3e}")
    print(f"  {label}: checkpoint {nbytes / 1e9:.3f} GB, save {out['save_gb_per_s']:.2f} GB/s, restore "
          f"{restore_s:.2f} s ({out['restore_gb_per_s']:.2f} GB/s, the checksums included), "
          f"verify_checkpoint {problems} in {verify_s:.2f} s; restored state against the saved: "
          f"{state_diff:.3e}; next step against the uninterrupted third: {next_diff:.3e}, held {held}"
          + ("" if launches is None else f"; {launches} flash launches in the restored step"), flush=True)
    if problems or state_diff != 0.0 or not next_diff <= bound:
        raise AssertionError(f"{label}: the checkpoint does not resume the run")
    del restored, twin, saved, third
    shutil.rmtree(directory, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


def checkpoint_phase(ht, tmp: str) -> dict:
    """(3) Checkpoints at full width: ResNet-50 under DataParallel at batch
    256 (BASELINE config 5), DASO on four shards of the card, and the
    README's TransformerLM (f32, 4 x 4096 tokens) under DataParallel with
    Adam through the flash kernel."""
    import torch

    from heat_tpu_torch.core.communication import MeshCommunication
    from heat_tpu_torch.ops import flash

    card = torch.device("cuda", 0)
    print("phase io: checkpoints at full width; deterministic algorithms where torch has them", flush=True)
    x, y = _cifar(CKPT_BATCH, SEED + 15)

    def resnet():
        return ht.nn.ResNet50(num_classes=TRAIN_CLASSES, generator=torch.Generator("cuda").manual_seed(SEED))

    out = {}

    def make_dp():
        return ht.nn.DataParallel(resnet(), comm=MeshCommunication([card]),
                                  optimizer=ht.optim.SGD(TRAIN_LR, momentum=0.9)).init(SEED, x[:2])

    out["resnet50"] = _checkpoint_case(ht, "ResNet-50 DataParallel", make_dp, lambda t: t.train_step(x, y), tmp)

    def make_daso():
        daso = ht.optim.DASO(ht.optim.SGD(TRAIN_LR, momentum=0.9), total_epochs=10,
                             comm=MeshCommunication([card] * IO_P), nodes=2, warmup_epochs=0, cooldown_epochs=0)
        daso.add_model(resnet(), SEED, x[:IO_P])
        daso.global_skip, daso.local_skip, daso.batches_to_wait = 2, 1, 1
        return daso

    out["daso"] = _checkpoint_case(ht, f"ResNet-50 DASO on {IO_P} shards", make_daso, lambda t: t.step(x, y), tmp)

    tokens = torch.randint(0, LM["vocab"], (LM_BATCH, LM_SEQ), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(SEED + 15))
    forward = []

    def loss_fn(logits, labels):
        forward.append(flash.LAUNCHES)  # the forward's launches, counted before the backward
        return next_token_loss(logits, labels)

    def make_lm():
        return ht.nn.DataParallel(_lm(ht, torch.float32), comm=MeshCommunication([card]),
                                  optimizer=ht.optim.Adam(LM_LR), loss_fn=loss_fn).init(SEED, tokens[:1])

    def count(reset=False):
        if reset:
            flash.LAUNCHES = 0
            forward.clear()
            return None
        return {"forward": forward[0], "step": flash.LAUNCHES}

    lm = _checkpoint_case(ht, "TransformerLM f32 DataParallel Adam", make_lm,
                          lambda t: t.train_step(tokens, tokens), tmp, count)
    lm["launches"], lm["launches_forward"] = lm["launches"]["step"], lm["launches"]["forward"]
    if lm["launches_forward"] != LM["depth"] or lm["launches"] != LM["depth"]:
        raise AssertionError(f"the LM checkpoint step launched the flash kernel {lm['launches']} times, not {LM['depth']}")
    out["transformer_lm"] = lm
    return out


def convolve_phase(ht) -> dict:
    """(4) convolve of 10^8 float32 with a 9-tap filter in every mode
    against float64 on the card; four shards (halos exchanged) equal one
    shard bit for bit."""
    import torch
    import torch.nn.functional as Fn

    from heat_tpu_torch.core.communication import MeshCommunication

    card = torch.device("cuda", 0)
    print(f"phase io: convolve of {CONV_N} float32 with a {CONV_TAPS}-tap filter, every mode, against float64; "
          f"{IO_P} shards against one", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
    a = torch.randn(CONV_N, device="cuda", generator=gen)
    v = torch.randn(CONV_TAPS, device="cuda", generator=gen)
    k = CONV_TAPS
    flipped = v.double().flip(0)[None, None]
    full64 = Fn.conv1d(a.double()[None, None], flipped, padding=k - 1)[0, 0]
    mag64 = Fn.conv1d(a.double().abs()[None, None], flipped.abs(), padding=k - 1)[0, 0]
    one = ht.array(a, split=0, comm=MeshCommunication([card]))
    four = ht.array(a, split=0, comm=MeshCommunication([card] * IO_P))
    taps = ht.array(v)
    out = {}
    for mode, (lo, hi) in {"full": (0, CONV_N + k - 1), "same": ((k - 1) // 2, (k - 1) // 2 + CONV_N),
                           "valid": (k - 1, CONV_N)}.items():
        box = []
        ms = _time_step(lambda: box.append(ht.convolve(one, taps, mode=mode)))
        got = box[0].larray
        err = ((got.double() - full64[lo:hi]).abs() / ((k + 1) * U32 * mag64[lo:hi] + 1e-30)).max().item()
        ms4 = _time_step(lambda: box.append(ht.convolve(four, taps, mode=mode)))
        equal = box[1].gshape == box[0].gshape and torch.equal(box[1].larray, got)
        out[mode] = {"ms": ms, "ms_four_shards": ms4, "error_over_bound": err, "four_equal_one": equal}
        print(f"  {mode}: {ms:.2f} ms on one shard, {ms4:.2f} ms on {IO_P}; error {err:.3f} of the bound; "
              f"{IO_P} shards equal one bit for bit: {equal}", flush=True)
        if not (err <= 1.0 and equal and box[0].gshape == (hi - lo,)):
            raise AssertionError(f"convolve mode={mode} out of bound or four shards differ from one")
        del box, got
    return out


def io_path(ht, smi: str) -> dict:
    """Phase 15: I/O and checkpointing on the card; returns its numbers."""
    import torch

    numbers = {"card": smi, "seconds": {}}
    tmp = tempfile.mkdtemp(prefix="heat_io_")
    deterministic = (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic,
                     torch.backends.cudnn.benchmark)
    cublas = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    try:
        numbers["environment"] = io_environment(ht, tmp)
        x, init = kmeans_table(ht)
        t0 = time.perf_counter()
        numbers["formats"] = formats_phase(ht, x, tmp, numbers["environment"])
        numbers["seconds"]["formats"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        numbers["disk_fit"] = disk_fit_phase(ht, x, init, tmp, numbers["environment"])
        numbers["seconds"]["disk_fit"] = time.perf_counter() - t0
        del x, init
        torch.cuda.empty_cache()
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        t0 = time.perf_counter()
        numbers["checkpoints"] = checkpoint_phase(ht, tmp)
        numbers["seconds"]["checkpoints"] = time.perf_counter() - t0
        torch.use_deterministic_algorithms(deterministic[0])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = deterministic[1:]
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        numbers["convolve"] = convolve_phase(ht)
        numbers["seconds"]["convolve"] = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(deterministic[0])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = deterministic[1:]
        if cublas is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = cublas
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"  phase 15 took {sum(numbers['seconds'].values()):.1f} s: {numbers['seconds']}", flush=True)
    return numbers


# ---------------------------------------------------------------------------
# the runtime's path (phase 16): telemetry, resilience and profiling on the
# card. No kernel of its own: the traced fit runs the Lloyd kernel, the
# traced LM step the flash kernel and the four-shard cdist the pairwise one.
# ---------------------------------------------------------------------------
RT_P = 4  # shards of the card for the collective counts and the fault
RT_SMALL = (1_000, 16)  # the overhead chain where the host sets the pace
RT_CHAIN_REPS, RT_CHAIN_TRIALS, RT_CHAIN_ROUNDS = 8, 5, 5
RT_LARGE_REPS, RT_LARGE_TRIALS = 2, 2  # the chain on BASELINE config 3's table
RT_OVERHEAD_FLOOR = 0.9  # mode 1 against off, heat_tpu's own guard (tests/test_telemetry.py)
RT_QR_SHAPE = (1_000_000, 256)
RT_TIMED_TOL = 0.05  # a timed fit's host time against its CUDA-event time
RT_TABLE_BYTES = N * F * 4


def _rt_chain(ht, a, b):
    """heat_tpu's 10-op eager chain (tests/test_telemetry.py:28-38)."""
    c = (a + b) * 2.0
    c = ht.exp(c)
    c = c - b
    d = ht.abs(c)
    e = d + a
    f = ht.sqrt(ht.abs(e))
    g = f / (d + 1.0)
    h = g * b
    return ht.sum(h)


def _rt_rate(ht, a, b, reps: int, trials: int) -> float:
    """Ops per second of the chain, each chain ending in one host read (the
    reference's measurement)."""
    float(_rt_chain(ht, a, b).larray)
    best = math.inf
    for _ in range(trials):
        t0 = time.perf_counter()
        for _ in range(reps):
            float(_rt_chain(ht, a, b).larray)
        best = min(best, time.perf_counter() - t0)
    return 10.0 * reps / best


def _rt_counting_mesh(devices):
    """Phase 10's counting mesh, counting the prefix verbs too."""
    mesh = counting_mesh(devices)

    def counted(verb):
        method = getattr(type(mesh).__mro__[1], verb)

        def call(shards, *args, **kwargs):
            mesh._count(verb, shards)
            return method(mesh, shards, *args, **kwargs)

        return call

    mesh.exscan, mesh.scan = counted("exscan"), counted("scan")
    return mesh


def traced_fit_phase(ht, tel, x, init) -> dict:
    """(a) Phase 3's fit with telemetry off, at mode 1 and verbose, each
    under ``span("fit")``: the Lloyd kernel's launches, and the results
    equal bit for bit across the modes."""
    import torch

    from heat_tpu_torch.ops import lloyd

    print(f"phase runtime: KMeans(n_clusters={K}) for {ITERS} iterations from phase 3's centres with "
          "telemetry off, at mode 1 and verbose", flush=True)
    fits, out = {}, {"launches": {}, "ms_per_iter": {}}
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    tel.set_mode(0)
    ht.cluster.KMeans(n_clusters=K, init=init, max_iter=ITERS, tol=-1.0).fit(x)  # warm: the first fit of a process
    torch.cuda.synchronize()
    for mode, name in ((0, "off"), (1, "on"), (2, "verbose")):
        tel.set_mode(mode)
        tel.reset()
        lloyd.LAUNCHES = 0
        start.record()
        with tel.span("fit"):
            fits[name] = ht.cluster.KMeans(n_clusters=K, init=init, max_iter=ITERS, tol=-1.0).fit(x)
        stop.record()
        torch.cuda.synchronize()
        out["launches"][name] = lloyd.LAUNCHES
        out["ms_per_iter"][name] = start.elapsed_time(stop) / ITERS
    ref = fits["off"]
    out["equal"] = all(
        torch.equal(f.cluster_centers_.larray, ref.cluster_centers_.larray)
        and torch.equal(f.labels_.larray, ref.labels_.larray) and f.inertia_ == ref.inertia_
        for f in fits.values()
    )
    print(f"  Lloyd launches {out['launches']}; ms per iteration {json.dumps(out['ms_per_iter'])}; centres, "
          f"labels and inertia equal across the modes bit for bit: {out['equal']}", flush=True)
    if set(out["launches"].values()) != {ITERS} or not out["equal"]:
        raise AssertionError("the traced fits differ or missed the Lloyd kernel")
    return out


def overhead_phase(ht, tel, x) -> dict:
    """(b) The 10-op chain at RT_SMALL (the host sets the pace) and on the
    table: ops/s with telemetry off, at mode 1 and verbose; mode 1 keeps at
    least RT_OVERHEAD_FLOOR of the rate off at the small size (the legs
    alternate, the best round counts, as in the reference's guard)."""
    import torch

    print(f"phase runtime: the 10-op eager chain at {RT_SMALL[0]} x {RT_SMALL[1]} and {N} x {F} float32, "
          "telemetry off, at mode 1 and verbose", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
    a, b = (ht.array(torch.randn(RT_SMALL, generator=gen, device="cuda"), split=0) for _ in range(2))
    out = {"small": {}, "large": {}}
    ratio = 0.0
    for round_ in range(RT_CHAIN_ROUNDS):
        rates = {}
        for mode, name in ((0, "off"), (1, "on"), (2, "verbose")):
            tel.set_mode(mode)
            tel.reset()
            rates[name] = _rt_rate(ht, a, b, RT_CHAIN_REPS, RT_CHAIN_TRIALS)
        if rates["on"] / rates["off"] > ratio:
            ratio, out["small"] = rates["on"] / rates["off"], rates
        if round_ >= 1 and ratio >= RT_OVERHEAD_FLOOR:
            break
    out["small_ratio_on_off"] = ratio
    for mode, name in ((0, "off"), (1, "on"), (2, "verbose")):
        tel.set_mode(mode)
        tel.reset()
        out["large"][name] = _rt_rate(ht, x, x, RT_LARGE_REPS, RT_LARGE_TRIALS)
    tel.set_mode(0)
    print(f"  ops/s at {RT_SMALL}: {json.dumps(out['small'])} (mode 1 / off {ratio:.4f}); on the table: "
          f"{json.dumps(out['large'])}", flush=True)
    if ratio < RT_OVERHEAD_FLOOR:
        raise AssertionError(f"telemetry at mode 1 keeps {ratio:.3f} of the dispatch rate, under {RT_OVERHEAD_FLOOR}")
    return out


def sync_phase(ht, tel, res, x) -> dict:
    """(c) No sync added: a warm reduction chain on one and on four shards,
    forced (dispatched, not read) under ``set_sync_debug_mode("error")``
    with telemetry verbose; under ``errstate("warn")`` the syncs counted
    with the mode at "warn", one per check: with the recorder on one per
    forced chain, with it off one per op; a NaN made on the card raises
    under ``"raise"`` at the chain's force, and with the recorder off at
    the op."""
    import warnings

    import torch

    from heat_tpu_torch.core import fusion
    from heat_tpu_torch.core.communication import MeshCommunication

    print("phase runtime: a warm reduction chain under set_sync_debug_mode('error') with telemetry verbose; "
          "errstate('warn') under 'warn'; a NaN on the card under errstate('raise'); recorder on and off",
          flush=True)
    x4 = ht.array(x.larray[:1_000_003], split=0, comm=MeshCommunication([torch.device("cuda", 0)] * RT_P))

    def chain(z):
        return ht.sum(ht.abs(z * 2.0 - 1.0), axis=0).shards  # forced: dispatched, not read

    out = {}
    default = fusion._EAGER_BELOW_BYTES
    for leg in ("on", "off"):
        was = fusion.set_enabled(leg == "on")
        fusion._EAGER_BELOW_BYTES = 0  # the recorder at every size: its checks are what this leg holds
        try:
            tel.set_mode(2)
            tel.reset()
            chain(x), chain(x4)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                with tel.span("chain"):
                    chain(x)
                    chain(x4)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            rec = {"no_sync_events": len(tel.events())}
            tel.set_mode(1)
            tel.reset()
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    with res.errstate(nonfinite="warn"):
                        chain(x)
                        chain(x4)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            rec["checks"] = sum(r["eager"] for r in tel.dispatches().values()) + sum(
                fp["count"] for fp in tel.forcing_points().values())
            rec["syncs"] = sum("synchroniz" in str(w.message) for w in caught)
            tel.reset()
            z = ht.zeros(RT_SMALL, split=0) - 1.0
            raised = False
            with res.errstate(nonfinite="raise"):
                try:
                    ht.log(z).shards
                except res.NonFiniteError as exc:
                    raised, rec["nonfinite_message"] = True, str(exc)
            rec["nonfinite_counts"] = tel.nonfinite_counts()
        finally:
            fusion.set_enabled(was)
            fusion._EAGER_BELOW_BYTES = default
        out[leg] = rec
        print(f"  recorder {leg}: no sync under 'error' ({rec['no_sync_events']} timeline events); under "
              f"errstate('warn') {rec['syncs']} syncs for {rec['checks']} checks; NaN raised NonFiniteError: "
              f"{raised}, nonfinite_counts {rec['nonfinite_counts']}", flush=True)
        where = "force" if leg == "on" else "eager"
        if not (rec["syncs"] == rec["checks"] == (2 if leg == "on" else 8) and raised
                and rec["nonfinite_counts"] == {where: 1}):
            raise AssertionError(f"recorder {leg}: errstate on the card did not check each "
                                 f"{'chain' if leg == 'on' else 'op'} with one sync, or missed the NaN")
    return out


def collectives_phase(ht, tel) -> dict:
    """(d) Four shards of the card: the symmetric ring cdist, qr of a tall
    split-0 matrix, one DASO step of ResNet-50 and ring attention, each
    with ``collective_counts()`` equal to the counting mesh's; the ring's
    ppermute bytes against its shards' by hand."""
    import torch

    from heat_tpu_torch.nn.attention import ring_attention

    card = torch.device("cuda", 0)
    mesh = _rt_counting_mesh([card] * RT_P)
    print(f"phase runtime: collectives on {RT_P} shards of the card against the counting mesh", flush=True)
    tel.set_mode(1)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
    out = {}

    def counted(label, fn):
        before = dict(mesh.calls)
        tel.reset()
        fn()
        torch.cuda.synchronize()
        delta = {k: v - before.get(k, 0) for k, v in mesh.calls.items() if v - before.get(k, 0)}
        got = tel.collective_counts()
        out[label] = {"telemetry": got, "counting_mesh": delta, "collectives": tel.collectives()}
        print(f"  {label}: telemetry {got}, counting mesh {delta}", flush=True)
        if got != delta or not got:
            raise AssertionError(f"{label}: telemetry's collective counts differ from the counting mesh's")

    a = ht.array(torch.randn((RING_N, DIST_F), generator=gen, device="cuda"), split=0, comm=mesh)
    counted("cdist_ring_symmetric", lambda: ht.spatial.cdist(a))
    mb = a.shards[0].shape[0]
    rec = out["cdist_ring_symmetric"]["collectives"]["ppermute"]
    out["ppermute_bytes_by_hand"] = rec["count"] * mb * DIST_F * 4
    print(f"  the ring's ppermute bytes {rec['bytes']}: {rec['count']} x one shard's {mb} x {DIST_F} float32 = "
          f"{out['ppermute_bytes_by_hand']}", flush=True)
    if rec["bytes"] != out["ppermute_bytes_by_hand"]:
        raise AssertionError("the ring's recorded ppermute bytes are not its shards' bytes")
    del a
    q = ht.array(torch.randn(RT_QR_SHAPE, generator=gen, device="cuda"), split=0, comm=mesh)
    # the counting mesh counts the eager schedule's verbs: a recorded one
    # runs them inside its program (phase 19)
    with ht.core.fusion.collectives_disabled():
        counted("qr_tall_split0", lambda: ht.linalg.qr(q))
    del q
    x, y = _cifar(CKPT_BATCH, SEED + 16)
    daso = ht.optim.DASO(ht.optim.SGD(TRAIN_LR, momentum=0.9), total_epochs=10, comm=mesh, nodes=2,
                         warmup_epochs=0, cooldown_epochs=0)
    daso.add_model(ht.nn.ResNet50(num_classes=TRAIN_CLASSES, generator=torch.Generator("cuda").manual_seed(SEED)),
                   SEED, x[:RT_P])
    daso.global_skip, daso.local_skip, daso.batches_to_wait = 2, 1, 1
    counted("daso_step", lambda: daso.step(x, y))
    del daso, x, y
    torch.cuda.empty_cache()
    qkv = [torch.randn(SP_SMALL, generator=gen, device="cuda") for _ in range(3)]
    counted("ring_attention", lambda: ring_attention(*qkv, causal=True, comm=mesh))
    del qkv
    torch.cuda.empty_cache()
    return out


def _kernels_in_region(trace_path: str, region: str, kernel: str) -> dict:
    """Kernels whose name holds ``kernel`` on the device rows of a torch
    profiler trace, and how many of them lie inside the device row of the
    ``region`` annotation."""
    with open(trace_path) as fh:
        evs = json.load(fh)["traceEvents"]
    ranges = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in evs
              if e.get("name") == region and e.get("cat") == "gpu_user_annotation"]
    kernels = [e for e in evs if e.get("cat") == "kernel" and kernel in e.get("name", "")]
    inside = sum(any(lo <= e["ts"] and e["ts"] + e.get("dur", 0) <= hi for lo, hi in ranges) for e in kernels)
    return {"regions": len(ranges), "kernels": len(kernels), "inside": inside}


def timeline_phase(ht, tel, x, init, tmp: str) -> dict:
    """(e) One README TransformerLM f32 step (4 x 4096 tokens, Adam) under
    ``span("lm_step")`` and the fit under ``span("fit")`` at verbose: the
    exported trace validates, the launches; the fit under
    ``profiling.trace`` with ``annotate("lloyd")`` holds the Lloyd kernel
    inside the region on the device rows; a ``timed`` fit against its CUDA
    events."""
    import importlib
    import io as pyio

    import torch

    from heat_tpu_torch.core.communication import MeshCommunication
    from heat_tpu_torch.ops import flash, lloyd
    from heat_tpu_torch.utils import profiling

    cli = importlib.import_module("heat_tpu_torch.telemetry")
    print("phase runtime: the README TransformerLM f32 step and the fit at verbose, exported; the fit under "
          "torch.profiler with annotate('lloyd'); a timed fit", flush=True)
    card = torch.device("cuda", 0)
    tel.set_mode(2)
    tel.reset()
    tokens = torch.randint(0, LM["vocab"], (LM_BATCH, LM_SEQ), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(SEED + 16))
    lm = ht.nn.DataParallel(_lm(ht, torch.float32), comm=MeshCommunication([card]),
                            optimizer=ht.optim.Adam(LM_LR), loss_fn=next_token_loss).init(SEED, tokens[:1])
    flash.LAUNCHES = 0
    with tel.span("lm_step"):
        loss = lm.train_step(tokens, tokens)
    torch.cuda.synchronize()
    out = {"launches_lm_step": flash.LAUNCHES, "lm_loss": float(loss)}
    del lm
    torch.cuda.empty_cache()
    lloyd.LAUNCHES = 0
    with tel.span("fit"):
        ht.cluster.KMeans(n_clusters=K, init=init, max_iter=ITERS, tol=-1.0).fit(x)
    torch.cuda.synchronize()
    out["launches_fit"] = lloyd.LAUNCHES
    path = os.path.join(tmp, "telemetry_trace.json")
    doc = tel.export_trace(path)
    out["trace_events"] = len(doc["traceEvents"])
    out["validate_trace"] = tel.validate_trace(path)
    buf = pyio.StringIO()
    out["cli_validate_rc"] = cli.main(["validate-trace", path], out=buf)
    out["spans"] = {p: {"calls": r["calls"], "host_s": r["total_s"]} for p, r in tel.spans().items()}
    print(f"  flash launches in the step {out['launches_lm_step']} (loss {out['lm_loss']:.4f}), Lloyd launches "
          f"in the fit {out['launches_fit']}; exported {out['trace_events']} trace events, validate_trace "
          f"{out['validate_trace']}, the command line: {buf.getvalue().strip()}; spans {json.dumps(out['spans'])}",
          flush=True)
    if (out["launches_lm_step"] != LM["depth"] or out["launches_fit"] != ITERS or out["validate_trace"]
            or out["cli_validate_rc"] != 0):
        raise AssertionError("the traced step or fit missed its kernel, or the exported trace does not validate")
    tel.set_mode(0)
    prof_dir = os.path.join(tmp, "profile")
    with profiling.trace(prof_dir):
        with profiling.annotate("lloyd"):
            ht.cluster.KMeans(n_clusters=K, init=init, max_iter=ITERS, tol=-1.0).fit(x)
        torch.cuda.synchronize()
    files = sorted(os.listdir(prof_dir))
    out["profile"] = _kernels_in_region(os.path.join(prof_dir, files[-1]), "lloyd", "lloyd")
    print(f"  torch profiler trace {files[-1]}: {json.dumps(out['profile'])} (Lloyd kernels on the device "
          "rows, inside the 'lloyd' region)", flush=True)
    if out["profile"]["inside"] < ITERS or out["profile"]["inside"] != out["profile"]["kernels"]:
        raise AssertionError("the profiler trace does not hold the Lloyd kernels inside the annotated region")
    timed_fit = profiling.timed(name="timed_fit")(
        lambda: ht.cluster.KMeans(n_clusters=K, init=init, max_iter=ITERS, tol=-1.0).fit(x))
    profiling.reset()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    timed_fit()
    stop.record()
    torch.cuda.synchronize()
    out["timed_ms"] = profiling.report()["timed_fit"]["total_s"] * 1e3
    out["event_ms"] = start.elapsed_time(stop)
    rel = abs(out["timed_ms"] - out["event_ms"]) / out["event_ms"]
    print(f"  timed fit {out['timed_ms']:.3f} ms against its CUDA events {out['event_ms']:.3f} ms "
          f"({100 * rel:.2f}%)", flush=True)
    if rel > RT_TIMED_TOL:
        raise AssertionError(f"the timed fit differs from its CUDA-event time by {100 * rel:.1f}%")
    return out


def memory_phase(ht, tel) -> dict:
    """(f) The allocator's bytes with the table on the card."""
    from heat_tpu_torch.utils import profiling

    stats = profiling.device_memory_stats()
    tel.set_mode(1)
    block = tel.report()["memory"]
    card = stats.get("cuda:0", {})
    print(f"phase runtime: device_memory_stats {json.dumps(stats)}; report()['memory']['device'] has "
          f"{sorted(block['device'])}", flush=True)
    if not (card.get("bytes_in_use", 0) >= RT_TABLE_BYTES and card.get("peak_bytes_in_use", 0) >= card["bytes_in_use"]
            and block["device"]):
        raise AssertionError("the device memory stats do not show the table")
    return {"device": stats, "report_device_keys": sorted(block["device"])}


def runtime_faults_phase(ht, tel, res, x, tmp: str) -> dict:
    """(g) Faults on the card: an io.write OSError every second attempt
    while the table is saved as .npy (twice), a hard checkpoint.commit
    fault on ResNet-50's second checkpoint, and a collective.allreduce
    fault on a four-shard sum."""
    import copy

    import torch

    from heat_tpu_torch.core import fusion
    from heat_tpu_torch.core.communication import MeshCommunication

    card = torch.device("cuda", 0)
    print("phase runtime: io.write OSError every=2 on the table's .npy saves; checkpoint.commit on ResNet-50's "
          f"second checkpoint; collective.allreduce on a {RT_P}-shard sum", flush=True)
    tel.set_mode(1)
    tel.reset()
    out = {}
    paths = [os.path.join(tmp, f"rt{i}.npy") for i in range(2)]
    with res.inject("io.write", exc=OSError, every=2, times=None) as spec:
        for path in paths:
            ht.save_npy(x, path)
    loaded = ht.load_npy(paths[1], split=0)
    out["io"] = {"fired": spec.fired, "io_retries": tel.io_retries(), "equal": torch.equal(loaded.larray, x.larray)}
    del loaded
    for path in paths:
        os.remove(path)

    xb, yb = _cifar(CKPT_BATCH, SEED + 16)

    def make():
        return ht.nn.DataParallel(
            ht.nn.ResNet50(num_classes=TRAIN_CLASSES, generator=torch.Generator("cuda").manual_seed(SEED)),
            comm=MeshCommunication([card]), optimizer=ht.optim.SGD(TRAIN_LR, momentum=0.9)).init(SEED, xb[:2])

    directory = os.path.join(tmp, "rt_ckpt")
    dp = make()
    dp.train_step(xb, yb)
    saved = copy.deepcopy(dp.state_dict())
    dp.save(directory, step=1)
    dp.train_step(xb, yb)
    raised = False
    with res.inject("checkpoint.commit"):
        try:
            dp.save(directory, step=2)
        except res.FaultInjected:
            raised = True
    del dp
    fresh = make()
    fresh.restore(directory)
    out["checkpoint"] = {"raised": raised, "latest_step": ht.checkpoint.latest_step(directory),
                         "restored_state_diff": _state_diff(fresh.state_dict(), saved),
                         "events": tel.checkpoint_events()}
    del fresh, saved, xb, yb
    shutil.rmtree(directory, ignore_errors=True)
    torch.cuda.empty_cache()

    # the collective.allreduce site is the mesh verb's, which the eager
    # engine calls: a recorded sum combines its partials inside its program
    # and passes no site
    x4 = ht.array(x.larray, split=0, comm=MeshCommunication([card] * RT_P))
    faulted = False
    with fusion.disabled():
        want = ht.sum(x4, axis=0).larray.clone()
        with res.inject("collective.allreduce"):
            try:
                ht.sum(x4, axis=0)
            except res.FaultInjected:
                faulted = True
        next_equal = torch.equal(ht.sum(x4, axis=0).larray, want)
    with res.inject("collective.allreduce") as spec:
        recorded = ht.sum(x4, axis=0)
        was_recorded = fusion.is_deferred(recorded)
        recorded.larray
    out["allreduce"] = {"raised": faulted, "next_equal": next_equal, "recorded": was_recorded,
                        "recorded_fired": spec.fired}
    del x4, recorded
    print(f"  {json.dumps(out)}", flush=True)
    if not (out["io"]["equal"] and out["io"]["fired"] == 1 and out["io"]["io_retries"] == {"io.write": 1}
            and raised and out["checkpoint"]["latest_step"] == 1 and out["checkpoint"]["restored_state_diff"] == 0.0
            and faulted and out["allreduce"]["next_equal"] and out["allreduce"]["recorded"] and out["allreduce"]["recorded_fired"] == 0):
        raise AssertionError("an injected fault on the card did not recover as stated")
    return out


_RT_SINK_SCRIPT = """
import json, sys, torch
import heat_tpu_torch as ht
ht.telemetry.report()
ht.telemetry._SINK.flush("before")
untouched = not torch.cuda.is_initialized()
x = ht.ones((1000, 16), split=0)
ht.sum(x).item()
print(json.dumps({"cuda_uninitialized_after_report": untouched}))
"""


def sink_phase(tmp: str) -> dict:
    """(h) A subprocess with HEAT_TPU_METRICS set: ``report()`` and a sink
    flush before any tensor leave CUDA uninitialized, and the file holds
    JSON lines that parse."""
    path = os.path.join(tmp, "metrics.jsonl")
    env = dict(os.environ, HEAT_TPU_METRICS=path, HEAT_TPU_TELEMETRY="1", HEAT_TPU_METRICS_INTERVAL="0")
    proc = subprocess.run([sys.executable, "-c", _RT_SINK_SCRIPT], capture_output=True, text=True, env=env,
                          cwd=os.path.dirname(os.path.abspath(__file__)), timeout=300)
    if proc.returncode:
        raise AssertionError(f"the metrics-sink subprocess failed: {proc.stderr[-2000:]}")
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    lines = [json.loads(line) for line in open(path)]
    out = {"cuda_uninitialized_after_report": result["cuda_uninitialized_after_report"],
           "lines": [line["event"] for line in lines],
           "exit_line_device_memory": sorted(lines[-1]["report"]["memory"]["device"])}
    print(f"phase runtime: the metrics sink in a subprocess: {json.dumps(out)}", flush=True)
    if not (out["cuda_uninitialized_after_report"] and out["lines"] == ["before", "exit"]
            and out["exit_line_device_memory"]):
        raise AssertionError("report() initialized CUDA, or the metrics sink's lines are wrong")
    return out


def runtime_path(ht, smi: str) -> dict:
    """Phase 16: the runtime's observability and robustness layer on the
    card; returns its numbers (telemetry off again at the end)."""
    import torch

    from heat_tpu_torch.core import resilience as res
    from heat_tpu_torch.core import telemetry as tel

    numbers = {"card": smi, "seconds": {}}
    tmp = tempfile.mkdtemp(prefix="heat_rt_")
    was = tel.set_mode(0)
    try:
        x, init = kmeans_table(ht)
        for label, fn in (
            ("memory", lambda: memory_phase(ht, tel)),
            ("fit", lambda: traced_fit_phase(ht, tel, x, init)),
            ("overhead", lambda: overhead_phase(ht, tel, x)),
            ("sync", lambda: sync_phase(ht, tel, res, x)),
            ("collectives", lambda: collectives_phase(ht, tel)),
            ("timeline", lambda: timeline_phase(ht, tel, x, init, tmp)),
            ("faults", lambda: runtime_faults_phase(ht, tel, res, x, tmp)),
            ("sink", lambda: sink_phase(tmp)),
        ):
            t0 = time.perf_counter()
            numbers[label] = fn()
            numbers["seconds"][label] = time.perf_counter() - t0
            torch.cuda.empty_cache()
    finally:
        tel.set_mode(was)
        tel.reset()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"  phase 16 took {sum(numbers['seconds'].values()):.1f} s: {numbers['seconds']}", flush=True)
    return numbers


# ---------------------------------------------------------------------------
# memory and health on the card (phase 17): the memory ledger, the flight
# ring, the watchdog and the mesh probes. No kernel of its own: the fit runs
# the Lloyd kernel and the LM step the flash kernel.
# ---------------------------------------------------------------------------
MH_P = 4  # shards of the card for the staged ingest and the mesh probe
MH_DEADLINE_MS = 200  # the watchdog's deadline for the injected stalls
MH_BLOCK = 512  # the caching allocator's rounding of a block
MH_FITS = 3  # fits per leg of the overhead comparison (hooks on, off)
MH_CHAIN_REPS, MH_CHAIN_TRIALS = 8, 5


def _dndarray_storages() -> int:
    """Bytes of the distinct shard storages of every live DNDarray."""
    import gc

    from heat_tpu_torch.core.dndarray import DNDarray

    gc.collect()
    storages = {}
    for obj in gc.get_objects():
        if issubclass(type(obj), DNDarray):
            for s in obj.shards:
                if s.device.type == "cuda":
                    storages[(str(s.device), s.untyped_storage().data_ptr())] = s.untyped_storage().nbytes()
    return sum(storages.values())


def ledger_fit_phase(ht, tel, x, init) -> dict:
    """(a) Phase 3's fit with the ledger and the ring on at telemetry mode
    1: its Lloyd launches, the ledger against the live arrays and the
    allocator, the watermark between the table and the allocator's peak."""
    import torch

    from heat_tpu_torch.core import memledger
    from heat_tpu_torch.ops import lloyd

    print(f"phase health: KMeans(n_clusters={K}) for {ITERS} iterations from phase 3's centres with the memory "
          "ledger and the flight ring on", flush=True)
    tel.set_mode(1)
    tel.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lloyd.LAUNCHES = 0
    km = ht.cluster.KMeans(n_clusters=K, init=init, max_iter=ITERS, tol=-1.0).fit(x)
    torch.cuda.synchronize()
    out = {"launches": lloyd.LAUNCHES}
    memledger.sample("fit", force=True)
    led = memledger.ledger(top=3)
    out["ledger"] = {k: led[k] for k in ("total_bytes", "by_owner", "buffers", "top")}
    out["dndarray_storages"] = _dndarray_storages()
    out["memory_allocated"] = torch.cuda.memory_allocated()
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    out["watermark"] = memledger.watermark()
    out["table_bytes"] = RT_TABLE_BYTES
    slack = MH_BLOCK * led["buffers"]
    print(f"  Lloyd launches {out['launches']}; ledger {json.dumps(out['ledger'])}; the live arrays' shard "
          f"storages {out['dndarray_storages']}; memory_allocated {out['memory_allocated']} (the ledger's total "
          f"within {slack} B: {abs(led['total_bytes'] - out['memory_allocated'])}); watermark "
          f"{json.dumps(out['watermark'])} between the table's {RT_TABLE_BYTES} B and max_memory_allocated "
          f"{out['max_memory_allocated']}", flush=True)
    if out["launches"] != ITERS:
        raise AssertionError("the fit with the ledger on missed the Lloyd kernel")
    if led["by_owner"].get("dndarray") != out["dndarray_storages"]:
        raise AssertionError("the ledger's dndarray bytes are not the live arrays' shard storages")
    if abs(led["total_bytes"] - out["memory_allocated"]) > slack:
        raise AssertionError("the ledger's total is not the allocator's")
    if not RT_TABLE_BYTES <= out["watermark"]["bytes"] <= out["max_memory_allocated"]:
        raise AssertionError("the watermark is not between the table's bytes and the allocator's peak")
    out["fitted_centres"] = km.cluster_centers_
    return out


def hooks_overhead_phase(ht, tel, x, init) -> dict:
    """(b) The fit's ms per iteration and the host-bound 10-op chain's ops/s
    at telemetry mode 1, with the ledger's hook and the ring on and off
    (legs alternated, the best of each kept); the host waits of the
    centres' reads that end the fits, in the health layer's histogram."""
    import torch

    from heat_tpu_torch.core import health_runtime, memledger

    print("phase health: the fit and the 10-op chain at mode 1 with the ledger and the ring on and off "
          "(HEAT_TPU_MEMORY_LEDGER=0 HEAT_TPU_FLIGHT=0 in-process)", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    a, b = (ht.array(torch.randn(RT_SMALL, generator=gen, device="cuda"), split=0) for _ in range(2))
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    tel.set_mode(1)
    tel.reset()
    fit_ms = {"on": math.inf, "off": math.inf}
    chain = {"on": 0.0, "off": 0.0}
    try:
        with tel.scope("fit"):
            for _ in range(MH_FITS):
                for leg in ("on", "off"):
                    memledger.set_enabled(leg == "on")
                    health_runtime.set_flight(leg == "on")
                    start.record()
                    km = ht.cluster.KMeans(n_clusters=K, init=init, max_iter=ITERS, tol=-1.0).fit(x)
                    stop.record()
                    km.cluster_centers_.numpy()  # the host wait for the fit
                    torch.cuda.synchronize()
                    fit_ms[leg] = min(fit_ms[leg], start.elapsed_time(stop) / ITERS)
                    chain[leg] = max(chain[leg], _rt_rate(ht, a, b, MH_CHAIN_REPS, MH_CHAIN_TRIALS))
            waits = health_runtime.health_block()["sync"]
    finally:
        memledger.set_enabled(True)
        health_runtime.set_flight(True)
    out = {"fit_ms_per_iter": fit_ms, "fit_ratio_on_off": fit_ms["on"] / fit_ms["off"],
           "chain_ops_per_s": chain, "chain_ratio_on_off": chain["on"] / chain["off"],
           "sync_waits": waits.get("numpy", {})}
    print(f"  fit ms per iteration {json.dumps(fit_ms)} (on / off {out['fit_ratio_on_off']:.4f}); chain ops/s at "
          f"{RT_SMALL} {json.dumps(chain)} (on / off {out['chain_ratio_on_off']:.4f}); the fits' host waits "
          f"(sync:numpy) {json.dumps(out['sync_waits'])}", flush=True)
    if out["sync_waits"].get("count") != 2 * MH_FITS:
        raise AssertionError("the histogram did not see one host wait per fit")
    return out


def _staged_owners(ht, load):
    """The largest ``io`` and ``checkpoint`` bytes the ledger holds at a
    block read of the sharded ingest that ``load()`` runs."""
    from heat_tpu_torch.core import io as io_module
    from heat_tpu_torch.core import memledger

    seen = {"io": 0, "checkpoint": 0}
    ingest = io_module._ingest

    def watched(read_block, *args, **kwargs):
        def read(sl):
            by_owner = memledger.ledger(top=0)["by_owner"]
            for owner in seen:
                seen[owner] = max(seen[owner], by_owner.get(owner, 0))
            return read_block(sl)

        return ingest(read, *args, **kwargs)

    io_module._ingest = watched
    try:
        result = load()
    finally:
        io_module._ingest = ingest
    return seen, result


def ledger_lm_phase(ht, tel, x, tmp: str) -> dict:
    """(c) The README TransformerLM f32 step (4 x 4096 tokens, Adam) with the
    ledger on, saved and restored, its owner split; the table restored from
    a checkpoint and loaded from .npy on four shards of the card, its staged
    shards under ``checkpoint`` and ``io``."""
    import torch

    from heat_tpu_torch.core import memledger
    from heat_tpu_torch.core.communication import MeshCommunication
    from heat_tpu_torch.ops import flash

    card = torch.device("cuda", 0)
    print("phase health: the README TransformerLM f32 step, saved and restored, and the table restored and "
          f"loaded on {MH_P} shards of the card, with the ledger on", flush=True)
    tel.set_mode(1)
    tel.reset()
    tokens = torch.randint(0, LM["vocab"], (LM_BATCH, LM_SEQ), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(SEED + 17))

    def make():
        return ht.nn.DataParallel(_lm(ht, torch.float32), comm=MeshCommunication([card]),
                                  optimizer=ht.optim.Adam(LM_LR), loss_fn=next_token_loss).init(SEED, tokens[:1])

    lm = make()
    flash.LAUNCHES = 0
    loss = lm.train_step(tokens, tokens)
    torch.cuda.synchronize()
    out = {"launches": flash.LAUNCHES, "loss": float(loss)}
    out["after_step"] = memledger.ledger(top=0)["by_owner"]
    directory = os.path.join(tmp, "lm_ckpt")
    lm.save(directory, step=1)
    del lm
    torch.cuda.empty_cache()
    fresh = make()
    fresh.restore(directory)
    torch.cuda.synchronize()
    out["after_restore"] = memledger.ledger(top=0)["by_owner"]
    del fresh
    shutil.rmtree(directory, ignore_errors=True)
    torch.cuda.empty_cache()
    mesh = MeshCommunication([card] * MH_P)
    table_dir = os.path.join(tmp, "table_ckpt")
    ht.checkpoint.save_checkpoint(table_dir, {"table": x}, step=1)
    template = ht.zeros(x.gshape, split=0, comm=mesh)
    out["restore_staged"], restored = _staged_owners(
        ht, lambda: ht.checkpoint.load_checkpoint(table_dir, {"table": template})["table"])
    out["restored_equal"] = torch.equal(restored.larray, x.larray)
    del restored, template
    shutil.rmtree(table_dir, ignore_errors=True)
    path = os.path.join(tmp, "table.npy")
    ht.save_npy(x, path)
    out["npy_staged"], loaded = _staged_owners(ht, lambda: ht.load_npy(path, split=0, comm=mesh))
    out["npy_equal"] = torch.equal(loaded.larray, x.larray)
    out["after_load"] = memledger.ledger(top=0)["by_owner"]
    del loaded
    os.remove(path)
    torch.cuda.empty_cache()
    shard_bytes = -(-N // MH_P) * F * 4
    print(f"  flash launches in the step {out['launches']} (loss {out['loss']:.4f}); owner split after the step "
          f"{json.dumps(out['after_step'])}, after the restore {json.dumps(out['after_restore'])}; the table's "
          f"restore staged {json.dumps(out['restore_staged'])} and its .npy load {json.dumps(out['npy_staged'])} "
          f"at the last block read ({MH_P - 1} shards of {shard_bytes} B); after the load "
          f"{json.dumps(out['after_load'])}; equal to the table: {out['restored_equal']}, {out['npy_equal']}",
          flush=True)
    if out["launches"] != LM["depth"] or not (out["restored_equal"] and out["npy_equal"]):
        raise AssertionError("the LM step missed the flash kernel, or a staged table differs")
    if out["restore_staged"]["checkpoint"] < (MH_P - 1) * shard_bytes or out["npy_staged"]["io"] < (MH_P - 1) * shard_bytes:
        raise AssertionError("the staged shards are not under checkpoint and io")
    if out["after_load"].get("io", 0) or out["after_load"].get("checkpoint", 0):
        raise AssertionError("the loaded array did not claim its staged shards")
    return out


def watchdog_phase(ht, tel, res, centres, tmp: str) -> dict:
    """(d) A watchdog.stall injected at numpy() of the fitted centres under
    a MH_DEADLINE_MS deadline in the three policies."""
    import warnings

    import torch

    from heat_tpu_torch.core import health_runtime

    print(f"phase health: watchdog.stall at numpy() of the fitted centres, {MH_DEADLINE_MS} ms deadline, "
          "policies warn, raise and dump", flush=True)
    tel.set_mode(1)
    tel.reset()
    want = centres.numpy()
    prev = health_runtime.set_watchdog(deadline_ms=MH_DEADLINE_MS, policy="warn", enabled=True)
    dump_dir = health_runtime.set_dump_dir(tmp)
    out = {}

    def tripped(policy):
        before = health_runtime.watchdog_stats()["trips"]
        health_runtime.set_watchdog(policy=policy)
        got, raised = None, False
        with res.inject("watchdog.stall:sync:numpy", times=1):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                try:
                    got = centres.numpy()
                except res.StallError:
                    raised = True
        stall = health_runtime.last_stall()
        named = [str(w.message) for w in caught if w.category is res.StallWarning and "sync:numpy" in str(w.message)]
        return {"trips": health_runtime.watchdog_stats()["trips"] - before, "site": stall["site"],
                "waited_s": stall["waited_s"], "warning": bool(named), "raised": raised,
                "equal": None if got is None else bool((got == want).all())}

    try:
        out["warn"] = tripped("warn")
        out["dump"] = tripped("dump")
        end = time.monotonic() + 10.0
        while time.monotonic() < end and health_runtime.last_dump() is None:
            time.sleep(0.01)
        dump = health_runtime.last_dump()
        out["raise"] = tripped("raise")
        out["raise"]["next_read_equal"] = bool((centres.numpy() == want).all())
    finally:
        health_runtime.set_watchdog(prev[0], policy=prev[1], enabled=prev[2])
        health_runtime.set_dump_dir(dump_dir)
    proc = subprocess.run([sys.executable, "-m", "heat_tpu_torch.telemetry", "validate-trace", dump["trace_path"]],
                          capture_output=True, text=True, cwd=os.path.dirname(os.path.abspath(__file__)), timeout=300)
    with open(dump["path"]) as fh:
        bundle = json.load(fh)
    out["dump"].update({"cli_rc": proc.returncode, "cli": proc.stdout.strip(), "reason": bundle["reason"],
                        "bundle_stall_site": bundle["stalls"][-1]["site"]})
    print(f"  {json.dumps(out)}", flush=True)
    ok = (all(out[p]["trips"] == 1 and out[p]["site"] == "sync:numpy" and out[p]["warning"] for p in out)
          and out["warn"]["equal"] and out["dump"]["equal"] and out["raise"]["raised"]
          and out["raise"]["next_read_equal"] and out["dump"]["cli_rc"] == 0 and out["dump"]["reason"] == "stall")
    if not ok:
        raise AssertionError("the injected stall did not trip as stated under every policy")
    torch.cuda.synchronize()
    return out


def probes_phase(ht) -> dict:
    """(e) ping_mesh on one and four shards of the card; memory_report()
    against the ledger."""
    import torch

    from heat_tpu_torch.core import memledger
    from heat_tpu_torch.core.communication import MeshCommunication

    card = torch.device("cuda", 0)
    out = {}
    for p in (1, MH_P):
        ht.utils.health.ping_mesh(MeshCommunication([card] * p))  # warm
        out[f"ping_{p}"] = ht.utils.health.ping_mesh(MeshCommunication([card] * p))
    rep = ht.utils.health.memory_report()
    led = memledger.ledger(top=0)
    out["memory_report_total"], out["ledger_total"] = rep["total_bytes"], led["total_bytes"]
    print(f"phase health: ping_mesh {json.dumps({k: v for k, v in out.items() if k.startswith('ping')})}; "
          f"memory_report total {rep['total_bytes']} B, the ledger's {led['total_bytes']} B", flush=True)
    if not all(out[f"ping_{p}"]["ok"] for p in (1, MH_P)) or rep["total_bytes"] != led["total_bytes"]:
        raise AssertionError("a mesh probe failed, or memory_report disagrees with the ledger")
    return out


_MH_FRESH_SCRIPT = """
import json, torch
import heat_tpu_torch as ht
from heat_tpu_torch.core import memledger
ht.telemetry.report()
memledger.ledger()
ht.flight.health_block()
print(json.dumps({"cuda_initialized": torch.cuda.is_initialized()}))
"""


def fresh_process_phase() -> dict:
    """(f) A fresh process reads report(), ledger() and the health block:
    CUDA stays uninitialized."""
    proc = subprocess.run([sys.executable, "-c", _MH_FRESH_SCRIPT], capture_output=True, text=True,
                          env=dict(os.environ, HEAT_TPU_TELEMETRY="1"),
                          cwd=os.path.dirname(os.path.abspath(__file__)), timeout=300)
    if proc.returncode:
        raise AssertionError(f"the fresh process failed: {proc.stderr[-2000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"phase health: a fresh process after report(), ledger() and ht.flight.health_block(): "
          f"{json.dumps(out)}", flush=True)
    if out["cuda_initialized"]:
        raise AssertionError("reading the memory and health surfaces initialized CUDA")
    return out


def health_path(ht, smi: str) -> dict:
    """Phase 17: memory and health on the card; returns its numbers
    (telemetry off again at the end)."""
    import torch

    from heat_tpu_torch.core import resilience as res
    from heat_tpu_torch.core import telemetry as tel

    numbers = {"card": smi, "seconds": {}}
    tmp = tempfile.mkdtemp(prefix="heat_mh_")
    was = tel.set_mode(0)
    try:
        x, init = kmeans_table(ht)
        t0 = time.perf_counter()
        numbers["fit"] = ledger_fit_phase(ht, tel, x, init)
        centres = numbers["fit"].pop("fitted_centres")
        numbers["seconds"]["fit"] = time.perf_counter() - t0
        for label, fn in (
            ("overhead", lambda: hooks_overhead_phase(ht, tel, x, init)),
            ("lm", lambda: ledger_lm_phase(ht, tel, x, tmp)),
            ("watchdog", lambda: watchdog_phase(ht, tel, res, centres, tmp)),
            ("probes", lambda: probes_phase(ht)),
            ("fresh_process", fresh_process_phase),
        ):
            t0 = time.perf_counter()
            numbers[label] = fn()
            numbers["seconds"][label] = time.perf_counter() - t0
            torch.cuda.empty_cache()
    finally:
        tel.set_mode(was)
        tel.reset()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"  phase 17 took {sum(numbers['seconds'].values()):.1f} s: {numbers['seconds']}", flush=True)
    return numbers


# ---------------------------------------------------------------------------
# the fusion recorder on the card (phase 18): no kernel of its own. A
# recorded chain is one program: its GraphModule through torch.compile
# (Inductor), built at the first force of its signature.
# ---------------------------------------------------------------------------
FU_WARM = 100  # warm chains of one signature: no build, no Dynamo graph added
FU_REPS = 20  # chains per CUDA-event timing
FU_P = 4  # shards of the card for the ragged chain
FU_RAGGED = (1_000_003, 16)  # 4 shards of 250,001 rows: one padding row
# Fused against eager, and the compiled program against its plain module:
# * element by element, on h (the chain before its sum), in units of
#   u = 2^-24 times each element's first-order error scale (_fu_scale: the
#   rounding of each op carried through the chain, the one sum that can
#   cancel included): a float32 implementation of the chain lies within 2
#   of the exact value (1.996 measured for ATen's on 10^6 elements against
#   float64, on the CPU), so two lie within FU_ULPS = 4 of each other; the
#   bfloat16 control lies ~1.6e5 away;
# * on the sum S = sum(h): |S_f - S_e| <= FU_SUM_TOL sum|h|. Elementwise
#   differences of a few u and the two reductions' orders (ATen's tree,
#   Inductor's split reduction) measured 0 at both sizes on an H100; the
#   bfloat16 control measured 7.486e-5 at 1,000 x 16 and 4.301e-5 on the
#   table, so the bound sits 4.3x under it: a sum that lost a term or ran
#   in a lower precision shows.
FU_SUM_TOL = 1e-5
FU_ULPS = 4
#: rows of the sweep of the 10-op chain over sizes (x 16 float32, two operands)
FU_SWEEP_ROWS = (1_000, 10_000, 100_000, 300_000, 1_000_000, 3_000_000, 10_000_000)
#: the eager chain's memory traffic, in operand-sized units (reads + writes)
#: per op: a+b, *2, exp, -b, abs, +a, abs, sqrt, +1, /, *b, then the sum
#: reading h once
FU_EAGER_UNITS = (3, 2, 2, 3, 2, 3, 2, 2, 2, 3, 3, 1)


def _fu_nine(ht, a, b):
    """The 10-op chain (tests/test_telemetry.py:28-38) before its sum."""
    c = (a + b) * 2.0
    c = ht.exp(c)
    c = c - b
    d = ht.abs(c)
    e = d + a
    f = ht.sqrt(ht.abs(e))
    g = f / (d + 1.0)
    return g * b


def _fu_bounds(n: int, f: int) -> dict:
    """The least device time of the chain, fused and eager: bytes over the
    card's memory rate (the operations, ~20 per element, are far under the
    float32 rate)."""
    unit = n * f * 4
    fused = 2 * unit + 4  # a and b read once, the scalar written
    eager = sum(FU_EAGER_UNITS) * unit + 4
    return {
        "fused_bytes": fused, "eager_bytes": eager,
        "fused_bound_ms": fused / HBM_BYTES_PER_S * 1e3, "eager_bound_ms": eager / HBM_BYTES_PER_S * 1e3,
    }


def _fu_nine_torch(a, b):
    """The chain before its sum in plain torch: the lower-precision control."""
    c = ((a + b) * 2.0).exp() - b
    d = c.abs()
    f = (d + a).abs().sqrt()
    return f / (d + 1.0) * b


def _fu_scale(a, b):
    """Per element, the size of the chain's first-order rounding error in
    units of u = 2^-24, in float64 from its float32 operands: exp's result
    E = e^(2(a + b)) carries an error of ~E (1 + 2|a + b|) u, c = E - b
    adds |b|; e = |c| + a, which can cancel, adds |a|; the square root
    divides e's error by 2 sqrt|e|; g = f / (|c| + 1) and h = g b pass the
    errors on and each add one rounding of their result."""
    a, b = a.double(), b.double()
    big = ((a + b) * 2.0).exp()
    c = big - b
    d = c.abs()
    e = d + a
    f = e.abs().sqrt()
    m_c = big * (1.0 + 2.0 * (a + b).abs()) + b.abs()
    h = f / (d + 1.0) * b
    return b.abs() * ((m_c + a.abs()) / (2.0 * f * (d + 1.0)) + f * m_c / (d + 1.0) ** 2) + h.abs()


def _fu_ulps(got, want, scale) -> float:
    """The largest |got - want| over all elements in units of u times the
    element's error scale (:func:`_fu_scale`): a few for two float32
    implementations of the chain, ~2^16 for a bfloat16 one."""
    import torch

    worst = 0.0
    for g, w, sc in zip(got, want, scale):
        # an element with b = 0 has h = 0 and a scale of 0 in every
        # implementation; a NaN anywhere counts as infinitely far
        ratio = (g.double() - w.double()).abs() / (sc * 2.0**-24).clamp_min(2.0**-1022)
        worst = max(worst, torch.nan_to_num(ratio, nan=math.inf).max().item())
    return worst


def _fu_unique_graphs() -> int:
    from torch._dynamo.utils import counters

    return int(counters["stats"]["unique_graphs"])


def _fu_degraded(fusion) -> int:
    return fusion.cache_stats()["degraded"]


def _fu_device_ms(ht, a, b) -> float:
    """Device ms per chain: FU_REPS chains forced (dispatched, never read)
    between two CUDA events."""
    import torch

    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ht.sum(_fu_nine(ht, a, b)).shards
    torch.cuda.synchronize()
    start.record()
    for _ in range(FU_REPS):
        ht.sum(_fu_nine(ht, a, b)).shards
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / FU_REPS


def _fu_sum_check(label, got, want, abs_sum) -> float:
    ratio = abs(got - want) / abs_sum
    if not ratio <= FU_SUM_TOL:
        raise AssertionError(f"{label}: |S - S_ref| / sum|h| = {ratio:.3e} over {FU_SUM_TOL}")
    return ratio


def fusion_chain_phase(ht, tel, fusion, x) -> dict:
    """(a) The 10-op chain at RT_SMALL and on the table, fused and eager."""
    import torch

    print(f"phase fusion: the 10-op chain at {RT_SMALL[0]} x {RT_SMALL[1]} and {N} x {F} float32, fused and "
          "with the recorder off", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 18)
    out = {}
    for label, shape, (a, b) in (
        ("small", RT_SMALL, [ht.array(torch.randn(RT_SMALL, generator=gen, device="cuda"), split=0) for _ in range(2)]),
        ("table", (N, F), (x, ht.array(torch.randn((N, F), generator=gen, device="cuda"), split=0))),
    ):
        rec = dict(_fu_bounds(*shape))
        degraded = _fu_degraded(fusion)
        # the first force of the signature builds the program
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        total = ht.sum(_fu_nine(ht, a, b))
        if not fusion.is_deferred(total):
            raise AssertionError("the chain did not defer")
        fused_value = float(total.larray)
        rec["first_build_s"] = time.perf_counter() - t0
        with fusion.disabled():
            h_eager = _fu_nine(ht, a, b)
            eager_value = float(ht.sum(h_eager).larray)
        abs_sum = h_eager.larray.double().abs().sum().item()
        rec["fused_vs_eager"] = _fu_sum_check(f"{label} fused vs eager", fused_value, eager_value, abs_sum)
        # the compiled program against its plain GraphModule on the same leaves
        pending = ht.sum(_fu_nine(ht, a, b))
        sig, leaves, _ = fusion._signature(pending._payload)
        prog = fusion._PROGRAMS[sig]
        flat = fusion._flat(leaves)
        compiled_value = prog.compiled(*flat)[0].item()
        plain_value = prog.gm(*flat)[0].item()
        rec["compiled_vs_plain"] = _fu_sum_check(f"{label} compiled vs plain", compiled_value, plain_value, abs_sum)
        if plain_value != eager_value:
            raise AssertionError(f"{label}: the plain GraphModule differs from the eager engines")
        del pending, flat, leaves
        # element by element, on the chain before its sum (a program of its
        # own): compiled against plain on the same leaves, the installed
        # result against the compiled one and against the eager engines
        h = _fu_nine(ht, a, b)
        sig, leaves, _ = fusion._signature(h._payload)
        flat = fusion._flat(leaves)
        fused_h = h.shards
        prog = fusion._PROGRAMS[sig]
        compiled_h, plain_h = prog.compiled(*flat), prog.gm(*flat)
        scale = [_fu_scale(a.larray, b.larray)]
        rec["h_installed_is_compiled"] = all(torch.equal(x, y) for x, y in zip(fused_h, compiled_h))
        rec["h_bit_for_bit"] = all(torch.equal(x, y) for x, y in zip(compiled_h, plain_h))
        rec["h_compiled_vs_plain_ulps"] = _fu_ulps(compiled_h, plain_h, scale)
        rec["h_fused_vs_eager_ulps"] = _fu_ulps(fused_h, h_eager.shards, scale)
        del h, flat, leaves, fused_h, compiled_h, plain_h
        # the control: the same chain in bfloat16, summed in float32
        h_low = _fu_nine_torch(a.larray.bfloat16(), b.larray.bfloat16()).float()
        rec["control_bf16_ulps"] = _fu_ulps([h_low], [h_eager.larray], scale)
        rec["control_bf16_sum_ratio"] = abs(h_low.sum().item() - eager_value) / abs_sum
        del h_low, h_eager, scale
        print(f"  {label}: h element by element, compiled vs plain {rec['h_compiled_vs_plain_ulps']:.3f} u of its "
              f"error scale (bit for bit: {rec['h_bit_for_bit']}), fused vs eager "
              f"{rec['h_fused_vs_eager_ulps']:.3f} (installed = compiled: {rec['h_installed_is_compiled']}); the "
              f"bf16 control {rec['control_bf16_ulps']:.3e}, its sum |S_c - S_e| / sum|h| "
              f"{rec['control_bf16_sum_ratio']:.3e}; fused vs eager sum {rec['fused_vs_eager']:.3e}, compiled vs "
              f"plain sum {rec['compiled_vs_plain']:.3e}", flush=True)
        if not (rec["h_installed_is_compiled"] and rec["h_compiled_vs_plain_ulps"] <= FU_ULPS
                and rec["h_fused_vs_eager_ulps"] <= FU_ULPS):
            raise AssertionError(f"{label}: the compiled chain differs from its plain version element by element")
        if not (rec["control_bf16_ulps"] > FU_ULPS and rec["control_bf16_sum_ratio"] > FU_SUM_TOL):
            raise AssertionError(f"{label}: the bf16 control passes the bounds: they cannot see a lower precision")
        # warm: one dispatch per chain, no build, no Dynamo graph added
        builds, graphs = fusion.cache_stats()["compiles"], _fu_unique_graphs()
        tel.set_mode(1)
        tel.reset()
        for _ in range(FU_WARM):
            ht.sum(_fu_nine(ht, a, b)).shards
        torch.cuda.synchronize()
        rec["warm_dispatches"] = tel.async_forcing()["dispatches"]
        rec["warm_engine_dispatches"] = tel.dispatches()
        tel.set_mode(0)
        rec["warm_builds"] = fusion.cache_stats()["compiles"] - builds
        rec["warm_dynamo_graphs"] = _fu_unique_graphs() - graphs
        fused_engine = sum(r["fused"] for r in rec["warm_engine_dispatches"].values())
        eager_engine = sum(r["eager"] for r in rec["warm_engine_dispatches"].values())
        if (rec["warm_dispatches"], rec["warm_builds"], rec["warm_dynamo_graphs"], fused_engine, eager_engine) != (
            FU_WARM, 0, 0, 12 * FU_WARM, 0
        ):
            raise AssertionError(f"{label}: the warm chains were not one fused dispatch each without a build: {rec}")
        # device time per chain and ops/s with a host read per chain
        rec["fused_ms"] = _fu_device_ms(ht, a, b)
        reps, trials = (RT_CHAIN_REPS, RT_CHAIN_TRIALS) if label == "small" else (RT_LARGE_REPS, RT_LARGE_TRIALS)
        rec["fused_ops_per_s"] = _rt_rate(ht, a, b, reps, trials)
        with fusion.disabled():
            rec["eager_ms"] = _fu_device_ms(ht, a, b)
            rec["eager_ops_per_s"] = _rt_rate(ht, a, b, reps, trials)
        if _fu_degraded(fusion) != degraded:
            raise AssertionError(f"{label}: a program degraded")
        print(
            f"  {label}: first build {rec['first_build_s']:.2f} s; device ms per chain fused {rec['fused_ms']:.4f} "
            f"(bound {rec['fused_bound_ms']:.4f}, {rec['fused_bytes'] / 1e9:.3f} GB) vs eager {rec['eager_ms']:.4f} "
            f"(bound {rec['eager_bound_ms']:.4f}, {rec['eager_bytes'] / 1e9:.3f} GB); ops/s fused "
            f"{rec['fused_ops_per_s']:.0f} vs eager {rec['eager_ops_per_s']:.0f}; |S_f - S_e| / sum|h| "
            f"{rec['fused_vs_eager']:.3e}, compiled vs plain {rec['compiled_vs_plain']:.3e}; {FU_WARM} warm chains: "
            f"{rec['warm_dispatches']} dispatches, {rec['warm_builds']} builds, {rec['warm_dynamo_graphs']} Dynamo graphs",
            flush=True,
        )
        out[label] = rec
    return out


def fusion_ragged_phase(ht, fusion) -> dict:
    """(b) Four shards of the card, NaN in the inputs' padding, against one
    shard: the logical rows and the row sums bit for bit, the column sums
    (across the split) finite and within the sum bound."""
    import torch

    from heat_tpu_torch.core.communication import MeshCommunication

    print(f"phase fusion: {FU_P} shards of the card, {FU_RAGGED[0]} x {FU_RAGGED[1]} float32 with NaN padding, "
          "against one shard", flush=True)
    degraded = _fu_degraded(fusion)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 181)
    xa, xb = (torch.randn(FU_RAGGED, generator=gen, device="cuda") for _ in range(2))
    mesh = MeshCommunication([torch.device("cuda", 0)] * FU_P)
    a4, b4 = ht.array(xa, split=0, comm=mesh), ht.array(xb, split=0, comm=mesh)
    pad = _poison_padding(a4) + _poison_padding(b4)
    a1, b1 = ht.array(xa, split=0), ht.array(xb, split=0)
    h4, h1 = _fu_nine(ht, a4, b4), _fu_nine(ht, a1, b1)
    rows4, rows1 = ht.sum(h4, axis=1), ht.sum(h1, axis=1)
    cols4, cols1 = ht.sum(h4, axis=0), ht.sum(h1, axis=0)
    if not all(fusion.is_deferred(t) for t in (h4, rows4, cols4)):
        raise AssertionError("the four-shard chain did not defer")
    block = -(-FU_RAGGED[0] // FU_P)
    shapes_ok = all(tuple(s.shape) == (block, FU_RAGGED[1]) for s in h4.shards)
    rows_equal = torch.equal(h4.larray, h1.larray) and torch.equal(rows4.larray, rows1.larray)
    abs_cols = h1.larray.double().abs().sum(dim=0)
    c4, c1 = cols4.larray.double(), cols1.larray.double()
    col_ratio = ((c4 - c1).abs() / abs_cols).max().item()
    out = {"padding_rows": pad, "shards_hold_blocks": shapes_ok, "rows_bit_for_bit": rows_equal,
           "cols_finite": bool(torch.isfinite(c4).all()), "cols_ratio": col_ratio}
    print(f"  {pad} NaN padding rows; shards of {block} rows: {shapes_ok}; logical rows and row sums equal one "
          f"shard's bit for bit: {rows_equal}; column sums finite: {out['cols_finite']}, max |d| / sum|h| "
          f"{col_ratio:.3e}", flush=True)
    if not (shapes_ok and rows_equal and out["cols_finite"] and col_ratio <= FU_SUM_TOL):
        raise AssertionError("the four-shard chain differs from one shard's, or let the padding in")
    if _fu_degraded(fusion) != degraded:
        raise AssertionError("the four-shard chain degraded")
    return out


def fusion_sync_phase(ht, tel, fusion, x) -> dict:
    """(c) No host sync in a warm fused chain before its read, on the table
    and on four shards; at most one at the read."""
    import warnings

    import torch

    from heat_tpu_torch.core.communication import MeshCommunication

    print("phase fusion: warm fused chains under set_sync_debug_mode('error') until the read, one sync at it",
          flush=True)
    degraded = _fu_degraded(fusion)
    x4 = ht.array(x.larray[:FU_RAGGED[0]], split=0, comm=MeshCommunication([torch.device("cuda", 0)] * FU_P))
    for z in (x, x4):
        ht.sum(_fu_nine(ht, z, z)).shards  # built before the checked region
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = [ht.sum(_fu_nine(ht, z, z)) for z in (x, x4)]
        for s in pending:
            s.shards  # forced: dispatched, not read
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = []
    tel.set_mode(1)
    tel.reset()
    for s in pending:
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                s.item()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        syncs.append(sum("synchroniz" in str(w.message) for w in caught))
    blocking = tel.async_forcing()["blocking_total"]
    tel.set_mode(0)
    out = {"syncs_at_read": syncs, "blocking_syncs": blocking}
    print(f"  no sync before the reads; syncs at each read {syncs}; blocking syncs counted {blocking}", flush=True)
    if max(syncs) > 1 or blocking != len(pending):
        raise AssertionError("a fused chain's read took more than one sync")
    if _fu_degraded(fusion) != degraded:
        raise AssertionError("the synced chain degraded")
    return out


def fusion_fit_phase(ht, fusion, x, init) -> dict:
    """(d) Phase 3's fit with the recorder on: 30 Lloyd launches, and the
    fit with the recorder off equal bit for bit (no engine op lies on the
    fit's loop: it streams the shards through the kernel and reduces with
    torch)."""
    import torch

    from heat_tpu_torch.ops import lloyd

    print(f"phase fusion: KMeans(n_clusters={K}) for {ITERS} iterations from phase 3's centres with the recorder "
          "on and off", flush=True)
    degraded = _fu_degraded(fusion)
    lloyd.LAUNCHES = 0
    on = ht.cluster.KMeans(n_clusters=K, init=init, max_iter=ITERS, tol=-1.0).fit(x)
    torch.cuda.synchronize()
    launches = lloyd.LAUNCHES
    with fusion.disabled():
        off = ht.cluster.KMeans(n_clusters=K, init=init, max_iter=ITERS, tol=-1.0).fit(x)
    out = {
        "launches": launches,
        "labels_equal": torch.equal(on.labels_.larray, off.labels_.larray),
        "centres_bit_for_bit": torch.equal(on.cluster_centers_.larray, off.cluster_centers_.larray),
        "inertia_equal": on.inertia_ == off.inertia_,
    }
    print(f"  Lloyd launches {launches}; labels equal {out['labels_equal']}; centres bit for bit "
          f"{out['centres_bit_for_bit']}; inertia equal {out['inertia_equal']}", flush=True)
    if launches != ITERS or not (out["labels_equal"] and out["centres_bit_for_bit"] and out["inertia_equal"]):
        raise AssertionError("the fit with the recorder on missed the kernel or differs from the fit without it")
    if _fu_degraded(fusion) != degraded:
        raise AssertionError("a program of the fit degraded")
    return out


def fusion_faults_phase(ht, tel, fusion, tmp: str) -> dict:
    """(e) fusion.compile, fusion.execute and memory.exhausted injected on
    the chain at three shapes of its own: each degrades to the eager result
    bit for bit, quarantines its signature and auto-dumps a bundle whose
    trace validates (memory.exhausted writes the OOM forensic first); a
    budget under the chain's static peak raises MemoryBudgetExceeded under
    ``raise`` with the chain left pending."""
    import warnings

    import torch

    from heat_tpu_torch.core import health_runtime as hr
    from heat_tpu_torch.core import memledger as ml
    from heat_tpu_torch.core import resilience as res

    print("phase fusion: fusion.compile, fusion.execute and memory.exhausted injected; a budget under the static "
          "peak under 'raise'", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 182)
    prev_dir = hr.set_dump_dir(tmp)
    out = {}
    tel.set_mode(1)
    try:
        for i, site in enumerate(("fusion.compile", "fusion.execute", "memory.exhausted")):
            tel.reset()  # the auto-dump's throttle is per reason, and restarts here
            where = os.path.join(tmp, site)  # a directory each: the dumps' numbering restarts too
            os.makedirs(where)
            hr.set_dump_dir(where)
            rows = RT_SMALL[0] + 1 + i
            a, b = (ht.array(torch.randn((rows, RT_SMALL[1]), generator=gen, device="cuda"), split=0) for _ in range(2))
            with fusion.disabled():
                want = ht.sum(_fu_nine(ht, a, b)).larray.clone()
            if site == "fusion.execute":
                ht.sum(_fu_nine(ht, a, b)).shards  # the program is built and cached first
            stats = fusion.cache_stats()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                with res.inject(site, times=1) as spec:
                    got = ht.sum(_fu_nine(ht, a, b)).larray
            after = fusion.cache_stats()
            # the bundles this fault wrote: "degrade", and "oom" before it
            bundles = [
                os.path.join(where, name) for name in os.listdir(where)
                if name.endswith(".json") and not name.endswith(".trace.json")
            ]
            reasons, problems = [], []
            for path in bundles:
                with open(path) as fh:
                    bundle = json.load(fh)
                reasons.append(bundle["reason"])
                problems += bundle["trace_problems"] + tel.validate_trace(bundle["trace_path"])
            oom = ml.last_oom() if site == "memory.exhausted" else None
            rec = {
                "fired": spec.fired,
                "bit_for_bit": torch.equal(got, want),
                "degraded": after["degraded"] - stats["degraded"],
                "quarantined": after["quarantined"] - stats["quarantined"],
                "dumps": sorted(reasons),
                "dump_problems": problems,
                "warned": sorted({w.category.__name__ for w in caught}),
            }
            if oom is not None:
                rec["oom_program"] = oom["program"]
                rec["oom_names_owners"] = bool(oom["by_owner"])
            out[site] = rec
            print(f"  {site}: {json.dumps(rec)}", flush=True)
            ok = rec["fired"] == 1 and rec["bit_for_bit"] and rec["degraded"] == 1 and rec["quarantined"] == 1
            ok = ok and not rec["dump_problems"] and "DegradedDispatchWarning" in rec["warned"]
            if site == "memory.exhausted":
                ok = ok and rec["oom_program"] and rec["oom_names_owners"] and "MemoryExhaustedWarning" in rec["warned"]
                ok = ok and rec["dumps"] == ["degrade", "oom"]
            else:
                ok = ok and rec["dumps"] == ["degrade"]
            if not ok:
                raise AssertionError(f"{site}: the injected fault did not degrade as it should")
        degraded = _fu_degraded(fusion)
        a, b = (ht.array(torch.randn(RT_SMALL, generator=gen, device="cuda"), split=0) for _ in range(2))
        pending = ht.sum(_fu_nine(ht, a, b))
        prev = ml.set_budget(1, "raise")
        try:
            try:
                pending.shards
                raised = False
            except ml.MemoryBudgetExceeded:
                raised = True
            left_pending = fusion.is_deferred(pending)
        finally:
            ml.set_budget(*prev)
        with fusion.disabled():
            want = ht.sum(_fu_nine(ht, a, b)).larray.item()
        value = pending.larray.item()
        out["budget"] = {"raised": raised, "left_pending": left_pending, "read_after": value,
                         "ratio_to_eager": abs(value - want) / max(abs(want), 1e-30)}
        print(f"  budget of 1 byte under 'raise': raised {raised}, chain left pending {left_pending}, read after "
              f"the budget was lifted {value:.6e} (eager {want:.6e})", flush=True)
        if not (raised and left_pending) or _fu_degraded(fusion) != degraded:
            raise AssertionError("the memory gate did not refuse the dispatch with the chain intact")
    finally:
        tel.set_mode(0)
        tel.reset()
        hr.set_dump_dir(prev_dir)
    return out


def fusion_telemetry_phase(ht, tel, fusion, tmp: str) -> dict:
    """(f) Verbose telemetry over a fresh chain: the report's six fusion
    blocks, the health block's dispatch and compile histograms, and the
    exported trace validated with its dispatch-to-sync pairs."""
    import torch

    print("phase fusion: the report's fusion blocks, the dispatch and compile histograms, the trace's pairs",
          flush=True)
    degraded = _fu_degraded(fusion)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 183)
    tel.set_mode(2)
    tel.reset()
    try:
        a, b = (ht.array(torch.randn((RT_SMALL[0] + 7, RT_SMALL[1]), generator=gen, device="cuda"), split=0)
                for _ in range(2))
        for _ in range(3):
            ht.sum(_fu_nine(ht, a, b)).item()
        rep = tel.report()
        path = os.path.join(tmp, "fusion_trace.json")
        doc = tel.export_trace(path)
        problems = tel.validate_trace(path)
    finally:
        tel.set_mode(0)
        tel.reset()
    blocks = ("fusion_cache", "programs", "forcing_points", "unfused_reasons", "retraces", "degraded")
    pairs = sum(1 for e in doc["traceEvents"] if e["ph"] == "b")
    out = {
        "blocks": {k: k in rep for k in blocks},
        "forcing_points": rep["forcing_points"],
        "dispatch_hist": rep["health"]["dispatch"].get("*", {}).get("count", 0),
        "compile_hist": rep["health"]["compile"].get("*", {}).get("count", 0),
        "trace_pairs": pairs,
        "trace_problems": problems,
    }
    print(f"  {json.dumps(out)}", flush=True)
    if not (all(out["blocks"].values()) and out["dispatch_hist"] >= 1 and out["compile_hist"] >= 1
            and pairs >= 3 and not problems):
        raise AssertionError("the fusion telemetry on the card is incomplete")
    if _fu_degraded(fusion) != degraded:
        raise AssertionError("a program degraded under verbose telemetry")
    return out


def fusion_sweep_phase(ht, tel, fusion, default: int) -> dict:
    """(g) The 10-op chain over sizes, ops/s with a host read per chain:
    recorded at every size, with the recorder off, and with the card's
    default, under which operands smaller than ``default`` bytes together
    run eagerly (``small_on_card``); at each size which of the two the
    default chose, and the one-op programs' plain run (no build)."""
    import torch

    print(f"phase fusion: the 10-op chain at {list(FU_SWEEP_ROWS)} x {F} float32, ops/s recorded, eager and by "
          f"the default (operands under {default} B eager)", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 184)
    out = {}
    for rows in FU_SWEEP_ROWS:
        a, b = (ht.array(torch.randn((rows, F), generator=gen, device="cuda"), split=0) for _ in range(2))
        reps, trials = (RT_CHAIN_REPS, RT_CHAIN_TRIALS) if rows <= 1_000_000 else (RT_LARGE_REPS, RT_LARGE_TRIALS)
        rec = {"operand_bytes": a.nbytes + b.nbytes}
        rates = {"recorded": [], "eager": [], "default": []}
        for leg in ("recorded", "eager", "default", "default", "eager", "recorded"):  # the host drifts: in turns
            fusion._EAGER_BELOW_BYTES = 0 if leg == "recorded" else default
            if leg == "eager":
                with fusion.disabled():
                    rates[leg].append(_rt_rate(ht, a, b, reps, trials))
            else:
                rates[leg].append(_rt_rate(ht, a, b, reps, trials))
        rec.update({leg: max(r) for leg, r in rates.items()})
        fusion._EAGER_BELOW_BYTES = default
        rec["default_records"] = fusion.is_deferred(a + b)
        fusion._EAGER_BELOW_BYTES = 0
        out[rows] = rec
        print(f"  {rows} x {F} ({rec['operand_bytes']} B): ops/s recorded {rec['recorded']:.0f}, eager "
              f"{rec['eager']:.0f}, default {rec['default']:.0f} ({'recorded' if rec['default_records'] else 'eager'})",
              flush=True)
        del a, b
    # one op has nothing to fuse: its program runs the eager op, no build
    before = _fu_unique_graphs()
    y = ht.array(torch.randn((N, F), generator=gen, device="cuda"), split=0)
    total = ht.sum(y, axis=0)
    if not fusion.is_deferred(total):
        raise AssertionError("the one-op sum did not record")
    with fusion.disabled():
        want = ht.sum(y, axis=0).larray
    out["one_op"] = {"dynamo_graphs": _fu_unique_graphs() - before, "bit_for_bit": torch.equal(total.larray, want)}
    print(f"  a one-op program (sum over {N} x {F}): {json.dumps(out['one_op'])}", flush=True)
    if out["one_op"] != {"dynamo_graphs": 0, "bit_for_bit": True}:
        raise AssertionError("a one-op program was built by Inductor or differs from the eager op")
    return out


def fusion_path(ht, smi: str) -> dict:
    """Phase 18: the fusion recorder on the card; returns its numbers (the
    recorder is left off again at the end)."""
    import torch

    from heat_tpu_torch.core import fusion
    from heat_tpu_torch.core import telemetry as tel

    numbers = {"card": smi, "seconds": {}, "torch": torch.__version__}
    tmp = tempfile.mkdtemp(prefix="heat_fu_")
    was = fusion.set_enabled(True)
    default = fusion._EAGER_BELOW_BYTES
    tel.set_mode(0)
    fusion.clear_cache()
    try:
        x, init = kmeans_table(ht)
        # the recorder's own checks record at every size; the sweep then
        # measures where the card's default (small operands eager) stands
        fusion._EAGER_BELOW_BYTES = 0
        for label, fn in (
            ("chain", lambda: fusion_chain_phase(ht, tel, fusion, x)),
            ("ragged", lambda: fusion_ragged_phase(ht, fusion)),
            ("sync", lambda: fusion_sync_phase(ht, tel, fusion, x)),
            ("fit", lambda: fusion_fit_phase(ht, fusion, x, init)),
            ("faults", lambda: fusion_faults_phase(ht, tel, fusion, tmp)),
            ("telemetry", lambda: fusion_telemetry_phase(ht, tel, fusion, tmp)),
            ("sweep", lambda: fusion_sweep_phase(ht, tel, fusion, default)),
        ):
            t0 = time.perf_counter()
            numbers[label] = fn()
            numbers["seconds"][label] = time.perf_counter() - t0
            torch.cuda.empty_cache()
        numbers["cache"] = {k: v for k, v in fusion.cache_stats().items() if k != "program_keys"}
    finally:
        fusion._EAGER_BELOW_BYTES = default
        fusion.set_enabled(was)
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"  phase 18 took {sum(numbers['seconds'].values()):.1f} s: {numbers['seconds']}", flush=True)
    return numbers


# ---------------------------------------------------------------------------
# the recorder's collective half on four shards of the card (phase 19): no
# kernel of its own. A collective of a pending chain records a node of it,
# and a force batches the small live roots into one program. Every item runs
# three legs: the collective nodes on (the default), off (each collective
# forces its chain) and the recorder off; each leg's first call builds, the
# second is timed by CUDA events and counted by telemetry.
# ---------------------------------------------------------------------------
FC_P = 4
# BASELINE config 4's 512 columns; its 10^7 rows cut to 2.5·10^6 (5.1 GB
# float32) so that four shards, Q and the chain's intermediates fit in 80 GB
FC_QR_SHAPE = (2_500_000, 512)
FC_CONV_N, FC_CONV_TAPS = 100_000_000, 9
FC_CG_N = 8_192  # a replicated SPD matrix of 268 MB, above the 192 MiB rule
FC_LEGS = ("on", "off", "eager")
FC_REPS = 2  # timed calls per leg after the first; the median is kept
# Tolerances of the legs against each other. The programs of the three legs
# cut one chain into other Inductor programs, which may round otherwise
# (an FMA contracted, a reduction split differently):
# * moments: |on - off| <= 1e-5 |off| + 1e-6, and each against float64
#   within 1e-4 relative (10^7-row float32 sums in any order);
# * the z-score chain through the resplits: |on - off| <= 8 u (1 + |z|)
#   elementwise (z = (x - m) / s rounds once per op; m and s within a few u);
# * argmax/argmin: exact (integer results; the maxima of random columns
#   are unique);
# * matmul: on against off within FC_ZSCORE_UNITS u of the factors' spread
#   (see the item), each leg against float64 within FC_MATMUL_F64_UNITS
#   u |A||B| elementwise, a bound that a product of bf16 factors must fail;
# * convolve: phase 15's bound, |c - c64| <= (k + 1) u (|v| * |a|);
# * CG: ‖b - A x‖ / ‖b‖ <= 1e-4 in float64 (float32 CG of a matrix of
#   condition ~5).
FC_ZSCORE_UNITS = 8
FC_CG_RESIDUAL = 1e-4
# about 6x the largest reading on an H100 80GB HBM3 at 700 W (10.8 u|A||B|,
# zᵀ z with the recorder off; 4.7 and 5.8 on and off), about 700x under
# the bf16 control's (4.5e4 and 9.5e4 u|A||B|); a zeroed off-diagonal entry
# of zᵀ z sits near 8e3
FC_MATMUL_F64_UNITS = 64


def _fc_leg(fusion, tel, leg: str, fn, check_pending=None) -> tuple:
    """One leg of an item: its first call (the builds), then FC_REPS calls
    each forced between CUDA events, the first with telemetry counting.
    Returns (outputs of the last call, numbers with the median ms)."""
    import contextlib

    import torch

    ctx = {"on": contextlib.nullcontext, "off": fusion.collectives_disabled, "eager": fusion.disabled}[leg]()
    with ctx:
        builds, degraded = _fu_unique_graphs(), _fu_degraded(fusion)
        out = fn()
        if check_pending is not None and leg == "on":
            check_pending(out)
        _dispatched(out)
        torch.cuda.synchronize()
        builds = _fu_unique_graphs() - builds
        del out
        times = []
        for rep in range(FC_REPS):
            mode = tel.set_mode(1 if rep == 0 else 0)
            tel.reset()
            try:
                start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                out = None
                start.record()
                out = _dispatched(fn())
                stop.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(stop))
                if rep == 0:
                    stats, reasons = tel.async_forcing(), tel.unfused_reasons()
            finally:
                tel.set_mode(mode)
                tel.reset()
        degraded = _fu_degraded(fusion) - degraded
    numbers = {
        "ms": sorted(times)[len(times) // 2], "dispatches": stats["dispatches"], "roots": stats["roots_dispatched"],
        "multi_root_batches": stats["multi_root_batches"], "builds": builds, "degraded": degraded,
    }
    if reasons.get("op"):
        numbers["declined"] = reasons["op"]
    if degraded:
        raise AssertionError(f"collectives {leg}: {degraded} programs degraded")
    return out, numbers


def _fc_item(fusion, tel, label: str, fn, nbytes: float, check_pending=None) -> tuple:
    """The three legs of one item, printed beside its bytes bound; returns
    ({leg: outputs}, numbers)."""
    import torch

    outs, numbers = {}, {"bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    for leg in FC_LEGS:
        outs[leg], numbers[leg] = _fc_leg(fusion, tel, leg, fn, check_pending)
        torch.cuda.empty_cache()
    print(
        f"  {label}: bound {numbers['bound_ms']:.3f} ms; " + "; ".join(
            f"{leg} {numbers[leg]['ms']:.3f} ms, {numbers[leg]['dispatches']} dispatches "
            f"({numbers[leg]['roots']} roots, {numbers[leg]['multi_root_batches']} batched), {numbers[leg]['builds']} builds"
            for leg in FC_LEGS
        ),
        flush=True,
    )
    return outs, numbers


def _fc_pending(*names):
    """A check that every output of the on leg's first call is pending."""
    from heat_tpu_torch.core import fusion

    def check(out):
        for name, o in zip(names, out if isinstance(out, (tuple, list)) else (out,)):
            if not fusion.is_deferred(o):
                raise AssertionError(f"{name} is not pending before its read")

    return check


def _fc_zscore(ht, x):
    return (x - ht.mean(x, axis=0)) / ht.std(x, axis=0)


def fused_collectives_path(ht, smi: str) -> dict:
    """Phase 19: the recorder's collective half on four shards of the card;
    returns its numbers."""
    import torch

    from heat_tpu_torch.core import fusion
    from heat_tpu_torch.core import telemetry as tel
    from heat_tpu_torch.core.communication import MeshCommunication

    card = torch.device("cuda", 0)
    mesh = MeshCommunication([card] * FC_P)
    numbers = {"card": smi, "seconds": {}}
    print(f"phase collectives: the recorder's collective nodes on {FC_P} shards of the card", flush=True)
    if not (fusion.active() and fusion.collectives_active()):
        raise AssertionError("the recorder or its collective nodes are off by default")
    x, _ = kmeans_table(ht)
    x = ht.array(x.larray, split=0, comm=mesh)
    table_bytes = x.nbytes
    t0 = time.perf_counter()

    # 1. the moments of config 3's table: one program of three roots
    outs, numbers["moments"] = _fc_item(
        fusion, tel, f"mean, var, std along axis 0 of {N} x {F} float32",
        lambda: (ht.mean(x, axis=0), ht.var(x, axis=0), ht.std(x, axis=0)), table_bytes,
        _fc_pending("mean", "var", "std"),
    )
    on = numbers["moments"]["on"]
    if (on["dispatches"], on["roots"], on["multi_root_batches"]) != (1, 3, 1):  # tests/test_fused_collectives.py:79-81
        raise AssertionError(f"moments: {on['dispatches']} dispatches of {on['roots']} roots, {on['multi_root_batches']} batched")
    x64 = x.larray.double()
    want64 = (x64.mean(0), x64.var(0), x64.std(0))
    worst = 0.0
    for got_on, got_off, ref in zip(outs["on"], outs["off"], want64):
        a, b = got_on.larray.double(), got_off.larray.double()
        if not bool(((a - b).abs() <= 1e-5 * b.abs() + 1e-6).all()):
            raise AssertionError("moments: the collective leg differs from the collectives-off leg")
        worst = max(worst, ((a - ref).abs() / ref.abs()).max().item())
    del x64, outs
    if worst > 1e-4:
        raise AssertionError(f"moments: {worst:.3e} from float64")
    numbers["moments"]["max_rel_err_f64"] = worst

    # 2. a chain through two resplits, pending throughout
    def resplit_chain():
        z = _fc_zscore(ht, x)
        z.resplit_(1)
        s = ht.sum(z * z, axis=0)
        z.resplit_(0)
        return z, s

    outs, numbers["resplit_chain"] = _fc_item(
        fusion, tel, "z-score, resplit_(1), column sums, resplit_(0)", resplit_chain, 2 * table_bytes,
        _fc_pending("z", "column sums"),
    )
    (z_on, s_on), (z_off, s_off) = outs["on"], outs["off"]
    bitwise = all(torch.equal(a, b) for a, b in zip(z_on.shards, z_off.shards)) and torch.equal(s_on.larray, s_off.larray)
    dz = ((z_on.larray - z_off.larray).abs() / (U32 * (1 + z_off.larray.abs()))).max().item()
    numbers["resplit_chain"].update(bitwise=bitwise, max_units=dz, split=z_on.split)
    print(f"    shards equal to the collectives-off leg bit for bit: {bitwise}; max |dz| {dz:.2f} u (1 + |z|)", flush=True)
    if z_on.split != 0 or dz > FC_ZSCORE_UNITS:
        raise AssertionError(f"resplit chain: split {z_on.split}, {dz:.2f} u from the collectives-off leg")
    del outs, z_on, s_on, z_off, s_off

    # 3. argmax/argmin along the split axis
    outs, numbers["argreduce"] = _fc_item(
        fusion, tel, "argmax, argmin along the split axis", lambda: (ht.argmax(x, axis=0), ht.argmin(x, axis=0)),
        table_bytes, _fc_pending("argmax", "argmin"),
    )
    for leg in ("on", "off"):
        for got, want in zip(outs[leg], outs["eager"]):
            if not torch.equal(got.larray, want.larray):
                raise AssertionError(f"argmax/argmin, collectives {leg}: indices differ from the eager leg")
    del outs

    # 4. matmul: the pending z-scored table @ a replicated W, and Zᵀ Z
    gen = torch.Generator(device="cuda").manual_seed(SEED + 19)
    w = ht.array(torch.randn(F, F, generator=gen, device="cuda"), comm=mesh)

    def products():
        z = _fc_zscore(ht, x)
        y = ht.matmul(z, w)
        if fusion.collectives_active() and not (fusion.is_deferred(y) and y.split == 0):
            raise AssertionError("z @ W is not pending at split 0")
        return y, ht.matmul(z.T, z)

    outs, numbers["matmul"] = _fc_item(fusion, tel, "z @ W (16 x 16) and zᵀ z", products, 2 * table_bytes)
    if outs["on"][0].split != 0 or outs["on"][1].split is not None:
        raise AssertionError("matmul: the case table's splits")
    z64 = _fc_zscore(ht, x).larray.double()
    w64 = w.larray.double()
    for i, (label, a64, b64, w_exact) in enumerate((("z @ W", z64, w64, True), ("zᵀ z", z64.T, z64, False))):
        on, off = outs["on"][i].larray, outs["off"][i].larray
        exact, mag = a64 @ b64, U32 * (a64.abs() @ b64.abs())  # u |A||B|
        # on against off: both legs run the same per-shard products and
        # combine order, on factors that differ by at most FC_ZSCORE_UNITS
        # u (1 + |z|) elementwise (the resplit chain's bound); W is a leaf
        spread = (a64.abs() + 1) @ b64.abs() + (0 if w_exact else a64.abs() @ (b64.abs() + 1))
        d_on_off = (on.double() - off.double()).abs()
        check_within(f"matmul {label}, on against off", on, off, FC_ZSCORE_UNITS * U32 * spread)
        units = {leg: ((outs[leg][i].larray.double() - exact).abs() / mag).max().item() for leg in FC_LEGS}
        # the control: the same product from bf16 factors, which the
        # float64 bound must refuse
        control = ((a64.float().bfloat16() @ b64.float().bfloat16()).double() - exact).abs()
        control_units = (control / mag).max().item()
        for leg, got in units.items():
            if got > FC_MATMUL_F64_UNITS:
                raise AssertionError(f"matmul {label}, collectives {leg}: {got:.3e} u |A||B| from float64")
        if control_units <= FC_MATMUL_F64_UNITS:
            raise AssertionError(f"matmul {label}: the bf16 control passes the float64 bound ({control_units:.3e} u |A||B|)")
        numbers["matmul"][label] = {
            "bitwise_on_off": torch.equal(on, off), "on_off_units": (d_on_off / mag).max().item(),
            "f64_units": units, "bf16_control_units": control_units,
        }
        print(f"    {label}: on equal to off bit for bit {numbers['matmul'][label]['bitwise_on_off']}, max |on - off| "
              f"{numbers['matmul'][label]['on_off_units']:.3e} u |A||B|; from float64 in u |A||B| {units} "
              f"(bound {FC_MATMUL_F64_UNITS}), the bf16 control {control_units:.3e}", flush=True)
        del exact, mag, spread, d_on_off, control
    del outs, z64, w64

    # 5. QR: a pending column scale into CholQR2 (one multi-output node) and TSQR
    m, n = FC_QR_SHAPE
    base = ht.array(torch.randn(m, n, generator=gen, device="cuda"), split=0, comm=mesh)
    scale = ht.array(torch.linspace(0.5, 2.0, n, device="cuda"), comm=mesh)
    qr_bytes = 2 * base.nbytes
    numbers["qr"] = {}
    for method in ("cholqr2", "tsqr"):
        check = _fc_pending("Q", "R") if method == "tsqr" else None
        outs, numbers["qr"][method] = _fc_item(
            fusion, tel, f"qr(method={method!r}) of a column scale of {m} x {n}",
            lambda: ht.linalg.qr(base * scale, method=method), qr_bytes, check,
        )
        a = (base * scale).larray
        for leg in FC_LEGS:
            errs = qr_errors(a, outs[leg][0].larray, outs[leg][1].larray)
            check_qr(f"{method}, collectives {leg}", errs, n)
            numbers["qr"][method][leg].update(errs)
        print(f"    residual {numbers['qr'][method]['on']['residual']:.3e}, orthogonality "
              f"{numbers['qr'][method]['on']['orthogonality']:.3e} (collectives on)", flush=True)
        del outs, a
        torch.cuda.empty_cache()
    del base, scale

    # 6. convolve over the deferred halo
    import torch.nn.functional as Fn

    sig = ht.array(torch.randn(FC_CONV_N, generator=gen, device="cuda"), split=0, comm=mesh)
    taps = ht.array(torch.randn(FC_CONV_TAPS, generator=gen, device="cuda"), comm=mesh)
    outs, numbers["convolve"] = _fc_item(
        fusion, tel, f"convolve of a pending {FC_CONV_N} float32 with {FC_CONV_TAPS} taps",
        lambda: ht.convolve(sig * 0.5 + 1.0, taps), 2 * sig.nbytes, _fc_pending("convolve"),
    )
    k = FC_CONV_TAPS
    a64 = (sig * 0.5 + 1.0).larray.double()
    flipped = taps.larray.double().flip(0)[None, None]
    full64 = Fn.conv1d(a64[None, None], flipped, padding=k - 1)[0, 0]
    mag64 = Fn.conv1d(a64.abs()[None, None], flipped.abs(), padding=k - 1)[0, 0]
    errs = {}
    for leg in FC_LEGS:
        errs[leg] = ((outs[leg].larray.double() - full64).abs() / ((k + 1) * U32 * mag64 + 1e-30)).max().item()
    bitwise = torch.equal(outs["on"].larray, outs["off"].larray)
    numbers["convolve"].update(error_over_bound=errs, bitwise_on_off=bitwise)
    print(f"    error over the bound {errs}; on equal to off bit for bit: {bitwise}", flush=True)
    if max(errs.values()) > 1.0:
        raise AssertionError(f"convolve: error over its bound {errs}")
    del outs, a64, full64, mag64, sig, taps
    torch.cuda.empty_cache()

    # 7. CG on a replicated SPD matrix above the 192 MiB rule
    c = FC_CG_N
    mat = torch.randn(c, c, generator=gen, device="cuda")
    spd = ht.array(mat @ mat.T / c + torch.eye(c, device="cuda"), comm=mesh)
    rhs = ht.array(torch.randn(c, generator=gen, device="cuda"), comm=mesh)
    x0 = ht.zeros((c,), comm=mesh)
    del mat
    outs, numbers["cg"] = _fc_item(fusion, tel, f"cg on a {c} x {c} SPD float32", lambda: ht.linalg.cg(spd, rhs, x0), spd.nbytes)
    declined = numbers["cg"]["on"].get("declined")
    print(f"    recording declined: {declined}", flush=True)
    if declined != {"cg_unrolled_loop": 1}:
        raise AssertionError(f"cg: declined {declined}")
    a64, b64 = spd.larray.double(), rhs.larray.double()
    for leg in FC_LEGS:
        res = (torch.linalg.vector_norm(b64 - a64 @ outs[leg].larray.double()) / torch.linalg.vector_norm(b64)).item()
        numbers["cg"][leg]["residual"] = res
        if not res <= FC_CG_RESIDUAL:
            raise AssertionError(f"cg, collectives {leg}: residual {res:.3e}")
    del outs, a64, b64, spd, rhs, x0, x
    torch.cuda.empty_cache()
    numbers["seconds"]["items"] = time.perf_counter() - t0
    print(f"  phase 19's items took {numbers['seconds']['items']:.1f} s", flush=True)
    return numbers


def four_shard_paths(ht, paths: dict) -> dict:
    """Phase 19, second part: the earlier four-shard paths again, each
    through ``recorded_path`` with the collective nodes on (the default),
    for their programs, builds and multi-root batches. Returns the Lloyd
    and pairwise launches of each, counted at the wrappers' launch
    function (the paths zero the ``LAUNCHES`` counters themselves)."""
    import torch

    from heat_tpu_torch.core import fusion
    from heat_tpu_torch.core import telemetry as tel
    from heat_tpu_torch.ops import lloyd, pairwise

    counts = {"lloyd": 0, "pairwise": 0}
    originals = {mod: mod._launch for mod in (lloyd, pairwise)}

    def counted(mod, name):
        def launch(*args, **kwargs):
            counts[name] += 1
            return originals[mod](*args, **kwargs)

        return launch

    launches = {}
    lloyd._launch, pairwise._launch = counted(lloyd, "lloyd"), counted(pairwise, "pairwise")
    try:
        z = ht.array(torch.randn(1000 * 1000, generator=torch.Generator("cuda").manual_seed(SEED), device="cuda"), split=0)
        for label, fn in (
            ("four_shard_moments", lambda: moments_mesh_phase(ht, z)),
            ("four_shard_linalg", lambda: linalg_mesh_phase(ht)),
            ("four_shard_layer", lambda: layer_mesh_phase(ht)),
            ("four_shard_runtime_collectives", lambda: collectives_phase(ht, tel)),
            ("four_shard_distance_rings", lambda: distance_ring_phase(ht)),
            ("four_shard_fit", lambda: estimators_mesh_phase(ht)),
        ):
            before = dict(counts)
            recorded_path(fusion, paths, label, fn)
            launches[label] = {k: counts[k] - before[k] for k in counts}
            print(f"  {label}: {launches[label]['lloyd']} Lloyd and {launches[label]['pairwise']} pairwise launches",
                  flush=True)
    finally:
        for mod, fn in originals.items():
            mod._launch = fn
    return launches


# ---------------------------------------------------------------------------
# the numerics lens and the serving layer (phase 20): no kernel of their
# own; the LM steps run B3 and the ninth tenant's fit B1. Everything runs
# through the recorder: the lens samples at its dispatch seam, and a session
# gates and bills there. On the card only operands of 192 MiB or more record
# (fusion._EAGER_BELOW_BYTES) and only roots of at most 16 KiB batch across
# sessions, so the tenants read small results of 640 MB tables.
# ---------------------------------------------------------------------------
NS_REPS = 16  # chains per lens mode timed (the sample mode samples 1 of 16)
NS_RAGGED = (4_000_003, 16)  # 4 shards of 1,000,001 rows, 256 MB: one padding row
NS_NANS = 7  # NaNs written into its logical rows
NS_TENANTS = 8
NS_ROUNDS = 20
NS_LM_STEPS = 3
# Bounds of phase 20:
# * the lens's counts (nonfinite, subnormal) and its exponent histogram
#   against a float64 computation that reads no bits (frexp's exponent):
#   exact; absmax exact (a maximum rounds nothing); rms within
#   NS_RMS_ULPS float32 ULPs of the float64 value: a float32 sum of up to
#   1.6·10^8 squares in a tree order errs by at most ~log2(n) u ~ 28 u,
#   then a division and a square root;
# * the update ratio of a training stream against float64 norms of the
#   parameters copied around the step: NS_RATIO_RTOL relative (float32
#   sums of 1.2·10^8 squares, ~2 log2(n) u);
# * the refused chain against the serving-off read of the same program:
#   bit for bit (one compiled program, one input).
NS_RMS_ULPS = 64
NS_RATIO_RTOL = 1e-4


def _ns_reference_stats(parts) -> dict:
    """The lens's statistics of the logical elements ``parts`` in float64,
    from values, not bits: the exponent from frexp."""
    import numpy as np
    import torch

    n = sum(p.numel() for p in parts)
    nonfinite = subnormal = 0
    hist = torch.zeros(16, dtype=torch.float64, device="cuda")
    absmax, sumsq = 0.0, 0.0
    info = np.finfo(str(parts[0].dtype).replace("torch.", ""))
    bias = info.maxexp - 1  # float32: 127, as the exponent field's
    span = 2 * info.maxexp - 2  # the normal exponent codes: 254
    minexp = 1 - bias
    for p in parts:
        v = p.reshape(-1).double()
        finite = torch.isfinite(v)
        nonfinite += int((~finite).sum())
        v = torch.where(finite, v, torch.zeros_like(v))
        a = v.abs()
        subnormal += int(((a > 0) & (a < float(info.tiny))).sum())
        absmax = max(absmax, float(a.max()))
        _, e = torch.frexp(a)
        floor_log2 = e.long() - 1
        b = torch.clamp(((floor_log2 - minexp) * 16) // span, 0, 15)
        counted = a > 0
        hist += torch.bincount(b[counted], minlength=16).double()
        sumsq += float(v.square().sum())
    return {"n": n, "nonfinite": nonfinite, "subnormal": subnormal, "hist": [int(h) for h in hist.tolist()],
            "absmax": absmax, "rms": math.sqrt(sumsq / n)}


def _ns_check_stats(label, rr, parts) -> dict:
    """The lens's record of one root against the float64 values."""
    import numpy as np

    want = _ns_reference_stats(parts)
    got = {k: rr[k] for k in ("nonfinite", "subnormal", "hist", "absmax", "rms")}
    rms_ulps = abs(rr["rms"] - want["rms"]) / np.spacing(np.float32(want["rms"]))
    exact = (rr["elems"] == want["n"] and got["nonfinite"] == want["nonfinite"]
             and got["subnormal"] == want["subnormal"] and got["hist"] == want["hist"]
             and got["absmax"] == want["absmax"])
    print(f"    {label}: {want['n']} elements, nonfinite {got['nonfinite']}, subnormal {got['subnormal']}, "
          f"histogram {got['hist']}; rms {rr['rms']:.9g} ({rms_ulps:.2f} f32 ULP from float64, bound "
          f"{NS_RMS_ULPS}), absmax {rr['absmax']:.9g}; counts, histogram and absmax equal float64's: {exact}",
          flush=True)
    if not exact or rms_ulps > NS_RMS_ULPS:
        raise AssertionError(f"{label}: the lens's statistics {got} differ from float64's {want}")
    return {"rms_ulps": float(rms_ulps), "elements": want["n"], "nonfinite": got["nonfinite"]}


def _ns_chain_ms(ht, fn, reps: int) -> float:
    """ms per chain between CUDA events, each chain's result read back to
    the host (a sampled dispatch syncs the host anyway)."""
    import torch

    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        out = fn()
        for o in out if isinstance(out, tuple) else (out,):
            o.larray.reshape(-1)[:1].item()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def numerics_lens_phase(ht, nl, fusion, x) -> dict:
    """(a) The lens on the card: the 10-op chain and the column moments in
    each mode; each root's statistics against float64; the drift ledger of
    Inductor's code against the plain module; four NaN-padded shards; the
    canary on one shard and four, clean and with ``numeric.sdc.1``."""
    import torch

    from heat_tpu_torch.core import resilience
    from heat_tpu_torch.core.communication import MeshCommunication

    out = {}
    print(f"phase numerics: the lens over the 10-op chain and the column moments of {N} x {F} float32, modes off, "
          "sample and full", flush=True)
    b = ht.array(torch.randn(N, F, generator=torch.Generator(device="cuda").manual_seed(SEED + 20), device="cuda"),
                 split=0)
    chains = {"nine": lambda: _fu_nine(ht, x, b),
              "moments": lambda: (ht.mean(x, axis=0), ht.var(x, axis=0), ht.std(x, axis=0))}
    prev = nl.set_mode("full"), nl._SAMPLE_EVERY, nl._SHADOW_EVERY
    try:
        nl._SHADOW_EVERY = 1
        for name, fn in chains.items():  # the builds, and the lens's first run at these shapes, untimed
            for o in (fn() if name == "moments" else (fn(),)):
                o.larray
        out["ms"] = {}
        for mode in ("off", "sample", "full"):
            nl.set_mode(mode)
            nl._SAMPLE_EVERY, nl._SHADOW_EVERY = 16, 4  # the knobs' defaults
            row = {}
            for name, fn in chains.items():
                nl.reset()
                row[name] = _ns_chain_ms(ht, fn, NS_REPS)
                seen = nl.sampling_stats()
                want = 0 if mode == "off" else (NS_REPS if mode == "full" else -(-NS_REPS // 16))
                row[name + "_sampled"] = seen["dispatches_sampled"]
                if seen["dispatches_sampled"] != want or (mode != "off" and seen["dispatches_seen"] != NS_REPS):
                    raise AssertionError(f"lens {mode}, {name}: sampled {seen} of {NS_REPS} dispatches, not {want}")
            out["ms"][mode] = row
            print(f"  {mode}: 10-op chain {row['nine']:.4f} ms, moments {row['moments']:.4f} ms per chain "
                  f"({row['nine_sampled']} and {row['moments_sampled']} of {NS_REPS} sampled)", flush=True)
        # the statistics and the drift, every dispatch sampled and audited
        nl.set_mode("full")
        nl._SHADOW_EVERY = 1
        nl.reset()
        h = chains["nine"]()
        hv = h.larray  # alone: a pending moment would ride its program
        moments = chains["moments"]()
        for m in moments:
            m.larray
        stats, drift = nl.tensor_stats(), nl.drift_ledger()
        if len(stats) != 2 or len(drift["programs"]) != 2:
            raise AssertionError(f"the lens recorded {len(stats)} programs and audited {len(drift['programs'])}, not 2")
        print("  the lens's statistics of each root against float64:", flush=True)
        out["stats"] = {}
        for key, rec in stats.items():
            roots = [h] if len(rec["roots"]) == 1 else list(moments)
            for i, arr in enumerate(roots):
                label = f"{rec['family'][:40]}[{i}]"
                out["stats"][f"{key}[{i}]"] = _ns_check_stats(label, rec["roots"][i], [arr.larray])
        out["drift"] = {}
        for key, rec in drift["programs"].items():
            kind = "elementwise" if len(stats[key]["roots"]) == 1 else "reduction"
            out["drift"][kind] = {"program": key, "p50_ulp": rec["p50_ulp"], "max_ulp": rec["max_ulp"],
                                  "nonfinite_mismatch": rec["nonfinite_mismatch"]}
            print(f"  drift of Inductor's code against the plain module, {kind} ({key}, {rec['family'][:60]}): "
                  f"p50 {rec['p50_ulp']} ULP, max {rec['max_ulp']} ULP", flush=True)
        del h, hv, moments
        # four shards with NaN in the padding and NS_NANS in the data
        mesh = MeshCommunication([torch.device("cuda", 0)] * 4)
        data = torch.randn(NS_RAGGED, generator=torch.Generator(device="cuda").manual_seed(SEED + 201), device="cuda")
        rows = torch.randperm(NS_RAGGED[0], generator=torch.Generator(device="cuda").manual_seed(SEED + 202),
                              device="cuda")[:NS_NANS]
        data[rows, 3] = float("nan")
        a4 = ht.array(data, split=0, comm=mesh)
        pad = _poison_padding(a4)
        nl.reset()
        y = a4 * 2.0 + 1.0
        if not fusion.is_deferred(y):
            raise AssertionError("the four-shard chain did not record")
        padded_nans = sum(int(torch.isnan(s[c:]).sum()) for s, c in zip(y.shards, y.counts_displs()[0]))
        (rec,) = nl.tensor_stats().values()
        rr = rec["roots"][0]
        out["nan_padding"] = {"padding_elements": padded_nans, "nonfinite": rr["nonfinite"], "elements": rr["elems"]}
        print(f"  {mesh.size} shards of {NS_RAGGED[0]} x {NS_RAGGED[1]}: {pad} padding row(s) of NaN, "
              f"{padded_nans} NaN in the result's padding; the lens counts {rr['nonfinite']} nonfinite of "
              f"{rr['elems']} elements (the data holds {NS_NANS})", flush=True)
        if padded_nans == 0 or rr["nonfinite"] != NS_NANS or rr["elems"] != NS_RAGGED[0] * NS_RAGGED[1]:
            raise AssertionError("the lens counted the padding, or missed the NaN in the data")
        del a4, y, data
        # the canary
        out["canary"] = {}
        one = MeshCommunication([torch.device("cuda", 0)])
        for label, comm in (("one shard", one), ("four shards", mesh)):
            r = nl.run_canary(comm=comm)
            out["canary"][label] = {"mismatches": r["mismatches"], "ms": r["ms"]}
            print(f"  canary on {label}: {r['devices']} device(s), mismatches {r['mismatches']}, {r['ms']:.3f} ms",
                  flush=True)
            if r["mismatches"]:
                raise AssertionError(f"the canary flagged a healthy card on {label}")
        resilience.reset_device_faults()
        nl.reset()
        with resilience.inject("numeric.sdc.1", times=1):
            r = nl.run_canary(comm=mesh)
        found = [f for f in nl.findings() if f["rule"] == "numlens.sdc"]
        faults = resilience.device_fault_counts()
        out["canary"]["injected"] = {"mismatches": r["mismatches"], "index": [f["index"] for f in found],
                                     "device_faults": faults}
        print(f"  canary on four shards with numeric.sdc.1 injected: mismatches {r['mismatches']}, finding at "
              f"index {[f['index'] for f in found]}: {found[0]['message'] if found else None}; device faults "
              f"{faults}", flush=True)
        if [f["index"] for f in found] != [1] or r["mismatches"] != ["cuda:0"] or faults.get("cuda:0") != 1:
            raise AssertionError("the injected SDC did not name index 1 or reach the device-fault ledger")
        resilience.reset_device_faults()
    finally:
        nl.set_mode(prev[0])
        nl._SAMPLE_EVERY, nl._SHADOW_EVERY = prev[1], prev[2]
        nl.reset()
    return out


def numerics_training_phase(ht, nl) -> dict:
    """(b) The training streams: the README's TransformerLM under
    DataParallel, lens off and on; then DASO's merges on four shards."""
    import copy

    import torch

    from heat_tpu_torch.core.communication import MeshCommunication
    from heat_tpu_torch.ops import flash

    out = {}
    print(f"phase numerics: the README's TransformerLM under DataParallel, Adam({LM_LR}), {LM_BATCH} x {LM_SEQ} "
          f"tokens, {NS_LM_STEPS} steps with the lens off and on", flush=True)
    tokens = torch.randint(0, LM["vocab"], (LM_BATCH, LM_SEQ), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(SEED + 14))
    model = _lm(ht, torch.float32)
    dp = ht.nn.DataParallel(model, comm=MeshCommunication([torch.device("cuda", 0)]),
                            optimizer=ht.optim.Adam(LM_LR), loss_fn=next_token_loss)
    dp.init(SEED, tokens[:1])
    prev = nl.set_mode(0)
    try:
        dp.train_step(tokens, tokens)  # the first step's allocations
        for mode in ("off", "full"):
            nl.set_mode(mode)
            nl.reset()
            times, launches, ratios = [], [], []
            for _ in range(NS_LM_STEPS):
                before = _flat(model.parameters()) if mode == "full" else None
                flash.LAUNCHES = 0
                loss = []
                times.append(_time_step(lambda: loss.append(dp.train_step(tokens, tokens))))
                launches.append(flash.LAUNCHES)
                if mode == "full":
                    after = _flat(model.parameters())
                    want = float((after - before).norm() / (after.norm() + 1e-12))
                    st = nl.training_stats()["data_parallel.step"]
                    ratios.append((st["last_update_ratio"], want))
                    if st["last_loss"] != loss[0]:
                        raise AssertionError(f"the stream's loss {st['last_loss']} is not the step's {loss[0]}")
                    del before, after
            out[mode] = {"ms": sorted(times)[len(times) // 2], "step_ms": times, "launches": launches}
            if mode == "full":
                errs = [abs(g - w) / w for g, w in ratios]
                out[mode].update(update_ratios=ratios, ratio_rel_err=max(errs),
                                 stream=nl.training_stats()["data_parallel.step"])
            print(f"  lens {mode}: {out[mode]['ms']:.2f} ms per step (median of {NS_LM_STEPS}: "
                  f"{[round(t, 2) for t in times]}), B3 launches per step {launches}"
                  + (f"; update ratio against float64 norms: {[(f'{g:.6e}', f'{w:.6e}') for g, w in ratios]}, "
                     f"max rel err {max(errs):.2e} (bound {NS_RATIO_RTOL:g})" if mode == "full" else ""), flush=True)
            if launches != [LM["depth"]] * NS_LM_STEPS:
                raise AssertionError(f"lens {mode}: B3 launched {launches} per step, not {LM['depth']}")
            if mode == "full" and not (all(w > 0 for _, w in ratios) and max(errs) <= NS_RATIO_RTOL):
                raise AssertionError("the stream's update ratio disagrees with the parameters' float64 norms")
    finally:
        nl.set_mode(prev)
    del dp, model
    torch.cuda.empty_cache()

    print(f"phase numerics: DASO on {TRAIN_P} shards of the card, ResNet-50 at batch {TRAIN_BATCH}, the lens on "
          "until two merges", flush=True)
    x, y = _cifar(TRAIN_BATCH, SEED + 11)
    pristine = ht.nn.ResNet50(num_classes=TRAIN_CLASSES, generator=torch.Generator("cuda").manual_seed(SEED))
    daso = ht.optim.DASO(ht.optim.SGD(TRAIN_LR), total_epochs=10, comm=MeshCommunication([torch.device("cuda", 0)] * TRAIN_P),
                         nodes=2, warmup_epochs=1, cooldown_epochs=0)
    daso.add_model(copy.deepcopy(pristine), SEED, x[:TRAIN_P])
    merge, seen = daso._merge, []

    def watched(waits):
        before = torch.cat([_flat(r.parameters()) for r in daso.replicas])
        merge(waits)
        after = torch.cat([_flat(r.parameters()) for r in daso.replicas])
        seen.append(float((after - before).norm() / (after.norm() + 1e-12)))

    daso._merge = watched
    nl.set_mode("full")
    nl.reset()
    try:
        losses = []
        while len(seen) < 2:
            losses.append(daso.step(x, y))
        st = nl.training_stats()["daso.merge"]
    finally:
        nl.set_mode(prev)
        daso._merge = merge
    err = max(abs(st_ratio - w) / w for st_ratio, w in zip([st["last_update_ratio"]], seen[-1:]))
    out["daso"] = {"steps": len(losses), "merges": st["steps"], "last_loss": st["last_loss"],
                   "update_ratio": st["last_update_ratio"], "float64": seen, "rel_err": err}
    print(f"  {len(losses)} steps, {st['steps']} merges in the stream; last loss {st['last_loss']:.6f} (the step "
          f"returned {losses[-1]:.6f}); update ratio {st['last_update_ratio']:.6e} against float64 {seen[-1]:.6e} "
          f"(rel err {err:.2e})", flush=True)
    if st["steps"] != 2 or st["last_loss"] != losses[-1] or err > NS_RATIO_RTOL:
        raise AssertionError("DASO's merge stream disagrees with its steps or with float64")
    del daso, pristine, x, y
    torch.cuda.empty_cache()
    return out


def _ns_moments(ht, x):
    """A tenant's small read: the column std (its mean inside the same
    program), one root of 64 bytes."""
    return ht.std(x, axis=0)


def _ns_read_ms(read) -> float:
    t0 = time.perf_counter()
    read()
    return (time.perf_counter() - t0) * 1e3


def serving_sessions_phase(ht, fusion, serving, memledger, tel, tables, fit) -> dict:
    """(c) Eight sessions on eight threads, each with its own table, and a
    ninth running config 3's fit; then admission's three gates."""
    import threading

    import numpy as np
    import torch

    from heat_tpu_torch.ops import lloyd

    out = {}
    print(f"phase serving: {NS_TENANTS} sessions on {NS_TENANTS} threads, a {N} x {F} float32 table each, "
          f"{NS_ROUNDS} rounds of the column moments and a z-score; a ninth session runs KMeans.fit", flush=True)
    # warm-up: every batch one tenant's read can form (its own root and
    # 0..7 other tenants' small roots, each of one structure)
    t0, builds = time.perf_counter(), _fu_unique_graphs()
    for k in range(NS_TENANTS):
        for own in ("moments", "zscore"):
            others = [_ns_moments(ht, t) for t in tables[1:k + 1]]
            mine = _ns_moments(ht, tables[0]) if own == "moments" else _fc_zscore(ht, tables[0])
            mine.larray.reshape(-1)[:1].item()
            if any(fusion.is_deferred(o) for o in others):
                raise AssertionError(f"the warm-up's batch of {k} roots left one pending")
            del others, mine
    out["warmup"] = {"seconds": time.perf_counter() - t0, "inductor_builds": _fu_unique_graphs() - builds}
    print(f"  warm-up of the {2 * NS_TENANTS} batch shapes: {out['warmup']['seconds']:.1f} s, "
          f"{out['warmup']['inductor_builds']} Inductor builds", flush=True)
    compiles, lat = fusion.cache_stats()["compiles"], {}
    sessions = [serving.Session(f"tenant{i}") for i in range(NS_TENANTS)]
    barrier = threading.Barrier(NS_TENANTS + 1)
    errors = []
    prev_mode = tel.set_mode(1)
    tel.reset()

    def tenant(i):
        try:
            x = tables[i]
            lat[i] = {"moments": [], "zscore": []}
            with sessions[i]:
                barrier.wait(timeout=60)
                for _ in range(NS_ROUNDS):
                    lat[i]["moments"].append(_ns_read_ms(lambda: _ns_moments(ht, x).larray.reshape(-1)[:1].item()))
                    lat[i]["zscore"].append(_ns_read_ms(lambda: _fc_zscore(ht, x).larray.reshape(-1)[:1].item()))
        except Exception as exc:  # noqa: BLE001 - raised below
            errors.append(exc)

    def fitter():
        try:
            with serving.Session("kmeans") as sess:
                barrier.wait(timeout=60)
                t = time.perf_counter()
                before = lloyd.LAUNCHES
                fit["model"] = ht.cluster.KMeans(n_clusters=K, init=fit["init"], max_iter=ITERS, tol=-1.0).fit(fit["x"])
                torch.cuda.synchronize()
                fit["launches"], fit["seconds"], fit["stats"] = lloyd.LAUNCHES - before, time.perf_counter() - t, dict(sess.stats)
        except Exception as exc:  # noqa: BLE001 - raised below
            errors.append(exc)

    threads = [threading.Thread(target=tenant, args=(i,)) for i in range(NS_TENANTS)] + [threading.Thread(target=fitter)]
    try:
        for t in threads:
            t.start()
        t0 = time.perf_counter()
        for t in threads:
            t.join(timeout=600)
        out["seconds"] = time.perf_counter() - t0
        async_ = tel.async_forcing()
    finally:
        tel.set_mode(prev_mode)
        tel.reset()
    if errors:
        raise errors[0]
    out["retraces_after_warmup"] = fusion.cache_stats()["compiles"] - compiles
    out["batches"] = {"dispatches": async_["dispatches"], "roots": async_["roots_dispatched"],
                      "multi_root_batches": async_["multi_root_batches"]}
    out["sessions"] = {}
    for i, sess in enumerate(sessions):
        st = sess.report()["stats"]
        row = {"dispatches": st["dispatches"], "roots": st["roots"]}
        for kind in ("moments", "zscore"):
            v = np.asarray(lat[i][kind])
            row[f"{kind}_p50_ms"], row[f"{kind}_p99_ms"] = float(np.percentile(v, 50)), float(np.percentile(v, 99))
        out["sessions"][sess.name] = row
        print(f"  {sess.name}: moments p50 {row['moments_p50_ms']:.3f} / p99 {row['moments_p99_ms']:.3f} ms, z-score "
              f"p50 {row['zscore_p50_ms']:.3f} / p99 {row['zscore_p99_ms']:.3f} ms; {row['dispatches']} dispatches "
              f"billed, {row['roots']} roots", flush=True)
    out["fit"] = {"launches": fit["launches"], "seconds": fit["seconds"], "stats": fit["stats"]}
    print(f"  {out['seconds']:.2f} s for all; {async_['dispatches']} dispatches of {async_['roots_dispatched']} roots, "
          f"{async_['multi_root_batches']} cross-session batches; retraces after the warm-up "
          f"{out['retraces_after_warmup']}; the ninth session's fit {fit['seconds']:.2f} s, {fit['launches']} Lloyd "
          f"launches, {fit['stats']['dispatches']} dispatches billed", flush=True)
    roots = sum(r["roots"] for r in out["sessions"].values())
    if out["retraces_after_warmup"] or fit["launches"] != ITERS or roots != 2 * NS_TENANTS * NS_ROUNDS:
        raise AssertionError(f"sessions: {out['retraces_after_warmup']} retraces, {fit['launches']} Lloyd launches, "
                             f"{roots} roots billed (not 0, {ITERS}, {2 * NS_TENANTS * NS_ROUNDS})")
    if not out["batches"]["multi_root_batches"]:
        raise AssertionError("no dispatch carried roots of two sessions")
    del sessions

    # admission: raise, then wait, then the memory gate's hold
    x = tables[0]
    want = _ns_moments(ht, x).larray.clone()  # serving off: no session, no bucket
    with serving.Session("limited", admission_rate=2, admission_burst=1, policy="raise") as sess:
        _ns_moments(ht, x).larray
        pending = _ns_moments(ht, x)
        try:
            pending.larray
            raise AssertionError("the limited session's second read was admitted")
        except serving.AdmissionError as exc:
            message = str(exc)
        still = fusion.is_deferred(pending)
        time.sleep(0.6)
        got = pending.larray
        refused = sess.stats["admission_refused"]
    out["raise"] = {"message": message, "pending_after_refusal": still, "refused": refused,
                    "bit_for_bit": bool(torch.equal(got, want))}
    print(f"  raise policy, 2 tokens/s: {message[:150]}...; pending after the refusal {still}; after the refill "
          f"equal to the serving-off read bit for bit: {out['raise']['bit_for_bit']}", flush=True)
    if not (still and refused == 1 and "limited" in message and "session:limited" in message
            and out["raise"]["bit_for_bit"]):
        raise AssertionError("the raise policy's refusal or its later dispatch is wrong")
    waiter, neighbours = serving.Session("patient", admission_rate=0.5, admission_burst=1), {}
    errors = []

    def patient():
        try:
            with waiter:
                _ns_moments(ht, x).larray.reshape(-1)[:1].item()
                _ns_moments(ht, x).larray.reshape(-1)[:1].item()  # waits ~2 s for its token
        except Exception as exc:  # noqa: BLE001 - raised below
            errors.append(exc)

    def neighbour(i):
        try:
            with serving.Session(f"neighbour{i}"):
                neighbours[i] = [_ns_read_ms(lambda: _ns_moments(ht, tables[i]).larray.reshape(-1)[:1].item())
                                 for _ in range(NS_ROUNDS)]
        except Exception as exc:  # noqa: BLE001 - raised below
            errors.append(exc)

    t = threading.Thread(target=patient)
    t.start()
    while not waiter.stats["admission_waits"] and t.is_alive():
        time.sleep(0.005)
    others = [threading.Thread(target=neighbour, args=(i,)) for i in (1, 2, 3)]
    for o in others:
        o.start()
    for th in others + [t]:
        th.join(timeout=120)
    if errors:
        raise errors[0]
    p99 = float(np.percentile([v for vs in neighbours.values() for v in vs], 99))
    slept = waiter.stats["admission_waited_s"] * 1e3
    out["wait"] = {"waited_ms": slept, "neighbour_p99_ms": p99, "waits": waiter.stats["admission_waits"]}
    print(f"  wait policy, 0.5 tokens/s: the tenant slept {slept:.1f} ms for its token; three neighbours' p99 "
          f"meanwhile {p99:.3f} ms", flush=True)
    if not (waiter.stats["admission_waits"] >= 1 and p99 < slept):
        raise AssertionError("a neighbour waited behind the tenant's admission sleep")
    with serving.Session("held") as sess:
        pending = _ns_moments(ht, x)
        with memledger.admission_hold("drain"):
            try:
                pending.larray
                raise AssertionError("a read was admitted under the hold")
            except memledger.MemoryBudgetExceeded as exc:
                message = str(exc)
            still = fusion.is_deferred(pending)
        got = pending.larray
        billed = sess.stats["mem_refused"]
    out["hold"] = {"message": message, "pending": still, "bit_for_bit": bool(torch.equal(got, want)),
                   "mem_refused": billed}
    print(f"  memledger.admission_hold: {message[:100]}...; pending {still}; after the release equal bit for bit: "
          f"{out['hold']['bit_for_bit']}", flush=True)
    if not (still and "drain" in message and out["hold"]["bit_for_bit"] and billed == 1):
        raise AssertionError("the admission hold did not refuse, or its release changed the result")
    return out


_NS_CACHE_SCRIPT = """
import json, os, sys, time
t_start = time.perf_counter()
import torch
t_torch = time.perf_counter() - t_start
import heat_tpu_torch as ht
from heat_tpu_torch.core import fusion, serving
from torch._dynamo.utils import counters
torch.backends.cuda.matmul.allow_tf32 = False
ht.use_device("gpu")
n, f, seed, cache, work, mode = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5], sys.argv[6]
gen = torch.Generator(device="cuda").manual_seed(seed)
a = ht.array(torch.randn(n, f, generator=gen, device="cuda"), split=0)
b = ht.array(torch.randn(n, f, generator=gen, device="cuda"), split=0)
torch.cuda.synchronize()
t_ready = time.perf_counter() - t_start
if mode == "warm":
    # started beside the cold process: its start overlaps the cold work; it
    # arms the cache (and loads the index) once the cold process is done
    while not os.path.exists(os.path.join(work, "go")):
        time.sleep(0.05)
    serving.arm_cache(cache)
t_go = time.perf_counter()


def nine():
    c = ht.exp((a + b) * 2.0) - b
    d = ht.abs(c)
    return ht.sqrt(ht.abs(d + a)) / (d + 1.0) * b


items = (("10-op chain", nine), ("moments", lambda: (ht.mean(a, axis=0), ht.var(a, axis=0), ht.std(a, axis=0))),
         ("z-score", lambda: (a - ht.mean(a, axis=0)) / ht.std(a, axis=0)))
first, results = {}, {}
for label, fn in items:
    before = dict(fusion.cache_stats())
    builds = counters["stats"]["unique_graphs"]
    t0 = time.perf_counter()
    out = fn()
    values = [o.larray for o in (out if isinstance(out, tuple) else (out,))]
    torch.cuda.synchronize()
    after = fusion.cache_stats()
    first[label] = {"seconds": time.perf_counter() - t0, "inductor_builds": counters["stats"]["unique_graphs"] - builds,
                    "compiles": after["compiles"] - before["compiles"], "disk_hits": after["disk_hits"] - before["disk_hits"]}
    results[label] = values
t_work = time.perf_counter() - t_go
path = os.path.join(work, "results.pt")
if mode == "cold":
    torch.save({k: [v.cpu() for v in vs] for k, vs in results.items()}, path)
    equal = None
else:
    saved = torch.load(path)
    equal = {k: all(torch.equal(v.cpu(), w) for v, w in zip(vs, saved[k])) for k, vs in results.items()}
print("CACHE " + json.dumps({"first": first, "import_torch_s": t_torch, "ready_s": t_ready, "work_s": t_work,
                              "seconds": time.perf_counter() - t_start,
                              "fxgraph_cache_hit": counters["inductor"]["fxgraph_cache_hit"],
                              "fxgraph_cache_miss": counters["inductor"]["fxgraph_cache_miss"],
                              "index_keys": serving.cache_stats()["index_keys"], "equal": equal}))
"""


def serving_cache_phase(ht, serving) -> dict:
    """(d) The persistent program cache: a cold, then a warm fresh process
    on one new directory forcing the same three signatures (the cold one
    armed by ``HEAT_TPU_PROGRAM_CACHE_DIR`` at import, the warm one by
    ``arm_cache`` before its first build; the warm one starts beside the
    cold one and waits for it before it arms); then whether this process's
    Inductor follows an arm after its earlier builds."""
    out = {}
    cache, work = tempfile.mkdtemp(prefix="heat_ns_cache_"), tempfile.mkdtemp(prefix="heat_ns_work_")
    try:
        print(f"phase serving: the persistent program cache, two fresh processes on the empty {cache}", flush=True)
        args = [str(N), str(F), str(SEED + 21), cache, work]
        here = os.path.dirname(os.path.abspath(__file__))
        t0 = time.perf_counter()
        procs, logs = {}, {}
        for mode in ("cold", "warm"):
            logs[mode] = open(os.path.join(work, f"{mode}.stderr"), "w+")
            procs[mode] = subprocess.Popen(
                [sys.executable, "-c", _NS_CACHE_SCRIPT, *args, mode], stdout=subprocess.PIPE, stderr=logs[mode],
                text=True, cwd=here, env=dict(os.environ, HEAT_TPU_PROGRAM_CACHE_DIR=cache) if mode == "cold" else None,
            )
        try:
            for mode in ("cold", "warm"):
                # the result line, not the exit: a process's teardown (its
                # compile workers') overlaps the next step
                line = next((ln for ln in procs[mode].stdout if ln.startswith("CACHE ")), None)
                wall = time.perf_counter() - t0
                if line is None:
                    procs[mode].wait(timeout=60)
                    logs[mode].seek(0)
                    raise AssertionError(f"the {mode} process failed: {logs[mode].read()[-3000:]}")
                if mode == "cold":
                    open(os.path.join(work, "go"), "w").close()
                rec = json.loads(line[len("CACHE "):])
                rec["wall_s"] = wall
                out[mode] = rec
                firsts = "; ".join(f"{k} {v['seconds']:.2f} s ({v['inductor_builds']} built, {v['compiles']} "
                                   f"compile, {v['disk_hits']} disk hit)" for k, v in rec["first"].items())
                print(f"  {mode}: {rec['seconds']:.1f} s in the process ({rec['import_torch_s']:.1f} s importing torch, "
                      f"{rec['ready_s']:.1f} s to its tables), the three signatures' work {rec['work_s']:.2f} s; "
                      f"first results: {firsts}; FX graph cache {rec['fxgraph_cache_hit']} hit(s), "
                      f"{rec['fxgraph_cache_miss']} miss(es); index {rec['index_keys']} keys"
                      + (f"; results equal the cold process's bit for bit: {rec['equal']}" if mode == "warm" else ""),
                      flush=True)
            cold, warm = out["cold"], out["warm"]
            if any(v["disk_hits"] or not v["compiles"] for v in cold["first"].values()):
                raise AssertionError("the cold process found its programs in the index")
            if any(v["compiles"] or v["disk_hits"] != 1 for v in warm["first"].values()):
                raise AssertionError("the warm process compiled a signature the cold one indexed")
            if not all(warm["equal"].values()):
                raise AssertionError("the warm process's results differ from the cold one's")
            if warm["fxgraph_cache_miss"] or warm["fxgraph_cache_hit"] < len(warm["first"]):
                raise AssertionError("Inductor's FX graph cache did not serve the warm process")
            out["in_process"] = _ns_cache_in_process(ht, serving)
            for mode, proc in procs.items():
                if proc.wait(timeout=300):
                    logs[mode].seek(0)
                    raise AssertionError(f"the {mode} process exited with {proc.returncode}: {logs[mode].read()[-3000:]}")
        finally:
            for mode, proc in procs.items():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                proc.stdout.close()
                logs[mode].close()
    finally:
        shutil.rmtree(cache, ignore_errors=True)
        shutil.rmtree(work, ignore_errors=True)
    return out


def _ns_cache_in_process(ht, serving) -> dict:
    """This process built programs before: does an arm move Inductor's
    cache, and does a disarm restore it?"""
    import torch

    moved = tempfile.mkdtemp(prefix="heat_ns_moved_")
    before_env = os.environ.get("TORCHINDUCTOR_CACHE_DIR")
    try:
        serving.arm_cache(moved)
        a = ht.array(torch.randn(N, F, generator=torch.Generator(device="cuda").manual_seed(SEED + 22), device="cuda"),
                     split=0)
        ht.sum(ht.abs(a * 3.25) + 0.5, axis=1).larray  # a signature no phase built
        files = sum(len(fs) for _, _, fs in os.walk(os.path.join(moved, "inductor")))
        serving.disarm_cache()
        restored = os.environ.get("TORCHINDUCTOR_CACHE_DIR") == before_env
    finally:
        serving.disarm_cache()
        shutil.rmtree(moved, ignore_errors=True)
    print(f"  in this process, after its earlier builds: an arm moved Inductor's cache: {files > 0} ({files} files "
          f"under the armed directory); disarm_cache restored TORCHINDUCTOR_CACHE_DIR: {restored}", flush=True)
    if not restored:
        raise AssertionError("disarm_cache left Inductor's cache directory moved")
    return {"files_in_armed_dir": files, "moved": files > 0, "disarm_restored": restored}


def numerics_serving_path(ht, smi: str) -> dict:
    """Phase 20: the numerics lens and the serving layer on the card;
    returns its numbers."""
    import torch

    from heat_tpu_torch.core import fusion, memledger, serving
    from heat_tpu_torch.core import numlens as nl
    from heat_tpu_torch.core import telemetry as tel

    if not torch.cuda.is_available():
        raise RuntimeError("phase 20 needs CUDA")
    numbers = {"card": smi, "seconds": {}}
    t0, builds = time.perf_counter(), _fu_unique_graphs()
    x, init = kmeans_table(ht)
    lap = time.perf_counter()
    numbers["lens"] = numerics_lens_phase(ht, nl, fusion, x)
    numbers["seconds"]["lens"] = time.perf_counter() - lap
    torch.cuda.empty_cache()
    lap = time.perf_counter()
    numbers["training"] = numerics_training_phase(ht, nl)
    numbers["seconds"]["training"] = time.perf_counter() - lap
    lap = time.perf_counter()
    gen = torch.Generator(device="cuda")
    tables = [ht.array(torch.randn(N, F, generator=gen.manual_seed(SEED + 300 + i), device="cuda"), split=0)
              for i in range(NS_TENANTS)]
    numbers["sessions"] = serving_sessions_phase(ht, fusion, serving, memledger, tel, tables,
                                                 {"x": x, "init": init})
    numbers["seconds"]["sessions"] = time.perf_counter() - lap
    del tables
    torch.cuda.empty_cache()
    lap = time.perf_counter()
    numbers["cache"] = serving_cache_phase(ht, serving)
    numbers["seconds"]["cache"] = time.perf_counter() - lap
    numbers["seconds"]["all"] = time.perf_counter() - t0
    numbers["inductor_builds"] = _fu_unique_graphs() - builds
    print(f"phase 20: {numbers['seconds']['all']:.1f} s, {numbers['inductor_builds']} Inductor builds "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in numbers['seconds'].items() if k != 'all')})", flush=True)
    return numbers


# ---------------------------------------------------------------------------
# the trace analyzer and the live ops plane (phase 21): no kernel of their
# own; the analyzed fit and the scraped ninth tenant run B1. Both read the
# timeline and the gauges only: a chain's dispatch and its read are on the
# timeline when the recorder ran it (operands of 192 MiB or more on the
# card), a Lloyd launch of ops/lloyd.py is not, so a read after a fit is
# ``sync_wait``.
# ---------------------------------------------------------------------------
OT_WARM = 50  # warm chains of the 10-op chain, each read back
OT_DEVICE_REPS = 20  # back-to-back calls of the chain's program: its device time per call
OT_STORM_READS = 32  # reads of a recorded reduction inside one span
OT_LAYOUT_ROWS = (9_000_000, 8_000_000, 7_000_000, 6_000_000, 5_000_000)  # one-op layouts, each over 192 MiB
OT_P = 4
OT_INTERVAL_S = 0.25  # the sampler's cadence
OT_SCRAPE_S = 0.1  # the scraper's cadence, 10 Hz
OT_ROUNDS = 30  # reads of each kind per tenant per leg
OT_LEGS = (("scraped", True), ("quiet", False), ("quiet2", False), ("scraped2", True))  # ABBA against drift
OT_BURN = dict(target=0.99, fast_s=2.0, slow_s=6.0, threshold=1.0, min_samples=8)
OT_WAIT_S = 10.0  # the longest wait for an alert edge
OT_ROUTES = {"/metrics": 200, "/healthz": 200, "/readyz": 200, "/debug/report": 200,
             "/debug/trace?analyze=1": 200, "/debug/numerics": 200, "/debug/flight": 200}
# Bounds of phase 21:
# * the window's accounting: unattributed at most OT_UNATTRIBUTED_PCT of
#   it (tests/test_tracelens.py:84);
# * device_execute, the host's wait from a warm chain's dispatch stamp to
#   its value, within OT_EXECUTE_RANGE of the chains' device time (CUDA
#   events around OT_DEVICE_REPS back-to-back calls of the program, which
#   keep the card busy, times OT_WARM): less, by the host work between the
#   first launch and the stamp, and more only by the read's copy and
#   return. Events around each of the warm calls also count the card's
#   wait for the first launch, and are printed beside;
# * the compile bucket at least OT_COMPILE_SHARE of what the cold chain
#   took beyond a warm one: the build runs inside the interval from the
#   compile event to the dispatch stamp;
# * the command line's analysis of the exported file: buckets within
#   OT_BUCKET_TOL_S of the live analysis (the export stamps microseconds
#   with three decimals), findings equal.
OT_UNATTRIBUTED_PCT = 5.0
OT_EXECUTE_RANGE = (0.5, 1.05)
OT_COMPILE_SHARE = 0.9
OT_BUCKET_TOL_S = 1e-6

#: a command-line process of the phase: it imports torch and the package
#: while the phase runs, then waits for its arguments in ``go`` (a JSON
#: list) and runs ``heat_tpu_torch.telemetry`` as ``python -m`` would
_OT_CLI_SCRIPT = """
import json, os, runpy, sys, time
import torch
import heat_tpu_torch
go = sys.argv[1]
while not os.path.exists(go):
    time.sleep(0.02)
with open(go) as fh:
    sys.argv = ["heat_tpu_torch.telemetry"] + json.load(fh)
rc = 0
try:
    runpy.run_module("heat_tpu_torch.telemetry", run_name="__main__", alter_sys=True)
except SystemExit as exc:
    rc = exc.code or 0
sys.stdout.flush()
print("CUDA_INITIALIZED " + str(torch.cuda.is_initialized()), file=sys.stderr)
sys.exit(rc)
"""


class _OtCli:
    """One command-line process, started at once and given its arguments
    later."""

    def __init__(self, tmp: str, name: str):
        self.go = os.path.join(tmp, f"{name}.go")
        self.proc = subprocess.Popen([sys.executable, "-c", _OT_CLI_SCRIPT, self.go], stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True, cwd=os.path.dirname(os.path.abspath(__file__)))

    def run(self, args, timeout: float = 180.0) -> dict:
        with open(self.go + ".tmp", "w") as fh:
            json.dump(list(args), fh)
        os.replace(self.go + ".tmp", self.go)
        out, err = self.proc.communicate(timeout=timeout)
        return {"rc": self.proc.returncode, "stdout": out, "stderr": err,
                "cuda_initialized": "CUDA_INITIALIZED True" in err}

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()


def _ot_get(port: int, route: str, timeout: float = 30.0):
    """One GET of the local ops server: (status, body, ms)."""
    import urllib.error
    import urllib.request

    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}", timeout=timeout) as resp:
            code, body = resp.status, resp.read().decode()
    except urllib.error.HTTPError as exc:
        code, body = exc.code, exc.read().decode()
    return code, body, (time.perf_counter() - t0) * 1e3


class _OtTimed:
    """A cached program whose calls are bracketed by CUDA events (before the
    first launch and after the last) and by the host clock."""

    def __init__(self, prog):
        self.prog = prog
        self.pairs = []
        self.host = []  # (call, return) perf_counter stamps

    def __call__(self, flat):
        import torch

        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = self.prog(flat)
        stop.record()
        self.host.append((t0, time.perf_counter()))
        self.pairs.append((start, stop))
        return out

    def __getattr__(self, name):
        return getattr(self.prog, name)


def _ot_buckets(ana) -> dict:
    return {b: rec["s"] for b, rec in ana["attribution"]["overall"].items()}


def _ot_print_analysis(label: str, ana) -> None:
    overall = ana["attribution"]["overall"]
    print(f"  {label}: window {ana['window_s'] * 1e3:.3f} ms, {ana['events']} events; "
          + ", ".join(f"{b} {r['s'] * 1e3:.3f} ms ({r['pct']:.2f}%)"
                      for b, r in sorted(overall.items(), key=lambda kv: -kv[1]["s"]))
          + f", unattributed {ana['attribution']['unattributed_pct']:.3f}%", flush=True)
    crit = ana["critical_path"]
    print(f"    critical path {crit['total_s'] * 1e3:.3f} ms, {crit['sync_pct']}% waiting on the card, "
          f"{len(crit['steps'])} steps; first five: "
          + "; ".join(f"{s['bucket']} {s['dur_s'] * 1e3:.3f} ms cid {s['cid']}" for s in crit["steps"][:5]), flush=True)
    for key, rec in list(ana["attribution"]["per_program"].items())[:5]:
        print(f"    program {key}: {rec['dispatches']} dispatches, {rec['syncs']} syncs, compile "
              f"{rec['compile'] * 1e3:.3f} ms, dispatch_queue {rec['dispatch_queue'] * 1e3:.3f} ms, device_execute "
              f"{rec['device_execute'] * 1e3:.3f} ms", flush=True)
    for f in ana["findings"]:
        print(f"    finding [{f['severity']}] {f['rule']}: {f['message']}", flush=True)


#: the static analyzer's lint and verifier over the package, in a process
#: of their own: pure static analysis that needs no card and takes minutes
#: of one CPU core on the card's host, so the script starts it, at the
#: lowest priority, with the kernels' builds and phase 21's analyzer leg
#: reads its result
_STATIC_ANALYSIS_SCRIPT = """
import json, os, sys, time
os.nice(19)
import torch
from heat_tpu_torch.analysis import dataflow, engine
t0 = time.perf_counter()
lint = engine.lint_paths(["heat_tpu_torch"])
t1 = time.perf_counter()
verify, stats = dataflow.verify_paths(["heat_tpu_torch"])
t2 = time.perf_counter()
print(json.dumps({
    "lint_s": t1 - t0, "verify_s": t2 - t1, "lint": engine.summarize(lint), "verify": engine.summarize(verify),
    "active": [f.as_dict() for f in lint + verify if not (f.suppressed or f.baselined)],
    "modules": stats["modules"], "functions": stats["functions"], "cuda_initialized": torch.cuda.is_initialized(),
    "forbidden": sorted({"jax", "jaxlib", "heat_tpu", "flax", "optax"} & set(sys.modules)),
}))
"""
_STATIC_ANALYSIS = {}


def start_static_analysis() -> None:
    """Start the lint and the verifier over ``heat_tpu_torch`` in their own
    process (once)."""
    if "proc" not in _STATIC_ANALYSIS:
        _STATIC_ANALYSIS["started"] = time.perf_counter()
        _STATIC_ANALYSIS["proc"] = subprocess.Popen(
            [sys.executable, "-c", _STATIC_ANALYSIS_SCRIPT], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, cwd=os.path.dirname(os.path.abspath(__file__)))


def stop_static_analysis() -> None:
    proc = _STATIC_ANALYSIS.get("proc")
    if proc is not None and proc.poll() is None:
        proc.kill()
        proc.communicate()


def static_analysis_result(timeout: float = 600.0) -> dict:
    """The lint's and the verifier's result; the seconds this call waited
    for it as ``waited_s``."""
    start_static_analysis()
    t0 = time.perf_counter()
    out, err = _STATIC_ANALYSIS["proc"].communicate(timeout=timeout)
    if _STATIC_ANALYSIS["proc"].returncode != 0:
        raise AssertionError(f"the static analysis process failed: {err[-3000:]}")
    return dict(json.loads(out.strip().splitlines()[-1]), waited_s=time.perf_counter() - t0)


def ot_static_analysis_leg(ht, fusion) -> dict:
    """The static analyzer over what the warm chains left: the program
    audit of the cached programs (static: nothing built), the lint's and
    the verifier's result over the package, and the drift check of the
    verifier's cost model against telemetry's bytes on the card's mesh and
    on OT_P shards of it (its workloads stay eager there)."""
    import torch

    from heat_tpu_torch import analysis
    from heat_tpu_torch.analysis import dataflow
    from heat_tpu_torch.core.communication import MeshCommunication

    t0 = time.perf_counter()
    compiles = fusion.cache_stats()["compiles"]
    keys = fusion.cache_stats()["program_keys"]
    findings = analysis.audit_programs()
    audit_s = time.perf_counter() - t0
    info = fusion.program_audit_info()
    print(f"phase ops_trace: the static analyzer's leg: audit_programs() over {len(keys)} cached program(s) in "
          f"{audit_s:.3f} s, {len(findings)} finding(s)", flush=True)
    for key, rec in info.items():
        cost, repl = rec["cost"], rec["replicated_cost"]
        print(f"    program {key} [{rec['family'][:80]}]: mesh {rec['mesh_size']}, {rec['split_leaves']} split "
              f"leaves, bytes accessed per rank {cost.get('bytes_accessed')}, whole on every rank "
              f"{repl.get('bytes_accessed')}, collectives {cost.get('collectives')}, static peak "
              f"{(cost.get('memory') or {}).get('peak_bytes')} B", flush=True)
    print(analysis.render_audit(findings, len(keys)), flush=True)
    static = static_analysis_result()
    print(f"  lint_paths(['heat_tpu_torch']) {static['lint_s']:.2f} s: {static['lint']}; "
          f"verify_paths(['heat_tpu_torch']) {static['verify_s']:.2f} s over {static['modules']} modules, "
          f"{static['functions']} functions: {static['verify']}; in their own process, started with the "
          f"script ({static['waited_s']:.2f} s waited here), CUDA initialized there {static['cuda_initialized']}, "
          f"forbidden modules loaded {static['forbidden']}", flush=True)
    t1 = time.perf_counter()
    drift = {"card": dataflow.drift_report()}
    new_compiles = fusion.cache_stats()["compiles"] - compiles
    same_keys = fusion.cache_stats()["program_keys"] == keys
    # the default mesh of four shards: use_comm drops the cached programs
    # (a mesh-keyed cache), so this comes after the audit and its count
    ht.use_comm(MeshCommunication([torch.device("cuda", 0)] * OT_P))
    try:
        before = fusion.cache_stats()["compiles"]
        drift[f"{OT_P}_shards"] = dataflow.drift_report()
        new_compiles += fusion.cache_stats()["compiles"] - before
    finally:
        ht.use_comm(None)
    drift_s = time.perf_counter() - t1
    for label, rep in drift.items():
        print(f"  drift_report() on {label} (mesh {rep['mesh_size']}): " + "; ".join(
            f"{name} static {r['static_total']} B, observed {r['observed_total']} B, ratio {r['ratio']}"
            for name, r in rep["workloads"].items()), flush=True)
    out = {
        "programs": len(keys), "findings": [f.as_dict() for f in findings], "audit_s": audit_s,
        "info": {k: {"family": r["family"], "mesh_size": r["mesh_size"], "cost": r["cost"],
                     "replicated_bytes_accessed": r["replicated_cost"].get("bytes_accessed")} for k, r in info.items()},
        "new_compiles": new_compiles, "static": static, "drift": drift,
        "drift_s": drift_s, "leg_s": time.perf_counter() - t0,
    }
    print(f"  the leg: {out['leg_s']:.2f} s (audit {audit_s:.3f} s, waiting for the lint and verifier "
          f"{static['waited_s']:.2f} s, drift {drift_s:.2f} s), {out['new_compiles']} new compiles", flush=True)
    if not keys or any(f.kind == "replication" for f in findings):
        raise AssertionError(f"ops_trace: the audit of {len(keys)} program(s) found {out['findings']}")
    if out["new_compiles"] or not same_keys:
        raise AssertionError(f"ops_trace: the static analyzer's leg built {out['new_compiles']} program(s)")
    if static["lint"]["active"] or static["verify"]["active"] or static["cuda_initialized"] or static["forbidden"]:
        raise AssertionError(f"ops_trace: the lint and verifier over the package: {static}")
    if any(not r["within_bound"] or r["ratio"] > dataflow.DRIFT_FACTOR
           for rep in drift.values() for r in rep["workloads"].values()) or drift[f"{OT_P}_shards"]["mesh_size"] != OT_P:
        raise AssertionError(f"ops_trace: the drift check: {drift}")
    return out


def ot_analyzer_phase(ht, tel, fusion, tl, hr, x, b, tmp: str, cli: "_OtCli") -> dict:
    """(a) The analyzer on a recorded workload: phase 18's 10-op chain on
    the table, one cold signature and OT_WARM warm chains, each read."""
    import gc

    import numpy as np
    import torch

    print(f"phase ops_trace: the analyzer over the 10-op chain on {N} x {F} float32, one cold signature and "
          f"{OT_WARM} warm chains, each read back", flush=True)
    out = {}
    fusion.clear_cache()
    tel.reset()
    gc.collect()  # not inside the window
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cold = ht.sum(_fu_nine(ht, x, b)).item()
    out["cold_s"] = time.perf_counter() - t0
    (sig,) = list(fusion._PROGRAMS)
    timed = fusion._PROGRAMS[sig] = _OtTimed(fusion._PROGRAMS[sig])
    warm_from, walls, values = time.perf_counter(), [], []
    try:
        for _ in range(OT_WARM):
            t0 = time.perf_counter()
            values.append(ht.sum(_fu_nine(ht, x, b)).item())
            walls.append(time.perf_counter() - t0)
    finally:
        fusion._PROGRAMS[sig] = timed.prog
    torch.cuda.synchronize()
    event_s = sum(s.elapsed_time(e) for s, e in timed.pairs) / 1e3
    ana = tl.analyze()
    path = os.path.join(tmp, "ops_trace.json")
    tel.export_trace(path)  # the window just analyzed
    # the program's device time per call, with the card kept busy
    pending = ht.sum(_fu_nine(ht, x, b))
    _, leaves, _ = fusion._signature(pending._payload)
    flat = fusion._flat(leaves)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    timed.prog(flat)
    start.record()
    for _ in range(OT_DEVICE_REPS):
        timed.prog(flat)
    stop.record()
    torch.cuda.synchronize()
    device_ms = start.elapsed_time(stop) / OT_DEVICE_REPS
    del pending, leaves, flat
    _ot_print_analysis("the whole window", ana)
    warm_events = [e for e in tel.events() if e["ts"] >= warm_from]
    stamps = [e["ts"] for e in warm_events if e["kind"] == "dispatch"]
    warm = tl.analyze(warm_events)
    _ot_print_analysis(f"the {OT_WARM} warm chains", warm)
    chains = ana["chains"]
    keys = set(fusion.cache_stats()["program_keys"])
    buckets = _ot_buckets(ana)
    execute = _ot_buckets(warm).get("device_execute", 0.0)
    wall_warm = float(np.median(walls))
    out.update({
        "window_s": ana["window_s"], "buckets_s": buckets, "unattributed_pct": ana["attribution"]["unattributed_pct"],
        "warm_buckets_s": _ot_buckets(warm), "warm_unattributed_pct": warm["attribution"]["unattributed_pct"],
        "critical_path": ana["critical_path"]["steps"][:5], "per_program": ana["attribution"]["per_program"],
        "findings": ana["findings"], "warm_findings": warm["findings"],
        "warm_chain_wall_ms": {"p50": wall_warm * 1e3, "p99": float(np.percentile(walls, 99)) * 1e3},
        "device_execute_s": execute, "device_s": OT_WARM * device_ms / 1e3, "device_ms_per_call": device_ms,
        "execute_over_device": execute / (OT_WARM * device_ms / 1e3), "cuda_event_s": event_s,
        "execute_over_events": execute / event_s,
        "call_host_ms_p50": float(np.median([r - c for c, r in timed.host])) * 1e3,
        "return_to_stamp_ms_p50": float(np.median([s - r for s, (_, r) in zip(stamps, timed.host)])) * 1e3,
        "compile_s": buckets.get("compile", 0.0), "cold_minus_warm_s": out["cold_s"] - wall_warm,
    })
    print(f"  device_execute of the warm chains {execute * 1e3:.3f} ms against their device time "
          f"{out['device_s'] * 1e3:.3f} ms ({device_ms:.4f} ms a call back to back; {out['execute_over_device']:.3f}x) "
          f"and against events around each call {event_s * 1e3:.3f} ms ({out['execute_over_events']:.3f}x); a "
          f"program call's host time p50 {out['call_host_ms_p50']:.3f} ms, its return to the dispatch stamp p50 "
          f"{out['return_to_stamp_ms_p50']:.3f} ms; a warm chain's wall p50 {wall_warm * 1e3:.3f} ms; the compile "
          f"bucket {out['compile_s']:.3f} s against the cold chain's {out['cold_s']:.3f} s less a warm one's "
          f"({out['cold_minus_warm_s']:.3f} s)", flush=True)
    if ana["attribution"]["unattributed_pct"] > OT_UNATTRIBUTED_PCT:
        raise AssertionError(f"ops_trace: {ana['attribution']['unattributed_pct']}% of the window unattributed")
    if len(chains) != OT_WARM + 1 or [(c["dispatches"], c["syncs"]) for c in chains] != [(1, 1)] * (OT_WARM + 1) \
            or [c["compiled"] for c in chains] != [True] + [False] * OT_WARM:
        raise AssertionError(f"ops_trace: the chains are not one dispatch and one sync each: {chains[:3]}")
    if set(ana["attribution"]["per_program"]) != keys or len(keys) != 1:
        raise AssertionError(f"ops_trace: per-program keys {sorted(ana['attribution']['per_program'])} are not the "
                             f"cache's {sorted(keys)}")
    with fusion.disabled():
        h = _fu_nine(ht, x, b)
        eager = float(ht.sum(h).larray)
    abs_sum = h.larray.double().abs().sum().item()
    del h
    out["fused_vs_eager"] = _fu_sum_check("ops_trace cold chain vs eager", cold, eager, abs_sum)
    if any(v != cold for v in values):
        raise AssertionError("ops_trace: a warm chain's value differs from the cold one's")
    # the read-per-chain loop is a sync storm by the detector's definition
    # (more than HEAT_TPU_TRACELENS_SYNC_STORM_K blocking syncs within 1 s);
    # with the threshold at the loop's own count of reads the warm window
    # names nothing
    storm = [f for f in warm["findings"] if f["rule"] == "tracelens.sync_storm"]
    others = [f for f in warm["findings"] if f["rule"] != "tracelens.sync_storm" and f["severity"] != "info"]
    quiet = tl.analyze(warm_events, sync_storm_k=OT_WARM)
    out["warm_findings_at_k"] = quiet["findings"]
    if others or len(storm) != 1 or storm[0]["data"]["syncs"] <= tl._SYNC_STORM_K or \
            [f for f in quiet["findings"] if f["severity"] != "info"]:
        raise AssertionError(f"ops_trace: the warm window's findings {warm['findings']}")
    if not OT_EXECUTE_RANGE[0] * out["device_s"] <= execute <= OT_EXECUTE_RANGE[1] * out["device_s"]:
        raise AssertionError(f"ops_trace: device_execute {execute:.6f} s outside {OT_EXECUTE_RANGE} x the chains' "
                             f"device time {out['device_s']:.6f} s")
    if not out["compile_s"] >= OT_COMPILE_SHARE * out["cold_minus_warm_s"]:
        raise AssertionError(f"ops_trace: compile bucket {out['compile_s']:.3f} s under {OT_COMPILE_SHARE} x "
                             f"{out['cold_minus_warm_s']:.3f} s")
    # the exported file through the command line, in its own process
    res = cli.run(["analyze", path, "--json"])
    doc = json.loads(res["stdout"])
    diffs = {bk: abs(doc["attribution"]["overall"].get(bk, {}).get("s", 0.0) - s) for bk, s in buckets.items()}
    out["cli"] = {"rc": res["rc"], "max_bucket_diff_s": max(diffs.values()), "cuda_initialized": res["cuda_initialized"],
                  "same_findings": doc["findings"] == json.loads(json.dumps(ana["findings"]))}
    print(f"  python -m heat_tpu_torch.telemetry analyze {os.path.basename(path)} --json in its own process: exit "
          f"{res['rc']}, buckets within {out['cli']['max_bucket_diff_s']:.3e} s of the live analysis, the same "
          f"findings {out['cli']['same_findings']}, CUDA initialized there {res['cuda_initialized']}", flush=True)
    gate = int(any(f["severity"] in ("error", "warning") for f in ana["findings"]))
    if set(doc["attribution"]["overall"]) != set(buckets) or out["cli"]["max_bucket_diff_s"] > OT_BUCKET_TOL_S \
            or not out["cli"]["same_findings"] or res["cuda_initialized"] or res["rc"] != gate:
        raise AssertionError(f"ops_trace: the command line's analysis differs: {out['cli']}, {res['stderr'][-2000:]}")
    # the flight bundle's diagnosis of the ring
    dump = hr.dump_flight(os.path.join(tmp, "ops_trace_flight.json"), reason="ops_trace")
    with open(dump["path"]) as fh:
        diag = json.load(fh)["diagnosis"]
    want = {"text", "window_s", "attribution", "unattributed_pct", "critical_path", "stragglers", "findings"}
    out["flight"] = {"problems": dump["problems"], "diagnosis_keys": sorted(diag),
                     "unattributed_pct": diag.get("unattributed_pct")}
    print(f"  flight dump: trace problems {dump['problems']}, diagnosis keys {sorted(diag)}, its window "
          f"{diag.get('window_s')} s, unattributed {diag.get('unattributed_pct')}%", flush=True)
    if dump["problems"] or set(diag) != want or "trace window" not in diag["text"]:
        raise AssertionError(f"ops_trace: the flight bundle's diagnosis does not validate: {diag}")
    out["static_analysis"] = ot_static_analysis_leg(ht, fusion)
    return out


def ot_detectors_phase(ht, tel, tl, nl, x) -> dict:
    """(b) Each detector in its own telemetry window: a sync storm, a
    retrace storm of one-op layouts, a resplit ping-pong on four shards and
    the canary's injected SDC."""
    import torch

    from heat_tpu_torch.core import resilience
    from heat_tpu_torch.core.communication import MeshCommunication

    out = {}
    print(f"phase ops_trace: the detectors: {OT_STORM_READS} reads in one span, {len(OT_LAYOUT_ROWS)} one-op layouts, "
          f"resplits 0 -> 1 -> 0 -> 1 on {OT_P} shards, numeric.sdc.1 under the full lens", flush=True)

    def hits(ana, rule):
        return [f for f in ana["findings"] if f["rule"] == rule]

    tel.reset()
    want = ht.sum(x).item()
    with tel.span("reads"):
        got = [ht.sum(x).item() for _ in range(OT_STORM_READS)]
    storm = hits(tl.analyze(), "tracelens.sync_storm")
    out["sync_storm"] = storm
    print(f"  sync storm: {storm}", flush=True)
    if len(storm) != 1 or storm[0]["data"] != {"span": "reads", "syncs": OT_STORM_READS} or set(got) != {want}:
        raise AssertionError(f"ops_trace: the span's reads gave {storm}")

    tel.reset()
    sums = [ht.sum(x[:m]).item() for m in OT_LAYOUT_ROWS]
    retrace = hits(tl.analyze(), "tracelens.retrace_storm")
    compiles = [e for e in tel.events() if e["kind"] == "compile"]
    out["retrace_storm"] = retrace
    print(f"  retrace storm: {len(compiles)} compile events, family {compiles[0].get('family') if compiles else None}; "
          f"{retrace}", flush=True)
    if len(retrace) != 1 or retrace[0]["data"]["compiles"] != len(OT_LAYOUT_ROWS) or len(set(sums)) < 2:
        raise AssertionError(f"ops_trace: {len(OT_LAYOUT_ROWS)} one-op layouts gave {retrace}")

    mesh = MeshCommunication([torch.device("cuda", 0)] * OT_P)
    x4 = ht.array(x.larray, split=0, comm=mesh)
    tel.reset()
    z = x4 * 1.0
    for split in (1, 0, 1):
        z = ht.resplit(z, split)
    trail = [e.get("detail") for e in tel.events() if e["kind"] == "fused_collective" and e["op"] == "reshard"]
    equal = bool(torch.equal(torch.cat(z.shards, dim=1), x.larray))
    pingpong = hits(tl.analyze(), "tracelens.reshard_pingpong")
    out["reshard_pingpong"] = {"findings": pingpong, "details": trail, "bit_for_bit": equal}
    print(f"  reshard ping-pong: reshard details {trail}, the result equal to the table bit for bit {equal}; "
          f"{pingpong}", flush=True)
    if len(pingpong) != 1 or pingpong[0]["data"]["targets"] != ["split=1", "split=0", "split=1"] or not equal:
        raise AssertionError(f"ops_trace: resplits 0 -> 1 -> 0 -> 1 gave {pingpong}, details {trail}")
    del x4, z

    tel.reset()
    prev = nl.set_mode("full")
    try:
        resilience.reset_device_faults()
        with resilience.inject("numeric.sdc.1", times=1):
            nl.run_canary(comm=mesh)
        diag = tl.diagnose(tel.events())
    finally:
        nl.set_mode(prev)
        resilience.reset_device_faults()
        nl.reset()
    sdc = hits(diag, "tracelens.sdc")
    out["sdc"] = sdc
    print(f"  numeric.sdc.1 under the full lens: {sdc}", flush=True)
    if len(sdc) != 1 or sdc[0]["severity"] != "error" or sdc[0]["data"]["device"] != "cuda:0":
        raise AssertionError(f"ops_trace: diagnose did not surface the injected SDC: {diag['findings']}")
    return out


def ot_fit_phase(ht, tel, tl, x, init) -> dict:
    """(c) Config 3's fit under the verbose timeline, analyzed, beside the
    profiler's busy share of the same fit: a reading. The fit's Lloyd
    launches come from ops/lloyd.py and record nothing; the window is the
    user's span around the fit and the read of its centres."""
    import torch

    from heat_tpu_torch.ops import lloyd

    tel.reset()
    before = lloyd.LAUNCHES
    with _profiled() as prof:
        t0 = time.perf_counter()
        with tel.span("fit"):
            model = ht.cluster.KMeans(n_clusters=K, init=init, max_iter=ITERS, tol=-1.0).fit(x)
            model.cluster_centers_.numpy()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launches = lloyd.LAUNCHES - before
    busy = sum(r[0] for r in _device_rows(prof))
    ana = tl.analyze()
    print(f"phase ops_trace: KMeans.fit on {N} x {F}, {launches} Lloyd launches, wall {wall_ms:.3f} ms (profiler on), "
          f"the profiler's busy share {100 * busy / wall_ms:.1f}%", flush=True)
    _ot_print_analysis("the fit's window", ana)
    if launches != ITERS:
        raise AssertionError(f"ops_trace: the fit launched the Lloyd kernel {launches} times, not {ITERS}")
    return {"launches": launches, "wall_ms": wall_ms, "busy_ms": busy, "busy_pct": 100 * busy / wall_ms,
            "buckets_s": _ot_buckets(ana), "unattributed_pct": ana["attribution"]["unattributed_pct"],
            "window_s": ana["window_s"], "chains": len(ana["chains"]), "findings": ana["findings"]}


def _ot_counters(text: str, kinds: dict) -> dict:
    """The counter samples of one exposition, ``{name{labels}: value}``."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        key, value = line.rsplit(" ", 1)
        name = key.split("{")[0]
        if kinds.get(name) == "counter" or name.endswith("_count"):
            out[key] = float(value)
    return out


def _ot_traffic(ht, serving, opsplane, tables, fit, port, leg: str, scrape: bool) -> dict:
    """Eight sessions on eight threads reading their tables OT_ROUNDS times
    (the column moments and a z-score), a ninth fitting config 3, and with
    ``scrape`` a scraper reading /metrics at 10 Hz."""
    import threading

    import numpy as np
    import torch

    from heat_tpu_torch.ops import lloyd

    kinds = {name: spec[0] for name, spec in opsplane.SCHEMA.items()}
    names = [f"{leg}-tenant{i}" for i in range(NS_TENANTS)] + [f"{leg}-kmeans"]
    barrier = threading.Barrier(NS_TENANTS + 1 + int(scrape))
    stop, errors, lat = threading.Event(), [], {}
    scrapes = {"ms": [], "bytes": 0, "samples": 0, "problems": [], "unknown": set(), "fell": [], "tenants": set()}

    def tenant(i):
        try:
            lat[i] = []
            with serving.Session(names[i]):
                barrier.wait(timeout=60)
                for _ in range(OT_ROUNDS):
                    lat[i].append(_ns_read_ms(lambda: _ns_moments(ht, tables[i]).larray.reshape(-1)[:1].item()))
                    lat[i].append(_ns_read_ms(lambda: _fc_zscore(ht, tables[i]).larray.reshape(-1)[:1].item()))
        except Exception as exc:  # noqa: BLE001 - raised below
            errors.append(exc)

    def fitter():
        try:
            with serving.Session(names[-1]):
                barrier.wait(timeout=60)
                before = lloyd.LAUNCHES
                ht.cluster.KMeans(n_clusters=K, init=fit["init"], max_iter=ITERS, tol=-1.0).fit(fit["x"])
                torch.cuda.synchronize()
                fit["launches"] = lloyd.LAUNCHES - before
        except Exception as exc:  # noqa: BLE001 - raised below
            errors.append(exc)

    def scraper():
        try:
            last = {}
            barrier.wait(timeout=60)
            while not stop.is_set():
                t0 = time.perf_counter()
                code, text, ms = _ot_get(port, "/metrics")
                scrapes["ms"].append(ms)
                scrapes["problems"] += opsplane.validate_exposition(text) + ([f"code {code}"] if code != 200 else [])
                fams = {ln.split("{")[0].split()[0] for ln in text.splitlines() if ln and not ln.startswith("#")}
                known = set(kinds) | {"heat_tpu_latency_seconds" + s for s in ("_bucket", "_sum", "_count")}
                scrapes["unknown"] |= fams - known
                counters = _ot_counters(text, kinds)
                scrapes["fell"] += [k for k, v in counters.items() if v < last.get(k, 0.0)]
                last.update(counters)
                scrapes["tenants"] |= {k.split('tenant="')[1].split('"')[0] for k in counters if 'tenant="' in k}
                scrapes["bytes"], scrapes["samples"] = len(text.encode()), sum(
                    1 for ln in text.splitlines() if ln and not ln.startswith("#"))
                stop.wait(max(0.0, OT_SCRAPE_S - (time.perf_counter() - t0)))
        except Exception as exc:  # noqa: BLE001 - raised below
            errors.append(exc)

    threads = [threading.Thread(target=tenant, args=(i,)) for i in range(NS_TENANTS)] + [threading.Thread(target=fitter)]
    extra = [threading.Thread(target=scraper)] if scrape else []
    t0 = time.perf_counter()
    for t in threads + extra:
        t.start()
    for t in threads:
        t.join(timeout=600)
    stop.set()
    for t in extra:
        t.join(timeout=60)
    if errors:
        raise errors[0]
    reads = np.concatenate([np.asarray(v) for v in lat.values()])
    out = {"seconds": time.perf_counter() - t0, "reads_ms": reads.tolist(), "read_p50_ms": float(np.percentile(reads, 50)),
           "read_p99_ms": float(np.percentile(reads, 99)), "fit_launches": fit["launches"], "names": names}
    if scrape:
        out.update({"scrapes_ms": scrapes["ms"], "scrape_p50_ms": float(np.percentile(scrapes["ms"], 50)),
                    "scrape_p99_ms": float(np.percentile(scrapes["ms"], 99)), "exposition_bytes": scrapes["bytes"],
                    "exposition_samples": scrapes["samples"], "problems": scrapes["problems"][:5],
                    "unknown_families": sorted(scrapes["unknown"]), "counters_fell": scrapes["fell"][:5],
                    "tenants": sorted(scrapes["tenants"] & set(names))})
    return out


def ot_ops_phase(ht, tel, fusion, serving, opsplane, hr, tables, fit, tmp: str, clis: dict) -> dict:
    """(d) The ops plane under serving traffic, scraped and not; (e) the
    burn-rate alert under the tenants' traffic."""
    import numpy as np

    out = {}
    print(f"phase ops_trace: the ops plane: {NS_TENANTS} sessions and a fitting ninth, scraped at "
          f"{1 / OT_SCRAPE_S:.0f} Hz and not, the sampler at {OT_INTERVAL_S} s; then a dispatch SLO's burn alert",
          flush=True)
    # every batch one tenant's read can form: phase 20's programs when the
    # cache still holds them, so that no build falls in the windows
    t0, builds = time.perf_counter(), _fu_unique_graphs()
    for k in range(NS_TENANTS):
        for own in ("moments", "zscore"):
            others = [_ns_moments(ht, t) for t in tables[1:k + 1]]
            mine = _ns_moments(ht, tables[0]) if own == "moments" else _fc_zscore(ht, tables[0])
            mine.larray.reshape(-1)[:1].item()
            del others, mine
    out["warmup"] = {"seconds": time.perf_counter() - t0, "inductor_builds": _fu_unique_graphs() - builds}
    prev_interval, opsplane._INTERVAL_S = opsplane._INTERVAL_S, OT_INTERVAL_S
    prev_dir = hr.set_dump_dir(tmp)
    port = opsplane.serve(port=0)  # a bind that fails raises: the phase fails
    try:
        # every route once, a 640 MB chain pending throughout
        tel.reset()
        _ns_moments(ht, tables[0]).larray.reshape(-1)[:1].item()
        pending = _ns_moments(ht, tables[1])
        dispatches = sum(1 for e in tel.events() if e["kind"] == "dispatch")
        codes = {route: _ot_get(port, route)[0] for route in OT_ROUTES}
        still = fusion.is_deferred(pending)
        added = sum(1 for e in tel.events() if e["kind"] == "dispatch") - dispatches
        pending.larray
        out["routes"] = {"codes": codes, "pending_after": still, "dispatches_added": added}
        print(f"  routes: {codes}; the pending 640 MB chain pending after them {still}, dispatch events added "
              f"{added}", flush=True)
        if codes != OT_ROUTES or not still or added:
            raise AssertionError(f"ops_trace: the routes answered {codes}, pending {still}, {added} dispatches")
        res = clis["check"].run(["ops", "check", "--port", str(port)])
        out["ops_check"] = {"rc": res["rc"], "stdout": res["stdout"].strip().splitlines()}
        print(f"  ops check --port {port} in its own process: exit {res['rc']}: {out['ops_check']['stdout']}",
              flush=True)
        oks = [ln for ln in out["ops_check"]["stdout"] if ln.startswith("OK: ")]
        if res["rc"] or len(oks) != 2:
            raise AssertionError(f"ops_trace: ops check failed: {res['stdout']} {res['stderr'][-2000:]}")
        # the traffic, scraped and not, in the order A B B A
        compiles, legs = fusion.cache_stats()["compiles"], {}
        for leg, scrape in OT_LEGS:
            rec = legs[leg] = _ot_traffic(ht, serving, opsplane, tables, fit, port, leg, scrape)
            print(f"  {leg}: {rec['seconds']:.2f} s, a tenant's read p50 {rec['read_p50_ms']:.3f} / p99 "
                  f"{rec['read_p99_ms']:.3f} ms; the fit {rec['fit_launches']} Lloyd launches"
                  + (f"; {len(rec['scrapes_ms'])} scrapes p50 {rec['scrape_p50_ms']:.3f} / p99 "
                     f"{rec['scrape_p99_ms']:.3f} ms, {rec['exposition_bytes']} bytes and "
                     f"{rec['exposition_samples']} samples each; problems {rec['problems']}, unknown families "
                     f"{rec['unknown_families']}, counters that fell {rec['counters_fell']}, tenants "
                     f"{len(rec['tenants'])}" if scrape else ""), flush=True)
            if rec["fit_launches"] != ITERS:
                raise AssertionError(f"ops_trace: the {leg} fit launched {rec['fit_launches']} times")
            if scrape and (rec["problems"] or rec["unknown_families"] or rec["counters_fell"]
                           or not rec["scrapes_ms"] or len(rec["tenants"]) != NS_TENANTS + 1):
                raise AssertionError(f"ops_trace: the scrapes under traffic: {rec}")
        for label, scrape in (("scraped", True), ("quiet", False)):
            reads = np.concatenate([legs[leg].pop("reads_ms") for leg, sc in OT_LEGS if sc == scrape])
            out[label] = {"read_p50_ms": float(np.percentile(reads, 50)), "read_p99_ms": float(np.percentile(reads, 99)),
                          "legs": {leg: legs[leg] for leg, sc in OT_LEGS if sc == scrape}}
            if scrape:
                ms = np.concatenate([legs[leg].pop("scrapes_ms") for leg, sc in OT_LEGS if sc])
                out[label].update({"scrapes": len(ms), "scrape_p50_ms": float(np.percentile(ms, 50)),
                                   "scrape_p99_ms": float(np.percentile(ms, 99))})
        print(f"  pooled over two legs each: a tenant's read with the scraper p50 {out['scraped']['read_p50_ms']:.3f} "
              f"/ p99 {out['scraped']['read_p99_ms']:.3f} ms, without p50 {out['quiet']['read_p50_ms']:.3f} / p99 "
              f"{out['quiet']['read_p99_ms']:.3f} ms; {out['scraped']['scrapes']} scrapes p50 "
              f"{out['scraped']['scrape_p50_ms']:.3f} / p99 {out['scraped']['scrape_p99_ms']:.3f} ms", flush=True)
        out["retraces"] = fusion.cache_stats()["compiles"] - compiles
        billed = {r["name"]: r["stats"]["dispatches"] for r in serving.session_reports()}
        exported = {labels["tenant"]: v for name, labels, v in opsplane.collect()
                    if name == "heat_tpu_session_dispatches_total"}
        names = [n for leg in legs.values() for n in leg["names"]]
        out["billing_parity"] = all(exported.get(n) == float(billed[n]) for n in names)
        print(f"  per-tenant dispatch counters equal serving.session_reports(): {out['billing_parity']} "
              f"({sum(billed[n] for n in names)} dispatches over {len(names)} sessions); retraces "
              f"{out['retraces']}", flush=True)
        if not out["billing_parity"] or out["retraces"]:
            raise AssertionError(f"ops_trace: exported {exported}, billed {billed}, {out['retraces']} retraces")
        out["burn"] = _ot_burn(ht, serving, opsplane, hr, tel, tables, port, clis["alert"])
    finally:
        opsplane.shutdown()
        opsplane._INTERVAL_S = prev_interval
        hr.set_dump_dir(prev_dir)
        hr.set_slo(dispatch_ms=None)
    return out


def _ot_burn(ht, serving, opsplane, hr, tel, tables, port, cli) -> dict:
    """(e) ``set_slo(dispatch_ms=0.001)`` under the tenants' traffic: the
    two-window alert fires, /healthz answers 503 and ``ops check`` fails;
    the SLO lifted, the alert clears within the fast window."""
    import threading

    import numpy as np

    out, edges, stop, errors = {}, [], threading.Event(), []
    unsubscribe = opsplane.on_burn(lambda m, t, rising, s: edges.append((time.perf_counter(), m, t, rising)))

    def tenant(i):
        try:
            with serving.Session(f"burn-tenant{i}"):
                while not stop.is_set():
                    # a host read of the pending chain: its dispatch-to-done
                    # time is a ``dispatch`` latency sample
                    _ns_moments(ht, tables[i]).numpy()
        except Exception as exc:  # noqa: BLE001 - raised below
            errors.append(exc)

    def alert_active() -> bool:
        return bool(opsplane.burn_report()["alerts"].get("dispatch/*", {}).get("active"))

    threads = [threading.Thread(target=tenant, args=(i,)) for i in range(NS_TENANTS)]
    prev_burn = opsplane.set_burn(**OT_BURN)
    t_start = time.time()
    try:
        for t in threads:
            t.start()
        hr.set_slo(dispatch_ms=0.001)
        t0 = time.perf_counter()
        while not alert_active() and time.perf_counter() - t0 < OT_WAIT_S:
            time.sleep(0.02)
        out["to_alert_s"] = time.perf_counter() - t0
        fired = [e for e in tel.events() if e["kind"] == "slo_burn" and e.get("tenant") == "*"]
        _, text, _ = _ot_get(port, "/metrics")
        gauge = 'heat_tpu_slo_burn_alert{metric="dispatch",tenant="*"} 1' in text
        healthz = _ot_get(port, "/healthz")[0]
        res = cli.run(["ops", "check", "--port", str(port)])
        out.update({"alert": alert_active(), "gauge": gauge, "healthz_alerting": healthz, "slo_burn_events": len(fired),
                    "ops_check_rc": res["rc"], "ops_check": res["stdout"].strip().splitlines()})
        hr.set_slo(dispatch_ms=None)
        t0 = time.perf_counter()
        while alert_active() and time.perf_counter() - t0 < OT_WAIT_S:
            time.sleep(0.02)
        out["to_clear_s"] = time.perf_counter() - t0
        cleared = [e for e in tel.events() if e["kind"] == "slo_burn_clear" and e.get("tenant") == "*"]
        out.update({"cleared": not alert_active(), "slo_burn_clear_events": len(cleared),
                    "healthz_after": _ot_get(port, "/healthz")[0]})
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=120)
        hr.set_slo(dispatch_ms=None)
        opsplane.set_burn(**{k: prev_burn[k] for k in OT_BURN})
        unsubscribe()
    if errors:
        raise errors[0]
    pts = [ts for ts, _ in opsplane.series("heat_tpu_fusion_forces_total", {}) if ts >= t_start]
    gaps = np.diff(pts) if len(pts) > 1 else np.asarray([math.inf])
    out.update({"series_points": len(pts), "series_gap_median_s": float(np.median(gaps)),
                "edges": [(round(t - edges[0][0], 3), m, tn, r) for t, m, tn, r in edges if tn == "*"] if edges else []})
    print(f"  burn: alert after {out['to_alert_s']:.2f} s, gauge 1 {out['gauge']}, /healthz {out['healthz_alerting']}, "
          f"{out['slo_burn_events']} slo_burn event(s); ops check exit {out['ops_check_rc']} "
          f"({out['ops_check']}); lifted, cleared after {out['to_clear_s']:.2f} s with "
          f"{out['slo_burn_clear_events']} slo_burn_clear event(s), /healthz {out['healthz_after']}; "
          f"heat_tpu_fusion_forces_total {out['series_points']} points, median gap {out['series_gap_median_s']:.3f} s",
          flush=True)
    if not (out["alert"] and out["gauge"] and out["healthz_alerting"] == 503 and out["slo_burn_events"] >= 1
            and out["ops_check_rc"] == 1 and out["cleared"] and out["to_clear_s"] <= OT_BURN["fast_s"]
            and out["slo_burn_clear_events"] >= 1 and out["healthz_after"] == 200
            and abs(out["series_gap_median_s"] - OT_INTERVAL_S) <= 0.5 * OT_INTERVAL_S):
        raise AssertionError(f"ops_trace: the burn alert: {out}")
    return out


def ops_trace_path(ht, smi: str) -> dict:
    """Phase 21: the trace analyzer and the live ops plane on the card;
    returns its numbers."""
    import torch

    from heat_tpu_torch.core import fusion, opsplane, serving
    from heat_tpu_torch.core import health_runtime as hr
    from heat_tpu_torch.core import numlens as nl
    from heat_tpu_torch.core import telemetry as tel
    from heat_tpu_torch.core import tracelens as tl

    if not torch.cuda.is_available():
        raise RuntimeError("phase 21 needs CUDA")
    numbers = {"card": smi, "seconds": {}}
    t0, builds = time.perf_counter(), _fu_unique_graphs()
    tmp = tempfile.mkdtemp(prefix="heat_ops_trace_")
    clis = {name: _OtCli(tmp, name) for name in ("analyze", "check", "alert")}
    prev_mode = tel.set_mode(2)
    try:
        x, init = kmeans_table(ht)
        gen = torch.Generator(device="cuda")
        tables = [ht.array(torch.randn(N, F, generator=gen.manual_seed(SEED + 300 + i), device="cuda"), split=0)
                  for i in range(NS_TENANTS)]
        lap = time.perf_counter()
        numbers["ops"] = ot_ops_phase(ht, tel, fusion, serving, opsplane, hr, tables, {"x": x, "init": init}, tmp,
                                      clis)
        numbers["seconds"]["ops"] = time.perf_counter() - lap
        del tables
        torch.cuda.empty_cache()
        lap = time.perf_counter()
        b = ht.array(torch.randn(N, F, generator=gen.manual_seed(SEED + 21), device="cuda"), split=0)
        numbers["analyzer"] = ot_analyzer_phase(ht, tel, fusion, tl, hr, x, b, tmp, clis["analyze"])
        numbers["seconds"]["analyzer"] = time.perf_counter() - lap
        del b
        lap = time.perf_counter()
        numbers["detectors"] = ot_detectors_phase(ht, tel, tl, nl, x)
        numbers["seconds"]["detectors"] = time.perf_counter() - lap
        lap = time.perf_counter()
        numbers["fit"] = ot_fit_phase(ht, tel, tl, x, init)
        numbers["seconds"]["fit"] = time.perf_counter() - lap
    finally:
        for cli in clis.values():
            cli.stop()
        tel.set_mode(prev_mode)
        tel.reset()
        shutil.rmtree(tmp, ignore_errors=True)
    numbers["seconds"]["all"] = time.perf_counter() - t0
    numbers["inductor_builds"] = _fu_unique_graphs() - builds
    print(f"phase 21: {numbers['seconds']['all']:.1f} s, {numbers['inductor_builds']} Inductor builds "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in numbers['seconds'].items() if k != 'all')})", flush=True)
    return numbers


# ---------------------------------------------------------------------------
# the multi-process runtime (phase 22): the port's torch.distributed world,
# a one-rank NCCL world on the card, two processes on the card over gloo
# (the clean, killed and hung trainer) and config 3 read from .npy and fit
# by KMeans over a mesh whose ranks span two processes, through the Lloyd
# kernel
# ---------------------------------------------------------------------------
MP_STEPS = 8  # the lstsq trainer's steps, its checkpoint every MP_EVERY
MP_EVERY = 2
MP_KILL_STEP = 3
MP_RTOL = 1e-5  # world-size invariance, and the reform's final w against the clean run
MP_NUMPY_RTOL = 1e-12  # the clean 2-process w against numpy's float64 descent
MP_HANG_WALL_S = 60.0  # the hung peer's generation must end within this
MP_TIMEOUT_S = 240.0  # each launch, as the launcher's generation bound
MP_BARRIER_MS = 200.0  # the patched barrier's bound in the StallError check
MP_LAUNCH_KEYS = ("epoch", "world", "exits", "lost", "duration_s", "timed_out")

_MP_NCCL_PROBE = """
import json, os, sys, torch
import heat_tpu_torch as ht
from heat_tpu_torch.core import multihost
out = sys.argv[1]
doc = {"rank": int(os.environ["HEAT_TPU_PROCESS_ID"])}
try:
    comm = multihost.initialize_distributed(backend="nccl", device="gpu", heartbeat=False, timeout_s=60)
    got = comm.allreduce([torch.full((4,), float(doc["rank"] + 1), device="cuda")])[0]
    torch.cuda.synchronize()
    doc.update(ok=True, value=got.tolist())
except Exception as exc:
    doc.update(ok=False, error=f"{type(exc).__name__}: {exc}"[:2000])
with open(os.path.join(out, f"nccl-{doc['rank']}.json"), "w") as fh:
    json.dump(doc, fh)
os._exit(0)
"""


def _mp_env() -> dict:
    """The workers' environment: the package beside this script on the path."""
    root = os.path.dirname(os.path.abspath(__file__))
    path = os.environ.get("PYTHONPATH", "")
    return {"PYTHONPATH": root + (os.pathsep + path if path else "")}


def _mp_results(out: str) -> dict:
    """The trainer's result documents under ``out``, keyed (epoch, rank)."""
    docs = {}
    if os.path.isdir(out):
        for name in sorted(os.listdir(out)):
            if name.startswith("result-") and name.endswith(".json"):
                with open(os.path.join(out, name)) as fh:
                    doc = json.load(fh)
                docs[(doc["epoch"], doc["rank"])] = doc
    return docs


def _mp_final_w(docs: dict):
    import numpy as np

    done = [d for d in docs.values() if d["status"] == "done" and d["final_w"]]
    if not done:
        raise AssertionError(f"no finished trainer in {sorted(docs)}")
    return np.asarray(max(done, key=lambda d: d["epoch"])["final_w"])


def _mp_launch(multihost, n: int, args, root: str, log: str, env_extra=None, **kwargs) -> dict:
    """``n`` trainer processes under ``spawn_local``; their output goes to
    ``log``. Returns the launcher's summary and the result documents."""
    cmd = [sys.executable, "-m", "heat_tpu_torch.scripts.multiproc_trainer", "--out", os.path.join(root, "out"),
           *args]
    kwargs.setdefault("timeout_s", MP_TIMEOUT_S)
    t0 = time.perf_counter()
    with open(log, "ab") as fh:
        result = multihost.spawn_local(n, cmd, env=dict(_mp_env(), **(env_extra or {})), stdout=fh,
                                       mesh=os.path.join(root, "mesh"), **kwargs)
    result["seconds"] = time.perf_counter() - t0
    result["docs"] = _mp_results(os.path.join(root, "out"))
    return result


def _mp_gens(result: dict) -> list:
    return [{k: g.get(k) for k in MP_LAUNCH_KEYS} for g in result["generations"]]


def _mp_tail(log: str, n: int = 4000) -> str:
    with open(log, "rb") as fh:
        return fh.read()[-n:].decode(errors="replace")


def mp_one_rank_phase(ht, device: str) -> dict:
    """(a) A one-process world on the card: every verb of the
    process-spanning mesh against the in-process mesh bit for bit, a named
    barrier, a patched barrier's StallError, the report's multihost block
    and the ops plane's peer gauges."""
    import torch
    import torch.distributed as dist

    from heat_tpu_torch.core import communication, multihost, opsplane, resilience
    from heat_tpu_torch.core import telemetry as tel

    backend = "nccl" if device == "cuda" else "gloo"
    t0 = time.perf_counter()
    comm = multihost.initialize_distributed(f"127.0.0.1:{multihost._free_port()}", 1, 0, backend=backend,
                                            device="gpu" if device == "cuda" else "cpu", heartbeat=False)
    out = {"backend": dist.get_backend(), "init_s": time.perf_counter() - t0, "ranks": comm.size}
    try:
        if out["backend"] != backend or multihost.process_count() != 1 or multihost.process_index() != 0:
            raise AssertionError(f"one-rank world: {out}, {multihost.process_count()} processes")
        local = communication.MeshCommunication(list(comm.local_devices))
        gen = torch.Generator(device=comm.local_devices[0]).manual_seed(SEED + 22)
        checked = 0
        for dt in (torch.float32, torch.float64, torch.int64):
            def draw(shape):
                x = torch.randn(*shape, generator=gen, device=comm.local_devices[0]) * 100
                return [(x if dt.is_floating_point else x.round()).to(dt) for _ in comm.local_devices]

            a, b = draw((6, 4)), draw((6, 4))
            cases = {
                "allreduce": lambda m: m.allreduce(a),
                "allreduce max": lambda m: m.allreduce(a, "max"),
                "allreduce tuple": lambda m: m.allreduce([(x, y) for x, y in zip(a, b)]),
                "bcast": lambda m: m.bcast(a, root=0),
                "exscan": lambda m: m.exscan(a),
                "scan": lambda m: m.scan(a, "prod"),
                "allgather": lambda m: m.allgather(a, dim=1),
                "ppermute": lambda m: m.ppermute(a, shift=1),
                "alltoall": lambda m: m.alltoall(a, split_axis=0, concat_axis=1),
            }
            for name, fn in cases.items():
                got, want = fn(comm), fn(local)
                flat = [t for v in got for t in (v if isinstance(v, tuple) else (v,))]
                ref = [t for v in want for t in (v if isinstance(v, tuple) else (v,))]
                if len(flat) != len(ref) or any(
                        g.dtype != w.dtype or g.device != w.device or not torch.equal(g, w) for g, w in zip(flat, ref)):
                    raise AssertionError(f"{name} {dt}: the {backend} world differs from the in-process mesh")
                checked += 1
        out["verbs_bit_for_bit"] = checked
        multihost.sync_processes("chip_smoke.phase22")
        release = __import__("threading").Event()
        real_count, real_barrier = multihost.process_count, multihost._barrier
        multihost.process_count = lambda: 2
        multihost._barrier = lambda tag, timeout_ms: release.wait(30.0)
        t1 = time.perf_counter()
        try:
            with __import__("warnings").catch_warnings():
                __import__("warnings").simplefilter("ignore")
                multihost.sync_processes("chip_smoke.hung", timeout_ms=MP_BARRIER_MS)
            raise AssertionError("the hung barrier returned")
        except resilience.StallError as exc:
            if "chip_smoke.hung" not in str(exc):
                raise
            out["stall_error_ms"] = (time.perf_counter() - t1) * 1e3
        finally:
            multihost.process_count, multihost._barrier = real_count, real_barrier
            release.set()
        block = tel.report()["multihost"]
        want = {"world", "epoch", "barriers", "barrier_timeouts", "abandoned_threads", "heartbeats",
                "heartbeat_errors", "init_retries", "peers_lost", "heartbeat_running", "abandoned_alive"}
        if set(block) != want or block["barrier_timeouts"] < 1 or block["peers_lost"]:
            raise AssertionError(f"report()['multihost']: {block}")
        gauges = {n: v for n, _, v in opsplane.collect() if n.startswith(("heat_tpu_peer", "heat_tpu_barrier"))}
        if gauges.get("heat_tpu_peers_expected") != 1.0 or gauges.get("heat_tpu_peers_lost") != 0.0:
            raise AssertionError(f"the ops plane's peer gauges: {gauges}")
        if not opsplane.ready_status()["checks"]["peers"]:
            raise AssertionError("/readyz's peers check is down in a whole world")
        out["report"], out["gauges"] = block, gauges
    finally:
        ht.use_comm(None)
        dist.destroy_process_group()
        communication._CONTROL = None
    print(f"  one-rank {backend} world: init {out['init_s']:.2f} s, {out['verbs_bit_for_bit']} verb cases bit for "
          f"bit against the in-process mesh, StallError after {out['stall_error_ms']:.0f} ms", flush=True)
    return out


def mp_nccl_probe_phase(multihost, tmp: str) -> dict:
    """One attempt at a two-rank NCCL world on the one card; what NCCL
    answers is printed."""
    out_dir = os.path.join(tmp, "nccl")
    os.makedirs(out_dir)
    log = os.path.join(tmp, "nccl.log")
    with open(log, "wb") as fh:
        result = multihost.spawn_local(2, [sys.executable, "-c", _MP_NCCL_PROBE, out_dir], env=_mp_env(),
                                       stdout=fh, max_reforms=0, timeout_s=120.0,
                                       mesh=os.path.join(tmp, "nccl-mesh"))
    docs = []
    for name in sorted(os.listdir(out_dir)):
        with open(os.path.join(out_dir, name)) as fh:
            docs.append(json.load(fh))
    accepted = len(docs) == 2 and all(d["ok"] for d in docs)
    answer = "accepted" if accepted else "; ".join(sorted({d.get("error", "?") for d in docs})) or _mp_tail(log)
    print(f"  two-rank NCCL world on one card: {answer[:1500]}", flush=True)
    return {"accepted": accepted, "answer": answer, "exits": result["generations"][0]["exits"],
            "timed_out": result["generations"][0]["timed_out"]}


def mp_lstsq_phase(multihost, tmp: str, device: str, backend: str, beside=None) -> dict:
    """(b) the lstsq trainer on two processes over ``backend``: clean
    against one process and numpy, rank 1 killed at step 3 (one reform),
    rank 1 hung at step 3 (detected and reaped). The kill run goes alone,
    the other three side by side, with ``beside`` (a callable: another
    launch) in a thread of its own beside them."""
    import threading

    import numpy as np

    base = ["--device", device, "--backend", backend, "--steps", str(MP_STEPS), "--checkpoint-every", str(MP_EVERY)]
    legs = {
        "clean1": (1, [], {}),
        "clean2": (2, [], {}),
        "kill": (2, ["--die-rank", "1", "--die-at-step", str(MP_KILL_STEP)], {"max_reforms": 1}),
        "hang": (2, ["--hang-rank", "1", "--hang-at-step", str(MP_KILL_STEP)], {"max_reforms": 1}),
    }
    runs = {}

    def launch(label):
        n, extra, kw = legs[label]
        root = os.path.join(tmp, f"{backend}-{label}")
        try:
            runs[label] = _mp_launch(multihost, n, base + ["--ckpt-dir", os.path.join(root, "ckpt"), *extra], root,
                                     os.path.join(tmp, f"{backend}-{label}.log"), **kw)
        except Exception as exc:  # noqa: BLE001 - raised below with the leg's log
            runs[label] = {"ok": False, "generations": [], "error": repr(exc)}

    # the kill run alone, its downtime being a respawn's; the clean runs and
    # the hang run (whose hung rank only sleeps) side by side
    launch("kill")
    threads = [threading.Thread(target=launch, args=(label,)) for label in ("clean1", "clean2", "hang")]
    if beside is not None:
        threads.append(threading.Thread(target=beside))
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for label in legs:
        if not runs[label]["ok"]:
            raise AssertionError(f"lstsq {label} over {backend}: {runs[label].get('error')} {_mp_gens(runs[label])}\n"
                                 f"{_mp_tail(os.path.join(tmp, f'{backend}-{label}.log'))}")
    out = {label: {"seconds": r["seconds"], "generations": _mp_gens(r), "reforms": r["reforms"]}
           for label, r in runs.items()}
    # clean: both processes hold the same w, equal to one process's and to numpy's
    docs2 = runs["clean2"]["docs"]
    if sorted(docs2) != [(0, 0), (0, 1)] or docs2[(0, 0)]["final_w"] != docs2[(0, 1)]["final_w"]:
        raise AssertionError(f"clean 2-process run: {sorted(docs2)}")
    w1, w2 = _mp_final_w(runs["clean1"]["docs"]), _mp_final_w(docs2)
    rng = np.random.default_rng(7)
    X, y = rng.standard_normal((64, 16)), rng.standard_normal(64)
    w = np.zeros(16)
    for _ in range(MP_STEPS):
        w = w - 0.05 * (X.T @ (X @ w - y)) / 64
    out["clean2"]["rel_err_1proc"] = float(np.max(np.abs(w2 - w1) / np.abs(w1)))
    out["clean2"]["rel_err_numpy"] = float(np.max(np.abs(w2 - w) / np.abs(w)))
    if not (np.allclose(w2, w1, rtol=MP_RTOL, atol=0) and np.allclose(w2, w, rtol=MP_NUMPY_RTOL, atol=0)):
        raise AssertionError(f"clean w: {out['clean2']}")
    # kill: one reform into a world of one under epoch 1, replay <= every
    kill = runs["kill"]
    g0, g1 = kill["generations"]
    final = kill["docs"][(1, 0)]
    survivor = kill["docs"].get((0, 0))
    if (kill["reforms"], g0["lost"], g1["world"], g1["epoch"], g1["exits"]) != (1, [1], 1, 1, [0]):
        raise AssertionError(f"kill: {_mp_gens(kill)}")
    replayed = (survivor["completed_steps"] if survivor else MP_KILL_STEP) - final["resumed_from"]
    if final["resumed_from"] is None or replayed > MP_EVERY:
        raise AssertionError(f"kill: resumed from {final['resumed_from']}, survivor {survivor}")
    wk = _mp_final_w(kill["docs"])
    # the death is rank 1's last beacon (step 3); the downtime ends at the
    # first step of generation 1
    death = os.stat(multihost._progress_path(kill["mesh"], 0, 1)).st_mtime
    out["kill"].update(rel_err_clean=float(np.max(np.abs(wk - w2) / np.abs(w2))), replayed=replayed,
                       resumed_from=final["resumed_from"], downtime_s=g1["t_first_progress"] - death)
    if not np.allclose(wk, w2, rtol=MP_RTOL, atol=0):
        raise AssertionError(f"kill: final w {out['kill']}")
    # hang: detected, reaped, the generation bounded
    hang = runs["hang"]
    h0, h1 = hang["generations"]
    if (hang["reforms"], h0["lost"], h0["timed_out"], h1["exits"]) != (1, [1], False, [0]) or h0["exits"][1] == 0:
        raise AssertionError(f"hang: {_mp_gens(hang)}")
    if h0["duration_s"] > MP_HANG_WALL_S or hang["docs"][(1, 0)]["completed_steps"] != MP_STEPS:
        raise AssertionError(f"hang: generation 0 took {h0['duration_s']} s")
    out["hang"]["wall_s"] = h0["duration_s"]
    print(f"  lstsq over {backend}: clean 2 processes {runs['clean2']['seconds']:.1f} s (w against 1 process "
          f"{out['clean2']['rel_err_1proc']:.2e}, against numpy {out['clean2']['rel_err_numpy']:.2e}); kill at step "
          f"{MP_KILL_STEP}: 1 reform, epoch 1, world 1, resumed from {final['resumed_from']} ({replayed} replayed), "
          f"w within {out['kill']['rel_err_clean']:.2e}, downtime {out['kill']['downtime_s']:.2f} s; hung peer reaped, "
          f"generation 0 {h0['duration_s']:.1f} s", flush=True)
    return out


def mp_spanning_phase(ht, multihost, tmp: str, device: str, rows: int, smi: str, sizes=None) -> dict:
    """(c) Config 3 over a mesh whose ranks span two processes on the card,
    through the array's entry points (``--workload kmeans``): each process
    reads its rows of the ``.npy`` table, takes config 1's moments, fits
    ``KMeans`` through the Lloyd kernel and saves the table and the
    centers. Held bit for bit against this process's two-shard mesh of the
    card running the same calls on the eager engines; the workers'
    checkpoint restored here on two shards and on one. The same launch
    then runs the main path (:func:`mp_mainpath_leg`) at the shapes of
    ``multiproc_trainer.MAIN_SIZES``, of which ``sizes`` overrides some (a
    rehearsal on the CPU cuts them)."""
    import numpy as np
    import torch

    from heat_tpu_torch.core import communication
    from heat_tpu_torch.scripts import multiproc_trainer as trainer
    from heat_tpu_torch.utils.checkpoint import load_checkpoint, verify_checkpoint

    card = torch.device(device, 0) if device == "cuda" else torch.device("cpu")

    def sync():
        if card.type == "cuda":
            torch.cuda.synchronize()

    root = os.path.join(tmp, "spanning")
    os.makedirs(root)
    table, ckpt = os.path.join(root, "config3.npy"), os.path.join(root, "ckpt")
    data = trainer.lloyd_table(rows, F, K, SEED, card)
    np.save(table, data.cpu().numpy())
    del data
    nbytes = rows * F * 4
    main_args = [a for key, value in (sizes or {}).items() for a in (f"--{key.replace('_', '-')}", str(value))]
    sizes = {**trainer.MAIN_SIZES, **trainer.LAYER_SIZES, **(sizes or {})}
    workloads = ",".join(("kmeans",) + trainer.MAIN_WORKLOADS + trainer.LAYER_WORKLOADS)
    run = _mp_launch(multihost, 2, ["--workload", workloads, "--device", device,
                                    "--backend", "gloo", "--table", table, "--ckpt-dir", ckpt, "--iters",
                                    str(ITERS), "--clusters", str(K), "--seed", str(SEED), *main_args],
                     root, os.path.join(tmp, "spanning.log"),
                     env_extra={"OMP_NUM_THREADS": "1"} if device == "cpu" else None)
    if not run["ok"]:
        raise AssertionError(f"spanning: {_mp_gens(run)}\n{_mp_tail(os.path.join(tmp, 'spanning.log'))}")
    docs = [run["docs"][(0, r)] for r in range(2)]
    # the same calls on this process's two-shard mesh of the card; the
    # spanning mesh runs the eager engines (its recorder stays eager)
    two = communication.MeshCommunication([card, card])
    with ht.core.fusion.disabled():
        x = ht.load_npy(table, split=0, comm=two)
        moments = trainer.digests(two, trainer.kmeans_moments(ht, x))
        km, one = trainer.timed_fit(ht, x, K, ITERS, SEED)
        launches_one = one["launches"]
        again = trainer.kmeans_fit(ht, x, K, ITERS, SEED)
    labels = trainer.digests(two, {"labels": km.labels_})["labels"]
    # the same seed, the same fit: the kmeans++ draws add their weights
    # exactly, so no scan's order picks another row
    if not (torch.equal(again.cluster_centers_.larray, km.cluster_centers_.larray)
            and trainer.digests(two, {"labels": again.labels_})["labels"] == labels):
        raise AssertionError(f"a second fit from the same seed differs: inertia {again.inertia_} against "
                             f"{km.inertia_}")
    del again
    centers = km.cluster_centers_.larray
    out = {
        "seconds": run["seconds"],
        "launches": [d["launches"] for d in docs],
        "launches_one_process": launches_one,
        "n_iter": [d["n_iter"] for d in docs],
        "ms_per_iter": [d["ms_per_iter"] for d in docs],
        "allreduce_ms_per_iter": [d["allreduce_ms_per_iter"] for d in docs],
        "fit_s": [d["fit_s"] for d in docs],
        "fit_parts_s": [d["parts_s"] for d in docs],
        "fit_calls_s": [d["calls_s"] for d in docs],
        "one_process": {key: one[key] for key in ("ms_per_iter", "allreduce_ms_per_iter", "fit_s", "parts_s",
                                                  "calls_s")},
        "ingest_gbps": [d["ingest_bytes"] / 1e9 / d["ingest_s"] for d in docs],
        "save_gbps": [d["save_bytes"] / 1e9 / d["save_s"] for d in docs],
        "inertia": docs[0]["inertia"],
        "generations": _mp_gens(run),
    }
    if device == "cuda" and (out["launches"] != [ITERS, ITERS] or launches_one != 2 * ITERS):
        raise AssertionError(f"Lloyd launches in the spanning fit: {out['launches']} per process, {launches_one} "
                             "in one process")
    want_centers = centers.float().cpu().numpy().tobytes().hex()
    for q, d in enumerate(docs):
        if d["centers_hex"] != want_centers or d["inertia"] != float(km.inertia_) or d["n_iter"] != km.n_iter_:
            err = float(np.max(np.abs(np.asarray(d["centers"], dtype=np.float32) - centers.float().cpu().numpy())))
            raise AssertionError(f"process {q}'s fit differs from the two-shard fit: inertia {d['inertia']} against "
                                 f"{float(km.inertia_)}, n_iter {d['n_iter']} against {km.n_iter_}, centers by "
                                 f"{err} at most")
        if any(labels[r] != sha for r, sha in d["labels_sha256"].items()):
            raise AssertionError(f"process {q}'s labels differ from the two-shard fit's")
        for name, got in d["moments"].items():
            want = moments[name]
            if (got != want) if isinstance(got, str) else any(want[r] != sha for r, sha in got.items()):
                raise AssertionError(f"process {q}'s {name} differs from the two-shard mesh's")
    if sorted(r for d in docs for r in d["labels_sha256"]) != ["0", "1"]:
        raise AssertionError(f"the processes' ranks: {[sorted(d['labels_sha256']) for d in docs]}")
    # the workers' checkpoint: clean, one fragment per rank from each
    # process's receipt, restored here on two shards and on one
    problems = verify_checkpoint(ckpt, 1)
    receipts = {}
    for q in range(2):
        with open(os.path.join(ckpt, "ckpt_1", f".receipt-{q}.json")) as fh:
            receipts[q] = sorted(os.path.basename(f) for f in json.load(fh) if ".shard_0" in f)
    if problems or receipts != {q: [f"leaf_00001.shard_{q:05d}"] for q in range(2)}:
        raise AssertionError(f"the checkpoint: problems {problems}, receipts {receipts}")
    out["restore_gbps"] = {}
    for p in (2, 1):
        mesh = communication.MeshCommunication([card] * p)
        template = {"table": ht.zeros((rows, F), split=0, comm=mesh), "centers": ht.zeros((K, F), comm=mesh)}
        sync()
        t0 = time.perf_counter()
        back = load_checkpoint(ckpt, template, step=1)
        sync()
        out["restore_gbps"][p] = nbytes / 1e9 / (time.perf_counter() - t0)
        whole = [torch.cat(x.lshards)] if p == 1 else x.lshards
        if not (all(torch.equal(a, b) for a, b in zip(back["table"].lshards, whole))
                and torch.equal(back["centers"].larray, centers)):
            raise AssertionError(f"the checkpoint restored on {p} shard(s) differs from the table or the centers")
        del back, template, whole
    del x, km
    print(f"  config 3 read from .npy and fit by KMeans across 2 processes (A11.5b): {out['launches']} Lloyd "
          f"launches ({launches_one} in the two-shard fit here, which a second fit from the seed repeats bit for "
          f"bit); centers, inertia, labels and "
          f"{len(moments)} moments bit for bit with the two-shard mesh of the card; checkpoint verified, one "
          f"fragment per rank from each receipt, restored on 2 and 1 shards bit for bit ({smi})", flush=True)

    def parts(t):
        calls = t["calls_s"]
        inner = {"kmeans++ calls": calls.get("kmeanspp", []), "allgather in init": calls.get("allgather in init", []),
                 "chunks": calls["iterations"], "allreduces in iterations, first and median": [
                     calls["allreduce in iterations"][0], float(np.median(calls["allreduce in iterations"]))]}
        return (", ".join(f"{k} {v:.4f}" for k, v in t["parts_s"].items()) + "; "
                + ", ".join(f"{k} {[round(v, 5) for v in vs]}" for k, vs in inner.items()))

    print(f"  spanning KMeans fit, its own {ITERS} iterations: ms per iteration {out['ms_per_iter']}, "
          f"cross-process allreduce {out['allreduce_ms_per_iter']} ms per iteration (gloo through the host), fit "
          f"{out['fit_s']} s by part (s): {' | '.join(parts(d) for d in docs)}; the same fit on the two-shard "
          f"mesh of one process: ms per iteration {one['ms_per_iter']}, allreduce {one['allreduce_ms_per_iter']} "
          f"ms, fit {one['fit_s']} s ({parts(one)}); ingest "
          f"{out['ingest_gbps']} GB/s per process, save {out['save_gbps']} GB/s per process, restore "
          f"{out['restore_gbps']} GB/s (checksums verified first); launch {run['seconds']:.1f} s ({smi})",
          flush=True)
    if card.type == "cuda":
        torch.cuda.empty_cache()
    out["mainpath"] = mp_mainpath_leg(ht, docs, card, smi, sizes)
    out["layers"] = mp_layers_leg(ht, docs, card, smi, sizes)
    return out


# the main path over the spanning mesh (phase 22, A11.5b(c1)): BASELINE's
# configs 2, 4 and 5 in the two workers of the spanning leg's launch, after
# their KMeans fit, each held bit for bit against the same calls on this
# process's two-shard mesh of the card:
# * config 2 at full width, cdist and rbf of 100,000 x 64 float32 by the
#   symmetric ring: per rank a 50,000 x 100,000 block (20 GB), compared by
#   digest (multiproc_trainer.block_digest) and freed before the next call;
#   on two ranks the ring is the diagonal tile and one rotation, two B2
#   launches per rank per call;
# * config 4 at 512 columns and phase 19's 2.5·10^6 rows (cut from 10^7):
#   CholeskyQR2 at condition 1, the probe's TSQR fallback at ~1e5; R's and
#   Q's blocks by digest, and the two-shard factors within phase 10's
#   float64 bounds (qr_errors, check_qr);
# * config 5, ResNet-50 at batch 256 float32: three DataParallel steps
#   (every BatchNorm a meeting across the processes, forward and backward)
#   and two DASO steps, one group per process; cuDNN deterministic in both
#   runs, losses and the parameters' digests bit for bit;
# * the exchange: an allreduce of 548 bytes and a ppermute of one
#   50,000 x 64 float32 block between the processes (timed, not compared;
#   exchange_timing.time_exchange).
# The shapes are multiproc_trainer.MAIN_SIZES.


def mp_mainpath_leg(ht, docs, card, smi: str, sizes: dict) -> dict:
    """The spanning leg's main-path workloads, read from the workers'
    documents ``docs`` and held against this process's two-shard mesh of
    ``card`` running the same workloads (:mod:`multiproc_trainer`)."""
    import numpy as np
    import torch

    from heat_tpu_torch.core import communication
    from heat_tpu_torch.scripts import multiproc_trainer as trainer

    two = communication.MeshCommunication([card, card])
    clock = trainer.VerbClock(two)
    mains = [d["mainpath"] for d in docs]
    cuda = card.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
    deterministic = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    errs = {}

    def keep(name, a, q, r):
        errs[name] = qr_errors(a.larray, q.larray, r.larray)
        check_qr(f"the two-shard qr at {name}", errs[name], sizes["qr_cols"])

    try:
        with ht.core.fusion.disabled():
            want = {
                "cdist": trainer.cdist_workload(ht, two, clock, sizes["cdist_rows"], sizes["cdist_features"],
                                                seed=SEED),
                "qr": trainer.qr_workload(ht, two, clock, sizes["qr_rows"], sizes["qr_cols"], seed=SEED, keep=keep),
                "dp": trainer.dp_workload(ht, two, clock, 2, sizes["dp_batch"], seed=SEED,
                                          image=(sizes["dp_image"],) * 2 + (3,), filters=sizes["dp_filters"]),
            }
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = deterministic
        if cuda:
            torch.cuda.empty_cache()
    out = {"launches": [sum(m["cdist"]["launches"].values()) for m in mains],
           "launches_two_shards": want["cdist"]["launches"], "qr_errors": errs,
           "qr_schedules": {k: v["schedule"] for k, v in want["qr"].items()},
           "dp_losses": want["dp"]["dp_losses"], "daso_losses": want["dp"]["daso_losses"],
           "parts_ms": [{k: v["ms"] for k, v in d["parts"].items() if not k.startswith(_LAYER_PARTS)} for d in docs],
           "parts_verbs": [{k: v["verbs"] for k, v in d["parts"].items() if not k.startswith(_LAYER_PARTS)}
                           for d in docs],
           "two_shard_parts_ms": {k: v["ms"] for k, v in clock.parts.items()},
           "exchange_ms": [{k: float(np.median(v)) for k, v in m["exchange"].items()} for m in mains],
           "exchange_ms_all": [m["exchange"] for m in mains]}
    if cuda and (any(m["cdist"]["launches"] != {"cdist": 2, "rbf": 2} for m in mains)
                 or want["cdist"]["launches"] != {"cdist": 4, "rbf": 4}):
        raise AssertionError(f"B2 launches of the spanning cdist and rbf: {[m['cdist']['launches'] for m in mains]} "
                             f"per process, {want['cdist']['launches']} on the two-shard mesh")
    if want["qr"]["cond1"]["schedule"] != ["cholqr2"] or want["qr"]["cond1e5"]["schedule"] != ["tsqr"]:
        raise AssertionError(f"qr's schedules on the two-shard mesh: {out['qr_schedules']}")
    for q, m in enumerate(mains):
        for name, got in m["cdist"]["digests"].items():
            if any(want["cdist"]["digests"][name][r] != digest for r, digest in got.items()):
                raise AssertionError(f"process {q}'s {name} blocks differ from the two-shard mesh's")
        for name, got in m["qr"].items():
            ref = want["qr"][name]
            if (got["schedule"], got["r"]) != (ref["schedule"], ref["r"]) or any(
                    ref["q"][r] != digest for r, digest in got["q"].items()):
                raise AssertionError(f"process {q}'s qr at {name} differs from the two-shard mesh's: schedule "
                                     f"{got['schedule']} against {ref['schedule']}")
        for key in ("dp_losses", "dp_params", "daso_losses", "daso_params"):
            if m["dp"][key] != want["dp"][key]:
                raise AssertionError(f"process {q}'s {key} differ from the two-shard mesh's: {m['dp'][key]} against "
                                     f"{want['dp'][key]}")
    if sorted(r for m in mains for r in m["cdist"]["digests"]["cdist"]) != ["0", "1"]:
        raise AssertionError(f"the processes' ranks: {[sorted(m['cdist']['digests']['cdist']) for m in mains]}")
    losses = want["dp"]["dp_losses"] + want["dp"]["daso_losses"]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"config 5's losses are not finite: {losses}")
    steps = [k for k in docs[0]["parts"] if k.startswith("dp step")]
    out["bn_meetings_per_step"] = [[d["parts"][k]["verbs"].get("allreduce", {}).get("calls", 0) - 1 for k in steps]
                                   for d in docs]
    print(f"  main path across 2 processes (A11.5b(c1)): config 2 cdist and rbf of {sizes['cdist_rows']} x "
          f"{sizes['cdist_features']} float32, B2 launches {[m['cdist']['launches'] for m in mains]} per process "
          f"({want['cdist']['launches']} on the two-shard mesh), every rank's block bit for bit by digest; config 4 "
          f"qr of {sizes['qr_rows']} x {sizes['qr_cols']}: {out['qr_schedules']}, R and Q's blocks bit for bit, "
          f"errors {json.dumps(errs)}; config 5 ResNet-50 batch {sizes['dp_batch']}: DataParallel losses "
          f"{want['dp']['dp_losses']}, DASO {want['dp']['daso_losses']}, losses and parameters bit for bit; "
          f"BatchNorm meetings per step {out['bn_meetings_per_step']} ({smi})", flush=True)
    print(f"  main path ms per part, per process: {out['parts_ms']}; on the two-shard mesh: "
          f"{out['two_shard_parts_ms']}; verbs per part (calls, ms): {out['parts_verbs']}; exchange medians "
          f"(ms): {out['exchange_ms']} ({smi})", flush=True)
    return out


# the layers over the spanning mesh (phase 22, A11.5b(c2a)), in the two
# workers of the spanning leg's launch after the main path, each held bit
# for bit against the same workloads on this process's two-shard mesh of
# the card (multiproc_trainer.LAYER_SIZES):
# * lm: the README's TransformerLM at full width and depth, batch 1, a
#   forward at MID_SEQ tokens through ring_attention and one through
#   ulysses_attention (SP_BLOCK), the logits by digest; one Adam step at
#   4,096 tokens through the ring, its gradients across the processes
#   (torch's deterministic algorithms on in both runs: the embedding's
#   backward); the loss and the parameters' digest. The verbs per forward
#   against the schedule: the ring 2(p - 1) ppermutes per layer, Ulysses 4
#   alltoalls per layer, each with one allgather per layer across the
#   processes that joins the output (none on the two-shard mesh);
# * parallel: the Megatron pair (TP_SHAPE) on a 'tp' line across the two
#   processes over TP_ROWS tokens, forward and one SGD step (the loss, each
#   rank's blocks and the forward after it); a pipeline of two README
#   TransformerBlocks on PP_BATCH x PP_SEQ activations; two experts;
# * estimators: convolve of CONV_N float32 with CONV_TAPS taps in "same"
#   and "full"; Lasso at LASSO_PROTOCOL; Spectral.fit of 10,000 x 16 blobs
#   (cut from SPECTRAL_N, 40,000: Lanczos holds the whole Laplacian in
#   each process), B1 counted per process (its similarity is the quadratic
#   expansion, a matrix product: B2 is not on Spectral's path); ping_mesh.


def mp_layers_leg(ht, docs, card, smi: str, sizes: dict) -> dict:
    """The spanning leg's layer workloads (``lm``, ``parallel``,
    ``estimators``), read from the workers' documents ``docs`` and held
    against this process's two-shard mesh of ``card`` running them."""
    import torch

    from heat_tpu_torch.core import communication
    from heat_tpu_torch.scripts import multiproc_trainer as trainer

    t0 = time.perf_counter()
    two = communication.MeshCommunication([card, card])
    clock = trainer.VerbClock(two)
    mains = [d["mainpath"] for d in docs]
    layer_sizes = {key: sizes[key] for key in trainer.LAYER_SIZES}
    want = {}
    with ht.core.fusion.disabled():
        for name, fn in (("lm", trainer.lm_workload), ("parallel", trainer.parallel_workload),
                         ("estimators", trainer.estimators_workload)):
            want[name] = fn(ht, two, clock, layer_sizes, seed=SEED)
            if card.type == "cuda":
                torch.cuda.empty_cache()
    depth, p = sizes["lm_depth"], 2
    schedule = {"ring": {"ppermute": 2 * (p - 1) * depth, "allgather": depth},
                "ulysses": {"alltoall": 4 * depth, "allgather": depth}}
    for q, (d, m) in enumerate(zip(docs, mains)):
        for name in ("lm", "parallel", "estimators"):
            for key, digest in m[name]["digests"].items():
                ref = want[name]["digests"][key]
                if (digest != ref) if isinstance(digest, str) else any(ref[r] != v for r, v in digest.items()):
                    raise AssertionError(f"process {q}'s {name} {key} differs from the two-shard mesh's")
        if m["lm"]["loss"] != want["lm"]["loss"] or m["parallel"]["tp_loss"] != want["parallel"]["tp_loss"]:
            raise AssertionError(f"process {q}'s losses differ: lm {m['lm']['loss']} against {want['lm']['loss']}, "
                                 f"tp {m['parallel']['tp_loss']} against {want['parallel']['tp_loss']}")
        if any(want["parallel"]["tp_params"][r] != v for r, v in m["parallel"]["tp_params"].items()):
            raise AssertionError(f"process {q}'s tensor-parallel blocks after the step differ from the two-shard mesh's")
        for sched, counts in schedule.items():
            verbs = {k: v["calls"] for k, v in d["parts"][f"lm {sched} forward"]["verbs"].items()}
            if verbs != counts:
                raise AssertionError(f"process {q}'s {sched} forward ran {verbs}, its schedule {counts}")
        ping = m["estimators"]["ping"]
        if not ping["ok"] or ping["devices"] != 2 or ping["platform"] != card.type:
            raise AssertionError(f"process {q}'s ping_mesh: {ping}")
    for sched, counts in schedule.items():
        verbs = {k: v["calls"] for k, v in clock.parts[f"lm {sched} forward"]["verbs"].items()}
        if verbs != {k: v for k, v in counts.items() if k != "allgather"}:
            raise AssertionError(f"the two-shard {sched} forward ran {verbs}")
    # every rank's block came from the one process that holds it
    per_rank = {"tp_params": [m["parallel"]["tp_params"] for m in mains]}
    for key, digest in want["estimators"]["digests"].items():
        if not isinstance(digest, str):
            per_rank[key] = [m["estimators"]["digests"][key] for m in mains]
    for key, got in per_rank.items():
        if sorted(r for g in got for r in g) != ["0", "1"]:
            raise AssertionError(f"the processes' ranks of {key}: {[sorted(g) for g in got]}")
    launches = [m["estimators"]["launches"]["spectral"] for m in mains]
    iterations = [m["estimators"]["spectral_iterations"] for m in mains]
    if card.type == "cuda" and (any(n["lloyd"] != i or n["pairwise"] for n, i in zip(launches, iterations))
                                or want["estimators"]["launches"]["spectral"]["lloyd"]
                                != 2 * want["estimators"]["spectral_iterations"]):
        raise AssertionError(f"Spectral's launches across processes {launches} over {iterations} iterations, on the "
                             f"two-shard mesh {want['estimators']['launches']['spectral']}")
    if not (math.isfinite(want["lm"]["loss"]) and math.isfinite(want["parallel"]["tp_loss"])):
        raise AssertionError(f"losses: lm {want['lm']['loss']}, tp {want['parallel']['tp_loss']}")
    parts = [{k: round(v["ms"], 1) for k, v in d["parts"].items() if k.startswith(_LAYER_PARTS)} for d in docs]
    out = {"lm_loss": want["lm"]["loss"], "tp_loss": want["parallel"]["tp_loss"],
           "spectral_launches": launches, "spectral_iterations": iterations,
           "spectral_launches_two_shards": want["estimators"]["launches"]["spectral"],
           "parts_ms": parts, "two_shard_parts_ms": {k: round(v["ms"], 1) for k, v in clock.parts.items()},
           "verbs": [{k: {verb: v["calls"] for verb, v in d["parts"][k]["verbs"].items()} for k in d["parts"]
                      if k.startswith(_LAYER_PARTS)} for d in docs],
           "workload_s": [{name: m[name]["seconds"] for name in trainer.LAYER_WORKLOADS} for m in mains],
           "ping": [m["estimators"]["ping"] for m in mains]}
    out["seconds"] = time.perf_counter() - t0
    print(f"  layers across 2 processes (A11.5b(c2a)): the README LM (depth {depth}) forward at "
          f"{sizes['lm_seq']} tokens through ring and Ulysses, logits bit for bit, verbs per forward {schedule} as "
          f"their schedules; one Adam step at {sizes['lm_step_seq']} tokens through the ring, gradients across the "
          f"processes, loss {out['lm_loss']} and parameters bit for bit; parallel/: the Megatron pair "
          f"{sizes['tp_dim']} x {sizes['tp_hidden']} on a 'tp' line across the processes, forward and one step "
          f"(loss {out['tp_loss']}), a 2-stage pipeline and 2 experts bit for bit; estimators: convolve of "
          f"{sizes['conv_n']} in same and full, Lasso {sizes['lasso_n']} x {sizes['lasso_f']}, Spectral "
          f"{sizes['spectral_n']} x 16 (B1 {[n['lloyd'] for n in launches]} per process over {iterations} iterations, "
          f"B2 {[n['pairwise'] for n in launches]}: its similarity is the quadratic expansion), ping_mesh ok, all bit "
          f"for bit ({smi})", flush=True)
    print(f"  layers ms per part, per process: {parts}; on the two-shard mesh: {out['two_shard_parts_ms']}; "
          f"workloads' seconds per process {out['workload_s']}; the leg's own {out['seconds']:.1f} s ({smi})",
          flush=True)
    return out


_LAYER_PARTS = ("lm ", "tp ", "pipeline", "experts", "convolve", "lasso", "spectral")


def multiprocess_path(ht, smi: str, device: str = "cuda", rows: int = N) -> dict:
    """Phase 22: the multi-process runtime on the card; returns its numbers
    (``rows`` config 3's table)."""
    from heat_tpu_torch.core import multihost

    numbers = {"card": smi, "seconds": {}}
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="heat_multiproc_")
    try:
        lap = time.perf_counter()
        numbers["one_rank"] = mp_one_rank_phase(ht, device)
        numbers["seconds"]["one_rank"] = time.perf_counter() - lap
        # the NCCL probe's launch beside the gloo lstsq runs that go side
        # by side; its answer decides whether the lstsq runs again over NCCL
        probe = {}

        def nccl_probe():
            lap = time.perf_counter()
            try:
                probe["answer"] = mp_nccl_probe_phase(multihost, tmp)
            except Exception as exc:  # noqa: BLE001 - raised below, after the lstsq runs
                probe["error"] = exc
            probe["seconds"] = time.perf_counter() - lap

        lap = time.perf_counter()
        numbers["lstsq_gloo"] = mp_lstsq_phase(multihost, tmp, device, "gloo",
                                               beside=nccl_probe if device == "cuda" else None)
        numbers["seconds"]["lstsq_gloo"] = time.perf_counter() - lap
        if "error" in probe:
            raise probe["error"]
        if probe:
            numbers["nccl_two_ranks"] = probe["answer"]
            numbers["seconds"]["nccl_probe_beside_lstsq"] = probe["seconds"]
            if probe["answer"]["accepted"]:
                lap = time.perf_counter()
                numbers["lstsq_nccl"] = mp_lstsq_phase(multihost, tmp, device, "nccl")
                numbers["seconds"]["lstsq_nccl"] = time.perf_counter() - lap
        lap = time.perf_counter()
        numbers["spanning"] = mp_spanning_phase(ht, multihost, tmp, device, rows, smi)
        numbers["seconds"]["spanning"] = time.perf_counter() - lap
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    numbers["seconds"]["all"] = time.perf_counter() - t0
    print(f"phase 22: {numbers['seconds']['all']:.1f} s, {smi} "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in numbers['seconds'].items() if k != 'all')})", flush=True)
    return numbers


# ---------------------------------------------------------------------------
# the elastic supervisor and the autoscale controller (phase 23): no kernel
# of their own. The README LM's steps under DataParallel.fit run B3 (12
# launches per replica per step forward, none in the backward), the
# interactive tenant's fit of config 3 runs B1 (30 launches). Bounds:
# * the elastic run's losses against the uninterrupted run's: the same
#   weights, batches and Adam; after the reform each replica takes two
#   sequences instead of one and the gradient is summed over two shards
#   instead of four, so the products run over other row counts and the sum
#   in another order (float association only; the model has no BatchNorm).
#   Phase 14's bound on four shards against one, MESH_TRAIN_BOUND relative,
#   holds each step's loss;
# * the DASO acceptance of tests/test_elastic.py:448-495 at p = 4, its own
#   bound 1e-5 on the losses and the probe's logits;
# * the fit during the shed and the shrink against the same fit unloaded:
#   bit for bit (its one-shard mesh of the card is never re-formed, B1's
#   launches are not dispatches and are never shed).
# ---------------------------------------------------------------------------
EL_P, EL_LOSE = 4, 2  # four shards of the card, two lost at the reform
EL_STEPS, EL_EVERY, EL_PREEMPT_AT = 8, 3, 5  # steps, checkpoint cadence, the poll that is preempted
EL_LOSS_RTOL = MESH_TRAIN_BOUND
EL_DASO_TOL = 1e-5
AS_P = 4
AS_INTERACTIVE = AS_BATCH = 4
AS_ROUNDS = 10  # z-score reads per tenant per leg
AS_DEADLINE_MS = 100.0
AS_SLO_MS = 1.0
AS_BURN = dict(target=0.9, fast_s=1.0, slow_s=4.0, threshold=1.0, min_samples=4)  # tests/test_autoscale.py:78-86
AS_ARM = dict(interval_s=60.0, cooldown_s=0.3, shrink_after_s=0.0, max_actions=4, min_devices=1, shrink_n=1)
AS_DECISIONS = {"shed_on": 1, "shed_off": 1, "shrink": 1, "recover": 1, "bound": 0, "errors": 0}


def _el_commits(elastic):
    """Wrap ``Supervisor.commit`` to time each commit and count its bytes
    (every tensor and array of the committed tree); returns the record list
    and the restore."""
    import numpy as np
    import torch

    from heat_tpu_torch.utils.checkpoint import _flatten

    records, real = [], elastic.Supervisor.commit

    def commit(self, tree, step):
        nbytes = sum(leaf.numel() * leaf.element_size() if isinstance(leaf, torch.Tensor)
                     else leaf.nbytes if isinstance(leaf, np.ndarray) else 0 for _, leaf in _flatten(tree))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real(self, tree, step)
        records.append({"step": int(step), "bytes": nbytes, "seconds": time.perf_counter() - t0})

    elastic.Supervisor.commit = commit
    return records, lambda: setattr(elastic.Supervisor, "commit", real)


def elastic_lm_phase(ht, tel, tmp: str) -> dict:
    """(a) The README LM under DataParallel on four shards of the card,
    uninterrupted and through DataParallel.fit with a preemption."""
    import torch

    from heat_tpu_torch.core import communication, elastic, resilience
    from heat_tpu_torch.ops import flash

    card = torch.device("cuda", 0)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    batches = [(t, t) for t in (torch.randint(0, LM["vocab"], (LM_BATCH, LM_SEQ), device="cuda", generator=gen)
                                for _ in range(EL_STEPS))]
    forward = []

    def loss_fn(logits, labels):
        # between the forward and the backward: the launches so far are the forward's
        forward.append(flash.LAUNCHES)
        flash.LAUNCHES = 0
        return next_token_loss(logits, labels)

    def trainer():
        dp = ht.nn.DataParallel(_lm(ht, torch.float32), comm=communication.get_comm(), optimizer=ht.optim.Adam(LM_LR),
                                loss_fn=loss_fn)
        return dp.init(SEED, batches[0][0][:1])

    print(f"phase elastic: the README's TransformerLM in float32 under DataParallel, Adam({LM_LR}), {EL_P} shards "
          f"of the card, {EL_STEPS} batches of {LM_BATCH} x {LM_SEQ} tokens: uninterrupted, then DataParallel.fit "
          f"with elastic.preempt at poll {EL_PREEMPT_AT}, a checkpoint every {EL_EVERY} steps, {EL_LOSE} ranks lost",
          flush=True)
    out = {}
    communication.reform([card] * EL_P)
    plain = trainer()
    t0 = time.perf_counter()
    plain_losses = [plain.train_step(x, y) for x, y in batches]
    torch.cuda.synchronize()
    out["uninterrupted_s"] = time.perf_counter() - t0
    del plain
    torch.cuda.empty_cache()
    communication.reform([card] * EL_P)
    dp = trainer()
    forward.clear()
    records, restore = _el_commits(elastic)
    prev = tel.set_mode(2)
    tel.reset()
    try:
        flash.LAUNCHES = 0
        t0 = time.perf_counter()
        with resilience.inject("elastic.preempt", every=EL_PREEMPT_AT, times=1):
            res = dp.fit(batches, directory=tmp, checkpoint_every=EL_EVERY, lose=EL_LOSE, install_signals=False)
        torch.cuda.synchronize()
        out["elastic_s"] = time.perf_counter() - t0
        backward = flash.LAUNCHES
        block = tel.report()["elastic"]
        kinds = [e["kind"] for e in tel.report()["events"] if str(e["kind"]).startswith("elastic_")]
    finally:
        restore()
        tel.set_mode(prev)
    out["report"] = block
    out["events"] = kinds
    out["mesh_after"] = dp.comm.size
    out["default_mesh_after"] = communication.get_comm().size
    out["forward_launches"] = list(forward)
    after = EL_STEPS - block["last_reform"]["step"]  # the steps run on the new mesh
    out["replicas"] = [EL_P] * (len(forward) - after) + [dp.comm.size] * after
    out["commits"] = records
    out["losses"], out["uninterrupted_losses"] = res["losses"], plain_losses
    rel = [abs(a - b) / abs(b) for a, b in zip(res["losses"], plain_losses)]
    out["loss_rel_max"], out["loss_rel"] = max(rel), rel
    print(f"  report()['elastic']: {block['preemptions']} preemption, {block['reforms']} reform, "
          f"{block['steps_replayed']} steps replayed, downtime {block['downtime_ms']:.1f} ms, {block['checkpoints']} "
          f"checkpoints, {block['drained_roots']} roots drained; events {kinds}", flush=True)
    print(f"  the mesh after the reform: {out['mesh_after']} shards (the default mesh {out['default_mesh_after']}); "
          f"flash launches per step forward {forward} ({LM['depth']} per replica), {backward} in the last backward", flush=True)
    for r in records:
        print(f"  commit of step {r['step']}: {r['bytes'] / 1e9:.3f} GB in {r['seconds']:.2f} s "
              f"({r['bytes'] / 1e9 / r['seconds']:.3f} GB/s)", flush=True)
    print(f"  losses {[round(v, 5) for v in res['losses']]} against uninterrupted "
          f"{[round(v, 5) for v in plain_losses]}: max relative {out['loss_rel_max']:.3e} (bound {EL_LOSS_RTOL:g}: "
          f"float association of the products and of the gradient's sum over {dp.comm.size} shards instead of "
          f"{EL_P}; no BatchNorm); uninterrupted {out['uninterrupted_s']:.1f} s, elastic {out['elastic_s']:.1f} s",
          flush=True)
    if not (block["preemptions"] == 1 and block["reforms"] == 1 and block["steps_replayed"] <= EL_EVERY
            and res["steps"] == EL_STEPS and out["mesh_after"] == EL_P - EL_LOSE == out["default_mesh_after"]):
        raise AssertionError(f"the elastic run did not preempt, reform and finish as set: {block}, {res['steps']} "
                             f"steps, mesh {out['mesh_after']}")
    if forward != [LM["depth"] * n for n in out["replicas"]] or backward != 0:
        raise AssertionError(f"flash launches per step forward {forward}, {backward} in the backward")
    if not all(math.isfinite(v) for v in res["losses"]) or out["loss_rel_max"] > EL_LOSS_RTOL:
        raise AssertionError(f"the elastic run's losses leave the uninterrupted run's: {rel}")
    out["launches"] = sum(forward) + backward
    del dp, res
    torch.cuda.empty_cache()
    return out


def elastic_daso_phase(ht, tmp: str) -> dict:
    """(b) tests/test_elastic.py:448-495 at p = 4 on the card: DASO with an
    MLP (8, 4), SGD 0.05 and an f32 wire, lose = p // 2."""
    import numpy as np
    import torch

    from heat_tpu_torch.core import communication, elastic, resilience

    card = torch.device("cuda", 0)
    p, lose = EL_P, EL_P // 2
    lcm = math.lcm(p, p - lose)
    n = lcm * max(1, 24 // lcm)
    rng = np.random.default_rng(7)
    batches = [(rng.standard_normal((n, 6)).astype(np.float32), rng.integers(0, 4, n).astype(np.int32))
               for _ in range(10)]
    probe = batches[0][0]

    def make():
        daso = ht.optim.DASO(local_optimizer=ht.optim.SGD(0.05), total_epochs=4, warmup_epochs=0, cooldown_epochs=0,
                             nodes=2, downcast_type=torch.float32)
        return daso.add_model(ht.nn.MLP(features=(8, 4), device="cuda",
                                        generator=torch.Generator(device="cuda").manual_seed(0)), 0, probe[:2])

    communication.reform([card] * p)
    ref = make()
    ref_losses = [ref.step(x, y) for x, y in batches]
    ref_logits = ref(probe).detach().cpu().numpy()
    communication.reform([card] * p)
    daso = make()
    elastic.reset()
    with resilience.inject("elastic.preempt", every=6, times=1):
        res = elastic.fit(daso, batches, directory=tmp, checkpoint_every=3, max_reforms=2, lose=lose,
                          install_signals=False)
    out = {"mesh_after": daso.comm.size, "elastic": res["elastic"],
           "loss_abs_max": float(np.max(np.abs(np.asarray(res["losses"]) - np.asarray(ref_losses)))),
           "logits_abs_max": float(np.max(np.abs(daso(probe).detach().cpu().numpy() - ref_logits)))}
    print(f"  DASO kill-a-host (tests/test_elastic.py:448) at p = {p}: {res['elastic']['reforms']} reform onto "
          f"{out['mesh_after']} shards, {res['elastic']['steps_replayed']} replayed; losses within "
          f"{out['loss_abs_max']:.3e}, logits within {out['logits_abs_max']:.3e} of the uninterrupted run "
          f"(bound {EL_DASO_TOL:g})", flush=True)
    np.testing.assert_allclose(res["losses"], ref_losses, rtol=EL_DASO_TOL, atol=EL_DASO_TOL)
    np.testing.assert_allclose(daso(probe).detach().cpu().numpy(), ref_logits, rtol=EL_DASO_TOL, atol=EL_DASO_TOL)
    if res["elastic"]["reforms"] != 1 or out["mesh_after"] != p - lose or res["steps"] != len(batches):
        raise AssertionError(f"the DASO run did not reform once onto {p - lose} shards: {res['elastic']}")
    return out


def _as_leg(ht, serving, bases, rounds: int, fit=None) -> dict:
    """One leg of the tenants' traffic: each tenant builds its table on the
    default mesh inside its session and reads its z-score ``rounds`` times;
    interactive reads are timed and those over AS_DEADLINE_MS counted,
    batch reads refused by a shed are counted. ``fit`` runs in a ninth,
    interactive session meanwhile."""
    import threading

    import numpy as np

    lat = {i: [] for i in range(AS_INTERACTIVE)}
    failures, refused, served = [], [], []
    barrier = threading.Barrier(len(bases) + (fit is not None))

    def tenant(i):
        interactive = i < AS_INTERACTIVE
        try:
            session = serving.Session(f"{'fg' if interactive else 'bg'}{i}",
                                      tier="interactive" if interactive else "batch",
                                      deadline_ms=AS_DEADLINE_MS if interactive else None)
            with session:
                x = ht.array(bases[i], split=0, copy=False)
                barrier.wait(timeout=120)
                for _ in range(rounds):
                    t0 = time.perf_counter()
                    try:
                        _fc_zscore(ht, x).larray.reshape(-1)[:1].item()
                    except serving.ShedError:
                        if interactive:
                            raise
                        refused.append(i)
                        continue
                    (lat[i] if interactive else served).append((time.perf_counter() - t0) * 1e3)
        except Exception as exc:  # noqa: BLE001 - counted, raised by the caller
            failures.append((i, repr(exc)))

    def fitter():
        try:
            with serving.Session("kmeans", tier="interactive", deadline_ms=AS_DEADLINE_MS):
                barrier.wait(timeout=120)
                fit["run"]()
        except Exception as exc:  # noqa: BLE001 - counted, raised by the caller
            failures.append(("fit", repr(exc)))

    from heat_tpu_torch.core import fusion

    threads = [threading.Thread(target=tenant, args=(i,)) for i in range(len(bases))]
    if fit is not None:
        threads.append(threading.Thread(target=fitter))
    t0, builds, stats = time.perf_counter(), _fu_unique_graphs(), fusion.cache_stats()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    reads = np.asarray([v for vs in lat.values() for v in vs])
    after = fusion.cache_stats()
    return {"seconds": time.perf_counter() - t0, "failures": failures, "refused": len(refused),
            "inductor_builds": _fu_unique_graphs() - builds, "programs_built": after["compiles"] - stats["compiles"],
            "forces": after["forces"] - stats["forces"],
            "batch_served": len(served), "interactive_reads": int(reads.size),
            "deadline_misses": int((reads > AS_DEADLINE_MS).sum()),
            "p50_ms": float(np.percentile(reads, 50)) if reads.size else None,
            "p99_ms": float(np.percentile(reads, 99)) if reads.size else None}


def autoscale_phase(ht, tel) -> dict:
    """(c) Eight tenants on four shards of the card under a burning SLO: the
    controller sheds, shrinks to three shards, and recovers to four."""
    import torch

    from heat_tpu_torch.core import autoscale, communication, health_runtime, opsplane, serving
    from heat_tpu_torch.ops import lloyd

    card = torch.device("cuda", 0)
    out = {}
    print(f"phase autoscale: {AS_INTERACTIVE} interactive tenants ({AS_DEADLINE_MS:g} ms deadline) and {AS_BATCH} "
          f"batch tenants, a {N} x {F} float32 table each on {AS_P} shards of the card, {AS_ROUNDS} z-score reads "
          f"per leg; a ninth, interactive tenant fits config 3 through the Lloyd kernel", flush=True)
    x, init = kmeans_table(ht)  # on the card's one-shard mesh, which no reform touches
    fits = {}

    def fit(label):
        def run():
            torch.cuda.synchronize()
            lloyd.LAUNCHES = 0
            t0 = time.perf_counter()
            model = ht.cluster.KMeans(n_clusters=K, init=init, max_iter=ITERS, tol=-1.0).fit(x)
            centers = model.cluster_centers_.larray.clone()
            torch.cuda.synchronize()
            fits[label] = {"launches": lloyd.LAUNCHES, "seconds": time.perf_counter() - t0, "centers": centers}
        return {"run": run}

    fit("unloaded")["run"]()
    gen = torch.Generator(device="cuda")
    bases = [torch.randn(N, F, generator=gen.manual_seed(SEED + 2300 + i), device="cuda")
             for i in range(AS_INTERACTIVE + AS_BATCH)]
    baseline = communication.reform([card] * AS_P)

    warms = []

    def warm():
        # the new mesh's program built outside the timed reads
        t0, builds = time.perf_counter(), _fu_unique_graphs()
        with serving.Session("warm", tier="interactive"):
            _fc_zscore(ht, ht.array(bases[0], split=0, copy=False)).larray.reshape(-1)[:1].item()
        warms.append({"seconds": time.perf_counter() - t0, "inductor_builds": _fu_unique_graphs() - builds})

    warm()
    out["before"] = _as_leg(ht, serving, bases, AS_ROUNDS)
    prev_slo = health_runtime.set_slo(dispatch_ms=AS_SLO_MS)
    prev_burn = opsplane.set_burn(**AS_BURN)
    prev_mode = tel.set_mode(2)
    ctl = autoscale.arm(**AS_ARM)
    try:
        for _ in range(16):  # tests/test_autoscale.py:86: the injected latency fault
            health_runtime._slo_observe("dispatch", 0.05)
        opsplane.sample()
        actions = [autoscale.poll()]
        t0 = time.perf_counter()
        actions.append(autoscale.poll())
        out["shrink_ms"] = (time.perf_counter() - t0) * 1e3
        out["mesh_shrunk"] = communication.get_comm().size
        warm()
        out["shedding"] = _as_leg(ht, serving, bases, AS_ROUNDS, fit=fit("shedding"))
        out["shed_refusals_total"] = serving.shed_state()["refusals"]
        time.sleep(AS_BURN["fast_s"] + 0.1)  # the fast window drains
        opsplane.sample()
        actions.append(autoscale.poll())
        time.sleep(AS_ARM["cooldown_s"] + 0.05)
        t0 = time.perf_counter()
        actions.append(autoscale.poll())
        out["recover_ms"] = (time.perf_counter() - t0) * 1e3
        out["mesh_recovered"] = communication.get_comm().size
        out["recovered_to_baseline"] = communication.get_comm().devices == baseline.devices
        health_runtime.set_slo(dispatch_ms=None)  # the burn is over: the after leg's reads breach nothing
        warm()
        out["after"] = _as_leg(ht, serving, bases, AS_ROUNDS)
        snap = ctl.snapshot()
        opsplane.sample()
        line = 'heat_tpu_autoscale_decisions_total{action="shed_on"} 1'
        out["exposition_has_shed_on"] = line in opsplane.render().splitlines()
        events = [e["kind"] for e in tel.report()["events"] if str(e["kind"]).startswith("autoscale_")]
    finally:
        autoscale.disarm()
        serving.shed(())
        tel.set_mode(prev_mode)
        health_runtime.set_slo(**{f"{m}_ms": None if v is None else v * 1e3 for m, v in prev_slo.items()})
        opsplane.set_burn(**{k: prev_burn[k] for k in AS_BURN})
        communication.reform()
    out["actions"], out["decisions"], out["events"], out["warmups"] = actions, snap["decisions"], events, warms
    out["fit"] = {k: {"launches": v["launches"], "seconds": v["seconds"]} for k, v in fits.items()}
    out["fit_bit_for_bit"] = bool(torch.equal(fits["shedding"]["centers"], fits["unloaded"]["centers"]))
    failures = [f for leg in ("before", "shedding", "after") for f in out[leg]["failures"]]
    print(f"  decisions {snap['decisions']} (actions {actions}); events {events}", flush=True)
    print(f"  shrink to {out['mesh_shrunk']} shards in {out['shrink_ms']:.1f} ms, recovery to "
          f"{out['mesh_recovered']} shards in {out['recover_ms']:.1f} ms (the baseline's devices: "
          f"{out['recovered_to_baseline']})", flush=True)
    for leg in ("before", "shedding", "after"):
        r = out[leg]
        print(f"  {leg}: interactive reads p50 {r['p50_ms']:.3f} / p99 {r['p99_ms']:.3f} ms over "
              f"{r['interactive_reads']} reads, {r['deadline_misses']} over the {AS_DEADLINE_MS:g} ms deadline; "
              f"batch reads served {r['batch_served']}, refused {r['refused']}; failures {r['failures']}; "
              f"{r['seconds']:.2f} s, {r['forces']} forces, {r['programs_built']} programs built "
              f"({r['inductor_builds']} by Inductor)", flush=True)
    print(f"  warm-ups of each mesh's read (before, shrunk, recovered): "
          f"{[(round(w['seconds'], 2), w['inductor_builds']) for w in warms]} (seconds, Inductor builds)", flush=True)
    print(f"  the fit: {fits['unloaded']['launches']} Lloyd launches unloaded ({fits['unloaded']['seconds']:.2f} s), "
          f"{fits['shedding']['launches']} during the shed and the shrink ({fits['shedding']['seconds']:.2f} s), "
          f"centers bit for bit {out['fit_bit_for_bit']}; shed refusals {out['shed_refusals_total']}; "
          f"exposition {line!r}: {out['exposition_has_shed_on']}", flush=True)
    if {k: snap["decisions"].get(k, 0) for k in AS_DECISIONS} != AS_DECISIONS or actions != [
            "shed_on", "shrink", None, "recover"]:
        raise AssertionError(f"the controller's decisions are not one shed_on, shrink, recover and shed_off: "
                             f"{snap['decisions']}, {actions}")
    if failures or out["shedding"]["refused"] < 1 or out["before"]["refused"] or out["after"]["refused"]:
        raise AssertionError(f"failures {failures}; refusals {[out[k]['refused'] for k in ('before', 'shedding', 'after')]}")
    # a read misses its deadline only behind a program built in its leg
    # (on the shrunk mesh the tenants' small roots batch in new orders, one
    # program each), which stalls at most one read of each interactive
    # tenant
    misses = {leg: (out[leg]["deadline_misses"], max(out[leg]["programs_built"], out[leg]["inductor_builds"]))
              for leg in ("before", "shedding", "after")}
    if any(m > AS_INTERACTIVE * b for m, b in misses.values()):
        raise AssertionError(f"interactive reads over the {AS_DEADLINE_MS:g} ms deadline (misses, programs built): "
                             f"{misses}")
    if not (out["mesh_shrunk"] == AS_P - 1 and out["mesh_recovered"] == AS_P and out["recovered_to_baseline"]):
        raise AssertionError(f"the mesh went to {out['mesh_shrunk']} and back to {out['mesh_recovered']} shards")
    if not (fits["unloaded"]["launches"] == fits["shedding"]["launches"] == ITERS and out["fit_bit_for_bit"]
            and out["exposition_has_shed_on"]):
        raise AssertionError("the fit's launches or centers, or the exposition's decision count, are wrong")
    del x, init, bases
    torch.cuda.empty_cache()
    return out


def elastic_autoscale_path(ht, smi: str) -> dict:
    """Phase 23: the elastic supervisor and the autoscale controller on the
    card; returns its numbers."""
    import torch

    from heat_tpu_torch.core import telemetry as tel

    if not torch.cuda.is_available():
        raise RuntimeError("phase 23 needs CUDA")
    numbers = {"card": smi, "seconds": {}}
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="heat_elastic_")
    try:
        lap = time.perf_counter()
        numbers["lm"] = elastic_lm_phase(ht, tel, os.path.join(tmp, "lm"))
        numbers["seconds"]["lm"] = time.perf_counter() - lap
        lap = time.perf_counter()
        numbers["daso"] = elastic_daso_phase(ht, os.path.join(tmp, "daso"))
        numbers["seconds"]["daso"] = time.perf_counter() - lap
    finally:
        ht.core.communication.reform()
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    lap = time.perf_counter()
    numbers["autoscale"] = autoscale_phase(ht, tel)
    numbers["seconds"]["autoscale"] = time.perf_counter() - lap
    numbers["seconds"]["all"] = time.perf_counter() - t0
    print(f"phase 23: {numbers['seconds']['all']:.1f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in numbers['seconds'].items() if k != 'all')}); {smi}", flush=True)
    return numbers


def recorded_path(fusion, paths: dict, label: str, fn, off=None):
    """Run one path with the recorder on, as a user gets the package: its
    seconds, programs (cache misses), Inductor builds (Dynamo graphs),
    forces, multi-root batches (dispatches of programs of several roots)
    and degraded forces go into ``paths``, and a degraded force fails it
    (no phase before 18 injects a fusion fault). A change of the default
    mesh clears the program cache and zeroes its counters (as heat_tpu's
    does): the counts carry across each clear. With ``off`` (a dict), run
    the path again with the collective nodes off and with the recorder off
    and keep those legs' numbers there. Returns the recorder-on numbers."""
    import torch

    keys = ("compiles", "forces", "degraded")
    carried = dict.fromkeys(keys + ("batches",), 0)
    clear = fusion.clear_cache

    def batches():
        return sum(p["dispatches"] for p in fusion.programs().values() if p["roots"] > p["dispatches"])

    def clear_carrying():
        stats = fusion.cache_stats()
        for k in keys:
            carried[k] += stats[k]
        carried["batches"] += batches()
        clear()

    def counts():
        stats = fusion.cache_stats()
        return dict({k: carried[k] + stats[k] for k in keys}, batches=carried["batches"] + batches(),
                    inductor_builds=_fu_unique_graphs())

    out = None
    fusion.clear_cache = clear_carrying
    try:
        for leg in ("on", "collectives off", "off") if off is not None else ("on",):
            before, t0 = counts(), time.perf_counter()
            if leg == "on":
                out = fn()
            elif leg == "off":
                with fusion.disabled():
                    off[f"{label}_recorder_off"] = fn()
            else:
                with fusion.collectives_disabled():
                    off[f"{label}_collectives_off"] = fn()
            after = counts()
            rec = {"seconds": time.perf_counter() - t0}
            rec.update({k: after[k] - before[k] for k in after})
            paths[{"on": label, "off": f"{label}_recorder_off"}.get(leg, f"{label}_collectives_off")] = rec
            print(f"  path {label}, recorder {leg}: {rec['seconds']:.1f} s, {rec['compiles']} programs "
                  f"({rec['inductor_builds']} built by Inductor), {rec['forces']} forces, {rec['batches']} "
                  f"multi-root batches, {rec['degraded']} degraded",
                  flush=True)
            torch.cuda.empty_cache()
            if rec["degraded"]:
                raise AssertionError(f"{label}: {rec['degraded']} fused programs degraded with no fault injected")
    finally:
        fusion.clear_cache = clear
    return out


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

    start = time.perf_counter()
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

    start_static_analysis()
    try:
        return _phases(ht, _build, kind, smi, start)
    finally:
        stop_static_analysis()


def _phases(ht, _build, kind: str, smi: str, start: float) -> int:
    import torch

    # 1. build
    sources = sorted(p.stem for p in _build.SOURCE_DIR.glob("*.cu"))
    t0 = time.perf_counter()
    _build.build(sources)
    for name in sources:
        _build.library(name)
    print(f"phase build: {sources} built in {time.perf_counter() - t0:.1f} s", flush=True)
    for name in ("flash", "pairwise"):
        print_build_report(name, _build.build_log(name))

    # phases 2 to 17 run as a user gets the package, the recorder on; the
    # engine-heavy ones run again with it off, the compared leg
    paths, off = {}, {}
    run = partial(recorded_path, ht.core.fusion, paths)
    kernels = [run("kmeans", lambda: kmeans_path(ht))]
    kernels.append(run("attention", lambda: attention_path(ht)))
    kernels.append(run("distance", lambda: distance_path(ht)))
    moments = run("moments", lambda: moments_path(ht, smi), off)
    linalg = run("linalg", lambda: linalg_path(ht, smi))
    training = run("training", lambda: training_path(ht, smi))
    layer = run("array_layer", lambda: array_layer_path(ht, smi), off)
    estimators = run("estimators", lambda: estimators_path(ht, smi), off)
    nn = run("nn", lambda: nn_path(ht, smi))
    io = run("io", lambda: io_path(ht, smi))
    runtime = run("runtime", lambda: runtime_path(ht, smi))
    health = run("health", lambda: health_path(ht, smi))
    fusion = fusion_path(ht, smi)
    collectives = run("fused_collectives", lambda: fused_collectives_path(ht, smi))
    collectives["four_shard_launches"] = four_shard_paths(ht, paths)
    serving_numbers = run("numerics_serving", lambda: numerics_serving_path(ht, smi))
    ops_trace = run("ops_trace", lambda: ops_trace_path(ht, smi))
    multiprocess = run("multiprocess", lambda: multiprocess_path(ht, smi))
    elastic = run("elastic_autoscale", lambda: elastic_autoscale_path(ht, smi))
    for entry, name in ((kernels[0], "lloyd"), (kernels[2], "pairwise")):
        entry["launches_four_shard_paths"] = sum(v[name] for v in collectives["four_shard_launches"].values())
    train_f32, train_bf16, forward_bf16 = nn["train_f32"], nn["train_bf16"], nn["forward_bf16"]
    kernels[0]["launches_disk_fit"] = io["disk_fit"]["npy"]["launches"]
    kernels[1].update({
        "launches_training_step_f32": train_f32["launches_per_step"],
        "launches_training_step_bf16": train_bf16["launches_per_step"],
        "launches_training_backward_f32": train_f32["launches_backward"],
        "launches_training_backward_bf16": train_bf16["launches_backward"],
        "launches_bf16_forward": forward_bf16["launches"],
        "ms_bf16": forward_bf16["kernel_ms"],
        "bound_bf16_held_ms": forward_bf16["kernel_bound_ms"],
        "plain_ms_bf16": forward_bf16["plain_ms"],
        "library_ms_bf16": forward_bf16["library_ms"],
        "max_abs_err_bf16": forward_bf16["kernel_max_abs_err"],
        "launches_checkpoint_step": io["checkpoints"]["transformer_lm"]["launches"],
        "launches_traced_step": runtime["timeline"]["launches_lm_step"],
    })
    kernels[0]["launches_traced_fit"] = runtime["fit"]["launches"]["verbose"]
    kernels[0]["launches_ledger_fit"] = health["fit"]["launches"]
    kernels[0]["launches_fused_fit"] = fusion["fit"]["launches"]
    kernels[1]["launches_ledger_step"] = health["lm"]["launches"]
    kernels[0]["launches_serving_fit"] = serving_numbers["sessions"]["fit"]["launches"]
    kernels[1]["launches_numlens_step"] = serving_numbers["training"]["full"]["launches"][-1]
    kernels[0]["launches_tracelens_fit"] = ops_trace["fit"]["launches"]
    kernels[0]["launches_scraped_fit"] = ops_trace["ops"]["scraped"]["legs"]["scraped"]["fit_launches"]
    kernels[0]["launches_spanning_fit"] = multiprocess["spanning"]["launches"]
    kernels[2]["launches_spanning_cdist"] = multiprocess["spanning"]["mainpath"]["launches"]
    spectral = multiprocess["spanning"]["layers"]["spectral_launches"]
    kernels[0]["launches_spanning_spectral"] = [n["lloyd"] for n in spectral]
    kernels[2]["launches_spanning_spectral"] = [n["pairwise"] for n in spectral]
    kernels[0]["launches_autoscale_fit"] = elastic["autoscale"]["fit"]["shedding"]["launches"]
    kernels[1]["launches_elastic_fit"] = elastic["lm"]["launches"]
    kernels[1]["launches_elastic_step_forward"] = elastic["lm"]["forward_launches"]

    print("moments: " + json.dumps(moments))
    print("linalg: " + json.dumps(linalg))
    print("training: " + json.dumps(training))
    print("array_layer: " + json.dumps(layer))
    print("estimators: " + json.dumps(estimators))
    print("nn: " + json.dumps(nn))
    print("io: " + json.dumps(io))
    print("runtime: " + json.dumps(runtime))
    print("health: " + json.dumps(health))
    print("fusion: " + json.dumps(fusion))
    print("fused_collectives: " + json.dumps(collectives))
    print("numerics_serving: " + json.dumps(serving_numbers, default=str))
    print("ops_trace: " + json.dumps(ops_trace, default=str))
    print("multiprocess: " + json.dumps(multiprocess, default=str))
    print("elastic_autoscale: " + json.dumps(elastic, default=str))
    for label, numbers in off.items():
        print(f"{label}: " + json.dumps(numbers))
    print("paths: " + json.dumps(paths))
    print(f"chip_smoke: {time.perf_counter() - start:.1f} s from its start to its last phase ({smi})")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
