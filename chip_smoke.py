#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (vqvae_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device, ``nvcc`` and ``g++``; it exits non-zero (and
prints no result) without a GPU or outside a checkout of the repository.

Phases, each printed as it ends:
1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. the build of every native source of both slices, all started together:
   ``csrc/knn_select.cu`` (kernels K1/K2), ``csrc/assign.cu`` (K3),
   ``csrc/gather_min.cu`` (K4), each with nvcc for sm_90a, and the host
   graph library (g++);
3. each kernel against its plain PyTorch version on the card, TF32 off:
   - K1/K2 at the codebook stage's shapes — 16,384 query rows against the
     full 983,040-row database of ``bench.py``-style latents (seed 0),
     D=16, k_sel=29: K1 packed at bins 1024, K2 unpacked at bins 768. At
     most 1e-3 of the rows may differ, only at near-ties (within 1e-5
     relative of the plain version's k_sel-th value), and kNN recall after
     the exact re-rank against the exact route must be >= 0.999. Times:
     the kernel, the plain version and, as a yardstick, ``torch.cdist`` +
     ``torch.topk``; K1 also at the stage's 131,072-row launch and against
     a 262,144-row database that fits in L2, and one K1 call's device time
     by kernel (``torch.profiler``). Bounds: three TF32 passes on the
     tensor cores plus a compare, and beside it the first version's
     CUDA-core f32 bound;
   - K3 at the quality stage's 160,000 rows x 16 against 512 codes (val-
     and medoid-like draws of the same latents), at a ragged 1,037 x 5
     against 130, and at the vanilla presets' flat width D = 128 (K3's
     widest) against 512 codes: the vanilla quality stage's 1,000 rows
     (its quantization-loss call) and 10,000 rows (its codebook-health
     call), and 60,000 rows: at most 1e-4 of the rows may differ, only at
     near-ties (exact distances within 1e-5 relative), and distances
     within 1e-5 relative. Yardstick: ``(|c|^2 - 2 z c^T).min(1)``. At
     160,000 x 16 and at 1,000 x 128 also one call's device time by kernel
     (``torch.profiler``: the prep launch and the main kernel) and the
     wrapper's host time per call;
   - K4 at the gather-min tool's shapes (196,608 x K rows, 2^20 indices,
     K in 256, 512, 1024) and at 4,096 indices into 196,608 x 1024
     (sparse), where it must take the scan route, and at 16 indices, where
     it must take the gather route: bitwise equal, with one call's device
     time by kernel. Yardstick:
     ``d[idx].amin(0)``. Its bound counts each distinct gathered row once
     (a repeat does not change a min), and its time leaves out the
     wrapper's index check;
4. the codebook stage through its entry point ``build_codebook_main`` on
   the card at the full width of ``configs/fashionmnist/spatial/geodesic``
   (VAE 16 / 64-128-256 / 256-128-64, batch norm, 28 px; k=20 union
   approx; K=512 kpp_parallel seed 42; batch 4096) with seeded random
   weights written as a reference ``.pt`` and (61,440, 4, 4, 16) latents —
   983,040 nodes — then again on 40 images (640 nodes, effective bins
   640), where the selection takes K2. Launch counts are zeroed before and
   read after each run;
5. the stage's output against its plain CPU run on a small input (256
   images): identical graph structure and off-LCC positions, edge lengths
   within rtol 1e-4 on all but 1e-3 of the edges (ReLU gates at rounding
   distance from their kink may flip between devices), QE within rtol
   1e-3;
6. the whole pipeline through the port's orchestrator ``run_pipeline`` on
   the preset, rooted in a scratch directory: a first call runs ``vae`` at
   full width (batch 256, the synthetic 60,000 / 10,000 split) for 2
   epochs; the first 4,096 images of its ``latents_train`` are cut out;
   a second call runs codebook (65,536 nodes, the VAE read through the
   preset's ``.../checkpoints/best`` path) -> quality (the full val split)
   -> transformer (the preset's full width: 512 tokens, embed 256, 4
   layers, 4 heads, batch 256, dropout 0.1, label smoothing 0.1, lr 3e-4,
   on the cut's codes and labels, 5 epochs of about 16 steps) -> generate
   (the preset's 100 samples, 10 classes, top_k 50) -> evaluate. Every
   launch count is zeroed before the first call and read after the
   second. The quality and evaluate stages swallow their exceptions by
   design, so every stage's artifacts are checked here: the VAE's, the
   codebook's, the quality JSONs, the transformer's checkpoints and
   finite, falling losses, a 302 x 302 ``generated_samples.png`` read back
   by the port's PNG reader, ``metrics.yaml`` with finite PSNR and SSIM and
   null LPIPS, ``comparison_grid.png``; K1 and K3 must have launched.
   Logged: seconds per stage, steps/s per epoch of both trainings, and
   the generate stage's ms per sampled token step;
7. the VAE on the card against the CPU: one train step on the same batch
   and noise (loss within rtol 1e-5; each gradient tensor within 2e-3 of
   its norm; at least 99 % of the parameters within rtol 1e-4 and all
   within one Adam step, 2 lr, of the CPU's: where a gradient sits at
   rounding distance from 0, Adam's first step may take either sign). A
   control runs the card's step again with TF32 matmuls and convolutions
   and must fail the gradient limit;
8. the transformer at the preset's width on the card against the CPU,
   same weights, dropout 0: one train step on the same batch (loss within
   rtol 1e-5, each gradient tensor within ``TF_GRAD_LIMIT`` of its norm,
   and a TF32 control that must fail that limit), the card's KV-cache
   logits against its own full-prefix forward (1e-5 relative), greedy
   sampling of 100 sequences equal to the CPU's except at near-ties (top
   two logits within 1e-5 relative; their count is printed); then the
   card's train step time, device time and the model's FLOPs at the f32
   peak. Then the quality evaluators on phase 6's artifacts, card against
   CPU (codes identical except at near-ties, PSNRs within 1e-3 dB);
9. the gather-min tool through its entry point at its default shapes, its
   K4 launches counted per width and per route (the scan route must run);
10. the vanilla geodesic preset (``configs/fashionmnist/vanilla/geodesic``:
   flat latent 128, encoder 64/128/256, decoder 256/128/64, batch 256;
   transformer embed 512, 8 layers, 8 heads, two positions) through
   ``run_pipeline`` in one call, every stage at the preset's settings but
   the depth: vae 2 of 200 epochs on the synthetic 60,000 / 10,000 split,
   the ``legacy_riemannian`` codebook on all 60,000 flat latents (k = 20
   union exact, K = 512 kpp_parallel, 5,000 subset edges, batch 4,096),
   quality (K3 at D = 128), the transformer 2 of 200 epochs, generate and
   evaluate; then the ``legacy`` (Euclidean) builder on the same latents.
   Checked: both graph files, codes (60,000,) with -1 only off the LCC
   and values under 512, 512 medoids and a finite QE, the quality JSONs,
   finite and falling transformer losses, the 302 x 302 sample grid,
   finite PSNR / SSIM, and K3 launched. Logged: seconds by stage;
11. the EMA VQ-VAE baseline at the full width of
   ``configs/baseline_vqvae/config.yaml`` (3 channels, z 128, hidden 256,
   2 res blocks, 512 codes, batch 128, lr 2e-4, clip 1.0, beta 0.25, EMA
   0.99) through ``run_baseline_pipeline``: 2 of 100 epochs on the
   synthetic CIFAR-10 stand-in (60,000 / 10,000 images, as for every
   dataset), then ``evaluate_baseline``, then ``eval_codebook_metrics``. Checked: finite, falling losses,
   perplexity > 1 and usage > 0, the three evaluation files, the CSV row
   and a recon PNG read back by the port's reader. Logged: steps/s per
   epoch, and one step's wall and device ms (``torch.profiler``);
12. one baseline train step at that width on the card against the CPU,
   from the same weights, codebook, batch (the last 16 of 128 rows
   padding, mask 0) and bank draw: the loss within rtol 1e-5, each
   gradient within ``VQ_GRAD_LIMIT`` of its tensor's norm (a TF32 control
   must fail that limit), each code of the EMA codebook after the step
   within 1e-5 of its norm (codes a near-tie row moved are counted and
   left out), and
   ``quantize``'s indices equal except at near-ties;
13. the VAE's device-resident epoch path at full width on the card against
   the CPU (with a NaN batch and a TF32 control), and one 60,000-image
   epoch of each training path;
14. both models in bf16 through their CLIs, one bf16 step of each against
   the CPU;
15. the codebook stage's other engines on phase 6's 65,536-node graph:
   edge-list Bellman-Ford, ELL (with ``active``), host Dijkstra, device
   components, k-medoids on an ``EdgeList``, the nodal lengths against
   the mlp engine's (every edge past rtol 1e-3, atol 1e-5 must have an
   endpoint where a decoder ReLU input lies within ``KINK_RATIO`` of its
   summed absolute terms of 0, in f64: there the engines' f32 roundings
   may gate it differently), the predecessor paths and the kNN escape
   hatch;
16. the slice of k-means, IVF, the demos and the profiling layer:
   a. IVF (``ops.knn_search_ivf``, k = 20, JAX's defaults: 2,048 buckets,
      16 probes, cap 600) on phase 4's 983,040 latents: every row
      answered, itself first on >= 99.9 % of rows, distances sorted and
      within rtol 1e-5 of the exact f32 distance of each index; recall@20
      against phase 3's exact rows and each step's seconds, logged;
   b. IVF on phase 6's 65,536 cells, card against CPU, step by step from
      the CPU's state: one Lloyd step (labels equal except at near-ties of
      the fast form, within ``FAST_FORM_TIE`` of the terms it cancels; the
      other centres within 1e-5 of their norms), the top-4 choices (equal
      except at such near-ties), the bucket search (rows differ only
      where the swapped candidates' distances tie within rtol 1e-5); end
      to end, the rows that differ and both recalls, logged;
   c. ``fit_kmeans`` K = 512 on the same cells: one Lloyd step from the
      same k-means++ centres, as in b, with a TF32 control that the
      near-tie rule must reject (logged either way); the card's whole fit
      assigned again on the CPU from its final centres (labels equal but
      for near-ties, inertia within rtol 1e-5); whole fits card against
      CPU, inertia within rtol 1e-3 (the two trajectories part after a
      near-tie, and then agree only as two runs of one algorithm);
   d. every demo's and experiment's ``run`` on phase 6's experiment
      (``codebook_comparison`` at K = 512 on 65,536 cells,
      ``codebook_sampling``, which must launch K3, counted from 0,
      ``kmedoids_geodesic_analysis``, ``run_riemann_experiments``,
      ``riemann_sanity_check`` with a seeded decoder and
      ``interactive_exploration``): artifacts written, numbers finite;
   e. phase 6's preset again from the quality stage on (the transformer
      for 1 epoch) under ``VQVAE_TPU_PROFILE_DIR``: one non-empty Chrome
      trace per stage, each stage's device-busy share (the union of its
      CUDA kernel intervals over its wall time), ``programs_compiled`` 0
      in the timings JSON;
   f. ``tools/bench_fit``'s grid on phase 6's graph (its LCC), 8, 32, 128
      and 512 sources on both backends, the crossover, the backend
      ``HOST_WORK_THRESHOLD`` picks at each point beside the faster one,
      and the host Dijkstra's time by thread count; then the grid from 1
      to 64 sources on a k = 10 graph of 16,384 of its cells;
17. the CIFAR-10 spatial-geodesic preset and the last single-card scripts:
   a. ``configs/cifar10/spatial/geodesic`` through ``run_pipeline`` at the
      preset's width (latent 32, encoder 64/128/256, decoder 256/128/64,
      3 x 32 x 32; transformer embed 256, 4 layers) on the synthetic
      60,000 / 10,000 split: vae 2 of 200 epochs, the first 4,096
      images' latents cut (65,536 nodes at D = 32), the codebook stage
      and the quality stage each driven alone with the launch counts
      zeroed before and read after it (K1 must launch in the one, K3 in
      the other), then transformer (2 of 200 epochs) -> generate ->
      evaluate; every stage's artifacts checked as in phase 6 (a
      342 x 342 x 3 sample grid);
   b. K1 at D = 32 on a's 65,536 cells (all against all, one launch, as
      on the stage; with one call's device time by kernel) and K3 at
      D = 32 on a's val latents against its 512 medoids (16,000 and
      160,000 rows, the quality stage's two calls), each against its
      plain version under phase 3's near-tie rules, timed beside its
      bound and a library call;
   c. phase 13's epoch check on the CIFAR preset's VAE at full width
      (``spatial_free_bits`` 0.1, 3 steps), card against CPU, the epoch's
      mean losses within ``CIFAR_LOSS_LIMIT`` relative, with a TF32
      control that must fail it;
   d. the collapse probe's ``measure`` on a's VAE and the dilation
      experiment on a's experiment (finite numbers; ``collapsed`` is
      printed, not gated: two epochs cannot judge it);
   e. one JSON line from each tool at a cut size: ``bench_riemannian``
      (mlp, indexed, nodal on phase 6's graph, FLOPs beside the f32
      peak), ``check_riem_accuracy`` (8,192 edges, both decoders),
      ``bench_kmedoids_prep`` (262,144 nodes), ``ab_kmed_reorder``
      (phase 6's graph, K = 512), ``probe_pull`` (983,040 x 11),
      ``run_fullscale_median`` (2 runs of a cut sandbox preset),
      ``compare_all_approaches`` (phases 6, 10, 11 and 17),
      ``knn_experiments``' ``run`` (phase 6's latents) and
      ``train_legacy_vae`` (1 epoch at ``configs/vae.yaml``'s widths on
      4,096 synthetic images);
18. the device mesh (``vqvae_tpu_torch/parallel``), each part's ranks
   started as subprocesses of this script (``--phase18-rank``, with
   ``torchrun``'s environment; a rank that fails fails the run):
   a. one rank in an NCCL group on phase 6's 65,536-node graph: the
      codebook stage's steps (kNN, lengths, LCC, k-medoids, 64-source
      distances) with the group's mesh equal bit for bit to the same
      steps without a group;
   b. two gloo ranks sharing ``cuda:0`` on phase 4's 983,040 nodes: the
      sharded kNN against one process's (rows may differ only at
      near-ties; counted), lengths on phase 4's LCC graph within rtol
      1e-6 of its stored ones, k-medoids on it equal to phase 4's medoids,
      assignments and QE, 64-source distances equal to one process's; K1
      launches per rank;
   c. five data-parallel steps of the VAE (batch 256, BatchNorm, the epoch
      path), the transformer (batch 256, dropout 0) and the baseline
      (batch 128: EMA, bank, perplexity) at full width, two ranks on
      halves of each batch against one process on the whole batch: mean
      losses within 1e-5 relative, parameters within 2 lr a step (phase
      13's limits), the baseline's codebook and bank within rtol 1e-5 or
      2e-5 of their largest values; a baseline latent may take another
      code at a near-tie (distances within 1e-5 of |z|^2 + |e|^2), and
      then only the steps before it are held to the limits;
   d. ``run_pipeline`` at world size 2 on the spatial preset at phase 6's
      depth (vae 1 epoch, codebook on 65,536 nodes, transformer 1 epoch):
      every file written by rank 0 alone (an audit hook), codes -1 only
      off the LCC, finite losses; stage seconds logged. Two ranks on one
      card are timed, not claimed faster;
19. one JSON line of per-kernel numbers, then the device line.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (dense, 700 W): f32 outside the tensor cores,
# int32, TF32 on the tensor cores, HBM bandwidth
PEAK_F32 = 67e12
PEAK_INT32 = 33.5e12
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12

N_NODES = 983_040
D = 16
K_SEL = 29           # k + 1 + margin 8 for the stage's k = 20
Q_ROWS = 16_384
Q_ROWS_MAIN = 131_072  # query rows of one K1 launch on the codebook stage
L2_ROWS = 262_144      # a database cut to fit the 50 MB L2
K3_ROWS = 160_000    # 10,000 val images x 16 cells (codebook health)
K3_CODES = 512
K4_N = 196_608       # the gather-min tool's defaults
K4_ROWS = 1 << 20
K4_SPARSE_ROWS = 4096  # R << N: few present rows
K4_FEW_ROWS = 16       # a handful: one block of the gather route
K4_WIDTHS = (256, 512, 1024)
PRESET = "configs/fashionmnist/spatial/geodesic"
PIPELINE_EPOCHS = 2
CODEBOOK_IMAGES = 4096  # 65,536 nodes: the codebook path at a cut depth
TRANSFORMER_EPOCHS = 5  # of the preset's 200: about 16 steps each
# card vs CPU train step: largest gradient difference, as a share of its
# tensor's norm. On an H100, full f32 reads 4.65e-4 and the same step with
# TF32 convolutions 1.14e-2; the limit sits between them.
GRAD_LIMIT = 2e-3
# the same for one transformer step at the preset's width (full f32 on the
# card against the CPU, and the TF32 control); see PERF.md
TF_GRAD_LIMIT = 1e-4
K3_WIDE = 128                       # the vanilla presets' flat latent width
K3_WIDE_ROWS = (1_000, 10_000, 60_000)
VANILLA = "configs/fashionmnist/vanilla/geodesic"
VANILLA_VAE_EPOCHS = 2
VANILLA_TF_EPOCHS = 2
BASELINE = "configs/baseline_vqvae/config.yaml"
BASELINE_EPOCHS = 2
# the same for one baseline VQ-VAE step at the config's width: full f32
# read 4.0e-5 on an H100, the TF32 control 4.7e-3; see PERF.md
VQ_GRAD_LIMIT = 1e-3


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def make_latents(n_nodes: int, dim: int = 16, seed: int = 0):
    """Clustered gaussian latents (10 overlapping lobes), as ``bench.py``
    ``make_latents``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 1.2, size=(10, dim)).astype(np.float32)
    labels = rng.integers(0, 10, size=n_nodes)
    z = centers[labels] + rng.normal(0, 1.0, size=(n_nodes, dim)).astype(
        np.float32)
    return z.astype(np.float32)


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()  # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_times(fn, calls: int = 1):
    """[(kernel name, device ms per call)] of ``calls`` calls of ``fn``
    (``torch.profiler``), largest first. A session that records no device
    time (seen once in a run of many sessions) is taken again, twice at
    most."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        parts = sorted(
            ((ev.key.replace("void ", "").replace("(anonymous namespace)::",
                                                  "").split("(")[0],
              ev.device_time_total / 1e3 / calls)
             for ev in prof.key_averages() if ev.device_time_total > 0),
            key=lambda kv: -kv[1])
        if parts:
            return parts
    fail("torch.profiler recorded no device time in three sessions")


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    if hasattr(torch.backends, "fp32_precision"):
        log(f"f32 precision: matmul "
            f"{torch.backends.cuda.matmul.fp32_precision}, cuDNN conv "
            f"{torch.backends.cudnn.conv.fp32_precision}")
    return card


def phase_build():
    from vqvae_tpu_torch import native
    from vqvae_tpu_torch.ops import assign, knn_select
    from vqvae_tpu_torch.ops import gather_min as gather_min_ops

    # one compiler per source, all started together; a failed build raises
    t0 = time.perf_counter()
    with ThreadPoolExecutor() as pool:
        builds = {name: pool.submit(fn) for name, fn in
                  (("knn_select.cu", knn_select.build),
                   ("assign.cu", assign.build),
                   ("gather_min.cu", gather_min_ops.build),
                   ("graph_core.cpp", native.build))}
        for name, build in builds.items():
            log(f"built {name}")
            for line in build.result().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  {line.strip()}")
    log(f"build wall {time.perf_counter() - t0:.3f}s")


def select_agrees(name, kd, ki, rd, ri):
    """K1/K2's output against its plain version's: at most 1e-3 of the
    rows may differ, only at near-ties (a candidate in one output and not
    the other within 1e-5 relative of the plain k_sel-th value). Returns
    (max |kernel - plain| over finite values, share of rows differing)."""
    import torch

    torch.cuda.synchronize()
    finite = torch.isfinite(kd) & torch.isfinite(rd)
    max_abs = float((kd - rd).abs()[finite].max()) if finite.any() else 0.0
    differ = (ki != ri).any(dim=1)
    frac = float(differ.float().mean())
    if frac > 1e-3:
        fail(f"{name}: {frac:.2e} of rows differ from the plain version")
    kth = rd[:, -1:]
    for r in torch.nonzero(differ).flatten().tolist():
        a, b = set(ki[r].tolist()), set(ri[r].tolist())
        for c in a ^ b:
            src_d, src_i = (kd, ki) if c in a else (rd, ri)
            val = src_d[r][src_i[r] == c][0]
            if abs(float(val - kth[r, 0])) > 1e-5 * abs(float(kth[r, 0])):
                fail(f"{name}: row {r} candidate {c} differs beyond a "
                     f"near-tie ({float(val)} vs k_sel-th {float(kth[r, 0])})")
    return max_abs, frac


def select_bound(q_rows: int, db_rows: int, d: int, k_sel: int,
                 packed: bool):
    """(bound ms, bound_by, CUDA-core f32 bound ms) of a K1/K2 call: the
    inputs read once and the outputs written once over HBM, or the D-term
    product of every (query, row) pair on the tensor cores at
    f32-equivalent precision (three TF32 passes) plus one top-2 compare on
    the CUDA cores (int32 keys packed, f32 unpacked). The first version's
    bound put the D+2 multiply-adds on the CUDA cores in f32."""
    n_pairs = q_rows * db_rows
    compare_ms = n_pairs / (PEAK_INT32 if packed else PEAK_F32) * 1e3
    bytes_ms = (4 * (q_rows + db_rows) * d + 8 * q_rows * k_sel) \
        / PEAK_BYTES * 1e3
    ops_ms = 3 * 2 * n_pairs * d / PEAK_TF32 * 1e3 + compare_ms
    cuda_core_ms = 2 * n_pairs * (d + 2) / PEAK_F32 * 1e3 + compare_ms
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms > ops_ms else "operations",
            max(bytes_ms, cuda_core_ms))


def check_kernel(name, zd, n_valid, bins, packed, exact_i, exact_d):
    """Kernel vs plain version, recall after the re-rank, and timings."""
    import numpy as np
    import torch

    from vqvae_tpu_torch.ops.knn import _exact_rerank
    from vqvae_tpu_torch.ops.knn_select import (fused_select,
                                                fused_select_reference)

    zq = zd[:Q_ROWS].contiguous()

    def kernel():
        return fused_select(zq, zd, n_valid, metric="euclidean", bins=bins,
                            k_sel=K_SEL, packed=packed)

    def plain():
        return fused_select_reference(zq, zd, n_valid, metric="euclidean",
                                      bins=bins, k_sel=K_SEL, packed=packed)

    kd, ki = kernel()
    rd, ri = plain()
    max_abs, frac = select_agrees(name, kd, ki, rd, ri)
    qv = torch.ones(Q_ROWS, dtype=torch.bool, device=zd.device)
    k = exact_i.shape[1]
    _, got = _exact_rerank(zq, qv, kd, ki, zd, k, "euclidean")
    got, want = got.cpu().numpy(), exact_i.cpu().numpy()
    recall = float(np.mean([len(set(got[r]) & set(want[r])) / k
                            for r in range(Q_ROWS)]))
    if recall < 0.999:
        fail(f"{name}: recall {recall} < 0.999 after the exact re-rank")

    ms = cuda_ms(kernel, 5)
    plain_ms = cuda_ms(plain, 1)
    extra = ""
    if packed:
        # the main path's launch shape, and a database that fits in L2
        zq_main = zd[:Q_ROWS_MAIN].contiguous()
        main_ms = cuda_ms(lambda: fused_select(
            zq_main, zd, n_valid, metric="euclidean", bins=bins,
            k_sel=K_SEL, packed=packed), 1)
        del zq_main
        zl2 = zd[:L2_ROWS].contiguous()
        l2_ms = cuda_ms(lambda: fused_select(
            zq, zl2, L2_ROWS, metric="euclidean", bins=bins, k_sel=K_SEL,
            packed=packed), 5)
        del zl2
        extra = (f"; {Q_ROWS_MAIN} query rows {main_ms:.4f} ms; "
                 f"{L2_ROWS}-row database {l2_ms:.4f} ms")
        # where one call's device time goes, by kernel
        parts = kernel_times(kernel)
        log(f"{name} device time by kernel: " + "; ".join(
            f"{key[:48]} {t:.3f} ms" for key, t in parts[:7]))

    def library():
        for s in range(0, Q_ROWS, 1024):
            torch.topk(torch.cdist(zq[s:s + 1024], zd[:n_valid]), K_SEL,
                       dim=1, largest=False)

    library_ms = cuda_ms(library, 1)
    bound_ms, bound_by, cuda_core_ms = select_bound(
        Q_ROWS, zd.shape[0], D, K_SEL, packed)
    log(f"{name}: rows differ {frac:.2e}, max |kernel - plain| {max_abs}, "
        f"recall {recall:.6f}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"cdist+topk {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}; CUDA-core f32 bound {cuda_core_ms:.4f} ms){extra}")
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "rows_differ": frac, "recall": recall}


def phase_kernels(z):
    import torch

    from vqvae_tpu_torch.ops.knn import _knn_block_exact

    zd = torch.from_numpy(z).cuda()
    qv = torch.ones(Q_ROWS, dtype=torch.bool, device=zd.device)
    t0 = time.perf_counter()
    exact_d, exact_i = _knn_block_exact(zd[:Q_ROWS], zd, N_NODES, qv, k=21,
                                        metric="euclidean", query_tile=1024,
                                        db_tile=32768, margin=4)
    torch.cuda.synchronize()
    log(f"exact route for {Q_ROWS} rows: {time.perf_counter() - t0:.3f}s")
    out = {
        "K1": check_kernel("K1 (packed, bins 1024)", zd, N_NODES, 1024, True,
                           exact_i, exact_d),
        "K2": check_kernel("K2 (unpacked, bins 768)", zd, N_NODES, 768,
                           False, exact_i, exact_d),
    }
    del zd
    torch.cuda.empty_cache()
    return out, exact_i.cpu().numpy()


def stage_config(work: Path, z_nodes, n_images: int, name: str):
    """A codebook config of the geodesic preset pointing at fresh inputs."""
    import torch

    import numpy as np

    from vqvae_tpu_torch.config import load_config
    from vqvae_tpu_torch.utils.checkpoint import build_vae

    base = work / name
    (base / "latents").mkdir(parents=True)
    np.savez(base / "latents" / "latents.npz",
             z=z_nodes[:n_images * 16].reshape(n_images, 4, 4, D))
    preset = ROOT / "configs/fashionmnist/spatial/geodesic/codebook.yaml"
    cfg = load_config(preset, {"latents_path": str(base / "latents"),
                               "vae_ckpt_path": str(base / "vae.pt"),
                               "out_dir": str(base / "codebook")})
    torch.manual_seed(0)
    model = build_vae(cfg["vae"])
    torch.save({"model_state_dict": model.state_dict(), "epoch": 0},
               base / "vae.pt")
    return cfg


def run_stage(cfg, device, expect_packed: bool):
    """One drive of the main path; returns (out dir, K1/K2 launches, ELL
    sweeps, seconds)."""
    import numpy as np

    from vqvae_tpu_torch.cli import build_codebook_main
    from vqvae_tpu_torch.ops.ell import ELL_STATS
    from vqvae_tpu_torch.ops.knn import KNN_EFFECTIVE
    from vqvae_tpu_torch.ops.knn_select import fused_select

    ell_start = len(ELL_STATS)
    fused_select.launches = 0
    t0 = time.perf_counter()
    out = build_codebook_main(cfg, device=device)
    secs = time.perf_counter() - t0
    launches = fused_select.launches
    if KNN_EFFECTIVE.get("packed") is not expect_packed:
        fail(f"selection ran packed={KNN_EFFECTIVE.get('packed')}, "
             f"expected {expect_packed}")
    sweeps = sum(r["iters"] for r in ELL_STATS[ell_start:])
    for name in ("knn_graph_geodesic.npz", "codebook.npz", "codebook.pt",
                 "codes.npy"):
        if not (out / name).exists():
            fail(f"artifact {name} missing under {out}")
    codes = np.load(out / "codes.npy")
    n_images = int(np.load(Path(cfg["latents_path"]) / "latents.npz")
                   ["z"].shape[0])
    if codes.shape != (n_images, 4, 4):
        fail(f"codes shape {codes.shape}")
    return out, launches, sweeps, secs


def phase_main_path(z, work: Path):
    import numpy as np

    from vqvae_tpu_torch.cli import load_codebook

    n_images = N_NODES // 16
    cfg = stage_config(work, z, n_images, "main")
    out, k1_launches, sweeps, secs = run_stage(cfg, "cuda", True)
    rec = load_codebook(out)["config"]
    codes = np.load(out / "codes.npy")
    qe = rec["quantization_error"]
    if not np.isfinite(qe) or qe <= 0:
        fail(f"QE {qe}")
    if len(load_codebook(out)["medoid_indices"]) != 512:
        fail("medoid count is not 512")
    if k1_launches <= 0:
        fail("the main path launched no K1 kernel")
    log(f"main path: {n_images * 16} nodes in {secs:.3f}s; stages "
        + ", ".join(f"{k} {v:.3f}s" for k, v in rec["timings_s"].items())
        + f"; QE {qe}; LCC {rec['lcc_nodes']} nodes "
        f"({int((codes == -1).sum())} off-LCC); ELL sweeps {sweeps}; "
        f"K1 launches {k1_launches}")

    cfg2 = stage_config(work, z, 40, "k2path")
    _, k2_launches, _, secs2 = run_stage(cfg2, "cuda", False)
    if k2_launches <= 0:
        fail("the 640-node run launched no K2 kernel")
    log(f"640-node run (effective bins 640 -> K2): {secs2:.3f}s, "
        f"K2 launches {k2_launches}")
    return k1_launches, k2_launches, rec["timings_s"]["knn"]


def phase_reference(z, work: Path):
    """The stage on the card against its plain CPU run, 256 images."""
    import numpy as np
    from scipy import sparse

    from vqvae_tpu_torch.cli import load_codebook

    cfg_gpu = stage_config(work, z, 256, "small_gpu")
    cfg_cpu = stage_config(work, z, 256, "small_cpu")
    out_gpu, _, _, _ = run_stage(cfg_gpu, "cuda", True)
    out_cpu, _, _, _ = run_stage(cfg_cpu, "cpu", True)
    wg = sparse.load_npz(out_gpu / "knn_graph_geodesic.npz")
    wc = sparse.load_npz(out_cpu / "knn_graph_geodesic.npz")
    if not (np.array_equal(wg.indptr, wc.indptr)
            and np.array_equal(wg.indices, wc.indices)):
        fail("small run: the GPU graph differs from the CPU graph")
    # lengths agree to float order, except where a pre-activation of the
    # linearized decoder sits within rounding of a ReLU kink and the two
    # devices gate it differently: allow 1e-3 of the edges past rtol 1e-4
    rel = np.abs(wg.data - wc.data) / np.maximum(np.abs(wc.data), 1e-30)
    frac = float(np.mean(rel > 1e-4))
    log(f"small run: edge lengths GPU vs CPU: median rel diff "
        f"{float(np.median(rel)):.3e}, max {float(rel.max()):.3e}, "
        f"{frac:.3e} of edges past rtol 1e-4")
    if frac > 1e-3:
        fail("small run: edge lengths differ beyond rtol 1e-4 on more than "
             "1e-3 of the edges")
    cg, cc = np.load(out_gpu / "codes.npy"), np.load(out_cpu / "codes.npy")
    if not np.array_equal(cg == -1, cc == -1):
        fail("small run: off-LCC positions differ")
    qg = load_codebook(out_gpu)["config"]["quantization_error"]
    qc = load_codebook(out_cpu)["config"]["quantization_error"]
    if abs(qg - qc) > 1e-3 * abs(qc):
        fail(f"small run: QE {qg} (GPU) vs {qc} (CPU)")
    mg = load_codebook(out_gpu)["medoid_indices"]
    mc = load_codebook(out_cpu)["medoid_indices"]
    log(f"small run (4096 nodes): GPU vs CPU QE {qg} vs {qc}, medoids equal "
        f"{float(np.mean(mg == mc)):.4f}, codes equal "
        f"{float(np.mean(cg == cc)):.4f}")


def near_tie_rows(z, cb, idx, ref_idx, rel: float = 1e-5,
                  name: str = "K3") -> int:
    """Rows where two assignments differ; fails unless the two codes' exact
    (f64) distances are within ``rel`` of each other."""
    import torch

    differ = torch.nonzero(idx != ref_idx).flatten()
    if differ.numel():
        zd = z[differ].double()
        a = ((zd - cb[idx[differ]].double()) ** 2).sum(1)
        b = ((zd - cb[ref_idx[differ]].double()) ** 2).sum(1)
        gap = (a - b).abs() / torch.minimum(a, b).clamp_min(1e-30)
        if float(gap.max()) > rel:
            fail(f"{name}: a row differs beyond a near-tie (relative gap "
                 f"{float(gap.max()):.3e} > {rel})")
    return int(differ.numel())


def check_assign(name, z, cb, reps: int, split: bool = False):
    """K3 against its plain version; times and bound at this shape, and
    with ``split`` one call's device time by kernel and the wrapper's host
    time per call."""
    import torch

    from vqvae_tpu_torch.ops.assign import (nearest_codes,
                                            nearest_codes_reference)

    idx, dist = nearest_codes(z, cb)
    ref_idx, ref_dist = nearest_codes_reference(z, cb)
    torch.cuda.synchronize()
    n_diff = near_tie_rows(z, cb, idx, ref_idx)
    frac = n_diff / z.shape[0]
    if frac > 1e-4:
        fail(f"{name}: {frac:.2e} of rows differ from the plain version")
    same = idx == ref_idx
    err = (dist - ref_dist)[same].abs()
    max_abs = float(err.max())
    max_rel = float((err / ref_dist[same].abs().clamp_min(1e-30)).max())
    if max_rel > 1e-5:
        fail(f"{name}: distances differ by {max_rel:.3e} relative")
    ms = cuda_ms(lambda: nearest_codes(z, cb), reps)
    device_ms = host_ms = None
    if split:
        parts = kernel_times(lambda: nearest_codes(z, cb), 10)
        device_ms = sum(t for _, t in parts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()  # enqueue only: the card runs behind
        for _ in range(reps):
            nearest_codes(z, cb)
        host_ms = (time.perf_counter() - t0) / reps * 1e3
        torch.cuda.synchronize()
        log(f"{name}: device time per call {device_ms:.4f} ms by kernel: "
            + "; ".join(f"{key[:40]} {t:.4f} ms" for key, t in parts)
            + f"; wrapper host time per call {host_ms:.4f} ms")
    plain_ms = cuda_ms(lambda: nearest_codes_reference(z, cb), 2)
    cb_sq = (cb * cb).sum(1)
    library_ms = cuda_ms(lambda: (cb_sq - 2.0 * (z @ cb.T)).min(1), reps)
    n, k, d = z.shape[0], cb.shape[0], z.shape[1]
    # 2*N*K*D f32 FLOP against inputs read once, idx (int64) and dist out
    ops_ms = 2.0 * n * k * d / PEAK_F32 * 1e3
    bytes_ms = (4.0 * (n + k) * d + 12.0 * n) / PEAK_BYTES * 1e3
    log(f"{name}: rows differ {frac:.2e} (near-ties), max |dist - plain| "
        f"{max_abs} (rel {max_rel:.3e}); kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, (|c|^2 - 2zc^T).min {library_ms:.4f} ms, bound "
        f"{max(ops_ms, bytes_ms):.4f} ms "
        f"({'bytes' if bytes_ms > ops_ms else 'operations'})")
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
            "library_ms": library_ms, "device_ms": device_ms,
            "host_ms": host_ms}


def check_gather_min(k: int, gen, rows: int = K4_ROWS, route=None):
    """K4 against its plain version on ``rows`` random indices into
    196,608 x ``k``; times, bound; fails unless it took ``route`` (when
    given)."""
    import torch

    from vqvae_tpu_torch.ops.gather_min import (gather_min,
                                                gather_min_reference,
                                                launch_gather_min)

    d = torch.rand((K4_N, k), generator=gen, device="cuda")
    idx = torch.randint(0, K4_N, (rows,), generator=gen, device="cuda",
                        dtype=torch.int32)
    before = dict(gather_min.route_launches)
    out = gather_min(d, idx)
    ref = gather_min_reference(d, idx)
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        fail(f"K4 K={k} R={rows}: kernel differs from the plain version by "
             f"{float((out - ref).abs().max())}")
    took = [r for r, c in gather_min.route_launches.items()
            if c > before[r]]
    if route is not None and took != [route]:
        fail(f"K4 K={k} R={rows}: took the {took} route, expected {route}")
    # the inputs are checked: time the launches without the index check
    ms = cuda_ms(lambda: launch_gather_min(d, idx), 10)
    parts = kernel_times(lambda: launch_gather_min(d, idx), 10)
    device_ms = sum(t for _, t in parts)
    plain_ms = cuda_ms(lambda: gather_min_reference(d, idx), 2)
    long_idx = idx.long()
    library_ms = cuda_ms(lambda: d[long_idx].amin(dim=0, keepdim=True), 3)
    # a repeated row does not change a min: the function needs each
    # distinct row of this run's idx once, idx in and one row out, and
    # one f32 compare per value of those rows
    distinct = int(torch.unique(idx).numel())
    bytes_ms = 4.0 * (distinct * k + rows + k) / PEAK_BYTES * 1e3
    ops_ms = float(distinct) * k / PEAK_F32 * 1e3
    log(f"K4 gather-min K={k} R={rows} ({took[0]} route): bitwise equal; "
        f"kernel {ms:.4f} ms ({rows * k * 4 / ms / 1e6:.1f} GB/s gathered, "
        f"{distinct * k * 4 / ms / 1e6:.1f} GB/s of the {distinct} distinct "
        f"rows), plain {plain_ms:.4f} ms, d[idx].amin {library_ms:.4f} ms, "
        f"bound {max(bytes_ms, ops_ms):.4f} ms "
        f"({'bytes' if bytes_ms > ops_ms else 'operations'}); device time "
        f"per call {device_ms:.4f} ms by kernel: "
        + "; ".join(f"{key[:32]} {t:.4f} ms" for key, t in parts))
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
            "library_ms": library_ms, "k4_route": took[0],
            "device_ms": device_ms}


def phase_kernels_assign_gather():
    import numpy as np
    import torch

    z = make_latents(K3_ROWS + K3_CODES, D, seed=1)
    zd = torch.from_numpy(z[:K3_ROWS]).cuda()
    cb = torch.from_numpy(z[K3_ROWS:]).cuda()  # medoid-like: other rows
    out = {"K3": check_assign("K3 assign (160000 x 16, 512 codes)", zd, cb,
                              20, split=True)}
    rng = np.random.default_rng(1)
    zr = torch.from_numpy(rng.normal(size=(1037, 5)).astype(np.float32))
    cbr = torch.from_numpy(rng.normal(size=(130, 5)).astype(np.float32))
    check_assign("K3 assign (ragged 1037 x 5, 130 codes)", zr.cuda(),
                 cbr.cuda(), 20)
    del zd, cb
    zw = make_latents(K3_WIDE_ROWS[-1] + K3_CODES, K3_WIDE, seed=2)
    zd = torch.from_numpy(zw[:K3_WIDE_ROWS[-1]]).cuda()
    cb = torch.from_numpy(zw[K3_WIDE_ROWS[-1]:]).cuda()
    for rows in K3_WIDE_ROWS:
        res = check_assign(f"K3 assign ({rows} x {K3_WIDE}, {K3_CODES} "
                           f"codes)", zd[:rows].contiguous(), cb, 20,
                           split=(rows == K3_WIDE_ROWS[0]))
        if rows == K3_WIDE_ROWS[0]:
            out[f"K3@{K3_WIDE}"] = res
    del zd, cb
    gen = torch.Generator(device="cuda").manual_seed(0)
    for k in K4_WIDTHS:
        out[f"K4@{k}"] = check_gather_min(k, gen, route="scan")
        torch.cuda.empty_cache()
    check_gather_min(K4_WIDTHS[-1], gen, rows=K4_SPARSE_ROWS, route="scan")
    check_gather_min(K4_WIDTHS[-1], gen, rows=K4_FEW_ROWS, route="gather")
    torch.cuda.empty_cache()
    return out


def pipeline_overrides(work: Path):
    """Overrides of the preset for the two orchestrated runs, rooted at
    ``work`` (the preset's relative ``experiments/...`` paths land under
    it). No dataset files, so the VAE trains on the synthetic 60,000 /
    10,000 split; the codebook and the transformer read the first
    ``CODEBOOK_IMAGES`` training latents (and their labels)."""
    cut = str(work / f"latents_train_{CODEBOOK_IMAGES}")
    return {
        "vae": {"max_epochs": PIPELINE_EPOCHS,
                "data": {"root": str(work / "no-data")}},
        "codebook": {"latents_path": cut},
        "transformer": {"data": {"labels_path": cut},
                        "training": {"epochs": TRANSFORMER_EPOCHS}},
    }


def zero_launches():
    from vqvae_tpu_torch.ops import fused_select, nearest_codes
    from vqvae_tpu_torch.ops.gather_min import gather_min

    for fn in (fused_select, nearest_codes, gather_min):
        fn.launches = 0
    gather_min.route_launches = dict.fromkeys(gather_min.route_launches, 0)


def read_launches():
    from vqvae_tpu_torch.ops import fused_select, nearest_codes
    from vqvae_tpu_torch.ops.gather_min import gather_min

    return {"K1/K2": fused_select.launches, "K3": nearest_codes.launches,
            "K4": gather_min.launches}


def quality_outputs(exp: Path) -> dict:
    import json as _json

    files = sorted(exp.glob("vae/**/vae_quality_assessment.json")) + [
        exp / "evaluation" / "quantization_analysis.json",
        exp / "evaluation" / "codebook_health.json"]
    missing = [str(f) for f in files if not f.exists()]
    if len(files) != 3 or missing:
        fail(f"quality outputs missing: {missing or 'vae assessment'}")
    return {f.name: _json.loads(f.read_text()) for f in files}


def timed_sampler():
    """Wrap the generate stage's sampler so one call's seconds (to a
    device sync), token steps and batch are recorded; returns the record
    and a function that restores the sampler."""
    import torch

    from vqvae_tpu_torch.cli import generate_samples as gen_mod

    orig, rec = gen_mod.sample_autoregressive, {}

    def timed(model, first, steps, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(model, first, steps, *args, **kwargs)
        torch.cuda.synchronize()
        rec.update(seconds=time.perf_counter() - t0, steps=steps,
                   batch=first.shape[0])
        return out

    gen_mod.sample_autoregressive = timed
    return rec, lambda: setattr(gen_mod, "sample_autoregressive", orig)


def phase_pipeline(work: Path):
    """vae, then codebook -> quality -> transformer -> generate ->
    evaluate, through the port's orchestrator; returns the experiment
    dir, the launches, seconds per stage and the training rates."""
    import json as _json

    import numpy as np
    import yaml

    from vqvae_tpu_torch.cli import run_pipeline
    from vqvae_tpu_torch.cli.pipeline import STAGES
    from vqvae_tpu_torch.config import load_config
    from vqvae_tpu_torch.utils.images import load_image
    from vqvae_tpu_torch.utils.latents import load_latents, save_latents

    preset = ROOT / PRESET
    exp = work / load_config(preset / "quality.yaml")["experiment"]
    run = exp / "vae" / "spatial_vae_fashionmnist"
    overrides = pipeline_overrides(work)
    work.mkdir(parents=True, exist_ok=True)
    zero_launches()
    first = run_pipeline(preset, skip=STAGES[1:], overrides=overrides,
                         root_dir=work, device="cuda")
    lat = load_latents(run / "latents_train")
    save_latents(overrides["codebook"]["latents_path"],
                 *(lat[k][:CODEBOOK_IMAGES]
                   for k in ("z", "mu", "logvar", "y")))
    sampling, restore = timed_sampler()
    try:
        rest = run_pipeline(preset, skip=STAGES[:1], overrides=overrides,
                            root_dir=work, device="cuda")
    finally:
        restore()
    launches = read_launches()
    seconds = {**{k: v for k, v in first.items() if k != "total"}, **rest}
    del seconds["total"]

    tf_dir = exp / "transformer"
    evaluation = exp / "evaluation"
    for path in (run / "checkpoints" / "best.pt",
                 run / "checkpoints" / "latest.pt",
                 run / "latents_train" / "latents.npz",
                 run / "latents_val" / "latents.npz",
                 run / "recon_grid.png", run / "metrics.jsonl",
                 exp / "codebook" / "codebook.npz",
                 exp / "codebook" / "codebook.pt",
                 exp / "codebook" / "codes.npy",
                 exp / "codebook" / "knn_graph_geodesic.npz",
                 tf_dir / "checkpoints" / "best.pt",
                 tf_dir / "checkpoints" / "latest.pt",
                 tf_dir / "metrics.jsonl",
                 evaluation / "generated_samples.png",
                 evaluation / "metrics.yaml",
                 evaluation / "comparison_grid.png"):
        if not path.exists():
            fail(f"pipeline artifact {path} missing")
    quality = quality_outputs(exp)
    rows = [_json.loads(line) for line in
            (run / "metrics.jsonl").read_text().splitlines()]
    val_loss = rows[-1]["val_loss"]
    if len(rows) != PIPELINE_EPOCHS or not np.isfinite(val_loss):
        fail(f"VAE training: {len(rows)} epochs, final val loss {val_loss}")
    tf_rows = [_json.loads(line) for line in
               (tf_dir / "metrics.jsonl").read_text().splitlines()]
    tf_losses = [(r["train_loss"], r["val_loss"]) for r in tf_rows]
    if len(tf_rows) != TRANSFORMER_EPOCHS or not np.all(
            np.isfinite(tf_losses)):
        fail(f"transformer training: {len(tf_rows)} epochs, losses "
             f"{tf_losses}")
    if not tf_rows[-1]["train_loss"] < tf_rows[0]["train_loss"]:
        fail(f"transformer training: train loss did not fall: {tf_losses}")
    grid = load_image(evaluation / "generated_samples.png")
    if grid.shape[:2] != (302, 302):
        fail(f"generated_samples.png is {grid.shape}, expected 302 x 302")
    metrics = yaml.safe_load((evaluation / "metrics.yaml").read_text())
    if not (np.isfinite(metrics["PSNR_full"])
            and np.isfinite(metrics["SSIM_full"])
            and metrics["LPIPS"] is None):
        fail(f"evaluation metrics {metrics}")
    if launches["K1/K2"] <= 0:
        fail("the codebook stage launched no K1 kernel")
    if launches["K3"] <= 0:
        fail("the quality stage launched no K3 kernel")
    if not sampling:
        fail("the generate stage did not sample")
    rates = [r["train_steps"] / r["train_seconds"] for r in rows]
    tf_rates = [r["train_steps"] / r["train_seconds"] for r in tf_rows]
    token_ms = sampling["seconds"] / sampling["steps"] * 1e3
    codes = np.load(exp / "codebook" / "codes.npy")
    shown = ("psnr", "ssim", "quality", "health", "entropy", "used")
    summary = "; ".join(
        name + ": " + ", ".join(f"{k} {v}" for k, v in q.items()
                                if k.startswith(shown))
        for name, q in quality.items())
    log(f"pipeline seconds by stage: "
        + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items()))
    log(f"pipeline: vae {PIPELINE_EPOCHS} epochs, {rows[-1]['train_steps']} "
        f"steps each, steps/s per epoch "
        f"{', '.join(f'{r:.2f}' for r in rates)}; final val loss {val_loss}, "
        f"psnr {rows[-1]['val_psnr']}; codebook {codes.size} nodes; quality "
        f"{summary}")
    log(f"pipeline: transformer {TRANSFORMER_EPOCHS} epochs of "
        f"{tf_rows[0]['train_steps']} steps, steps/s per epoch "
        f"{', '.join(f'{r:.2f}' for r in tf_rates)}; (train, val) loss per "
        f"epoch {', '.join(f'({a:.4f}, {b:.4f})' for a, b in tf_losses)}")
    log(f"pipeline: generate sampled {sampling['batch']} sequences, "
        f"{sampling['steps']} token steps in {sampling['seconds']:.3f}s "
        f"({token_ms:.3f} ms a step); evaluate PSNR {metrics['PSNR_full']}, "
        f"SSIM {metrics['SSIM_full']}, LPIPS {metrics['LPIPS']}; launches "
        f"{launches}")
    return {"exp": exp, "launches": launches, "quality": quality,
            "seconds": seconds, "steps_per_s": rates,
            "transformer_steps_per_s": tf_rates, "token_ms": token_ms,
            "val_loss": val_loss}


def phase_quality_reference(exp: Path, gpu_quality: dict):
    """The quality evaluators on the pipeline's artifacts on the CPU
    against the card's run; codes compared directly."""
    import numpy as np

    from vqvae_tpu_torch.cli import load_codebook, run_quality_stage
    from vqvae_tpu_torch.cli.quality_checks import nearest_medoid_assign
    from vqvae_tpu_torch.utils.latents import load_latents

    z = load_latents(next(exp.glob("vae/*/latents_val")))["z"]
    z = z.reshape(-1, z.shape[-1])
    cb = load_codebook(exp / "codebook")["z_medoid"].astype(np.float32)
    zero_launches()
    gpu_codes = nearest_medoid_assign(z, cb, "cuda")
    cpu_codes = nearest_medoid_assign(z, cb, "cpu")
    differ = np.nonzero(gpu_codes != cpu_codes)[0]
    if differ.size:
        zz = z[differ].astype(np.float64)
        a = ((zz - cb[gpu_codes[differ]]) ** 2).sum(1)
        b = ((zz - cb[cpu_codes[differ]]) ** 2).sum(1)
        gap = float((np.abs(a - b) / np.minimum(a, b)).max())
        if gap > 1e-5:
            fail(f"quality codes: card and CPU differ beyond near-ties "
                 f"(relative gap {gap:.3e})")
    t0 = time.perf_counter()
    run_quality_stage(exp, dataset="fashionmnist", device="cpu")
    t_cpu = time.perf_counter() - t0
    cpu_quality = quality_outputs(exp)
    worst = 0.0
    for name, want in gpu_quality.items():
        for key, val in want.items():
            have = cpu_quality[name][key]
            if key.startswith("psnr"):
                worst = max(worst, abs(have - val))
                if abs(have - val) > 1e-3:
                    fail(f"quality {name} {key}: card {val} vs CPU {have}")
            elif isinstance(val, str) and have != val:
                fail(f"quality {name} {key}: card {val!r} vs CPU {have!r}")
    log(f"quality card vs CPU: {differ.size} of {len(z)} codes differ "
        f"(near-ties), max PSNR difference {worst:.3e} dB, ratings equal; "
        f"CPU quality stage {t_cpu:.3f}s")


def set_tf32() -> None:
    """TF32 in f32 matmuls and cuDNN convolutions: the train-step check's
    control (``resolve_device`` sets full f32 again)."""
    import torch

    if hasattr(torch.backends, "fp32_precision"):
        torch.backends.cuda.matmul.fp32_precision = "tf32"
        torch.backends.cudnn.conv.fp32_precision = "tf32"
        log(f"TF32 control: matmul "
            f"{torch.backends.cuda.matmul.fp32_precision}, cuDNN conv "
            f"{torch.backends.cudnn.conv.fp32_precision}")
    else:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True


def phase_train_step_reference(seed: int = 42):
    """One train step of the preset VAE at full width on the same batch
    and noise, card against CPU."""
    import copy

    import torch

    from vqvae_tpu_torch.config import load_config
    from vqvae_tpu_torch.data import load_dataset
    from vqvae_tpu_torch.device import resolve_device
    from vqvae_tpu_torch.models import VAE, BatchNorm, flax_init_
    from vqvae_tpu_torch.train import VAEEngine
    from vqvae_tpu_torch.train.vae_engine import seeded_generator

    cfg = load_config(ROOT / PRESET / "vae.yaml")
    arch = dict(cfg["model"])
    arch.pop("beta")
    model = flax_init_(VAE(**arch), seeded_generator("cpu", seed))
    split = load_dataset("fashionmnist", root="no-such-dir", train=True,
                         synthetic_size=256, seed=seed)
    images = torch.from_numpy(split.images)
    mask = torch.ones(images.shape[0])
    mask[-16:] = 0.0
    images[-16:] = 0.0  # a padded tail, as the last batch has
    lr = float(cfg["lr"])

    def step(dev, tf32=False):
        m = copy.deepcopy(model)
        eng = VAEEngine(m, lr=lr, weight_decay=float(cfg["weight_decay"]),
                        grad_clip_max_norm=float(cfg["grad_clip_max_norm"]),
                        cosine_t_max=int(cfg["max_epochs"]),
                        steps_per_epoch=235, seed=seed, device=dev)
        if tf32:  # the control: the engine has set full f32; undo it
            set_tf32()
        try:  # the same noise on both devices: a CPU generator
            out = eng.train_step(images.to(dev), mask.to(dev), 1.0,
                                 seeded_generator("cpu", seed, 1))
        finally:
            resolve_device(dev)  # full f32 again
        return (float(out["loss"]),
                {k: (p.detach().cpu(), p.grad.detach().cpu())
                 for k, p in m.named_parameters()},
                {k: b.cpu() for k, b in m.named_buffers()})

    loss_g, par_g, buf_g = step("cuda")
    loss_t, par_t, _ = step("cuda", tf32=True)
    loss_c, par_c, buf_c = step("cpu")
    # a conv bias that feeds a BatchNorm has a true gradient of 0: its
    # rounding residue (and Adam's sign of it) is no signal
    pre_norm = set()
    for name, mod in model.named_modules():
        if isinstance(mod, BatchNorm):
            parent, i = name.rsplit(".", 1)
            pre_norm.add(f"{parent}.{int(i) - 1}.bias")

    def grad_gap(par):
        """Largest gradient difference from the CPU's, as a share of the
        tensor's norm, and that tensor's name."""
        return max((float((par[k][1] - g_c).norm() / g_c.norm()), k)
                   for k, (_, g_c) in par_c.items() if k not in pre_norm)

    # Elementwise, a gradient may differ by ~1e-3 of its tensor's largest:
    # train-mode BatchNorm's backward cancels, and ReLU gates at rounding
    # distance from 0 flip. So each tensor is held as a whole; and Adam's
    # first step is ~lr * sign(g), so a parameter whose gradient sign
    # flipped lands 2 lr away, and parameters cannot show a gradient's
    # size: the gradient limit is what tells f32 from TF32 convolutions,
    # and the TF32 control shows that it does.
    worst, worst_tf32 = grad_gap(par_g), grad_gap(par_t)
    log(f"train step TF32 control: loss {loss_t} vs CPU {loss_c}; largest "
        f"gradient difference {worst_tf32[0]:.3e} of its tensor's norm "
        f"({worst_tf32[1]}); full f32: {worst[0]:.3e} ({worst[1]})")
    if worst_tf32[0] <= GRAD_LIMIT:
        fail(f"train step: the TF32 control passes the gradient limit "
             f"{GRAD_LIMIT}, so the check cannot tell TF32 from f32")
    if abs(loss_g - loss_c) > 1e-5 * abs(loss_c):
        fail(f"train step: loss {loss_g} (card) vs {loss_c} (CPU)")
    n_par, n_close = 0, 0
    for key, (p_c, _) in par_c.items():
        if key in pre_norm:
            continue
        dp = (par_g[key][0] - p_c).abs()
        if (dp > 1e-4 * p_c.abs() + 2.0 * lr + 1e-7).any():
            fail(f"train step: parameters of {key} moved apart by more "
                 f"than one Adam step")
        n_close += int((dp <= 1e-4 * p_c.abs() + 1e-7).sum())
        n_par += p_c.numel()
    if worst[0] > GRAD_LIMIT:
        fail(f"train step: gradient of {worst[1]} differs by "
             f"{worst[0]:.3e} of its norm (limit {GRAD_LIMIT})")
    if n_close < 0.99 * n_par:
        fail(f"train step: only {n_close} of {n_par} parameters within "
             f"rtol 1e-4")
    for key, b_c in buf_c.items():
        if b_c.is_floating_point() and not torch.allclose(
                buf_g[key], b_c, rtol=1e-4, atol=1e-6):
            fail(f"train step: BatchNorm statistic {key} differs")
    log(f"train step card vs CPU: loss {loss_g} vs {loss_c}; largest "
        f"gradient difference {worst[0]:.3e} of its tensor's norm "
        f"({worst[1]}, limit {GRAD_LIMIT}); {n_close} of {n_par} parameters "
        f"within rtol 1e-4, all within 2 lr ({len(pre_norm)} pre-norm "
        f"biases skipped); BatchNorm statistics within rtol 1e-4")


def phase_transformer_reference(seed: int = 42):
    """The transformer prior at the preset's width on the card against the
    CPU, from the same weights, dropout 0: one train step, the KV cache
    against the full-prefix forward, greedy sampling; then the card's
    train step time beside its FLOPs at the f32 peak."""
    import copy

    import torch

    from vqvae_tpu_torch.config import load_config
    from vqvae_tpu_torch.device import resolve_device
    from vqvae_tpu_torch.models.transformer import (Transformer,
                                                    transformer_init_)
    from vqvae_tpu_torch.train import TransformerEngine
    from vqvae_tpu_torch.train.transformer_engine import sample_autoregressive
    from vqvae_tpu_torch.train.vae_engine import seeded_generator

    cfg = load_config(ROOT / PRESET / "transformer.yaml")
    arch = {**dict(cfg["model"]), "dropout": 0.0}
    train = cfg["training"]
    model = transformer_init_(Transformer(**arch),
                              seeded_generator("cpu", seed))
    bs, seq = int(cfg["data"]["batch_size"]), arch["max_seq_len"]
    vocab, classes = arch["num_tokens"], arch["num_classes"]
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(0, vocab, (bs, seq - 1), generator=g)
    t = torch.randint(0, vocab, (bs, seq - 1), generator=g)
    lab = torch.randint(0, classes, (bs,), generator=g)
    mask = torch.ones(bs)
    mask[-16:] = 0.0  # a padded tail, as the last batch has
    x[-16:], t[-16:] = 0, 0

    def engine(dev):
        return TransformerEngine(
            copy.deepcopy(model), lr=float(train["lr"]),
            weight_decay=float(train["weight_decay"]),
            cosine_t_max=int(train["epochs"]), steps_per_epoch=16,
            label_smoothing=float(train["label_smoothing"]), seed=seed,
            device=dev)

    def step(dev, tf32=False):
        eng = engine(dev)
        if tf32:  # the control: the engine has set full f32; undo it
            set_tf32()
        try:
            loss = eng.train_step(x.to(dev), t.to(dev), lab.to(dev),
                                  mask.to(dev), None)
        finally:
            resolve_device(dev)  # full f32 again
        return float(loss), {k: p.grad.detach().cpu()
                             for k, p in eng.model.named_parameters()}

    loss_g, grad_g = step("cuda")
    loss_t, grad_t = step("cuda", tf32=True)
    loss_c, grad_c = step("cpu")

    def grad_gap(grads):
        # the attention key biases have a true gradient of 0: the softmax
        # over keys ignores a constant added to every key's logit
        return max((float((grads[k] - g_c).norm() / g_c.norm()), k)
                   for k, g_c in grad_c.items()
                   if not k.endswith("attn.key.bias"))

    worst, worst_tf32 = grad_gap(grad_g), grad_gap(grad_t)
    log(f"transformer train step TF32 control: loss {loss_t} vs CPU "
        f"{loss_c}; largest gradient difference {worst_tf32[0]:.3e} of its "
        f"tensor's norm ({worst_tf32[1]}); full f32: {worst[0]:.3e} "
        f"({worst[1]}); loss {loss_g}")
    if worst_tf32[0] <= TF_GRAD_LIMIT:
        fail(f"transformer train step: the TF32 control passes the gradient "
             f"limit {TF_GRAD_LIMIT}, so the check cannot tell TF32 from f32")
    if abs(loss_g - loss_c) > 1e-5 * abs(loss_c):
        fail(f"transformer train step: loss {loss_g} (card) vs {loss_c} "
             f"(CPU)")
    if worst[0] > TF_GRAD_LIMIT:
        fail(f"transformer train step: gradient of {worst[1]} differs by "
             f"{worst[0]:.3e} of its norm (limit {TF_GRAD_LIMIT})")

    card = copy.deepcopy(model).cuda().eval()
    cpu = copy.deepcopy(model).eval()
    xs = torch.randint(0, vocab, (bs, seq), generator=g)
    with torch.no_grad():
        xd, yd = xs.cuda(), lab.cuda()
        full = card(xd, y=yd)
        cache = card.init_cache(bs)
        kv_err = 0.0
        for i in range(seq):
            step_logits = card(xd[:, i:i + 1], y=yd, cache=cache)[:, 0]
            scale = full[:, i].abs().amax(-1)
            kv_err = max(kv_err, float(((step_logits - full[:, i]).abs()
                                        .amax(-1) / scale).max()))
    if kv_err > 1e-5:
        fail(f"transformer KV cache: logits differ from the full-prefix "
             f"forward by {kv_err:.3e} relative")

    n_gen = 100
    first = torch.randint(0, vocab, (n_gen, 1), generator=g)
    y_gen = torch.arange(classes).repeat_interleave(n_gen // classes)
    got = sample_autoregressive(
        card, first.cuda(), seq - 1,
        torch.Generator(device="cuda").manual_seed(0), top_k=1,
        labels=y_gen.cuda()).cpu()
    want = sample_autoregressive(cpu, first, seq - 1,
                                 torch.Generator().manual_seed(0), top_k=1,
                                 labels=y_gen)
    near_ties = 0
    for r in torch.nonzero((got != want).any(1)).flatten().tolist():
        c = int(torch.nonzero(got[r] != want[r])[0])
        with torch.no_grad():
            logits = cpu(want[r:r + 1, :c], y=y_gen[r:r + 1])[0, -1]
        top2 = torch.topk(logits, 2).values
        if float(top2[0] - top2[1]) > 1e-5 * float(top2[0].abs()):
            fail(f"greedy sampling: sequence {r} differs from the CPU at "
                 f"position {c} without a near-tie")
        near_ties += 1

    # the card's step: wall time per step, device time per step, and the
    # model's FLOPs at the f32 peak (matmuls and attention, backward 2x)
    eng = engine("cuda")
    batch = [a.cuda() for a in (x, t, lab, mask)]
    eng.train_step(*batch, None)
    torch.cuda.synchronize()
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        eng.train_step(*batch, None)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / reps * 1e3
    parts = kernel_times(lambda: eng.train_step(*batch, None), 5)
    device_ms = sum(ms for _, ms in parts)
    mat = sum(p.numel() for k, p in model.named_parameters()
              if p.ndim == 2 and ("blocks" in k or k.startswith("head")))
    tokens = bs * (seq - 1)
    flops = 3 * (2 * mat * tokens + 4 * len(model.blocks) * bs
                 * (seq - 1) ** 2 * arch["embed_dim"])
    flops_ms = flops / PEAK_F32 * 1e3
    log(f"transformer card vs CPU at the preset's width: loss {loss_g} vs "
        f"{loss_c}; largest gradient difference {worst[0]:.3e} of its "
        f"tensor's norm ({worst[1]}, limit {TF_GRAD_LIMIT}); KV cache vs "
        f"full prefix {kv_err:.3e} relative; greedy {n_gen} x {seq - 1} "
        f"tokens, {near_ties} sequences differ at near-ties")
    log(f"transformer train step on the card (batch {bs}): wall "
        f"{step_ms:.3f} ms ({1e3 / step_ms:.2f} steps/s), device time "
        f"{device_ms:.3f} ms ({device_ms / step_ms:.1%} busy) in "
        f"{len(parts)} kernel kinds; {flops / 1e9:.2f} GFLOP at the f32 "
        f"peak {flops_ms:.3f} ms ({flops_ms / step_ms:.1%} of the step)")
    return {"step_ms": step_ms, "device_ms": device_ms,
            "flops_ms": flops_ms, "grad_gap": worst[0],
            "grad_gap_tf32": worst_tf32[0], "kv_err": kv_err,
            "near_ties": near_ties}


def phase_gather_min_tool():
    """The gather-min tool's entry point at its default shapes."""
    from vqvae_tpu_torch.ops.gather_min import gather_min
    from vqvae_tpu_torch.tools import bench_gather_min

    zero_launches()
    t0 = time.perf_counter()
    res = bench_gather_min.main(["--device", "cuda"])
    launches = read_launches()["K4"]
    routes = dict(gather_min.route_launches)
    if launches <= 0:
        fail("the gather-min tool launched no K4 kernel")
    if routes["scan"] <= 0:
        fail(f"the gather-min tool never took K4's scan route: {routes}")
    log(f"gather-min tool: {time.perf_counter() - t0:.3f}s, K4 launches "
        f"{launches} (by route {routes}; by width "
        f"{ {k: r['launches'] for k, r in res.items()} })")
    return {k: r["launches"] for k, r in res.items()}


def phase_vanilla(work: Path):
    """The vanilla geodesic preset through ``run_pipeline`` (all six
    stages, ``legacy_riemannian``), then the ``legacy`` builder on the same
    latents; returns the launches, seconds by stage and the QEs."""
    import json as _json

    import numpy as np
    import yaml

    from vqvae_tpu_torch.cli import (build_codebook_legacy_main,
                                     load_codebook, run_pipeline)
    from vqvae_tpu_torch.cli.pipeline import STAGES
    from vqvae_tpu_torch.config import load_config
    from vqvae_tpu_torch.utils.images import load_image

    preset = ROOT / VANILLA
    exp = work / load_config(preset / "quality.yaml")["experiment"]
    overrides = {"vae": {"max_epochs": VANILLA_VAE_EPOCHS,
                         "data": {"root": str(work / "no-data")}},
                 "transformer": {"training": {"epochs": VANILLA_TF_EPOCHS}}}
    work.mkdir(parents=True, exist_ok=True)
    zero_launches()
    seconds = run_pipeline(preset, overrides=overrides, root_dir=work,
                           device="cuda")
    launches = read_launches()
    if list(seconds) != list(STAGES) + ["total"]:
        fail(f"vanilla pipeline ran {list(seconds)}")

    cb_dir = exp / "codebook"
    tf_dir = exp / "transformer"
    evaluation = exp / "evaluation"
    for path in (exp / "vae" / "checkpoints" / "best.pt",
                 exp / "vae" / "latents_train" / "latents.npz",
                 cb_dir / "knn_graph.npz", cb_dir / "knn_graph_riemannian.npz",
                 cb_dir / "codebook.npz", cb_dir / "codes.npy",
                 tf_dir / "checkpoints" / "best.pt", tf_dir / "metrics.jsonl",
                 evaluation / "generated_samples.png",
                 evaluation / "metrics.yaml"):
        if not path.exists():
            fail(f"vanilla pipeline artifact {path} missing")
    quality = quality_outputs(exp)

    def check_codebook(out: Path, label: str):
        codes = np.load(out / "codes.npy")
        cb = load_codebook(out)
        rec = cb["config"]
        if codes.shape != (60_000,) or codes.max() >= 512:
            fail(f"{label}: codes shape {codes.shape}, max {codes.max()}")
        if int((codes >= 0).sum()) != rec["lcc_nodes"]:
            fail(f"{label}: -1 codes do not match the LCC "
                 f"({rec['lcc_nodes']} nodes)")
        if len(cb["medoid_indices"]) != 512 or not np.isfinite(
                rec["quantization_error"]):
            fail(f"{label}: {len(cb['medoid_indices'])} medoids, QE "
                 f"{rec['quantization_error']}")
        return rec

    riem = check_codebook(cb_dir, "legacy_riemannian")
    cfg = load_config(preset / "codebook.yaml", {
        "builder": "legacy",
        "latents_path": str(exp / "vae" / "latents_train"),
        "vae_ckpt_path": str(exp / "vae" / "checkpoints" / "best"),
        "out_dir": str(exp / "codebook_euclidean")})
    t0 = time.perf_counter()
    out = build_codebook_legacy_main(cfg, riemannian=False, device="cuda")
    t_euclid = time.perf_counter() - t0
    if (out / "knn_graph_riemannian.npz").exists():
        fail("the legacy builder wrote a Riemannian graph")
    euclid = check_codebook(out, "legacy")

    tf_rows = [_json.loads(line) for line in
               (tf_dir / "metrics.jsonl").read_text().splitlines()]
    tf_losses = [(r["train_loss"], r["val_loss"]) for r in tf_rows]
    if len(tf_rows) != VANILLA_TF_EPOCHS or not np.all(
            np.isfinite(tf_losses)):
        fail(f"vanilla transformer: {len(tf_rows)} epochs, {tf_losses}")
    if not tf_rows[-1]["train_loss"] < tf_rows[0]["train_loss"]:
        fail(f"vanilla transformer: train loss did not fall: {tf_losses}")
    grid = load_image(evaluation / "generated_samples.png")
    if grid.shape[:2] != (302, 302):
        fail(f"vanilla generated_samples.png is {grid.shape}")
    metrics = yaml.safe_load((evaluation / "metrics.yaml").read_text())
    if not (np.isfinite(metrics["PSNR_full"])
            and np.isfinite(metrics["SSIM_full"])):
        fail(f"vanilla evaluation metrics {metrics}")
    if launches["K3"] <= 0:
        fail("the vanilla quality stage launched no K3 kernel")
    vae_rows = [_json.loads(line) for line in
                (exp / "vae" / "metrics.jsonl").read_text().splitlines()]
    rates = [r["train_steps"] / r["train_seconds"] for r in vae_rows]
    tf_rates = [r["train_steps"] / r["train_seconds"] for r in tf_rows]
    shown = ("psnr", "quality", "health", "entropy", "used")
    log("vanilla pipeline seconds by stage: "
        + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items()))
    log(f"vanilla: vae steps/s per epoch "
        f"{', '.join(f'{r:.2f}' for r in rates)}; legacy_riemannian "
        f"{riem['lcc_nodes']} LCC nodes, QE {riem['quantization_error']}, "
        f"steps {riem['timings_s']}; transformer steps/s per epoch "
        f"{', '.join(f'{r:.2f}' for r in tf_rates)}, (train, val) loss "
        f"{', '.join(f'({a:.4f}, {b:.4f})' for a, b in tf_losses)}; "
        f"evaluate PSNR {metrics['PSNR_full']}, SSIM {metrics['SSIM_full']};"
        f" launches {launches}")
    log("vanilla quality: " + "; ".join(
        name + ": " + ", ".join(f"{k} {v}" for k, v in q.items()
                                if k.startswith(shown))
        for name, q in quality.items()))
    log(f"vanilla legacy (Euclidean) builder: {t_euclid:.3f}s, "
        f"{euclid['lcc_nodes']} LCC nodes, QE {euclid['quantization_error']},"
        f" steps {euclid['timings_s']}")
    return {"launches": launches, "seconds": seconds,
            "euclid_s": t_euclid}


def baseline_config(work: Path) -> Path:
    """The baseline's config at full width, 2 epochs, rooted at ``work``
    (no dataset files there: the synthetic CIFAR-10 split); its path."""
    import yaml

    cfg = yaml.safe_load((ROOT / BASELINE).read_text())
    cfg["out_dir"] = str(work / "baseline")
    cfg["data"]["root"] = str(work / "no-data")
    cfg["train"]["epochs"] = BASELINE_EPOCHS
    work.mkdir(parents=True, exist_ok=True)
    path = work / "baseline.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def phase_baseline(work: Path):
    """The baseline through ``run_baseline_pipeline`` and
    ``eval_codebook_metrics_main``; then one step's wall and device ms."""
    import json as _json

    import numpy as np
    import torch

    from vqvae_tpu_torch.cli import (eval_codebook_metrics_main,
                                     run_baseline_pipeline)
    from vqvae_tpu_torch.cli.train_baseline_vqvae import (
        baseline_model, baseline_split_loader)
    from vqvae_tpu_torch.config import load_config
    from vqvae_tpu_torch.train import VQVAEEngine
    from vqvae_tpu_torch.utils.images import load_image

    path = baseline_config(work)
    cfg = load_config(path)
    base = Path(cfg["out_dir"])
    timings = run_baseline_pipeline(path, device="cuda")
    t0 = time.perf_counter()
    metrics = eval_codebook_metrics_main(cfg, split="test", device="cuda")
    timings["eval_codebook_metrics"] = time.perf_counter() - t0
    rows = [_json.loads(line) for line in
            (base / "metrics.jsonl").read_text().splitlines()]
    losses = [(r["train_loss"], r["val_loss"]) for r in rows]
    if len(rows) != BASELINE_EPOCHS or not np.all(np.isfinite(losses)):
        fail(f"baseline training: {len(rows)} epochs, losses {losses}")
    if not rows[-1]["train_loss"] < rows[0]["train_loss"]:
        fail(f"baseline training: train loss did not fall: {losses}")
    if not (rows[-1]["val_perplex"] > 1.0 and rows[-1]["val_usage"] > 0.0):
        fail(f"baseline training: perplexity {rows[-1]['val_perplex']}, "
             f"usage {rows[-1]['val_usage']}")
    ev = base / "evaluation"
    results = {}
    for name in ("evaluation_results.json", "metrics.yaml",
                 "codebook_health.json", "generated_samples.png"):
        if not (ev / name).exists():
            fail(f"baseline evaluation file {name} missing")
    results = _json.loads((ev / "evaluation_results.json").read_text())
    health = _json.loads((ev / "codebook_health.json").read_text())
    if not (np.isfinite(results["recon_psnr"])
            and np.isfinite(results["recon_ssim"])
            and results["perplexity"] > 1.0):
        fail(f"baseline evaluation {results}")
    table = (base / "codebook_eval_test.csv").read_text().splitlines()
    if len(table) != 2 or not table[1].startswith("test,"):
        fail(f"baseline codebook_eval_test.csv: {table}")
    if not (metrics["perplex"] > 1.0 and metrics["usage"] > 0.0):
        fail(f"baseline codebook metrics {metrics}")
    recon = load_image(base / f"recon_epoch{BASELINE_EPOCHS:04d}.png")
    if recon.shape != (4 * 34 + 2, 8 * 34 + 2, 3):
        fail(f"baseline recon grid {recon.shape}")
    rates = [r["train_steps"] / r["train_seconds"] for r in rows]

    # one step at the config's width: wall time and device time
    m = cfg["model"]
    eng = VQVAEEngine(baseline_model(m), n_codes=int(m["n_codes"]),
                      beta=float(m["beta"]), ema_decay=float(m["ema_decay"]),
                      lr=float(cfg["train"]["lr"]),
                      grad_clip=float(cfg["train"]["grad_clip"]),
                      seed=int(cfg["seed"]), device="cuda")
    cb, bank = eng.init_state()
    loader = baseline_split_loader(cfg, int(cfg["train"]["batch_size"]),
                                   train=True)
    x, mask, _, _ = eng.device_dataset(loader, loader.batch_size)
    bs = loader.batch_size
    xb, mb = x[:bs], mask[:bs]
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = [cb, bank]

    def step():
        state[0], state[1], _ = eng.train_step(state[0], state[1], xb, mb,
                                               gen)

    step()
    torch.cuda.synchronize()
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / reps * 1e3
    parts = kernel_times(step, 5)
    device_ms = sum(ms for _, ms in parts)
    # the step's convolutions and products, forward and backward
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        step()
    flops = counter.get_total_flops()
    flops_ms = flops / PEAK_F32 * 1e3
    log(f"baseline seconds: " + ", ".join(f"{k} {v:.3f}"
                                          for k, v in timings.items()))
    log(f"baseline: {BASELINE_EPOCHS} epochs of {rows[0]['train_steps']} "
        f"steps, steps/s per epoch {', '.join(f'{r:.2f}' for r in rates)}; "
        f"(train, val) loss {', '.join(f'({a:.4f}, {b:.4f})' for a, b in losses)}"
        f"; val perplexity {rows[-1]['val_perplex']:.2f}, usage "
        f"{rows[-1]['val_usage']:.3f}, reseeded {rows[-1]['reseeded']}; "
        f"evaluate {results}, health {health['health_assessment']}; "
        f"test metrics {({k: round(v, 5) for k, v in metrics.items()})}")
    log(f"baseline train step on the card (batch {bs}): wall "
        f"{step_ms:.3f} ms ({1e3 / step_ms:.2f} steps/s), device time "
        f"{device_ms:.3f} ms ({device_ms / step_ms:.1%} busy) in "
        f"{len(parts)} kernel kinds; {flops / 1e9:.2f} GFLOP at the f32 "
        f"peak {flops_ms:.3f} ms ({flops_ms / step_ms:.1%} of the step); "
        f"largest: " + "; ".join(f"{key[:40]} {t:.3f} ms"
                                 for key, t in parts[:4]))
    return {"timings": timings, "steps_per_s": rates, "step_ms": step_ms,
            "device_ms": device_ms, "flops_ms": flops_ms}


def phase_baseline_step_reference(seed: int = 42):
    """One baseline train step at the config's width on the card against
    the CPU, from the same weights, codebook, batch and bank draw."""
    import copy

    import numpy as np
    import torch

    from vqvae_tpu_torch.config import load_config
    from vqvae_tpu_torch.data import load_dataset
    from vqvae_tpu_torch.device import resolve_device
    from vqvae_tpu_torch.models.vae import flax_init_
    from vqvae_tpu_torch.models.vqvae_baseline import CodebookState, quantize
    from vqvae_tpu_torch.cli.train_baseline_vqvae import baseline_model
    from vqvae_tpu_torch.train import VQVAEEngine
    from vqvae_tpu_torch.train.vae_engine import seeded_generator

    cfg = load_config(ROOT / BASELINE)
    m, tr = cfg["model"], cfg["train"]
    bs, n_codes = int(tr["batch_size"]), int(m["n_codes"])
    model = flax_init_(baseline_model(m), seeded_generator("cpu", seed))
    cb0 = CodebookState.create(seeded_generator("cpu", seed, 1), n_codes,
                               int(m["z_channels"]))
    split = load_dataset("cifar10", root="no-such-dir", train=True,
                         synthetic_size=bs, seed=seed)
    x = torch.from_numpy(split.denormalize(split.images) * 2.0 - 1.0).float()
    mask = torch.ones(bs)
    x[-16:], mask[-16:] = 0.0, 0.0  # a padded tail, as the padded set has

    def step(dev, tf32=False):
        eng = VQVAEEngine(copy.deepcopy(model), n_codes=n_codes,
                          beta=float(m["beta"]),
                          ema_decay=float(m["ema_decay"]),
                          ema_eps=float(m["ema_eps"]), lr=float(tr["lr"]),
                          grad_clip=float(tr["grad_clip"]), seed=seed,
                          device=dev)
        grads, run_opt = {}, eng.opt.step

        def snapshot_then_step():  # the gradients before clipping
            grads.update({k: p.grad.detach().cpu().clone()
                          for k, p in eng.model.named_parameters()})
            run_opt()

        eng.opt.step = snapshot_then_step
        if tf32:  # the control: the engine has set full f32; undo it
            set_tf32()
        try:
            with torch.no_grad():
                _, idx = quantize(cb0.to(dev), eng.model.encode(x.to(dev)))
                z_e = eng.model.encode(x.to(dev)).cpu()
            cb, _, met = eng.train_step(
                cb0.to(dev), torch.zeros(eng.bank_size, cb0.embed.shape[1],
                                         device=dev),
                x.to(dev), mask.to(dev), seeded_generator("cpu", seed, 2))
        finally:
            resolve_device(dev)  # full f32 again
        return (float(met["loss"]), grads, cb.to("cpu"), idx.cpu(), z_e)

    loss_g, grad_g, cb_g, idx_g, z_g = step("cuda")
    loss_t, grad_t, _, _, _ = step("cuda", tf32=True)
    loss_c, grad_c, cb_c, idx_c, z_c = step("cpu")

    flat = z_c.reshape(-1, z_c.shape[-1])
    n_ties = near_tie_rows(flat, cb0.embed, idx_g.reshape(-1),
                           idx_c.reshape(-1), name="baseline quantize")

    def grad_gap(grads):
        return max((float((grads[k] - g_c).norm() / g_c.norm()), k)
                   for k, g_c in grad_c.items())

    worst, worst_tf32 = grad_gap(grad_g), grad_gap(grad_t)
    log(f"baseline train step TF32 control: loss {loss_t} vs CPU {loss_c}; "
        f"largest gradient difference {worst_tf32[0]:.3e} of its tensor's "
        f"norm ({worst_tf32[1]}); full f32: {worst[0]:.3e} ({worst[1]}); "
        f"quantize rows differing at near-ties: {n_ties}")
    if worst_tf32[0] <= VQ_GRAD_LIMIT:
        fail(f"baseline train step: the TF32 control passes the gradient "
             f"limit {VQ_GRAD_LIMIT}, so the check cannot tell TF32 from "
             f"f32")
    if abs(loss_g - loss_c) > 1e-5 * abs(loss_c):
        fail(f"baseline train step: loss {loss_g} (card) vs {loss_c} (CPU)")
    if worst[0] > VQ_GRAD_LIMIT:
        fail(f"baseline train step: gradient of {worst[1]} differs by "
             f"{worst[0]:.3e} of its norm (limit {VQ_GRAD_LIMIT})")
    # codes whose members a near-tie row moved get other EMA sums
    moved = torch.unique(torch.cat([idx_g.reshape(-1)[idx_g.reshape(-1)
                                                      != idx_c.reshape(-1)],
                                    idx_c.reshape(-1)[idx_g.reshape(-1)
                                                      != idx_c.reshape(-1)]]))
    keep = torch.ones(n_codes, dtype=torch.bool)
    keep[moved] = False
    # each code held as a whole: a code's EMA sum adds its members' z_e,
    # whose elements cancel, so one element's relative error says nothing
    worst_cb, worst_elem = 0.0, 0.0
    for key in ("embed", "cluster_size", "embed_avg"):
        a, b = getattr(cb_g, key)[keep], getattr(cb_c, key)[keep]
        if a.ndim == 1:
            a, b = a[:, None], b[:, None]
        gap = float(((a - b).norm(dim=1)
                     / b.norm(dim=1).clamp_min(1e-30)).max())
        worst_elem = max(worst_elem, float(((a - b).abs()
                                            / b.abs().clamp_min(1e-30))
                                           .max()))
        worst_cb = max(worst_cb, gap)
        if gap > 1e-5:
            fail(f"baseline train step: EMA codebook {key} differs by "
                 f"{gap:.3e} of a code's norm")
    log(f"baseline train step card vs CPU: loss {loss_g} vs {loss_c}; "
        f"largest gradient difference {worst[0]:.3e} of its tensor's norm "
        f"({worst[1]}, limit {VQ_GRAD_LIMIT}); EMA codebook within "
        f"{worst_cb:.3e} of a code's norm (elementwise {worst_elem:.3e} "
        f"relative; {int(moved.numel())} codes left out); "
        f"{n_ties} of {idx_c.numel()} codes differ at near-ties")
    return {"grad_gap": worst[0], "grad_gap_tf32": worst_tf32[0],
            "near_ties": n_ties}


# -- phases 13-15: the VAE epoch path, bf16, the codebook engines ----------

EPOCH_IMAGES = 600       # 3 batches of 256 padded to 768: padding rows fall
                         # in every batch the permutation sends them to
# one bf16 step against the CPU: the bf16 limits of tests/test_torch_bf16.py
# (3x the largest gap port vs flax over five seeds); the f32 step is the
# control and must sit 10x under them
VAE_BF16_LIMITS = {"loss": 3.6e-4, "grad": 3.7e-1, "grad_out_bias": 7.8e-1}
TF_BF16_LIMITS = {"loss": 6.3e-5, "grad": 9.4e-2}
ENGINE_SOURCES = 512     # sources of the shortest-path engines' comparison
HATCH_ROWS = 16_384      # rows of the kNN escape hatch's check (host kNN)


def _pre_norm_biases(model):
    from vqvae_tpu_torch.models import BatchNorm

    out = set()
    for name, mod in model.named_modules():
        if isinstance(mod, BatchNorm):
            parent, i = name.rsplit(".", 1)
            out.add(f"{parent}.{int(i) - 1}.bias")
    return out


def phase_vae_epoch(seed: int = 42, preset: str = PRESET,
                    dataset: str = "fashionmnist", label: str = "phase 13",
                    extras: bool = True, loss_limit: float = 1e-5):
    """One epoch of the VAE's device-resident path at ``preset``'s full
    width on the card against the CPU (same permutation and noise), the
    epoch's mean losses within ``loss_limit`` relative; then, with
    ``extras``, with a NaN pixel in a middle batch, and one 60,000-image
    epoch of the epoch path against the per-batch path."""
    import copy

    import numpy as np
    import torch

    from vqvae_tpu_torch.config import load_config
    from vqvae_tpu_torch.data import get_data_loaders, load_dataset
    from vqvae_tpu_torch.device import resolve_device
    from vqvae_tpu_torch.models import VAE, flax_init_
    from vqvae_tpu_torch.train import VAEEngine
    from vqvae_tpu_torch.train.vae_engine import seeded_generator

    cfg = load_config(ROOT / preset / "vae.yaml")
    arch = dict(cfg["model"])
    arch.pop("beta")
    bs, lr = int(cfg["data"]["batch_size"]), float(cfg["lr"])
    model = flax_init_(VAE(**arch), seeded_generator("cpu", seed))
    pre_norm = _pre_norm_biases(model)
    split = load_dataset(dataset, root="no-such-dir", train=True,
                         synthetic_size=EPOCH_IMAGES, seed=seed)
    n_steps = -(-EPOCH_IMAGES // bs)
    perm = torch.randperm(n_steps * bs,
                          generator=torch.Generator().manual_seed(seed))
    middle = perm[bs:2 * bs]
    if not (middle >= EPOCH_IMAGES).any():
        fail(f"{label}: the permutation put no padding row in the middle "
             "batch")

    def engine(dev):
        return VAEEngine(copy.deepcopy(model), lr=lr,
                         weight_decay=float(cfg["weight_decay"]),
                         grad_clip_max_norm=float(cfg["grad_clip_max_norm"]),
                         cosine_t_max=int(cfg["max_epochs"]),
                         steps_per_epoch=n_steps, seed=seed, device=dev)

    def epoch(dev, images, tf32=False, state=None):
        """(epoch means, eval sums, parameters, state dict); with ``state``
        only the evaluation runs, from those weights."""
        eng = engine(dev)
        loader = SimpleNamespace(split=SimpleNamespace(images=images))
        data, mask, steps, _ = eng.device_dataset(loader, bs)
        if tf32:  # the control: the engine has set full f32; undo it
            set_tf32()
        try:  # the same noise on both devices: a CPU generator
            tr = torch.zeros(3)
            if state is None:
                tr = eng.train_epoch(data, mask, perm.to(dev), 1.0, steps,
                                     bs, seeded_generator("cpu", seed, 1))
            else:
                eng.model.load_state_dict(state)
            va = eng.eval_epoch(data, mask, 1.0, steps, bs,
                                seeded_generator("cpu", seed, 2))
        finally:
            resolve_device(dev)
        return (tr.cpu().numpy(), va.cpu().numpy(),
                {k: p.detach().cpu() for k, p in
                 eng.model.named_parameters()},
                {k: v.detach().cpu() for k, v in
                 eng.model.state_dict().items()})

    def compare(label, got, ref, check_metrics=True):
        """The epoch check: its mean (loss, recon, kl) within
        ``loss_limit`` relative (unless ``check_metrics`` is off) and every parameter finite and
        within one Adam step a step (2 lr) of the CPU's. Phase 7's other
        rule, 99 % of the parameters within rtol 1e-4, holds for one step
        only (Adam's first step is lr * sign(g)); later steps divide the
        gradients' rounding residue by sqrt(v), so the share is logged."""
        tr_g, va_g, par_g, _ = got
        tr_c, va_c, par_c, _ = ref
        loss_gap = float(np.abs(tr_g - tr_c).max() / np.abs(tr_c).max())
        n_par = n_close = 0
        worst_lr = 0.0
        for key, p_c in par_c.items():
            if key in pre_norm:
                continue
            if not torch.isfinite(par_g[key]).all():
                fail(f"{label}: non-finite parameters in {key}")
            dp = (par_g[key] - p_c).abs()
            worst_lr = max(worst_lr, float(dp.max()) / lr)
            n_close += int((dp <= 1e-4 * p_c.abs() + 1e-7).sum())
            n_par += p_c.numel()
        ok = (worst_lr <= 2.0 * n_steps
              and (not check_metrics or loss_gap <= loss_limit))
        log(f"{label}: epoch (loss, recon, kl) gap {loss_gap:.3e} relative;"
            f" {n_close} of {n_par} parameters within rtol 1e-4, largest "
            f"move apart {worst_lr:.3f} lr ({n_steps} steps); eval sums card "
            f"{va_g.tolist()} CPU {va_c.tolist()}")
        return ok

    images = split.images
    cpu = epoch("cpu", images)
    card = epoch("cuda", images)
    tf32 = epoch("cuda", images, tf32=True)
    if compare(f"{label} TF32 control", tf32, cpu):
        fail(f"{label}: the TF32 control passes the epoch check")
    if not compare(f"{label} epoch card vs CPU", card, cpu):
        fail(f"{label}: the card's epoch differs from the CPU's")
    # evaluation from the CPU's post-epoch state on both devices: from
    # each device's own state the pre-norm conv biases, whose steps are
    # Adam's sign of rounding residue, shift eval-mode outputs (1e-4)
    same = epoch("cuda", images, state=cpu[3])[1]
    log(f"{label}: eval sums from the CPU's state, card {same.tolist()}")
    if not np.allclose(same, cpu[1], rtol=1e-5):
        fail(f"{label}: eval sums {same} (card) vs {cpu[1]} (CPU) from "
             f"one state")
    if not extras:
        return {}

    bad = images.copy()
    row = int(middle[middle < EPOCH_IMAGES][0])
    bad[row, 3, 5, 0] = np.nan
    cpu_nan = epoch("cpu", bad)
    card_nan = epoch("cuda", bad)
    if np.isfinite(cpu_nan[0][0]) or np.isfinite(card_nan[0][0]):
        fail("phase 13: the NaN batch left the epoch loss finite")
    # the loss mean carries the NaN step; parameters must not
    if not compare("phase 13 NaN batch card vs CPU", card_nan, cpu_nan,
                   check_metrics=False):
        fail("phase 13: after a NaN batch the card's parameters differ "
             "from the CPU's")

    # one 60,000-image epoch: the epoch path against the per-batch path
    tr_loader, _ = get_data_loaders("fashionmnist", root="no-such-dir",
                                    batch_size=bs, seed=seed)
    eng = engine("cuda")
    data, mask, steps, n_pad = eng.device_dataset(tr_loader, bs)
    gen = seeded_generator("cuda", seed, 3)
    eng.train_epoch(data, mask, torch.randperm(n_pad, device="cuda",
                                               generator=gen),
                    1.0, 4, bs, gen)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.train_epoch(data, mask, torch.randperm(
        n_pad, device="cuda", generator=gen), 1.0, steps, bs, gen)
    float(out[0])
    t_epoch = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng.run_epoch(tr_loader, True, 1, 1.0)
    t_batch = time.perf_counter() - t0
    log(f"phase 13: one {steps}-step epoch of 60,000 images: epoch path "
        f"{t_epoch:.3f}s ({steps / t_epoch:.2f} steps/s), per-batch path "
        f"{t_batch:.3f}s ({steps / t_batch:.2f} steps/s)")
    return {"epoch_s": t_epoch, "per_batch_s": t_batch, "steps": steps}


def phase_bf16(work: Path, exp: Path, f32_rates: dict, seed: int = 42):
    """``model.dtype: bfloat16``: the preset's train_vae and
    train_transformer for one epoch each (the transformer on phase 6's
    codes), then one bf16 step of each on the card against the CPU, with
    the f32 step as the control."""
    import json as _json

    import numpy as np
    import torch

    from vqvae_tpu_torch.cli import train_transformer_main, train_vae_main
    from vqvae_tpu_torch.config import load_config
    from vqvae_tpu_torch.data import load_dataset
    from vqvae_tpu_torch.models import VAE, flax_init_
    from vqvae_tpu_torch.models.transformer import (Transformer,
                                                    transformer_init_)
    from vqvae_tpu_torch.train import TransformerEngine, VAEEngine
    from vqvae_tpu_torch.train.vae_engine import seeded_generator

    vae_cfg = load_config(ROOT / PRESET / "vae.yaml", {
        "max_epochs": 1, "out_dir": str(work / "vae"),
        "data": {"root": str(work / "no-data")},
        "model": {"dtype": "bfloat16"}})
    vae_out = train_vae_main(vae_cfg, device="cuda")
    rows = [_json.loads(line) for line in
            (vae_out / "metrics.jsonl").read_text().splitlines()]
    if not (np.isfinite(rows[-1]["train_loss"])
            and np.isfinite(rows[-1]["val_loss"])):
        fail(f"bf16 VAE: losses {rows[-1]}")
    vae_rate = rows[-1]["train_steps"] / rows[-1]["train_seconds"]
    cut = str(work.parent / "pipeline" / f"latents_train_{CODEBOOK_IMAGES}")
    # (phase 6's cut of the training latents: the codes' labels)
    tf_cfg = load_config(ROOT / PRESET / "transformer.yaml", {
        "data": {"codes_path": str(exp / "codebook" / "codes.npy"),
                 "labels_path": cut},
        "training": {"epochs": 1}, "out": {"dir": str(work / "tf")},
        "model": {"dtype": "bfloat16"}})
    tf_out = train_transformer_main(tf_cfg, device="cuda")
    tf_rows = [_json.loads(line) for line in
               (tf_out / "metrics.jsonl").read_text().splitlines()]
    if not (np.isfinite(tf_rows[-1]["train_loss"])
            and np.isfinite(tf_rows[-1]["val_loss"])):
        fail(f"bf16 transformer: losses {tf_rows[-1]}")
    tf_rate = tf_rows[-1]["train_steps"] / tf_rows[-1]["train_seconds"]
    log(f"bf16: vae 1 epoch {rows[-1]['train_steps']} steps, "
        f"{vae_rate:.2f} steps/s (f32 in phase 6: "
        f"{', '.join(f'{r:.2f}' for r in f32_rates['vae'])}), train loss "
        f"{rows[-1]['train_loss']:.4f}, val loss {rows[-1]['val_loss']:.4f}; "
        f"transformer 1 epoch {tf_rows[-1]['train_steps']} steps, "
        f"{tf_rate:.2f} steps/s (f32 in phase 6: "
        f"{', '.join(f'{r:.2f}' for r in f32_rates['transformer'])}), "
        f"loss {tf_rows[-1]['train_loss']:.4f}")

    # one step of each model, card against CPU, bf16 and f32
    cfg = load_config(ROOT / PRESET / "vae.yaml")
    arch = dict(cfg["model"])
    arch.pop("beta")
    base = flax_init_(VAE(**arch), seeded_generator("cpu", seed))
    pre_norm = _pre_norm_biases(base)
    out_bias = "decoder.deconv_layers.6.bias"
    split = load_dataset("fashionmnist", root="no-such-dir", train=True,
                         synthetic_size=256, seed=seed)
    images = torch.from_numpy(split.images)
    mask = torch.ones(images.shape[0])
    mask[-16:], images[-16:] = 0.0, 0.0

    def vae_step(dev, dtype):
        m = VAE(**arch, dtype=dtype)
        m.load_state_dict(base.state_dict())
        eng = VAEEngine(m, lr=float(cfg["lr"]), seed=seed, device=dev)
        out = eng.train_step(images.to(dev), mask.to(dev), 1.0,
                             seeded_generator("cpu", seed, 1))
        return float(out["loss"]), {k: p.grad.detach().float().cpu()
                                    for k, p in m.named_parameters()}

    tcfg = load_config(ROOT / PRESET / "transformer.yaml")
    tarch = {**dict(tcfg["model"]), "dropout": 0.0}
    tbase = transformer_init_(Transformer(**tarch),
                              seeded_generator("cpu", seed))
    tbs, seq = int(tcfg["data"]["batch_size"]), tarch["max_seq_len"]
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(0, tarch["num_tokens"], (tbs, seq - 1), generator=g)
    t = torch.randint(0, tarch["num_tokens"], (tbs, seq - 1), generator=g)
    lab = torch.randint(0, tarch["num_classes"], (tbs,), generator=g)
    tmask = torch.ones(tbs)
    tmask[-16:] = 0.0

    def tf_step(dev, dtype):
        m = Transformer(**tarch, dtype=dtype)
        m.load_state_dict(tbase.state_dict())
        eng = TransformerEngine(m, lr=3e-4, label_smoothing=0.1, seed=seed,
                                device=dev)
        loss = eng.train_step(x.to(dev), t.to(dev), lab.to(dev),
                              tmask.to(dev), None)
        return float(loss), {k: p.grad.detach().cpu()
                             for k, p in m.named_parameters()}

    def gaps(step, skip):
        res = {}
        for dtype in ("bfloat16", "float32"):
            loss_g, grad_g = step("cuda", dtype)
            loss_c, grad_c = step("cpu", dtype)
            rel = {k: float((grad_g[k] - g_c).norm() / g_c.norm())
                   for k, g_c in grad_c.items() if not skip(k)}
            res[dtype] = {"loss": abs(loss_g - loss_c) / abs(loss_c),
                          "grad": max(rel.values()),
                          "worst": max(rel, key=rel.get), "rel": rel}
        return res

    vae = gaps(vae_step, lambda k: k in pre_norm)
    tf = gaps(tf_step, lambda k: k.endswith("attn.key.bias"))
    for name, res, limits in (("VAE", vae, VAE_BF16_LIMITS),
                              ("transformer", tf, TF_BF16_LIMITS)):
        for dtype, scale in (("bfloat16", 1.0), ("float32", 0.1)):
            r = res[dtype]
            grad = max(v for k, v in r["rel"].items() if k != out_bias)
            log(f"bf16 step check, {name} {dtype} card vs CPU: loss "
                f"{r['loss']:.3e} relative, largest gradient gap "
                f"{r['grad']:.3e} of its norm ({r['worst']}); limits x "
                f"{scale}: loss {limits['loss'] * scale:.3e}, gradient "
                f"{limits['grad'] * scale:.3e}")
            if r["loss"] > limits["loss"] * scale or \
                    grad > limits["grad"] * scale:
                fail(f"bf16 step check: {name} {dtype} card vs CPU outside "
                     f"{scale} x the bf16 limit")
            if out_bias in r["rel"] and r["rel"][out_bias] > \
                    limits["grad_out_bias"] * scale:
                fail(f"bf16 step check: {name} {dtype} output bias gradient "
                     f"gap {r['rel'][out_bias]:.3e}")
    return {"vae_steps_per_s": vae_rate, "tf_steps_per_s": tf_rate}


# an edge's two engines may gate a ReLU differently where its input lies
# within f32 rounding of 0: within this share of the unit's summed
# absolute terms (f64). Every edge past the nodal-vs-mlp tolerance must
# have such an endpoint (on an H100 each such edge read under 3e-8; 0.9 %
# of all edges have an endpoint under this bound)
KINK_RATIO = 1e-6


def relu_kink_ratio(model, z):
    """(N,) per latent cell: the least |ReLU input| of the spatial
    decoder over the unit's summed absolute terms (the forward error
    bound's magnitude, propagated layer by layer), in f64 on the card."""
    import torch
    import torch.nn.functional as F

    dec = model.decoder
    layers = list(dec.deconv_layers)
    with torch.no_grad():
        h = torch.from_numpy(z).cuda().double()[:, :, None, None]
        mag = h.abs()
        w, b = dec.conv_in.weight.double(), dec.conv_in.bias.double()
        h, mag = F.conv2d(h, w, b), F.conv2d(mag, w.abs(), b.abs())
        least = torch.full((len(z),), float("inf"), dtype=torch.float64,
                           device=h.device)
        for i in range((len(layers) - 1) // 3):
            ct, norm = layers[3 * i], layers[3 * i + 1]
            w, b = ct.weight.double(), ct.bias.double()
            kw = dict(stride=ct.stride, padding=ct.padding,
                      output_padding=ct.output_padding)
            h = F.conv_transpose2d(h, w, b, **kw)
            mag = F.conv_transpose2d(mag, w.abs(), b.abs(), **kw)
            if isinstance(norm, torch.nn.BatchNorm2d):  # eval: running stats
                scale = (norm.weight.double() / torch.sqrt(
                    norm.running_var.double() + norm.eps))[None, :, None, None]
                mean = norm.running_mean.double()[None, :, None, None]
                shift = norm.bias.double()[None, :, None, None]
                h = (h - mean) * scale + shift
                mag = mag * scale.abs() + (mean * scale).abs() + shift.abs()
            ratio = h.abs() / mag.clamp_min(1e-300)
            least = torch.minimum(least, ratio.flatten(1).min(1).values)
            h = torch.relu(h)
    return least.cpu().numpy()


def phase_engines(exp: Path, cut: Path, seed: int = 0):
    """The codebook stage's other engines on phase 6's 65,536-node
    geodesic graph (its LCC) and its latents ``cut``, card against card
    and host."""
    import numpy as np
    import torch
    from scipy import sparse

    from vqvae_tpu_torch import native
    from vqvae_tpu_torch.ops.connected import CC_STATS
    from vqvae_tpu_torch.ops import (EdgeList, connected_components_device,
                                     edge_lengths_riemannian_auto,
                                     fit_kmedoids, geo_compat, knn_search,
                                     largest_connected_component,
                                     multi_source_shortest_paths)
    from vqvae_tpu_torch.ops.ell import (ELL_STATS, BucketedGraph,
                                         multi_source_shortest_paths_ell)
    from vqvae_tpu_torch.ops.riemannian import make_decoder_image_fn
    from vqvae_tpu_torch.utils.checkpoint import load_vae_from_checkpoint
    from vqvae_tpu_torch.utils.latents import load_latents

    W = sparse.load_npz(exp / "codebook" / "knn_graph_geodesic.npz").tocsr()
    n_all = W.shape[0]
    t0 = time.perf_counter()
    labels = connected_components_device(W, device="cuda")
    t_cc = time.perf_counter() - t0
    mask = largest_connected_component(W)
    sizes = np.bincount(labels)
    if not np.array_equal(labels == np.argmax(sizes), mask):
        fail("connected_components_device: the LCC differs from the host's")
    Wl = W[mask][:, mask].tocsr()
    n = Wl.shape[0]
    rng = np.random.default_rng(seed)
    src = np.sort(rng.choice(n, ENGINE_SOURCES, replace=False))
    timings = {"components": t_cc}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    el = EdgeList.from_csr(Wl, device="cuda")
    (d_bf, it_bf), timings["bellman_ford"] = timed(
        lambda: multi_source_shortest_paths(el, src, return_iters=True))
    g = BucketedGraph.from_csr(Wl, device="cuda")
    (d_ell, it_ell), timings["ell"] = timed(
        lambda: multi_source_shortest_paths_ell(g, src, return_iters=True))
    rec_off = ELL_STATS[-1]
    (d_act, it_act), timings["ell_active"] = timed(
        lambda: multi_source_shortest_paths_ell(g, src, active=True,
                                                return_iters=True))
    rec_act = ELL_STATS[-1]
    t0 = time.perf_counter()
    d_host = native.dijkstra_multi_source(Wl, src.astype(np.int32)).T
    timings["host_dijkstra"] = time.perf_counter() - t0
    d_bf, d_ell, d_act = (d.cpu().numpy() for d in (d_bf, d_ell, d_act))
    for name, d in (("edge-list Bellman-Ford", d_bf), ("ELL active", d_act),
                    ("host Dijkstra", d_host)):
        if not np.array_equal(d, d_ell):
            fail(f"{name} distances differ from the ELL engine's")
    if it_act != it_ell:
        fail(f"ELL active: {it_act} sweeps, {it_ell} without")
    e_dir, k = int(el.src.shape[0]), ENGINE_SOURCES
    cc = CC_STATS[-1]
    # bytes a sweep moves: Bellman-Ford reads src, dst (8 B each) and w
    # (4 B) per edge, gathers d[src] (4K B), writes and re-reads the
    # contributions (8K B) for the scatter-min, and clones and compares d
    # (12 N K B); label propagation gathers and scatters 8-byte labels by
    # 8-byte indices over both directions (32 B an edge) plus ~6 N-long
    # passes of 8 B (the minimum, two jumps, the compare)
    bf_bytes = it_bf * (e_dir * (20 + 12 * k) + 12 * n * k)
    cc_bytes = cc["sweeps"] * (cc["edges"] * 32 + cc["nodes"] * 48)
    log(f"engines on the {n}-node LCC of {n_all} ({Wl.nnz} stored edges, "
        f"{k} sources): identical distances; Bellman-Ford "
        f"{timings['bellman_ford']:.3f}s in {it_bf} sweeps over {e_dir} "
        f"padded directed edges ({bf_bytes / 1e9:.2f} GB); "
        f"ELL {timings['ell']:.3f}s in {it_ell} "
        f"sweeps ({rec_off['bytes'] / 1e9:.2f} GB); ELL active "
        f"{timings['ell_active']:.3f}s, {it_act} sweeps, active_frac "
        f"{rec_act['active_frac']:.4f} ({rec_act['chunk_relaxed']} of "
        f"{rec_act['chunk_visits']} chunks, {rec_act['bytes'] / 1e9:.2f} "
        f"GB); host Dijkstra {timings['host_dijkstra']:.3f}s; device "
        f"components {t_cc:.3f}s in {cc['sweeps']} sweeps "
        f"({cc_bytes / 1e9:.3f} GB; labels equal the host's LCC)")

    t0 = time.perf_counter()
    m_el, a_el, q_el = fit_kmedoids(el, K=512, init="kpp_parallel", seed=42)
    timings["kmedoids_edge_list"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    m_csr, a_csr, q_csr = fit_kmedoids(Wl, K=512, init="kpp_parallel",
                                       seed=42, backend="device",
                                       reorder=False, device="cuda")
    timings["kmedoids_csr"] = time.perf_counter() - t0
    if not (np.array_equal(m_el, m_csr) and np.array_equal(a_el, a_csr)
            and q_el == q_csr):
        fail(f"fit_kmedoids: the EdgeList run differs from the CSR run "
             f"(QE {q_el} vs {q_csr})")
    log(f"fit_kmedoids K=512 kpp_parallel: EdgeList "
        f"{timings['kmedoids_edge_list']:.3f}s, CSR (ELL) "
        f"{timings['kmedoids_csr']:.3f}s; identical medoids, assignments "
        f"and QE {q_el}")

    # 100 predecessor paths re-summed to their distances
    d_p, pred = geo_compat.dijkstra_multi_source(Wl, src[:1],
                                                 return_predecessors=True)
    targets = rng.choice(np.nonzero(np.isfinite(d_p[0]))[0], 100,
                         replace=False)
    worst = 0.0
    for v in targets:
        path = [int(v)]
        while pred[0, path[-1]] != -9999:
            path.append(int(pred[0, path[-1]]))
        if path[-1] != src[0]:
            fail(f"predecessor path of {v} ends at {path[-1]}")
        total = np.float32(0.0)
        for a, b in zip(path[::-1][:-1], path[::-1][1:]):
            total = np.float32(total + np.float32(Wl[a, b]))
        worst = max(worst, abs(float(total) - float(d_p[0, v])))
    if worst != 0.0:
        fail(f"predecessor paths re-sum to their distances within {worst}")
    log("geo_compat: 100 predecessor paths re-sum exactly to their "
        "distances")

    # nodal lengths against the mlp engine's over every edge
    model = load_vae_from_checkpoint(
        next(exp.glob("vae/*/checkpoints/best.pt")), None, "cuda")
    decode_fn = make_decoder_image_fn(model, "spatial")
    z = load_latents(cut)["z"].reshape(-1, D)
    rows, cols = sparse.triu(W, k=1).nonzero()
    (mlp, timings["lengths_mlp"]) = timed(
        lambda: edge_lengths_riemannian_auto(decode_fn, z, rows, cols,
                                             engine="mlp", device="cuda"))
    (nodal, timings["lengths_nodal"]) = timed(
        lambda: edge_lengths_riemannian_auto(decode_fn, z, rows, cols,
                                             engine="nodal", device="cuda"))
    # the mlp engine's probed affine segments sum a unit's pre-activation
    # in another order than the conv decoder: where it sits within
    # rounding of a ReLU kink the two gate it differently (as in phase 5).
    # Each edge past the bound must show such a unit at an endpoint
    bad = ~np.isclose(nodal, mlp, rtol=1e-3, atol=1e-5)
    rel = np.abs(nodal - mlp) / np.maximum(np.abs(mlp), 1e-30)
    kink = relu_kink_ratio(model, z)
    edge_kink = np.minimum(kink[rows], kink[cols])
    unexplained = int((bad & (edge_kink > KINK_RATIO)).sum())
    # the nodal engine's metric table (N D^2 f32) written once and
    # gathered at both ends of every edge
    nodal_bytes = 4 * D * D * (z.shape[0] + 2 * len(rows))
    log(f"Riemannian lengths of {len(rows)} edges: mlp "
        f"{timings['lengths_mlp']:.3f}s, nodal {timings['lengths_nodal']:.3f}"
        f"s ({z.shape[0] * D} decoder JVP rows, {nodal_bytes / 1e9:.2f} GB "
        f"of metrics); nodal vs mlp median rel "
        f"{float(np.median(rel)):.3e}, max {float(rel.max()):.3e}, "
        f"{int(bad.sum())} past rtol 1e-3 atol 1e-5, each with a ReLU input "
        f"within {KINK_RATIO} of its terms of 0 at an endpoint but "
        f"{unexplained} (largest such ratio among them "
        f"{float(edge_kink[bad].max()) if bad.any() else 0.0:.2e}; "
        f"{float((edge_kink <= KINK_RATIO).mean()):.4f} of all edges have "
        f"one)")
    if unexplained:
        fail(f"nodal lengths differ from the mlp engine's beyond rtol 1e-3, "
             f"atol 1e-5 on {unexplained} edges with no ReLU input within "
             f"rounding of its kink")

    # the kNN escape hatch, forced under the row count
    zs = z[:HATCH_ROWS]
    t0 = time.perf_counter()
    d_h, i_h = knn_search(zs, 21, device="cuda", device_max=HATCH_ROWS - 1)
    timings["knn_native"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    d_d, i_d = knn_search(zs, 21, device="cuda")
    timings["knn_device"] = time.perf_counter() - t0
    differ = np.nonzero((np.sort(i_h, 1) != np.sort(i_d, 1)).any(1))[0]
    ties = 0
    for r in differ:  # a near-tie: the k-th distances agree within 1e-5
        if abs(d_h[r, -1] - d_d[r, -1]) > 1e-5 * max(d_d[r, -1], 1e-30):
            fail(f"kNN escape hatch: row {r} differs beyond a near-tie")
        ties += 1
    log(f"kNN escape hatch on {HATCH_ROWS} rows, k=21: native host "
        f"{timings['knn_native']:.3f}s, device route "
        f"{timings['knn_device']:.3f}s; {ties} rows differ at near-ties")
    return timings


# -- phase 16: k-means, IVF, the demos, per-stage traces, the crossover ----

IVF_K = 20               # the codebook stage's k
KMEANS_K = 512
CROSSOVER_SOURCES = (8, 32, 128, 512)
# a smaller graph, where the crossover falls inside the grid: the k = 10
# union kNN graph of the cut's first 16,384 cells
SMALL_GRAPH_ROWS = 16_384
SMALL_GRAPH_SOURCES = (1, 2, 4, 8, 16, 32, 64)
CROSSOVER_THREADS = (1, 2, 4)  # and the host's own count
# a near-tie of the fast form |z|^2 - 2 z.c + |c|^2: two values within this
# share of the terms it cancels (|z|^2 + |c|^2), the size of f32 rounding
# in products summed in another order
FAST_FORM_TIE = 1e-5


def _fast_form_gap(z, centers, got, want):
    """(rows, gap): the rows where two choices of centres differ, and the
    largest gap between a differing pair's exact (f64) squared distances
    as a share of the terms the fast form cancels (|z|^2 + |c|^2).
    ``got`` and ``want`` are (N,) or (N, c)."""
    import numpy as np

    got = got.reshape(len(z), -1)
    want = want.reshape(len(z), -1)
    rows, cols = np.nonzero(got != want)
    if not rows.size:
        return 0, 0.0
    zr = z[rows].astype(np.float64)
    ca = centers[got[rows, cols]].astype(np.float64)
    cb = centers[want[rows, cols]].astype(np.float64)
    a = ((zr - ca) ** 2).sum(1)
    b = ((zr - cb) ** 2).sum(1)
    scale = (zr * zr).sum(1) + np.maximum((ca * ca).sum(1), (cb * cb).sum(1))
    return int(np.unique(rows).size), float((np.abs(a - b) / scale).max())


def _near_ties(z, centers, got, want, name: str) -> int:
    """Rows where two choices of centres differ; fails unless every
    differing pair is a near-tie of the fast form (``FAST_FORM_TIE``)."""
    rows, gap = _fast_form_gap(z, centers, got, want)
    if gap > FAST_FORM_TIE:
        fail(f"{name}: {rows} rows differ, one beyond a near-tie (gap "
             f"{gap:.3e} of the cancelled terms > {FAST_FORM_TIE})")
    return rows


def _lloyd_step(z, centers0, name: str, tf32_control: bool = False):
    """One Lloyd step (assignment, update) on the card against the CPU
    from the same centres: labels equal except at near-ties, each centre
    no differing row touched within 1e-5 of its norm (a mean of hundreds
    of rows, summed in another order on the card). With ``tf32_control`` the
    card's step runs again with TF32 products; returns (rows, centre gap,
    the control's rows and gap)."""
    import numpy as np
    import torch

    from vqvae_tpu_torch.device import resolve_device
    from vqvae_tpu_torch.ops import kmeans_euclidean as km

    def step(dev):
        zt = torch.from_numpy(z).to(dev)
        c0 = torch.from_numpy(centers0).to(dev)
        labels, _ = km.assign_fast_form(zt, (zt * zt).sum(1), c0)
        return (labels.cpu().numpy(),
                km.lloyd_update(zt, labels, c0).cpu().numpy())

    l_c, c_c = step("cpu")
    l_g, c_g = step("cuda")
    rows = _near_ties(z, centers0, l_g, l_c, name)
    moved = np.union1d(l_g[l_g != l_c], l_c[l_g != l_c])
    keep = np.setdiff1d(np.arange(len(centers0)), moved)
    gap = float((np.linalg.norm(c_g[keep] - c_c[keep], axis=1)
                 / np.maximum(np.linalg.norm(c_c[keep], axis=1),
                              1e-30)).max())
    if gap > 1e-5:
        fail(f"{name}: centres differ by {gap:.3e} relative")
    control = None
    if tf32_control:
        set_tf32()
        try:
            l_t, _ = step("cuda")
        finally:
            resolve_device("cuda")  # full f32 again
        control = _fast_form_gap(z, centers0, l_t, l_c)
    return rows, gap, control


def _same_distances(d_a, d_b, i_a, i_b, name: str) -> int:
    """Rows whose index lists differ; fails unless their sorted distances
    agree within rtol 1e-5 (the swapped candidates tie)."""
    import numpy as np

    rows = np.nonzero((i_a != i_b).any(-1))[0]
    if rows.size and not np.allclose(d_a[rows], d_b[rows], rtol=1e-5,
                                     atol=0.0):
        fail(f"{name}: {rows.size} rows differ beyond near-ties")
    return int(rows.size)


def _exact_distance_gap(z, d, i) -> float:
    """Largest relative gap between the returned distances and the exact
    f32 distances of the returned indices, on the card."""
    import torch

    zt = torch.from_numpy(z).cuda()
    worst = 0.0
    for s in range(0, len(z), 65536):
        it = torch.from_numpy(i[s:s + 65536]).cuda()
        dt = torch.from_numpy(d[s:s + 65536]).cuda()
        diff = zt[s:s + 65536, None, :] - zt[it]
        exact = torch.sqrt((diff * diff).sum(-1))
        gap = (dt - exact).abs() / exact.clamp_min(1e-30)
        gap = torch.where((dt - exact).abs() == 0, 0.0, gap)
        worst = max(worst, float(gap.max()))
    return worst


def phase_ivf(exact_i, knn_s: float, k1_ms: float) -> dict:
    """16a: IVF at the codebook main run's shape, recall against phase 3's
    exact indices."""
    import numpy as np

    from vqvae_tpu_torch.ops import knn_search_ivf

    z = make_latents(N_NODES, D, seed=0)
    stats = {}
    t0 = time.perf_counter()
    d, i = knn_search_ivf(z, IVF_K, device="cuda", stats=stats)
    secs = time.perf_counter() - t0
    if not (((i >= 0) & (i < N_NODES)).all() and np.isfinite(d).all()):
        fail("IVF: a row is unanswered (index out of range or inf)")
    self_first = float((i[:, 0] == np.arange(N_NODES)).mean())
    if self_first < 0.999:
        fail(f"IVF: the row itself first on only {self_first:.5f} of rows")
    if (np.diff(d, axis=1) < 0).any():
        fail("IVF: distances not sorted")
    gap = _exact_distance_gap(z, d, i)
    if gap > 1e-5:
        fail(f"IVF: returned distances differ from the exact f32 distance "
             f"by {gap:.3e} relative (limit 1e-5)")
    want = exact_i[:, :IVF_K]
    recall = float(np.mean([len(set(i[r]) & set(want[r])) / IVF_K
                            for r in range(len(want))]))
    cand = stats["P"] * stats["cap"]
    log(f"16a IVF on {N_NODES} rows, k={IVF_K}: {secs:.3f}s (C "
        f"{stats['C']}, P {stats['P']}, cap {stats['cap']}, k_sel "
        f"{stats['k_sel']}; {cand} candidates a query, {N_NODES / cand:.1f}x"
        f" fewer than the brute route); steps "
        + ", ".join(f"{k} {stats[k]:.3f}s" for k in (
            "lloyd", "top4", "balance", "layout", "probe_table", "search",
            "scatter"))
        + f"; recall@{IVF_K} {recall:.4f} on phase 3's {len(want)} exact "
        f"rows; self first {self_first:.6f}; max distance gap {gap:.2e}; "
        f"beside phase 4's kNN step {knn_s:.3f}s and K1 {k1_ms:.3f} ms a "
        f"{Q_ROWS}-row call")
    return {"seconds": secs, "recall": recall, **stats}


def phase_ivf_reference(z) -> dict:
    """16b: IVF on the card against the CPU on phase 6's 65,536 cells,
    step by step from the CPU's state, then end to end."""
    import numpy as np
    import torch

    from vqvae_tpu_torch.ops import ivf, knn_search, knn_search_ivf

    n = len(z)
    st_g, st_c = {}, {}
    t0 = time.perf_counter()
    _, i_g = knn_search_ivf(z, IVF_K, device="cuda", stats=st_g)
    t_g = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, i_c = knn_search_ivf(z, IVF_K, device="cpu", stats=st_c)
    t_c = time.perf_counter() - t0
    C, P, cap, k_sel = (st_c[k] for k in ("C", "P", "cap", "k_sel"))

    # step by step, each from the CPU's state carried across
    zc = torch.from_numpy(z)
    zg = zc.cuda()
    rng = np.random.default_rng(0)
    init = z[rng.choice(n, size=C, replace=False)]
    lloyd_rows, lloyd_gap, _ = _lloyd_step(z, init, "IVF Lloyd step")
    centers = ivf._lloyd_sample(zc, torch.from_numpy(init), 10)
    ch_c = ivf._assign_topc(zc, centers, 65536, 4).numpy()
    ch_g = ivf._assign_topc(zg, centers.cuda(), 65536, 4).cpu().numpy()
    top4_rows = _near_ties(z, centers.numpy(), ch_g, ch_c, "IVF top-4")
    labels = ivf._balance_buckets(ch_c, C, cap)
    ids = ivf._bucket_ids(labels, C, cap)
    probe = torch.from_numpy(ivf._probe_table(centers.numpy(), labels, ch_c,
                                              P)).long()
    bz = zc[torch.from_numpy(np.maximum(ids, 0)).long()]
    ids_t = torch.from_numpy(ids)
    sd_c, si_c = ivf._ivf_search(bz, ids_t, probe, IVF_K, k_sel)
    sd_g, si_g = ivf._ivf_search(bz.cuda(), ids_t.cuda(), probe.cuda(),
                                 IVF_K, k_sel)
    valid = ids.reshape(-1) >= 0
    search_rows = _same_distances(
        sd_g.cpu().numpy().reshape(-1, IVF_K)[valid],
        sd_c.numpy().reshape(-1, IVF_K)[valid],
        si_g.cpu().numpy().reshape(-1, IVF_K)[valid],
        si_c.numpy().reshape(-1, IVF_K)[valid], "IVF search")

    # end to end: reported, not gated (a near-tie in the coarse Lloyd moves
    # a centroid, and the balancing then moves rows between buckets)
    _, exact = knn_search(z, IVF_K, device="cuda")
    rec = [float(np.mean([len(set(a[r]) & set(exact[r])) / IVF_K
                          for r in range(0, n, 7)])) for a in (i_g, i_c)]
    e2e_rows = int((i_g != i_c).any(1).sum())
    log(f"16b IVF card vs CPU on {n} rows (C {C}, P {P}, cap {cap}): card "
        f"{t_g:.3f}s, CPU {t_c:.3f}s; one Lloyd step from the same centres: "
        f"{lloyd_rows} labels differ (near-ties), the other centres within "
        f"{lloyd_gap:.2e}; top-4 from the CPU's centres: "
        f"{top4_rows} rows differ, all near-ties (within {FAST_FORM_TIE} of "
        f"the fast form's cancelled terms); search from the CPU's layout and"
        f" probe table: {search_rows} rows differ, all with equal distances "
        f"(rtol 1e-5); end to end {e2e_rows} rows differ, recall@{IVF_K} "
        f"card {rec[0]:.4f}, CPU {rec[1]:.4f}")
    return {"card_s": t_g, "cpu_s": t_c, "recall": rec}


def phase_kmeans_reference(z) -> dict:
    """16c: ``fit_kmeans`` K = 512 on the card against the CPU, one step
    from the same centres (with a TF32 control), then whole fits."""
    import torch

    from vqvae_tpu_torch.ops import fit_kmeans
    from vqvae_tpu_torch.ops import kmeans_euclidean as km

    t0 = time.perf_counter()
    init = km.kmeans_plus_plus_init(z, KMEANS_K, 42)
    t_init = time.perf_counter() - t0
    rows, step_gap, (t32_rows, t32_gap) = _lloyd_step(
        z, init, "k-means step", tf32_control=True)
    log(f"16c k-means TF32 control: {t32_rows} labels differ from the CPU's,"
        f" largest gap {t32_gap:.3e} of the cancelled terms (limit "
        f"{FAST_FORM_TIE}): the check "
        f"{'rejects' if t32_gap > FAST_FORM_TIE else 'DOES NOT reject'} "
        f"TF32")

    t0 = time.perf_counter()
    c_fg, l_fg, i_fg = fit_kmeans(z, KMEANS_K, seed=42, device="cuda")
    t_g = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, l_fc, i_fc = fit_kmeans(z, KMEANS_K, seed=42, device="cpu")
    t_c = time.perf_counter() - t0
    # the card's end state, assigned again on the CPU: the same labels but
    # for near-ties, the same inertia within rounding
    zt = torch.from_numpy(z)
    l_end, i_end = km._assign(zt, (zt * zt).sum(1), torch.from_numpy(c_fg))
    end_rows = _near_ties(z, c_fg, l_fg, l_end.numpy(), "k-means end state")
    end_rel = abs(i_fg - float(i_end)) / abs(float(i_end))
    # whole fits part after a near-tie taken the other way (the labels
    # then differ by thousands), so their inertias agree only as two
    # trajectories of one algorithm do
    i_rel = abs(i_fg - i_fc) / abs(i_fc)
    log(f"16c fit_kmeans K={KMEANS_K} on {len(z)} cells, 100 iterations: "
        f"card {t_g:.3f}s, CPU {t_c:.3f}s (each with the host's k-means++ "
        f"init, {t_init:.3f}s); one step from the same centres: "
        f"{rows} labels differ, all near-ties, untouched centres within "
        f"{step_gap:.2e}; the card's end state on the CPU: {end_rows} labels"
        f" differ (near-ties), inertia within {end_rel:.2e} (limit 1e-5); "
        f"whole fits: {int((l_fg != l_fc).sum())} labels differ, inertia "
        f"{i_fg} vs {i_fc} (rel {i_rel:.2e}, limit 1e-3)")
    if end_rel > 1e-5:
        fail(f"fit_kmeans: the card's inertia {i_fg} vs {float(i_end)} from "
             f"its own centres on the CPU")
    if i_rel > 1e-3:
        fail(f"fit_kmeans: inertia {i_fg} (card) vs {i_fc} (CPU)")
    return {"card_s": t_g, "cpu_s": t_c, "init_s": t_init,
            "inertia_rel": i_rel}


def _finite(name: str, values) -> None:
    import numpy as np

    arr = np.asarray(values, np.float64)
    if not np.isfinite(arr).all():
        fail(f"{name}: non-finite values {values}")


def phase_demos(exp: Path) -> dict:
    """16d: the demos and experiments' ``run`` on phase 6's experiment.
    Returns their seconds and K3's launches in the sampling demo."""
    import json as _json

    import numpy as np

    from vqvae_tpu_torch.demos import (codebook_comparison,
                                       codebook_sampling,
                                       interactive_exploration,
                                       kmedoids_geodesic_analysis)
    from vqvae_tpu_torch.experiments_geo import (riemann_sanity_check,
                                                 run_riemann_experiments)

    secs = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        secs[name] = time.perf_counter() - t0
        return out

    cmp_ = timed("codebook_comparison", lambda: codebook_comparison.run(
        exp, K=KMEANS_K, max_points=65536, device="cuda"))
    saved = _json.loads((exp / "demo_codebook_comparison.json").read_text())
    _finite("codebook_comparison", [
        saved["euclidean"]["inertia"], saved["euclidean"]["recon_mse"],
        saved["euclidean"]["perplexity"], saved["geodesic"]["qe"],
        saved["geodesic"]["recon_mse"], saved["geodesic"]["perplexity"]])
    zero_launches()
    samp = timed("codebook_sampling",
                 lambda: codebook_sampling.run(exp, device="cuda"))
    k3 = read_launches()["K3"]
    if k3 <= 0:
        fail("codebook_sampling launched no K3 kernel")
    if not Path(samp["png"]).stat().st_size:
        fail("codebook_sampling wrote no grid")
    _finite("codebook_sampling", [samp["pixel_mse"]])
    rows = timed("kmedoids_geodesic_analysis",
                 lambda: kmedoids_geodesic_analysis.run(exp, device="cuda"))
    saved = _json.loads((exp / "demo_kmedoids_analysis.json").read_text())
    _finite("kmedoids_geodesic_analysis",
            [[r[k] for k in ("qe", "purity", "nmi", "ari", "perplexity")]
             for r in saved])
    riem = timed("run_riemann_experiments",
                 lambda: run_riemann_experiments.run(exp, device="cuda"))
    saved = _json.loads((exp / "riemann_graph_effect.json").read_text())
    _finite("run_riemann_experiments", [
        saved[k] for k in ("mean_sp_euclidean", "mean_sp_riemannian",
                           "path_dilation_ratio", "path_dilation_ratio_raw")])
    san = timed("riemann_sanity_check",
                lambda: riemann_sanity_check.run(device="cuda"))
    _finite("riemann_sanity_check", [san["corr"], san["ratio_mean"],
                                     san["ratio_std"]])
    if not san["ok"]:
        fail("riemann_sanity_check: the metric looks degenerate")
    inter = timed("interactive_exploration",
                  lambda: interactive_exploration.run(device="cuda"))
    dist = inter["distances"]
    if not (np.isfinite(dist).any(0).all() and (dist[dist < np.inf] >= 0)
            .all()):
        fail("interactive_exploration: no finite distances from a probe")
    log(f"16d demos (seconds: "
        + ", ".join(f"{k} {v:.3f}" for k, v in secs.items())
        + f"): codebook_comparison K={KMEANS_K} on {cmp_['n_points']} cells:"
        f" Euclidean recon MSE {cmp_['euclidean']['recon_mse']:.6f}, "
        f"perplexity {cmp_['euclidean']['perplexity']:.2f}; geodesic recon "
        f"MSE {cmp_['geodesic']['recon_mse']:.6f}, perplexity "
        f"{cmp_['geodesic']['perplexity']:.2f} (LCC "
        f"{cmp_['geodesic']['lcc_nodes']}); sampling pixel MSE "
        f"{samp['pixel_mse']:.6f}, K3 launches {k3}; K sweep QE "
        + ", ".join(f"{r['K']}: {r['qe']:.1f}" for r in rows)
        + f"; dilation R {riem['path_dilation_ratio']:.4f} (raw "
        f"{riem['path_dilation_ratio_raw']:.4f}); sanity corr "
        f"{san['corr']:.4f}")
    return {"seconds": secs, "k3_launches": k3}


def _busy_share(trace: Path, wall_s: float) -> float:
    """The union of CUDA kernel intervals in a Chrome trace over
    ``wall_s``."""
    import json as _json

    events = _json.loads(trace.read_text())["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                   if e.get("cat") == "kernel")
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e6 / wall_s


def phase_stage_traces(work: Path, exp: Path) -> dict:
    """16e: phase 6's preset again from the quality stage on (the
    transformer for one epoch), each stage traced; each stage's busy
    share."""
    import json as _json
    import os

    from vqvae_tpu_torch.cli import run_pipeline

    prof = work / "profile"
    timings_path = work / "timings_traced.json"
    for f in (exp / "evaluation" / "codebook_health.json",
              exp / "evaluation" / "metrics.yaml"):
        f.unlink()
    overrides = pipeline_overrides(work)
    overrides["transformer"]["training"]["epochs"] = 1
    os.environ["VQVAE_TPU_PROFILE_DIR"] = str(prof)
    os.environ["VQVAE_TPU_TIMINGS_PATH"] = str(timings_path)
    try:
        timings = run_pipeline(ROOT / PRESET, skip={"vae", "codebook"},
                               overrides=overrides, root_dir=work,
                               device="cuda")
    finally:
        del os.environ["VQVAE_TPU_PROFILE_DIR"]
        del os.environ["VQVAE_TPU_TIMINGS_PATH"]
    for f in (exp / "evaluation" / "codebook_health.json",
              exp / "evaluation" / "metrics.yaml"):
        if not f.exists():
            fail(f"traced pipeline: {f.name} was not written again")
    written = _json.loads(timings_path.read_text())
    if written.get("programs_compiled") != 0 or "compile_seconds" not in \
            written:
        fail(f"traced pipeline: timings JSON {written}")
    shares = {}
    for stage in ("quality", "transformer", "generate", "evaluate"):
        trace = prof / stage / "trace.json"
        if not trace.exists() or not trace.stat().st_size:
            fail(f"no trace for the {stage} stage")
        shares[stage] = _busy_share(trace, timings[stage])
    if not shares["transformer"] > 0:
        fail("the transformer stage's trace holds no CUDA kernel")
    log("16e per-stage traces (transformer 1 epoch): "
        + ", ".join(f"{s} {timings[s]:.3f}s, device busy "
                    f"{100 * shares[s]:.1f} %" for s in shares)
        + f"; programs_compiled {written['programs_compiled']}, "
        f"compile_seconds {written['compile_seconds']}")
    return {"seconds": timings, "busy": shares}


def phase_crossover(exp: Path, z) -> dict:
    """16f: the shortest-path backends' crossover on phase 6's graph (its
    LCC) and on a smaller kNN graph of its cells ``z``, through
    ``tools/bench_fit``."""
    from scipy import sparse

    from vqvae_tpu_torch.ops import (backend, build_knn_graph,
                                     largest_connected_component)
    from vqvae_tpu_torch.tools import bench_fit

    W = sparse.load_npz(exp / "codebook" / "knn_graph_geodesic.npz").tocsr()
    mask = largest_connected_component(W)
    Wl = W[mask][:, mask].tocsr()
    rec = bench_fit.crossover_grid(Wl, CROSSOVER_SOURCES, runs=1,
                                   device="cuda")
    # the backend the threshold picks at each point, beside the faster one
    picks = [("host" if g["work"] < backend.HOST_WORK_THRESHOLD else
              "device", "host" if g["host_s"] < g["device_s"] else "device")
             for g in rec["grid"]]
    threads = sorted(set(CROSSOVER_THREADS) | {rec["native_threads"]})
    scaling = bench_fit.thread_scaling(Wl, 8, threads, runs=1)
    log(f"16f crossover on the {rec['nodes']}-node LCC ({rec['edges']} "
        f"stored edges; {rec['host_threads']} host threads, native "
        f"{rec['native_threads']}; device graph build "
        f"{rec['device_graph_build_s']:.3f}s): "
        + ", ".join(f"{g['sources']} sources host {g['host_s']:.4f}s / "
                    f"device {g['device_s']:.4f}s (with the build "
                    f"{g['device_build_s']:.4f}s)" for g in rec["grid"])
        + f"; crossover {rec['crossover_sources']} sources (device wins "
        f"everywhere: {rec['device_wins_everywhere']}), work "
        f"{rec['crossover_work']}, per host thread "
        f"{rec['crossover_work_per_thread']}; with the device graph's "
        f"build in each call: {rec['crossover_sources_with_build']} "
        f"sources, per host thread "
        f"{rec['crossover_work_per_thread_with_build']}; "
        f"HOST_WORK_THRESHOLD {backend.HOST_WORK_THRESHOLD:.4g}, its pick "
        f"(and the faster) by point: "
        + ", ".join(f"{a} ({b})" for a, b in picks)
        + "; host Dijkstra from 8 sources by threads: "
        + ", ".join(f"{r['threads']}: {r['host_s']:.4f}s" for r in scaling))
    Ws, _ = build_knn_graph(z[:SMALL_GRAPH_ROWS], k=10, sym="union",
                            device="cuda")
    small = bench_fit.crossover_grid(Ws, SMALL_GRAPH_SOURCES, runs=2,
                                     device="cuda")
    log(f"16f crossover on a {small['nodes']}-node k=10 graph of the cells "
        f"({small['edges']} stored edges): "
        + ", ".join(f"{g['sources']}: host {g['host_s']:.4f}s / device "
                    f"{g['device_s']:.4f}s" for g in small["grid"])
        + f"; crossover {small['crossover_sources']} sources, work "
        f"{small['crossover_work']}, per host thread "
        f"{small['crossover_work_per_thread']}")
    log("16f crossover record " + json.dumps(
        {"crossover": rec, "small_graph": small, "thread_scaling": scaling}))
    return rec


def phase_slice(exact_i, knn_s: float, k1_ms: float, work: Path,
                exp: Path, cut: Path) -> dict:
    """Phase 16, steps a-f, each step's seconds logged."""
    from vqvae_tpu_torch.utils.latents import load_latents

    out, secs = {}, {}
    z_cut = load_latents(cut)["z"].reshape(-1, D).astype("float32")
    for name, fn in (
            ("a", lambda: phase_ivf(exact_i, knn_s, k1_ms)),
            ("b", lambda: phase_ivf_reference(z_cut)),
            ("c", lambda: phase_kmeans_reference(z_cut)),
            ("d", lambda: phase_demos(exp)),
            ("e", lambda: phase_stage_traces(work, exp)),
            ("f", lambda: phase_crossover(exp, z_cut))):
        t0 = time.perf_counter()
        out[name] = fn()
        secs[name] = time.perf_counter() - t0
    log("phase 16 seconds by step: "
        + ", ".join(f"{k} {v:.3f}" for k, v in secs.items()))
    return out


# -- phase 17: the CIFAR-10 presets and the last single-card scripts -------

CIFAR = "configs/cifar10/spatial/geodesic"
CIFAR_D = 32
CIFAR_VAE_EPOCHS = 2    # of the preset's 200
CIFAR_TF_EPOCHS = 2     # of the preset's 200
CIFAR_K3_ROWS = (16_000, 160_000)  # the quality stage's two K3 calls
# phase 17c's epoch loss gap, card against CPU: full f32 read 1.5e-6 on an
# H100 and the TF32 control 1.8e-5; the limit sits between them
CIFAR_LOSS_LIMIT = 5e-6
RIEM_ACCURACY_EDGES = 8192
PREP_NODES = 262_144
PULL_ROWS = 983_040


def cifar_overrides(work: Path) -> dict:
    """The CIFAR preset's overrides for phase 17a, rooted at ``work``: the
    VAE 2 epochs on the synthetic split, the codebook and the transformer
    on the first ``CODEBOOK_IMAGES`` training latents, the transformer 2
    epochs."""
    cut = str(work / f"latents_train_{CODEBOOK_IMAGES}")
    return {
        "vae": {"max_epochs": CIFAR_VAE_EPOCHS,
                "data": {"root": str(work / "no-data")}},
        "codebook": {"latents_path": cut},
        "transformer": {"data": {"labels_path": cut},
                        "training": {"epochs": CIFAR_TF_EPOCHS}},
    }


def phase_cifar_pipeline(work: Path) -> dict:
    """17a: the CIFAR-10 spatial-geodesic preset through ``run_pipeline``:
    vae, the 4,096-image cut, then codebook and quality each driven alone
    with the launch counts zeroed before and read after it, then
    transformer -> generate -> evaluate; every stage's artifacts
    checked."""
    import json as _json

    import numpy as np
    import yaml
    from scipy import sparse

    from vqvae_tpu_torch.cli import load_codebook, run_pipeline
    from vqvae_tpu_torch.cli.pipeline import STAGES
    from vqvae_tpu_torch.config import load_config
    from vqvae_tpu_torch.ops.knn import KNN_EFFECTIVE
    from vqvae_tpu_torch.utils.images import load_image
    from vqvae_tpu_torch.utils.latents import load_latents, save_latents

    preset = ROOT / CIFAR
    exp = work / load_config(preset / "quality.yaml")["experiment"]
    run = exp / "vae" / "spatial_vae_cifar10"
    overrides = cifar_overrides(work)
    work.mkdir(parents=True, exist_ok=True)
    seconds = dict(run_pipeline(preset, skip=STAGES[1:], overrides=overrides,
                                root_dir=work, device="cuda"))
    del seconds["total"]
    lat = load_latents(run / "latents_train")
    save_latents(overrides["codebook"]["latents_path"],
                 *(lat[k][:CODEBOOK_IMAGES]
                   for k in ("z", "mu", "logvar", "y")))
    launches = {}
    for stage in ("codebook", "quality"):
        zero_launches()
        t = run_pipeline(preset, skip=set(STAGES) - {stage},
                         overrides=overrides, root_dir=work, device="cuda")
        launches[stage] = read_launches()
        seconds[stage] = t[stage]
    knn_effective = dict(KNN_EFFECTIVE)
    sampling, restore = timed_sampler()
    try:
        rest = run_pipeline(preset, skip=STAGES[:3], overrides=overrides,
                            root_dir=work, device="cuda")
    finally:
        restore()
    seconds.update({k: v for k, v in rest.items() if k != "total"})

    tf_dir = exp / "transformer"
    evaluation = exp / "evaluation"
    for path in (run / "checkpoints" / "best.pt",
                 run / "checkpoints" / "latest.pt",
                 run / "latents_train" / "latents.npz",
                 run / "latents_val" / "latents.npz",
                 run / "recon_grid.png", run / "metrics.jsonl",
                 exp / "codebook" / "codebook.npz",
                 exp / "codebook" / "codebook.pt",
                 exp / "codebook" / "codes.npy",
                 exp / "codebook" / "knn_graph_geodesic.npz",
                 tf_dir / "checkpoints" / "best.pt",
                 tf_dir / "checkpoints" / "latest.pt",
                 tf_dir / "metrics.jsonl",
                 evaluation / "generated_samples.png",
                 evaluation / "metrics.yaml",
                 evaluation / "comparison_grid.png"):
        if not path.exists():
            fail(f"CIFAR pipeline artifact {path} missing")
    quality = quality_outputs(exp)
    rows = [_json.loads(line) for line in
            (run / "metrics.jsonl").read_text().splitlines()]
    val_loss = rows[-1]["val_loss"]
    if len(rows) != CIFAR_VAE_EPOCHS or not np.isfinite(val_loss):
        fail(f"CIFAR VAE: {len(rows)} epochs, final val loss {val_loss}")
    tf_rows = [_json.loads(line) for line in
               (tf_dir / "metrics.jsonl").read_text().splitlines()]
    tf_losses = [(r["train_loss"], r["val_loss"]) for r in tf_rows]
    if len(tf_rows) != CIFAR_TF_EPOCHS or not np.all(np.isfinite(tf_losses)):
        fail(f"CIFAR transformer: {len(tf_rows)} epochs, losses {tf_losses}")
    if not tf_rows[-1]["train_loss"] < tf_rows[0]["train_loss"]:
        fail(f"CIFAR transformer: train loss did not fall: {tf_losses}")
    grid = load_image(evaluation / "generated_samples.png")
    if grid.shape != (342, 342, 3):
        fail(f"CIFAR generated_samples.png is {grid.shape}, expected "
             f"342 x 342 x 3")
    metrics = yaml.safe_load((evaluation / "metrics.yaml").read_text())
    if not (np.isfinite(metrics["PSNR_full"])
            and np.isfinite(metrics["SSIM_full"])
            and metrics["LPIPS"] is None):
        fail(f"CIFAR evaluation metrics {metrics}")
    codes = np.load(exp / "codebook" / "codes.npy")
    if codes.shape != (CODEBOOK_IMAGES, 4, 4):
        fail(f"CIFAR codes shape {codes.shape}")
    z_cut = load_latents(overrides["codebook"]["latents_path"])["z"]
    if z_cut.shape[-1] != CIFAR_D:
        fail(f"CIFAR latents are {z_cut.shape}, expected D = {CIFAR_D}")
    if launches["codebook"]["K1/K2"] <= 0 or not knn_effective.get(
            "packed"):
        fail(f"the CIFAR codebook stage launched no K1 kernel "
             f"({launches['codebook']}, {knn_effective})")
    if launches["quality"]["K3"] <= 0:
        fail(f"the CIFAR quality stage launched no K3 kernel "
             f"({launches['quality']})")
    if not sampling:
        fail("the CIFAR generate stage did not sample")
    rates = [r["train_steps"] / r["train_seconds"] for r in rows]
    tf_rates = [r["train_steps"] / r["train_seconds"] for r in tf_rows]
    rec = load_codebook(exp / "codebook")["config"]
    edges = sparse.load_npz(exp / "codebook" / "knn_graph_geodesic.npz"
                            ).nnz // 2
    riem_ms = rec["timings_s"]["riemannian"] / edges * 4096 * 1e3
    shown = ("psnr", "ssim", "quality", "health", "entropy", "used")
    log("17a CIFAR pipeline seconds by stage: "
        + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items())
        + f"; vae steps/s per epoch {', '.join(f'{r:.2f}' for r in rates)},"
        f" final val loss {val_loss}, psnr {rows[-1]['val_psnr']}; codebook "
        f"{codes.size} nodes at D = {z_cut.shape[-1]} ({knn_effective}), "
        f"{edges} edges (Riemannian {riem_ms:.3f} ms per 4,096), "
        f"QE {rec['quantization_error']}, LCC {rec['lcc_nodes']}, steps "
        + ", ".join(f"{k} {v:.3f}s" for k, v in rec["timings_s"].items())
        + "; quality " + "; ".join(
            name + ": " + ", ".join(f"{k} {v}" for k, v in q.items()
                                    if k.startswith(shown))
            for name, q in quality.items())
        + f"; transformer steps/s {', '.join(f'{r:.2f}' for r in tf_rates)}"
        f", losses {tf_losses}; generate "
        f"{sampling['seconds'] / sampling['steps'] * 1e3:.3f} ms a token "
        f"step; evaluate PSNR {metrics['PSNR_full']}, SSIM "
        f"{metrics['SSIM_full']}; launches by stage {launches}")
    return {"exp": exp, "run": run, "cut": Path(
        overrides["codebook"]["latents_path"]), "launches": launches,
            "seconds": seconds, "knn": knn_effective}


def phase_cifar_kernels(cifar: dict) -> dict:
    """17b: K1 and K3 at D = 32 on phase 17a's own latents and codebook,
    each against its plain version (the near-tie rules of phase 3), timed
    beside its bound and a library call."""
    import numpy as np
    import torch

    from vqvae_tpu_torch.cli import load_codebook
    from vqvae_tpu_torch.ops.knn_select import (fused_select,
                                                fused_select_reference)
    from vqvae_tpu_torch.utils.latents import load_latents

    z = load_latents(cifar["cut"])["z"].reshape(-1, CIFAR_D)
    zd = torch.from_numpy(np.ascontiguousarray(z, np.float32)).cuda()
    n, bins = zd.shape[0], int(cifar["knn"]["bins"])
    name = f"K1 (packed, bins {bins}) at D = {CIFAR_D}, {n} x {n}"

    def kernel():
        return fused_select(zd, zd, n, metric="euclidean", bins=bins,
                            k_sel=K_SEL, packed=True)

    def plain():
        return fused_select_reference(zd, zd, n, metric="euclidean",
                                      bins=bins, k_sel=K_SEL, packed=True)

    kd, ki = kernel()
    rd, ri = plain()
    max_abs, frac = select_agrees(name, kd, ki, rd, ri)
    del kd, ki, rd, ri
    ms = cuda_ms(kernel, 5)
    parts = kernel_times(kernel)
    log(f"{name} device time by kernel: " + "; ".join(
        f"{key[:48]} {t:.3f} ms" for key, t in parts[:7]))
    plain_ms = cuda_ms(plain, 1)

    def library():
        for s in range(0, n, 4096):
            torch.topk(torch.cdist(zd[s:s + 4096], zd), K_SEL, dim=1,
                       largest=False)

    library_ms = cuda_ms(library, 1)
    bound_ms, bound_by, cuda_core_ms = select_bound(n, n, CIFAR_D, K_SEL,
                                                    True)
    log(f"{name}: rows differ {frac:.2e}, max |kernel - plain| {max_abs}; "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, cdist+topk "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
        f"CUDA-core f32 bound {cuda_core_ms:.4f} ms)")
    out = {"K1@32": {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": library_ms, "rows_differ": frac}}
    del zd
    zv = load_latents(cifar["run"] / "latents_val")["z"].reshape(-1,
                                                                 CIFAR_D)
    cb = load_codebook(cifar["exp"] / "codebook")["z_medoid"].astype(
        np.float32)
    zv = torch.from_numpy(np.ascontiguousarray(zv, np.float32)).cuda()
    cb = torch.from_numpy(cb).cuda()
    for rows in CIFAR_K3_ROWS:
        res = check_assign(f"K3 assign ({rows} x {CIFAR_D}, {cb.shape[0]} "
                           f"codes) on the CIFAR run", zv[:rows].contiguous(),
                           cb, 20, split=(rows == CIFAR_K3_ROWS[-1]))
        out[f"K3@{CIFAR_D}" if rows == CIFAR_K3_ROWS[-1]
            else f"K3@{CIFAR_D}/{rows}"] = res
    torch.cuda.empty_cache()
    return out


def phase_cifar_probe(cifar: dict) -> dict:
    """17d: the collapse probe's ``measure`` on 17a's VAE and the dilation
    experiment on 17a's experiment; numbers must be finite (two epochs
    cannot judge collapse: ``collapsed`` is printed, not gated)."""
    from vqvae_tpu_torch.config import load_config
    from vqvae_tpu_torch.experiments_geo import run_riemann_experiments
    from vqvae_tpu_torch.tools import check_cifar_collapse

    cfg = load_config(ROOT / CIFAR / "vae.yaml")
    probe = check_cifar_collapse.measure(cifar["run"], cfg, device="cuda")
    _finite("the CIFAR probe", [v for k, v in probe.items()
                                if k != "collapsed"])
    riem = run_riemann_experiments.run(cifar["exp"], device="cuda")
    _finite("the CIFAR dilation", [
        riem[k] for k in ("mean_sp_euclidean", "mean_sp_riemannian",
                          "path_dilation_ratio", "path_dilation_ratio_raw")])
    print(json.dumps({"cifar_probe": probe, "cifar_dilation": riem}),
          flush=True)
    return {"probe": probe, "dilation": riem}


def _tool(name: str, fn):
    """Run one tool, print its JSON line and its seconds."""
    t0 = time.perf_counter()
    out = fn()
    secs = time.perf_counter() - t0
    print(json.dumps({"tool": name, "seconds": secs, "result": out},
                     default=str), flush=True)
    return out


def phase_tools(work: Path, exp6: Path, cut6: Path, cifar: dict) -> dict:
    """17e: each tool at a cut size, one JSON line each."""
    import numpy as np
    from scipy import sparse

    from vqvae_tpu_torch.cli import compare_all_approaches, train_legacy_vae
    from vqvae_tpu_torch.ops import largest_connected_component
    from vqvae_tpu_torch.tools import (ab_kmed_reorder, bench_kmedoids_prep,
                                       bench_riemannian, check_riem_accuracy,
                                       probe_pull, run_fullscale_median)
    from vqvae_tpu_torch.utils.latents import load_latents
    from vqvae_tpu_torch.visualizations import knn_experiments

    out = {}
    W = sparse.load_npz(exp6 / "codebook" / "knn_graph_geodesic.npz").tocsr()
    z6 = load_latents(cut6)["z"].reshape(-1, D).astype(np.float32)
    upper = sparse.triu(W, k=1).tocoo()
    bench = _tool("bench_riemannian", lambda: bench_riemannian.run(
        z=z6, rows=upper.row, cols=upper.col, engines=("mlp", "indexed",
                                                       "nodal"),
        runs=1, batch=4096, device="cuda"))
    for eng, rec in bench["records"].items():
        _finite(f"bench_riemannian {eng}", [bench["results"][eng],
                                            rec["flops"]])
        log(f"17e Riemannian {eng}: {bench['results'][eng]:.4f} s for "
            f"{rec['samples']} JVP samples, {rec['flops']:.4g} FLOP "
            f"({rec['jvp_flops_per_sample']:.4g} a sample) = "
            f"{rec['f32_peak_seconds']:.4f} s at the f32 peak "
            f"({rec['f32_peak_seconds'] / bench['results'][eng]:.2%})")
    out["bench_riemannian"] = bench
    for label, kw in (("fashion", {}), ("cifar", {"channels": 3, "size": 32,
                                                  "dim": CIFAR_D})):
        acc = _tool(f"check_riem_accuracy ({label})",
                    lambda kw=kw: check_riem_accuracy.run(
                        edges=RIEM_ACCURACY_EDGES, device="cuda", **kw))
        _finite("check_riem_accuracy", [list(v.values()) for v in
                                        acc["results"].values()])
        out[f"check_riem_accuracy_{label}"] = acc
    out["bench_kmedoids_prep"] = _tool(
        "bench_kmedoids_prep", lambda: bench_kmedoids_prep.run(
            nodes=PREP_NODES, device="cuda"))
    mask = largest_connected_component(W)
    ab = _tool("ab_kmed_reorder", lambda: ab_kmed_reorder.run(
        W[mask][:, mask].tocsr(), K=KMEANS_K, device="cuda"))
    if len({r["qe"] for r in ab["runs"] if r["reorder"]}) != 1:
        fail(f"ab_kmed_reorder: the reorder-on fits differ: {ab['runs']}")
    out["ab_kmed_reorder"] = ab
    out["probe_pull"] = _tool("probe_pull", lambda: probe_pull.run(
        rows=PULL_ROWS, k=11, device="cuda"))
    med_root = work / "median"
    med = _tool("run_fullscale_median", lambda: run_fullscale_median.run(
        ROOT / "configs/sandbox-fashion/geodesic", runs=2,
        out=med_root / "timings.json", root=med_root, device="cuda",
        overrides={"vae": {"max_epochs": 1,
                           "data": {"root": str(work / "no-data")}},
                   "transformer": {"training": {"epochs": 1}}}))
    _finite("run_fullscale_median", med["band_seconds"])
    out["run_fullscale_median"] = med
    table = _tool("compare_all_approaches", lambda: compare_all_approaches.run(
        [("spatial_geodesic", str(exp6)),
         ("vanilla_geodesic",
          str(work / "vanilla" / "experiments/fashionmnist/vanilla/geodesic")),
         ("baseline_vqvae", str(work / "baseline" / "baseline")),
         ("cifar_spatial_geodesic", str(cifar["exp"]))],
        work / "comparison"))
    if table is None or len(table) != 4:
        fail(f"compare_all_approaches read {table and list(table)}")
    out["compare_all_approaches"] = table
    knn = _tool("knn_experiments", lambda: [
        {k: v for k, v in r.items() if k != "distances"}
        for r in knn_experiments.run(z6, (5, 10, 20), device="cuda")["rows"]])
    _finite("knn_experiments", [[r["connectivity_ratio"],
                                 r["mean_geodesic"]] for r in knn])
    out["knn_experiments"] = knn
    legacy = _tool("train_legacy_vae", lambda: train_legacy_vae.main([
        "--epochs", "1", "--synthetic-size", "4096", "--out-dir",
        str(work / "legacy"), "--device", "cuda"]))
    if not (legacy / "checkpoints" / "best.pt").exists():
        fail("train_legacy_vae wrote no checkpoint")
    return out


def phase_cifar(work: Path, exp6: Path, cut6: Path) -> dict:
    """Phase 17, steps a-e, each step's seconds logged."""
    secs, out = {}, {}

    def step(name, fn):
        t0 = time.perf_counter()
        out[name] = fn()
        secs[name] = time.perf_counter() - t0

    step("a", lambda: phase_cifar_pipeline(work / "cifar"))
    step("b", lambda: phase_cifar_kernels(out["a"]))
    step("c", lambda: phase_vae_epoch(preset=CIFAR, dataset="cifar10",
                                      label="phase 17c", extras=False,
                                      loss_limit=CIFAR_LOSS_LIMIT))
    step("d", lambda: phase_cifar_probe(out["a"]))
    step("e", lambda: phase_tools(work, exp6, cut6, out["a"]))
    log("phase 17 seconds by step: "
        + ", ".join(f"{k} {v:.3f}" for k, v in secs.items()))
    return out


# -- phase 18: the device mesh (torch.distributed) --------------------------

P18_RANKS = 2            # ranks of 18b-d, both on cuda:0 under gloo
P18_SOURCES = 64         # sources of the distance check
P18_VAE_IMAGES = 1200    # 18c: 5 batches of 256, the last padded
P18_STEPS = 5
P18_TIMEOUT = 600
P18_STATE_RTOL = 1e-5    # 18c: EMA codebook, bank, BatchNorm statistics
P18_STATE_ATOL = 2e-5    # ... and this share of the tensor's largest value
P18_GRAD_GAP = 1e-3      # 18c: |g - g_one| / |g_one| over all gradients


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_ranks(world: int, spec: dict, work: Path, label: str) -> list:
    """Run ``world`` ranks of this script's phase-18 worker (the env of
    ``torchrun``: RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR/PORT); each
    writes ``<work>/<label>_rank<r>.json``. A rank that exits non-zero
    fails the run; every rank is stopped before this returns."""
    work.mkdir(parents=True, exist_ok=True)
    spec_path = work / f"{label}_spec.json"
    spec_path.write_text(json.dumps({**spec, "label": label,
                                     "work": str(work)}))
    port = _free_port()
    procs, logs = [], []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   PYTHONPATH=str(ROOT))
        logs.append(open(work / f"{label}_rank{rank}.log", "w"))
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--phase18-rank",
             str(spec_path)], env=env, stdout=logs[-1],
            stderr=subprocess.STDOUT))
    t_end = time.monotonic() + P18_TIMEOUT
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) \
                    or time.monotonic() > t_end:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        for f in logs:
            f.close()
    for rank, p in enumerate(procs):
        text = (work / f"{label}_rank{rank}.log").read_text()
        for line in text.splitlines():
            if line.startswith("[chip_smoke]"):
                print(f"  rank {rank}: {line}", flush=True)
        if p.returncode != 0:
            print(text[-6000:], file=sys.stderr, flush=True)
            fail(f"phase 18 {label}: rank {rank} of {world} exited with "
                 f"{p.returncode}")
    return [json.loads((work / f"{label}_rank{r}.json").read_text())
            for r in range(world)]


def _p18_decoder(ckpt: Path, dev):
    """The spatial decoder of a VAE checkpoint, configured as the codebook
    stage configures it."""
    from vqvae_tpu_torch.config import load_config
    from vqvae_tpu_torch.ops.riemannian import make_decoder_image_fn
    from vqvae_tpu_torch.utils.checkpoint import load_vae_from_checkpoint

    vae_cfg = dict(load_config(ROOT / PRESET / "codebook.yaml")["vae"])
    vae_cfg.setdefault("topology", "spatial")
    vae_cfg["enc_channels"] = tuple(vae_cfg["enc_channels"])
    vae_cfg["dec_channels"] = tuple(vae_cfg["dec_channels"])
    model = load_vae_from_checkpoint(ckpt, vae_cfg, device=dev)
    return make_decoder_image_fn(model, model.topology)


def _p18_codebook_steps(z_flat, decode_fn, mesh, dev) -> tuple:
    """The codebook stage's steps as ``build_codebook_main`` runs them
    (k 20 union approx, lengths at batch 4096, LCC, K 512 kpp_parallel
    seed 42), then the distances from the first medoids; returns (arrays,
    seconds, K1/K2 launches)."""
    import numpy as np

    from vqvae_tpu_torch.ops.backend import multi_source_distances
    from vqvae_tpu_torch.ops.ell import BucketedGraph
    from vqvae_tpu_torch.ops.graph import (build_knn_graph,
                                           largest_connected_component,
                                           symmetric_csr_from_edges)
    from vqvae_tpu_torch.ops.kmedoids import fit_kmedoids
    from vqvae_tpu_torch.ops.knn_select import fused_select
    from vqvae_tpu_torch.ops.riemannian import edge_lengths_riemannian_auto

    secs = {}
    t0 = time.perf_counter()
    fused_select.launches = 0
    W_eu, info = build_knn_graph(z_flat, k=20, mode="connectivity",
                                 sym="union", approx=True, device=dev,
                                 mesh=mesh)
    launches = fused_select.launches
    secs["knn"] = time.perf_counter() - t0
    rows, cols = W_eu.nonzero()
    keep = rows < cols
    rows, cols = rows[keep], cols[keep]
    t0 = time.perf_counter()
    lengths = edge_lengths_riemannian_auto(decode_fn, z_flat, rows, cols,
                                           batch_size=4096, device=dev,
                                           mesh=mesh)
    secs["riemannian"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    W_geo = symmetric_csr_from_edges(rows, cols, lengths, W_eu.shape[0])
    mask = largest_connected_component(W_geo)
    W_lcc = W_geo[mask][:, mask].tocsr()
    secs["lcc"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    med, asg, qe = fit_kmedoids(W_lcc, K=512, init="kpp_parallel", seed=42,
                                kpp_rounds=4, device=dev,
                                assume_symmetric=True, mesh=mesh)
    secs["kmedoids"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    bg = BucketedGraph.from_csr(W_lcc, assume_symmetric=True, device=dev)
    dist = multi_source_distances(bg, med[:P18_SOURCES], "device", mesh=mesh)
    secs["distances"] = time.perf_counter() - t0
    return ({"indices": info["indices"], "lengths": lengths, "lcc": mask,
             "medoids": med, "assign": asg, "qe": np.array(qe),
             "distances": dist}, secs, launches)


def _p18a_rank(spec: dict, dev) -> dict:
    """18a: the sharded codebook steps through a one-rank NCCL group
    against the same steps without a group, bit for bit."""
    import numpy as np

    from vqvae_tpu_torch.parallel import init_distributed
    from vqvae_tpu_torch.utils.latents import flatten_spatial, load_latents

    z_flat = flatten_spatial(load_latents(spec["latents"])["z"])
    decode_fn = _p18_decoder(Path(spec["vae"]), dev)
    plain, s_plain, k_plain = _p18_codebook_steps(z_flat, decode_fn, None,
                                                  dev)
    mesh = init_distributed("nccl", device=dev)
    if not (mesh.distributed and mesh.world_size == 1
            and mesh.backend == "nccl"):
        fail(f"18a: expected a one-rank NCCL group, got {mesh}")
    sharded, s_mesh, k_mesh = _p18_codebook_steps(z_flat, decode_fn, mesh,
                                                  dev)
    differ = [k for k in plain
              if not np.array_equal(plain[k], sharded[k])]
    return {"nodes": int(z_flat.shape[0]), "differ": differ,
            "seconds_plain": s_plain, "seconds_mesh": s_mesh,
            "k1_plain": k_plain, "k1_mesh": k_mesh,
            "qe": float(sharded["qe"]),
            "lcc": int(sharded["lcc"].sum())}


def _near_tie_rows(i_a, d_a, i_b, d_b, rel: float = 1e-5) -> tuple:
    """(rows whose neighbour sets differ, rows among them whose differing
    neighbours lie within ``rel`` of the row's k-th distance)."""
    import numpy as np

    differ = np.nonzero((i_a != i_b).any(1))[0]
    ties = 0
    for r in differ:
        kth = max(float(d_a[r, -1]), float(d_b[r, -1]))
        only = set(i_a[r]) ^ set(i_b[r])
        vals = [float(d[r][i[r] == c][0]) for c in only
                for i, d in ((i_a, d_a), (i_b, d_b)) if (i[r] == c).any()]
        ties += all(abs(v - kth) <= rel * max(kth, 1e-30) for v in vals)
    return int(len(differ)), int(ties)


def _p18b(spec: dict, mesh, dev) -> dict:
    """18b: the codebook stage's steps sharded over the ranks, each from
    phase 4's inputs: kNN (against one process's search on rank 0),
    lengths on phase 4's LCC graph (against its stored lengths), k-medoids
    on it (against phase 4's medoids, codes and QE) and the distances from
    64 medoids (against one process's relaxation on rank 0)."""
    import numpy as np
    from scipy import sparse

    from vqvae_tpu_torch.cli import load_codebook
    from vqvae_tpu_torch.ops.backend import multi_source_distances
    from vqvae_tpu_torch.ops.ell import BucketedGraph
    from vqvae_tpu_torch.ops.kmedoids import fit_kmedoids
    from vqvae_tpu_torch.ops.knn import knn_search
    from vqvae_tpu_torch.ops.knn_select import fused_select
    from vqvae_tpu_torch.ops.riemannian import edge_lengths_riemannian_auto
    from vqvae_tpu_torch.parallel import HOST_COPIES, barrier
    from vqvae_tpu_torch.utils.latents import flatten_spatial, load_latents

    z_flat = flatten_spatial(load_latents(spec["b_latents"])["z"])
    decode_fn = _p18_decoder(Path(spec["b_vae"]), dev)
    out, secs = {"nodes": int(z_flat.shape[0])}, {}
    copies0 = dict(HOST_COPIES)

    barrier(mesh)
    t0 = time.perf_counter()
    fused_select.launches = 0
    d_sh, i_sh = knn_search(z_flat, 21, approx=True, device=dev, mesh=mesh)
    out["k1_launches"] = fused_select.launches
    secs["knn"] = time.perf_counter() - t0
    if mesh.rank == 0:
        d_1, i_1 = knn_search(z_flat, 21, approx=True, device=dev)
        out["knn_rows_differ"], out["knn_near_ties"] = _near_tie_rows(
            i_sh, d_sh, i_1, d_1)
    del d_sh, i_sh

    cb = Path(spec["b_codebook"])
    W_lcc = sparse.load_npz(cb / "knn_graph_geodesic.npz").tocsr()
    codes = np.load(cb / "codes.npy").reshape(-1)
    z_lcc = z_flat[codes >= 0]
    tri = sparse.triu(W_lcc, 1).tocoo()
    barrier(mesh)
    t0 = time.perf_counter()
    lengths = edge_lengths_riemannian_auto(decode_fn, z_lcc, tri.row,
                                           tri.col, batch_size=4096,
                                           device=dev, mesh=mesh)
    secs["riemannian"] = time.perf_counter() - t0
    rel = np.abs(lengths - tri.data) / np.maximum(np.abs(tri.data), 1e-30)
    out["edges"] = int(len(lengths))
    out["lengths_max_rel"] = float(rel.max())
    out["lengths_over_1e-6"] = int((rel > 1e-6).sum())

    barrier(mesh)
    t0 = time.perf_counter()
    med, asg, qe = fit_kmedoids(W_lcc, K=512, init="kpp_parallel", seed=42,
                                kpp_rounds=4, device=dev,
                                assume_symmetric=True, mesh=mesh)
    secs["kmedoids"] = time.perf_counter() - t0
    ref = load_codebook(cb)
    out["medoids_equal"] = bool(np.array_equal(med,
                                               ref["medoid_indices"]))
    out["assign_equal"] = bool(np.array_equal(asg, codes[codes >= 0]))
    out["qe"], out["qe_ref"] = float(qe), float(
        ref["config"]["quantization_error"])

    bg = BucketedGraph.from_csr(W_lcc, assume_symmetric=True, device=dev)
    barrier(mesh)
    t0 = time.perf_counter()
    dist = multi_source_distances(bg, med[:P18_SOURCES], "device",
                                  mesh=mesh)
    secs["distances"] = time.perf_counter() - t0
    if mesh.rank == 0:
        out["distances_equal"] = bool(np.array_equal(
            dist, multi_source_distances(bg, med[:P18_SOURCES], "device")))
    out["seconds"] = secs
    out["host_copies"] = {k: HOST_COPIES[k] - copies0[k]
                          for k in HOST_COPIES}
    return out


def _p18_excess(got, ref, rtol: float) -> float:
    """How far ``got`` lies beyond rtol of ``ref``, as a share of ref's
    largest value (<= 0: within rtol everywhere; inf: not finite)."""
    if not bool(got.isfinite().all()):
        return float("inf")
    top = max(float(ref.abs().max()), 1e-30) if ref.numel() else 1.0
    return float(((got - ref).abs() - rtol * ref.abs()).max()) / top \
        if ref.numel() else 0.0


def _p18_grad_gap(got: dict, ref: dict) -> float:
    """|got - ref| / |ref| over every parameter's gradient at once (the
    Euclidean norms of the concatenated gradients)."""
    num = sum(float(((got[k] - w).double() ** 2).sum())
              for k, w in ref.items())
    den = sum(float((w.double() ** 2).sum()) for w in ref.values())
    return (num / max(den, 1e-300)) ** 0.5


def _p18_state_check(got: dict, ref: dict, lr: float, params: set) -> tuple:
    """(parameters apart at most, in lr; buffers' largest excess over
    P18_STATE_RTOL as a share of their largest value)."""
    worst, buf = 0.0, 0.0
    for key, r in ref.items():
        g = got[key]
        if not r.is_floating_point():
            continue
        if key in params:
            worst = max(worst, float((g - r).abs().max()) / lr
                        if bool(g.isfinite().all()) else float("inf"))
        else:
            buf = max(buf, _p18_excess(g, r, P18_STATE_RTOL))
    return worst, buf


def _p18c(spec: dict, mesh, dev) -> dict:
    """18c: data-parallel steps of each model at full width, the ranks on
    halves of each batch, against one process on the whole batch (rank
    0, no group). Each of the P18_STEPS data-parallel steps starts from
    the one process's state before that step (weights, optimizer state,
    BatchNorm statistics; the baseline's codebook and bank) with the same
    batch and generators, so every step is held on its own. Limits per
    step: the losses and metrics within 1e-5 relative; the gradients
    after the step (summed over ranks, clipped), all parameters' together,
    within P18_GRAD_GAP of one process's in Euclidean norm; the EMA
    codebook, the bank and the BatchNorm statistics within rtol
    P18_STATE_RTOL or P18_STATE_ATOL of the tensor's largest value; the
    parameters at most 2 lr apart (one Adam step). The baseline's
    codes may differ at near-ties (distances within 1e-5 of their terms'
    scale |z|^2 + |e|^2, at most 1e-3 of the step's latents), counted per
    step: its codebook is then held against one process's EMA update from
    the same state on the data-parallel codes, and its perplexity and
    usage against those codes' histogram. Controls that must fail: one
    step with the gradients left unsummed (each model), the EMA counts
    and sums left un-reduced, and the bank filled from the local rows."""
    import copy

    import numpy as np
    import torch

    import vqvae_tpu_torch.models.vqvae_baseline as vqvae_baseline_mod
    import vqvae_tpu_torch.train.transformer_engine as tf_engine_mod
    import vqvae_tpu_torch.train.vae_engine as vae_engine_mod
    import vqvae_tpu_torch.train.vqvae_engine as vq_engine_mod
    from vqvae_tpu_torch.cli.train_baseline_vqvae import baseline_model
    from vqvae_tpu_torch.config import load_config
    from vqvae_tpu_torch.data import load_dataset
    from vqvae_tpu_torch.models import VAE, flax_init_
    from vqvae_tpu_torch.models.transformer import (Transformer,
                                                    transformer_init_)
    from vqvae_tpu_torch.models.vqvae_baseline import (CodebookState,
                                                       ema_update, quantize)
    from vqvae_tpu_torch.parallel import (HOST_COPIES, all_gather_rows,
                                          barrier, get_mesh)
    from vqvae_tpu_torch.train import (TransformerEngine, VAEEngine,
                                       VQVAEEngine)
    from vqvae_tpu_torch.train.vae_engine import seeded_generator

    one = get_mesh(1)
    work = Path(spec["work"]) / "c_states"
    work.mkdir(parents=True, exist_ok=True)
    out = {"seconds": {}, "seconds_one": {}}
    copies0 = dict(HOST_COPIES)

    def cpu(t):
        return t.detach().cpu().clone()

    def grads_of(eng):
        return {k: cpu(p.grad) for k, p in eng.model.named_parameters()
                if p.grad is not None}

    def run(kind, make, step_fn):
        """Rank 0 runs one process's P18_STEPS steps and keeps the state
        before each; every rank then takes each data-parallel step from
        that state. Returns (one process's results, the ranks' results,
        the data-parallel engine, the states)."""
        ref, states = [], []
        if mesh.rank == 0:
            eng = make(one)
            extra = step_fn.initial(eng)
            t0 = time.perf_counter()
            for s in range(P18_STEPS):
                states.append({"model": copy.deepcopy(eng.model.state_dict()),
                               "opt": copy.deepcopy(eng.opt.state_dict()),
                               "step": getattr(eng, "step", 0), **extra})
                res, extra = step_fn(eng, s, states[-1])
                ref.append(res)
            out["seconds_one"][kind] = time.perf_counter() - t0
            torch.save(states, work / f"{kind}.pt")
        barrier(mesh)
        states = torch.load(work / f"{kind}.pt", map_location=dev,
                            weights_only=False)
        eng = make(mesh)
        got, secs = [], 0.0
        for s in range(P18_STEPS):
            _restore(eng, states[s])
            t0 = time.perf_counter()
            got.append(step_fn(eng, s, states[s])[0])
            secs += time.perf_counter() - t0
        out["seconds"][kind] = secs
        return ref, got, eng, states

    def _restore(eng, st):
        eng.model.load_state_dict(st["model"])
        eng.opt.load_state_dict(copy.deepcopy(st["opt"]))
        if hasattr(eng, "step"):
            eng.step = st["step"]

    def control(mod, name, value, eng, st, step_fn):
        """One data-parallel step 0 with ``mod.name`` replaced."""
        orig = getattr(mod, name)
        setattr(mod, name, value)
        try:
            _restore(eng, st)
            return step_fn(eng, 0, st)[0]
        finally:
            setattr(mod, name, orig)

    def unsummed(params, m):
        return None

    # -- the VAE: the epoch path's steps over a fixed permutation --------
    cfg = load_config(ROOT / PRESET / "vae.yaml")
    arch = dict(cfg["model"])
    arch.pop("beta")
    bs, lr = int(cfg["data"]["batch_size"]), float(cfg["lr"])
    model = flax_init_(VAE(**arch), seeded_generator("cpu", 42))
    split = load_dataset("fashionmnist", root="no-such-dir", train=True,
                         synthetic_size=P18_VAE_IMAGES, seed=42)
    loader = SimpleNamespace(split=SimpleNamespace(images=split.images))
    vae_params = {k for k, _ in model.named_parameters()}
    vdata = {}

    def make_vae(m):
        eng = VAEEngine(copy.deepcopy(model), lr=lr,
                        weight_decay=float(cfg["weight_decay"]),
                        grad_clip_max_norm=float(cfg["grad_clip_max_norm"]),
                        seed=42, device=dev, mesh=m)
        if not vdata:
            data, mask, _, n_pad = eng.device_dataset(loader, bs)
            perm = torch.randperm(n_pad, generator=torch.Generator()
                                  .manual_seed(42)).to(dev)
            vdata.update(data=data, mask=mask, perm=perm)
        return eng

    def vae_step(eng, s, st):
        mine = eng.local_rows(bs)
        ib = vdata["perm"][s * bs:(s + 1) * bs][mine]
        m = eng.train_step(vdata["data"][ib], vdata["mask"][ib], 1.0,
                           seeded_generator(dev, 42, 1, s), nan_guard=True,
                           noise_rows=(mine.start, bs))
        return {"loss": cpu(torch.stack([m["loss"], m["recon"], m["kl"]])),
                "grads": grads_of(eng),
                "state": {k: cpu(v) for k, v in
                          eng.model.state_dict().items()}}, {}
    vae_step.initial = lambda eng: {}

    # -- the transformer: dropout 0, a padded tail -----------------------
    tcfg = load_config(ROOT / PRESET / "transformer.yaml")
    tarch = {**dict(tcfg["model"]), "dropout": 0.0}
    tmodel = transformer_init_(Transformer(**tarch),
                               seeded_generator("cpu", 42))
    tbs, seq = int(tcfg["data"]["batch_size"]), tarch["max_seq_len"]
    g = torch.Generator().manual_seed(42)
    tb = []
    for _ in range(P18_STEPS):
        x = torch.randint(0, tarch["num_tokens"], (tbs, seq - 1), generator=g)
        t = torch.randint(0, tarch["num_tokens"], (tbs, seq - 1), generator=g)
        lab = torch.randint(0, tarch["num_classes"], (tbs,), generator=g)
        mask = torch.ones(tbs)
        mask[-16:] = 0.0
        tb.append((x, t, lab, mask))
    tlr = float(tcfg["training"]["lr"])
    tf_params = {k for k, _ in tmodel.named_parameters()}

    def make_tf(m):
        return TransformerEngine(
            copy.deepcopy(tmodel), lr=tlr,
            weight_decay=float(tcfg["training"].get("weight_decay", 0.0)),
            label_smoothing=float(tcfg["training"].get("label_smoothing",
                                                       0.0)),
            seed=42, device=dev, mesh=m)

    def tf_step(eng, s, st):
        mine = eng.local_rows(tbs)
        loss = eng.train_step(*(a[mine].to(dev) for a in tb[s]), None)
        return {"loss": cpu(loss)[None], "grads": grads_of(eng),
                "state": {k: cpu(v) for k, v in
                          eng.model.state_dict().items()}}, {}
    tf_step.initial = lambda eng: {}

    # -- the baseline: batch 128, a padded tail, the EMA codebook and bank
    bcfg = load_config(ROOT / BASELINE)
    bm, btr = bcfg["model"], bcfg["train"]
    bbs, n_codes = int(btr["batch_size"]), int(bm["n_codes"])
    blr = float(btr["lr"])
    bmodel = flax_init_(baseline_model(bm), seeded_generator("cpu", 42))
    cb0 = CodebookState.create(seeded_generator("cpu", 42, 1), n_codes,
                               int(bm["z_channels"]))
    bsplit = load_dataset("cifar10", root="no-such-dir", train=True,
                          synthetic_size=bbs * P18_STEPS, seed=42)
    bx = torch.from_numpy(bsplit.denormalize(bsplit.images) * 2.0
                          - 1.0).float()
    bmask = torch.ones(len(bx))
    bx[-16:], bmask[-16:] = 0.0, 0.0
    vq_params = {k for k, _ in bmodel.named_parameters()}

    def make_vq(m):
        return VQVAEEngine(copy.deepcopy(bmodel), n_codes=n_codes,
                           beta=float(bm["beta"]),
                           ema_decay=float(bm["ema_decay"]),
                           ema_eps=float(bm["ema_eps"]), lr=blr,
                           grad_clip=float(btr["grad_clip"]), seed=42,
                           device=dev, mesh=m)

    def vq_step(eng, s, st):
        mine = eng.local_rows(bbs)
        sl = slice(s * bbs + mine.start, s * bbs + mine.stop)
        xs = bx[sl].to(dev)
        cb = CodebookState(**st["cb"])
        res = {}
        with torch.no_grad():  # the step's codes, as its forward has them
            z_e = eng.model.encode(xs)
            _, idx = quantize(cb, z_e)
            res["codes"] = cpu(all_gather_rows(idx.reshape(len(xs), -1),
                                               bbs, eng.mesh).reshape(-1))
            if eng.mesh.world_size == 1:  # distances and their scale
                flat = z_e.reshape(-1, z_e.shape[-1]).float()
                sq, esq = (flat ** 2).sum(1, keepdim=True), \
                    (cb.embed ** 2).sum(1)
                res["dist"] = cpu(sq - 2.0 * flat @ cb.embed.T + esq)
                res["scale"] = cpu(sq + esq)
                res["z_e"] = cpu(z_e)
        cb, bank, met = eng.train_step(cb, st["bank"], xs,
                                       bmask[sl].to(dev),
                                       seeded_generator(dev, 42, 3, s),
                                       (mine.start, bbs))
        res.update(
            metrics={k: float(met[k]) for k in
                     ("loss", "rec", "vq", "q_mse", "perplex", "usage")},
            cb={k: cpu(v) for k, v in cb.as_dict().items()},
            bank=cpu(bank), grads=grads_of(eng),
            state={k: cpu(v) for k, v in eng.model.state_dict().items()})
        return res, {"cb": cb.as_dict(), "bank": bank}
    vq_step.initial = lambda eng: {
        "cb": cb0.to(dev).as_dict(),
        "bank": torch.zeros((eng.bank_size, int(bm["z_channels"])),
                            device=dev)}

    def check_plain(r, g, klr, params):
        loss_gap = float(((g["loss"] - r["loss"]).abs()
                          / r["loss"].abs().clamp_min(1e-30)).max())
        grad_gap = _p18_grad_gap(g["grads"], r["grads"])
        worst, buf = _p18_state_check(g["state"], r["state"], klr, params)
        ok = {"loss": loss_gap <= 1e-5, "grads": grad_gap <= P18_GRAD_GAP,
              "params": worst <= 2.0, "buffers": buf <= P18_STATE_ATOL}
        return {"loss_gap": loss_gap, "grad_gap": grad_gap,
                "worst_lr": worst, "buffer_excess": buf, "ok": ok}

    def check_vq(r, g, st):
        c = check_plain({"loss": torch.tensor([r["metrics"]["loss"]]),
                         **r}, {"loss": torch.tensor([g["metrics"]["loss"]]),
                                **g}, blr, vq_params)
        rc, gc = r["codes"], g["codes"]
        pos = torch.nonzero(gc != rc).flatten()
        d, scale = r["dist"], r["scale"]
        near = bool(((d[pos, gc[pos]] - d[pos, rc[pos]]).abs()
                     <= 1e-5 * scale[pos, rc[pos]]).all()
                    and len(pos) <= 1e-3 * len(rc))
        metric_gap = max(abs(g["metrics"][k] - r["metrics"][k])
                         / max(abs(r["metrics"][k]), 1e-30)
                         for k in ("loss", "rec", "vq", "q_mse"))
        hist = np.bincount(gc.numpy(), minlength=n_codes).astype(np.float64)
        p = hist / max(hist.sum(), 1.0)
        perplex = float(np.exp(-(p * np.log(p + 1e-12)).sum()))
        usage = float((hist > 0).mean())
        hist_gap = max(abs(g["metrics"]["perplex"] - perplex) / perplex,
                       abs(g["metrics"]["usage"] - usage))
        # one process's EMA update from the step's state on the
        # data-parallel codes (equal to its own when no code differs)
        want = ema_update(CodebookState(**{k: v.cpu() for k, v in
                                           st["cb"].items()}),
                          r["z_e"], gc.reshape(r["z_e"].shape[:-1]),
                          float(bm["ema_decay"]), float(bm["ema_eps"]))
        cb_x = max(_p18_excess(g["cb"][k], v, P18_STATE_RTOL)
                   for k, v in want.as_dict().items())
        bank_x = _p18_excess(g["bank"], r["bank"], P18_STATE_RTOL)
        c.update(flips=int(len(pos)), metric_gap=metric_gap,
                 hist_gap=hist_gap, cb_excess=cb_x, bank_excess=bank_x)
        c["ok"].update(codes=near, metrics=metric_gap <= 1e-5,
                       histogram=hist_gap <= 1e-5,
                       ema=cb_x <= P18_STATE_ATOL,
                       bank=bank_x <= P18_STATE_ATOL)
        return c

    specs = {"vae": (make_vae, vae_step, vae_engine_mod),
             "tf": (make_tf, tf_step, tf_engine_mod),
             "vq": (make_vq, vq_step, vq_engine_mod)}
    results = {}
    for kind, (make, step_fn, mod) in specs.items():
        ref, got, eng, states = run(kind, make, step_fn)
        ctl = {"grads": control(mod, "sum_gradients", unsummed, eng,
                                states[0], step_fn)}
        if kind == "vq":
            ctl["ema"] = control(vqvae_baseline_mod, "all_reduce_sum",
                                 lambda t, m: t, eng, states[0], step_fn)
            ctl["bank"] = control(vq_engine_mod, "all_reduce_sum",
                                  lambda t, m: t, eng, states[0], step_fn)
        results[kind] = (ref, got, ctl, states)
        del eng
    out["host_copies"] = {k: HOST_COPIES[k] - copies0[k]
                          for k in HOST_COPIES}
    if mesh.rank != 0:
        return out
    for kind, (ref, got, ctl, states) in results.items():
        if kind == "vq":
            steps = [check_vq(r, g, st) for r, g, st in
                     zip(ref, got, states)]
            ctl_ok = {k: check_vq(ref[0], v, states[0])["ok"][k]
                      for k, v in ctl.items()}
        else:
            klr, params = {"vae": (lr, vae_params),
                           "tf": (tlr, tf_params)}[kind]
            steps = [check_plain(r, g, klr, params)
                     for r, g in zip(ref, got)]
            ctl_ok = {k: check_plain(ref[0], v, klr, params)["ok"][k]
                      for k, v in ctl.items()}
        out[kind] = {"steps": steps,
                     "ok": all(all(s["ok"].values()) for s in steps),
                     "controls_failed": {k: not v for k, v in
                                         ctl_ok.items()}}
    return out


def _p18d(spec: dict, mesh, dev, written: set) -> dict:
    """18d: ``run_pipeline`` at world size 2 on the spatial preset at
    phase 6's depth (vae 1 epoch; codebook on the first 4,096 images'
    65,536 nodes; quality; transformer 1 epoch; generate; evaluate)."""
    import numpy as np

    from vqvae_tpu_torch.cli import run_pipeline
    from vqvae_tpu_torch.cli.pipeline import STAGES
    from vqvae_tpu_torch.config import load_config
    from vqvae_tpu_torch.ops.knn_select import fused_select
    from vqvae_tpu_torch.parallel import HOST_COPIES, barrier, is_primary
    from vqvae_tpu_torch.utils.latents import load_latents, save_latents

    root = Path(spec["d_root"])
    preset = ROOT / PRESET
    ov = pipeline_overrides(root)
    ov["vae"]["max_epochs"] = 1
    ov["transformer"]["training"]["epochs"] = 1
    exp = root / load_config(preset / "quality.yaml")["experiment"]
    run = exp / "vae" / "spatial_vae_fashionmnist"
    copies0 = dict(HOST_COPIES)
    root.mkdir(parents=True, exist_ok=True)
    first = run_pipeline(preset, skip=STAGES[1:], overrides=ov,
                         root_dir=root, device=dev)
    if is_primary():
        lat = load_latents(run / "latents_train")
        save_latents(ov["codebook"]["latents_path"],
                     *(lat[k][:CODEBOOK_IMAGES]
                       for k in ("z", "mu", "logvar", "y")))
    barrier(mesh)
    fused_select.launches = 0
    rest = run_pipeline(preset, skip=STAGES[:1], overrides=ov,
                        root_dir=root, device=dev)
    out = {"seconds": {**{k: v for k, v in first.items() if k != "total"},
                       **{k: v for k, v in rest.items() if k != "total"}},
           "k1_launches": fused_select.launches,
           "host_copies": {k: HOST_COPIES[k] - copies0[k]
                           for k in HOST_COPIES}}
    prefix = str(root.resolve()) + os.sep
    out["written"] = sorted(p for p in written if p.startswith(prefix))
    if mesh.rank == 0:
        codes = np.load(exp / "codebook" / "codes.npy")
        from scipy import sparse

        lcc = sparse.load_npz(exp / "codebook" /
                              "knn_graph_geodesic.npz").shape[0]
        out["codes_ok"] = bool(codes.shape == (CODEBOOK_IMAGES, 4, 4)
                               and (codes >= 0).sum() == lcc
                               and codes.min() >= -1 and codes.max() < 512)
        losses = []
        for path in (run / "metrics.jsonl",
                     exp / "transformer" / "metrics.jsonl"):
            for line in path.read_text().splitlines():
                row = json.loads(line)
                losses += [row["train_loss"], row["val_loss"]]
        out["losses_finite"] = bool(losses and np.isfinite(losses).all())
        out["tree"] = sorted(str(p.resolve()) for p in root.rglob("*")
                             if p.is_file())
    return out


def phase18_rank(spec_path: str) -> None:
    """A rank of phase 18 (started by ``launch_ranks``)."""
    spec = json.loads(Path(spec_path).read_text())
    sys.path.insert(0, str(ROOT))
    written: set = set()

    def audit(event, args):  # files this rank writes or renames into place
        if event == "open" and isinstance(args[0], (str, os.PathLike)):
            mode, flags = args[1], args[2] or 0
            if (any(c in mode for c in "wax+") if isinstance(mode, str)
                    else bool(flags & (os.O_WRONLY | os.O_RDWR))):
                written.add(os.path.realpath(os.fspath(args[0])))
        elif event == "os.rename":
            written.add(os.path.realpath(os.fsdecode(args[1])))

    sys.addaudithook(audit)
    import torch

    save = torch.save

    def recorded_save(obj, f, *a, **kw):  # torch writes a path from C++
        if isinstance(f, (str, os.PathLike)):
            written.add(os.path.realpath(os.fspath(f)))
        return save(obj, f, *a, **kw)

    torch.save = recorded_save
    from vqvae_tpu_torch.device import resolve_device
    from vqvae_tpu_torch.parallel import init_distributed

    dev = resolve_device(spec["device"])  # TF32 off
    rank = int(os.environ["RANK"])
    if spec["part"] == "a":
        out = _p18a_rank(spec, dev)
    else:
        mesh = init_distributed("gloo", device=dev)
        out = {"backend": mesh.backend, "world": mesh.world_size}
        t0 = time.perf_counter()
        out["b"] = _p18b(spec, mesh, dev)
        out["b"]["wall"] = time.perf_counter() - t0
        log(f"18b done in {out['b']['wall']:.3f}s")
        t0 = time.perf_counter()
        out["c"] = _p18c(spec, mesh, dev)
        out["c"]["wall"] = time.perf_counter() - t0
        log(f"18c done in {out['c']['wall']:.3f}s")
        t0 = time.perf_counter()
        out["d"] = _p18d(spec, mesh, dev, written)
        out["d"]["wall"] = time.perf_counter() - t0
        log(f"18d done in {out['d']['wall']:.3f}s")
    out_path = Path(spec["work"]) / f"{spec['label']}_rank{rank}.json"
    out_path.write_text(json.dumps(out))


def _p18c_report(ranks: list) -> None:
    """Log 18c's per-step gaps and controls (rank 0 checked them); fail on
    a step beyond its limits or a control that passed."""
    c = ranks[0]["c"]
    names = {"vae": "VAE", "tf": "transformer", "vq": "baseline"}
    for k in ("vae", "tf", "vq"):
        st = c[k]["steps"]
        gaps = ", ".join(f"{x['loss_gap']:.3e}" for x in st)
        log(f"18c {names[k]}: {P18_STEPS} steps, each from one process's "
            f"state, 2 ranks x half batch vs 1 x whole: loss gap by step "
            f"[{gaps}], gradients apart at most "
            f"{max(x['grad_gap'] for x in st):.3e} of their norm, "
            f"parameters apart at most "
            f"{max(x['worst_lr'] for x in st):.3f} lr"
            + (f", BatchNorm statistics beyond rtol {P18_STATE_RTOL:g} by "
               f"at most {max(x['buffer_excess'] for x in st):.3e}"
               if k == "vae" else "")
            + (f"; codes differing by step {[x['flips'] for x in st]} "
               f"(near-ties: {all(x['ok']['codes'] for x in st)}), "
               f"metrics {max(x['metric_gap'] for x in st):.3e} apart, "
               f"perplexity and usage {max(x['hist_gap'] for x in st):.3e} "
               f"from the codes' histogram, EMA codebook and bank beyond "
               f"rtol {P18_STATE_RTOL:g} by at most "
               f"{max(x['cb_excess'] for x in st):.3e} and "
               f"{max(x['bank_excess'] for x in st):.3e} of their largest "
               f"values" if k == "vq" else "")
            + f"; controls failed as they must: {c[k]['controls_failed']}")
        bad = [(i, [n for n, v in x["ok"].items() if not v])
               for i, x in enumerate(st) if not all(x["ok"].values())]
        if bad:
            fail(f"18c: the {names[k]} data-parallel steps differ from one "
                 f"process's (step, checks): {bad}")
        passed = [n for n, v in c[k]["controls_failed"].items() if not v]
        if passed:
            fail(f"18c: the {names[k]} controls {passed} passed the checks "
                 f"they must fail")
    log(f"18c step seconds by rank {[_fmt(r['c']['seconds']) for r in ranks]}"
        f" (one process {_fmt(c['seconds_one'])}); gloo host copies by rank "
        f"{[r['c']['host_copies'] for r in ranks]}; wall {c['wall']:.3f}s")


def phase_mesh(work: Path, exp6: Path, cut6: Path) -> dict:
    """Phase 18: the device mesh. 18a one NCCL rank on phase 6's graph;
    18b-d two gloo ranks sharing the card (see the module notes)."""
    p18 = work / "p18"
    t0 = time.perf_counter()
    a = launch_ranks(1, {
        "part": "a", "device": "cuda:0", "latents": str(cut6),
        "vae": str(exp6 / "vae" / "spatial_vae_fashionmnist" / "checkpoints"
                   / "best.pt")}, p18, "a")[0]
    t_a = time.perf_counter() - t0
    if a["differ"]:
        fail(f"18a: the one-rank NCCL group changed {a['differ']}")
    if a["k1_mesh"] <= 0:
        fail("18a: the sharded kNN launched no K1/K2 kernel")
    log(f"18a NCCL world 1 on {a['nodes']} nodes: kNN indices, lengths, "
        f"LCC, medoids, assignments, QE {a['qe']} and {P18_SOURCES}-source "
        f"distances bit for bit; K1 launches {a['k1_mesh']} (plain "
        f"{a['k1_plain']}); seconds plain {_fmt(a['seconds_plain'])}, "
        f"group {_fmt(a['seconds_mesh'])}; wall {t_a:.3f}s")

    t0 = time.perf_counter()
    main = work / "main"
    ranks = launch_ranks(P18_RANKS, {
        "part": "bcd", "device": "cuda:0",
        "b_latents": str(main / "latents"), "b_vae": str(main / "vae.pt"),
        "b_codebook": str(main / "codebook"),
        "d_root": str(p18 / "d")}, p18, "bcd")
    t_bcd = time.perf_counter() - t0
    r0 = ranks[0]
    b = r0["b"]
    if any(r["backend"] != "gloo" or r["world"] != P18_RANKS for r in ranks):
        fail("18b-d: expected a two-rank gloo group")
    if any(r["b"]["k1_launches"] <= 0 for r in ranks):
        fail("18b: a rank launched no K1/K2 kernel")
    if b["knn_near_ties"] != b["knn_rows_differ"] \
            or b["knn_rows_differ"] > 1e-3 * b["nodes"]:
        fail(f"18b: kNN rows differ beyond near-ties: "
             f"{b['knn_rows_differ']} rows, {b['knn_near_ties']} near-ties")
    if any(r["b"]["lengths_over_1e-6"] for r in ranks):
        fail(f"18b: lengths beyond rtol 1e-6 of phase 4's: "
             f"{b['lengths_over_1e-6']} (max {b['lengths_max_rel']})")
    for r in ranks:
        if not (r["b"]["medoids_equal"] and r["b"]["assign_equal"]
                and r["b"]["qe"] == r["b"]["qe_ref"]):
            fail(f"18b: medoids / assignments / QE differ from phase 4's "
                 f"(QE {r['b']['qe']} vs {r['b']['qe_ref']})")
    if not b["distances_equal"]:
        fail("18b: sharded distances differ from one process's")
    log(f"18b gloo x{P18_RANKS} on cuda:0, {b['nodes']} nodes: kNN rows "
        f"differing from one process {b['knn_rows_differ']} (near-ties "
        f"{b['knn_near_ties']}); {b['edges']} lengths on phase 4's graph, "
        f"max rel {b['lengths_max_rel']:.3e}; medoids, assignments, QE "
        f"{b['qe']} and {P18_SOURCES}-source distances identical; K1 "
        f"launches by rank {[r['b']['k1_launches'] for r in ranks]}; "
        f"seconds by rank {[_fmt(r['b']['seconds']) for r in ranks]}; "
        f"gloo host copies by rank "
        f"{[r['b']['host_copies'] for r in ranks]}; wall {b['wall']:.3f}s")

    _p18c_report(ranks)

    d = r0["d"]
    if ranks[1]["d"]["written"]:
        fail(f"18d: rank 1 wrote {ranks[1]['d']['written'][:5]}")
    missing = sorted(set(d["tree"]) - set(d["written"]))
    if missing:
        fail(f"18d: files not written by rank 0: {missing[:5]}")
    if not (d["codes_ok"] and d["losses_finite"]):
        fail(f"18d: codes ok {d['codes_ok']}, losses finite "
             f"{d['losses_finite']}")
    if any(r["d"]["k1_launches"] <= 0 for r in ranks):
        fail("18d: a rank's codebook stage launched no K1/K2 kernel")
    log(f"18d run_pipeline world {P18_RANKS}: {len(d['tree'])} files, each "
        f"written by rank 0 only; codes -1 only off the LCC; losses finite; "
        f"K1 launches by rank {[r['d']['k1_launches'] for r in ranks]}; "
        f"stage seconds by rank {[_fmt(r['d']['seconds']) for r in ranks]};"
        f" gloo host copies by rank {[r['d']['host_copies'] for r in ranks]};"
        f" wall {d['wall']:.3f}s")
    log(f"phase 18: 18a {t_a:.3f}s, 18b-d {t_bcd:.3f}s")
    return {"a": a, "b": b, "k1_launches": [r["b"]["k1_launches"]
                                            for r in ranks]}


def _fmt(secs: dict) -> str:
    return "{" + ", ".join(f"{k} {v:.3f}" for k, v in secs.items()) + "}"


def main() -> None:
    if len(sys.argv) > 2 and sys.argv[1] == "--phase18-rank":
        return phase18_rank(sys.argv[2])  # a rank that phase 18 started
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False; this smoke test runs on "
             "an NVIDIA GPU")
    if not (ROOT / "vqvae_tpu_torch" / "csrc" / "knn_select.cu").exists():
        fail(f"no vqvae_tpu_torch package next to {Path(__file__).name}; "
             f"run it from a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    from vqvae_tpu_torch.device import resolve_device

    t_start = time.perf_counter()
    resolve_device("cuda")  # TF32 off for matmuls and convolutions
    card = phase_device()
    phase_build()
    z = make_latents(N_NODES, D, seed=0)
    kernels, exact_i = phase_kernels(z)
    t0 = time.perf_counter()
    kernels.update(phase_kernels_assign_gather())
    log(f"K3/K4 kernel checks {time.perf_counter() - t0:.3f}s")
    work = ROOT / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    try:
        k1_launches, k2_launches, knn_s = phase_main_path(z, work)
        phase_reference(z, work)
        del z
        t0 = time.perf_counter()
        pipe = phase_pipeline(work / "pipeline")
        phase_train_step_reference()
        phase_transformer_reference()
        phase_quality_reference(pipe["exp"], pipe["quality"])
        k4_launches = phase_gather_min_tool()
        log(f"phases 6-9 {time.perf_counter() - t0:.3f}s")
        t0 = time.perf_counter()
        vanilla = phase_vanilla(work / "vanilla")
        log(f"phase 10 {time.perf_counter() - t0:.3f}s")
        t0 = time.perf_counter()
        phase_baseline(work / "baseline")
        phase_baseline_step_reference()
        log(f"phases 11-12 {time.perf_counter() - t0:.3f}s")
        t0 = time.perf_counter()
        phase_vae_epoch()
        log(f"phase 13 {time.perf_counter() - t0:.3f}s")
        t0 = time.perf_counter()
        phase_bf16(work / "bf16", pipe["exp"],
                   {"vae": pipe["steps_per_s"],
                    "transformer": pipe["transformer_steps_per_s"]})
        log(f"phase 14 {time.perf_counter() - t0:.3f}s")
        t0 = time.perf_counter()
        cut = work / "pipeline" / f"latents_train_{CODEBOOK_IMAGES}"
        phase_engines(pipe["exp"], cut)
        log(f"phase 15 {time.perf_counter() - t0:.3f}s")
        t0 = time.perf_counter()
        sliced = phase_slice(exact_i, knn_s, kernels["K1"]["ms"],
                             work / "pipeline", pipe["exp"], cut)
        log(f"phase 16 {time.perf_counter() - t0:.3f}s")
        t0 = time.perf_counter()
        cifar = phase_cifar(work, pipe["exp"], cut)
        kernels.update(cifar["b"])
        log(f"phase 17 {time.perf_counter() - t0:.3f}s")
        t0 = time.perf_counter()
        phase_mesh(work, pipe["exp"], cut)
        log(f"phase 18 {time.perf_counter() - t0:.3f}s")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    launches = {"K1": k1_launches, "K2": k2_launches,
                "K3": pipe["launches"]["K3"] + sliced["d"]["k3_launches"],
                f"K3@{K3_WIDE}": vanilla["launches"]["K3"],
                f"K1@{CIFAR_D}": cifar["a"]["launches"]["codebook"]["K1/K2"],
                f"K3@{CIFAR_D}": cifar["a"]["launches"]["quality"]["K3"],
                **{f"K4@{w}": k4_launches[w] for w in K4_WIDTHS}}
    entries = []
    for kid, name, source, replaces in (
            ("K1", "knn_select packed", "knn_select.cu",
             "vqvae_tpu/ops/pallas_knn.py:124"),
            ("K2", "knn_select unpacked", "knn_select.cu",
             "vqvae_tpu/ops/pallas_knn.py:58"),
            ("K3", "nearest-code assign", "assign.cu",
             "vqvae_tpu/ops/pallas_assign.py:33"),
            (f"K3@{K3_WIDE}", f"nearest-code assign D={K3_WIDE}",
             "assign.cu", "vqvae_tpu/ops/pallas_assign.py:33"),
            (f"K1@{CIFAR_D}", f"knn_select packed D={CIFAR_D}",
             "knn_select.cu", "vqvae_tpu/ops/pallas_knn.py:124"),
            (f"K3@{CIFAR_D}", f"nearest-code assign D={CIFAR_D}",
             "assign.cu", "vqvae_tpu/ops/pallas_assign.py:33"),
            *((f"K4@{w}", f"gather-min K={w}", "gather_min.cu",
               "tools/bench_pallas_gather.py:39") for w in K4_WIDTHS)):
        k = kernels[kid]
        entries.append({
            "name": f"{kid.split('@')[0]} {name}", "route": "cuda",
            "source": f"vqvae_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "launches": launches[kid], "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"],
            **{key: k[key] for key in ("device_ms", "host_ms", "k4_route")
               if key in k}})
    log(f"card {card}; total {time.perf_counter() - t_start:.3f}s")
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
