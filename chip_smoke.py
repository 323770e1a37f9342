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
     and medoid-like draws of the same latents) and at a ragged 1,037 x 5
     against 130: at most 1e-4 of the rows may differ, only at near-ties
     (exact distances within 1e-5 relative), and distances within 1e-5
     relative. Yardstick: ``(|c|^2 - 2 z c^T).min(1)``. At 160,000 rows
     also one call's device time by kernel (``torch.profiler``: the prep
     launch and the main kernel) and the wrapper's host time per call;
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
6. the pipeline vae -> codebook -> quality through its entry points:
   ``train_vae_main`` on the preset ``vae.yaml`` at full width (batch 256,
   the synthetic 60,000 / 10,000 split) for 2 epochs, ``build_codebook_main``
   on the first 4,096 images of its ``latents_train`` (65,536 nodes) reading
   the VAE through the preset's ``.../checkpoints/best`` path, and the three
   quality evaluators on the full val split, with every launch count
   zeroed before and read after. Every artifact must exist, the val loss
   be finite and K3 have launched;
7. the new path on the card against the CPU: one train step on the same
   batch and noise (loss within rtol 1e-5; each gradient tensor within
   2e-3 of its norm; at least 99 % of the parameters within rtol 1e-4 and
   all within one Adam step, 2 lr, of the CPU's: where a gradient sits at
   rounding distance from 0, Adam's first step may take either sign). A
   control runs the card's step again with TF32 matmuls and convolutions
   and must fail the gradient limit. Then the quality evaluators on the
   same artifacts (codes identical except at near-ties, PSNRs within
   1e-3 dB);
8. the gather-min tool through its entry point at its default shapes, its
   K4 launches counted per width and per route (the scan route must run);
9. one JSON line of per-kernel numbers, then the device line.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

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
# card vs CPU train step: largest gradient difference, as a share of its
# tensor's norm. On an H100, full f32 reads 4.65e-4 and the same step with
# TF32 convolutions 1.14e-2; the limit sits between them.
GRAD_LIMIT = 2e-3


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
    (``torch.profiler``), largest first."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sorted(
        ((ev.key.replace("void ", "").replace("(anonymous namespace)::",
                                              "").split("(")[0],
          ev.device_time_total / 1e3 / calls)
         for ev in prof.key_averages() if ev.device_time_total > 0),
        key=lambda kv: -kv[1])


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
    # least time for the same work: inputs read once and outputs written
    # once over HBM, or the D-term product of every (query, row) pair on
    # the tensor cores at f32-equivalent precision (three TF32 passes) plus
    # one top-2 compare on the CUDA cores (int32 keys packed, f32
    # unpacked). The first version's bound put the D+2 multiply-adds on the
    # CUDA cores in f32; it is printed beside the new one.
    n_pairs = Q_ROWS * zd.shape[0]
    compare_ms = n_pairs / (PEAK_INT32 if packed else PEAK_F32) * 1e3
    bytes_ms = (4 * (Q_ROWS + zd.shape[0]) * D + 8 * Q_ROWS * K_SEL) \
        / PEAK_BYTES * 1e3
    ops_ms = 3 * 2 * n_pairs * D / PEAK_TF32 * 1e3 + compare_ms
    cuda_core_ms = 2 * n_pairs * (D + 2) / PEAK_F32 * 1e3 + compare_ms
    log(f"{name}: rows differ {frac:.2e}, max |kernel - plain| {max_abs}, "
        f"recall {recall:.6f}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"cdist+topk {library_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.4f} "
        f"ms ({'bytes' if bytes_ms > ops_ms else 'operations'}; CUDA-core "
        f"f32 bound {max(bytes_ms, cuda_core_ms):.4f} ms){extra}")
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
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
    return out


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
    return k1_launches, k2_launches


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


def near_tie_rows(z, cb, idx, ref_idx, rel: float = 1e-5) -> int:
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
            fail(f"K3: a row differs beyond a near-tie (relative gap "
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
    gen = torch.Generator(device="cuda").manual_seed(0)
    for k in K4_WIDTHS:
        out[f"K4@{k}"] = check_gather_min(k, gen, route="scan")
        torch.cuda.empty_cache()
    check_gather_min(K4_WIDTHS[-1], gen, rows=K4_SPARSE_ROWS, route="scan")
    check_gather_min(K4_WIDTHS[-1], gen, rows=K4_FEW_ROWS, route="gather")
    torch.cuda.empty_cache()
    return out


def pipeline_configs(work: Path):
    """The preset's vae and codebook configs pointing under ``work`` (the
    experiment layout the preset uses); no dataset files, so the VAE
    trains on the synthetic 60,000 / 10,000 split."""
    from vqvae_tpu_torch.config import load_config

    exp = work / "experiments" / "fashionmnist" / "spatial" / "geodesic"
    vae = load_config(ROOT / PRESET / "vae.yaml", {
        "max_epochs": PIPELINE_EPOCHS, "out_dir": str(exp / "vae"),
        "data": {"root": str(work / "no-data")}})
    run = exp / "vae" / "spatial_vae_fashionmnist"
    codebook = load_config(ROOT / PRESET / "codebook.yaml", {
        "latents_path": str(work / f"latents_train_{CODEBOOK_IMAGES}"),
        "vae_ckpt_path": str(run / "checkpoints" / "best"),
        "out_dir": str(exp / "codebook")})
    return exp, run, vae, codebook


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

    files = sorted(exp.glob("vae/*/vae_quality_assessment.json")) + [
        exp / "evaluation" / "quantization_analysis.json",
        exp / "evaluation" / "codebook_health.json"]
    missing = [str(f) for f in files if not f.exists()]
    if len(files) != 3 or missing:
        fail(f"quality outputs missing: {missing or 'vae assessment'}")
    return {f.name: _json.loads(f.read_text()) for f in files}


def phase_pipeline(work: Path):
    """vae -> codebook -> quality through the entry points; returns the
    experiment dir, the launches, seconds per stage and the training
    rate."""
    import json as _json

    import numpy as np

    from vqvae_tpu_torch.cli import (build_codebook_main, run_quality_stage,
                                     train_vae_main)
    from vqvae_tpu_torch.utils.latents import load_latents, save_latents

    exp, run, vae_cfg, cb_cfg = pipeline_configs(work)
    zero_launches()
    t0 = time.perf_counter()
    out = train_vae_main(vae_cfg, device="cuda")
    t_vae = time.perf_counter() - t0
    if out != run:
        fail(f"VAE run landed in {out}, expected {run}")
    lat = load_latents(run / "latents_train")
    save_latents(cb_cfg["latents_path"],
                 *(lat[k][:CODEBOOK_IMAGES]
                   for k in ("z", "mu", "logvar", "y")))
    t0 = time.perf_counter()
    build_codebook_main(cb_cfg, device="cuda")
    t_codebook = time.perf_counter() - t0
    t0 = time.perf_counter()
    rc = run_quality_stage(exp, dataset="fashionmnist", device="cuda")
    t_quality = time.perf_counter() - t0
    launches = read_launches()

    for path in (run / "checkpoints" / "best.pt",
                 run / "checkpoints" / "latest.pt",
                 run / "latents_train" / "latents.npz",
                 run / "latents_val" / "latents.npz",
                 run / "recon_grid.png", run / "metrics.jsonl",
                 exp / "codebook" / "codebook.npz",
                 exp / "codebook" / "codebook.pt",
                 exp / "codebook" / "codes.npy",
                 exp / "codebook" / "knn_graph_geodesic.npz"):
        if not path.exists():
            fail(f"pipeline artifact {path} missing")
    quality = quality_outputs(exp)
    rows = [_json.loads(line) for line in
            (run / "metrics.jsonl").read_text().splitlines()]
    val_loss = rows[-1]["val_loss"]
    if len(rows) != PIPELINE_EPOCHS or not np.isfinite(val_loss):
        fail(f"VAE training: {len(rows)} epochs, final val loss {val_loss}")
    if launches["K3"] <= 0:
        fail("the quality stage launched no K3 kernel")
    rates = [r["train_steps"] / r["train_seconds"] for r in rows]
    codes = np.load(exp / "codebook" / "codes.npy")
    shown = ("psnr", "ssim", "quality", "health", "entropy", "used")
    summary = "; ".join(
        name + ": " + ", ".join(f"{k} {v}" for k, v in q.items()
                                if k.startswith(shown))
        for name, q in quality.items())
    rate_text = ", ".join(f"{r:.2f}" for r in rates)
    log(f"pipeline: vae {t_vae:.3f}s ({PIPELINE_EPOCHS} epochs, "
        f"{rows[-1]['train_steps']} steps each, steps/s per epoch "
        f"{rate_text}; final val loss {val_loss}, psnr "
        f"{rows[-1]['val_psnr']}), codebook {t_codebook:.3f}s ({codes.size} "
        f"nodes), quality {t_quality:.3f}s (gate rc {rc}; {summary}); "
        f"launches {launches}")
    return {"exp": exp, "launches": launches, "quality": quality,
            "seconds": {"vae": t_vae, "codebook": t_codebook,
                        "quality": t_quality},
            "steps_per_s": rates, "val_loss": val_loss}


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


def main() -> None:
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
    kernels = phase_kernels(z)
    t0 = time.perf_counter()
    kernels.update(phase_kernels_assign_gather())
    log(f"K3/K4 kernel checks {time.perf_counter() - t0:.3f}s")
    work = ROOT / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    try:
        k1_launches, k2_launches = phase_main_path(z, work)
        phase_reference(z, work)
        del z
        t0 = time.perf_counter()
        pipe = phase_pipeline(work / "pipeline")
        phase_train_step_reference()
        phase_quality_reference(pipe["exp"], pipe["quality"])
        k4_launches = phase_gather_min_tool()
        log(f"phases 6-8 {time.perf_counter() - t0:.3f}s")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    launches = {"K1": k1_launches, "K2": k2_launches,
                "K3": pipe["launches"]["K3"],
                **{f"K4@{w}": k4_launches[w] for w in K4_WIDTHS}}
    entries = []
    for kid, name, source, replaces in (
            ("K1", "knn_select packed", "knn_select.cu",
             "vqvae_tpu/ops/pallas_knn.py:124"),
            ("K2", "knn_select unpacked", "knn_select.cu",
             "vqvae_tpu/ops/pallas_knn.py:58"),
            ("K3", "nearest-code assign", "assign.cu",
             "vqvae_tpu/ops/pallas_assign.py:33"),
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
