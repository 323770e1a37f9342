#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (vqvae_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device, ``nvcc`` and ``g++``; it exits non-zero (and
prints no result) without a GPU or outside a checkout of the repository.

Phases, each printed as it ends:
1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. the build of every native source of the slice, all started together:
   ``csrc/knn_select.cu`` (kernels K1/K2, nvcc for sm_90a) and the host
   graph library (g++);
3. each kernel against its plain PyTorch version on the card, TF32 off, at
   the codebook stage's shapes — 16,384 query rows against the full
   983,040-row database of ``bench.py``-style latents (seed 0), D=16,
   k_sel=29: K1 packed at bins 1024, K2 unpacked at bins 768. At most 1e-3
   of the rows may differ, only at near-ties (within 1e-5 relative of the
   plain version's k_sel-th value), and kNN recall after the exact re-rank
   against the exact route must be >= 0.999. Times: the kernel, the plain
   version and, as a yardstick, ``torch.cdist`` + ``torch.topk``;
4. the slice through its entry point ``build_codebook_main`` on the card at
   the full width of ``configs/fashionmnist/spatial/geodesic`` (VAE
   16 / 64-128-256 / 256-128-64, batch norm, 28 px; k=20 union approx;
   K=512 kpp_parallel seed 42; batch 4096) with seeded random weights
   written as a reference ``.pt`` and (61,440, 4, 4, 16) latents — 983,040
   nodes — then again on 40 images (640 nodes, effective bins 640), where
   the selection takes K2. Launch counts are zeroed before and read after
   each run;
5. the stage's output against its plain CPU run on a small input (256
   images): identical graph structure and off-LCC positions, edge lengths
   within rtol 1e-4 on all but 1e-3 of the edges (ReLU gates at rounding
   distance from their kink may flip between devices), QE within rtol
   1e-3;
6. one JSON line of per-kernel numbers, then the device line.
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
# int32, HBM bandwidth
PEAK_F32 = 67e12
PEAK_INT32 = 33.5e12
PEAK_BYTES = 3.35e12

N_NODES = 983_040
D = 16
K_SEL = 29           # k + 1 + margin 8 for the stage's k = 20
Q_ROWS = 16_384


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
    from vqvae_tpu_torch.ops import knn_select

    # one compiler per source, all started together; a failed build raises
    t0 = time.perf_counter()
    with ThreadPoolExecutor() as pool:
        builds = {name: pool.submit(fn) for name, fn in
                  (("knn_select.cu", knn_select.build),
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

    def library():
        for s in range(0, Q_ROWS, 1024):
            torch.topk(torch.cdist(zq[s:s + 1024], zd[:n_valid]), K_SEL,
                       dim=1, largest=False)

    library_ms = cuda_ms(library, 1)
    # least time for the same work: inputs read once and outputs written
    # once over HBM, or D+2 f32 multiply-adds per (query, row) pair on the
    # CUDA cores plus one top-2 compare (int32 keys packed, f32 unpacked)
    n_pairs = Q_ROWS * zd.shape[0]
    bytes_ms = (4 * (Q_ROWS + zd.shape[0]) * D + 8 * Q_ROWS * K_SEL) \
        / PEAK_BYTES * 1e3
    ops_ms = (2 * n_pairs * (D + 2) / PEAK_F32
              + n_pairs / (PEAK_INT32 if packed else PEAK_F32)) * 1e3
    log(f"{name}: rows differ {frac:.2e}, max |kernel - plain| {max_abs}, "
        f"recall {recall:.6f}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"cdist+topk {library_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.4f} "
        f"ms ({'bytes' if bytes_ms > ops_ms else 'operations'})")
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
    work = ROOT / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    try:
        k1_launches, k2_launches = phase_main_path(z, work)
        phase_reference(z, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    launches = {"K1": k1_launches, "K2": k2_launches}
    entries = []
    for kid, name, line in (("K1", "knn_select packed", 124),
                            ("K2", "knn_select unpacked", 58)):
        k = kernels[kid]
        entries.append({
            "name": f"{kid} {name}", "route": "cuda",
            "source": "vqvae_tpu_torch/csrc/knn_select.cu",
            "replaces": f"vqvae_tpu/ops/pallas_knn.py:{line}",
            "launches": launches[kid], "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"]})
    log(f"card {card}; total {time.perf_counter() - t_start:.3f}s")
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
