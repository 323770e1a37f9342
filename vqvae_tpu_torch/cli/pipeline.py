"""The six-stage pipeline orchestrator — the port of
``vqvae_tpu/cli/pipeline.py`` and of ``scripts/run_pipeline.py``'s flags.

One config-driven orchestrator runs the stages in process, in the order
vae -> codebook -> quality -> transformer -> generate -> evaluate, each
from ``<preset>/<stage>.yaml`` (a stage without a YAML is not
configured). The artifact contract between stages is the files under the
preset's ``experiments/...`` paths, relative to ``root_dir``, where the
run ``chdir``s for its duration. A failing stage aborts the run unless it
is in ``NON_CRITICAL`` (the quality gates and the final evaluation, as the
reference's ``critical=False`` steps): those print the traceback and go
on, so a caller that needs their outputs checks the files. Per-stage wall
seconds are returned and, when ``VQVAE_TPU_TIMINGS_PATH`` is set, written
there as JSON with the run's ``programs_compiled`` and ``compile_seconds``
(the port's native builds, ``utils.profiling.CompileStats``), which each
stage's line also prints. Each stage runs inside ``profile_trace(stage)``:
with ``VQVAE_TPU_PROFILE_DIR`` set, a ``torch.profiler`` Chrome trace of
the stage lands in ``<dir>/<stage>/trace.json``.

The codebook stage dispatches on the config's ``builder``: ``spatial``
(``build_codebook.py``), or ``legacy`` / ``legacy_riemannian``
(``build_codebook_legacy.py``, the vanilla presets' flat latents); a
reference-style config without the key implies one (``codebook_builder``).

``run_baseline_pipeline`` runs the end-to-end EMA VQ-VAE baseline: train,
then evaluate, in process (``scripts/run_baseline_pipeline.py`` runs the
two scripts as subprocesses).

Several cards: ``torchrun --nproc-per-node <cards> -m
vqvae_tpu_torch.cli.pipeline --preset ...`` joins one process group
(``parallel.init_distributed``: ``nccl``, or ``--dist-backend gloo`` to
put several ranks on one card with ``--device cuda:0``; the stage CLIs
alone take ``nccl`` on cards, ``gloo`` with ``--device cpu``). The VAE,
spatial codebook and transformer stages (and the baseline's training) run
on every rank, sharded; the stages that take no mesh in JAX (quality,
generate, evaluate, the legacy builders, the baseline's evaluation) run
on rank 0 while the others wait; a barrier closes every stage, and rank 0
alone writes. Without ``torchrun`` nothing changes.

Run: ``python -m vqvae_tpu_torch.cli.pipeline --preset <dir> [--skip-vae
...] [--timings-out <json>] [--device cpu]``, or for the baseline
``python -m vqvae_tpu_torch.cli.pipeline --baseline <config.yaml>
[--skip-train] [--epochs N] [--device cpu]``.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from pathlib import Path
from typing import Dict, Iterable, Optional

from ..config import Config, load_config
from ..device import resolve_device
from ..parallel.mesh import barrier, init_distributed, is_primary
from ..utils.profiling import CompileStats, profile_trace

STAGES = ("vae", "codebook", "quality", "transformer", "generate", "evaluate")
NON_CRITICAL = {"quality", "evaluate"}
# stages that take a mesh (JAX's sharded stages); the rest run on rank 0
SHARDED_STAGES = {"vae", "codebook", "transformer"}


def _stage_config(config_dir: Path, stage: str,
                  overrides: Optional[Dict] = None) -> Optional[Config]:
    path = config_dir / f"{stage}.yaml"
    if not path.exists():
        return None
    return load_config(path, overrides=(overrides or {}).get(stage))


def codebook_builder(cfg: Config) -> str:
    """The builder a codebook config names, or the one a reference-style
    config implies."""
    builder = cfg.get("builder")
    if builder is None:
        if "riemannian" in cfg:
            return "legacy_riemannian"
        return "legacy" if "model" in cfg else "spatial"
    return str(builder)


def _sharded(stage: str, cfg: Config) -> bool:
    """True for a stage every rank runs (the spatial codebook builder
    takes a mesh; the legacy builders do not)."""
    return stage in SHARDED_STAGES and not (
        stage == "codebook" and codebook_builder(cfg) != "spatial")


def _run_stage(stage: str, cfg: Config, device) -> None:
    from . import (build_codebook_legacy_main, build_codebook_main,
                   evaluate_model_main, generate_samples_main,
                   run_quality_stage, train_transformer_main, train_vae_main)

    if stage == "vae":
        train_vae_main(cfg, device=device)
    elif stage == "codebook":
        builder = codebook_builder(cfg)
        if builder == "spatial":
            build_codebook_main(cfg, device=device)
        else:
            build_codebook_legacy_main(
                cfg, riemannian=(builder == "legacy_riemannian"),
                device=device)
    elif stage == "quality":
        rc = run_quality_stage(str(cfg["experiment"]),
                               dataset=str(cfg.get("dataset",
                                                   "fashionmnist")),
                               synthetic_size=cfg.get("synthetic_size"),
                               device=device)
        if rc != 0:
            print("[pipeline] VAE quality gate recommends RETRAIN "
                  "(continuing: non-critical)")
    elif stage == "transformer":
        train_transformer_main(cfg, device=device)
    elif stage == "generate":
        generate_samples_main(cfg, device=device)
    elif stage == "evaluate":
        evaluate_model_main(cfg, device=device)


def run_pipeline(
    config_dir: str | Path,
    skip: Iterable[str] = (),
    overrides: Optional[Dict] = None,
    root_dir: str | Path = ".",
    device=None,
    dist_backend: Optional[str] = None,
) -> Dict[str, float]:
    """Run every configured stage under ``config_dir`` on ``device``
    (default the GPU; raises when CUDA is absent and no device is given);
    ``overrides`` maps a stage to a dict deep-merged into its YAML. Returns
    per-stage wall seconds and ``total``. Under ``torchrun`` the ranks
    join one process group (``dist_backend``, default ``nccl`` on cards)
    and run the stages as the module notes say."""
    mesh = init_distributed(dist_backend, device=device)
    dev = resolve_device(device)
    config_dir = Path(config_dir).resolve()
    if not config_dir.is_dir():
        raise FileNotFoundError(f"preset directory not found: {config_dir}")
    if not any((config_dir / f"{s}.yaml").exists() for s in STAGES):
        raise FileNotFoundError(
            f"{config_dir} contains no stage configs "
            f"({', '.join(s + '.yaml' for s in STAGES)})")
    skip = set(skip)
    timings: Dict[str, float] = {}
    t_total = time.perf_counter()
    compiles = CompileStats.install()
    c_total = compiles.snapshot()
    prev_cwd = os.getcwd()
    os.chdir(root_dir)
    try:
        for stage in STAGES:
            if stage in skip:
                print(f"[pipeline] skipping {stage}")
                continue
            cfg = _stage_config(config_dir, stage, overrides)
            if cfg is None:
                print(f"[pipeline] no {stage}.yaml — stage not configured")
                continue
            print(f"[pipeline] === stage: {stage} ===")
            t0 = time.perf_counter()
            c0 = compiles.snapshot()
            try:
                if _sharded(stage, cfg) or is_primary():
                    with profile_trace(stage):
                        _run_stage(stage, cfg, dev)
            except Exception:
                traceback.print_exc()
                if stage not in NON_CRITICAL:
                    raise
                print(f"[pipeline] non-critical stage {stage} failed; "
                      f"continuing")
            barrier(mesh)  # the stage's writes are done on every rank
            timings[stage] = time.perf_counter() - t0
            dc = compiles.delta(c0)
            print(f"[pipeline] {stage} done in {timings[stage]:.1f}s "
                  f"({dc['programs']} programs compiled, "
                  f"{dc['compile_seconds']}s compiling)")
    finally:
        os.chdir(prev_cwd)

    timings["total"] = time.perf_counter() - t_total
    dt = compiles.delta(c_total)
    print(f"[pipeline] TOTAL: {timings['total']:.1f}s "
          f"({ {k: round(v, 1) for k, v in timings.items()} }); "
          f"{dt['programs']} programs compiled, {dt['compile_seconds']}s "
          f"compiling")
    timings_path = os.environ.get("VQVAE_TPU_TIMINGS_PATH")
    if timings_path and is_primary():
        with open(timings_path, "w") as f:
            json.dump({**timings, "programs_compiled": dt["programs"],
                       "compile_seconds": dt["compile_seconds"]}, f,
                      indent=2)
    return timings


def run_baseline_pipeline(config: str | Path, skip_train: bool = False,
                          epochs: Optional[int] = None,
                          device=None,
                          dist_backend: Optional[str] = None
                          ) -> Dict[str, float]:
    """The EMA VQ-VAE baseline from its config file: train (``epochs``
    overrides ``train.epochs``), then evaluate, in process, on ``device``
    (default the GPU; raises when CUDA is absent and no device is given).
    Returns wall seconds by step and ``total``. Under ``torchrun`` the
    training runs data-parallel on every rank and rank 0 evaluates."""
    from .evaluate_baseline import evaluate_baseline_main
    from .train_baseline_vqvae import train_baseline_main

    mesh = init_distributed(dist_backend, device=device)
    dev = resolve_device(device)
    overrides = {"train": {"epochs": epochs}} if epochs is not None else None
    cfg = load_config(config, overrides=overrides)
    timings: Dict[str, float] = {}
    t_total = time.perf_counter()
    if not skip_train:
        t0 = time.perf_counter()
        train_baseline_main(cfg, device=dev)
        timings["train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if is_primary():
        evaluate_baseline_main(cfg, device=dev)
    barrier(mesh)
    timings["evaluate"] = time.perf_counter() - t0
    timings["total"] = time.perf_counter() - t_total
    print(f"[baseline] TOTAL: {timings['total']:.1f}s "
          f"({ {k: round(v, 1) for k, v in timings.items()} })")
    return timings


def main(argv=None) -> Dict[str, float]:
    parser = argparse.ArgumentParser(
        description="Run the pipeline's stages, or the EMA VQ-VAE "
                    "baseline (PyTorch port).")
    which = parser.add_mutually_exclusive_group(required=True)
    which.add_argument("--preset",
                       help="configs/<dataset>/<variant>/<distance> "
                            "directory")
    which.add_argument("--baseline", metavar="CONFIG",
                       help="the baseline's config (e.g. configs/"
                            "baseline_vqvae/config.yaml): train, then "
                            "evaluate")
    parser.add_argument("--skip-train", action="store_true",
                        help="baseline: evaluate the existing checkpoint")
    parser.add_argument("--epochs", type=int, default=None,
                        help="baseline: override train.epochs")
    for stage in STAGES:
        parser.add_argument(f"--skip-{stage}", action="store_true")
    # the reference's flag names
    parser.add_argument("--skip-generation", action="store_true",
                        dest="skip_generate")
    parser.add_argument("--skip-evaluation", action="store_true",
                        dest="skip_evaluate")
    parser.add_argument("--timings-out", default=None,
                        help="write per-stage wall seconds as JSON here")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; under torchrun "
                             "the rank's card)")
    parser.add_argument("--dist-backend", default=None,
                        choices=("nccl", "gloo"),
                        help="process-group backend under torchrun "
                             "(default: nccl on cards, gloo on the CPU)")
    args = parser.parse_args(argv)
    if args.baseline:
        timings = run_baseline_pipeline(args.baseline,
                                        skip_train=args.skip_train,
                                        epochs=args.epochs,
                                        device=args.device,
                                        dist_backend=args.dist_backend)
    else:
        skip = {s for s in STAGES if getattr(args, f"skip_{s}")}
        timings = run_pipeline(args.preset, skip=skip, device=args.device,
                               dist_backend=args.dist_backend)
    if args.timings_out and is_primary():
        with open(args.timings_out, "w") as f:
            json.dump(timings, f, indent=2)
    return timings


if __name__ == "__main__":
    main()
