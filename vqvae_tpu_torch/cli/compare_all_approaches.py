"""Aggregate and compare the metrics of several approaches' runs.

The port of ``scripts/compare_all_approaches.py``, without pandas: the
same tolerant loader over each run's result files (``metrics.yaml``,
``evaluation_results.json``, ``codebook_health.json``,
``quantization_analysis.json``, under ``<dir>/evaluation`` and ``<dir>``),
the same key normalization into six columns (psnr, ssim, lpips, entropy,
used_codes, usage_percent; a missing one is NaN), and the same outputs in
``--out_dir``: ``comparison_table.csv`` (pandas' layout: the index column
unnamed, floats by ``repr``, NaN empty) and ``comparison_report.md`` (the
table, then the best-PSNR and best-LPIPS lines). ``main`` also draws
JAX's two charts (``comparison_charts.png``, ``entropy_vs_psnr.png``;
matplotlib). The default approaches are JAX's four.

Run: ``python -m vqvae_tpu_torch.cli.compare_all_approaches
[--approaches name=path ...] [--out_dir experiments/comparison]``.
"""
from __future__ import annotations

import argparse
import json
import math
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import yaml

COLUMNS = ("psnr", "ssim", "lpips", "entropy", "used_codes",
           "usage_percent")
DEFAULT_APPROACHES = (
    ("euclidean_k512", "experiments/fashionmnist/spatial/euclidean"),
    ("geodesic_k512", "experiments/fashionmnist/spatial/geodesic"),
    ("vanilla_euclidean", "experiments/fashionmnist/vanilla/euclidean"),
    ("baseline_vqvae", "experiments/baseline_vqvae"),
)

Table = Dict[str, Dict[str, float]]


def load_results(approach_dir: Path) -> Dict[str, float]:
    """Every numeric result of a run: ``metrics.yaml`` keys upper-cased,
    the JSON files' numbers kept under their own names (first found)."""
    out: Dict[str, float] = {}
    for cand in (approach_dir / "evaluation", approach_dir):
        my = cand / "metrics.yaml"
        if my.exists():
            data = yaml.safe_load(my.read_text()) or {}
            for k, v in data.items():
                if v is not None:
                    try:
                        out[k.upper()] = float(v)
                    except (TypeError, ValueError):
                        pass
        for name in ("evaluation_results.json", "codebook_health.json",
                     "quantization_analysis.json"):
            p = cand / name
            if p.exists():
                for k, v in json.loads(p.read_text()).items():
                    if isinstance(v, (int, float)):
                        out.setdefault(k, float(v))
    return out


def extract_metrics(results: Dict[str, float]) -> Dict[str, float]:
    """The comparison's six columns from a run's results (NaN if absent)."""
    def pick(*keys):
        for k in keys:
            if k in results:
                return results[k]
        return math.nan

    return {
        "psnr": pick("PSNR", "recon_psnr", "psnr_continuous_vs_quantized",
                     "psnr_db"),
        "ssim": pick("SSIM", "recon_ssim", "ssim_continuous_vs_quantized"),
        "lpips": pick("LPIPS", "lpips"),
        "entropy": pick("entropy"),
        "used_codes": pick("used_codes"),
        "usage_percent": pick("usage_percent"),
    }


def _present(table: Table, col: str) -> List[Tuple[str, float]]:
    return [(name, row[col]) for name, row in table.items()
            if not math.isnan(row[col])]


def best(table: Table, col: str, lowest: bool = False
         ) -> Optional[Tuple[str, float]]:
    """The first row with the column's max (min with ``lowest``), NaN
    skipped, as pandas' ``idxmax`` / ``idxmin``; None when all are NaN."""
    vals = _present(table, col)
    if not vals:
        return None
    target = (min if lowest else max)(v for _, v in vals)
    return next((n, v) for n, v in vals if v == target)


def write_csv(table: Table, path: Path) -> None:
    lines = ["," + ",".join(COLUMNS)]
    for name, row in table.items():
        lines.append(name + "," + ",".join(
            "" if math.isnan(row[c]) else repr(float(row[c]))
            for c in COLUMNS))
    path.write_text("\n".join(lines) + "\n")


def markdown_table(table: Table) -> str:
    head = "| | " + " | ".join(COLUMNS) + " |"
    rule = "|---|" + "---:|" * len(COLUMNS)
    rows = ["| " + name + " | " + " | ".join(
        "nan" if math.isnan(row[c]) else f"{row[c]:g}" for c in COLUMNS)
        + " |" for name, row in table.items()]
    return "\n".join([head, rule, *rows])


def summary_lines(table: Table) -> List[str]:
    lines = []
    top = best(table, "psnr")
    if top is not None:
        lines.append(f"**Best PSNR:** {top[0]} ({top[1]:.2f} dB)")
    top = best(table, "lpips", lowest=True)
    if top is not None:
        lines.append(f"**Best LPIPS:** {top[0]} ({top[1]:.4f})")
    return lines


def run(approaches: Sequence[Tuple[str, str]] = DEFAULT_APPROACHES,
        out_dir="experiments/comparison") -> Optional[Table]:
    """Load each approach's results and write the table and the report;
    returns the table (None when no approach directory exists)."""
    table: Table = {}
    for name, path in approaches:
        p = Path(path)
        if not p.exists():
            print(f"[compare] {name}: {path} missing, skipping")
            continue
        table[name] = extract_metrics(load_results(p))
    if not table:
        print("[compare] nothing to compare")
        return None
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    write_csv(table, out / "comparison_table.csv")
    md = markdown_table(table)
    print(md)
    (out / "comparison_report.md").write_text("\n".join(
        ["# Approach comparison", "", md, "", *summary_lines(table)]) + "\n")
    return table


def plot(table: Table, out_dir) -> None:
    """JAX's bar charts of the four metrics and the entropy-vs-PSNR
    scatter (matplotlib)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    out = Path(out_dir)
    metrics = [c for c in ("psnr", "ssim", "lpips", "entropy")
               if _present(table, c)]
    fig, axes = plt.subplots(1, max(len(metrics), 1),
                             figsize=(4 * max(len(metrics), 1), 4))
    axes = axes if len(metrics) > 1 else [axes]
    for ax, metric in zip(axes, metrics):
        names, vals = zip(*_present(table, metric))
        ax.bar(names, vals)
        ax.set_title(metric.upper())
        ax.tick_params(axis="x", rotation=45)
    fig.tight_layout()
    fig.savefig(out / "comparison_charts.png", dpi=120)
    plt.close(fig)

    both = [n for n, r in table.items()
            if not (math.isnan(r["entropy"]) or math.isnan(r["psnr"]))]
    if both:
        fig, ax = plt.subplots(figsize=(5, 4))
        ax.scatter([table[n]["entropy"] for n in both],
                   [table[n]["psnr"] for n in both])
        for n in both:
            ax.annotate(n, (table[n]["entropy"], table[n]["psnr"]),
                        fontsize=8)
        ax.set_xlabel("codebook entropy")
        ax.set_ylabel("PSNR (dB)")
        fig.tight_layout()
        fig.savefig(out / "entropy_vs_psnr.png", dpi=120)
        plt.close(fig)


def main(argv=None) -> Optional[Table]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--approaches", nargs="+", default=None,
                    help="name=path pairs; defaults to the standard four")
    ap.add_argument("--out_dir", type=str, default="experiments/comparison")
    args = ap.parse_args(argv)
    pairs = ([tuple(a.split("=", 1)) for a in args.approaches]
             if args.approaches else DEFAULT_APPROACHES)
    table = run(pairs, args.out_dir)
    if table is not None:
        plot(table, args.out_dir)
        print(f"[compare] wrote {args.out_dir}/comparison_table.csv, "
              f"charts, report")
    return table


if __name__ == "__main__":
    main()
