"""Metrics logging: CSV + JSONL always, MLflow when available — the port of
``vqvae_tpu/utils/logging.py``.

Every run directory gets ``metrics.csv``, ``metrics.jsonl`` and
``params.yaml``; when an ``mlflow`` installation and a tracking URI are
present, the same calls mirror into it (import-gated). Under a process
group only rank 0 writes; the other ranks' loggers record nothing.
"""
from __future__ import annotations

import csv
import json
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import yaml

from ..parallel.mesh import is_primary


class MetricsLogger:
    def __init__(
        self,
        out_dir: str | Path,
        run_name: str = "run",
        experiment_name: str = "default",
        tracking_uri: Optional[str] = None,
    ):
        self.out_dir = Path(out_dir)
        self.primary = is_primary()
        if self.primary:
            self.out_dir.mkdir(parents=True, exist_ok=True)
        self.run_name = run_name
        self._csv_path = self.out_dir / "metrics.csv"
        self._jsonl_path = self.out_dir / "metrics.jsonl"
        self._csv_fields: Optional[list] = None
        self._t0 = time.perf_counter()

        self._mlflow = None
        if tracking_uri and self.primary:
            try:
                import mlflow  # type: ignore
            except ImportError:
                mlflow = None
            if mlflow is not None:
                mlflow.set_tracking_uri(tracking_uri)
                mlflow.set_experiment(experiment_name)
                mlflow.start_run(run_name=run_name)
                self._mlflow = mlflow

    def log_params(self, params: Dict[str, Any]) -> None:
        if not self.primary:
            return
        with open(self.out_dir / "params.yaml", "w") as f:
            yaml.safe_dump({k: _plain(v) for k, v in params.items()}, f,
                           sort_keys=False)
        if self._mlflow:
            self._mlflow.log_params(params)

    def log_metrics(self, metrics: Dict[str, Any], step: int) -> None:
        if not self.primary:
            return
        row = {"step": step,
               "wall_time_s": round(time.perf_counter() - self._t0, 3)}
        row.update({k: _plain(v) for k, v in metrics.items()})
        if self._csv_fields is None:
            self._csv_fields = list(row.keys())
            with open(self._csv_path, "w", newline="") as f:
                csv.DictWriter(f, fieldnames=self._csv_fields).writeheader()
        with open(self._csv_path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._csv_fields,
                               extrasaction="ignore")
            w.writerow(row)
        with open(self._jsonl_path, "a") as f:
            f.write(json.dumps(row) + "\n")
        if self._mlflow:
            self._mlflow.log_metrics(
                {k: float(v) for k, v in metrics.items()
                 if isinstance(v, (int, float)) and not isinstance(v, bool)},
                step=step)

    def log_artifact(self, path: str | Path) -> None:
        if self._mlflow:
            self._mlflow.log_artifact(str(path))

    def end(self) -> None:
        if self._mlflow:
            self._mlflow.end_run()


def _plain(v: Any) -> Any:
    """numpy and 0-d tensor scalars as Python numbers (YAML/JSON-safe)."""
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    if hasattr(v, "item") and getattr(v, "ndim", None) == 0:
        return v.item()
    return v
