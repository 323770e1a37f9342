"""The program's spans and counters (``utils/profiling.py``) and the
benchmark's readers of them, on the CPU profiler.

- with no profiler session a span is the shared null context, a training
  step and a small codebook build record no rows, and the build's
  ``timings_s`` still holds every step;
- under ``torch.profiler`` the spans nest with the right parents: one
  ``train_step`` a step, each BatchNorm's forward and backward once a
  step, the build's steps under its root, the Riemannian chunks' gathers
  and products and k-medoids' passes and samples once each, ELL's sweeps
  counted;
- every row lies inside the profiler's own row of its name, within 50 us
  (one clock);
- the CSR + LCC step's four parts add up to its ``lcc`` seconds;
- the graph's write counts the pieces its pool compressed, one a member
  of the build's small graph, and each piece of a graph cut small;
- ``KMED_STATS`` takes its pass and sample seconds from the spans;
- each new reader of ``portbench/metrics/`` returns its number from a
  synthetic table and ``info``, and None without its source; the tools
  that measure the spans' cost (``tools/span_cost.py``,
  ``portbench/tools/traced_cost.py``) run at a small size.
"""
import zipfile
from collections import Counter, defaultdict
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy import sparse
from torch.profiler import ProfilerActivity, profile

from portbench import harness
from vqvae_tpu_torch.cli.build_codebook import (build_codebook_main,
                                                load_codebook)
from vqvae_tpu_torch.config import Config
from vqvae_tpu_torch.models import VAE
from vqvae_tpu_torch.ops import kmedoids
from vqvae_tpu_torch.ops.ell import (BucketedGraph,
                                     multi_source_shortest_paths_ell)
from vqvae_tpu_torch.train.vae_engine import VAEEngine, seeded_generator
from vqvae_tpu_torch.utils import npz, profiling
from vqvae_tpu_torch.utils.checkpoint import save_checkpoint
from vqvae_tpu_torch.utils.latents import save_latents

REPO = Path(__file__).resolve().parents[1]
ENC, DEC, LATENT = (8, 16, 32), (32, 16, 8), 8
NORMS = 5  # three in the encoder, two in the decoder
BATCH, STEPS, EVAL_STEPS = 8, 3, 2
LCC_PARTS = ("csr", "components", "subgraph", "graph_write")
SLACK_NS = 50_000


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _empty_table():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def _model():
    return VAE(in_channels=1, enc_channels=ENC, dec_channels=DEC,
               latent_dim=LATENT, recon_loss="mse", output_image_size=28,
               norm_type="batch", topology="spatial")


def _engine():
    eng = VAEEngine(_model(), lr=1e-3, device="cpu", steps_per_epoch=STEPS)
    eng.init_state()
    return eng


def _epoch(eng):
    gen = seeded_generator("cpu", 0)
    n = BATCH * STEPS
    x = torch.rand((n, 28, 28, 1), generator=gen)
    mask = torch.ones(n)
    perm = torch.randperm(n, generator=gen)
    eng.train_epoch(x, mask, perm, 1.0, STEPS, BATCH, gen)
    eng.eval_epoch(x, mask, 1.0, EVAL_STEPS, BATCH, gen)


@pytest.fixture(scope="module")
def build_cfg(tmp_path_factory):
    """A 2,048-node build (128 images of 4x4 latents; one image far off,
    so the LCC is a strict subgraph) from a seeded narrow decoder."""
    root = tmp_path_factory.mktemp("codebook")
    rng = np.random.default_rng(0)
    centers = rng.normal(0, 1.2, size=(6, LATENT)).astype(np.float32)
    z = centers[rng.integers(0, 6, size=(128, 4, 4))]
    z = (z + rng.normal(0, 0.6, size=z.shape)).astype(np.float32)
    z[-1] = 40.0
    save_latents(root / "latents", z, z, np.zeros_like(z),
                 np.zeros(128, np.int64))
    model = _model()
    model.load_state_dict(_engine().model.state_dict())
    save_checkpoint(root / "vae.pt", {"model_state_dict": model.state_dict(),
                                      "epoch": 0})
    return Config({
        "latents_path": str(root / "latents"),
        "vae_ckpt_path": str(root / "vae.pt"), "out_dir": str(root / "out"),
        "vae": {"in_channels": 1, "output_image_size": 28,
                "latent_dim": LATENT, "enc_channels": list(ENC),
                "dec_channels": list(DEC), "recon_loss": "mse",
                "norm_type": "batch", "mse_use_sigmoid": True,
                "topology": "spatial"},
        "graph": {"k": 10, "sym": "union"},
        "quantize": {"K": 16, "init": "kpp_parallel", "seed": 42},
        "system": {"batch_size": 512}})


@pytest.fixture(scope="module")
def traced_build(build_cfg):
    """One build under the CPU profiler: (its table, the profiler's rows
    named ``vqvae.*`` by name, its ``timings_s``, its KMED_STATS record)."""
    profiling.reset_spans()
    n_stats = len(kmedoids.KMED_STATS)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = build_codebook_main(build_cfg, device="cpu")
    rows = profiling.spans()
    profiling.reset_spans()
    assert len(kmedoids.KMED_STATS) == n_stats + 1
    return (rows, _profiler_rows(prof),
            load_codebook(out)["config"]["timings_s"],
            kmedoids.KMED_STATS[-1])


def _profiler_rows(prof):
    out = defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("vqvae."):
            start = e.start_ns()
            out[e.name()].append((start, start + e.duration_ns()))
    return out


def _traced_epoch():
    eng = _engine()
    _epoch(eng)  # warm
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _epoch(eng)
    return profiling.spans(), _profiler_rows(prof)


def test_spans_are_off_without_a_profiler(build_cfg, tmp_path):
    assert not profiling.tracing()
    assert profiling.span("vqvae.x") is profiling.span("vqvae.y") \
        is profiling._NULL
    profiling.count("vqvae.x", 3)
    _epoch(_engine())
    out = build_codebook_main(build_cfg.replace(
        out_dir=str(tmp_path / "out")), device="cpu")
    assert profiling.spans() == []
    timings = load_codebook(out)["config"]["timings_s"]
    assert set(timings) == {"knn", "riemannian", *LCC_PARTS, "lcc",
                            "kmedoids", "total"}
    assert all(t >= 0 for t in timings.values())


def test_the_lcc_parts_add_up_to_the_lcc_step(build_cfg, tmp_path):
    out = build_codebook_main(build_cfg.replace(
        out_dir=str(tmp_path / "out")), device="cpu")
    t = load_codebook(out)["config"]["timings_s"]
    assert sum(t[k] for k in LCC_PARTS) == pytest.approx(t["lcc"], rel=1e-12,
                                                         abs=1e-15)
    assert t["lcc"] > 0


def test_a_sink_span_times_the_block_traced_or_not():
    sink, seconds = {}, []
    with profiling.span("vqvae.test.a", sink) as a:
        pass
    with profiling.span("vqvae.test.b", sink, after=a):
        pass
    with profiling.span("vqvae.test.c", seconds):
        pass
    assert set(sink) == {"a", "b"} and len(seconds) == 1
    assert profiling.spans() == []
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("vqvae.test.a", sink, key="other"):
            profiling.count("vqvae.test.n", 4)
    (n, a) = profiling.spans()
    assert sink["other"] == (a.end - a.start) / 1e9
    assert (n.name, n.count, n.parent) == ("vqvae.test.n", 4, "vqvae.test.a")
    assert a.parent is None and a.count is None


def test_train_epoch_spans_nest():
    rows, _ = _traced_epoch()
    by = Counter((r.name, r.parent) for r in rows)
    step_children = ("forward", "loss", "backward", "guard", "optimizer")
    want = {("vqvae.vae.train_epoch", None): 1,
            ("vqvae.vae.train_step", "vqvae.vae.train_epoch"): STEPS,
            ("vqvae.vae.batchnorm", "vqvae.vae.forward"): NORMS * STEPS,
            ("vqvae.vae.eval_step", None): EVAL_STEPS,
            **{(f"vqvae.vae.{c}", "vqvae.vae.train_step"): STEPS
               for c in step_children}}
    # backward runs on the calling thread on the CPU (on autograd's own
    # device thread on a card, where the norm's backward has no parent)
    want[("vqvae.vae.batchnorm_backward", "vqvae.vae.backward")] = \
        NORMS * STEPS
    assert dict(by) == want
    epoch = next(r for r in rows if r.name == "vqvae.vae.train_epoch")
    assert all(epoch.start <= r.start and r.end <= epoch.end for r in rows
               if r.parent == "vqvae.vae.train_epoch")


def test_build_spans_nest_and_count(traced_build):
    rows, _, _, stats = traced_build
    by = Counter((r.name, r.parent) for r in rows)
    root = "vqvae.codebook.build"
    assert by[(root, None)] == 1
    for step in ("inputs", "knn", "riemannian", *LCC_PARTS, "kmedoids",
                 "artifacts"):
        assert by[(f"vqvae.codebook.{step}", root)] == 1, step
    chunks = by[("vqvae.riemannian.gather", "vqvae.codebook.riemannian")]
    assert chunks == by[("vqvae.riemannian.jvp",
                         "vqvae.codebook.riemannian")] >= 2
    assert by[("vqvae.knn.rerank", "vqvae.codebook.knn")] >= 1
    passes = by[("vqvae.kmedoids.pass", "vqvae.codebook.kmedoids")]
    assert passes == stats["passes"] >= 2
    assert by[("vqvae.kmedoids.sample", "vqvae.codebook.kmedoids")] == \
        passes - 1


def test_kmed_stats_take_the_spans_readings(traced_build):
    rows, _, _, stats = traced_build
    secs = lambda name: [(r.end - r.start) / 1e9  # noqa: E731
                         for r in sorted(rows, key=lambda r: r.start)
                         if r.name == name]
    assert stats["pass_seconds"] == secs("vqvae.kmedoids.pass")
    assert stats["sample_seconds"] == pytest.approx(
        sum(secs("vqvae.kmedoids.sample")), rel=1e-12)


def test_traced_lcc_parts_lie_within_the_lcc_step(traced_build):
    _, _, t, _ = traced_build
    parts = sum(t[k] for k in LCC_PARTS)
    assert 0 < parts <= t["lcc"] and parts == pytest.approx(t["lcc"],
                                                            rel=0.05)


def test_the_graph_write_counts_its_pieces(traced_build, build_cfg,
                                           tmp_path, monkeypatch):
    rows, _, timings, _ = traced_build
    graph = Path(build_cfg["out_dir"]) / "knn_graph_geodesic.npz"
    with zipfile.ZipFile(graph) as f:
        members = len(f.infolist())  # each fits one piece
    assert [(r.count, r.parent) for r in rows
            if r.name == "vqvae.codebook.graph_write_chunks"] == \
        [(members, "vqvae.codebook.graph_write")]
    assert set(timings) == {"knn", "riemannian", *LCC_PARTS, "lcc",
                            "kmedoids", "total"}
    monkeypatch.setattr(npz, "CHUNK", 1 << 14)
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        pieces = npz.save_csr_npz(tmp_path / "graph.npz",
                                  sparse.load_npz(graph))
    assert profiling.spans() == []  # the writer counts nothing itself
    with zipfile.ZipFile(tmp_path / "graph.npz") as f:
        assert pieces == sum(-(-i.file_size // (1 << 14))
                             for i in f.infolist()) > len(f.infolist())


def _inside(rows, prof_rows):
    """Each span row against the profiler's rows of its name: the least
    distance by which it pokes out of one (0 when inside)."""
    worst = 0
    for r in rows:
        if r.count is None:
            worst = max(worst, min(max(s - r.start, r.end - e, 0)
                                   for s, e in prof_rows[r.name]))
    return worst


def test_rows_lie_inside_the_profilers_rows(traced_build):
    rows, prof_rows, _, _ = traced_build
    epoch_rows, epoch_prof = _traced_epoch()
    assert _inside(rows, prof_rows) <= SLACK_NS
    assert _inside(epoch_rows, epoch_prof) <= SLACK_NS


def test_ell_sweeps_are_counted():
    rng = np.random.default_rng(1)
    n = 300
    rows = rng.integers(0, n, 1200)
    cols = rng.integers(0, n, 1200)
    keep = rows != cols
    from scipy import sparse

    w = sparse.csr_matrix((rng.random(keep.sum()) + 0.1,
                           (rows[keep], cols[keep])), shape=(n, n))
    graph = BucketedGraph.from_csr(w.maximum(w.T).tocsr(), device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        _, iters = multi_source_shortest_paths_ell(graph, [0, 7, 42],
                                                   return_iters=True)
    table = profiling.spans()
    sweeps = [r for r in table if r.name == "vqvae.kmedoids.ell_sweep"]
    counted = [r.count for r in table
               if r.name == "vqvae.kmedoids.ell_sweeps"]
    assert len(sweeps) == iters == sum(counted) >= 2


def test_stage_timer_is_a_sink_span(capsys):
    sink = {}
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.stage_timer("stage", sink):
            pass
    (row,) = profiling.spans()
    assert row.name == "vqvae.stage"
    assert sink["stage"] == (row.end - row.start) / 1e9
    assert "[timer] stage:" in capsys.readouterr().out


# -- the benchmark's readers ------------------------------------------------

def _row(name, start, end, parent=None, count=None):
    return profiling.SpanRow(name, start, end, parent, 1, count)


def _table(monkeypatch, rows):
    monkeypatch.setattr(profiling, "_ROWS", list(rows))


VAE_INFO = {"stage": "vae_train", "traced": {"train_steps": 2}}
CB_INFO = {"stage": "codebook"}


def _vae_rows(offset):
    """A traced epoch of two 10 ms steps, each with 2 + 1 ms of BatchNorm
    (forward + backward), starting at ``offset`` ms."""
    ms = 1_000_000
    o = offset * ms
    rows = [_row("vqvae.vae.train_epoch", o, o + 30 * ms)]
    for i in range(2):
        s = o + i * 10 * ms
        rows += [_row("vqvae.vae.train_step", s, s + 10 * ms,
                      "vqvae.vae.train_epoch"),
                 _row("vqvae.vae.batchnorm", s + ms, s + 3 * ms,
                      "vqvae.vae.forward"),
                 _row("vqvae.vae.batchnorm_backward", s + 5 * ms, s + 6 * ms)]
    return rows


@pytest.mark.parametrize("metric,want", [
    ("vae_train.step_host_ms", 10.0),
    ("vae_train.batchnorm_host_ms", 3.0),
])
def test_vae_span_readers_read_the_first_traced_epoch(monkeypatch, metric,
                                                      want):
    read = harness.reader(metric)
    # the second stretch (every host op traced) runs its steps slower
    slow = [r._replace(end=r.start + 2 * (r.end - r.start))
            for r in _vae_rows(100)]
    _table(monkeypatch, _vae_rows(0) + slow)
    assert read(None, VAE_INFO) == pytest.approx(want)
    assert read(None, CB_INFO) is None
    _table(monkeypatch, [])
    assert read(None, VAE_INFO) is None
    monkeypatch.delattr(profiling, "spans")  # a program without the table
    assert read(None, VAE_INFO) is None


def test_batchnorm_kernel_calls_reader_counts_a_step(monkeypatch):
    """The counter of the norms' kernels, forward on the step's thread
    and backward on autograd's (no parent), summed over the first traced
    epoch's steps; none outside a step, none in a program without it."""
    read = harness.reader("vae_train.batchnorm_kernel_calls")
    rows = _vae_rows(0)
    counted = list(rows)
    for s in (0, 10_000_000):
        counted += [_row("vqvae.vae.batchnorm_kernel", s + t, s + t,
                         "vqvae.vae.batchnorm", 1) for t in (1, 2, 3)]
        counted += [_row("vqvae.vae.batchnorm_kernel", s + 7, s + 7,
                         None, 1)]
    outside = _row("vqvae.vae.batchnorm_kernel", 25_000_000, 25_000_000,
                   None, 1)
    _table(monkeypatch, counted + [outside] + _vae_rows(100))
    assert read(None, VAE_INFO) == 4.0
    assert read(None, CB_INFO) is None
    _table(monkeypatch, rows)
    assert read(None, VAE_INFO) is None
    monkeypatch.delattr(profiling, "spans")
    assert read(None, VAE_INFO) is None


def test_ell_sweeps_reader_sums_the_first_build(monkeypatch):
    read = harness.reader("codebook.ell_sweeps")
    build = [_row("vqvae.codebook.build", 0, 100),
             _row("vqvae.kmedoids.ell_sweeps", 10, 10, count=7),
             _row("vqvae.kmedoids.ell_sweeps", 20, 20, count=5)]
    later = [_row("vqvae.codebook.build", 200, 300),
             _row("vqvae.kmedoids.ell_sweeps", 250, 250, count=9)]
    _table(monkeypatch, build + later)
    assert read(None, CB_INFO) == 12.0
    assert read(None, VAE_INFO) is None
    _table(monkeypatch, build[:1])
    assert read(None, CB_INFO) is None
    monkeypatch.delattr(profiling, "spans")
    assert read(None, CB_INFO) is None


@pytest.mark.parametrize("part", LCC_PARTS)
def test_lcc_part_readers_average_the_window_builds(part):
    read = harness.reader(f"codebook.{part}_s")
    info = {**CB_INFO, "timings": [{part: 1.0, "lcc": 4.0},
                                   {part: 2.0, "lcc": 5.0}]}
    assert read(None, info) == pytest.approx(1.5)
    # a program whose builds time the step whole
    assert read(None, {**CB_INFO, "timings": [{"lcc": 4.0}]}) is None
    assert read(None, {"stage": "vae_train", "timings": info["timings"]}) \
        is None


def test_span_cost_tool_reports_a_step(monkeypatch):
    from vqvae_tpu_torch.tools import span_cost

    out = span_cost.run(REPO / "configs" / "sandbox-fashion" / "geodesic",
                        batch=4, device="cpu")
    assert out["device"] == "cpu" and set(out["on_ns"]) == {"host"}
    assert out["off_ns"] < out["on_ns"]["host"]
    assert out["step_spans"]["vqvae.vae.batchnorm"] == NORMS
    assert out["spans_a_step"] == 5 + 2 * NORMS
    assert out["session_rows"]["host_and_device"][
        "vqvae.vae.batchnorm cpu"] == 3 * NORMS
    assert profiling.spans() == []


def test_traced_cost_tool_reads_the_spans_per_round():
    from portbench.tools import traced_cost

    row = traced_cost.rounds(
        "fmnist-spatial-geodesic.vae-train", 2121692627, 1, device="cpu",
        overrides={"data": {"train_size": 600, "eval_size": 100}})
    assert all(len(v) == 1 for v in row["seconds"].values())
    assert set(row["slowdown"]) == {"device", "host_ops",
                                    "device_spans_off", "host_ops_spans_off"}
    assert set(row["spans_cost"]) == {"device", "host_ops"}
    assert len(row["untraced_ms_a_step"]) == 1
    assert set(row["spans"]) == {f"{k}.{m}" for k in ("device", "host_ops")
                                 for m in traced_cost.READERS}
    assert all(len(v) == 1 and v[0] > 0 for v in row["spans"].values())
    assert profiling.spans() == []
