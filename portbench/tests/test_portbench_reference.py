"""The plain references against the port on the CPU at test size, and the
faults each cell's check must catch: a run driven through set-up, window
and check with the timed path broken underneath comes out not correct."""
import numpy as np
import pytest
import torch

from portbench import harness

from .conftest import TINY, run_tiny, tiny_cell


@pytest.mark.parametrize("name", sorted(TINY))
def test_port_matches_the_reference(name, tmp_path):
    result, _ = run_tiny(name, tmp_path)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0


def _state_unchanged(monkeypatch):
    from vqvae_tpu_torch.train import state
    monkeypatch.setattr(state.Optimizer, "step", lambda self: None)


def _half_batch_vae(monkeypatch):
    from vqvae_tpu_torch.train.vae_engine import VAEEngine
    step = VAEEngine.train_step

    def half(self, images, mask, *a, **kw):
        h = images.shape[0] // 2
        return step(self, images[:h], mask[:h], *a, **kw)

    monkeypatch.setattr(VAEEngine, "train_step", half)


def _altered_code(monkeypatch):
    from vqvae_tpu_torch.cli import build_codebook
    save = build_codebook.save_codebook_artifacts

    def altered(out_dir, medoids, z_medoid, codes, record):
        codes = codes.copy()
        flat = codes.reshape(-1)
        i = int(np.nonzero(flat >= 0)[0][-1])
        flat[i] = (flat[i] + 1) % len(medoids)
        save(out_dir, medoids, z_medoid, codes, record)

    monkeypatch.setattr(build_codebook, "save_codebook_artifacts", altered)


def _medoids_of_another_seed(monkeypatch):
    from vqvae_tpu_torch.cli import build_codebook
    fit = build_codebook.fit_kmedoids
    monkeypatch.setattr(build_codebook, "fit_kmedoids",
                        lambda *a, **kw: fit(*a, **{**kw,
                                                    "seed": kw["seed"] + 1}))


def _fewer_rounds(monkeypatch):
    from vqvae_tpu_torch.cli import build_codebook
    fit = build_codebook.fit_kmedoids
    monkeypatch.setattr(build_codebook, "fit_kmedoids",
                        lambda *a, **kw: fit(*a, **{**kw, "kpp_rounds": 2}))


def _lost_neighbours(monkeypatch):
    from vqvae_tpu_torch.ops import graph
    search = graph.knn_search

    def lossy(*a, **kw):
        d, i = search(*a, **kw)
        i = i.copy()
        i[::7, 3] = i[::7, -1]  # every 7th list loses its third neighbour
        return d, i

    monkeypatch.setattr(graph, "knn_search", lossy)


def _altered_lengths(monkeypatch):
    from vqvae_tpu_torch.cli import build_codebook
    lengths = build_codebook.edge_lengths_riemannian_auto
    monkeypatch.setattr(build_codebook, "edge_lengths_riemannian_auto",
                        lambda *a, **kw: np.asarray(lengths(*a, **kw)) * 1.01)


FAULTS = [
    ("fmnist-spatial-geodesic.vae-train", _state_unchanged, "change_gap"),
    ("fmnist-spatial-geodesic.vae-train", _half_batch_vae, "loss_gap"),
    ("cifar10-spatial-geodesic.vae-train", _state_unchanged, "change_gap"),
    ("cifar10-spatial-geodesic.vae-train", _half_batch_vae, "loss_gap"),
    ("fmnist-spatial-geodesic.codebook", _altered_code, "assign_bad"),
    ("fmnist-spatial-geodesic.codebook", _altered_lengths, "length_gap"),
    ("fmnist-spatial-geodesic.codebook", _medoids_of_another_seed,
     "medoid_bad"),
    ("fmnist-spatial-geodesic.codebook", _fewer_rounds, "medoid_bad"),
    ("fmnist-spatial-geodesic.codebook", _lost_neighbours, "knn_miss"),
    ("cifar10-spatial-geodesic.codebook", _altered_lengths, "length_gap"),
    ("cifar10-spatial-geodesic.codebook", _altered_code, "assign_bad"),
    ("cifar10-spatial-geodesic.codebook", _lost_neighbours, "knn_miss"),
]


@pytest.mark.parametrize("name, fault, number", FAULTS,
                         ids=[f"{n}-{f.__name__}" for n, f, _ in FAULTS])
def test_a_broken_timed_path_is_not_correct(name, fault, number, tmp_path,
                                            monkeypatch):
    fault(monkeypatch)
    result, _ = run_tiny(name, tmp_path)
    assert not result["correct"]
    c = result["checks"][number]
    assert c["value"] > c["limit"], result["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(TINY))
def test_low_precision_control_fails_on_the_card(name, tmp_path):
    """The reference in TF32 in the program's place fails one number (on
    the card only: the CPU has no TF32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 exists on the card only")
    cell = tiny_cell(name, tmp_path, device="cuda")
    stage = harness.stage_module(cell.traffic["stage"])
    st = stage.setup(cell)
    if cell.traffic["stage"] == "codebook_builds":
        stage.window(st, 0.0)
    stage.release(st)
    checks = harness.judge(stage.check(st, control=True), cell.limits)
    assert not harness.all_within(checks), checks


def test_medoids_drawn_in_breadth_first_order_match(tmp_path, monkeypatch):
    """At the cell's size the stage relabels its graph breadth-first
    before the rounds; forced at test size on both sides, the draws
    still agree."""
    from vqvae_tpu_torch.ops import kmedoids

    from portbench.reference import codebook as ref_cb
    monkeypatch.setattr(kmedoids, "HOST_WORK_THRESHOLD", 0.0)
    monkeypatch.setattr(ref_cb, "draws_in_bfs_order", lambda nnz, K: True)
    result, _ = run_tiny("fmnist-spatial-geodesic.codebook", tmp_path)
    assert result["correct"], result["checks"]


def test_breadth_first_order_matches_the_stage():
    from scipy import sparse
    from vqvae_tpu_torch.ops.graph import bfs_node_order

    from portbench.reference import codebook as ref_cb
    rng = np.random.default_rng(3)
    n = 500
    a, b = rng.integers(0, n, 1200), rng.integers(0, n, 1200)
    w = sparse.coo_matrix((np.ones(2400), (np.r_[a, b], np.r_[b, a])),
                          shape=(n, n)).tocsr()  # several components
    got = ref_cb.bfs_order(w.indptr.astype(np.int64),
                           w.indices.astype(np.int64))
    assert np.array_equal(got, bfs_node_order(w))


def test_selection_matches_the_stage_but_for_near_ties():
    """The reference's binned selection against the stage's plain fused
    route at a size with three rows a bin."""
    from vqvae_tpu_torch.ops.knn import knn_search

    from portbench import inputs
    from portbench.reference import codebook as ref_cb
    z = inputs.clustered_latents(192, 4, 16, 10, 1.2, 1.0, 5, 21, "cpu")
    z = z.reshape(-1, 16)
    assert ref_cb.select_params(z.shape[0], 21)[0] * 2 < z.shape[0]
    sel = ref_cb.approx_knn(z, 21)
    _, idx = knn_search(z.numpy(), 21, approx=True, device="cpu")
    same = torch.from_numpy(idx) == sel["ids"]
    assert bool((same | sel["fragile"]).all())
    assert float(same.float().mean()) > 0.999
