"""Traffic kind ``codebook_builds``: back-to-back geodesic codebook builds.

Set-up makes one build's inputs from the seed and writes them into the
run's temporary directory: ``latent_images`` 4x4 grids of clustered
latents (``inputs.clustered_latents``, the traffic's lobes) and a seeded
decoder checkpoint in the reference format (flax-default kernels, drawn
norm scales and shifts, running statistics those of its activations over
the first ``CALIBRATE`` latents, as a trained decoder's would be); then
runs one whole build, so every kernel is built and every shape has run.
The window calls ``build_codebook_main`` on those inputs again and
again, each build writing its artifacts into a directory of its own;
``codebook_build_s`` is the window over the whole builds it held.

The check, once the window has closed, reads every build's artifacts and
holds them against the plain reference (``reference/codebook.py``) on the
same inputs (builds whose artifacts are equal byte for byte are judged
once):

- ``lcc_diff``: nodes whose membership of the largest component (a code
  of -1 marks a node off it) differs from the reference's;
- ``knn_miss``: entries of the reference's kNN lists (of LCC nodes) that
  the program's graph lacks, near-ties aside. The reference runs the
  configuration's approximate selection (``graph.method`` approx: each
  bin's two nearest rows, then the ``k_sel`` nearest of those, re-ranked
  exactly), so a neighbour that the selection loses by design is lost on
  both sides; an entry is a near-tie where rounding could drop it (its
  value within ``TIES`` tolerances of its bin's third, of the first
  candidate left out, or of the first re-ranked row left out);
- ``knn_extra``: edges of the program's graph that no near-tie could put
  on either end's list;
- ``length_gap``: the largest relative gap of an edge's Riemannian length
  from the reference's over the edges both graphs hold, leaving out edges
  with an end whose decoder has a ReLU input within ``KINK`` of its
  summed absolute terms of 0 (rounding decides that unit's gate);
- ``medoid_bad``: the program's medoids against the reference's
  ``kpp_parallel`` rounds on the program's own LCC graph (its lengths are
  judged above), in the stage's node order: round by round from the
  program's centers before it, each draw that differs from the
  reference's beyond keys within ``KEY_TIE``, the first center and the
  count included;
- ``assign_bad``: medoids not K distinct LCC nodes, ``z_medoid`` rows not
  the medoids' latents, a medoid not coded as itself, codes out of range,
  LCC nodes coded to a medoid farther than the nearest by more than
  ``ASSIGN_TIE``, and a quantization error (the sum of squared distances
  to the nearest medoid) off by more than ``QE_SUM``: judged by the
  reference's shortest paths over the program's own graph and lengths,
  from the program's medoids.

The control (``check(..., control=True)``) puts the reference in the
program's place: its selection and lengths in TF32, its own LCC, medoids,
codes and error from those, judged the same way.
"""
from __future__ import annotations

import hashlib
import json
import shutil
import time
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from .. import inputs, yardstick
from ..reference import codebook as ref_cb
from ..reference import precision
from ..reference import vae as ref_vae

KINK = 3e-7
ASSIGN_TIE = 1e-6
# float64 sums of 262,144 squares in two orders agree to ~3e-11
QE_SUM = 1e-9
MAX_DISPUTED_MEDOIDS = 64
# two implementations of one shortest-path sum agree to the bit; keys of
# draws closer than this are near-ties
KEY_TIE = 1e-6
# the stage's k-means|| rounds (its default: the configuration sets none)
KPP_ROUNDS = 4
# latents whose decoder activations set the seeded decoder's norm statistics
CALIBRATE = 16384


def _stage_config(cfg: Dict, work: Path, out: Path):
    from vqvae_tpu_torch.config import Config

    v, cb = cfg["vae"], cfg["codebook"]
    return Config({
        "latents_path": str(work / "latents.npz"),
        "vae_ckpt_path": str(work / "vae.pt"),
        "out_dir": str(out),
        "vae": {"in_channels": v["in_channels"],
                "output_image_size": v["image_size"],
                "latent_dim": v["latent_dim"],
                "enc_channels": list(v["enc_channels"]),
                "dec_channels": list(v["dec_channels"]),
                "recon_loss": v["recon_loss"], "norm_type": v["norm_type"],
                "mse_use_sigmoid": v["mse_use_sigmoid"],
                "topology": v["topology"]},
        "graph": {"k": cb["k"], "sym": cb["sym"], "method": cb["method"]},
        "quantize": {"K": cb["K"], "init": cb["init"], "seed": cb["seed"]},
        "system": {"batch_size": cb["batch_size"]},
    })


def setup(cell) -> Dict:
    from vqvae_tpu_torch.cli.build_codebook import build_codebook_main

    cfg, dev, seed, work = cell.config, cell.device, cell.seed, cell.workdir
    tr, v = cell.traffic, cfg["vae"]
    grid = v["image_size"]
    for _ in v["enc_channels"]:
        grid = yardstick.conv_out(grid, 3, 2, 1)
    z = inputs.clustered_latents(cfg["latent_images"], grid, v["latent_dim"],
                                 tr["lobes"], tr["center_std"],
                                 tr["noise_std"], seed, 21, dev)
    sd = ref_vae.calibrate_decoder(
        ref_vae.initial_state(cfg, seed, 22, dev, random_stats=True), cfg,
        z.reshape(-1, z.shape[-1])[:CALIBRATE])
    z_host = z.cpu().numpy()
    sd_host = {k: t.cpu() for k, t in sd.items()}
    del z, sd
    np.savez(work / "latents.npz", z=z_host)
    torch.save({"model_state_dict": sd_host, "epoch": 0}, work / "vae.pt")
    warm = work / "warm"
    build_codebook_main(_stage_config(cfg, work, warm), device=dev)
    shutil.rmtree(warm)
    return {"cell": cell, "z": z_host, "sd": sd_host,
            "build": build_codebook_main, "outs": []}


def window(st: Dict, seconds: float) -> Dict:
    cell = st["cell"]
    t0 = time.perf_counter()
    ends, cpu = [t0], [time.thread_time()]
    while True:
        out = cell.workdir / f"build{len(st['outs'])}"
        st["build"](_stage_config(cell.config, cell.workdir, out),
                    device=cell.device)
        st["outs"].append(out)
        ends.append(time.perf_counter())
        cpu.append(time.thread_time())
        if ends[-1] - t0 >= seconds:
            break
    st["notes"] = {"build_s": [round(b - a, 4)
                               for a, b in zip(ends, ends[1:])],
                   "build_thread_cpu_s": [round(b - a, 4)
                                          for a, b in zip(cpu, cpu[1:])]}
    n = len(ends) - 1  # the builds of this call
    return {"builds": n, "attempted": n, "failed": 0}


def end_to_end(st: Dict, counters: Dict, window_s: float) -> Dict:
    return {"codebook_build_s": window_s / counters["builds"]}


def release(st: Dict) -> None:
    st.pop("build", None)


def read_build(out: Path, z_flat: np.ndarray) -> Dict:
    """A build's artifacts: its graph in the full graph's node ids (each
    edge once) and in its LCC's (the stored CSR as well), its medoids in
    both."""
    from scipy import sparse

    codes = np.load(out / "codes.npy").reshape(-1)
    with np.load(out / "codebook.npz") as f:
        medoids = f["medoid_indices"].astype(np.int64)
        z_medoid = f["z_medoid"]
        record = json.loads(bytes(f["config_json"]).decode())
    lcc = np.nonzero(codes != -1)[0]
    csr = sparse.load_npz(out / "knn_graph_geodesic.npz").tocsr()
    w = sparse.triu(csr, k=1).tocoo()
    return {"codes": codes, "rows": lcc[w.row], "cols": lcc[w.col],
            "lengths": w.data.astype(np.float32),
            "lcc_rows": w.row.astype(np.int64),
            "lcc_cols": w.col.astype(np.int64),
            "indptr": csr.indptr.astype(np.int64),
            "indices": csr.indices.astype(np.int64),
            "medoids_lcc": medoids,
            "medoids": lcc[medoids] if len(lcc) else medoids,
            "z_medoid_ok": bool(len(medoids) == len(z_medoid) and
                                np.array_equal(z_medoid,
                                               z_flat[lcc[medoids]])),
            "qe": float(record["quantization_error"]),
            "timings": record.get("timings_s", {})}


def digest(b: Dict) -> str:
    """A build's artifacts as one hash (equal builds judge alike)."""
    h = hashlib.blake2b(digest_size=16)
    for key in ("codes", "indptr", "indices", "lengths", "medoids_lcc"):
        h.update(np.ascontiguousarray(b[key]).tobytes())
    h.update(repr((b["qe"], b["z_medoid_ok"])).encode())
    return h.hexdigest()


def graph(z: torch.Tensor, sd: Dict, cfg: Dict, tf32: bool) -> Dict:
    """The reference's kNN selection, union graph and lengths, its matmuls
    in TF32 or full float32."""
    k = cfg["codebook"]["k"]
    with precision(tf32):
        sel = ref_cb.approx_knn(z, k + 1)
        nbr, fragile = ref_cb.drop_self(sel["ids"], sel["fragile"])
        rows, cols = ref_cb.union_edges(nbr)
        lengths = ref_cb.edge_lengths(sd, cfg, z, rows, cols)
    return {"sel": sel, "nbr": nbr, "fragile": fragile, "rows": rows,
            "cols": cols, "lengths": lengths}


def reference(st: Dict, control: bool = False) -> Dict:
    """The reference's graph, lengths, kink ratios and LCC on the run's
    device; with ``control``, its graph and lengths in TF32 too."""
    cfg, dev = st["cell"].config, st["cell"].device
    z = torch.from_numpy(st["z"].reshape(-1, st["z"].shape[-1])).to(dev)
    sd = {k: t.to(dev) for k, t in st["sd"].items()}
    out = {**graph(z, sd, cfg, False), "z": z, "n": z.shape[0],
           "kink": ref_cb.kink_ratio(sd, cfg, z)}
    out["lcc"] = ref_cb.largest_component(
        ref_cb.components(out["rows"], out["cols"], out["n"]))
    if control:
        out["tf32"] = graph(z, sd, cfg, True)
    return out


def judge(b: Dict, ref: Dict, cfg: Dict, notes: Dict) -> Dict[str, float]:
    """The numbers of the module's notes for one build's outputs ``b``
    (``notes`` gets counts for the record)."""
    dev, n = ref["z"].device, ref["n"]
    cb = cfg["codebook"]
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    codes = t(b["codes"])
    lcc_prog = codes != -1
    out = {"lcc_diff": float((lcc_prog != ref["lcc"]).sum())}

    # the kNN: each reference list entry of an LCC node that the program's
    # graph lacks, near-ties aside, is a miss; each program edge that no
    # near-tie could list at either end is extra
    pr, pc = t(b["rows"]).long(), t(b["cols"]).long()
    lo, hi = torch.minimum(pr, pc), torch.maximum(pr, pc)
    pk = lo * n + hi
    order = torch.argsort(pk)
    pk, p_len = pk[order], t(b["lengths"])[order]
    lo, hi = lo[order], hi[order]
    k = ref["nbr"].shape[1]
    u = torch.arange(n, device=dev).repeat_interleave(k)
    v = ref["nbr"].reshape(-1)
    keep = ref["lcc"][u]
    lacking = keep & ~torch.isin(torch.minimum(u, v) * n
                                 + torch.maximum(u, v), pk)
    miss = lacking & ~ref["fragile"].reshape(-1)
    out["knn_miss"] = float(miss.sum())
    rk = ref["rows"] * n + ref["cols"]
    extra = pk[~torch.isin(pk, rk)]
    eu, ev = extra // n, extra % n
    could = (ref_cb.could_list(ref["z"], ref["sel"], eu, ev)
             | ref_cb.could_list(ref["z"], ref["sel"], ev, eu))
    out["knn_extra"] = float((~could).sum())
    for name, c in (("knn_lacking_near_ties", int(lacking.sum())),
                    ("knn_extra_near_ties", int(could.sum()))):
        notes[name] = max(notes.get(name, 0), c)

    # lengths on the edges both hold, kinks aside
    pos = torch.searchsorted(rk, pk).clamp_max(rk.shape[0] - 1)
    both = rk[pos] == pk
    ref_len = ref["lengths"][pos[both]]
    kink = torch.minimum(ref["kink"][ref["rows"][pos[both]]],
                         ref["kink"][ref["cols"][pos[both]]])
    rel = (p_len[both] - ref_len).abs() / ref_len.clamp_min(1e-30)
    clean = kink > KINK
    out["length_gap"] = float(rel[clean].max()) if clean.any() else 0.0
    past = rel > 1e-4
    notes["kink_edges"] = max(notes.get("kink_edges", 0),
                              int((~clean).sum()))
    notes["length_gap_all_edges"] = max(notes.get("length_gap_all_edges", 0.0),
                                        float(rel.max()) if len(rel) else 0.0)
    notes["edges_past_1e-4"] = max(notes.get("edges_past_1e-4", 0),
                                   int(past.sum()))
    if past.any():
        notes["largest_kink_ratio_past_1e-4"] = max(
            notes.get("largest_kink_ratio_past_1e-4", 0.0),
            float(kink[past].max()))

    # the medoids: the reference's rounds on the program's LCC graph, held
    # at the program's centers before each round
    n_lcc = len(b["indptr"]) - 1
    perm = (ref_cb.bfs_order(b["indptr"], b["indices"])
            if ref_cb.draws_in_bfs_order(len(b["indices"]), cb["K"])
            else np.arange(n_lcc))
    out["medoid_bad"] = float(ref_cb.kpp_parallel(
        t(b["lcc_rows"]).long(), t(b["lcc_cols"]).long(), t(b["lengths"]),
        n_lcc, perm, cb["K"], cb["seed"], KPP_ROUNDS,
        held=b["medoids_lcc"], key_tie=KEY_TIE))

    # codes, the assignment and the error on the program's own graph: a
    # node's code names its nearest medoid, and the error is the sum of
    # those distances squared
    med = t(b["medoids"]).long()
    bad = 0
    if (med.shape[0] != min(cb["K"], int(lcc_prog.sum()))
            or torch.unique(med).shape[0] != med.shape[0]
            or not bool(lcc_prog[med].all())):
        bad += cb["K"]
    bad += 0 if b["z_medoid_ok"] else cb["K"]
    c = codes[lcc_prog]
    bad += int(((c < 0) | (c >= med.shape[0])).sum())
    bad += int((codes[med] != torch.arange(med.shape[0], device=dev)).sum())
    d_min, slot = ref_cb.nearest_source(lo, hi, t(b["lengths"])[order], n,
                                        med)
    disputed = torch.nonzero(lcc_prog & (codes != slot)).flatten()
    tried = torch.unique(codes[disputed])
    for m in tried[:MAX_DISPUTED_MEDOIDS]:
        nodes = disputed[codes[disputed] == m]
        d_m = ref_cb.bellman_ford(lo, hi, t(b["lengths"])[order], n,
                                  med[m:m + 1])
        bad += int((d_m[nodes] > d_min[nodes] * (1 + ASSIGN_TIE)).sum())
    if tried.shape[0] > MAX_DISPUTED_MEDOIDS:
        bad += int(torch.isin(codes[disputed],
                              tried[MAX_DISPUTED_MEDOIDS:]).sum())
    qe = float((d_min[lcc_prog].double() ** 2).sum())
    bad += int(abs(b["qe"] - qe) > QE_SUM * max(qe, 1e-30))
    out["assign_bad"] = float(bad)
    return out


def check(st: Dict, control: bool = False) -> Dict[str, float]:
    cfg = st["cell"].config
    z_flat = st["z"].reshape(-1, st["z"].shape[-1])
    builds = [read_build(o, z_flat) for o in st["outs"]]
    st["timings"] = [b["timings"] for b in builds]
    ref = reference(st, control)
    st["edges"] = int(ref["rows"].shape[0])
    if control:
        builds = [control_build(ref, cfg)]
    worst: Dict[str, float] = {}
    notes: Dict = {}
    judged: Dict[str, Dict[str, float]] = {}
    for b in builds:
        key = digest(b)
        if key not in judged:
            judged[key] = judge(b, ref, cfg, notes)
        for name, v in judged[key].items():
            worst[name] = max(worst.get(name, 0.0), v)
    notes["distinct_builds"] = len(judged)
    st["notes"] = {**st.get("notes", {}), **notes}
    return worst


def control_build(ref: Dict, cfg: Dict) -> Dict:
    """The reference's own build with its selection and lengths in TF32:
    its LCC, the stored CSR of that LCC, medoids by its rounds, codes and
    error from those lengths."""
    g, n = ref["tf32"], ref["n"]
    cb = cfg["codebook"]
    dev = g["rows"].device
    lcc = ref_cb.largest_component(ref_cb.components(g["rows"], g["cols"], n))
    keep = lcc[g["rows"]] & lcc[g["cols"]]
    rows, cols, w = g["rows"][keep], g["cols"][keep], g["lengths"][keep]
    ids = torch.nonzero(lcc).flatten()
    local = torch.cumsum(lcc.long(), 0) - 1
    lr, lc = local[rows], local[cols]
    n_lcc = int(ids.shape[0])
    # the stored CSR: both directions, each row's columns ascending
    a, b_ = torch.cat([lr, lc]), torch.cat([lc, lr])
    order = torch.argsort(a * n_lcc + b_)
    indices = ref_cb.to_numpy(b_[order])
    indptr = np.zeros(n_lcc + 1, np.int64)
    np.cumsum(np.bincount(ref_cb.to_numpy(a), minlength=n_lcc),
              out=indptr[1:])
    perm = (ref_cb.bfs_order(indptr, indices)
            if ref_cb.draws_in_bfs_order(len(indices), cb["K"])
            else np.arange(n_lcc))
    med = ref_cb.kpp_parallel(lr, lc, w, n_lcc, perm, cb["K"], cb["seed"],
                              KPP_ROUNDS)
    d, slot = ref_cb.nearest_source(lr, lc, w, n_lcc,
                                    torch.as_tensor(med, device=dev))
    codes = torch.full((n,), -1, dtype=torch.long, device=dev)
    codes[ids] = slot
    ids_np = ref_cb.to_numpy(ids)
    return {"codes": ref_cb.to_numpy(codes),
            "rows": ref_cb.to_numpy(rows), "cols": ref_cb.to_numpy(cols),
            "lengths": ref_cb.to_numpy(w),
            "lcc_rows": ref_cb.to_numpy(lr), "lcc_cols": ref_cb.to_numpy(lc),
            "indptr": indptr, "indices": indices, "medoids_lcc": med,
            "medoids": ids_np[med], "z_medoid_ok": True,
            "qe": float((d.double() ** 2).sum()), "timings": {}}


def info(st: Dict, counters: Dict) -> Dict:
    cfg = st["cell"].config
    # the window's builds come first; later ones ran traced
    timings = st.get("timings", [])[:counters["builds"]]
    return {"stage": "codebook", **counters, "timings": timings,
            "nodes": int(np.prod(st["z"].shape[:-1])),
            "edges": st.get("edges", 0), "config": cfg}
