"""Decoder-pullback Riemannian edge lengths via ``torch.func.jvp``.

The port of ``vqvae_tpu/ops/riemannian.py``:
L_ij = 0.5 * (||J(z_i) dz|| + ||J(z_j) dz||), J the Jacobian of
z -> sigmoid(decoder(z)) flattened to pixels, dz = z_j - z_i. Spatial
decoders decode each latent vector as a 1x1 grid (the reference
unsqueezes 2-D z to (B, C, 1, 1)).

Three engines. Two gather edge endpoints on the device from the (N, D)
latent table and evaluate both endpoint JVPs in one decoder pass:

- ``mlp``: on a 1x1 grid the spatial decoder is exactly an MLP (each
  transposed conv acts on a fixed 1x1 -> 2x2 -> 4x4 grid), so its dense
  affine segments are probed once through the real layers and the JVP
  runs as plain matmuls; a self-check against the conv decoder guards the
  probe (``_verify_affine_segments``) — when it fails, ``auto`` takes the
  conv engine, as the JAX package does.
- ``edgewise``: the JVP of the conv decoder itself.

The third, ``nodal``, computes each node's pullback metric G = J^T J once
(the JVP of the node repeated D times against the D basis vectors, in one
decoder pass per chunk of ``batch_size // D`` nodes), then each edge's
``|J(z_a) v|`` as ``sqrt(v^T G(z_a) v)`` in blocks of edges: the same
quantity up to float association.

``edge_lengths_riemannian`` takes preformed endpoint arrays instead (the
legacy flat-latent codebook's call), through the same fused JVP.

Accounting: every ``edge_lengths_riemannian_auto`` call appends one record
to ``RIEM_STATS`` (JAX's keys: the engine, the decoder JVP samples, the
analytic JVP FLOPs per sample, the wall seconds); the linearized decoder
carries its ``jvp_flops_per_sample`` and ``conv_decoder_jvp_flops_per_sample``
gives the conv decoder's. The nodal engine, which JAX does not record,
counts each node's D basis JVPs as its samples.

``mesh`` (``parallel.Mesh``) shards the work as JAX's ``shard_map`` shards
its chunk axis: the number of chunks is padded to a multiple of the world
size, each rank runs its contiguous block of chunks and the lengths are
all-gathered in edge order. A chunk keeps its single-rank size, so every
edge's length comes from the same products as at world size 1. The nodal
engine shards its node chunks (the metrics are all-gathered) and its edge
blocks alike. ``RIEM_STATS`` records the samples of every rank (the whole
call's).
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..parallel.mesh import all_gather_rows, pad_to_multiple, shard_range

_AUTO_DEFAULT_BATCH = 1024

# one record per edge_lengths_riemannian_auto call: engine, samples (decoder
# JVP rows), analytic JVP FLOPs per sample (None when unknown), seconds
RIEM_STATS: list = []


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


def make_decoder_image_fn(model, topology: Optional[str] = None) -> Callable:
    """z -> flattened sigmoid(decoder(z)) for the port's ``models.VAE``.

    ``topology="spatial"``: z (B, C) is decoded as a (B, 1, 1, C) grid;
    ``"flat"``: z (B, D) feeds the dense decoder. The model rides along as
    an attribute so ``edge_lengths_riemannian_auto`` can build the
    linearized decoder."""
    topology = topology or model.topology
    model.eval()  # decode with running norm statistics, as JAX's train=False

    def decode_fn(z):
        if topology == "spatial" and z.ndim == 2:
            z = z[:, None, None, :]
        img = torch.sigmoid(model.decode(z))
        return img.reshape(img.shape[0], -1)

    decode_fn.model = model
    decode_fn.topology = topology
    decode_fn.device = _model_device(model)
    return decode_fn


def _nhwc_flat(h: torch.Tensor) -> torch.Tensor:
    return h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)


def _decoder_affine_segments(model) -> Optional[List[Tuple[torch.Tensor,
                                                            torch.Tensor]]]:
    """Dense affine segments ``[(M, c), ...]`` of the spatial decoder on
    1x1 latent grids (NHWC-flattened rows, ReLU between segments, sigmoid
    applied by the caller), or None when the decoder is not expressible
    this way (flat topology, group norm, non-f32 weights or compute,
    other sizes)."""
    if (getattr(model, "topology", None) != "spatial"
            or model.norm_type not in ("batch", "none")
            or model.output_image_size not in (28, 32)
            or getattr(model, "compute_dtype", torch.float32) != torch.float32
            or any(p.dtype != torch.float32 for p in model.parameters())):
        return None
    dec = model.decoder
    layers = list(dec.deconv_layers)
    n_stages = (len(layers) - 1) // 3
    dev = _model_device(model)

    def probe_affine(fn, d_in: int, in_shape):
        eye = torch.cat([torch.zeros((1, d_in), device=dev),
                         torch.eye(d_in, device=dev)])
        out = fn(eye.reshape(d_in + 1, *in_shape)).reshape(d_in + 1, -1)
        return out[1:] - out[0], out[0]

    def nchw(h, in_shape):  # NHWC-flat rows -> NCHW grid
        return h.reshape(h.shape[0], *in_shape).permute(0, 3, 1, 2)

    segs = []
    hw, ch = (1, 1), int(model.latent_dim)
    with torch.no_grad():
        for i in range(n_stages):
            ct, norm = layers[3 * i], layers[3 * i + 1]
            in_shape = (*hw, ch)

            def seg(h, ct=ct, norm=norm, in_shape=in_shape, first=(i == 0)):
                x = nchw(h, in_shape)
                if first:
                    x = dec.conv_in(x)
                return _nhwc_flat(norm(ct(x)))

            segs.append(probe_affine(seg, int(np.prod(in_shape)), in_shape))
            hw, ch = (2 * hw[0], 2 * hw[1]), ct.out_channels
        head = layers[-1]
        in_shape = (*hw, ch)
        segs.append(probe_affine(
            lambda h: _nhwc_flat(head(nchw(h, in_shape))),
            int(np.prod(in_shape)), in_shape))
    return segs


def _mlp_forward(segs, z: torch.Tensor) -> torch.Tensor:
    h = z.reshape(z.shape[0], -1)
    for i, (M, c) in enumerate(segs):
        h = h @ M + c
        if i < len(segs) - 1:
            h = torch.relu(h)
    return torch.sigmoid(h)


def _verify_affine_segments(model, segs) -> bool:
    """Runtime backstop for the linearized decoder: the probed affine+ReLU
    stack and the real conv decoder must agree on a small random batch, so
    a model whose geometry drifted from the probe falls back to the conv
    engine instead of giving a wrong metric."""
    z = np.random.RandomState(0).randn(8, int(model.latent_dim))
    z = torch.from_numpy(z.astype(np.float32)).to(_model_device(model))
    with torch.no_grad():
        mlp = _mlp_forward(segs, z)
        conv = torch.sigmoid(model.decode(z[:, None, None, :]))
        conv = conv.reshape(z.shape[0], -1)
    return (mlp.shape == conv.shape
            and bool(torch.allclose(mlp, conv, rtol=1e-3, atol=1e-4)))


def build_mlp_decode_fn(model) -> Optional[Callable]:
    """Linearized spatial decoder z (B, D) -> flattened sigmoid image via
    dense f32 matmuls (the same map as ``make_decoder_image_fn`` up to
    float association), or None when the decoder cannot be linearized or
    the linearization fails its self-check. The model is put in eval mode
    first: the segments hold its running norm statistics, as JAX's do."""
    model.eval()
    segs = _decoder_affine_segments(model)
    if segs is None or not _verify_affine_segments(model, segs):
        return None

    def decode_fn(z):
        return _mlp_forward(segs, z)

    decode_fn.device = _model_device(model)
    # primal and tangent: two multiply-adds per matrix entry each
    decode_fn.jvp_flops_per_sample = float(
        sum(4 * M.shape[0] * M.shape[1] for M, _ in segs))
    return decode_fn


def conv_decoder_jvp_flops_per_sample(model) -> Optional[float]:
    """Analytic JVP FLOPs per sample of the conv spatial decoder on a 1x1
    latent grid: the 1x1 ``conv_in``, then each 4x4 stride-2 transposed
    conv at out_H * out_W * 16 * Cin * Cout multiply-adds (the grid goes
    1 -> 2 -> 4, then the head to 8, or to 2 * 4 - 4 = 4 at 28 px), two
    FLOPs a multiply-add, primal and tangent. None for other decoders."""
    if (getattr(model, "topology", None) != "spatial"
            or model.output_image_size not in (28, 32)):
        return None
    chs = tuple(model.dec_channels)
    macs = float(model.latent_dim * chs[0])
    size = 1
    dims = list(chs) + [model.in_channels]
    for i in range(len(chs)):
        if i == len(chs) - 1 and model.output_image_size == 28:
            size = 2 * size - 4  # the 28-px head's padding: out = 2 in - 4
        else:
            size = 2 * size
        macs += size * size * 16 * dims[i] * dims[i + 1]
    return 4.0 * macs


def _mlp_decode_fn_cached(decode_fn) -> Optional[Callable]:
    if not hasattr(decode_fn, "_mlp_cache"):
        model = getattr(decode_fn, "model", None)
        decode_fn._mlp_cache = (build_mlp_decode_fn(model)
                                if model is not None else None)
    return decode_fn._mlp_cache


def _chunk_norms(decode_fn, za: torch.Tensor, zb: torch.Tensor):
    """Half-sum of endpoint JVP norms for one edge chunk: both endpoints in
    one decoder linearization over the concatenated batch."""
    v = zb - za
    _, jvp = torch.func.jvp(decode_fn, (torch.cat([za, zb]),),
                            (torch.cat([v, v]),))
    norms = torch.linalg.vector_norm(jvp.float(), dim=1)
    return 0.5 * (norms[:za.shape[0]] + norms[za.shape[0]:])


def _chunk_block(n_items: int, chunk: int, mesh) -> Tuple[int, int, int]:
    """(start, stop, padded) items of this rank's block of ``chunk``-sized
    chunks: the chunk count padded to a multiple of the world size, then
    split in contiguous blocks (JAX's ``n_chunks`` padding)."""
    n_chunks = pad_to_multiple(-(-n_items // chunk),
                               1 if mesh is None else mesh.world_size)
    c0, c1 = shard_range(n_chunks, mesh)
    return min(c0 * chunk, n_items), min(c1 * chunk, n_items), \
        n_chunks * chunk


def edge_lengths_riemannian_indexed(decode_fn: Callable, z, rows: np.ndarray,
                                    cols: np.ndarray, batch_size: int = 4096,
                                    device=None, mesh=None) -> np.ndarray:
    """Riemannian lengths of edges (rows[e], cols[e]) with endpoints
    gathered on the device from the latent table ``z``, ``batch_size``
    edges per decoder pass. ``device`` defaults to ``decode_fn.device``;
    ``mesh`` shards the chunks over its ranks."""
    dev = resolve_device(device if device is not None
                         else getattr(decode_fn, "device", None))
    rows = np.asarray(rows)
    e = rows.shape[0]
    if e == 0:
        return np.empty((0,), np.float32)
    es, ee, e_pad = _chunk_block(e, batch_size, mesh)
    z_t = torch.from_numpy(np.ascontiguousarray(z, np.float32)).to(dev)
    r_t = torch.from_numpy(rows[es:ee].astype(np.int64)).to(dev)
    c_t = torch.from_numpy(np.asarray(cols)[es:ee].astype(np.int64)).to(dev)
    out = torch.empty(ee - es, dtype=torch.float32, device=dev)
    with torch.no_grad():
        for s in range(0, ee - es, batch_size):
            r, c = r_t[s:s + batch_size], c_t[s:s + batch_size]
            out[s:s + batch_size] = _chunk_norms(decode_fn, z_t[r], z_t[c])
    out = all_gather_rows(out, e_pad, mesh)[:e]
    return out.cpu().numpy()


def edge_lengths_riemannian(decode_fn: Callable, z_start, z_end,
                            batch_size: int = 512,
                            device=None, mesh=None) -> np.ndarray:
    """Riemannian lengths of E edges given by their endpoints, flat (E, D)
    or spatial (E, H, W, C); returns (E,) float32. ``batch_size`` edges go
    through one decoder linearization (both endpoints at once). The JAX
    package pads the last chunk with zero latents; in eval mode that
    padding changes no valid row, so the last chunk here is just shorter.
    ``device`` defaults to ``decode_fn.device``; ``mesh`` shards the
    chunks over its ranks."""
    z_start = np.asarray(z_start, np.float32)
    z_end = np.asarray(z_end, np.float32)
    if z_start.shape != z_end.shape:
        raise ValueError("Start and end points must have same shape")
    e = np.arange(z_start.shape[0])
    return edge_lengths_riemannian_indexed(
        decode_fn, np.concatenate([z_start, z_end]), e, e + len(e),
        batch_size=batch_size, device=device, mesh=mesh)


def edge_lengths_riemannian_auto(decode_fn: Callable, z: np.ndarray,
                                 rows: np.ndarray, cols: np.ndarray,
                                 batch_size: int = _AUTO_DEFAULT_BATCH,
                                 engine: str = "auto",
                                 device=None, mesh=None) -> np.ndarray:
    """Riemannian edge-length engine dispatch.

    ``engine``: ``auto`` — the linearized matmul decoder (``mlp``) when the
    model supports it and passes its self-check, else the conv
    ``edgewise`` engine; ``mlp`` / ``edgewise`` / ``nodal`` force one
    (``mlp`` raises when the decoder cannot be linearized). The mlp
    engine's live buffers are small, so at the default ``batch_size`` it
    takes 16384 edges per pass; an explicit ``batch_size`` is kept.
    ``mesh`` shards every engine's chunks over its ranks.
    """
    if engine not in ("auto", "mlp", "edgewise", "nodal"):
        raise ValueError(f"unknown Riemannian engine {engine!r}")
    model = getattr(decode_fn, "model", None)
    conv_flops = (conv_decoder_jvp_flops_per_sample(model)
                  if model is not None else None)
    if engine == "nodal":
        t0 = time.perf_counter()
        out = edge_lengths_riemannian_nodal(decode_fn, z, rows, cols,
                                            batch_size=batch_size,
                                            device=device, mesh=mesh)
        d = int(np.shape(z)[-1])
        _record("nodal", int(np.shape(z)[0]) * d, conv_flops, t0)
        return out
    mlp_fn = None
    if engine in ("auto", "mlp"):
        mlp_fn = _mlp_decode_fn_cached(decode_fn)
        if engine == "mlp" and mlp_fn is None:
            raise ValueError(
                "engine=mlp: decoder cannot be linearized (needs spatial "
                "topology, batch/none norm, f32 weights)")
    z = np.asarray(z, np.float32)
    t0 = time.perf_counter()  # the pass alone, as JAX times it
    if mlp_fn is not None:
        mlp_bs = 16384 if batch_size == _AUTO_DEFAULT_BATCH else batch_size
        out = edge_lengths_riemannian_indexed(
            mlp_fn, z.reshape(z.shape[0], -1), rows, cols,
            batch_size=mlp_bs, device=device, mesh=mesh)
        _record("mlp", 2 * len(rows), mlp_fn.jvp_flops_per_sample, t0)
        return out
    out = edge_lengths_riemannian_indexed(
        decode_fn, z, rows, cols, batch_size=batch_size, device=device,
        mesh=mesh)
    _record("edgewise", 2 * len(rows), conv_flops, t0)
    return out


def _record(engine: str, samples: int, flops: Optional[float],
            t0: float) -> None:
    RIEM_STATS.append({"engine": engine, "samples": int(samples),
                       "jvp_flops_per_sample": flops,
                       "seconds": time.perf_counter() - t0})


def _pullback_chunk(decode_fn, zb: torch.Tensor) -> torch.Tensor:
    """(B, D, D) metrics J^T J of the nodes ``zb`` (B, D): one JVP over
    the nodes repeated D times against the tiled identity."""
    b, d = zb.shape
    basis = torch.eye(d, dtype=zb.dtype, device=zb.device).repeat(b, 1)
    _, jt = torch.func.jvp(decode_fn, (zb.repeat_interleave(d, dim=0),),
                           (basis,))
    jt = jt.float().reshape(b, d, -1)
    return torch.einsum("bip,bjp->bij", jt, jt)


@torch.no_grad()
def _pullback_metrics(decode_fn, z_t: torch.Tensor, batch_size: int,
                      mesh=None) -> torch.Tensor:
    n, d = z_t.shape
    bs = max(1, min(batch_size // max(d, 1), n))
    ns, ne, n_pad = _chunk_block(n, bs, mesh)
    out = torch.empty((ne - ns, d, d), dtype=torch.float32,
                      device=z_t.device)
    for s in range(ns, ne, bs):
        out[s - ns:s - ns + bs] = _pullback_chunk(decode_fn,
                                                  z_t[s:min(s + bs, ne)])
    out = all_gather_rows(out, n_pad, mesh)[:n]
    return out


def pullback_metrics(decode_fn: Callable, z: np.ndarray,
                     batch_size: int = 1024, device=None) -> np.ndarray:
    """(N, D, D) pullback metrics of all nodes; ``batch_size`` bounds the
    decoder batch (``batch_size // D`` nodes a chunk). ``device`` defaults
    to ``decode_fn.device``."""
    dev = resolve_device(device if device is not None
                         else getattr(decode_fn, "device", None))
    z = np.asarray(z, np.float32)
    n, d = z.shape
    if n == 0:
        return np.empty((0, d, d), np.float32)
    z_t = torch.from_numpy(np.ascontiguousarray(z)).to(dev)
    return _pullback_metrics(decode_fn, z_t, batch_size).cpu().numpy()


def _lengths_from_metrics(G: torch.Tensor, z: torch.Tensor,
                          rows: torch.Tensor, cols: torch.Tensor
                          ) -> torch.Tensor:
    v = z[cols] - z[rows]
    qa = torch.einsum("ei,eij,ej->e", v, G[rows], v)
    qb = torch.einsum("ei,eij,ej->e", v, G[cols], v)
    return 0.5 * (torch.sqrt(torch.clamp_min(qa, 0.0))
                  + torch.sqrt(torch.clamp_min(qb, 0.0)))


def edge_lengths_riemannian_nodal(decode_fn: Callable, z: np.ndarray,
                                  rows: np.ndarray, cols: np.ndarray,
                                  batch_size: int = 1024,
                                  edge_block: int = 1_048_576,
                                  device=None, mesh=None) -> np.ndarray:
    """Riemannian lengths of edges (rows[e], cols[e]) through per-node
    pullback metrics (the edgewise quantity up to float association),
    ``edge_block`` edges at a time; the metrics stay on the device.
    ``device`` defaults to ``decode_fn.device``; ``mesh`` shards the node
    chunks and the edge blocks over its ranks."""
    dev = resolve_device(device if device is not None
                         else getattr(decode_fn, "device", None))
    z = np.asarray(z, np.float32)
    rows = np.asarray(rows)
    e = rows.shape[0]
    z_t = torch.from_numpy(np.ascontiguousarray(z)).to(dev)
    G = _pullback_metrics(decode_fn, z_t, batch_size, mesh)
    if e == 0:
        return np.empty((0,), np.float32)
    es, ee, e_pad = _chunk_block(e, edge_block, mesh)
    r_t = torch.from_numpy(rows[es:ee].astype(np.int64)).to(dev)
    c_t = torch.from_numpy(np.asarray(cols)[es:ee].astype(np.int64)).to(dev)
    out = torch.empty(ee - es, dtype=torch.float32, device=dev)
    with torch.no_grad():
        for s in range(0, ee - es, edge_block):
            out[s:s + edge_block] = _lengths_from_metrics(
                G, z_t, r_t[s:s + edge_block], c_t[s:s + edge_block])
    out = all_gather_rows(out, e_pad, mesh)[:e]
    return out.cpu().numpy()
