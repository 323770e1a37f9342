"""Port parity: generation (``cli/generate_samples.py``), the PNG reader
(``utils/images.load_image``), the evaluator (``cli/evaluate_model.py``
with its PIL-bilinear ``_resize``) and LPIPS (``eval/lpips.py``).

- generation on carried-across JAX weights (a VAE ``.pt`` written by
  ``export_reference_vae_checkpoint``, transformer params through
  ``transformer_state_dict_from_jax``). Vanilla mode with top_k = 1 is
  deterministic (BOS prompt, greedy code), so both packages' PNGs must be
  within one gray level (the decoders differ in float order). Spatial mode
  draws its first token from each package's own RNG, so only the grid's
  size and range are checked.
- ``load_image`` equal to PIL's decode (same float32 division) on
  PIL-written gray, RGB and RGBA PNGs, on PNGs whose rows use each of the
  five filter types, and on the port's own PNGs.
- ``_resize`` bit-equal to PIL's ``resize(BILINEAR)`` at 30 -> 28 (a grid
  cell), 28 -> 64 and random sizes, gray and RGB.
- ``evaluate_model_main`` against JAX's on the same grid and synthetic
  split: PSNR and SSIM within rtol 1e-5 (they come out equal), the same
  ``metrics.yaml`` keys and comparison grid, LPIPS null with the same
  printed reason.
- ``lpips_distance`` against JAX's on random weights in the real shapes
  (an ``.npz`` in ``tmp_path``): within rtol 1e-4; the torch state-dict
  reader against JAX's.
"""
import struct
import zlib

import jax
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from vqvae_tpu.cli.evaluate_model import _resize as jax_resize
from vqvae_tpu.cli.evaluate_model import \
    evaluate_model_main as jax_evaluate_model_main
from vqvae_tpu.cli.generate_samples import \
    generate_samples_main as jax_generate_samples_main
from vqvae_tpu.config import load_config as jax_load_config
from vqvae_tpu.eval import lpips as jax_lpips
from vqvae_tpu.models import VAE as JaxVAE
from vqvae_tpu.models import Transformer as JaxTransformer
from vqvae_tpu.utils.checkpoint import Checkpointer
from vqvae_tpu.utils.images import save_image_grid as jax_save_image_grid
from vqvae_tpu.utils.torch_compat import export_reference_vae_checkpoint
from vqvae_tpu_torch.cli.evaluate_model import (_resize,
                                                evaluate_model_main,
                                                pil_bilinear_resize)
from vqvae_tpu_torch.cli.generate_samples import generate_samples_main
from vqvae_tpu_torch.config import load_config
from vqvae_tpu_torch.eval import lpips
from vqvae_tpu_torch.utils.checkpoint import transformer_state_dict_from_jax
from vqvae_tpu_torch.utils.images import load_image, save_image

ENC, DEC, LATENT = (8, 16, 32), (32, 16, 8), 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these ops are tiny, and several threads cost
    far more than the work on a shared host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _generate_inputs(tmp_path, topology, num_tokens, max_seq_len, k):
    vae_cfg = dict(in_channels=1, enc_channels=list(ENC),
                   dec_channels=list(DEC), latent_dim=LATENT,
                   recon_loss="mse", output_image_size=28, norm_type="batch",
                   mse_use_sigmoid=True, topology=topology)
    vae = JaxVAE(**{**vae_cfg, "enc_channels": ENC, "dec_channels": DEC})
    variables = _np_tree(jax.jit(lambda key: vae.init(
        {"params": key}, np.zeros((1, 28, 28, 1), np.float32)))(
            jax.random.key(0)))
    vae_pt = export_reference_vae_checkpoint(
        variables, tmp_path / "vae" / "best.pt", topology, ENC, DEC, "batch")
    tf_cfg = dict(num_classes=10, num_tokens=num_tokens, embed_dim=32,
                  n_layers=2, n_head=4, max_seq_len=max_seq_len, dropout=0.0)
    tf = JaxTransformer(**tf_cfg)
    params = _np_tree(jax.jit(lambda key: tf.init(
        {"params": key}, np.zeros((2, max_seq_len), np.int32),
        y=np.zeros(2, np.int32)))(jax.random.key(1))["params"])
    ckptr = Checkpointer(tmp_path / "tf_orbax")
    ckptr.save("best", {"params": params, "step": 0, "epoch": 1})
    ckptr.close()
    (tmp_path / "tf").mkdir()
    torch.save({"model_state_dict": transformer_state_dict_from_jax(params),
                "epoch": 1}, tmp_path / "tf" / "best.pt")
    rng = np.random.default_rng(2)
    np.savez(tmp_path / "codebook.npz",
             medoid_indices=np.arange(k, dtype=np.int32),
             z_medoid=rng.normal(0, 1, (k, LATENT)).astype(np.float32),
             config_json=np.bytes_(b"{}"))
    cfg = {
        "transformer_ckpt_path": str(tmp_path / "tf" / "best"),
        "vae_ckpt_path": str(vae_pt),
        "codebook_path": str(tmp_path / "codebook.npz"),
        "transformer": tf_cfg, "vae": vae_cfg,
        "dataset_name": "fashionmnist", "temperature": 1.0, "top_k": 1,
        "class_labels": list(range(10)), "samples_per_class": 3,
        "output_dir": str(tmp_path / "port"),
        "output_filename": "generated_samples.png", "seed": 0,
        "vanilla_vae": topology == "flat",
    }
    path = tmp_path / "generate.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def _pixels(path):
    return np.asarray(Image.open(path), np.int32)


def test_vanilla_greedy_generation_matches_jax(tmp_path):
    # 17 tokens over 16 codes: BOS (16) indexes past the codebook and is
    # clamped to its last row, as XLA clamps the gather
    path = _generate_inputs(tmp_path, "flat", num_tokens=17, max_seq_len=2,
                            k=16)
    want = jax_generate_samples_main(jax_load_config(path, {
        "transformer_ckpt_path": str(tmp_path / "tf_orbax" / "best"),
        "output_dir": str(tmp_path / "jax")}))
    got = generate_samples_main(load_config(path), device="cpu")
    assert got.name == want.name == "generated_samples.png"
    a, b = _pixels(got), _pixels(want)
    assert a.shape == b.shape == (10 * 30 + 2, 3 * 30 + 2)
    assert np.abs(a - b).max() <= 1


def test_spatial_generation_writes_the_grid(tmp_path):
    path = _generate_inputs(tmp_path, "spatial", num_tokens=32,
                            max_seq_len=16, k=32)
    out = generate_samples_main(load_config(path, {"top_k": 8}),
                                device="cpu")
    img = load_image(out)
    assert img.shape == (10 * 30 + 2, 3 * 30 + 2, 1)
    assert 0.0 <= img.min() and img.max() <= 1.0
    assert img[2:30, 2:30].std() > 0  # a decoded cell, not padding


def _png(arr, filters):
    """An 8-bit PNG of ``arr`` whose row ``y`` uses filter
    ``filters[y % len(filters)]`` (PIL's writer never picks Average on
    these images)."""
    h, w = arr.shape[:2]
    bpp = 1 if arr.ndim == 2 else arr.shape[2]
    rows = arr.reshape(h, w * bpp).astype(np.int64)
    raw = bytearray()
    prior = np.zeros(w * bpp, np.int64)
    for y in range(h):
        f = filters[y % len(filters)]
        cur = rows[y]
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        if f == 0:
            pred = np.zeros_like(cur)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prior
        elif f == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = (np.abs(p - left), np.abs(p - prior),
                          np.abs(p - upleft))
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, upleft))
        raw += bytes([f]) + ((cur - pred) % 256).astype(np.uint8).tobytes()
        prior = cur

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))
    ctype = {1: 0, 3: 2, 4: 6}[bpp]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunk(b"IEND", b""))


def _pil_load(path):
    img = np.asarray(Image.open(path), np.float32) / 255.0
    if img.ndim == 2:
        img = img[..., None]
    return img[..., :3] if img.shape[-1] == 4 else img


@pytest.mark.parametrize("channels", [None, 3, 4], ids=["L", "RGB", "RGBA"])
def test_load_image_equals_pil(tmp_path, channels):
    rng = np.random.default_rng(channels or 1)
    shape = (37, 29) if channels is None else (37, 29, channels)
    yy, xx = np.mgrid[:37, :29]
    smooth = (np.sin(yy / 5.0) * 60 + np.cos(xx / 7.0) * 60 + 128)
    if channels:
        smooth = np.repeat(smooth[..., None], channels, -1)
    noise = rng.integers(0, 256, shape)
    for k, arr in enumerate((smooth.astype(np.uint8), noise.astype(np.uint8),
                             (smooth / 2 + noise / 4).astype(np.uint8))):
        pil_path = tmp_path / f"pil{k}.png"
        Image.fromarray(arr).save(pil_path)
        got = load_image(pil_path)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, _pil_load(pil_path))
        forced = tmp_path / f"forced{k}.png"
        forced.write_bytes(_png(arr, filters=(0, 1, 2, 3, 4, 3, 1)))
        np.testing.assert_array_equal(load_image(forced), _pil_load(forced))
        np.testing.assert_array_equal(load_image(forced), got)


def test_load_image_reads_the_ports_own_pngs(tmp_path):
    rng = np.random.default_rng(5)
    for shape in ((20, 30, 1), (20, 30, 3)):
        img = rng.random(shape, dtype=np.float32)
        path = save_image(img, tmp_path / f"own{shape[-1]}.png")
        got = load_image(path)
        np.testing.assert_array_equal(got, _pil_load(path))
        assert np.abs(got - img).max() <= 0.5 / 255 + 1e-7


@pytest.mark.parametrize("src,size", [(30, 28), (28, 64), (28, 28),
                                      (64, 28), (17, 5)])
@pytest.mark.parametrize("channels", [1, 3])
def test_resize_equals_pil_bilinear(src, size, channels):
    rng = np.random.default_rng(src * size + channels)
    # float32 pixels k / 255 (as load_image gives them) and values between
    img = rng.integers(0, 256, (src, src, channels)).astype(
        np.float32) / 255.0
    img[::3] = rng.random((len(img[::3]), src, channels), dtype=np.float32)
    got = _resize(img, size)
    want = jax_resize(img, size)
    assert got.dtype == np.float32 and got.shape == (size, size, channels)
    np.testing.assert_array_equal(got, want)


def test_pil_bilinear_on_random_shapes():
    rng = np.random.default_rng(0)
    for trial in range(40):
        h, w = (int(v) for v in rng.integers(2, 60, 2))
        size = int(rng.integers(1, 80))
        shape = (h, w) if trial % 2 else (h, w, 3)
        arr = rng.integers(0, 256, shape).astype(np.uint8)
        want = np.asarray(Image.fromarray(arr).resize((size, size),
                                                      Image.BILINEAR))
        np.testing.assert_array_equal(pil_bilinear_resize(arr, size), want)


def _evaluate_config(tmp_path):
    rng = np.random.default_rng(3)
    images = rng.random((40, 28, 28, 1), dtype=np.float32)
    jax_save_image_grid(images, tmp_path / "generated_samples.png", nrow=4,
                        padding=2)
    cfg = {"data": {"dataset_name": "fashionmnist", "synthetic_size": 200},
           "dataset_name": "fashionmnist",
           "generated_path": str(tmp_path / "generated_samples.png"),
           "num_samples": 40, "samples_per_class": 4, "image_size": 28,
           "data_root": str(tmp_path / "no-data"),
           "out_dir": str(tmp_path / "port")}
    path = tmp_path / "evaluate.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def test_evaluate_matches_jax(tmp_path, monkeypatch, capsys):
    monkeypatch.delenv("LPIPS_WEIGHTS", raising=False)
    monkeypatch.chdir(tmp_path)  # no data/lpips_alex.npz here
    path = _evaluate_config(tmp_path)
    want = jax_evaluate_model_main(jax_load_config(
        path, {"out_dir": str(tmp_path / "jax")}))
    jax_out = capsys.readouterr().out
    got = evaluate_model_main(load_config(path), device="cpu")
    port_out = capsys.readouterr().out
    np.testing.assert_allclose(got["PSNR"], want["PSNR"], rtol=1e-5)
    np.testing.assert_allclose(got["SSIM"], want["SSIM"], rtol=1e-5)
    assert got["LPIPS"] is None and want["LPIPS"] is None

    def reason(text):
        return [line for line in text.splitlines() if "LPIPS: null" in line]
    assert reason(port_out) == reason(jax_out) and len(reason(port_out)) == 1

    ref = yaml.safe_load((tmp_path / "jax" / "metrics.yaml").read_text())
    have = yaml.safe_load((tmp_path / "port" / "metrics.yaml").read_text())
    assert set(have) == set(ref) == {"PSNR", "SSIM", "LPIPS", "PSNR_full",
                                     "SSIM_full", "LPIPS_full"}
    assert have["PSNR"] == ref["PSNR"] and have["SSIM"] == ref["SSIM"]
    assert np.isfinite(have["PSNR_full"]) and have["LPIPS_full"] is None
    np.testing.assert_array_equal(
        _pixels(tmp_path / "port" / "comparison_grid.png"),
        _pixels(tmp_path / "jax" / "comparison_grid.png"))


def _lpips_weights(rng):
    cfg = [(64, 3, 11), (192, 64, 5), (384, 192, 3), (256, 384, 3),
           (256, 256, 3)]
    w = {}
    for i, (cout, cin, k) in enumerate(cfg):
        w[f"conv{i}/kernel"] = (rng.normal(0, 1, (cout, cin, k, k))
                                * np.sqrt(2.0 / (cin * k * k))).astype(
                                    np.float32)
        w[f"conv{i}/bias"] = rng.normal(0, 0.01, cout).astype(np.float32)
        w[f"lin{i}"] = np.abs(rng.normal(0, 0.1, cout)).astype(np.float32)
    return w


@pytest.mark.parametrize("channels", [3, 1])
def test_lpips_matches_jax(tmp_path, channels):
    rng = np.random.default_rng(channels)
    path = tmp_path / "weights.npz"
    np.savez(path, **_lpips_weights(rng))
    a = rng.random((4, 28, 28, channels), dtype=np.float32)
    b = np.clip(a + rng.normal(0, 0.2, a.shape), 0, 1).astype(np.float32)
    want = jax_lpips.lpips_distance(a, b, weights_path=path)
    got = lpips.lpips_distance(a, b, weights_path=path, device="cpu")
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert lpips.lpips_distance(a, a, weights_path=path,
                                device="cpu") == pytest.approx(0, abs=1e-6)


def test_lpips_weight_search_and_torch_state_dict(tmp_path, monkeypatch):
    monkeypatch.delenv("LPIPS_WEIGHTS", raising=False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError, match="LPIPS weights not found"):
        lpips.lpips_distance(np.zeros((1, 8, 8, 3), np.float32),
                             np.zeros((1, 8, 8, 3), np.float32),
                             device="cpu")
    w = _lpips_weights(np.random.default_rng(0))
    sd = {}
    for i in range(5):
        sd[f"net.slice{i}.{2 * i}.weight"] = torch.from_numpy(
            w[f"conv{i}/kernel"])
        sd[f"net.slice{i}.{2 * i}.bias"] = torch.from_numpy(
            w[f"conv{i}/bias"])
        sd[f"lin{i}.model.1.weight"] = torch.from_numpy(
            w[f"lin{i}"].reshape(1, -1, 1, 1))
    torch.save(sd, tmp_path / "alex.pth")
    monkeypatch.setenv("LPIPS_WEIGHTS", str(tmp_path / "alex.pth"))
    assert lpips._find_weights() == jax_lpips._find_weights()
    got = lpips._load_weights(lpips._find_weights())
    want = jax_lpips._load_weights(jax_lpips._find_weights())
    assert set(got) == set(want) == set(w)
    for key in w:
        np.testing.assert_array_equal(got[key], want[key])
