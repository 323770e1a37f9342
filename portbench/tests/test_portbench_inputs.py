"""Every input is the same for one seed and differs for another, for the
driver's seeds past 32 bits too."""
import pytest
import torch

from portbench import inputs
from portbench.reference import vae as ref_vae

CFG = {"vae": {"in_channels": 3, "image_size": 32, "latent_dim": 4,
               "enc_channels": [4, 8, 8], "dec_channels": [8, 8, 4]}}
SEEDS = (2121692627, 2 ** 40 + 3)


def _all(seed):
    out = {}
    out["images"], out["labels"] = inputs.images(64, (32, 32, 3), True,
                                                 seed, 1, "cpu", chunk=16)
    out["latents"] = inputs.clustered_latents(8, 4, 4, 3, 1.2, 1.0, seed,
                                              21, "cpu")
    for k, v in ref_vae.initial_state(CFG, seed, 3, "cpu").items():
        out[f"vae.{k}"] = v
    for k, v in ref_vae.initial_state(CFG, seed, 22, "cpu",
                                      random_stats=True).items():
        out[f"dec.{k}"] = v
    return out


def test_same_seed_same_inputs_other_seed_other_inputs():
    a, b, c = _all(SEEDS[0]), _all(SEEDS[0]), _all(SEEDS[1])
    assert a.keys() == b.keys() == c.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    drawn = [k for k in a if a[k].is_floating_point()
             and a[k].float().std() > 0] + ["labels"]
    assert len(drawn) > 20
    for k in drawn:
        assert not torch.equal(a[k], c[k]), k


def test_images_lie_in_range_and_classes_vary():
    x, lab = inputs.images(256, (28, 28, 1), False, 5, 1, "cpu")
    assert x.shape == (256, 28, 28, 1) and x.dtype == torch.float32
    assert float(x.min()) >= 0.0 and float(x.max()) <= 1.0
    assert len(torch.unique(lab)) == 10


def test_weights_follow_their_specs():
    w = inputs.weights([("a", (3, 4), "lecun", 4), ("b", (5,), "zeros", None),
                        ("c", (2, 2), "uniform", (0.5, 1.5)),
                        ("d", (1000,), "normal", 0.02)], 7, 1, "cpu")
    lim = 2 * (1 / 2) / inputs.TRUNC_STD
    assert float(w["a"].abs().max()) <= lim + 1e-6
    assert torch.equal(w["b"], torch.zeros(5))
    assert 0.5 <= float(w["c"].min()) and float(w["c"].max()) <= 1.5
    assert float(w["d"].std()) == pytest.approx(0.02, rel=0.15)
