"""The benchmark's operation counts, K1's bound and the trace arithmetic
against hand counts at small shapes."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from portbench import tracing, yardstick


@pytest.mark.parametrize("n, k, s, p", [(4, 3, 2, 1), (28, 3, 2, 1),
                                        (7, 3, 2, 1), (5, 1, 1, 0)])
def test_conv_taps_count_the_kept_products(n, k, s, p):
    # a convolution of ones by ones sums, at each output, its in-bounds taps
    ones = F.conv2d(torch.ones(1, 1, n, n), torch.ones(1, 1, k, k),
                    stride=s, padding=p)
    assert yardstick.conv_taps_1d(n, k, s, p) ** 2 == int(ones.sum())


@pytest.mark.parametrize("n, k, s, p", [(1, 4, 2, 1), (2, 4, 2, 1),
                                        (4, 4, 2, 3), (16, 4, 2, 3),
                                        (16, 4, 2, 1)])
def test_deconv_taps_count_the_kept_products(n, k, s, p):
    ones = F.conv_transpose2d(torch.ones(1, 1, n, n), torch.ones(1, 1, k, k),
                              stride=s, padding=p)
    assert yardstick.deconv_taps_1d(n, k, s, p) ** 2 == int(ones.sum())
    assert yardstick.deconv_out(n, k, s, p) == ones.shape[-1]


def test_hand_counts_small_shapes():
    # 4 -> 2 by k3 s2 p1: output 0 keeps taps 1, 2; output 1 keeps 0..2
    assert yardstick.conv_taps_1d(4, 3, 2, 1) == 5
    # 1 -> 2 by k4 s2 p1: the one input reaches outputs 0, 1
    assert yardstick.deconv_taps_1d(1, 4, 2, 1) == 2


def _vae_cfg(c=1, image=28, lat=2, enc=(2, 3, 4), dec=(4, 3, 2)):
    return {"vae": {"in_channels": c, "image_size": image, "latent_dim": lat,
                    "enc_channels": list(enc), "dec_channels": list(dec)}}


def test_vae_forward_flops_by_hand():
    cfg = _vae_cfg()
    t = yardstick.conv_taps_1d
    d = yardstick.deconv_taps_1d
    enc = (2 * 1 * 2 * t(28, 3, 2, 1) ** 2 + 2 * 2 * 3 * t(14, 3, 2, 1) ** 2
           + 2 * 3 * 4 * t(7, 3, 2, 1) ** 2 + 2 * 2 * 4 * 2 * 16)
    dec = (2 * 2 * 4 * 16 + 2 * 4 * 3 * d(4, 4, 2, 1) ** 2
           + 2 * 3 * 2 * d(8, 4, 2, 1) ** 2 + 2 * 2 * 1 * d(16, 4, 2, 3) ** 2)
    assert yardstick.vae_forward_flops(cfg) == enc + dec


def test_riemannian_flops_on_a_1x1_grid():
    cfg = _vae_cfg()
    one = (2 * 2 * 4 * 1 + 2 * 4 * 3 * 2 ** 2 + 2 * 3 * 2 * 6 ** 2
           + 2 * 2 * 1 * 8 ** 2)
    assert yardstick.riemannian_flops(cfg, 10) == 10 * 2 * 2 * one


def test_k1_bound_takes_the_larger_of_work_and_bytes():
    # many rows of few dims: the distance products bound it
    big = yardstick.k1_bound_seconds(1 << 18, 1 << 18, 16, 21)
    assert big == pytest.approx(2 * (1 << 36) * 16 / yardstick.TF32_FLOPS)
    # one query against a few rows: the bytes bound it
    small = yardstick.k1_bound_seconds(1, 4, 2, 1)
    assert small == pytest.approx(((1 + 4) * 2 * 4 + 1 * 1 * 8)
                                  / yardstick.HBM_BYTES_PER_S)


def test_union_and_gaps():
    s = np.array([0, 5, 12, 30], np.int64) * 1000
    e = np.array([10, 8, 20, 31], np.int64) * 1000
    # [0, 10] holds [5, 8]; then [12, 20] and [30, 31]
    assert tracing.union_seconds(s, e) == pytest.approx(19e-6)
    assert tracing.idle_gaps(s, e) == [(10000, 12000), (20000, 30000)]
    tr = tracing.Trace(1.0, s, e, ["a", "b", "a", "c"],
                       np.array([19000, 21000], np.int64),
                       np.array([40000, 29000], np.int64), ["outer", "inner"])
    assert tr.busy_s == pytest.approx(19e-6)
    assert tr.device_ops()[0] == ["a", pytest.approx(18e-6)]
    # the second gap's midpoint (25 us) lies in both host ops and the inner
    # one names it; no op runs at the first's (11 us)
    assert tr.idle_by_host() == [["inner", pytest.approx(10e-6)],
                                 ["host, between ops", pytest.approx(2e-6)]]
