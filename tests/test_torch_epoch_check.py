"""The rule of ``chip_smoke.py``'s held-step epoch check (phases 13 and
17c), on synthetic gaps.

On the card each of the epoch's steps runs from the CPU's state before it;
its (loss, recon, kl) gap and phase 7's gradient gap must sit within
``HELD_LIMITS`` at every step, and the TF32 control must lie past them at
every step. These tests hold ``held_step_verdict`` to that rule without a
card or a model.
"""
import importlib.util
import math
from pathlib import Path

import pytest

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
cs = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(cs)

LIMITS = {"loss": 1e-6, "grad": 2e-3}
PAST = {"loss": 1e-4, "grad": 2e-2}  # a TF32 control's gaps


def _steps(gap, n=3):
    return [dict(gap) for _ in range(n)]


def test_identical_runs_pass():
    ok, why = cs.held_step_verdict(_steps({"loss": 0.0, "grad": 0.0}),
                                   _steps(PAST), LIMITS)
    assert ok and why == ""


def test_gaps_at_the_limits_pass():
    ok, _ = cs.held_step_verdict(_steps(LIMITS), _steps(PAST), LIMITS)
    assert ok


@pytest.mark.parametrize("measure,value", [
    ("loss", 2e-6), ("grad", 3e-3), ("loss", math.nan), ("grad", math.inf),
])
def test_a_gap_past_its_limit_fails(measure, value):
    gaps = _steps({"loss": 0.0, "grad": 0.0})
    gaps[1][measure] = value
    ok, why = cs.held_step_verdict(gaps, _steps(PAST), LIMITS)
    assert not ok and "step 1" in why and measure in why


@pytest.mark.parametrize("step", [0, 2])
def test_a_control_within_every_limit_fails_the_phase(step):
    control = _steps(PAST)
    control[step] = {"loss": 0.0, "grad": 0.0}
    ok, why = cs.held_step_verdict(_steps({"loss": 0.0, "grad": 0.0}),
                                   control, LIMITS)
    assert not ok and f"step {step}" in why and "TF32" in why


def test_a_control_past_one_limit_is_enough():
    # the loss gap of a TF32 step can sit under its limit; the gradient
    # gap past its own still tells TF32 from f32
    control = _steps({"loss": 1e-7, "grad": 5e-2})
    ok, _ = cs.held_step_verdict(_steps({"loss": 0.0, "grad": 0.0}),
                                 control, LIMITS)
    assert ok


@pytest.mark.parametrize("n_gaps,n_control", [(0, 0), (3, 2)])
def test_missing_steps_fail(n_gaps, n_control):
    ok, _ = cs.held_step_verdict(_steps({"loss": 0.0, "grad": 0.0}, n_gaps),
                                 _steps(PAST, n_control), LIMITS)
    assert not ok


def test_limits_name_both_presets_and_measures():
    assert set(cs.HELD_LIMITS) == {"fashionmnist", "cifar10"}
    for limits in cs.HELD_LIMITS.values():
        assert set(limits) == {"loss", "grad"}
        assert all(0 < v < 1 for v in limits.values())


def test_one_step_gaps():
    ref = [2.0, 1.5, 0.5]
    assert cs.held_loss_gap([2.0, 1.5, 0.5], ref) == 0.0
    assert cs.held_loss_gap([2.0, 1.5, 0.504], ref) == pytest.approx(0.002)
    torch = pytest.importorskip("torch")
    a = {"w": torch.tensor([3.0, 4.0]), "b": torch.tensor([1.0])}
    b = {"w": torch.tensor([3.0, 4.5]), "b": torch.tensor([9.0])}
    assert cs.held_grad_gap(b, a, skip={"b"}) == pytest.approx(0.1)
    assert cs.held_grad_gap(b, a, skip=set()) == pytest.approx(8.0)
