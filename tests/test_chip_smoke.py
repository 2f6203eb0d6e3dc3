"""``chip_smoke.py``: every phase at tiny sizes on the CPU, its refusal to
run without a GPU, and (marked ``gpu``) its headline phase on a card."""

import os
import subprocess
import sys

import jax
import pytest

import chip_smoke as cs

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_refuses_to_run_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=_REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_phase_quickstart_tiny():
    r = cs.phase_quickstart(nside=16, batch=8, n_maps=16, epochs=2, K=10)
    assert r["losses"][-1] < r["losses"][0]
    assert r["weights_err"] <= 1e-6 and r["export_err"] <= 1e-6


def test_phase_headline_tiny():
    r = cs.phase_headline(nside=8, batch=2, iters=1)
    assert r["err_stencil"] <= cs.FWD_TOL and r["err_ellpack"] <= cs.FWD_TOL
    assert r["err_dx"] <= cs.GRAD_TOL and r["err_dw"] <= cs.GRAD_TOL
    # x, the 9 per-pixel weight planes and y, one float32 pass each
    M = 12 * 8 * 8
    assert r["floor_bytes"] == 4 * (M * 2 * 4 + 9 * M + M * 2 * 4)


def test_phase_fullsky_tiny():
    r = cs.phase_fullsky(nside=8, batch=2, steps=2)
    assert len(r["losses"]) == 2
    assert r["need_bytes"] > 0


def test_phase_k20_tiny():
    r = cs.phase_k20(nside=16, batch=2)
    assert r["err_stencil"] <= cs.FWD_TOL and r["err_dx"] <= cs.GRAD_TOL


def test_phase_smoothing_tiny():
    r = cs.phase_smoothing(nside=16, sigma_arcmin=300.0)
    assert r["reps"] >= 2  # the repetition chain is exercised
    assert r["err_stencil"] <= cs.FWD_TOL and r["err_dx"] <= cs.GRAD_TOL


def test_phase_four_tiny():
    """The --four comparison on four of the virtual CPU devices."""
    r = cs.phase_four(nside=8, devices=jax.devices()[:4])
    assert r["err_loss"] <= cs.FWD_TOL and r["err_grad"] <= cs.GRAD_TOL


def test_tree_rel_err_uses_the_largest_gradient():
    want = {"a": [1.0, -2.0], "b": [1e-9]}
    got = {"a": [1.0, -2.0], "b": [3e-9]}
    assert cs.tree_rel_err(got, want) == pytest.approx(1e-9)
    assert cs.rel_err([1.0, 2.5], [1.0, 2.0]) == pytest.approx(0.25)


@pytest.mark.gpu
def test_headline_phase_on_gpu(gpu):
    r = cs.phase_headline(nside=64, batch=2, iters=2)
    assert r["err_stencil"] <= cs.FWD_TOL and r["err_dw"] <= cs.GRAD_TOL
