"""Smoke tests for the example scripts (the reference ships its examples
as executable notebooks run via ``jupyter nbconvert --execute``,
examples/makefile:1-10 — these are the equivalent guard for our runnable
scripts).

Each example runs in a subprocess at tiny scale (NSIDE/EPOCHS from env);
the child selects the CPU platform via jax.config, then ``exec``s the
script as ``__main__``.
"""

import os
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_RUNNER = (
    "import jax; jax.config.update('jax_platforms', 'cpu'); "
    "exec(open({path!r}).read())"
)


def _run_example(name, env_extra, timeout=480):
    env = dict(os.environ)
    env.update(env_extra)
    env["PYTHONPATH"] = _REPO
    path = os.path.join(_REPO, "examples", name)
    proc = subprocess.run(
        [sys.executable, "-c", _RUNNER.format(path=path)],
        cwd=_REPO, env=env, capture_output=True, text=True, timeout=timeout,
    )
    assert proc.returncode == 0, (
        f"{name} failed\nstdout:\n{proc.stdout[-2000:]}\n"
        f"stderr:\n{proc.stderr[-2000:]}"
    )
    return proc.stdout


def test_quick_start_runs():
    out = _run_example("quick_start.py", {"NSIDE": "8", "EPOCHS": "2"})
    assert "accuracy" in out or "loss" in out


@pytest.mark.slow
def test_advanced_masked_runs():
    _run_example("advanced_masked.py", {"NSIDE": "8", "EPOCHS": "2"})


@pytest.mark.slow
def test_autoencoder_runs():
    _run_example("autoencoder.py", {"NSIDE": "8", "EPOCHS": "2"})


@pytest.mark.slow  # tests/test_serve.py covers the export/runtime units
def test_serving_runs():
    out = _run_example("serving.py", {"NSIDE": "8",
                                      "ARTIFACT": "/tmp/_ex_serve.dsx"})
    assert "exported" in out and "batch   7: accuracy" in out


@pytest.mark.slow  # 8-way SPMD compile is minutes on 1 core
def test_multichip_train_runs():
    out = _run_example("multichip_train.py", {"NSIDE": "8", "STEPS": "4",
                                              "PIXEL": "4"})
    assert "mesh: data=2 x pixel=4" in out and "step 4: loss" in out
