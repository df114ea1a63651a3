"""chip_smoke.py: its refusals run here; the smoke itself needs a GPU."""

import json
import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _gpu_env():
    """The caller's environment without this suite's CPU pinning."""
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    return env


def _run(args, cwd, env):
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=1300,
    )


def _ok_line(stdout):
    lines = stdout.strip().splitlines()
    return lines and lines[-1].startswith("{") and json.loads(lines[-1]).get("ok") is True


def test_require_gpu_refuses_anything_else():
    with pytest.raises(SystemExit, match="needs an NVIDIA GPU"):
        chip_smoke.require_gpu({"platform": "cpu", "kind": "cpu", "count": 8})
    with pytest.raises(SystemExit, match="needs 4 GPUs"):
        chip_smoke.require_gpu({"platform": "gpu", "kind": "H100", "count": 1}, 4)
    chip_smoke.require_gpu({"platform": "gpu", "kind": "H100", "count": 1})


def test_refuses_a_cpu_backend_before_any_phase():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = _run(["chip_smoke.py"], REPO, env)
    assert p.returncode != 0
    assert "needs an NVIDIA GPU" in p.stderr
    assert "==" not in p.stdout and not _ok_line(p.stdout)


def test_refuses_to_run_outside_a_checkout(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    p = _run(["chip_smoke.py"], str(tmp_path), _gpu_env())
    assert p.returncode != 0 and not _ok_line(p.stdout)


def test_steady_epoch_time_is_read_from_one_chunk():
    lines = [
        "[Epoch 0010 TRAIN 2.500s] Loss: 1",
        "[Epoch 0011 TRAIN 0.512s] Loss: 1",
        "[Epoch 0012 TRAIN 0.512s] Loss: 1",
        "[Epoch 0012 TEST] Loss: 1",
    ]
    assert chip_smoke.steady_epoch_s(lines, 11, 12) == 0.512
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.steady_epoch_s(lines, 10, 12)


@pytest.fixture
def gpu_env():
    probe = _run(
        ["-c", "import jax; print(jax.devices()[0].platform)"], REPO, _gpu_env()
    )
    if probe.returncode or probe.stdout.strip().splitlines()[-1] != "gpu":
        pytest.skip("no NVIDIA GPU: chip_smoke.py runs on the card")
    return _gpu_env()


@pytest.mark.gpu
def test_chip_smoke_passes_on_the_gpu(gpu_env):
    """Phases 1-6 of chip_smoke.py on the card (about 15 minutes)."""
    p = _run(["chip_smoke.py"], REPO, gpu_env)
    assert p.returncode == 0, p.stdout[-4000:] + p.stderr[-4000:]
    assert _ok_line(p.stdout)
