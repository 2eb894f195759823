"""chip_smoke.py's phases at tiny sizes on the CPU (kernels interpreted),
and its refusal to run without a GPU. The full-size run is on the card:
`python chip_smoke.py`."""

import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("phase", [
    "fused_forward_config2", "fused_forward_config3", "fused_train",
    "glass_train", "goldens", "mesh_forward", "optimize", "config5_fd"])
def test_phase_runs_tiny(phase):
    run = {
        "fused_forward_config2":
            lambda: cs.phase_fused_forward("config2", 64, 32, 2,
                                           interpret=True),
        "fused_forward_config3":
            lambda: cs.phase_fused_forward("config3", 32, 32, 1,
                                           interpret=True),
        "fused_train":
            lambda: cs.phase_fused_train(64, 32, 1, interpret=True),
        "glass_train": lambda: cs.phase_glass_train(32, 32, 2),
        "goldens": lambda: cs.phase_goldens((("config2", 96, 96),)),
        "mesh_forward": lambda: cs.phase_mesh_forward(96, 54, 2),
        "optimize": lambda: cs.phase_optimize(3),
        "config5_fd": lambda: cs.phase_config5_fd(128, 128),
    }[phase]
    run()


def test_sharded_phases_on_virtual_devices():
    """The --cards 4 phases on four of the conftest's CPU devices."""
    cs.phase_sharded_frame(64, 36, 2)
    cs.phase_sharded_train()


def test_check_raises_past_limit():
    cs.check("inside", 0.5, 1.0)
    with pytest.raises(cs.CheckFailed):
        cs.check("outside", 2.0, 1.0)


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py", *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_no_gpu_fails_without_result(tmp_path):
    """No GPU → non-zero exit and no JSON line, in the repo and in a
    directory that holds chip_smoke.py alone."""
    for cwd in (REPO, tmp_path):
        if cwd == tmp_path:
            shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        r = _run([], cwd)
        assert r.returncode != 0, r.stdout
        assert '"ok"' not in r.stdout
