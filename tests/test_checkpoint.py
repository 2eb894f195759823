"""Checkpoint / resume of the inverse-rendering loop (SURVEY.md §5).

The reference has no checkpointing (output PPM is the only artifact); ours
saves the scene-param pytree + optax state with orbax every N steps and
resumes by path. This drives the real CLI end-to-end: run → kill → resume →
verify the loop continues from the saved step with identical state.
"""

import json

import numpy as np
import pytest

from raytracer import cli


def _run(argv, capsys):
    cli.main(argv)
    out = capsys.readouterr().out
    steps = [json.loads(l) for l in out.splitlines()
             if l.startswith('{"step"')]
    return out, steps


@pytest.mark.slow
def test_optimize_checkpoint_resume(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    base = ["optimize", "--lr", "5e-2", "--log-every", "1",
            "--ckpt-every", "2", "--checkpoint", ck]

    # phase 1: 5 steps (checkpoints at 0,2,4 + final 4)
    _, s1 = _run(base + ["--steps", "5", "--out", str(tmp_path / "a.png")],
                 capsys)
    assert [s["step"] for s in s1] == [0, 1, 2, 3, 4]
    assert s1[-1]["loss"] < s1[0]["loss"]

    # phase 2: resume → continues at step 5, not 0
    out2, s2 = _run(base + ["--steps", "8", "--resume",
                            "--out", str(tmp_path / "b.png")], capsys)
    assert "resumed from step 4" in out2
    assert [s["step"] for s in s2] == [5, 6, 7]

    # phase 3: the resumed trajectory equals an uninterrupted 8-step run
    # step-for-step (state round-trip is exact: params + optimizer moments)
    ck2 = str(tmp_path / "ck2")
    _, s3 = _run(["optimize", "--lr", "5e-2", "--log-every", "1",
                  "--ckpt-every", "2", "--checkpoint", ck2, "--steps", "8",
                  "--out", str(tmp_path / "c.png")], capsys)
    by_step = {s["step"]: s["loss"] for s in s3}
    for s in s2:
        np.testing.assert_allclose(s["loss"], by_step[s["step"]],
                                   rtol=1e-5, atol=1e-8)
