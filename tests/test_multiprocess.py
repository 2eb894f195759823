"""Multi-process distributed bring-up test (SURVEY.md §4.4): the real
`jax.distributed.initialize` + sharded render across 2 localhost CPU
processes must equal the single-device render."""

import os
import socket
import subprocess
import sys

import pytest


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_render(tmp_path):
    port = _free_port()
    out = tmp_path / "ok.txt"
    env = dict(os.environ)
    env.pop("PJRT_LIBRARY_PATH", None)
    env["JAX_PLATFORMS"] = "cpu"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    worker = os.path.join(os.path.dirname(__file__), "dist_worker.py")
    procs = [subprocess.Popen(
        [sys.executable, worker, str(i), "2", str(port), str(out)],
        env=env, cwd=os.path.dirname(os.path.dirname(worker)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)]
    outs = []
    for p in procs:
        try:
            o, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            o, _ = p.communicate()
        outs.append(o)
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"proc {i} failed:\n{outs[i][-3000:]}"
    assert out.read_text() == "OK"
