"""Elastic band recovery: subprocess re-dispatch + split-retry + zero-fill.

SURVEY.md §5 "Failure detection / elastic recovery / fault injection" —
render steps are stateless/idempotent, so recovery = re-dispatch the failed
band. Fault injection env hooks (utils/elastic.py) let CPU CI exercise the
paths a crashed band process takes.
"""

import numpy as np
import pytest

from raytracer.utils.elastic import render_resilient


@pytest.fixture
def cpu_subproc_env(monkeypatch):
    """Band workers are fresh processes: put them on the CPU the same way
    tests/test_multiprocess.py does (conftest's in-process config does not
    propagate)."""
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.delenv("PJRT_LIBRARY_PATH", raising=False)


@pytest.fixture(scope="module")
def reference():
    """Fault-free single-band worker render. Same subprocess env as the
    faulted runs — band assembly is bitwise (test_bands.py proves band ==
    full-frame slice; this pins the driver's splicing); the in-process
    conftest renderer differs by ~1e-5 (different XLA CPU vectorization in
    the 8-device sim process), so the oracle-vs-render math is asserted by
    the golden tests, not here."""
    import os

    # module-scoped ⇒ instantiated BEFORE the function-scoped env fixture:
    # put the workers on the CPU itself
    prev = {k: os.environ.get(k) for k in ("JAX_PLATFORMS",)}
    os.environ["JAX_PLATFORMS"] = "cpu"
    try:
        img, rep = render_resilient(config="config1", width=64, band_rows=64,
                                    min_rows=8, retry_wait=0)
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    assert rep.bands_ok == 1 and rep.bands_failed == 0
    return img


@pytest.mark.slow
def test_resilient_recovers_from_transient_faults(tmp_path, monkeypatch,
                                                  cpu_subproc_env, reference):
    """First two workers crash (countdown injection) → backoff + split +
    re-dispatch must still produce the exact full frame."""
    cd = tmp_path / "countdown.txt"
    cd.write_text("2")
    monkeypatch.setenv("RT_FAULT_COUNTDOWN_FILE", str(cd))
    img, rep = render_resilient(config="config1", width=64, band_rows=16,
                                min_rows=8, retry_wait=0)
    assert cd.read_text() == "0"          # both injected faults consumed
    assert rep.bands_failed == 0 and not rep.failed_rows
    assert rep.retries >= 2
    np.testing.assert_array_equal(img, reference)


@pytest.mark.slow
def test_resilient_zero_fills_permanent_faults(monkeypatch, cpu_subproc_env,
                                               reference):
    """A permanently poisoned row range ends as zero-filled terminal pieces
    with every other band exact (partial frame beats no frame)."""
    monkeypatch.setenv("RT_FAULT_ROWS", "16-32")
    img, rep = render_resilient(config="config1", width=64, band_rows=16,
                                min_rows=8, retry_wait=0)
    monkeypatch.delenv("RT_FAULT_ROWS")
    assert rep.bands_failed == 2          # two terminal 8-row pieces
    assert sorted(rep.failed_rows) == [(16, 8), (24, 8)]
    assert (img[16:32] == 0).all()
    np.testing.assert_array_equal(img[:16], reference[:16])
    np.testing.assert_array_equal(img[32:], reference[32:])


@pytest.mark.slow
def test_optimize_supervised_survives_crashes(tmp_path, monkeypatch, capfd):
    """`optimize --supervise`: children crash every 3 steps (injected);
    auto-restart + exact orbax resume must still complete all 8 steps with
    the same per-step losses as an uncrashed child."""
    import json

    from raytracer import cli

    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.delenv("PJRT_LIBRARY_PATH", raising=False)

    def run(ck, out):
        cli.main(["optimize", "--steps", "8", "--lr", "5e-2",
                  "--ckpt-every", "2", "--log-every", "1",
                  "--checkpoint", ck, "--supervise", "--out", out])
        o, e = capfd.readouterr()
        steps = {}
        for ln in o.splitlines():          # later children win on re-executed
            if ln.startswith('{"step"'):   # steps (exact resume ⇒ identical)
                d = json.loads(ln)
                steps[d["step"]] = d["loss"]
        return steps, e

    monkeypatch.setenv("RT_FAULT_AFTER_STEPS", "3")
    crashed, err = run(str(tmp_path / "ck1"), str(tmp_path / "a.png"))
    assert err.count("restarting with --resume") >= 2
    assert sorted(crashed) == list(range(8))

    monkeypatch.delenv("RT_FAULT_AFTER_STEPS")
    clean, err2 = run(str(tmp_path / "ck2"), str(tmp_path / "b.png"))
    assert "restarting" not in err2
    assert sorted(clean) == list(range(8))
    for s in range(8):
        np.testing.assert_allclose(crashed[s], clean[s], rtol=1e-6)


@pytest.mark.slow
def test_resilient_ssaa_recovers_and_averages(tmp_path, monkeypatch,
                                              cpu_subproc_env):
    """--resilient --ssaa: faulted run == fault-free run bitwise, and the
    per-band box-average matches averaging a raw 2× worker render."""
    clean, rep0 = render_resilient(config="config1", width=48, ssaa=2,
                                   band_rows=24, min_rows=8, retry_wait=0)
    assert rep0.bands_failed == 0

    cd = tmp_path / "cd.txt"
    cd.write_text("1")
    monkeypatch.setenv("RT_FAULT_COUNTDOWN_FILE", str(cd))
    img, rep = render_resilient(config="config1", width=48, ssaa=2,
                                band_rows=24, min_rows=8, retry_wait=0)
    assert rep.bands_failed == 0 and rep.retries >= 1
    np.testing.assert_array_equal(img, clean)

    monkeypatch.delenv("RT_FAULT_COUNTDOWN_FILE")
    hi, _ = render_resilient(config="config1", width=96, band_rows=96,
                             min_rows=8, retry_wait=0)  # raw 2x frame
    want = hi.reshape(48, 2, 48, 2, 3).mean(axis=(1, 3))
    np.testing.assert_allclose(clean, want, rtol=1e-6, atol=1e-6)
