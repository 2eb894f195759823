"""Host-side plumbing: the compile-cache helper, tracer selection, the PNG
writer, the native build, and the elastic driver staying off the device."""

import os
import subprocess
import sys
import zlib

import numpy as np
import pytest

from raytracer.utils import cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cache_dir_in_child(env_dir):
    """What a fresh process ends up with after setup_compile_cache()."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    code = ("import jax\n"
            "from raytracer.utils.cache import setup_compile_cache\n"
            "print(setup_compile_cache())\n"
            "print(jax.config.jax_compilation_cache_dir)\n")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.split()


def test_compile_cache_honours_env(tmp_path):
    got, jax_sees = _cache_dir_in_child(str(tmp_path / "cc"))
    assert got == jax_sees == str(tmp_path / "cc")


def test_compile_cache_default_is_in_checkout():
    got, jax_sees = _cache_dir_in_child(None)
    assert got == jax_sees == os.path.join(REPO, ".jax_cache")
    assert cache.DEFAULT_DIR == os.path.join(REPO, ".jax_cache")


@pytest.mark.parametrize("kind", ["pallas", "mat", "grid-pallas"])
def test_build_tracer_rejects_removed_kinds(kind):
    from raytracer.models import presets
    from raytracer.utils.hostload import build_tracer

    scene, _, _ = presets.config1_sphere_plane()
    with pytest.raises(ValueError, match="grid and BVH"):
        build_tracer(scene, kind)


def test_png_writer_without_pillow(tmp_path):
    from raytracer.io.image import save_png, to_u8

    img = np.random.default_rng(0).random((5, 7, 3))
    path = tmp_path / "x.png"
    save_png(str(path), img)
    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    i, chunks = 8, {}
    while i < len(data):
        n = int.from_bytes(data[i:i + 4], "big")
        tag, body = data[i + 4:i + 8], data[i + 8:i + 8 + n]
        crc = int.from_bytes(data[i + 8 + n:i + 12 + n], "big")
        assert crc == zlib.crc32(tag + body)
        chunks[tag] = body
        i += 12 + n
    assert int.from_bytes(chunks[b"IHDR"][:4], "big") == 7
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    raw = raw.reshape(5, 1 + 7 * 3)
    assert (raw[:, 0] == 0).all()
    np.testing.assert_array_equal(raw[:, 1:].reshape(5, 7, 3), to_u8(img))


def test_native_build_concurrent(tmp_path):
    """Several processes building at once: one compiles, the others wait
    on the lock; every one loads a complete library."""
    so = str(tmp_path / "librt_native.so")
    code = ("import sys\n"
            "from raytracer.utils.native import build_native, _NativeLib\n"
            "import ctypes\n"
            "assert build_native(sys.argv[1])\n"
            "assert _NativeLib(ctypes.CDLL(sys.argv[1])).has_bvh\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code, so], env=env,
                              cwd=REPO, stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        if p.returncode != 0 and "build_native" in err:
            pytest.skip("no C++ compiler")
        assert p.returncode == 0, err
    assert os.path.exists(so)


def test_elastic_driver_never_initialises_a_backend():
    """The --resilient parent launches one worker per band; it must not
    hold the card itself (a JAX process reserves most of its memory)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    code = ("from raytracer.utils.elastic import render_resilient\n"
            "from jax._src import xla_bridge\n"
            "img, rep = render_resilient(config='config1', width=32,\n"
            "                            band_rows=16)\n"
            "assert rep.bands_ok == 2 and img.shape == (32, 32, 3)\n"
            "assert not xla_bridge.backends_are_initialized()\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr[-2000:]
