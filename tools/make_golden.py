"""Regenerate the committed golden images (tests/golden/*.ppm) via the C++ oracle.

Usage: python tools/make_golden.py [--check]
Builds native/oracle if needed, exports each preset scene, renders at the
golden resolutions below, and writes tests/golden/<name>_<res>.ppm.
With --check, also renders each with the NumPy oracle at 64² and asserts the
two oracles agree (cross-validation of the ground-truth pair, SURVEY.md §4.1).
"""

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import dataclasses

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
NATIVE = os.path.join(REPO, "native")

# (preset name, golden resolutions) — small enough for CPU CI, big enough to
# cover every feature; the benchmark renders full preset resolutions.
GOLDENS = {
    "config1": [(256, 256)],
    "config2": [(256, 256), (96, 96)],
    "config3": [(192, 192), (96, 96)],
    "config4": [(192, 108)],
    "config7": [(128, 128)],
}


def build_oracle() -> str:
    exe = os.path.join(NATIVE, "oracle")
    subprocess.run(["make", "-C", NATIVE, "oracle"], check=True)
    return exe


def main(check: bool = False) -> None:
    from raytracer.models import presets
    from tests.oracle.export_scene import export_scene

    os.makedirs(GOLDEN, exist_ok=True)
    exe = build_oracle()
    for name, sizes in GOLDENS.items():
        scene, cam, opts = presets.PRESETS[name]()
        scene_txt = os.path.join(GOLDEN, f"{name}.scene.txt")
        export_scene(scene_txt, scene, cam, opts)
        for w, h in sizes:
            out = os.path.join(GOLDEN, f"{name}_{w}x{h}.ppm")
            subprocess.run([exe, scene_txt, out, str(w), str(h)], check=True)
            print("wrote", out)
        if check:
            from raytracer.io.image import load_ppm
            from tests.oracle.np_oracle import render_oracle

            w, h = 64, 64
            tmp = os.path.join(GOLDEN, f"_{name}_check.ppm")
            subprocess.run([exe, scene_txt, tmp, str(w), str(h)], check=True)
            cpp = load_ppm(tmp)
            os.remove(tmp)
            o = dataclasses.replace(opts, width=w, height=h)
            ref = render_oracle(scene, cam, o)
            diff = np.abs(cpp - ref).max(axis=-1)
            # knife-edge rays (wall seams, box corners) may flip between two
            # fp64 implementations from association-order ulps; everything
            # else must match at u8 quantization precision.
            frac = (diff > 0.01).mean()
            rest = diff[diff <= 0.01].max() if (diff <= 0.01).any() else 0.0
            print(f"{name}: C++ vs NumPy oracle — {frac:.4%} edge flips, "
                  f"bulk max {rest:.5f}")
            assert frac <= 0.002, f"{name}: oracles disagree beyond seam flips"
            assert rest <= 1.5 / 255 + 1e-6, f"{name}: oracles disagree"


if __name__ == "__main__":
    main(check="--check" in sys.argv)
