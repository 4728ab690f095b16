"""Golden-image regression tests (SURVEY.md §4 item 3; VERDICT r02
missing #5).

Oracle-relative tests can drift in lockstep with the renderer; these
committed PNGs pin the absolute output.  Regenerate DELIBERATELY after
an intended change with:

    python tests/test_goldens.py --regen

Tolerance is 3/255 per channel: PNG quantization plus cross-platform
f32 reduction-order noise, far below any real shading regression.
"""

import os

import numpy as np
import pytest

import solstice as st

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
CFG = st.RenderConfig(width=96, height=96, max_bounces=3)


def _render(name):
    from solstice.scenes import make_scene

    demo = make_scene(name, seed=0)
    import jax

    img = st.render(demo.scene, demo.camera, CFG,
                    key=jax.random.PRNGKey(0))
    return np.clip(np.asarray(img[..., :3]), 0.0, 1.0)


SCENES = ["cornell", "terrain", "glass"]


def _golden_path(name):
    return os.path.join(GOLDEN_DIR, f"{name}_96.png")


@pytest.mark.parametrize("name", SCENES)
def test_matches_golden(name):
    from solstice.io.image import load_image, save_image

    path = _golden_path(name)
    assert os.path.exists(path), (
        f"missing golden {path}; run `python tests/test_goldens.py --regen`"
    )
    golden = np.asarray(load_image(path)).astype(np.float32) / 255.0
    img = _render(name)
    diff = np.abs(img - golden[..., :3])
    assert diff.max() <= 3.5 / 255.0, (
        f"{name}: max|diff| = {diff.max():.4f} "
        f"({(diff.max() * 255):.1f}/255) vs golden"
    )


if __name__ == "__main__":
    import sys

    if "--regen" in sys.argv:
        from solstice.io.image import save_image

        os.makedirs(GOLDEN_DIR, exist_ok=True)
        for name in SCENES:
            save_image(_golden_path(name), _render(name))
            print("wrote", _golden_path(name))
