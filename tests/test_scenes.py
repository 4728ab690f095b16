"""Demo-scene gallery smoke tests: every registered scene builds and
renders finite, non-flat images (the reference's de-facto integration
corpus, SURVEY.md section 4)."""

import numpy as np
import pytest

import solstice as st
from solstice.ops.render import render_sample
from solstice.scenes import SCENE_REGISTRY, make_scene

CFG = st.RenderConfig(width=24, height=24, max_bounces=2)


@pytest.mark.parametrize("name", sorted(SCENE_REGISTRY))
def test_scene_renders(name):
    demo = make_scene(name, seed=1)
    img, _ = render_sample(demo.scene, demo.camera, CFG)
    arr = np.asarray(img)
    assert np.isfinite(arr).all(), f"{name}: non-finite pixels"
    assert arr[..., :3].std() > 1e-3, f"{name}: flat image"


def test_animate_produces_distinct_frames():
    demo = make_scene("cubes", seed=1)
    s0, c0 = demo.animate(0)
    s5, c5 = demo.animate(5)
    i0, _ = render_sample(s0, c0, CFG)
    i5, _ = render_sample(s5, c5, CFG)
    assert float(np.abs(np.asarray(i0) - np.asarray(i5)).max()) > 1e-3


def test_viewer_cli(tmp_path):
    from solstice.viewer import main

    out = str(tmp_path / "out.png")
    main(["--scene", "cornell", "--out", out, "--width", "32",
          "--height", "32", "--bounces", "1"])
    from solstice.io import load_image

    img = load_image(out)
    assert img.shape == (32, 32, 4)


def test_viewer_list(capsys):
    from solstice.viewer import main

    main(["--list"])
    out = capsys.readouterr().out
    assert "cornell" in out and "water" in out


def test_engine_frame_morphing():
    """Engine.set_nb_frames/next_frame morph between keyframe scenes
    (reference: GPUKernel::setNbFrames/nextFrame morphing)."""
    import numpy as np

    import solstice as st
    from solstice.engine import morph_scenes

    def make(z):
        b = st.SceneBuilder()
        m = b.add_material(color=(0.8, 0.3, 0.2, 1))
        b.add_sphere((0, 0, z), 1.0, m)
        b.add_light((3, 6, -3))
        return b.build()

    a, b = make(2.0), make(5.0)
    eng = st.Engine(config=st.RenderConfig(width=16, height=16,
                                           max_bounces=1))
    eng.set_nb_frames(4)
    eng.set_keyframes(a, b)
    zs = [float(eng.next_frame().spheres.center[0, 2]) for _ in range(4)]
    assert zs == [3.0, 4.0, 5.0, 2.0]  # lerp then wrap to frame 0

    mid = morph_scenes(a, b, 0.5)
    np.testing.assert_allclose(float(mid.spheres.center[0, 2]), 3.5)
    # Integer leaves untouched.
    assert mid.spheres.material.dtype == a.spheres.material.dtype
    img = np.asarray(st.render(mid, eng.camera, eng.config))
    assert np.isfinite(img).all()
