"""Kill-one-host fault injection + resumable tile renders (SURVEY.md
section 5 failure-detection row; VERDICT r03 missing #5, next-round
item 6).  The heavy lifting lives in tools/fault_injection.py — this
test runs it at small scale plus unit-level resume checks."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import solstice as st

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny_scene():
    b = st.SceneBuilder()
    m = b.add_material(color=(0.8, 0.3, 0.3, 1.0))
    b.add_plane(st.types.PlaneAxis.XZ, (0.0, -1.0, 0.0), (8.0, 8.0), m)
    b.add_sphere((0.0, 0.0, 2.0), 0.8, m)
    b.add_light((0.0, 5.0, -1.0))
    return b.build(), st.Camera.create(position=(0, 0.5, -3.0), fov=1.0)


class TestResumableRender:
    def test_resume_is_bit_identical(self, tmp_path):
        """Interrupt after 2 of 4 chunks (by simply calling twice with a
        checkpoint dir that has partial state) -> identical image."""
        from solstice.ops.render import render_sample
        from solstice.utils.checkpoint import CheckpointManager, latest_step
        from solstice.utils.resumable import resumable_render

        scene, cam = _tiny_scene()
        cfg = st.RenderConfig(width=32, height=32, max_bounces=2)

        # Uninterrupted run.
        full_dir = str(tmp_path / "full")
        img_full, _ = resumable_render(scene, cam, cfg, full_dir,
                                       rows_per_chunk=8)

        # "Interrupted" run: copy the chunk-3 checkpoint (the rotation
        # keeps the newest 2: ckpt_3 + ckpt_4) into a fresh dir, then
        # let resumable_render continue from it — it must render ONLY
        # chunk 4 and still match the uninterrupted image.
        part_dir = str(tmp_path / "part")
        os.makedirs(part_dir)
        import shutil

        shutil.copy(os.path.join(full_dir, "ckpt_3.npz"),
                    os.path.join(part_dir, "ckpt_3.npz"))
        img_res, _ = resumable_render(scene, cam, cfg, part_dir,
                                      rows_per_chunk=8)
        np.testing.assert_array_equal(
            np.asarray(img_res), np.asarray(img_full)
        )
        assert latest_step(part_dir) == 4

    def test_matches_one_shot_render(self):
        """Chunked rendering must equal the one-shot full-frame path."""
        import tempfile

        from solstice.ops.render import render_sample
        from solstice.utils.resumable import resumable_render

        scene, cam = _tiny_scene()
        cfg = st.RenderConfig(width=32, height=32, max_bounces=2)
        img1, _ = render_sample(scene, cam, cfg)
        with tempfile.TemporaryDirectory() as d:
            img2, _ = resumable_render(scene, cam, cfg, d,
                                       rows_per_chunk=16)
        np.testing.assert_allclose(
            np.asarray(img2), np.asarray(img1), atol=1e-6
        )


@pytest.mark.slow
class TestKillOneHost:
    def test_harness_end_to_end(self):
        """SIGKILL one of two host processes mid-frame; the supervisor
        must detect the stall, relaunch, resume from checkpoint (not
        from scratch), and produce a bit-identical frame."""
        import json

        env = dict(os.environ, JAX_PLATFORMS="cpu", SOLR_FAULT_RES="48")
        env.pop("XLA_FLAGS", None)  # workers don't need 8 devices
        out = subprocess.run(
            [sys.executable,
             os.path.join(REPO, "tools", "fault_injection.py")],
            env=env, capture_output=True, timeout=600, text=True,
        )
        assert out.returncode == 0, out.stderr[-800:]
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        assert rec["fault_injection_ok"]
        assert rec["bit_identical_to_uninterrupted"]
        assert rec["work_preserved"], rec  # resumed, not restarted
