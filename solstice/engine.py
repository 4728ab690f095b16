"""Engine: stateful convenience shell over the functional core.

Analog of the reference's engine object
(solr/engines/GPUKernel.{h,cpp} + CudaKernel/OpenCLKernel): owns a
SceneBuilder, a camera, render configuration, and the progressive
accumulation buffer, and exposes render_begin/render-style entry points.
Unlike the reference there is no device state to manage — `render` is a
pure jitted function and this class only carries conveniences
(accumulation across progressive frames, dirty-scene rebuilds,
snapshotting).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from solstice.scene import SceneBuilder
from solstice.types import Camera, RenderConfig, Scene

__all__ = ["Engine", "morph_scenes"]


class Engine:
    """Progressive interactive renderer (reference: GPUKernel's
    render_begin/render_end + pathTracingIteration accumulation)."""

    def __init__(
        self,
        config: Optional[RenderConfig] = None,
        camera: Optional[Camera] = None,
        seed: int = 0,
    ):
        self.builder = SceneBuilder()
        self.config = config or RenderConfig()
        self.camera = camera or Camera.create()
        self._scene: Optional[Scene] = None
        self._dirty = True
        self._accum = None
        self._iteration = 0
        self._key = jax.random.PRNGKey(seed)

    # -- scene construction passthrough --------------------------------

    def __getattr__(self, name):
        # Delegate add_* scene-building calls to the builder
        # (reference: the GPUKernel add/set API).
        if name.startswith("add_"):
            self._dirty = True
            self.__dict__["_dirty"] = True
            return getattr(self.builder, name)
        raise AttributeError(name)

    @property
    def scene(self) -> Scene:
        if self._dirty or self._scene is None:
            self._scene = self.builder.build(use_bvh=self.config.use_bvh)
            self._dirty = False
            self.reset_accumulation()
        return self._scene

    def set_scene(self, scene: Scene) -> None:
        self._scene = scene
        self._dirty = False
        self.reset_accumulation()

    def reset_accumulation(self) -> None:
        """(reference: pathTracingIteration <- 0 on camera/scene change)"""
        self._accum = None
        self._iteration = 0

    def set_camera(self, camera: Camera) -> None:
        self.camera = camera
        self.reset_accumulation()

    # -- animation frames / morphing ------------------------------------
    # (reference: GPUKernel::setNbFrames / nextFrame / the morphing
    # interpolation between per-frame primitive states)

    def set_nb_frames(self, n: int) -> None:
        """Declare the animation length (reference: setNbFrames)."""
        self._nb_frames = int(n)
        self._frame = 0

    @property
    def frame(self) -> int:
        return getattr(self, "_frame", 0)

    def set_keyframes(self, scene_a: Scene, scene_b: Scene) -> None:
        """Register two same-topology keyframe scenes; frames morph
        between them (the reference stores per-frame primitive arrays
        and interpolates — here a pytree lerp over the continuous
        leaves, with the traversal accel rebuilt per frame)."""
        self._key_a, self._key_b = scene_a, scene_b

    def next_frame(self) -> Scene:
        """Advance the animation and return the frame's scene
        (reference: nextFrame).  With keyframes set, the scene is the
        morph at phase frame/(nb_frames-1); otherwise the static scene.
        """
        n = getattr(self, "_nb_frames", 1)
        self._frame = (self.frame + 1) % max(n, 1)
        self.reset_accumulation()
        return self.frame_scene()

    def frame_scene(self) -> Scene:
        n = max(getattr(self, "_nb_frames", 1) - 1, 1)
        if hasattr(self, "_key_a"):
            t = self.frame / n
            scene = morph_scenes(self._key_a, self._key_b, t)
            self._scene = scene
            self._dirty = False
            return scene
        return self.scene

    # -- rendering ------------------------------------------------------

    def render_frame(self) -> np.ndarray:
        """One progressive frame, accumulated; returns (H, W, 4) float."""
        from solstice.ops.render import accumulate, jit_render

        self._key, sub = jax.random.split(self._key)
        img = jit_render(self.scene, self.camera, self.config, sub)
        if self._accum is None:
            self._accum = img
        else:
            self._accum = accumulate(self._accum, img, self._iteration)
        self._iteration += 1
        return np.asarray(self._accum)

    def bitmap(self) -> np.ndarray:
        """Current frame as (H, W, 3) uint8 (reference:
        GPUKernel::getBitmap — the RGB byte buffer blitted by the
        viewer)."""
        img = self._accum
        if img is None:
            img = self.render_frame()
        rgb = np.asarray(jnp.clip(img[..., :3], 0.0, 1.0) * 255.0)
        return rgb.astype(np.uint8)


def morph_scenes(scene_a: Scene, scene_b: Scene, t: float) -> Scene:
    """Linear morph between two SAME-TOPOLOGY scenes: every continuous
    float leaf lerps; integer leaves (material ids, texture descriptors,
    BVH topology) come from ``scene_a``; the traversal accelerators are
    rebuilt from the morphed geometry (reference: the frame morphing
    GPUKernel applies between stored animation frames).
    """
    import dataclasses

    t = jnp.asarray(t, jnp.float32)

    def lerp(a, b):
        if a is None or b is None:
            return a
        a_arr = jnp.asarray(a)
        if not jnp.issubdtype(a_arr.dtype, jnp.floating):
            return a
        return a_arr * (1.0 - t) + jnp.asarray(b) * t

    base = dataclasses.replace(
        scene_a, tri_accel=None, sph_accel=None
    )
    base_b = dataclasses.replace(
        scene_b, tri_accel=None, sph_accel=None
    )
    morphed = jax.tree.map(lerp, base, base_b)
    morphed = dataclasses.replace(
        morphed, tri_accel=scene_a.tri_accel, sph_accel=scene_a.sph_accel
    )
    return morphed.refresh_accel()
