"""Demo-scene base class (reference: apps/scenes/Scene.{h,cpp} — the
initialize/animate lifecycle, ground/wall helpers, random materials
spanning the reflective/transparent/procedural matrix, light + camera
defaults)."""

from __future__ import annotations

from typing import Dict, Optional, Type

import numpy as np

import solstice as st
from solstice.types import PlaneAxis, ProceduralKind

SCENE_REGISTRY: Dict[str, Type["DemoScene"]] = {}


def register_scene(name: str):
    def deco(cls):
        SCENE_REGISTRY[name] = cls
        cls.name = name
        return cls

    return deco


class DemoScene:
    """Build-once, animate-per-frame demo scene.

    Subclasses implement ``do_initialize`` (build geometry via
    self.builder) and optionally ``do_animate(frame)`` returning an
    updated (scene, camera) for that frame — the analog of the
    reference's Scene::doInitialize / doAnimate.
    """

    name = "base"
    default_camera = dict(position=(0.0, 0.0, -4.0), fov=1.0)

    def __init__(self, seed: int = 0):
        self.builder = st.SceneBuilder()
        self.rng = np.random.default_rng(seed)
        self.camera = st.Camera.create(**self.default_camera)
        self._scene = None

    # -- lifecycle -----------------------------------------------------

    def initialize(self):
        self.do_initialize()
        self._scene = None
        return self

    @property
    def scene(self):
        if self._scene is None:
            self._scene = self.builder.build()
        return self._scene

    def animate(self, frame: int):
        """(scene, camera) for the given frame (default: static)."""
        out = self.do_animate(frame)
        return out if out is not None else (self.scene, self.camera)

    def do_initialize(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def do_animate(self, frame: int):
        return None

    # -- helpers (reference: Scene's ground/wall/material utilities) ---

    def add_ground(self, y: float = -1.0, extent: float = 10.0,
                   checker: bool = True):
        b = self.builder
        if checker:
            mat = b.add_material(
                color=(0.85, 0.85, 0.85, 1.0),
                procedural=ProceduralKind.CHECKER,
                procedural_scale=float(extent),
            )
        else:
            mat = b.add_material(color=(0.7, 0.7, 0.7, 1.0))
        b.add_plane(PlaneAxis.XZ, (0.0, y, 0.0), (extent, extent), mat)
        return mat

    def random_material(self):
        """Spans the material matrix (reference:
        Scene::createRandomMaterials): diffuse / specular / mirror /
        glass / procedural."""
        b = self.builder
        kind = self.rng.integers(0, 5)
        color = tuple(self.rng.uniform(0.2, 1.0, 3)) + (1.0,)
        if kind == 0:
            return b.add_material(color=color)
        if kind == 1:
            return b.add_material(color=color, specular=0.8,
                                  specular_power=40.0)
        if kind == 2:
            return b.add_material(color=(0.95, 0.95, 0.95, 1.0),
                                  reflection=0.8, specular=0.9)
        if kind == 3:
            return b.add_material(color=color, transparency=0.85,
                                  ior=1.5)
        return b.add_material(
            color=color,
            procedural=ProceduralKind(
                int(self.rng.choice([1, 2, 3, 4]))
            ),
            procedural_scale=6.0,
        )

    def default_light(self, position=(5.0, 8.0, -5.0), intensity=1.0):
        return self.builder.add_light(position, intensity=intensity)
