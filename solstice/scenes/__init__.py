"""Demo scene gallery.

Re-creation of the reference's scene layer (apps/scenes/ —
the Scene base class with initialize/animate plus ~30 demo subclasses:
CornellBoxScene, CubesScene, CylinderScene, TrianglesScene, ObjScene,
MoleculeScene, FractalsScene, MetaballsScene, WaterScene, GraphScene,
Year2013/XmasScene-style showpieces...).  The gallery doubles as the
framework's integration-test corpus, exactly as it did upstream.
"""

from solstice.scenes.base import DemoScene, SCENE_REGISTRY, register_scene
from solstice.scenes import gallery as _gallery  # noqa: F401 (registers)

__all__ = ["DemoScene", "SCENE_REGISTRY", "register_scene", "make_scene"]


def make_scene(name: str, **kwargs) -> "DemoScene":
    """Instantiate a registered demo scene by name."""
    cls = SCENE_REGISTRY[name]
    demo = cls(**kwargs)
    demo.initialize()
    return demo
