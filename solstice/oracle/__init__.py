"""CPU reference oracle (pure NumPy, float64).

The reference project had no automated tests — verification was visual,
against ~30 demo scenes (apps/scenes/).  This oracle replaces that
eyeball-oracle with a slow, simple, independently-implemented path
tracer whose images and finite-difference gradients the renderer
must match (SURVEY.md section 4; BASELINE config #1).
"""

from solstice.oracle.compare import assert_images_match
from solstice.oracle.cpu_tracer import oracle_render

__all__ = ["assert_images_match", "oracle_render"]
