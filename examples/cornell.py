"""End-to-end verification render: Cornell-style box with mirror,
glass, checkerboard floor, and a triangle mesh — exercises every pool,
the packet traversal, Phong+shadows, reflection/refraction, and writes
a PNG for visual inspection.

Run from the repository root: python examples/cornell.py [out.png]
"""

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from solstice.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache(min_compile_secs=5)

import solstice as st  # noqa: E402
from solstice.io.image import save_image  # noqa: E402
from solstice.scenes import make_scene  # noqa: E402


def main(out=os.path.join(tempfile.gettempdir(), "cornell_verify.png")):
    demo = make_scene("cornell").initialize()
    scene, camera = demo.scene, demo.camera
    cfg = st.RenderConfig(width=256, height=256, max_bounces=4)
    t0 = time.time()
    img = jax.jit(st.render, static_argnames=("cfg",))(scene, camera, cfg)
    img = np.asarray(img)
    dt = time.time() - t0
    assert np.isfinite(img).all(), "non-finite pixels"
    assert img[..., :3].max() > 0.05, "black frame"
    save_image(out, img[..., :3])
    print(f"device={jax.devices()[0]} render+compile={dt:.1f}s -> {out}")
    print(f"mean rgb={img[..., :3].mean(axis=(0, 1))}")


if __name__ == "__main__":
    main(*sys.argv[1:])
