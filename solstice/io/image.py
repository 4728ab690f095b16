"""Texture/image loading and saving.

Analog of the reference's image layer (solr/images/
ImageLoader.cpp + vendored jpgd/jpge/tgad codecs: BMP, JPEG, TGA in;
JPEG screenshots out).  Pillow provides the codecs here — BMP, JPEG,
TGA, PNG and more — so no vendored decoders are needed; the loader
normalizes everything to the engine's (H, W, 4) uint8 RGBA texel form.
"""

from __future__ import annotations

import numpy as np

__all__ = ["load_image", "save_image"]


def load_image(path: str) -> np.ndarray:
    """Load any Pillow-supported image as (H, W, 4) uint8 RGBA."""
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img.convert("RGBA"), np.uint8)


def save_image(path: str, image) -> None:
    """Save an (H, W, 3|4) float [0,1] or uint8 image (reference:
    the viewer's JPEG screenshot export)."""
    from PIL import Image

    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0).astype(np.uint8)
    if arr.shape[-1] == 4 and path.lower().endswith((".jpg", ".jpeg")):
        arr = arr[..., :3]
    Image.fromarray(arr).save(path)
