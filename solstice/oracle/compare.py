"""The image comparator shared by the oracle tests and chip_smoke.py."""

from __future__ import annotations

import numpy as np

__all__ = ["assert_images_match"]


def assert_images_match(img, ref, mean_tol=2e-3, pix_tol=2e-2,
                        outliers=0.01):
    """Inlier pixels must agree to float tolerance; a small fraction of
    outliers is allowed for discrete hit-selection flips on silhouettes
    and plane seams (f32 renderer vs f64 oracle tie-breaking)."""
    img = np.asarray(img, np.float64)[..., :3]
    ref = np.asarray(ref, np.float64)[..., :3]
    err = np.abs(img - ref).max(axis=-1)
    assert np.isfinite(img).all(), "non-finite pixels"
    inlier = err <= pix_tol
    frac_bad = 1.0 - inlier.mean()
    assert frac_bad < outliers, (
        f"{frac_bad:.2%} pixels exceed {pix_tol} (max {err.max():.3f})"
    )
    assert err[inlier].mean() < mean_tol, (
        f"inlier mean err {err[inlier].mean():.2e}"
    )
