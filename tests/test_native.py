"""Native C++ LBVH builder vs the NumPy reference builder.

The native path (solstice/native/src/lbvh.cc) is the framework's analog
of the reference's host-side C++ acceleration build
(solr/engines/GPUKernel.cpp: compactBoxes); it must produce a tree
identical to the NumPy builder in solstice/ops/bvh.py.
"""

import numpy as np
import numpy.testing as npt
import pytest

from solstice import native
from solstice.ops.bvh import build_bvh

pytestmark = pytest.mark.skipif(
    not native.native_available(), reason="no C++ toolchain"
)


def _random_aabbs(n, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    h = rng.uniform(0.01, 0.5, (n, 3)).astype(np.float32)
    return c - h, c + h


@pytest.mark.parametrize("n", [1, 3, 64, 65, 1000, 4097])
@pytest.mark.parametrize("leaf_size", [4, 8, 64])
def test_native_matches_numpy(n, leaf_size):
    amin, amax = _random_aabbs(n, seed=n)
    b_nat, o_nat = build_bvh(amin, amax, leaf_size, backend="native")
    b_np, o_np = build_bvh(amin, amax, leaf_size, backend="numpy")
    npt.assert_array_equal(o_nat, o_np)
    npt.assert_array_equal(np.asarray(b_nat.skip), np.asarray(b_np.skip))
    npt.assert_array_equal(
        np.asarray(b_nat.first_prim), np.asarray(b_np.first_prim)
    )
    npt.assert_array_equal(
        np.asarray(b_nat.prim_count), np.asarray(b_np.prim_count)
    )
    npt.assert_array_equal(np.asarray(b_nat.depth), np.asarray(b_np.depth))
    npt.assert_allclose(
        np.asarray(b_nat.aabb_min), np.asarray(b_np.aabb_min), atol=1e-6
    )
    npt.assert_allclose(
        np.asarray(b_nat.aabb_max), np.asarray(b_np.aabb_max), atol=1e-6
    )
    npt.assert_array_equal(
        np.asarray(b_nat.leaf_first), np.asarray(b_np.leaf_first)
    )
    npt.assert_array_equal(
        np.asarray(b_nat.leaf_count), np.asarray(b_np.leaf_count)
    )


def test_native_tree_invariants():
    amin, amax = _random_aabbs(2000, seed=7)
    bvh, order = build_bvh(amin, amax, leaf_size=8, backend="native")
    first = np.asarray(bvh.first_prim)
    count = np.asarray(bvh.prim_count)
    skip = np.asarray(bvh.skip)
    k = first.shape[0]
    # Every primitive appears in exactly one leaf range.
    covered = np.zeros(2000, np.int32)
    for f, c in zip(first, count):
        if f >= 0:
            covered[f : f + c] += 1
    assert (covered == 1).all()
    # Skip pointers form a valid monotone forward walk.
    assert (skip > np.arange(k)).all() and (skip <= k).all()
    # Node AABBs contain their primitives (after reorder).
    smin, smax = amin[order], amax[order]
    nmin = np.asarray(bvh.aabb_min)
    nmax = np.asarray(bvh.aabb_max)
    for i in range(k):
        if first[i] >= 0:
            s = slice(first[i], first[i] + count[i])
            assert (nmin[i] <= smin[s].min(axis=0) + 1e-4).all()
            assert (nmax[i] >= smax[s].max(axis=0) - 1e-4).all()


def test_native_triangle_aabbs():
    rng = np.random.default_rng(3)
    v0, v1, v2 = (rng.normal(size=(500, 3)).astype(np.float32) for _ in range(3))
    got = native.triangle_aabbs(v0, v1, v2)
    assert got is not None
    npt.assert_allclose(got[0], np.minimum(np.minimum(v0, v1), v2))
    npt.assert_allclose(got[1], np.maximum(np.maximum(v0, v1), v2))


class TestNativeObjParser:
    """Native C++ OBJ parser vs the Python fallback (reference analog:
    OBJReader.cpp).  Same geometry, normals, uvs, and materials must
    come out of both paths (triangle ORDER may differ: the native path
    groups faces by usemtl slot, the Python path by builder id)."""

    OBJ = """\
mtllib demo.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0 0 1
vn 0 0 1
vn 0 1 0
vt 0 0
vt 1 0
vt 1 1
vt 0 1
usemtl red
f 1/1/1 2/2/1 3/3/1 4/4/1
usemtl blue
f 1/1/2 2/2/2 5/1/2
f 3/3/2 4/4/2 5/1/2
"""
    MTL = """\
newmtl red
Kd 0.8 0.1 0.1
newmtl blue
Kd 0.1 0.1 0.8
"""

    def _load(self, tmp_path, use_native):
        import os

        import solstice as st
        from solstice.io.obj import load_obj

        d = tmp_path / ("n" if use_native else "p")
        d.mkdir()
        (d / "demo.obj").write_text(self.OBJ)
        (d / "demo.mtl").write_text(self.MTL)
        b = st.SceneBuilder()
        old = os.environ.pop("SOLR_NO_NATIVE_OBJ", None)
        try:
            if not use_native:
                os.environ["SOLR_NO_NATIVE_OBJ"] = "1"
            load_obj(str(d / "demo.obj"), b, center=False)
        finally:
            os.environ.pop("SOLR_NO_NATIVE_OBJ", None)
            if old:
                os.environ["SOLR_NO_NATIVE_OBJ"] = old
        return b

    def test_matches_python_parser(self, tmp_path):
        from solstice.native import native_available

        if not native_available():
            pytest.skip("no native toolchain")
        bn = self._load(tmp_path, True)
        bp = self._load(tmp_path, False)

        def rows(b):
            out = []
            for blk in b._triangles:
                v0, v1, v2, n0, n1, n2, uv0, uv1, uv2, mat = blk
                for i in range(len(v0)):
                    out.append(tuple(np.round(np.concatenate([
                        v0[i], v1[i], v2[i], n0[i], n1[i], n2[i],
                        uv0[i], uv1[i], uv2[i], [float(mat[i])],
                    ]), 5)))
            return sorted(out)

        assert len(rows(bn)) == 4  # quad -> 2 + 2 single tris
        assert rows(bn) == rows(bp)
        # Materials parsed once per path; same count and colors.
        assert len(bn._mat) == len(bp._mat)

    def test_large_mesh_roundtrip(self, tmp_path):
        """Native parse of a generated grid mesh must reproduce the
        vertex positions bit-exactly (strtof path)."""
        from solstice.native import obj_load, native_available

        if not native_available():
            pytest.skip("no native toolchain")
        rng = np.random.default_rng(0)
        v = rng.normal(size=(500, 3)).astype(np.float32)
        faces = rng.integers(1, 501, (300, 3))
        lines = ["v %.9g %.9g %.9g" % tuple(p) for p in v]
        lines += ["f %d %d %d" % tuple(f) for f in faces]
        p = tmp_path / "grid.obj"
        p.write_text("\n".join(lines) + "\n")
        parsed = obj_load(str(p))
        assert parsed is not None
        np.testing.assert_allclose(parsed["v"], v, rtol=1e-6)
        np.testing.assert_array_equal(parsed["f_v"], faces - 1)
        assert (parsed["f_slot"] == -1).all()
