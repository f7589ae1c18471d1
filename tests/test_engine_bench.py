"""The host-side parts of tools/engine_bench.py (the rest needs a GPU)."""

import os
import sys

import numpy as np
import pytest

from rustic.scene.gltf import load_glb
from tests.conftest import REPO, scene_path

sys.path.insert(0, os.path.join(REPO, "tools"))
from engine_bench import split_triangles  # noqa: E402


def _area_vectors(s):
    v = s.positions[s.triangles[:, :3]].astype(np.float64)
    return 0.5 * np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])


@pytest.mark.parametrize("name,n", [
    ("DarkCornell.glb", 200), ("DarkCornell.glb", 500), ("BreakTime.glb", 14336),
])
def test_split_triangles_keeps_the_surfaces(name, n):
    base = load_glb(scene_path(name))
    cut = split_triangles(base, n)
    assert len(cut.triangles) == n
    assert len(cut.positions) == len(cut.normals) == len(cut.tangents) == len(cut.uv0)
    a0, a1 = _area_vectors(base), _area_vectors(cut)
    # total area and winding (summed area vectors) unchanged
    np.testing.assert_allclose(
        np.linalg.norm(a1, axis=1).sum(), np.linalg.norm(a0, axis=1).sum(), rtol=1e-5
    )
    np.testing.assert_allclose(a1.sum(0), a0.sum(0), rtol=1e-4, atol=1e-3)
    # every material keeps its area
    for mat in np.unique(base.triangles[:, 3]):
        np.testing.assert_allclose(
            np.linalg.norm(a1[cut.triangles[:, 3] == mat], axis=1).sum(),
            np.linalg.norm(a0[base.triangles[:, 3] == mat], axis=1).sum(), rtol=1e-5,
        )
    np.testing.assert_allclose(np.linalg.norm(cut.normals, axis=1), 1.0, rtol=1e-5)
