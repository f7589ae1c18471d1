"""The one engine choice (ops/intersect.py `pick_engine`) and where the
program keeps its compile cache."""

import os
import re
import subprocess
import sys

import pytest

from rustic.ops import intersect as I
from tests.conftest import REPO


@pytest.mark.parametrize(
    "platform,n_tris,engine",
    [
        ("cpu", 1, "brute"),
        ("cpu", I.BRUTE_FORCE_MAX_TRIS, "brute"),
        ("cpu", I.BRUTE_FORCE_MAX_TRIS + 1, "bvh"),
        ("cpu", 24002, "bvh"),
        ("gpu", 1, "scan"),
        ("gpu", I.SCAN_MAX_TRIS, "scan"),
        ("gpu", I.SCAN_MAX_TRIS + 1, "bvh"),
    ],
)
def test_pick_engine(platform, n_tris, engine):
    assert I.pick_engine(n_tris, platform) == engine


def test_resolve_engine(cornell_scene):
    assert I.resolve_engine(cornell_scene, "auto", "cpu") == "bvh"
    assert I.resolve_engine(cornell_scene, "auto", "gpu") == "scan"
    assert I.resolve_engine(cornell_scene, "auto") == "bvh"  # the CPU here
    assert I.resolve_engine(cornell_scene, "brute", "gpu") == "brute"
    with pytest.raises(ValueError, match="needs a GPU"):
        I.resolve_engine(cornell_scene, "scan", "cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        I.resolve_engine(cornell_scene, "flash", "gpu")


def test_cpu_backend_never_picks_a_gpu_kernel(cornell_scene, monkeypatch):
    """backend="cpu" (the viewer's 'c' key) resolves `auto` for the CPU
    even where the default backend is a GPU."""
    import numpy as np

    from rustic.config import TracingConfig
    from rustic.runtime import render as R

    picked = []
    monkeypatch.setattr(R.jax, "default_backend", lambda: "gpu")
    real = R._compiled_accumulate
    monkeypatch.setattr(
        R, "_compiled_accumulate", lambda cfg, engine: picked.append(engine) or real(cfg, engine)
    )
    px = np.arange(4, dtype=np.int32)
    R.render_pixels(cornell_scene, TracingConfig(width=4, height=1, max_bounces=1),
                    px, px * 0, 1, backend="cpu")
    assert picked == ["bvh"]


def test_no_production_path_chooses_interpret():
    """Only tests pass interpret=True: in the package, an `interpret`
    argument is either passed through or defaults to False."""
    pattern = re.compile(r"interpret\s*=\s*([^,)\n]+)")
    found = []
    for root, _, files in os.walk(os.path.join(REPO, "rustic")):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(root, name)) as f:
                    found += [v.strip() for v in pattern.findall(f.read())]
    assert found and set(found) <= {"interpret", "False"}, found


def _cache_dir(env):
    code = "import jax, rustic; print(jax.config.jax_compilation_cache_dir)"
    env = {**env, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO}
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, cwd=REPO,
        capture_output=True, text=True, timeout=120, check=True,
    )
    return out.stdout.strip().splitlines()[-1]


def test_compile_cache_defaults_into_the_checkout():
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    assert _cache_dir(env) == os.path.join(REPO, ".jax_cache")


def test_compile_cache_follows_the_environment(tmp_path):
    env = {**os.environ, "JAX_COMPILATION_CACHE_DIR": str(tmp_path / "cache")}
    assert _cache_dir(env) == str(tmp_path / "cache")
