"""Test configuration: force the JAX CPU backend with 8 virtual devices.

The CPU backend is the framework's debugging twin (the same property the
reference gets from running kernels/ on the host via rayon,
src/trace.rs:226-327): every op in rustic outside the GPU scan kernel is
backend-agnostic JAX, so the suite runs without a GPU (the scan kernel
runs in Pallas interpret mode). The 8 virtual devices let sharding tests
exercise real Mesh/shard_map paths. Tests marked `gpu` need the card and
skip here; `python chip_smoke.py` runs the same checks on it.
"""

import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)
# The tests' compile cache is written with zlib (below), which a zstd
# process cannot read: keep it apart from the program's own cache, at a
# fixed path inside the checkout.
os.environ["JAX_COMPILATION_CACHE_DIR"] = os.path.join(REPO, ".jax_cache", "tests")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# This environment's zstandard C backend segfaults mid-suite while
# compressing a large persistent-cache entry (reproducible at the same
# executable, only after ~200 prior compiles in-process; standalone
# the same compile+write succeeds). Fall back to zlib for cache writes
# during tests — correctness-neutral.
try:  # pragma: no cover - environment workaround
    from jax._src import compilation_cache as _cc

    # jax 0.9.0 probes a module-level `zstd` before `zstandard`; null
    # both so the fallback holds even if a zstd package appears.
    _cc.zstandard = None
    if hasattr(_cc, "zstd"):
        _cc.zstd = None
except ImportError:
    pass

import numpy as np  # noqa: E402
import pytest  # noqa: E402

SCENES = os.path.join(REPO, "assets", "scenes")


@pytest.fixture(scope="session")
def furnace_world():
    from rustic.scene.world import World

    return World.from_path(os.path.join(SCENES, "FurnaceTest.glb"))


@pytest.fixture(scope="session")
def furnace_scene(furnace_world):
    return furnace_world.to_device()


@pytest.fixture(scope="session")
def cornell_world():
    from rustic.scene.world import World

    return World.from_path(os.path.join(SCENES, "DarkCornell.glb"))


@pytest.fixture(scope="session")
def cornell_scene(cornell_world):
    return cornell_world.to_device()


def scene_path(name: str) -> str:
    return os.path.join(SCENES, name)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU. Decided inside the
    fixture, never at import, so every xdist worker collects the same
    tests."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run on the card through chip_smoke.py)")
