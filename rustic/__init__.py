"""rustic — a wavefront path-tracing framework in JAX.

A ground-up JAX/XLA rebuild of the capability surface of
pema99/rust-path-tracer ("rustic"): a physically-based, progressive path
tracer with PBR materials, next-event estimation with MIS, texture
atlasing, procedural & HDR skyboxes, and BVH-accelerated ray traversal.

Architecture (not a port):

- The reference runs one divergent megakernel per pixel
  (reference: kernels/src/lib.rs:21). Here a *wavefront* integrator
  runs over a flat SoA batch of paths, advanced bounce-by-bounce with
  masked lanes (rustic/ops/trace.py).
- Ray/triangle intersection (rustic/ops/intersect.py) has three
  engines: brute force as one factorised f32 contraction, a lockstep
  BVH traversal (lax.while_loop over per-lane short stacks) for large
  scenes, and on the GPU a Triton scan kernel (rustic/ops/scan.py).
- Scene preprocessing (GLB load, binned-SAH BVH, texture atlas, alias
  light table) is host-side NumPy/C++ (rustic/scene/).
- Multi-device scaling is data-parallel over paths via shard_map on a
  jax.sharding.Mesh (rustic/parallel/).
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# Persistent XLA compilation cache. JAX reads $JAX_COMPILATION_CACHE_DIR
# itself; without it the cache lives at a fixed path inside the
# checkout, so every process of one checkout finds the programs the
# others compiled.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(
            _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
            ".jax_cache",
        ),
    )

from rustic.config import (  # noqa: E402,F401
    NextEventEstimation,
    RenderSettings,
    TracingConfig,
    Tonemapping,
)
