"""Runtime configuration.

Mirrors the capability surface of the reference `TracingConfig`
(reference: shared_structs/src/lib.rs:12-42) but split JAX-style into a
*static* part (shapes & modes that select the compiled program) and a
*dynamic* part (camera & lighting parameters that are traced values, so
interactive camera movement never recompiles).
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Tuple

import jax
import jax.numpy as jnp


class NextEventEstimation(enum.IntEnum):
    """Next-event-estimation mode (reference: shared_structs/src/lib.rs:193-236)."""

    NONE = 0
    MIS = 1  # NEE with multiple importance sampling
    DIRECT = 2  # NEE without MIS weighting ("direct light sampling")

    @property
    def uses_nee(self) -> bool:
        return self != NextEventEstimation.NONE

    @property
    def uses_mis(self) -> bool:
        return self == NextEventEstimation.MIS


class Tonemapping(enum.IntEnum):
    """Display tonemap operators (reference: src/app.rs:18-42, render.wgsl:36-117)."""

    NONE = 0
    REINHARD = 1
    ACES_NARKOWICZ = 2  # x0.6 pre-exposure (render.wgsl:136)
    ACES_NARKOWICZ_OVEREXPOSED = 3  # no pre-exposure (render.wgsl:139-140)
    ACES_HILL = 4
    NEUTRAL = 5
    UNCHARTED2 = 6


def _default_sun() -> Tuple[float, float, float, float]:
    # normalize(0.5, 1.3, 1.0) with w = intensity 15
    # (reference: shared_structs/src/lib.rs:36)
    n = math.sqrt(0.5 * 0.5 + 1.3 * 1.3 + 1.0 * 1.0)
    return (0.5 / n, 1.3 / n, 1.0 / n, 15.0)


@dataclasses.dataclass(frozen=True)
class TracingConfig:
    """Full render configuration (host-side, hashable).

    Field-for-field capability parity with the reference uniform struct
    (reference: shared_structs/src/lib.rs:12-42); defaults match
    shared_structs/src/lib.rs:27-42.
    """

    width: int = 1280
    height: int = 720
    min_bounces: int = 3
    max_bounces: int = 4
    nee: NextEventEstimation = NextEventEstimation.NONE
    has_skybox: bool = False  # True => HDR equirect image, False => procedural sky
    cam_position: Tuple[float, float, float] = (0.0, 1.0, -5.0)
    cam_rotation: Tuple[float, float] = (0.0, 0.0)  # (pitch x, yaw y) radians
    sun_direction: Tuple[float, float, float, float] = dataclasses.field(
        default_factory=_default_sun
    )  # xyz = direction, w = intensity
    specular_weight_clamp: Tuple[float, float] = (0.1, 0.9)

    def replace(self, **kw) -> "TracingConfig":
        return dataclasses.replace(self, **kw)

    # -- static/dynamic split ------------------------------------------------

    def static_part(self) -> "StaticConfig":
        return StaticConfig(
            width=self.width,
            height=self.height,
            min_bounces=self.min_bounces,
            max_bounces=self.max_bounces,
            nee=NextEventEstimation(self.nee),
            has_skybox=bool(self.has_skybox),
        )

    def dynamic_part(self) -> "CameraParams":
        return CameraParams(
            cam_position=jnp.asarray(self.cam_position, jnp.float32),
            cam_rotation=jnp.asarray(self.cam_rotation, jnp.float32),
            sun_direction=jnp.asarray(self.sun_direction, jnp.float32),
            specular_weight_clamp=jnp.asarray(
                self.specular_weight_clamp, jnp.float32
            ),
        )


@dataclasses.dataclass(frozen=True)
class StaticConfig:
    """The jit-static subset: changing any of these recompiles."""

    width: int
    height: int
    min_bounces: int
    max_bounces: int
    nee: NextEventEstimation
    has_skybox: bool


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class CameraParams:
    """The traced subset: camera / sun / clamps as device arrays."""

    cam_position: jax.Array  # [3]
    cam_rotation: jax.Array  # [2] (pitch, yaw)
    sun_direction: jax.Array  # [4] xyz dir, w intensity
    specular_weight_clamp: jax.Array  # [2] lo, hi

    def tree_flatten(self):
        return (
            (
                self.cam_position,
                self.cam_rotation,
                self.sun_direction,
                self.specular_weight_clamp,
            ),
            None,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@dataclasses.dataclass
class RenderSettings:
    """Driver-level knobs that live outside the traced kernel.

    Mirrors the reference's TracingState atomics
    (reference: src/trace.rs:40-50).
    """

    samples: int = 32  # target sample count for synchronous renders
    sync_rate: int = 32  # samples folded into one device dispatch
    denoise: bool = False
    # Pixel-seed mode: hash offsets decorrelate fully (default); the
    # IGN-based "blue noise" mode trades a structured residual pattern
    # for perceptually nicer low-spp previews (the reference's blue-noise
    # texture seeding plays the same role, src/trace.rs:149-160).
    use_blue_noise: bool = False
    tonemap: Tonemapping = Tonemapping.NONE
    batch_pixels: int = 1 << 20  # wavefront megabatch size (paths per dispatch)
    # Intersection engine for progressive/interactive drivers (the
    # reference's CPU/GPU dropdown analog); one-shot render_image takes
    # it as an explicit argument instead.
    engine: str = "auto"
    # Compute placement: "auto" = the default JAX backend (the GPU when
    # present); "cpu" = force the host backend — the reference's live
    # GPU<->CPU switch (src/app.rs:324-346) with accumulation preserved
    # across the toggle (src/trace.rs:162-164 restore semantics).
    backend: str = "auto"
