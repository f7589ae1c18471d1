"""BSDFs, fully batched over the wavefront.

Capability parity with the reference BSDF module
(reference: kernels/src/bsdf.rs): Lambertian, metallic/roughness PBR
(cosine diffuse + Karis-GGX specular with the RT-Gems-2 specular-weight
clamp), and a GGX microfacet dielectric ("glass"). Lobe selection is a
per-lane select instead of a branch; both lobes' math runs for every
lane and masks pick the result — the wavefront answer to divergence.

Lobe encoding (matches reference kernels/src/bsdf.rs:11-18):
  0 = DiffuseReflection, 1 = SpecularReflection,
  2 = DiffuseTransmission, 3 = SpecularTransmission.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from rustic.ops import sampling as s
from rustic.ops.texture import sample_atlas

LOBE_DIFFUSE = 0
LOBE_SPECULAR = 1
LOBE_DIFFUSE_T = 2
LOBE_SPECULAR_T = 3

# Dielectric constants (reference: kernels/src/bsdf.rs:178-183)
DIELECTRIC_IOR = 1.5
_F0_SQRT = (DIELECTRIC_IOR - 1.0) / (DIELECTRIC_IOR + 1.0)
DIELECTRIC_F0 = _F0_SQRT * _F0_SQRT


class PBRMaterial(NamedTuple):
    """Per-lane PBR parameters (reference: kernels/src/bsdf.rs:185-190)."""

    albedo: jnp.ndarray  # [B, 3]
    roughness: jnp.ndarray  # [B]
    metallic: jnp.ndarray  # [B]
    specular_weight_clamp: jnp.ndarray  # [2]


class BSDFSample(NamedTuple):
    """(reference: kernels/src/bsdf.rs:20-26)"""

    pdf: jnp.ndarray  # [B]
    lobe: jnp.ndarray  # [B] i32
    spectrum: jnp.ndarray  # [B, 3]
    direction: jnp.ndarray  # [B, 3]


def _specular_weight(mat: PBRMaterial, n_dot_v):
    """Fresnel-lerp lobe weight with firefly clamp
    (reference: kernels/src/bsdf.rs:275-280)."""
    approx_fresnel = s.fresnel_schlick_scalar(
        1.0, DIELECTRIC_IOR, jnp.maximum(n_dot_v, 0.0)
    )
    w = s.lerp(approx_fresnel, 1.0, mat.metallic)
    clamped = jnp.clip(
        w, mat.specular_weight_clamp[0], mat.specular_weight_clamp[1]
    )
    return jnp.where((w != 0.0) & (w != 1.0), clamped, w)


def _ks(mat: PBRMaterial, h_dot_v):
    f0 = s.lerp(
        jnp.full_like(mat.albedo, DIELECTRIC_F0), mat.albedo, mat.metallic[..., None]
    )
    return s.fresnel_schlick(jnp.maximum(h_dot_v, 0.0), f0)


def _eval_diffuse(mat, cos_theta, specular_weight, ks):
    """(reference: kernels/src/bsdf.rs:193-202)"""
    kd = (1.0 - ks) * (1.0 - mat.metallic[..., None])
    diffuse = kd * mat.albedo / jnp.pi
    return diffuse * (cos_theta / jnp.maximum(1.0 - specular_weight, 1e-8))[..., None]


def _eval_specular(mat, view, normal, light, cos_theta, d_term, specular_weight, ks):
    """(reference: kernels/src/bsdf.rs:204-219)"""
    g_term = s.geometry_smith_schlick_ggx(normal, view, light, mat.roughness)
    numerator = (d_term * g_term)[..., None] * ks
    denominator = 4.0 * jnp.maximum(s.dot(normal, view), 0.0) * cos_theta
    spec = numerator / jnp.maximum(denominator, s.EPS)[..., None]
    return spec * (cos_theta / jnp.maximum(specular_weight, 1e-8))[..., None]


def _pdf_diffuse(cos_theta):
    return cos_theta / jnp.pi


def _pdf_specular(view, normal, halfway, d_term):
    return (d_term * s.dot(normal, halfway)) / (
        4.0 * s.dot(view, halfway)
    )


def pbr_sample(
    mat: PBRMaterial, view: jnp.ndarray, normal: jnp.ndarray, r1, r2, r3
) -> BSDFSample:
    """Sample the PBR BSDF for every lane
    (reference: kernels/src/bsdf.rs:272-334).

    `view` points away from the surface (= -ray_direction).
    """
    n_dot_v = s.dot(normal, view)
    specular_weight = _specular_weight(mat, n_dot_v)

    # Diffuse candidate: cosine hemisphere about the normal
    up, right, forward = s.create_cartesian(normal)
    diff_dir = s.local_to_world(
        s.cosine_sample_hemisphere(r1, r2), up, right, forward
    )
    # Specular candidate: Karis GGX about the mirror direction
    refl = s.reflect(-view, normal)
    spec_dir = s.sample_ggx(r1, r2, refl, mat.roughness)

    take_spec = r3 < specular_weight
    direction = jnp.where(s.expand_mask(take_spec), spec_dir, diff_dir)
    lobe = jnp.where(take_spec, LOBE_SPECULAR, LOBE_DIFFUSE).astype(jnp.int32)

    cos_theta = jnp.maximum(s.dot(normal, direction), s.EPS)
    halfway = s.normalize(view + direction)
    ks = _ks(mat, s.dot(halfway, view))
    d_term = s.ggx_distribution(normal, halfway, mat.roughness)

    pdf_d = _pdf_diffuse(cos_theta)
    spec_d = _eval_diffuse(mat, cos_theta, specular_weight, ks)
    pdf_s = _pdf_specular(view, normal, halfway, d_term)
    spec_s = _eval_specular(
        mat, view, normal, direction, cos_theta, d_term, specular_weight, ks
    )

    pdf = jnp.where(take_spec, pdf_s, pdf_d)
    spectrum = jnp.where(s.expand_mask(take_spec), spec_s, spec_d)
    return BSDFSample(pdf=pdf, lobe=lobe, spectrum=spectrum, direction=direction)


def pbr_evaluate_lobe(
    mat: PBRMaterial, view, normal, light, lobe_is_specular=False
):
    """Evaluate the BSDF for a given direction and lobe
    (reference: kernels/src/bsdf.rs:237-270). NEE always evaluates the
    diffuse lobe (kernels/src/light_pick.rs:153)."""
    n_dot_v = s.dot(normal, view)
    specular_weight = _specular_weight(mat, n_dot_v)
    cos_theta = jnp.maximum(s.dot(normal, light), 0.0)
    halfway = s.normalize(view + light)
    ks = _ks(mat, s.dot(halfway, view))
    if not lobe_is_specular:
        return _eval_diffuse(mat, cos_theta, specular_weight, ks)
    d_term = s.ggx_distribution(normal, halfway, mat.roughness)
    return _eval_specular(
        mat, view, normal, light, cos_theta, d_term, specular_weight, ks
    )


def pbr_pdf_lobe(mat: PBRMaterial, view, normal, light, lobe_is_specular=False):
    """(reference: kernels/src/bsdf.rs:336-351)"""
    if not lobe_is_specular:
        return _pdf_diffuse(jnp.maximum(s.dot(normal, light), 0.0))
    halfway = s.normalize(view + light)
    d_term = s.ggx_distribution(normal, halfway, mat.roughness)
    return _pdf_specular(view, normal, halfway, d_term)


def material_tex_rect(has_tex, albedo_slot, metal_slot, rough_slot,
                      norm_slot):
    """The material's shared atlas rect: every textured map of a
    material lands at ONE co-located cell (scene/atlas.py
    pack_material_textures), so any textured slot holds the rect —
    pick the first. Untextured lanes yield a constant-color vec4 whose
    fetch lands on dummy texels and is discarded by the has_tex
    selects (same dead-fetch semantics the per-map form had)."""
    return jnp.where(
        has_tex[..., 0:1] != 0, albedo_slot,
        jnp.where(
            has_tex[..., 1:2] != 0, metal_slot,
            jnp.where(has_tex[..., 2:3] != 0, rough_slot, norm_slot),
        ),
    )


def material_tex_rows(scene, rect, uv):
    """ONE bilinear footprint (4 row gathers) over the 9-channel
    co-located material atlas -> [B, 9] rows serving albedo + metallic
    + roughness + normal at once, where the per-map form cost 4 maps x
    4 corners = 16 row gathers per bounce."""
    return sample_atlas(scene.atlas, rect, uv)


def get_pbr_material(
    scene, mat_idx: jnp.ndarray, uv: jnp.ndarray, specular_weight_clamp
) -> PBRMaterial:
    """Assemble per-lane PBR parameters, fetching atlas texels where the
    material is textured (reference: kernels/src/bsdf.rs:354-387)."""
    from rustic.scene.atlas import CH_ALBEDO, CH_METAL, CH_ROUGH

    has_tex = scene.mat_has_tex[mat_idx]  # [B, 4]
    albedo_slot = scene.mat_albedo[mat_idx]
    rough_slot = scene.mat_roughness[mat_idx]
    metal_slot = scene.mat_metallic[mat_idx]
    rect = material_tex_rect(
        has_tex, albedo_slot, metal_slot, rough_slot,
        scene.mat_normals[mat_idx],
    )
    rows = material_tex_rows(scene, rect, uv)

    albedo = jnp.where(
        has_tex[..., 0:1] != 0, rows[..., CH_ALBEDO][..., :3],
        albedo_slot[..., :3],
    )
    roughness = jnp.where(
        has_tex[..., 2] != 0, rows[..., CH_ROUGH], rough_slot[..., 0]
    )
    metallic = jnp.where(
        has_tex[..., 1] != 0, rows[..., CH_METAL], metal_slot[..., 0]
    )

    # NaN-avoidance clamps (reference: kernels/src/bsdf.rs:377-379)
    roughness = jnp.maximum(roughness, s.EPS)
    metallic = jnp.minimum(metallic, 1.0 - s.EPS)
    return PBRMaterial(
        albedo=albedo,
        roughness=roughness,
        metallic=metallic,
        specular_weight_clamp=specular_weight_clamp,
    )


def material_from_attrs(
    scene, attrs: jnp.ndarray, uv: jnp.ndarray, specular_weight_clamp,
    tex_rows=None,
) -> PBRMaterial:
    """PBR parameters from the packed per-triangle shading row
    (scene/world.py ATTR_*) — the gather-free twin of get_pbr_material.
    Atlas fetches only happen for scenes that actually carry textures
    (static flag), mirroring kernels/src/bsdf.rs:354-387 semantics.

    `tex_rows` ([B, 9] co-located material rows) lets the caller share
    ONE bilinear footprint between normal mapping and the material
    (trace.bounce_pre hoists it); when None and the scene is textured,
    the fetch happens here."""
    from rustic.scene import world as W
    from rustic.scene.atlas import CH_ALBEDO, CH_METAL, CH_ROUGH

    albedo = attrs[:, W.ATTR_ALBEDO][:, :3]
    roughness = attrs[:, W.ATTR_ROUGH.start]
    metallic = attrs[:, W.ATTR_METAL.start]
    if scene.has_textures:
        has_tex = attrs[:, W.ATTR_HASTEX]
        if tex_rows is None:
            rect = material_tex_rect(
                has_tex, attrs[:, W.ATTR_ALBEDO], attrs[:, W.ATTR_METAL],
                attrs[:, W.ATTR_ROUGH], attrs[:, W.ATTR_NORMTEX],
            )
            tex_rows = material_tex_rows(scene, rect, uv)
        albedo = jnp.where(
            has_tex[:, 0:1] != 0, tex_rows[..., CH_ALBEDO][..., :3], albedo
        )
        roughness = jnp.where(
            has_tex[:, 2] != 0, tex_rows[..., CH_ROUGH], roughness
        )
        metallic = jnp.where(
            has_tex[:, 1] != 0, tex_rows[..., CH_METAL], metallic
        )

    roughness = jnp.maximum(roughness, s.EPS)
    metallic = jnp.minimum(metallic, 1.0 - s.EPS)
    return PBRMaterial(
        albedo=albedo,
        roughness=roughness,
        metallic=metallic,
        specular_weight_clamp=specular_weight_clamp,
    )


# ---------------------------------------------------------------------------
# Lambertian (reference: kernels/src/bsdf.rs:46-105)
# ---------------------------------------------------------------------------


def lambertian_sample(albedo, normal, r1, r2) -> BSDFSample:
    up, right, forward = s.create_cartesian(normal)
    direction = s.local_to_world(
        s.cosine_sample_hemisphere(r1, r2), up, right, forward
    )
    cos_theta = jnp.maximum(s.dot(normal, direction), 0.0)
    pdf = cos_theta / jnp.pi
    spectrum = albedo / jnp.pi * cos_theta[..., None]
    lobe = jnp.full(pdf.shape, LOBE_DIFFUSE, jnp.int32)
    return BSDFSample(pdf=pdf, lobe=lobe, spectrum=spectrum, direction=direction)


# ---------------------------------------------------------------------------
# Glass: GGX microfacet dielectric (reference: kernels/src/bsdf.rs:107-176)
# ---------------------------------------------------------------------------


def glass_sample(albedo, ior, roughness, view, normal, r1, r2, r3) -> BSDFSample:
    inside = s.dot(normal, view) < 0.0
    n = jnp.where(s.expand_mask(inside), -normal, normal)
    in_ior = jnp.where(inside, ior, 1.0)
    out_ior = jnp.where(inside, 1.0, ior)

    m = s.sample_ggx_microsurface_normal(r1, r2, n, roughness)
    fresnel = s.fresnel_schlick_scalar(
        in_ior, out_ior, jnp.maximum(s.dot(m, view), 0.0)
    )
    reflect_dir = s.normalize(
        2.0 * jnp.abs(s.dotk(view, m)) * m - view
    )
    eta = in_ior / out_ior
    c = s.dot(view, m)
    k = 1.0 + eta * eta * (c * c - 1.0)
    sign_vn = jnp.sign(s.dot(view, n))
    refr_scale = eta * c - sign_vn * jnp.sqrt(jnp.maximum(k, 0.0))
    refract_dir = s.normalize(refr_scale[..., None] * m - eta[..., None] * view)

    reflecting = r3 <= fresnel
    direction = jnp.where(s.expand_mask(reflecting), reflect_dir, refract_dir)
    spectrum = jnp.where(s.expand_mask(reflecting), jnp.ones_like(albedo), albedo)
    lobe = jnp.where(reflecting, LOBE_SPECULAR, LOBE_SPECULAR_T).astype(jnp.int32)
    pdf = jnp.ones(r3.shape, jnp.float32)  # delta distribution
    return BSDFSample(pdf=pdf, lobe=lobe, spectrum=spectrum, direction=direction)
