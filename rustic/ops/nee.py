"""Next-event estimation: alias-table light picking, direct light
sampling with shadow rays, and MIS bookkeeping across bounces.

Capability parity with the reference device module
(reference: kernels/src/light_pick.rs). Fully batched: every lane picks
a light, samples a point, casts a shadow ray (vectorized any-hit), and
the contribution is masked by eligibility (NEE mode, diffuse lobe,
sentinel table).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from rustic.config import NextEventEstimation
from rustic.ops import bsdf as bsdf_mod
from rustic.ops import sampling as s
from rustic.ops.intersect import intersect_any


class DirectLightSample(NamedTuple):
    """One bounce's direct-light sample
    (reference: kernels/src/light_pick.rs:89-98)."""

    light_area: jnp.ndarray  # [B]
    light_normal: jnp.ndarray  # [B, 3]
    light_pick_pdf: jnp.ndarray  # [B]
    light_emission: jnp.ndarray  # [B, 3]
    light_triangle_index: jnp.ndarray  # [B] i32
    throughput: jnp.ndarray  # [B, 3]
    contribution: jnp.ndarray  # [B, 3]


class MISCarry(NamedTuple):
    """Between-bounce carry for the MIS BSDF side, pre-reduced at
    record time. The reference carries the whole light sample plus the
    BSDF sample to the next bounce (kernels/src/light_pick.rs:89-98
    consumed at :179-199); but everything in that computation except
    the NEXT hit's (t, triangle index) is already known when the light
    is sampled, so the carry collapses from 22 f32 columns to 6 of
    per-lane state."""

    vec: jnp.ndarray  # [B,3] throughput*spectrum*emission/(pdf*pick_pdf)
    area_cos: jnp.ndarray  # [B] light_area * cos(light_normal, -bounce_dir)
    pdf: jnp.ndarray  # [B] BSDF sample pdf (power-heuristic numerator)
    tri: jnp.ndarray  # [B] i32 sampled light's global triangle index

    @classmethod
    def zeros(cls, batch: int) -> "MISCarry":
        return cls(
            vec=jnp.zeros((batch, 3), jnp.float32),
            area_cos=jnp.zeros(batch, jnp.float32),
            pdf=jnp.zeros(batch, jnp.float32),
            tri=jnp.zeros(batch, jnp.int32),
        )


def resolve_entry(row, r2):
    """Resolve one fetched combined alias/geometry row (scene/world.py
    ENTRY_*) into the picked light's fields — the second half of the
    alias-method pick (reference: kernels/src/light_pick.rs:11-15).

    Pure vector math on an already-fetched [B, 48] row. Returns a dict of
    (area, pdf, verts a/b/c, normal, emission, tri_idx)."""
    from rustic.scene import world as W

    take = s.expand_mask(r2 < row[:, W.ENTRY_RATIO])

    def sel(a_sl, b_sl):
        return jnp.where(take, row[:, a_sl], row[:, b_sl])

    verts = sel(W.ENTRY_A_VERTS, W.ENTRY_B_VERTS)
    return {
        "area": sel(
            slice(W.ENTRY_AREA_A, W.ENTRY_AREA_A + 1),
            slice(W.ENTRY_AREA_B, W.ENTRY_AREA_B + 1),
        )[:, 0],
        "pdf": sel(
            slice(W.ENTRY_PDF_A, W.ENTRY_PDF_A + 1),
            slice(W.ENTRY_PDF_B, W.ENTRY_PDF_B + 1),
        )[:, 0],
        "va": verts[:, 0:3],
        "vb": verts[:, 3:6],
        "vc": verts[:, 6:9],
        "normal": sel(W.ENTRY_A_NORMAL, W.ENTRY_B_NORMAL),
        "emission": sel(W.ENTRY_A_EMISSION, W.ENTRY_B_EMISSION),
        "tri_idx": sel(
            slice(W.ENTRY_A_TRI, W.ENTRY_A_TRI + 1),
            slice(W.ENTRY_B_TRI, W.ENTRY_B_TRI + 1),
        )[:, 0].astype(jnp.int32),
    }


# Alias tables at or below this row count are fetched by a masked
# select-sum instead of a row gather: the select-sum is n fused
# multiply-adds per lane, where a gather pays per-row latency whatever
# the table size.
ENTRY_SELECT_MAX = 16


def fetch_entry_rows(scene, entry):
    """entry_rows[entry] — gather for big tables, select-sum for small."""
    n = scene.n_alias_entries
    if n > ENTRY_SELECT_MAX:
        return scene.entry_rows[entry]
    table = scene.entry_rows[:n]  # static slice
    out = jnp.zeros((entry.shape[0], table.shape[1]), table.dtype)
    for k in range(n):
        out = out + jnp.where((entry == k)[:, None], table[k], 0.0)
    return out


def resolve_entry_fields(scene, entry, r2):
    """resolve_entry(fetch_entry_rows(...)) without ever materializing a
    [B, ENTRY_WIDTH] row matrix: for small tables every resolved field
    is a per-entry select-sum against the STATIC table rows (scalar /
    tiny-vector broadcasts), so only the ~16 resolved columns are
    written to device memory instead of a [B, 48] row matrix."""
    from rustic.scene import world as W

    n = scene.n_alias_entries
    if n > ENTRY_SELECT_MAX:
        return resolve_entry(scene.entry_rows[entry], r2)

    def zeros_like_row(sl):
        w = (sl.stop - sl.start) if isinstance(sl, slice) else None
        if w is None:
            return jnp.zeros(entry.shape, jnp.float32)
        return jnp.zeros(entry.shape + (w,), jnp.float32)

    specs = {
        "area": (W.ENTRY_AREA_A, W.ENTRY_AREA_B),
        "pdf": (W.ENTRY_PDF_A, W.ENTRY_PDF_B),
        "verts": (W.ENTRY_A_VERTS, W.ENTRY_B_VERTS),
        "normal": (W.ENTRY_A_NORMAL, W.ENTRY_B_NORMAL),
        "emission": (W.ENTRY_A_EMISSION, W.ENTRY_B_EMISSION),
        "tri": (W.ENTRY_A_TRI, W.ENTRY_B_TRI),
    }
    acc = {name: zeros_like_row(a) for name, (a, _) in specs.items()}
    for k in range(n):
        row = scene.entry_rows[k]  # [ENTRY_WIDTH] — broadcasts, no gather
        use = entry == k
        take = use & (r2 < row[W.ENTRY_RATIO])
        for name, (a_sl, b_sl) in specs.items():
            v = jnp.where(
                take[:, None] if isinstance(a_sl, slice) else take,
                row[a_sl], row[b_sl],
            )
            m = use[:, None] if isinstance(a_sl, slice) else use
            acc[name] = acc[name] + jnp.where(m, v, 0.0)
    verts = acc["verts"]
    return {
        "area": acc["area"],
        "pdf": acc["pdf"],
        "va": verts[:, 0:3],
        "vb": verts[:, 3:6],
        "vc": verts[:, 6:9],
        "normal": acc["normal"],
        "emission": acc["emission"],
        "tri_idx": acc["tri"].astype(jnp.int32),
    }


def pick_light(scene, r1, r2):
    """O(1) alias-table pick (reference: kernels/src/light_pick.rs:8-16):
    one combined-row fetch resolves the pick and the light's geometry.
    Returns (global_triangle_index, area, pick_pdf), each [B]."""
    n = scene.n_alias_entries
    entry = jnp.clip((r1 * n).astype(jnp.int32), 0, n - 1)
    fields = resolve_entry_fields(scene, entry, r2)
    return fields["tri_idx"], fields["area"], fields["pdf"]


def pick_triangle_point(a, b, c, r1, r2):
    """Uniform point on a triangle via sqrt warp
    (reference: kernels/src/light_pick.rs:19-23; Osada et al. eq. 1)."""
    r1_sqrt = jnp.sqrt(r1)[..., None]
    r2e = r2[..., None]
    return (1.0 - r1_sqrt) * a + (r1_sqrt * (1.0 - r2e)) * b + (r1_sqrt * r2e) * c


def light_pdf_area_to_solid_angle(light_area, light_distance, light_normal, light_direction):
    """r^2 / (A * cos) conversion; 0 when the light faces away
    (reference: kernels/src/light_pick.rs:30-79)."""
    cos_theta = s.dot(light_normal, -light_direction)
    pdf = (light_distance * light_distance) / jnp.maximum(
        light_area * cos_theta, 1e-20
    )
    return jnp.where(cos_theta > 0.0, pdf, 0.0)


def _mis_weight(nee: NextEventEstimation, p1, p2):
    """(reference: kernels/src/light_pick.rs:81-87)"""
    if nee == NextEventEstimation.MIS:
        return s.power_heuristic(p1, p2)
    return jnp.ones_like(p1)


def prepare_direct_lighting(
    scene,
    nee: NextEventEstimation,
    mat: bsdf_mod.PBRMaterial,
    throughput,
    surface_point,
    surface_normal,
    ray_direction,
    r,  # tuple of 4 rng draws, each [B]
):
    """Direct-lighting candidate for every lane, *before* the visibility
    test (reference: kernels/src/light_pick.rs:100-173 minus the
    intersect_any call at :141). Returns
    (DirectLightSample with unoccluded contribution,
     (shadow_ro, shadow_rd, shadow_maxt, geometric_ok)).
    The occlusion result is applied by the caller (see
    ops/trace.py:bounce_post) so the shadow rays can be batched through
    a separate traversal kernel."""
    r1, r2, r3, r4 = r
    # One combined-row fetch resolves the alias pick AND the picked
    # light's geometry/emission (reference does 1 table read + 6 buffer
    # reads, kernels/src/light_pick.rs:121-131).
    n = scene.n_alias_entries
    entry = jnp.clip((r1 * n).astype(jnp.int32), 0, n - 1)
    light = resolve_entry_fields(scene, entry, r2)
    light_area = light["area"]
    light_pick_pdf = light["pdf"]
    la, lb, lc = light["va"], light["vb"], light["vc"]
    # flat-shaded light normal (reference: kernels/src/light_pick.rs:129)
    light_normal = light["normal"]
    light_emission = light["emission"]
    light_tri_global = light["tri_idx"]

    light_point = pick_triangle_point(la, lb, lc, r3, r4)
    delta = light_point - surface_point
    light_distance = s.length(delta)
    light_dir = delta / jnp.maximum(light_distance, 1e-12)[..., None]

    light_pdf = light_pdf_area_to_solid_angle(
        light_area, light_distance, light_normal, light_dir
    )
    view = -ray_direction
    bsdf_attenuation = bsdf_mod.pbr_evaluate_lobe(
        mat, view, surface_normal, light_dir, lobe_is_specular=False
    )
    bsdf_pdf = bsdf_mod.pbr_pdf_lobe(
        mat, view, surface_normal, light_dir, lobe_is_specular=False
    )
    weight = _mis_weight(nee, light_pdf, bsdf_pdf)
    direct = (
        bsdf_attenuation
        * light_emission
        * (weight / jnp.maximum(light_pdf, 1e-20) / jnp.maximum(light_pick_pdf, 1e-20))[
            ..., None
        ]
    )
    geom_ok = (light_pdf > 0.0) & (bsdf_pdf > 0.0)
    direct = jnp.where(geom_ok[..., None], direct, 0.0)

    dls = DirectLightSample(
        light_area=light_area,
        light_normal=light_normal,
        light_pick_pdf=light_pick_pdf,
        light_emission=light_emission,
        light_triangle_index=light_tri_global,
        throughput=throughput,
        contribution=throughput * direct,
    )
    shadow = (
        surface_point + light_dir * s.EPS,
        light_dir,
        light_distance - s.EPS * 2.0,
        geom_ok,
    )
    return dls, shadow


def sample_direct_lighting(
    scene,
    nee: NextEventEstimation,
    mat: bsdf_mod.PBRMaterial,
    throughput,
    surface_point,
    surface_normal,
    ray_direction,
    r,
    engine: str = "auto",
) -> DirectLightSample:
    """Fused prepare + visibility (reference:
    kernels/src/light_pick.rs:100-173 in full)."""
    dls, shadow = prepare_direct_lighting(
        scene, nee, mat, throughput, surface_point, surface_normal, ray_direction, r
    )
    occluded = intersect_any(scene, shadow[0], shadow[1], shadow[2], engine=engine)
    lit = shadow[3] & ~occluded
    return dls._replace(
        contribution=jnp.where(lit[..., None], dls.contribution, 0.0)
    )


def make_mis_carry(
    throughput,
    bsdf_pdf,
    bsdf_spectrum,
    bounce_direction,
    light_area,
    light_normal,
    light_pick_pdf,
    light_emission,
    light_tri,
) -> MISCarry:
    """Pre-reduce the BSDF-side MIS carry at record time (see MISCarry).
    `bounce_direction` is the BSDF-sampled continuation direction — the
    ray that may land on the sampled light next bounce."""
    vec = (
        throughput
        * bsdf_spectrum
        * light_emission
        / (
            jnp.maximum(bsdf_pdf, 1e-20) * jnp.maximum(light_pick_pdf, 1e-20)
        )[..., None]
    )
    area_cos = light_area * s.dot(light_normal, -bounce_direction)
    return MISCarry(vec=vec, area_cos=area_cos, pdf=bsdf_pdf, tri=light_tri)


def mis_carry_contribution(hit_tri_idx, hit_t, carry: MISCarry):
    """BSDF-sampling side of MIS when a diffuse bounce lands on the light
    that was sampled directly last bounce
    (reference: kernels/src/light_pick.rs:179-199), evaluated from the
    slim carry: light_pdf = t^2 / (area*cos) with the cos>0 facing test
    folded into the area_cos sign. Returns [B, 3]."""
    same_light = hit_tri_idx == carry.tri
    light_pdf = hit_t * hit_t / jnp.maximum(carry.area_cos, 1e-20)
    weight = s.power_heuristic(carry.pdf, light_pdf)
    ok = same_light & (carry.area_cos > 0.0)
    return jnp.where(s.expand_mask(ok), carry.vec * weight[..., None], 0.0)
