"""The wavefront path-trace integrator.

The reference renders one divergent per-pixel megakernel
(reference: kernels/src/lib.rs:21-186). Here it is inverted: a flat SoA
batch of paths advances bounce-by-bounce in lockstep; dead lanes are
masked, not branched around. All per-bounce stages — intersect, sky,
emissive handling, attribute interpolation, BSDF sampling, NEE,
russian roulette — are wide vector ops (ops/intersect.py for the
traversal engines).

The bounce is decomposed into stage functions (`init_state`,
`bounce_pre`, `bounce_post`) with the intersection results as explicit
inputs/outputs; `trace_paths` chains them into one jitted program.

Bounce-level capability parity with the reference loop
(kernels/src/lib.rs:62-183), including NEE emissive double-count
avoidance, single-sided emitters, MIS-weighted BSDF contributions on
light hits, throughput *= spectrum/pdf with NaN containment, and
russian roulette after min_bounces.

Low-discrepancy dimensions are assigned statically per stage: dims
(1,2) for the AA jitter, then 8 per bounce (3 BSDF, 4 NEE, 1 roulette).
The reference increments a dimension counter per draw with the same
budget (kernels/src/rng.rs:34-63); static assignment keeps every lane
on the same dimension — the lockstep requirement.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from rustic.config import CameraParams, StaticConfig
from rustic.ops import bsdf as bsdf_mod
from rustic.ops import nee as nee_mod
from rustic.ops import sampling as s
from rustic.ops.intersect import (
    TraceResult,
    gather_attr_rows,
    intersect_any,
    intersect_nearest,
)
from rustic.ops.rng import lds
from rustic.ops.skybox import sky_radiance

_DIMS_PER_BOUNCE = 8
_AA_DIMS = 2


class TraceState(NamedTuple):
    """Per-lane carry between bounces. Kept deliberately slim: the MIS
    bookkeeping rides as the pre-reduced 6-column MISCarry instead of
    the reference's full light+BSDF sample pair (see ops/nee.py
    MISCarry). The continuation direction needs no
    slot of its own — it IS `rd` (both are set to the BSDF-sampled
    direction under the same mask)."""

    ro: jnp.ndarray  # [B, 3]
    rd: jnp.ndarray  # [B, 3]
    throughput: jnp.ndarray  # [B, 3]
    radiance: jnp.ndarray  # [B, 3]
    alive: jnp.ndarray  # [B] bool
    missed: jnp.ndarray  # [B] bool — escaped the scene (sky owed, see bounce_pre)
    last_lobe_diffuse: jnp.ndarray  # [B] bool
    mis: nee_mod.MISCarry


class NEEPack(NamedTuple):
    """Shadow-ray request + unoccluded candidate contribution."""

    shadow_ro: jnp.ndarray  # [B, 3]
    shadow_rd: jnp.ndarray  # [B, 3]
    shadow_maxt: jnp.ndarray  # [B]
    contribution: jnp.ndarray  # [B, 3] throughput-weighted, pre-visibility
    eligible: jnp.ndarray  # [B] bool


def camera_rays(
    cfg: StaticConfig,
    cam: CameraParams,
    px: jnp.ndarray,
    py: jnp.ndarray,
    sample_idx,
    offsets,
):
    """Jittered pinhole camera rays (reference: kernels/src/lib.rs:38-51)."""
    jx = lds(sample_idx, 1, offsets)
    jy = lds(sample_idx, 2, offsets)
    sx = px.astype(jnp.float32) + jx
    sy = py.astype(jnp.float32) + jy
    u = (sx / cfg.width) * 2.0 - 1.0
    v = ((1.0 - sy / cfg.height) * 2.0 - 1.0) * (cfg.height / cfg.width)

    rd = s.normalize(jnp.stack([u, v, jnp.ones_like(u)], axis=-1))
    pitch, yaw = cam.cam_rotation[0], cam.cam_rotation[1]
    cx, sx_ = jnp.cos(pitch), jnp.sin(pitch)
    cy, sy_ = jnp.cos(yaw), jnp.sin(yaw)
    # Ry(yaw) @ Rx(pitch), applied to rd (reference: kernels/src/lib.rs:50-51)
    x = rd[..., 0]
    y = rd[..., 1]
    z = rd[..., 2]
    y, z = cx * y - sx_ * z, sx_ * y + cx * z
    x, z = cy * x + sy_ * z, -sy_ * x + cy * z
    rd = jnp.stack([x, y, z], axis=-1)
    ro = jnp.broadcast_to(cam.cam_position, rd.shape)
    return ro, rd


def sample_draws(cfg: StaticConfig, sample_idx, offsets) -> jnp.ndarray:
    """All of one sample's per-bounce LDS draws, [B, 8*max_bounces]:
    per bounce 3 BSDF + 4 NEE + 1 roulette (dims as documented above).
    Precomputing them keeps the bounce stages free of integer RNG work
    (used by the single-program trace_paths driver)."""
    cols = [
        lds(sample_idx, _AA_DIMS + b * _DIMS_PER_BOUNCE + 1 + k, offsets)
        for b in range(cfg.max_bounces)
        for k in range(_DIMS_PER_BOUNCE)
    ]
    return jnp.stack(cols, axis=-1)


def init_state(
    cfg: StaticConfig, cam: CameraParams, px, py, sample_idx, offsets
) -> TraceState:
    batch = px.shape[0]
    ro, rd = camera_rays(cfg, cam, px, py, sample_idx, offsets)
    return TraceState(
        ro=ro,
        rd=rd,
        throughput=jnp.ones((batch, 3), jnp.float32),
        radiance=jnp.zeros((batch, 3), jnp.float32),
        alive=jnp.ones(batch, bool),
        missed=jnp.zeros(batch, bool),
        last_lobe_diffuse=jnp.zeros(batch, bool),
        mis=nee_mod.MISCarry.zeros(batch),
    )


def _where_tuple(mask, new, old):
    out = []
    for n, o in zip(new, old):
        m = mask if n.ndim == 1 else mask[..., None]
        out.append(jnp.where(m, n, o))
    return type(new)(*out)


def bounce_pre(
    scene,
    cfg: StaticConfig,
    cam: CameraParams,
    bounce: int,
    st: TraceState,
    res: TraceResult,
    draws: jnp.ndarray,
) -> Tuple[TraceState, Optional[NEEPack]]:
    """Everything in one bounce except the shadow-ray visibility test:
    sky, emissive termination/MIS, attribute interpolation, BSDF sample,
    NEE candidate preparation, throughput/ray update, roulette.

    Shading reads the hit triangle's packed row (scene/world.py ATTR_*)
    with one row gather — the only indexed fetch on the shading path.

    Returns the advanced state and (when NEE is active) the shadow-ray
    request; `bounce_post` folds the visibility result in.
    """
    from rustic.scene import world as W

    batch = st.ro.shape[0]
    nee = cfg.nee
    uses_nee = nee.uses_nee and scene.has_lights
    ro, rd = st.ro, st.rd
    throughput = st.throughput
    radiance = st.radiance

    attrs = gather_attr_rows(scene, res.tri_idx)

    hit_pos = ro + rd * res.t[..., None]

    # ---- miss: sky, DEFERRED (reference: kernels/src/lib.rs:66-79) --------
    # A lane can escape at most once per sample, and a dead lane's
    # ro/rd/throughput stay frozen at their miss-time values (every
    # update below is masked by `shade`). So instead of paying the
    # 12-step atmosphere march every bounce (measured ~10 ms/bounce at
    # 1.8M lanes on DarkCornell), we only flag the miss here and fold
    # sky radiance in ONCE on the final bounce — bit-exact, because a
    # dead lane's later bounces contribute exactly +0.0 to radiance.
    miss = st.alive & ~res.hit
    missed = st.missed | miss

    hit_alive = st.alive & res.hit
    emissive = attrs[:, W.ATTR_EMISSIVE]
    is_emissive = jnp.any(emissive != 0.0, axis=-1)
    emis_hit = hit_alive & is_emissive
    front_emis = emis_hit & ~res.backface

    # ---- emissive handling (reference: kernels/src/lib.rs:85-109) ---------
    if not nee.uses_nee:
        add_direct = front_emis
        die_emis = emis_hit
    else:
        first_or_nondiffuse = (
            jnp.full(batch, bounce == 0) | ~st.last_lobe_diffuse
        )
        add_direct = front_emis & first_or_nondiffuse
        if nee.uses_mis:
            die_emis = emis_hit
        else:  # DLS: paths continue off non-qualifying emissive hits
            die_emis = emis_hit & (res.backface | first_or_nondiffuse)
    radiance = radiance + jnp.where(
        add_direct[..., None], s.mask_nan(throughput * emissive), 0.0
    )
    if nee.uses_mis:
        mis_mask = front_emis & ~add_direct & st.last_lobe_diffuse
        mis_contrib = nee_mod.mis_carry_contribution(res.tri_idx, res.t, st.mis)
        radiance = radiance + jnp.where(
            mis_mask[..., None], s.mask_nan(mis_contrib), 0.0
        )

    # NOTE: the full body runs on the final bounce too — NEE still
    # contributes there (the reference's loop does the same, the sampled
    # continuation ray is simply never traced). XLA dead-code eliminates
    # the unused final ray update.
    shade = hit_alive & ~die_emis

    # ---- vertex attribute interpolation (kernels/src/lib.rs:111-129) ------
    w_b = res.u[..., None]
    w_c = res.v[..., None]
    w_a = 1.0 - w_b - w_c
    nrm = attrs[:, W.ATTR_NRM]
    # NOT renormalized — deliberate parity with the reference, which
    # shades with the raw barycentric blend (kernels/src/lib.rs:125;
    # only its normal-map branch normalizes, lib.rs:140). |n| < 1 on
    # coarse meshes slightly darkens NEE; kept to match its images.
    normal = w_a * nrm[:, 0:3] + w_b * nrm[:, 3:6] + w_c * nrm[:, 6:9]
    uvs = attrs[:, W.ATTR_UV]
    uv = w_a * uvs[:, 0:2] + w_b * uvs[:, 2:4] + w_c * uvs[:, 4:6]
    out_of_range = jnp.any((uv < 0.0) | (uv > 1.0), axis=-1, keepdims=True)
    uv = jnp.where(out_of_range, uv - jnp.floor(uv), uv)

    # ---- normal mapping (kernels/src/lib.rs:131-141) -----------------------
    # (statically skipped for scenes without any texture maps)
    tex_rows = None
    if scene.has_textures:
        from rustic.scene.atlas import CH_NORMAL

        # ONE bilinear footprint over the co-located 9-channel material
        # atlas serves normal mapping AND the BSDF maps below (see
        # scene/atlas.pack_material_textures)
        has_tex = attrs[:, W.ATTR_HASTEX]
        rect = bsdf_mod.material_tex_rect(
            has_tex, attrs[:, W.ATTR_ALBEDO], attrs[:, W.ATTR_METAL],
            attrs[:, W.ATTR_ROUGH], attrs[:, W.ATTR_NORMTEX],
        )
        tex_rows = bsdf_mod.material_tex_rows(scene, rect, uv)
        has_nm = has_tex[:, 3] != 0
        nm = tex_rows[..., CH_NORMAL] * 2.0 - 1.0
        tan = attrs[:, W.ATTR_TAN]
        tangent = w_a * tan[:, 0:3] + w_b * tan[:, 3:6] + w_c * tan[:, 6:9]
        bitangent = s.cross(tangent, normal)
        mapped = s.normalize(
            tangent * nm[..., 0:1]
            + bitangent * nm[..., 1:2]
            + normal * nm[..., 2:3]
        )
        normal = jnp.where(has_nm[..., None], mapped, normal)

    # ---- BSDF sample (kernels/src/lib.rs:143-146) --------------------------
    mat = bsdf_mod.material_from_attrs(
        scene, attrs, uv, cam.specular_weight_clamp, tex_rows=tex_rows
    )
    r1 = draws[:, 0]
    r2 = draws[:, 1]
    r3 = draws[:, 2]
    bs = bsdf_mod.pbr_sample(mat, -rd, normal, r1, r2, r3)
    if scene.has_glass:
        # GGX dielectric for KHR_materials_transmission materials —
        # the glass BSDF the reference ships unwired
        # (kernels/src/bsdf.rs:107-176), selected per lane.
        is_glass = attrs[:, W.ATTR_TRANSMISSION] > 0.0
        gs = bsdf_mod.glass_sample(
            mat.albedo, attrs[:, W.ATTR_IOR], mat.roughness, -rd, normal,
            r1, r2, r3,
        )
        bs = bsdf_mod.BSDFSample(
            pdf=jnp.where(is_glass, gs.pdf, bs.pdf),
            lobe=jnp.where(is_glass, gs.lobe, bs.lobe),
            spectrum=jnp.where(is_glass[..., None], gs.spectrum, bs.spectrum),
            direction=jnp.where(is_glass[..., None], gs.direction, bs.direction),
        )
    sampled_diffuse = bs.lobe == bsdf_mod.LOBE_DIFFUSE

    # ---- NEE candidate on diffuse lobes (kernels/src/lib.rs:148-165) -------
    nee_pack = None
    mis_carry = st.mis
    if uses_nee:
        rn = tuple(draws[:, 3 + k] for k in range(4))
        dls, shadow = nee_mod.prepare_direct_lighting(
            scene, nee, mat, throughput, hit_pos, normal, rd, rn
        )
        eligible = shade & sampled_diffuse
        # the carry for next-bounce MIS is recorded regardless of
        # visibility (matches the reference: last_light_sample is
        # whatever sample_direct_lighting produced). Only eligible
        # (diffuse-shaded) lanes record, which is exactly the set whose
        # carry can ever be consumed (mis_mask requires
        # last_lobe_diffuse, set this same bounce).
        carry = nee_mod.make_mis_carry(
            throughput, bs.pdf, bs.spectrum, bs.direction,
            dls.light_area, dls.light_normal, dls.light_pick_pdf,
            dls.light_emission, dls.light_triangle_index,
        )
        mis_carry = _where_tuple(eligible, carry, st.mis)
        nee_pack = NEEPack(
            shadow_ro=shadow[0],
            shadow_rd=shadow[1],
            shadow_maxt=shadow[2],
            contribution=dls.contribution,
            eligible=eligible & shadow[3],
        )

    # ---- throughput & ray update (kernels/src/lib.rs:167-172) --------------
    pdf_safe = jnp.where(jnp.abs(bs.pdf) < 1e-20, 1e-20, bs.pdf)
    new_tp = s.mask_nan(throughput * bs.spectrum / pdf_safe[..., None])
    throughput = jnp.where(shade[..., None], new_tp, throughput)
    rd_new = bs.direction
    ro_new = hit_pos + rd_new * s.EPS
    ro = jnp.where(shade[..., None], ro_new, ro)
    rd = jnp.where(shade[..., None], rd_new, rd)
    alive = shade

    # ---- russian roulette (kernels/src/lib.rs:174-181) ---------------------
    if bounce > cfg.min_bounces:
        # Clamped to 1, unlike the reference: its unclamped
        # `throughput /= prob` loses energy whenever max(throughput) > 1
        # (survival is certain but the weight still shrinks) — a real
        # estimator bug there, inactive at its default 4/3 bounce config.
        prob = jnp.minimum(jnp.max(throughput, axis=-1), 1.0)
        roll = draws[:, 7]
        killed = alive & (roll > prob)
        alive = alive & ~killed
        throughput = jnp.where(
            alive[..., None],
            throughput / jnp.maximum(prob, 1e-20)[..., None],
            throughput,
        )

    # ---- deferred sky payoff (final bounce only) ---------------------------
    # Missed lanes' ro/rd/throughput are frozen at miss time, so one
    # evaluation here serves every bounce's escapees.
    if bounce == cfg.max_bounces - 1:
        radiance = radiance + deferred_sky_term(
            scene, cfg, cam, ro, rd, throughput, missed
        )

    st = TraceState(
        ro=ro,
        rd=rd,
        throughput=throughput,
        radiance=radiance,
        alive=alive,
        missed=missed,
        last_lobe_diffuse=jnp.where(shade, sampled_diffuse, st.last_lobe_diffuse),
        mis=mis_carry,
    )
    return st, nee_pack


# Compact-sky geometry: lanes group into segments of _SKY_SEG; the
# march runs on the _SKY_SEGS_K segments that contain misses (whole-
# segment gather/scatter, so top_k runs over batch/512 elements rather
# than over every lane). Above _SKY_SEGS_K miss-carrying segments the
# full-batch march runs instead (real sky visible — the march is
# genuine work there).
_SKY_SEG = 512
_SKY_SEGS_K = 512


def deferred_sky_term(scene, cfg, cam, ro, rd, throughput, missed):
    """The deferred-sky radiance term, [B, 3].

    Enclosed scenes still produce a few missed lanes per megabatch
    (seam leaks), and a lax.cond on jnp.any(missed) would then run the
    FULL 12-step atmosphere march for a handful of lanes. Instead only
    the segments that contain misses are marched (up to 1/14 of the
    batch), equal to the full march up to float rounding (the march is
    elementwise in the lane)."""
    batch = ro.shape[0]

    def full_march():
        sky = sky_radiance(scene, cfg.has_skybox, cam.sun_direction, ro, rd)
        return jnp.where(missed[:, None], throughput * sky, 0.0)

    n_segs = batch // _SKY_SEG
    if batch < 2 * _SKY_SEG * _SKY_SEGS_K or batch % _SKY_SEG:
        # small batches (CI tiles, probes): the march is cheap; keep
        # the single cond
        return jax.lax.cond(
            jnp.any(missed), full_march, lambda: jnp.zeros_like(ro)
        )
    seg_miss = missed.reshape(n_segs, _SKY_SEG)
    seg_any = jnp.any(seg_miss, axis=1)
    flag, seg_idx = jax.lax.top_k(
        seg_any.astype(jnp.float32), _SKY_SEGS_K
    )

    def compact_march():
        g = lambda a: a.reshape(n_segs, _SKY_SEG, 3)[seg_idx].reshape(-1, 3)
        sky = sky_radiance(scene, cfg.has_skybox, cam.sun_direction,
                           g(ro), g(rd))
        m = seg_miss[seg_idx].reshape(-1) & jnp.repeat(
            flag > 0.0, _SKY_SEG
        )
        contrib = jnp.where(m[:, None], g(throughput) * sky, 0.0)
        out = jnp.zeros((n_segs, _SKY_SEG, 3), ro.dtype)
        out = out.at[seg_idx].set(
            contrib.reshape(_SKY_SEGS_K, _SKY_SEG, 3)
        )
        return out.reshape(batch, 3)

    n_seg_missed = jnp.sum(seg_any.astype(jnp.int32))
    return jax.lax.cond(n_seg_missed > _SKY_SEGS_K, full_march, compact_march)


def bounce_post(st: TraceState, nee_pack: NEEPack, occluded) -> TraceState:
    """Fold the shadow-ray visibility into the NEE contribution."""
    lit = nee_pack.eligible & ~occluded
    radiance = st.radiance + jnp.where(
        lit[..., None], s.mask_nan(nee_pack.contribution), 0.0
    )
    return st._replace(radiance=radiance)


def trace_paths(
    scene,
    cfg: StaticConfig,
    cam: CameraParams,
    px: jnp.ndarray,
    py: jnp.ndarray,
    sample_idx,
    offsets: jnp.ndarray,
    engine: str = "auto",
) -> jnp.ndarray:
    """Trace one sample for a batch of pixels (single fused program);
    returns radiance [B, 3]."""
    st = init_state(cfg, cam, px, py, sample_idx, offsets)
    draws = sample_draws(cfg, sample_idx, offsets)
    for bounce in range(cfg.max_bounces):
        res = intersect_nearest(scene, st.ro, st.rd, engine=engine)
        st, nee_pack = bounce_pre(
            scene, cfg, cam, bounce, st, res,
            draws[:, bounce * 8 : bounce * 8 + 8],
        )
        if nee_pack is not None:
            occluded = intersect_any(
                scene,
                nee_pack.shadow_ro,
                nee_pack.shadow_rd,
                nee_pack.shadow_maxt,
                engine=engine,
            )
            st = bounce_post(st, nee_pack, occluded)
    return st.radiance


def accumulate_samples(
    scene,
    cfg: StaticConfig,
    cam: CameraParams,
    px: jnp.ndarray,
    py: jnp.ndarray,
    offsets: jnp.ndarray,
    sample_start,
    n_samples,
    engine: str = "auto",
    film_in: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Fold n_samples into a film-sum buffer on device — the analog of
    the reference's sync_rate dispatch loop (src/trace.rs:177-195) with
    accumulation kept device-side.

    n_samples may be a traced value: the loop bound is dynamic, so one
    compiled program serves every sample count."""
    batch = px.shape[0]
    film0 = film_in if film_in is not None else jnp.zeros((batch, 3), jnp.float32)

    def body(i, film):
        rad = trace_paths(
            scene,
            cfg,
            cam,
            px,
            py,
            sample_start + i.astype(jnp.uint32),
            offsets,
            engine=engine,
        )
        return film + rad

    return jax.lax.fori_loop(0, n_samples, body, film0)
