"""World assembly: GLB -> (BVH, light table, atlas, SoA device arrays).

The analog of the reference's `World::from_path` / `World::into_gpu`
pipeline (reference: src/asset.rs:55-235): load the scene, pack
textures, build the BVH (reordering the triangle buffer), build the
light-pick table from the *reordered* triangles, and upload flat arrays
to the device once. Scene data is read-only and replicated across chips.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

import jax
import jax.numpy as jnp

from rustic.scene import atlas as atlas_mod
from rustic.scene import bvh as bvh_mod
from rustic.scene import light_table as lt_mod
from rustic.scene.gltf import GltfScene, load_glb

ATLAS_SIZE = 4096  # reference: src/asset.rs:177

# Packed per-triangle shading-row layout (tri_attrs[:, i]):
ATTR_POS = slice(0, 9)  # vertex positions a,b,c
ATTR_NRM = slice(9, 18)  # vertex normals a,b,c
ATTR_TAN = slice(18, 27)  # vertex tangents a,b,c
ATTR_UV = slice(27, 33)  # vertex uv0 a,b,c
ATTR_EMISSIVE = slice(33, 36)
ATTR_ALBEDO = slice(36, 40)  # color or atlas uvst
ATTR_ROUGH = slice(40, 44)
ATTR_METAL = slice(44, 48)
ATTR_NORMTEX = slice(48, 52)
ATTR_HASTEX = slice(52, 56)  # albedo, metallic, roughness, normal flags
ATTR_TRANSMISSION = 56  # KHR_materials_transmission factor
ATTR_IOR = 57  # KHR_materials_ior
ATTR_WIDTH = 64

# Combined NEE entry rows (entry_rows[:, i]): everything one alias entry
# can resolve to, in a single row — one fetch per NEE sample covers the
# whole light-pick + light-geometry lookup.
ENTRY_AREA_A, ENTRY_PDF_A = 0, 1
ENTRY_AREA_B, ENTRY_PDF_B = 2, 3
ENTRY_RATIO = 4
ENTRY_A_VERTS = slice(8, 17)
ENTRY_A_NORMAL = slice(17, 20)
ENTRY_A_EMISSION = slice(20, 23)
ENTRY_A_TRI = 23
ENTRY_B_VERTS = slice(24, 33)
ENTRY_B_NORMAL = slice(33, 36)
ENTRY_B_EMISSION = slice(36, 39)
ENTRY_B_TRI = 39
ENTRY_WIDTH = 48


@dataclasses.dataclass(frozen=True)
class SceneArrays:
    """Device-resident scene: everything the integrator needs, SoA.

    The capability twin of the reference's GpuWorld (src/asset.rs:18-25)
    plus the precomputed brute-force triangle features. A pytree: the
    array fields are its leaves, the fields in STATIC_FIELDS ride as aux
    data (they pick the compiled program).
    """

    # geometry (per vertex)
    positions: jnp.ndarray  # [V, 3] f32
    normals: jnp.ndarray  # [V, 3] f32
    tangents: jnp.ndarray  # [V, 3] f32
    uv0: jnp.ndarray  # [V, 2] f32
    # triangles
    tri_vidx: jnp.ndarray  # [T, 3] i32 vertex indices
    tri_mat: jnp.ndarray  # [T] i32 material index
    # brute-force / scan intersection features: see ops/intersect.py
    tri_feats: jnp.ndarray  # [10, T, 4] f32
    # Packed per-triangle shading rows: everything the shader needs
    # about a hit triangle in one row (see ATTR_* layout constants).
    tri_attrs: jnp.ndarray  # [T, 64] f32
    # Combined NEE entry rows (ENTRY_* constants): one row per alias
    # entry resolves the light pick AND the picked light's geometry.
    entry_rows: jnp.ndarray  # [L_pad, 48] f32
    # BVH (SoA; leaf iff count > 0)
    bvh_min: jnp.ndarray  # [N, 3] f32
    bvh_max: jnp.ndarray  # [N, 3] f32
    bvh_left_first: jnp.ndarray  # [N] i32
    bvh_count: jnp.ndarray  # [N] i32
    # materials (each row is a color OR an atlas uvst rect;
    # has_texture flags say which — reference shared_structs/src/lib.rs:44-90)
    mat_emissive: jnp.ndarray  # [M, 3] f32
    mat_albedo: jnp.ndarray  # [M, 4] f32
    mat_roughness: jnp.ndarray  # [M, 4] f32
    mat_metallic: jnp.ndarray  # [M, 4] f32
    mat_normals: jnp.ndarray  # [M, 4] f32
    mat_has_tex: jnp.ndarray  # [M, 4] i32 (albedo, metallic, roughness, normal)
    # light-pick alias table (SoA LightPickEntry,
    # reference shared_structs/src/lib.rs:102-119)
    light_idx_a: jnp.ndarray  # [L] i32
    light_area_a: jnp.ndarray  # [L] f32
    light_pdf_a: jnp.ndarray  # [L] f32
    light_idx_b: jnp.ndarray  # [L] i32
    light_area_b: jnp.ndarray  # [L] f32
    light_pdf_b: jnp.ndarray  # [L] f32
    light_ratio: jnp.ndarray  # [L] f32 (<0 => sentinel)
    # images
    atlas: jnp.ndarray  # [Ha, Wa, 9] f32 co-located material maps (scene/atlas.py CH_*)
    skybox: jnp.ndarray  # [Hs, Ws, 4] f32

    # static metadata
    n_tris: int = 0
    n_nodes: int = 0
    n_alias_entries: int = 0
    has_lights: bool = False
    has_textures: bool = False
    has_glass: bool = False

    STATIC_FIELDS = (
        "n_tris", "n_nodes", "n_alias_entries",
        "has_lights", "has_textures", "has_glass",
    )


def _scene_flatten(scene: SceneArrays):
    names = [
        f.name for f in dataclasses.fields(scene)
        if f.name not in SceneArrays.STATIC_FIELDS
    ]
    children = tuple(getattr(scene, n) for n in names)
    aux = (
        tuple(names),
        tuple(getattr(scene, n) for n in SceneArrays.STATIC_FIELDS),
    )
    return children, aux


def _scene_unflatten(aux, children) -> SceneArrays:
    names, static = aux
    return SceneArrays(
        **dict(zip(names, children)),
        **dict(zip(SceneArrays.STATIC_FIELDS, static)),
    )


jax.tree_util.register_pytree_node(SceneArrays, _scene_flatten, _scene_unflatten)


def _triangle_features(
    verts: np.ndarray, tri_vidx: np.ndarray
) -> np.ndarray:
    """Per-triangle feature tensor G[10, T, 4] for brute-force intersection.

    The Möller–Trumbore scalars for every (ray, triangle) pair factor as
    one matmul F @ G with ray features F = [rd, ro×rd, ro, 1] (10) and
    per-triangle columns (det, u_num, v_num, t_num):

        det   = -rd·n                  (n = e1×e2)
        u_num =  (ro×rd)·e2 + rd·(a×e2)
        v_num = -(ro×rd)·e1 + rd·(e1×a)
        t_num =  ro·n - a·n

    with u = u_num/det, v = v_num/det, t = t_num/det — algebraically the
    same Möller–Trumbore the reference evaluates per pixel
    (reference: kernels/src/intersection.rs:9-54), restructured so the
    pair-wise work is a single [B,10]x[10,4T] contraction.
    """
    a = verts[tri_vidx[:, 0]].astype(np.float64)
    b = verts[tri_vidx[:, 1]].astype(np.float64)
    c = verts[tri_vidx[:, 2]].astype(np.float64)
    e1 = b - a
    e2 = c - a
    n = np.cross(e1, e2)
    d0 = np.sum(a * n, axis=-1)

    t_count = len(tri_vidx)
    g = np.zeros((10, t_count, 4), np.float32)
    g[0:3, :, 0] = -n.T
    g[0:3, :, 1] = np.cross(a, e2).T
    g[3:6, :, 1] = e2.T
    g[0:3, :, 2] = np.cross(e1, a).T
    g[3:6, :, 2] = -e1.T
    g[6:9, :, 3] = n.T
    g[9, :, 3] = -d0
    return g


def _fallback_skybox() -> np.ndarray:
    """2x2 magenta fallback (reference: src/asset.rs:275-289)."""
    px = np.array([1.0, 0.0, 1.0, 1.0], np.float32)
    return np.tile(px, (2, 2, 1))


def load_skybox_image(path: str) -> np.ndarray:
    """Load an equirect skybox (HDR or LDR) to float32 [H, W, 4]
    (reference: src/asset.rs:238-255)."""
    if path.lower().endswith(".npy"):
        img = np.asarray(np.load(path), np.float32)
        if img.shape[-1] == 3:
            img = np.concatenate([img, np.ones_like(img[..., :1])], axis=-1)
        return img
    if path.lower().endswith(".hdr"):
        # Dedicated RGBE decoder: the available Python image stacks
        # either reject .hdr or silently tonemap it to uint8, losing the
        # radiance scale (reference decodes it natively via the image
        # crate, src/asset.rs:238-255).
        from rustic.utils.hdr import read_hdr

        img = read_hdr(path)
        return np.concatenate([img, np.ones_like(img[..., :1])], axis=-1)
    if path.lower().endswith(".exr"):
        import imageio.v3 as iio

        img = np.asarray(iio.imread(path), np.float32)
        if img.ndim == 2:
            img = img[..., None].repeat(3, axis=-1)
        if img.shape[-1] == 3:
            img = np.concatenate(
                [img, np.ones_like(img[..., :1])], axis=-1
            )
        return img
    from rustic.utils.png import read_image_rgba

    with open(path, "rb") as f:
        return read_image_rgba(f.read())


class World:
    """Host-side scene bundle (NumPy) with `.to_device()` upload."""

    def __init__(self, gltf: GltfScene, atlas_size: int = ATLAS_SIZE):
        self.positions = gltf.positions
        self.normals = gltf.normals
        self.tangents = gltf.tangents
        self.uv0 = gltf.uv0
        triangles = gltf.triangles.copy()

        # ---- texture atlas --------------------------------------------------
        n_mats = len(gltf.materials)
        mat_transmission = np.zeros((n_mats, 2), np.float32)
        mat_emissive = np.zeros((n_mats, 3), np.float32)
        mat_albedo = np.zeros((n_mats, 4), np.float32)
        mat_roughness = np.zeros((n_mats, 4), np.float32)
        mat_metallic = np.zeros((n_mats, 4), np.float32)
        mat_normals = np.zeros((n_mats, 4), np.float32)
        mat_has_tex = np.zeros((n_mats, 4), np.int32)

        mat_maps: List[dict] = []
        for mi, m in enumerate(gltf.materials):
            mat_albedo[mi] = m.base_color
            mat_roughness[mi] = m.roughness
            mat_metallic[mi] = m.metallic
            mat_emissive[mi] = m.emissive
            mat_transmission[mi] = (m.transmission, m.ior)
            mat_maps.append({
                "albedo": m.albedo_texture,
                "metallic": m.metallic_texture,
                "roughness": m.roughness_texture,
                "normal": m.normal_texture,
            })

        if any(v is not None for maps in mat_maps for v in maps.values()):
            # Co-located 9-channel material atlas: every map of a
            # material shares ONE rect, so a single bilinear footprint
            # (4 row gathers) serves albedo+metal+rough+normal instead
            # of 4 gathers per map. The reference packs per-texture
            # rects into an RGBA8 atlas (src/atlas.rs:26-90); capability
            # is identical, the layout differs.
            atlas_img, mat_uvst = atlas_mod.pack_material_textures(
                mat_maps, atlas_size, atlas_size
            )
        else:
            atlas_img = np.zeros((4, 4, atlas_mod.ATLAS_CHANNELS), np.float32)
            mat_uvst = [None] * n_mats

        # Substitute the material's (shared) uvst rect into each
        # textured field slot (reference: src/asset.rs:179-192 — there
        # per-texture rects; here one rect per material)
        field_col = {"albedo": 0, "metallic": 1, "roughness": 2, "normal": 3}
        for mi, (maps, uvst) in enumerate(zip(mat_maps, mat_uvst)):
            for field, tex in maps.items():
                if tex is None:
                    continue
                mat_has_tex[mi, field_col[field]] = 1
                if field == "albedo":
                    mat_albedo[mi] = uvst
                elif field == "metallic":
                    mat_metallic[mi] = uvst
                elif field == "roughness":
                    mat_roughness[mi] = uvst
                else:
                    mat_normals[mi] = uvst

        # ---- BVH (reorders triangles) --------------------------------------
        self.bvh, perm = bvh_mod.build_bvh(self.positions, triangles)
        triangles = triangles[perm]
        self.triangles = triangles

        # ---- light table (on reordered triangles, like the reference:
        # src/asset.rs:194-203 builds BVH first, then the light table) -------
        mask = lt_mod.compute_emissive_mask(triangles, mat_emissive)
        self.light_table = lt_mod.build_light_table(
            self.positions, triangles, mask, mat_emissive
        )

        self.mat_emissive = mat_emissive
        self.mat_transmission = mat_transmission
        self.mat_albedo = mat_albedo
        self.mat_roughness = mat_roughness
        self.mat_metallic = mat_metallic
        self.mat_normals = mat_normals
        self.mat_has_tex = mat_has_tex
        self.atlas = atlas_img

        self.tri_feats = _triangle_features(self.positions, triangles[:, :3])
        self._pack_shading_rows()

    def _pack_shading_rows(self):
        """Build the gather-free shading tables (see ATTR_*/LIGHT_*/ALIAS_*)."""
        tris = self.triangles
        t_count = len(tris)
        vi = tris[:, :3]
        mi = tris[:, 3]

        attrs = np.zeros((t_count, ATTR_WIDTH), np.float32)
        attrs[:t_count, ATTR_POS] = self.positions[vi].reshape(t_count, 9)
        attrs[:t_count, ATTR_NRM] = self.normals[vi].reshape(t_count, 9)
        attrs[:t_count, ATTR_TAN] = self.tangents[vi].reshape(t_count, 9)
        attrs[:t_count, ATTR_UV] = self.uv0[vi].reshape(t_count, 6)
        attrs[:t_count, ATTR_EMISSIVE] = self.mat_emissive[mi]
        attrs[:t_count, ATTR_ALBEDO] = self.mat_albedo[mi]
        attrs[:t_count, ATTR_ROUGH] = self.mat_roughness[mi]
        attrs[:t_count, ATTR_METAL] = self.mat_metallic[mi]
        attrs[:t_count, ATTR_NORMTEX] = self.mat_normals[mi]
        attrs[:t_count, ATTR_HASTEX] = self.mat_has_tex[mi]
        attrs[:t_count, ATTR_TRANSMISSION] = self.mat_transmission[mi, 0]
        attrs[:t_count, ATTR_IOR] = self.mat_transmission[mi, 1]
        self.tri_attrs = attrs

        lt = self.light_table

        # Combined entry rows: alias scalars + both candidate triangles'
        # geometry, so one row fetch resolves an entire NEE light sample.
        la_pad = max(8, int(-(-len(lt) // 8) * 8))
        entries = np.zeros((la_pad, ENTRY_WIDTH), np.float32)
        n_e = len(lt)
        entries[:n_e, ENTRY_AREA_A] = lt.area_a
        entries[:n_e, ENTRY_PDF_A] = lt.pdf_a
        entries[:n_e, ENTRY_AREA_B] = lt.area_b
        entries[:n_e, ENTRY_PDF_B] = lt.pdf_b
        entries[:n_e, ENTRY_RATIO] = lt.ratio
        if not lt.is_sentinel:
            for side, idx_g in (("A", lt.idx_a), ("B", lt.idx_b)):
                gi = idx_g.astype(np.int64)
                svi = vi[gi]
                verts = self.positions[svi].reshape(n_e, 9)
                # UNNORMALIZED mean of vertex normals — deliberate parity
                # with the reference's light normal (kernels/src/
                # light_pick.rs:129, "(na+nb+nc)/3, lights can use flat
                # shading"); |n| < 1 on curved emitters skews the
                # area->solid-angle pdf exactly as it does there.
                nrm = self.normals[svi].mean(axis=1)
                emis = self.mat_emissive[mi[gi]]
                if side == "A":
                    entries[:n_e, ENTRY_A_VERTS] = verts
                    entries[:n_e, ENTRY_A_NORMAL] = nrm
                    entries[:n_e, ENTRY_A_EMISSION] = emis
                    entries[:n_e, ENTRY_A_TRI] = gi
                else:
                    entries[:n_e, ENTRY_B_VERTS] = verts
                    entries[:n_e, ENTRY_B_NORMAL] = nrm
                    entries[:n_e, ENTRY_B_EMISSION] = emis
                    entries[:n_e, ENTRY_B_TRI] = gi
        self.entry_rows = entries
        self.n_alias_entries = len(lt)

    @classmethod
    def from_path(cls, path: str) -> "World":
        """Load any supported scene format (.glb/.gltf/.obj — the
        reference gets its multi-format surface from assimp,
        reference: README.md:13)."""
        low = path.lower()
        if low.endswith(".obj"):
            from rustic.scene.obj import load_obj

            return cls(load_obj(path))
        if low.endswith(".stl"):
            from rustic.scene.mesh_formats import load_stl

            return cls(load_stl(path))
        if low.endswith(".ply"):
            from rustic.scene.mesh_formats import load_ply

            return cls(load_ply(path))
        if low.endswith(".fbx"):
            from rustic.scene.fbx import load_fbx

            return cls(load_fbx(path))
        return cls(load_glb(path))

    def to_device(self, skybox: Optional[np.ndarray] = None) -> SceneArrays:
        lt = self.light_table
        return SceneArrays(
            positions=jnp.asarray(self.positions),
            normals=jnp.asarray(self.normals),
            tangents=jnp.asarray(self.tangents),
            uv0=jnp.asarray(self.uv0),
            tri_vidx=jnp.asarray(self.triangles[:, :3], jnp.int32),
            tri_mat=jnp.asarray(self.triangles[:, 3], jnp.int32),
            tri_feats=jnp.asarray(self.tri_feats),
            tri_attrs=jnp.asarray(self.tri_attrs),
            bvh_min=jnp.asarray(self.bvh.aabb_min),
            bvh_max=jnp.asarray(self.bvh.aabb_max),
            bvh_left_first=jnp.asarray(self.bvh.left_first),
            bvh_count=jnp.asarray(self.bvh.count),
            mat_emissive=jnp.asarray(self.mat_emissive),
            mat_albedo=jnp.asarray(self.mat_albedo),
            mat_roughness=jnp.asarray(self.mat_roughness),
            mat_metallic=jnp.asarray(self.mat_metallic),
            mat_normals=jnp.asarray(self.mat_normals),
            mat_has_tex=jnp.asarray(self.mat_has_tex),
            entry_rows=jnp.asarray(self.entry_rows),
            n_alias_entries=self.n_alias_entries,
            light_idx_a=jnp.asarray(lt.idx_a),
            light_area_a=jnp.asarray(lt.area_a),
            light_pdf_a=jnp.asarray(lt.pdf_a),
            light_idx_b=jnp.asarray(lt.idx_b),
            light_area_b=jnp.asarray(lt.area_b),
            light_pdf_b=jnp.asarray(lt.pdf_b),
            light_ratio=jnp.asarray(lt.ratio),
            atlas=jnp.asarray(self.atlas),
            skybox=jnp.asarray(
                skybox if skybox is not None else _fallback_skybox()
            ),
            n_tris=len(self.triangles),
            n_nodes=self.bvh.n_nodes,
            has_lights=not lt.is_sentinel,
            has_textures=bool(self.mat_has_tex.any()),
            has_glass=bool((self.mat_transmission[:, 0] > 0.0).any()),
        )


def load_scene(
    scene_path: str, skybox_path: Optional[str] = None
) -> SceneArrays:
    """Convenience: GLB path (+ optional skybox image path) -> device arrays."""
    world = World.from_path(scene_path)
    skybox = load_skybox_image(skybox_path) if skybox_path else None
    return world.to_device(skybox)
