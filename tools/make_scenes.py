"""Generate coverage scenes the reference strips from its public mirror.

The reference's benchmark/correctness suite references GlassTest.glb and
BreakTime.glb, both removed by .MISSING_LARGE_BLOBS; this regenerates
equivalent-coverage scenes with rustic's own GLB writer:

- GlassTest.glb — BASELINE config #3 (dielectric refraction, long
  specular chains): two glass spheres (smooth ior 1.5 and rough ior
  1.45) and a metal sphere on a diffuse floor, lit by an emissive panel
  and the procedural sky.
- BreakTime.glb — BASELINE config #5 (full-pipeline throughput: PBR
  maps + normal mapping + HDR skybox): a break room with a tiled floor
  (checker albedo + grout normal map), a wood-textured table
  (stripe albedo + ring normal map), a metal sphere with a roughness
  map, a textured diffuse sphere, an emissive ceiling panel, and a
  window opening for the skybox. Pair with BreakTimeSky.npy
  (equirect linear radiance, --skybox flag).

Run: python tools/make_scenes.py [outdir]
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rustic.scene.glb_write import (  # noqa: E402
    MaterialSpec,
    MeshSpec,
    icosphere,
    quad,
    write_glb,
)


def make_glass_test(path: str):
    materials = [
        MaterialSpec(
            base_color=(0.75, 0.75, 0.75, 1.0), roughness=0.9, name="floor"
        ),
        MaterialSpec(
            base_color=(1.0, 1.0, 1.0, 1.0),
            roughness=0.02,
            transmission=1.0,
            ior=1.5,
            name="glass_smooth",
        ),
        MaterialSpec(
            base_color=(0.9, 0.95, 1.0, 1.0),
            roughness=0.25,
            transmission=1.0,
            ior=1.45,
            name="glass_rough",
        ),
        MaterialSpec(
            base_color=(0.95, 0.64, 0.54, 1.0),
            metallic=1.0,
            roughness=0.15,
            name="copper",
        ),
        MaterialSpec(
            base_color=(0.0, 0.0, 0.0, 1.0),
            emissive=(1.0, 0.95, 0.85),  # loader multiplies by 15
            name="panel_light",
        ),
    ]

    # Authored glTF *z-up*: the loader's Y/Z swizzle (src/asset.rs:102
    # semantics) turns gltf (x, y, z) into renderer (x, z, y), so gltf
    # +z becomes the renderer's +y (the default camera's screen-up).
    meshes = []
    p, i, n = quad((-8.0, -8.0, 0.0), (16.0, 0.0, 0.0), (0.0, 16.0, 0.0))
    meshes.append(MeshSpec(p, i, 0, normals=n, name="floor"))

    # spheres resting on the floor (renderer: x lateral, z depth)
    p, i, n = icosphere(3, 1.0, (-2.2, 0.0, 1.0))
    meshes.append(MeshSpec(p, i, 1, normals=n, name="glass_smooth"))
    p, i, n = icosphere(3, 1.0, (0.0, 1.8, 1.0))
    meshes.append(MeshSpec(p, i, 2, normals=n, name="glass_rough"))
    p, i, n = icosphere(3, 1.0, (2.2, 0.0, 1.0))
    meshes.append(MeshSpec(p, i, 3, normals=n, name="copper"))

    # emissive panel overhead, front face down toward the spheres
    p, i, n = quad((-1.5, -1.5, 5.0), (0.0, 3.0, 0.0), (3.0, 0.0, 0.0))
    meshes.append(MeshSpec(p, i, 4, normals=n, name="panel"))

    write_glb(path, meshes, materials)
    print(f"wrote {path}")


# -- BreakTime: textured break-room scene (BASELINE config #5) --------------


def _height_to_normal(h: np.ndarray, strength: float = 2.0) -> np.ndarray:
    """Height field [H, W] in [0,1] -> tangent-space normal map [H, W, 3]
    encoded in [0,1] (the loader decodes with *2-1, ops/trace.py)."""
    dx = np.roll(h, -1, axis=1) - np.roll(h, 1, axis=1)
    dy = np.roll(h, -1, axis=0) - np.roll(h, 1, axis=0)
    n = np.stack([-dx * strength, -dy * strength, np.ones_like(h)], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return (n * 0.5 + 0.5).astype(np.float32)


def _checker_tiles(res: int = 256, tiles: int = 8):
    """Checker albedo + grout-line height for the floor."""
    y, x = np.mgrid[0:res, 0:res] / res
    cx = np.floor(x * tiles).astype(int)
    cy = np.floor(y * tiles).astype(int)
    check = ((cx + cy) % 2).astype(np.float32)
    albedo = np.stack(
        [0.75 - 0.45 * check, 0.72 - 0.38 * check, 0.68 - 0.33 * check],
        axis=-1,
    )
    fx = x * tiles - np.floor(x * tiles)
    fy = y * tiles - np.floor(y * tiles)
    grout = (np.minimum.reduce([fx, 1 - fx, fy, 1 - fy]) < 0.03).astype(
        np.float32
    )
    albedo *= 1.0 - 0.5 * grout[..., None]
    height = 1.0 - grout
    return albedo.astype(np.float32), height


def _wood(res: int = 256):
    """Stripe-ring wood albedo + height."""
    y, x = np.mgrid[0:res, 0:res] / res
    rings = np.sin((x * 14.0 + 0.35 * np.sin(y * 9.0)) * np.pi)
    shade = 0.5 + 0.5 * rings
    albedo = np.stack(
        [0.45 + 0.25 * shade, 0.27 + 0.14 * shade, 0.12 + 0.06 * shade],
        axis=-1,
    )
    return albedo.astype(np.float32), (0.5 + 0.5 * rings).astype(np.float32)


def _metal_roughness_map(res: int = 256):
    """metallicRoughness texture: B = metallic, G = roughness (gltf.py
    splits those channels). Brushed look: roughness varies in bands."""
    y, x = np.mgrid[0:res, 0:res] / res
    rough = 0.08 + 0.3 * (0.5 + 0.5 * np.sin(x * 40.0 * np.pi)) * y
    img = np.zeros((res, res, 3), np.float32)
    img[..., 1] = rough  # G: roughness
    img[..., 2] = 1.0  # B: metallic
    return img


def _poster(res: int = 256):
    """Colorful diffuse texture for the sphere on the table."""
    y, x = np.mgrid[0:res, 0:res] / res
    r = 0.5 + 0.5 * np.sin(x * 6 * np.pi)
    g = 0.5 + 0.5 * np.sin((x + y) * 4 * np.pi)
    b = 0.5 + 0.5 * np.cos(y * 8 * np.pi)
    return np.stack([r, g, b], axis=-1).astype(np.float32)


def box(center, half, material, name, uv_scale=1.0):
    """Axis-aligned box as 6 quads with per-face planar UVs."""
    cx, cy, cz = center
    hx, hy, hz = half
    faces = [
        ((cx - hx, cy - hy, cz + hz), (2 * hx, 0, 0), (0, 2 * hy, 0)),  # +z
        ((cx + hx, cy - hy, cz - hz), (-2 * hx, 0, 0), (0, 2 * hy, 0)),  # -z
        ((cx - hx, cy - hy, cz - hz), (0, 0, 2 * hz), (0, 2 * hy, 0)),  # -x
        ((cx + hx, cy - hy, cz + hz), (0, 0, -2 * hz), (0, 2 * hy, 0)),  # +x
        ((cx - hx, cy + hy, cz - hz), (2 * hx, 0, 0), (0, 0, 2 * hz)),  # +y
        ((cx - hx, cy - hy, cz + hz), (2 * hx, 0, 0), (0, 0, -2 * hz)),  # -y
    ]
    out = []
    for k, (corner, eu, ev) in enumerate(faces):
        p, i, n = quad(corner, eu, ev)
        uv = np.array(
            [[0, 0], [uv_scale, 0], [uv_scale, uv_scale], [0, uv_scale]],
            np.float32,
        )
        out.append(MeshSpec(p, i, material, normals=n, uv0=uv,
                            name=f"{name}_f{k}"))
    return out


def sphere_uv(pos: np.ndarray, center) -> np.ndarray:
    d = pos - np.asarray(center, np.float32)
    d /= np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
    u = 0.5 + np.arctan2(d[:, 1], d[:, 0]) / (2 * np.pi)
    v = 0.5 - np.arcsin(np.clip(d[:, 2], -1, 1)) / np.pi
    return np.stack([u, v], axis=-1).astype(np.float32)


def make_break_time(path: str, sky_path: str):
    # textures (indices)
    floor_alb, floor_h = _checker_tiles()
    wood_alb, wood_h = _wood()
    textures = [
        floor_alb,                        # 0 floor albedo
        _height_to_normal(floor_h, 3.0),  # 1 floor normal
        wood_alb,                         # 2 wood albedo
        _height_to_normal(wood_h, 1.5),   # 3 wood normal
        _metal_roughness_map(),           # 4 brushed metal MR
        _poster(),                        # 5 diffuse sphere albedo
    ]
    materials = [
        MaterialSpec(roughness=0.6, base_color_texture=0, normal_texture=1,
                     name="floor_tiles"),
        MaterialSpec(base_color=(0.85, 0.83, 0.78, 1.0), roughness=0.9,
                     name="wall_paint"),
        MaterialSpec(roughness=0.35, base_color_texture=2, normal_texture=3,
                     name="wood"),
        MaterialSpec(base_color=(0.95, 0.95, 0.95, 1.0), metallic=1.0,
                     metallic_roughness_texture=4, name="brushed_metal"),
        MaterialSpec(base_color_texture=5, roughness=0.8, name="poster"),
        MaterialSpec(base_color=(0.0, 0.0, 0.0, 1.0),
                     emissive=(1.0, 0.97, 0.9), name="panel_light"),
    ]

    meshes = []
    uvq = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)

    def add_quad(corner, eu, ev, mat, name, uv_scale=1.0):
        p, i, n = quad(corner, eu, ev)
        meshes.append(
            MeshSpec(p, i, mat, normals=n, uv0=uvq * uv_scale, name=name)
        )

    # Authored z-up (the loader swizzles to the renderer's y-up, see
    # make_glass_test). Room 10 x 8 x 4 (x lateral, y depth, z height).
    add_quad((-5, -4, 0), (10, 0, 0), (0, 8, 0), 0, "floor", uv_scale=4.0)
    add_quad((-5, -4, 4), (0, 8, 0), (10, 0, 0), 1, "ceiling")
    add_quad((-5, 4, 0), (10, 0, 0), (0, 0, 4), 1, "wall_back")
    add_quad((-5, -4, 0), (0, 0, 4), (0, 8, 0), 1, "wall_left")
    # right wall with a window opening (2 < y < 0... frame quads)
    add_quad((5, -4, 0), (0, 8, 0), (0, 0, 1.0), 1, "wall_right_sill")
    add_quad((5, -4, 3.0), (0, 8, 0), (0, 0, 1.0), 1, "wall_right_top")
    add_quad((5, -4, 1.0), (0, 2.5, 0), (0, 0, 2.0), 1, "wall_right_a")
    add_quad((5, 1.5, 1.0), (0, 2.5, 0), (0, 0, 2.0), 1, "wall_right_b")
    # front wall behind the camera
    add_quad((-5, -4, 0), (10, 0, 0), (0, 0, 4), 1, "wall_front")

    # table: top + 4 legs (wood)
    meshes += box((0, 0.5, 1.0), (1.6, 0.9, 0.06), 2, "table_top",
                  uv_scale=1.0)
    for lx, ly in ((-1.45, -0.75), (1.45, -0.75), (-1.45, 0.75), (1.45, 0.75)):
        meshes += box((lx, 0.5 + ly, 0.47), (0.08, 0.08, 0.47), 2,
                      f"leg_{lx}_{ly}")

    # objects on the table
    c = (-0.7, 0.3, 1.56)
    p, i, n = icosphere(4, 0.5, c)
    meshes.append(MeshSpec(p, i, 3, normals=n, uv0=sphere_uv(p, c),
                           name="metal_sphere"))
    c = (0.8, 0.7, 1.46)
    p, i, n = icosphere(4, 0.4, c)
    meshes.append(MeshSpec(p, i, 4, normals=n, uv0=sphere_uv(p, c),
                           name="poster_sphere"))

    # emissive ceiling panel (front face down)
    add_quad((-1.0, -0.5, 3.98), (0, 2.0, 0), (2.0, 0, 0), 5, "panel")

    write_glb(path, meshes, materials, textures=textures)
    print(f"wrote {path}")

    # equirect HDR sky: gradient + sun disc, linear radiance (.npy — the
    # zero-egress image stack lacks an HDR encoder; load_skybox_image
    # reads .npy directly).
    h, w = 256, 512
    v, u = np.mgrid[0:h, 0:w]
    theta = (v + 0.5) / h * np.pi  # 0 = zenith
    phi = (u + 0.5) / w * 2 * np.pi
    elev = np.pi / 2 - theta
    horizon = np.exp(-np.abs(elev) * 3.0)
    sky = np.stack(
        [
            0.35 + 0.5 * horizon,
            0.55 + 0.35 * horizon,
            1.0 - 0.25 * horizon,
        ],
        axis=-1,
    ) * (0.7 + 0.3 * np.clip(np.sin(elev), 0, 1))[..., None]
    sun_dir = np.array([np.cos(0.35) * np.cos(1.1), np.cos(0.35) * np.sin(1.1),
                        np.sin(0.35)])
    view = np.stack(
        [np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi),
         np.cos(theta)], axis=-1,
    )
    cos_sun = view @ sun_dir
    sky += np.where(cos_sun > 0.9995, 120.0, 0.0)[..., None] * np.array(
        [1.0, 0.95, 0.85]
    )
    np.save(sky_path, sky.astype(np.float32))
    print(f"wrote {sky_path}")


if __name__ == "__main__":
    outdir = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "assets",
        "scenes",
    )
    make_glass_test(os.path.join(outdir, "GlassTest.glb"))
