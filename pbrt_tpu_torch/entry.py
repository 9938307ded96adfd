"""The port's scenes and camera (counterpart of
``__graft_entry__.py:13-63``), built with the port's SceneBuilder only.

- ``_portal_scene``: the 26-triangle cornell box whose ceiling has a
  0.3×0.3 opening (the portal), lit by a portal area light on an aaplane
  above it. With the default ``strategy="projection"`` it is the main
  path's scene (fused mode 1, flat sweep); with ``"portal"`` or
  ``"light"`` it falls outside the fused profile and renders through the
  generic wavefront loop.
- ``_plain_cornell``: the classic cornell box with a plain one-sided
  area light (fused mode 0, two-sample MIS).
- ``_tessellated_portal``: the portal scene plus a lat-long tessellated
  sphere (fused mode 1 with cluster culling once past 64 triangles).
- ``_sphere_cornell``: the plain cornell box plus two matte spheres (one
  Oren–Nayar) and a point light beside the area light: the generic
  loop's scene with all three shape families, a delta light and light
  selection over two lights.
- ``_heightfield_cornell``: the cornell walls around a 256×256 heightfield
  floor (130,050 triangles), a tessellated cone standing on it and a
  sphere above it, under a plain area light: 133,130 triangles, so the
  scene gets a BVH and renders through the BVH traversal kernel, with the
  sphere and the light's aaplane through the brute-force kernel.
- ``_triangle_soup``: about 100,000 triangles of irregular size thrown
  into the unit box under the same area light: the kernel-experiment
  harness's second tree (tools/kexp_prep.py), a less regular mesh than the
  heightfield.

The makers build on the card unless the caller asks for ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np

from pbrt_tpu_torch.core import transform
from pbrt_tpu_torch.scene import camera as cam_mod
from pbrt_tpu_torch.scene import tessellate
from pbrt_tpu_torch.scene.types import SceneBuilder, require_device

_WHITE = (0.73, 0.73, 0.73)
_RED = (0.63, 0.065, 0.05)
_GREEN = (0.14, 0.45, 0.091)
_WALLS = [
    [(0, 0, 0), (1, 0, 0), (1, 0, 1), (0, 0, 1)],   # floor
    [(0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)],   # back
    [(0, 0, 0), (0, 0, 1), (0, 1, 1), (0, 1, 0)],   # left
    [(1, 0, 0), (1, 1, 0), (1, 1, 1), (1, 0, 1)],   # right
]
_QUAD = [(0, 1, 2), (0, 2, 3)]


def _box_with_opening(b):
    """Materials, walls and the ceiling's four slabs around the
    [0.35,0.65]² opening. Returns (white, black) material rows."""
    white = b.add_material(type=0, kd=_WHITE)
    red = b.add_material(type=0, kd=_RED)
    green = b.add_material(type=0, kd=_GREEN)
    black = b.add_material(type=0, kd=0.0)
    for verts, m in zip(_WALLS, (white, white, red, green)):
        b.add_mesh(verts, _QUAD, mat=m)
    for lo, hi in [((0.0, 0.0), (0.35, 1.0)), ((0.65, 0.0), (1.0, 1.0)),
                   ((0.35, 0.0), (0.65, 0.35)), ((0.35, 0.65), (0.65, 1.0))]:
        b.add_mesh([(lo[0], 1.0, lo[1]), (hi[0], 1.0, lo[1]),
                    (hi[0], 1.0, hi[1]), (lo[0], 1.0, hi[1])], _QUAD,
                   mat=white)
    return white, black


def _portal_light(b, black, strategy="projection"):
    """Area light behind the ceiling portal: emitter plane above the
    opening, portal = the opening itself."""
    li = b.add_light(type="area", L=(18.4, 15.6, 8.0), prim=-1,
                     strategy=strategy, two_sided=False,
                     portals=[((0.35, 1.0, 0.35), (0.65, 1.0, 0.65), 1,
                               False)])
    pid = b.add_aaplane((0.3, 1.2, 0.3), (0.7, 1.2, 0.7), axis=1,
                        facing_fw=False, mat=black, light=li)
    b.light_rows[li]["prim"] = b.prim_index("pln", pid)


def _fill_portal_scene(b, strategy="projection"):
    """Add the portal scene to builder ``b`` (any object with the
    SceneBuilder interface)."""
    white, black = _box_with_opening(b)
    # short block
    b.add_mesh([(0.2, 0.0, 0.3), (0.5, 0.0, 0.3), (0.5, 0.3, 0.3),
                (0.2, 0.3, 0.3), (0.2, 0.0, 0.6), (0.5, 0.0, 0.6),
                (0.5, 0.3, 0.6), (0.2, 0.3, 0.6)],
               [(0, 1, 2), (0, 2, 3), (4, 6, 5), (4, 7, 6), (0, 3, 7),
                (0, 7, 4), (1, 5, 6), (1, 6, 2), (3, 2, 6), (3, 6, 7)],
               mat=white)
    _portal_light(b, black, strategy)


def _portal_scene(device="cuda", strategy="projection"):
    b = SceneBuilder()
    _fill_portal_scene(b, strategy)
    return b.build(device)


def _cornell_box(b):
    """The classic cornell box with a plain one-sided diffuse area light
    on an aaplane under the ceiling. Returns the white material row."""
    white = b.add_material(type=0, kd=_WHITE)
    red = b.add_material(type=0, kd=_RED)
    green = b.add_material(type=0, kd=_GREEN)
    black = b.add_material(type=0, kd=0.0)
    for verts, m in zip(_WALLS, (white, white, red, green)):
        b.add_mesh(verts, _QUAD, mat=m)
    b.add_mesh([(0, 1, 0), (1, 1, 0), (1, 1, 0.3), (0, 1, 0.3)], _QUAD,
               mat=white)
    b.add_mesh([(0, 1, 0.7), (1, 1, 0.7), (1, 1, 1), (0, 1, 1)], _QUAD,
               mat=white)
    li = b.add_light(type="area", L=(15.0, 13.0, 9.0), prim=-1)
    pid = b.add_aaplane((0.3, 0.99, 0.35), (0.7, 0.99, 0.65), axis=1,
                        facing_fw=False, mat=black, light=li)
    b.light_rows[li]["prim"] = ("pln", pid)
    return white


def _plain_cornell(device="cuda"):
    """Classic cornell box with a plain one-sided diffuse area light."""
    b = SceneBuilder()
    _cornell_box(b)
    return b.build(device)


def _fill_sphere_cornell(b):
    """Add the sphere cornell scene to builder ``b``: the plain cornell
    box plus two matte spheres (the second one Oren–Nayar, sigma 20°) and
    a point light beside the area light."""
    white = _cornell_box(b)
    rough = b.add_material(type=0, kd=(0.6, 0.5, 0.3), sigma=20.0)
    b.add_sphere((0.3, 0.18, 0.55), 0.18, mat=white)
    b.add_sphere((0.68, 0.14, 0.35), 0.14, mat=rough)
    b.add_light(type="point", I=(0.5, 0.5, 0.6), pos=(0.85, 0.8, 0.15))


def _sphere_cornell(device="cuda"):
    b = SceneBuilder()
    _fill_sphere_cornell(b)
    return b.build(device)


def _add_sphere_mesh(b, c, r, m, nseg):
    """Lat-long tessellated sphere (2·nseg²−2·nseg faces)."""
    th = np.linspace(0, np.pi, nseg + 1)
    ph = np.linspace(0, 2 * np.pi, nseg + 1)
    vs = [(c[0] + r * np.sin(th[i]) * np.cos(ph[j]),
           c[1] + r * np.cos(th[i]),
           c[2] + r * np.sin(th[i]) * np.sin(ph[j]))
          for i in range(nseg + 1) for j in range(nseg + 1)]
    fs = []
    for i in range(nseg):
        for j in range(nseg):
            a = i * (nseg + 1) + j
            d = a + nseg + 1
            if i > 0:
                fs.append((a, a + 1, d + 1))
            if i < nseg - 1:
                fs.append((a, d + 1, d))
    b.add_mesh(vs, fs, mat=m)


def _tessellated_portal(nseg=13, device="cuda"):
    """The portal scene's box and light plus a tessellated sphere
    (nseg=13: 328 triangles; nseg=22: 940)."""
    b = SceneBuilder()
    white, black = _box_with_opening(b)
    _add_sphere_mesh(b, (0.35, 0.22, 0.45), 0.22, white, nseg)
    _portal_light(b, black)
    return b.build(device)


def _floor_heights(n):
    """Heights of the n×n heightfield floor over [0,1]²: a closed-form sum
    of sines between 0.01 and 0.09 (no random numbers)."""
    x, z = np.meshgrid(np.linspace(0.0, 1.0, n), np.linspace(0.0, 1.0, n))
    tau = 2.0 * np.pi
    return (0.05 + 0.02 * np.sin(3 * tau * x) * np.sin(2 * tau * z)
            + 0.012 * np.sin(7 * tau * x + 1.3)
            + 0.008 * np.sin(11 * tau * z + 0.4))


def _fill_heightfield_cornell(b, n=256, n_phi=64, n_z=24):
    """Add the heightfield cornell scene to builder ``b``: back, left and
    right walls and a ceiling, a plain area light under it, an n×n
    heightfield floor (2·(n−1)² triangles), a cone of 2·n_phi·n_z
    triangles with shading normals standing on the floor, and a sphere.
    The tessellators work in z-up object space; (x, y, z) there is
    (x, z, y) here."""
    white = b.add_material(type=0, kd=_WHITE)
    red = b.add_material(type=0, kd=_RED)
    green = b.add_material(type=0, kd=_GREEN)
    black = b.add_material(type=0, kd=0.0)
    sand = b.add_material(type=0, kd=(0.55, 0.5, 0.35))
    blue = b.add_material(type=0, kd=(0.3, 0.4, 0.7))
    for verts, m in zip(_WALLS[1:], (white, red, green)):
        b.add_mesh(verts, _QUAD, mat=m)
    b.add_mesh([(0, 1, 0), (1, 1, 0), (1, 1, 1), (0, 1, 1)], _QUAD,
               mat=white)
    li = b.add_light(type="area", L=(15.0, 13.0, 9.0), prim=-1)
    pid = b.add_aaplane((0.3, 0.99, 0.35), (0.7, 0.99, 0.65), axis=1,
                        facing_fw=False, mat=black, light=li)
    b.light_rows[li]["prim"] = ("pln", pid)

    verts, faces, _ = tessellate.tessellate_heightfield(n, n,
                                                        _floor_heights(n))
    b.add_mesh(verts[:, [0, 2, 1]], faces, mat=sand)
    verts, faces, norms = tessellate.tessellate_cone(
        radius=0.12, height=0.35, n_phi=n_phi, n_z=n_z)
    base = np.asarray([0.68, 0.03, 0.55], np.float32)
    b.add_mesh(verts[:, [0, 2, 1]] + base, faces, mat=blue,
               normals=norms[:, [0, 2, 1]])
    b.add_sphere((0.32, 0.25, 0.45), 0.13, mat=white)


def _heightfield_cornell(device="cuda", n=256):
    """The BVH slice's scene: 2·(n−1)² + 3,080 triangles (133,130 at the
    default n = 256), one sphere, one aaplane light."""
    b = SceneBuilder()
    _fill_heightfield_cornell(b, n)
    return b.build(device)


def _fill_triangle_soup(b, n=100_000, seed=11):
    """Add an irregular triangle soup to builder ``b``: ``n`` triangles
    with centres uniform in [0.05, 0.95]³, each spanned by two edges of
    random direction whose lengths are log-uniform over two decades, from
    a numpy seed, as one mesh; and the plain area light of the cornell
    scenes under the ceiling. The decades are 0.0005 to 0.05 at 100,000
    triangles and scale with 1/sqrt(n) (up to 0.005 to 0.5), so the soup's
    total area, and with it the share of rays that hit, does not depend
    on n."""
    rng = np.random.RandomState(seed)
    shortest = 0.0005 * min(10.0, (100_000 / n) ** 0.5)
    white = b.add_material(type=0, kd=_WHITE)
    black = b.add_material(type=0, kd=0.0)
    li = b.add_light(type="area", L=(15.0, 13.0, 9.0), prim=-1)
    pid = b.add_aaplane((0.3, 0.99, 0.35), (0.7, 0.99, 0.65), axis=1,
                        facing_fw=False, mat=black, light=li)
    b.light_rows[li]["prim"] = ("pln", pid)
    c = rng.uniform(0.05, 0.95, (n, 1, 3))
    edge = rng.randn(n, 2, 3)
    edge /= np.linalg.norm(edge, axis=-1, keepdims=True)
    edge *= shortest * 100.0 ** rng.uniform(0.0, 1.0, (n, 2, 1))
    verts = np.concatenate([c, c + edge], axis=1).astype(np.float32)
    b.add_mesh(verts.reshape(3 * n, 3), np.arange(3 * n).reshape(n, 3),
               mat=white)


def _triangle_soup(device="cuda", n=100_000, seed=11):
    """The harness's irregular tree: ``n`` triangles (a BVH for more than
    256) and one aaplane light."""
    b = SceneBuilder()
    _fill_triangle_soup(b, n, seed)
    return b.build(device)


def _camera(res=(64, 64), device="cuda"):
    device = require_device(device)
    return cam_mod.make_perspective(
        transform.look_at((0.5, 0.5, -1.4), (0.5, 0.5, 1.0), (0, 1, 0),
                          device=device),
        40.0, res, device=device)
