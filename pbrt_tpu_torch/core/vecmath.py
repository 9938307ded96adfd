"""Vector math over batched ``(..., 3)`` tensors and batched bounding
boxes (port of pbrt_tpu/core/vecmath.py)."""

from __future__ import annotations

import dataclasses
import math

import torch

from pbrt_tpu_torch.ops import fastgather

INF = math.inf
SHADOW_EPS = 1e-3  # conservative ray-offset epsilon (vecmath.SHADOW_EPS)
MACHINE_EPS = 2.0 ** -24  # half the float32 epsilon (pbrt.h MachineEpsilon)


def gamma(n: int) -> float:
    """pbrt's gamma(n) floating-point error bound (core/pbrt.h)."""
    g = n * MACHINE_EPS
    return g / (1.0 - g)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def absdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return dot(a, b).abs()


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def length_squared(v: torch.Tensor) -> torch.Tensor:
    return torch.sum(v * v, dim=-1)


def length(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(length_squared(v))


def take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] along the first axis for an (R,) index: the same rows,
    with ``index_select`` (on a CPU several times faster than indexing)."""
    return torch.index_select(table, 0, idx)


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """√max(x, 0) with a zero gradient where x ≤ 0 (the clamped form's
    backward is 0 · ∞ = NaN there)."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def normalize(v: torch.Tensor) -> torch.Tensor:
    return v * torch.rsqrt(torch.clamp_min(torch.sum(v * v, dim=-1),
                                           1e-30))[..., None]


def distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return length(a - b)


def distance_squared(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return length_squared(a - b)


def lerp(t, a, b):
    return (1.0 - t) * a + t * b


def face_forward(n: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Flip n into the hemisphere of v (geometry.h Faceforward)."""
    return torch.where(dot(n, v)[..., None] < 0.0, -n, n)


def coordinate_system(v1: torch.Tensor):
    """Orthonormal basis around the unit vector v1 (geometry.h:237), by
    the branchless construction of Duff et al."""
    x, y, z = v1.unbind(-1)
    s = torch.where(z >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + z)
    b = x * y * a
    v2 = torch.stack([1.0 + s * x ** 2 * a, s * b, -s * x], dim=-1)
    v3 = torch.stack([b, s + y ** 2 * a, -y], dim=-1)
    return v2, v3


def spherical_direction(sin_theta, cos_theta, phi, x=None, y=None,
                        z=None) -> torch.Tensor:
    """geometry.h SphericalDirection, in the frame (x, y, z) if given."""
    d = torch.stack([sin_theta * torch.cos(phi), sin_theta * torch.sin(phi),
                     cos_theta], dim=-1)
    if x is None:
        return d
    return d[..., 0:1] * x + d[..., 1:2] * y + d[..., 2:3] * z


def spherical_theta(v: torch.Tensor) -> torch.Tensor:
    return torch.acos(torch.clamp(v[..., 2], -1.0, 1.0))


def spherical_phi(v: torch.Tensor) -> torch.Tensor:
    p = torch.atan2(v[..., 1], v[..., 0])
    return torch.where(p < 0.0, p + 2.0 * math.pi, p)


def take_axis(v: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """v[..., i] for a per-element component index i in [0, C)
    (``fastgather.select_component``, as pbrt_tpu's)."""
    return fastgather.select_component(v, i)


def offset_ray_origin(p: torch.Tensor, n: torch.Tensor,
                      w: torch.Tensor) -> torch.Tensor:
    """Scaled-normal shadow-ray origin offset (OffsetRayOrigin role)."""
    nf = face_forward(n, w)
    scale = SHADOW_EPS * torch.clamp_min(p.abs().amax(dim=-1), 1.0)
    return p + scale[..., None] * nf


@dataclasses.dataclass
class Bounds3:
    """Axis-aligned boxes, batched (geometry.h Bounds3f): lo, hi (...,3)."""
    lo: torch.Tensor
    hi: torch.Tensor

    def diagonal(self) -> torch.Tensor:
        return self.hi - self.lo

    def surface_area(self) -> torch.Tensor:
        d = self.diagonal()
        return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                      + d[..., 2] * d[..., 0])

    def centroid(self) -> torch.Tensor:
        return 0.5 * (self.lo + self.hi)


def bounds_union(a: Bounds3, b: Bounds3) -> Bounds3:
    return Bounds3(torch.minimum(a.lo, b.lo), torch.maximum(a.hi, b.hi))


def bounds_intersect_p(lo: torch.Tensor, hi: torch.Tensor, o: torch.Tensor,
                       inv_d: torch.Tensor, tmax: torch.Tensor) -> torch.Tensor:
    """Slab test, batched (Bounds3::IntersectP, geometry.h:1388+): lo, hi,
    o, inv_d (...,3), tmax (...). The far distance is scaled by
    1 + 2·gamma(3) for conservative traversal. Returns a bool mask."""
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    t_enter = torch.minimum(t0, t1).amax(dim=-1)
    t_exit = torch.maximum(t0, t1).amin(dim=-1) * (1.0 + 2.0 * gamma(3))
    return (t_enter <= t_exit) & (t_exit > 0.0) & (t_enter < tmax)


@dataclasses.dataclass
class Ray:
    """A batch of rays: origins and directions, (R, 3) each. (pbrt_tpu's
    tmax and hero-wavelength fields come with the integrators that read
    them.)"""
    o: torch.Tensor
    d: torch.Tensor


def make_ray(o: torch.Tensor, d: torch.Tensor) -> Ray:
    return Ray(o=o, d=d)


def reflect(wo: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """reflection.h Reflect: -wo + 2 dot(wo, n) n."""
    return -wo + 2.0 * dot(wo, n)[..., None] * n


def refract(wi: torch.Tensor, n: torch.Tensor, eta: torch.Tensor):
    """reflection.h Refract: (wt, valid). ``eta`` is eta_i / eta_t and
    ``n`` lies on wi's side."""
    cos_theta_i = dot(n, wi)
    sin2_theta_i = torch.clamp_min(1.0 - cos_theta_i * cos_theta_i, 0.0)
    sin2_theta_t = eta * eta * sin2_theta_i
    valid = sin2_theta_t < 1.0
    cos_theta_t = safe_sqrt(1.0 - sin2_theta_t)
    wt = (eta[..., None] * -wi
          + (eta * cos_theta_i - cos_theta_t)[..., None] * n)
    return wt, valid
