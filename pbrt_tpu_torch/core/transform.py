"""4x4 transforms and the two-keyframe AnimatedTransform (port of
pbrt_tpu/core/transform.py:29-260).

``look_at_matrix`` and ``rotate_matrix`` are host numpy: the scene parser
keeps its current transformation matrix in float64 and takes these
matrices as pbrt_tpu rounds them (LookAt and Rotate through float32).
The builders for programmatic scenes (``identity``, ``translate``,
``scale``, ``rotate`` and ``rotate_x/y/z``, ``look_at``, ``perspective``,
``orthographic``) compute each matrix and its inverse on the host as
pbrt_tpu's do and return a ``Transform`` on ``device``.

Applying a transform is a (R,3)·(3,3) product, left to ``torch.matmul``.
TF32 would keep only about three decimal digits of a float32 product on
the GPU, so this module turns it off for matmul and cuDNN alike: the
port's rays must match the float32 reference to ~1e-6.

``AnimatedTransform`` decomposes its two keyframes on the host (float64,
``decompose``) and interpolates per ray on the device: the translation
and the scale/shear lerped, the rotation by quaternion slerp. Its
per-ray 3×3 product is written as sums of elementwise products, never
as a matmul, so it stays float32 on the card too.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass
class Transform:
    m: torch.Tensor      # (4,4)
    m_inv: torch.Tensor  # (4,4)

    def __matmul__(self, other: "Transform") -> "Transform":
        return Transform(self.m @ other.m, other.m_inv @ self.m_inv)

    def inverse(self) -> "Transform":
        return Transform(self.m_inv, self.m)

    def apply_point(self, p: torch.Tensor) -> torch.Tensor:
        r = p @ self.m[:3, :3].T + self.m[:3, 3]
        w = p @ self.m[3, :3] + self.m[3, 3]
        return torch.where(w[..., None] == 1.0, r, r / w[..., None])

    def apply_vector(self, v: torch.Tensor) -> torch.Tensor:
        return v @ self.m[:3, :3].T


def _from_np(m: np.ndarray, m_inv: np.ndarray, device) -> Transform:
    return Transform(torch.as_tensor(m, dtype=torch.float32, device=device),
                     torch.as_tensor(m_inv, dtype=torch.float32,
                                     device=device))


def from_matrix(m, device="cpu") -> Transform:
    m = np.asarray(m, np.float32).reshape(4, 4)
    return _from_np(m, np.linalg.inv(m), device)


def identity(device="cpu") -> Transform:
    return _from_np(np.eye(4), np.eye(4), device)


def translate(delta, device="cpu") -> Transform:
    d = np.asarray(delta, np.float32)
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = d
    mi = np.eye(4, dtype=np.float32)
    mi[:3, 3] = -d
    return _from_np(m, mi, device)


def scale(s, device="cpu") -> Transform:
    """Scale by s (a number or three); the inverse by 1/s in float32."""
    s = np.broadcast_to(np.asarray(s, np.float32), (3,))
    m = np.diag(np.append(s, 1.0).astype(np.float32))
    mi = np.diag(np.append(1.0 / s, 1.0).astype(np.float32))
    return _from_np(m, mi, device)


def rotate_matrix(theta_deg: float, axis) -> np.ndarray:
    """transform.cpp Rotate about ``axis`` (Rodrigues, float64), rounded
    to float32."""
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    s, c = np.sin(np.radians(theta_deg)), np.cos(np.radians(theta_deg))
    m = np.eye(4)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    m[:3, :3] = c * np.eye(3) + s * K + (1 - c) * np.outer(a, a)
    return m.astype(np.float32)


def rotate(theta_deg: float, axis, device="cpu") -> Transform:
    """Rotate by theta_deg about axis; the inverse is the transpose."""
    m = rotate_matrix(theta_deg, axis)
    return _from_np(m, m.T, device)


def rotate_x(deg, device="cpu") -> Transform:
    return rotate(deg, (1, 0, 0), device)


def rotate_y(deg, device="cpu") -> Transform:
    return rotate(deg, (0, 1, 0), device)


def rotate_z(deg, device="cpu") -> Transform:
    return rotate(deg, (0, 0, 1), device)


def look_at_matrix(eye, look, up) -> np.ndarray:
    """transform.cpp LookAt: the camera-to-world matrix in float64, as
    pbrt_tpu computes it before rounding."""
    eye = np.asarray(eye, np.float64)
    look = np.asarray(look, np.float64)
    up = np.asarray(up, np.float64)
    d = look - eye
    d = d / np.linalg.norm(d)
    right = np.cross(up / np.linalg.norm(up), d)
    nr = np.linalg.norm(right)
    if nr < 1e-10:
        # up parallel to the viewing direction: pick an arbitrary right
        right = np.cross(np.array([0.0, 0.0, 1.0]) if abs(d[2]) < 0.9
                         else np.array([1.0, 0.0, 0.0]), d)
        nr = np.linalg.norm(right)
    right /= nr
    new_up = np.cross(d, right)
    m = np.eye(4)
    m[:3, 0] = right
    m[:3, 1] = new_up
    m[:3, 2] = d
    m[:3, 3] = eye
    return m


def look_at(eye, look, up, device="cpu") -> Transform:
    """transform.cpp LookAt: camera-to-world (host math in float64, as
    pbrt_tpu does, then rounded to float32)."""
    m = look_at_matrix(eye, look, up)
    return _from_np(m.astype(np.float32),
                    np.linalg.inv(m).astype(np.float32), device)


def perspective(fov_deg: float, near: float, far: float,
                device="cpu") -> Transform:
    """transform.cpp Perspective: camera space to the projected screen
    space (float64 on the host, then rounded)."""
    inv_tan = 1.0 / np.tan(np.radians(fov_deg) / 2.0)
    persp = np.array([
        [1, 0, 0, 0],
        [0, 1, 0, 0],
        [0, 0, far / (far - near), -far * near / (far - near)],
        [0, 0, 1, 0]], np.float64)
    m = np.diag([inv_tan, inv_tan, 1.0, 1.0]) @ persp
    return _from_np(m.astype(np.float32),
                    np.linalg.inv(m).astype(np.float32), device)


def orthographic(znear: float, zfar: float, device="cpu") -> Transform:
    """transform.cpp Orthographic: z from [znear, zfar] to [0, 1]."""
    m = np.eye(4)
    m[2, 2] = 1.0 / (zfar - znear)
    m[2, 3] = -znear / (zfar - znear)
    return _from_np(m.astype(np.float32),
                    np.linalg.inv(m).astype(np.float32), device)


# ---------------------------------------------------------------------------
# quaternions and AnimatedTransform (transform.cpp / quaternion.cpp)
# ---------------------------------------------------------------------------

def quat_from_matrix(m: np.ndarray) -> np.ndarray:
    """A rotation matrix (3,3) → its quaternion (x, y, z, w), on the host
    in float64."""
    tr = np.trace(m)
    if tr > 0:
        s = np.sqrt(tr + 1.0)
        w = s / 2.0
        s = 0.5 / s
        return np.array([(m[2, 1] - m[1, 2]) * s, (m[0, 2] - m[2, 0]) * s,
                         (m[1, 0] - m[0, 1]) * s, w])
    i = int(np.argmax(np.diag(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(0.0, m[i, i] - m[j, j] - m[k, k] + 1.0))
    q = np.zeros(4)
    q[i] = s * 0.5
    s = 0.5 / s if s != 0 else 0.0
    q[3] = (m[k, j] - m[j, k]) * s
    q[j] = (m[j, i] + m[i, j]) * s
    q[k] = (m[k, i] + m[i, k]) * s
    return q


def quat_slerp(t: torch.Tensor, q0: torch.Tensor,
               q1: torch.Tensor) -> torch.Tensor:
    """quaternion.cpp Slerp of the (4,) quaternions q0, q1, batched over
    the times t (R,): (R,4)."""
    cos_theta = (q0 * q1).sum(-1)
    q1 = torch.where(cos_theta < 0.0, -q1, q1)
    cos_theta = cos_theta.abs()
    theta = torch.arccos(torch.clamp(cos_theta, -1.0, 1.0))
    sin_theta = torch.sin(theta)
    near = cos_theta > 0.9995
    den = torch.where(near, 1.0, sin_theta)
    w0 = torch.where(near, 1.0 - t, torch.sin((1.0 - t) * theta) / den)
    w1 = torch.where(near, t, torch.sin(t * theta) / den)
    q = w0[..., None] * q0 + w1[..., None] * q1
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) quaternions → (..., 3, 3) rotation matrices."""
    x, y, z, w = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                     2 * (x * z + y * w)], dim=-1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                     2 * (y * z - x * w)], dim=-1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                     1 - 2 * (x * x + y * y)], dim=-1)], dim=-2)


def _lerp(t, a, b):
    return (1.0 - t) * a + t * b


@dataclasses.dataclass
class AnimatedTransform:
    """The two keyframes' decompositions (transform.cpp Decompose):
    translations t0, t1 (3,), rotations q0, q1 (4,), scale/shear s0, s1
    (3,3), over the times [start_time, end_time]."""
    t0: torch.Tensor
    t1: torch.Tensor
    q0: torch.Tensor
    q1: torch.Tensor
    s0: torch.Tensor
    s1: torch.Tensor
    start_time: torch.Tensor     # ()
    end_time: torch.Tensor       # ()

    def interpolate(self, time: torch.Tensor) -> torch.Tensor:
        """(R,4,4) matrices at the times (R,)."""
        dt = torch.clamp((time - self.start_time)
                         / torch.clamp_min(self.end_time - self.start_time,
                                           1e-9), 0.0, 1.0)
        trans = _lerp(dt[..., None], self.t0, self.t1)
        rot = quat_to_matrix(quat_slerp(dt, self.q0, self.q1))
        sc = _lerp(dt[..., None, None], self.s0, self.s1)
        # rot @ sc as elementwise sums (no matmul: TF32 on the card)
        upper = (rot[..., :, 0:1] * sc[..., 0:1, :]
                 + rot[..., :, 1:2] * sc[..., 1:2, :]
                 + rot[..., :, 2:3] * sc[..., 2:3, :])
        m = torch.zeros(dt.shape + (4, 4), device=dt.device)
        m[..., :3, :3] = upper
        m[..., :3, 3] = trans
        m[..., 3, 3] = 1.0
        return m


def decompose(m: np.ndarray):
    """transform.cpp AnimatedTransform::Decompose, on the host in float64:
    translation, rotation quaternion (polar decomposition by iteration)
    and the scale/shear."""
    m = np.asarray(m, np.float64)
    t = m[:3, 3].copy()
    M = m[:3, :3].copy()
    R = M.copy()
    for _ in range(100):
        R_next = 0.5 * (R + np.linalg.inv(R.T))
        if np.max(np.abs(R_next - R)) < 1e-8:
            R = R_next
            break
        R = R_next
    S = np.linalg.inv(R) @ M
    return t, quat_from_matrix(R), S


def make_animated(m0, m1, t_start=0.0, t_end=1.0,
                  device="cpu") -> AnimatedTransform:
    """An AnimatedTransform between the 4×4 matrices m0 (at t_start) and
    m1 (at t_end), decomposed from their float32 values as pbrt_tpu
    decomposes its Transforms' matrices."""
    t0, q0, s0 = decompose(np.asarray(m0, np.float32))
    t1, q1, s1 = decompose(np.asarray(m1, np.float32))

    def f32(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=device)
    return AnimatedTransform(t0=f32(t0), t1=f32(t1), q0=f32(q0), q1=f32(q1),
                             s0=f32(s0), s1=f32(s1), start_time=f32(t_start),
                             end_time=f32(t_end))
