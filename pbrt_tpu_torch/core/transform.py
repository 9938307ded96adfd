"""4x4 transforms (port of pbrt_tpu/core/transform.py:29-129).

``look_at_matrix`` and ``rotate_matrix`` are host numpy: the scene parser
keeps its current transformation matrix in float64 and takes these
matrices as pbrt_tpu rounds them (LookAt and Rotate through float32).

Applying a transform is a (R,3)·(3,3) product, left to ``torch.matmul``.
TF32 would keep only about three decimal digits of a float32 product on
the GPU, so this module turns it off for matmul and cuDNN alike: the
port's rays must match the float32 reference to ~1e-6.
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
