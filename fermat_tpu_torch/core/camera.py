"""Pinhole camera model + primary ray generation (fermat_tpu/core/camera.py).

Camera fields are 0-d float32 tensors on the scene's device, so the frame
is computed in float32 exactly as the JAX version computes it.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from fermat_tpu_torch.core.math import Vec3, cross, dot, normalize

Tensor = torch.Tensor


class Camera(NamedTuple):
    eye: Vec3  # Vec3 of 0-d tensors
    aim: Vec3
    up: Vec3
    fov: Tensor  # full horizontal field of view, radians

    @staticmethod
    def create(eye, aim, up=(0.0, 1.0, 0.0), fov=math.radians(60.0),
               device="cpu") -> "Camera":
        f = lambda c: torch.tensor(float(c), dtype=torch.float32, device=device)
        f3 = lambda v: Vec3(*(f(c) for c in v))
        return Camera(f3(eye), f3(aim), f3(up), f(fov))

    def to(self, device) -> "Camera":
        m = lambda t: t.to(device)
        v = lambda a: Vec3(m(a.x), m(a.y), m(a.z))
        return Camera(v(self.eye), v(self.aim), v(self.up), m(self.fov))


def camera_frame(cam: Camera, aspect_ratio: float) -> Tuple[Vec3, Vec3, Vec3]:
    """U, V, W frame (camera.h:142-171): W = aim - eye (unnormalized),
    |U| = |W| tan(fov/2), |V| = |U| / aspect."""
    w = cam.aim - cam.eye
    wlen = torch.sqrt(dot(w, w))
    u = normalize(cross(w, cam.up))
    v = normalize(cross(u, w))
    ulen = wlen * torch.tan(cam.fov / 2.0)
    return u * ulen, v * (ulen / aspect_ratio), w


def generate_camera_rays(cam: Camera, res_x: int, res_y: int,
                         jitter_x: Tensor, jitter_y: Tensor, pix: Tensor):
    """Primary rays, one lane per pixel id (camera.py:143-174).

    Pixel (x, y) maps to NDC ((x + jx)/res_x, (y + jy)/res_y).
    Returns (origin Vec3, normalized direction Vec3, pixel ids).
    """
    px = (pix % res_x).to(torch.float32)
    py = (pix // res_x).to(torch.float32)
    u, v, w = camera_frame(cam, res_x / res_y)
    dx = ((px + jitter_x) / res_x) * 2.0 - 1.0
    dy = ((py + jitter_y) / res_y) * 2.0 - 1.0
    d = normalize(Vec3(
        dx * u.x + dy * v.x + w.x,
        dx * u.y + dy * v.y + w.y,
        dx * u.z + dy * v.z + w.z,
    ))
    o = Vec3(cam.eye.x.expand_as(d.x), cam.eye.y.expand_as(d.y),
             cam.eye.z.expand_as(d.z))
    return o, d, pix
