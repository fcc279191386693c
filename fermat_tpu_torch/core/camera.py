"""Pinhole camera model, its manipulation ops, the direction sampler of the
bidirectional integrators and primary ray generation
(fermat_tpu/core/camera.py:25-174).

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

    # -- manipulation (camera.h:65-119) --
    def walk(self, delta: float) -> "Camera":
        d = (self.aim - self.eye) * delta
        return self._replace(eye=self.eye + d, aim=self.aim + d)

    def pan(self, dx: float, dy: float) -> "Camera":
        u, v, _ = camera_frame(self, 1.0)
        off = normalize(u) * (-dx) + normalize(v) * dy
        return self._replace(eye=self.eye + off, aim=self.aim + off)

    def zoom(self, delta: float) -> "Camera":
        return self._replace(fov=torch.clamp(self.fov * (1.0 + delta), 0.05, math.pi - 0.1))

    def rotate(self, rx: float, ry: float) -> "Camera":
        """Orbit the eye about aim: rx about the camera's right axis, ry about
        world +y."""
        u, _, _ = camera_frame(self, 1.0)
        axis_x = normalize(u)
        d = _rotate_about(self.eye - self.aim, axis_x, rx)
        up = _rotate_about(self.up, axis_x, rx)
        z, one = torch.zeros_like(self.fov), torch.ones_like(self.fov)
        axis_y = Vec3(z, one, z)
        d = _rotate_about(d, axis_y, ry)
        up = _rotate_about(up, axis_y, ry)
        return self._replace(eye=self.aim + d, up=up)

    def square_screen_focal_length(self) -> Tensor:
        """Image-plane distance giving a unit-area screen (camera.h:131-136)."""
        t = torch.tan(self.fov / 2.0)
        return 0.25 / (t * t)


def _rotate_about(v: Vec3, axis: Vec3, angle: float) -> Vec3:
    """Rodrigues rotation."""
    a = torch.tensor(angle, dtype=torch.float32, device=v.x.device)
    c, s = torch.cos(a), torch.sin(a)
    return v * c + cross(axis, v) * s + axis * (dot(axis, v) * (1.0 - c))


def camera_frame(cam: Camera, aspect_ratio: float) -> Tuple[Vec3, Vec3, Vec3]:
    """U, V, W frame (camera.h:142-171): W = aim - eye (unnormalized),
    |U| = |W| tan(fov/2), |V| = |U| / aspect."""
    w = cam.aim - cam.eye
    wlen = torch.sqrt(dot(w, w))
    u = normalize(cross(w, cam.up))
    v = normalize(cross(u, w))
    ulen = wlen * torch.tan(cam.fov / 2.0)
    return u * ulen, v * (ulen / aspect_ratio), w


class CameraSampler(NamedTuple):
    """Precomputed frame and pdf helper (camera.h:256-300, camera.py:89-142)."""

    u: Vec3
    v: Vec3
    w: Vec3
    w_len: Tensor
    square_focal_length: Tensor

    @staticmethod
    def create(cam: Camera, aspect_ratio: float) -> "CameraSampler":
        u, v, w = camera_frame(cam, aspect_ratio)
        return CameraSampler(u, v, w, torch.sqrt(dot(w, w)), cam.square_screen_focal_length())

    def sample_direction(self, ndc_x: Tensor, ndc_y: Tensor) -> Vec3:
        """NDC in [0,1]^2 -> the unnormalized direction (2x-1)U + (2y-1)V + W."""
        dx = ndc_x * 2.0 - 1.0
        dy = ndc_y * 2.0 - 1.0
        return Vec3(dx * self.u.x + dy * self.v.x + self.w.x,
                    dx * self.u.y + dy * self.v.y + self.w.y,
                    dx * self.u.z + dy * self.v.z + self.w.z)

    def _screen(self, out: Vec3):
        t = dot(out, self.w) / (self.w_len * self.w_len)
        tt = torch.where(t <= 0.0, 1.0, t)
        i = Vec3(out.x / tt, out.y / tt, out.z / tt) - self.w
        return t, dot(i, self.u) / dot(self.u, self.u), dot(i, self.v) / dot(self.v, self.v)

    def invert(self, out: Vec3) -> Tuple[Tensor, Tensor]:
        """Direction -> NDC (camera.h:195-201); (-1, -1) behind the camera."""
        t, ix, iy = self._screen(out)
        ok = t > 0.0
        return torch.where(ok, ix * 0.5 + 0.5, -1.0), torch.where(ok, iy * 0.5 + 0.5, -1.0)

    def pdf(self, out: Vec3, projected: bool = False) -> Tensor:
        """Solid-angle (or projected) pdf of the direction sampler
        (camera.h:205-251)."""
        t, ix, iy = self._screen(out)
        inside = (t > 0.0) & (torch.abs(ix) <= 1.0) & (torch.abs(iy) <= 1.0)
        cos_theta = dot(normalize(out), self.w) / self.w_len
        p = self.square_focal_length / torch.clamp_min(cos_theta ** (4 if projected else 3),
                                                        1e-12)
        return torch.where(inside, p, 0.0)

    def w_e(self, out: Vec3) -> Tensor:
        """Pinhole importance (the projected pdf): BPT's camera connections."""
        return self.pdf(out, projected=True)


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


def load_camera_file(path: str, device="cpu") -> Camera:
    """The eye / aim / up / fov camera text files (camera.py:177-185,
    renderer.cu:510-522): ten numbers, split by whitespace or commas."""
    vals = []
    with open(path, "r") as f:
        for line in f:
            vals.extend(float(tok) for tok in line.replace(",", " ").split())
    if len(vals) < 10:
        raise ValueError(f"camera file {path}: expected 10 floats, got {len(vals)}")
    return Camera.create(vals[0:3], vals[3:6], vals[6:9], vals[9], device=device)
