"""Interactive progressive viewer with AOV shading modes
(fermat_tpu/render/viewer.py).

Reference analogs:
  * glut_viewer.cu:171 (display loop: render a pass, blit, repeat) and
    :426 (keyboard camera manipulation + mode switching).
  * ShadingMode (renderer_view.h:62-77): kShaded kUV kUVStretch kCharts
    kAlbedo kDiffuseAlbedo kSpecularAlbedo kDiffuseColor kSpecularColor
    kDirectLighting kFiltered kVariance kNormal kAux0.

The frontend is a terminal renderer, as JAX's: truecolor ANSI half-blocks
('▀' with independent fg/bg colors packs two pixels per character cell),
progressive passes between input polls, camera ops that replace the view's
camera and restart the accumulation. Works over ssh; scriptable through any
byte stream (`run(input_stream=...)`, or a pipe on stdin). Keyboard map
mirrors the GLUT viewer: WASD walk/pan, r/f up/down, arrows rotate, +/-
zoom, TAB / 0-9 shading modes, o = save TGA, q = quit. The images come to
the host once a frame; the passes run on the context's device.

`filtered` before the first pass (no G-buffer yet) shows the tonemapped
composite, as JAX's does; JAX gets there by catching any exception of
filtered_image, the port by testing for the G-buffer, so a failing filter
raises here.
"""
from __future__ import annotations

import os
import select
import shutil
import sys
import time
from typing import Optional

import numpy as np

# ShadingMode parity (renderer_view.h:62-77). kCharts maps to per-triangle
# ids here. kUVStretch (renderer_view.h:65) is declared + key-bound in the
# reference (glut_viewer.cu:338) but its blit kernel was never written;
# here it renders the per-triangle world-area/uv-area stretch as a
# blue-grey-red log2 heatmap (red = texture compressed, blue = stretched).
SHADING_MODES = [
    "shaded",           # kShaded: tonemapped composited
    "uv",               # kUV: interpolated texture coords
    "uv_stretch",       # kUVStretch: sqrt(world/uv area) log2 heatmap
    "charts",           # kCharts analog: hashed triangle-id colors
    "albedo",           # kAlbedo: diffuse+specular albedo
    "diffuse_albedo",   # kDiffuseAlbedo
    "specular_albedo",  # kSpecularAlbedo
    "diffuse_color",    # kDiffuseColor: diffuse-routed radiance
    "specular_color",   # kSpecularColor
    "direct",           # kDirectLighting
    "filtered",         # kFiltered: EAW-denoised composited
    "variance",         # kVariance: online luminance variance
    "normal",           # kNormal
    "depth",            # kAux0 analog: normalized inverse depth
]


def _tonemap(img: np.ndarray, exposure: float = 1.0, gamma: float = 2.2):
    x = np.maximum(img * exposure, 0.0)
    x = x / (1.0 + x)  # Reinhard, matching the viewer's LDR blit
    return np.clip(x ** (1.0 / gamma), 0.0, 1.0)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def aov_image(ctx, mode: str, exposure: float = 1.0) -> np.ndarray:
    """(H, W, 3) float image in [0,1] for a shading mode (a function of the
    context's framebuffer and G-buffer, viewer.py:53-150)."""
    fb = ctx.fb
    gb = ctx.gbuffer
    if mode == "shaded":
        return _tonemap(_np(fb.composited), exposure)
    if mode == "uv" and gb is not None:
        uv = _np(gb["uv"])
        out = np.zeros(uv.shape[:2] + (3,), np.float32)
        out[..., 0] = np.mod(uv[..., 0], 1.0)
        out[..., 1] = np.mod(uv[..., 1], 1.0)
        return out
    if mode == "uv_stretch" and gb is not None:
        mesh = ctx.view.mesh
        e1 = np.stack([_np(mesh.e1.x), _np(mesh.e1.y), _np(mesh.e1.z)], -1)
        e2 = np.stack([_np(mesh.e2.x), _np(mesh.e2.y), _np(mesh.e2.z)], -1)
        w_area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
        uv0 = _np(mesh.uv0)
        du1 = _np(mesh.uv1) - uv0
        du2 = _np(mesh.uv2) - uv0
        uv_area = 0.5 * np.abs(du1[:, 0] * du2[:, 1] - du1[:, 1] * du2[:, 0])
        stretch = np.sqrt(w_area / np.maximum(uv_area, 1e-12))
        med = np.median(stretch[w_area > 0]) if (w_area > 0).any() else 1.0
        tri = _np(gb["tri"])
        s = stretch[np.clip(tri, 0, stretch.shape[0] - 1)]
        # log2 ratio vs the scene median, mapped to blue-grey-red
        x = np.clip(np.log2(s / max(med, 1e-12)) / 4.0, -1.0, 1.0)
        out = np.empty(tri.shape + (3,), np.float32)
        out[..., 0] = 0.5 + 0.5 * np.maximum(x, 0.0)
        out[..., 1] = 0.5 - 0.25 * np.abs(x)
        out[..., 2] = 0.5 + 0.5 * np.maximum(-x, 0.0)
        out[_np(gb["miss"])] = 0.0
        return out
    if mode == "charts" and gb is not None:
        tri = _np(gb["tri"]).astype(np.uint32)
        h = (tri * np.uint32(2654435761)) & np.uint32(0xFFFFFF)
        out = np.stack([(h >> 16) & 0xFF, (h >> 8) & 0xFF, h & 0xFF],
                       axis=-1).astype(np.float32) / 255.0
        out[_np(gb["miss"])] = 0.0
        return out
    if mode == "albedo":
        return np.clip(_np(fb.diffuse_albedo) + _np(fb.specular_albedo), 0.0, 1.0)
    if mode == "diffuse_albedo":
        return np.clip(_np(fb.diffuse_albedo), 0.0, 1.0)
    if mode == "specular_albedo":
        return np.clip(_np(fb.specular_albedo), 0.0, 1.0)
    if mode == "diffuse_color":
        return _tonemap(_np(fb.diffuse), exposure)
    if mode == "specular_color":
        return _tonemap(_np(fb.specular), exposure)
    if mode == "direct":
        return _tonemap(_np(fb.direct), exposure)
    if mode == "filtered" and gb is not None:
        return ctx.filtered_image()[..., :3].astype(np.float32) / 255.0
    if mode == "variance":
        v = _np(fb.var_luminance[..., 3])
        v = v / max(float(v.max()), 1e-9)
        return np.sqrt(v)[..., None].repeat(3, -1)
    if mode == "normal" and gb is not None:
        return np.clip(_np(gb["normal"]) * 0.5 + 0.5, 0.0, 1.0)
    if mode == "depth" and gb is not None:
        d = _np(gb["depth"])
        inv = 1.0 / np.maximum(d, 1e-6)
        inv[~np.isfinite(d) | (d > 1e30)] = 0.0
        inv = inv / max(inv.max(), 1e-9)
        return inv[..., None].repeat(3, -1).astype(np.float32)
    # the modes that need a G-buffer, before the first pass
    return _tonemap(_np(fb.composited), exposure)


def ansi_frame(img: np.ndarray, max_cols: int = 0, max_rows: int = 0) -> str:
    """Encode an (H, W, 3) [0,1] image as truecolor half-block lines."""
    if max_cols <= 0 or max_rows <= 0:
        ts = shutil.get_terminal_size((100, 40))
        max_cols = max_cols or ts.columns
        max_rows = max_rows or (ts.lines - 2)
    h, w = img.shape[:2]
    out_w = min(max_cols, w)
    out_h = min(max_rows * 2, h)
    yi = (np.arange(out_h) * h // max(out_h, 1)).clip(0, h - 1)
    xi = (np.arange(out_w) * w // max(out_w, 1)).clip(0, w - 1)
    small = (img[yi][:, xi] * 255.0 + 0.5).astype(np.uint8)
    if small.shape[0] % 2:
        small = small[:-1]
    top = small[0::2]
    bot = small[1::2]
    lines = []
    for r in range(top.shape[0]):
        parts = []
        for cidx in range(top.shape[1]):
            tr, tg, tb = top[r, cidx]
            br, bg, bb = bot[r, cidx]
            parts.append(
                f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg};{bb}m▀"
            )
        lines.append("".join(parts) + "\x1b[0m")
    return "\n".join(lines)


class Viewer:
    """Progressive viewer driving a RenderingContext (glut_viewer analog)."""

    def __init__(self, ctx, exposure: float = 1.0, out=None):
        self.ctx = ctx
        self.exposure = exposure
        self.mode_idx = 0
        self.running = True
        self.out = out if out is not None else sys.stdout
        self._walk = 0.12
        self._rot = 0.08

    @property
    def mode(self) -> str:
        return SHADING_MODES[self.mode_idx]

    def _set_camera(self, cam) -> None:
        self.ctx.view = self.ctx.view._replace(camera=cam)
        self.ctx.restart()  # camera moved -> invalidate accumulation

    # -- input ------------------------------------------------------------
    def handle_key(self, key: str) -> None:
        """One key (escape sequences pre-decoded to 'up'/'down'/...)."""
        cam = self.ctx.view.camera
        if key == "q":
            self.running = False
        elif key == "w":
            self._set_camera(cam.walk(self._walk))
        elif key == "s":
            self._set_camera(cam.walk(-self._walk))
        elif key == "a":
            self._set_camera(cam.pan(-self._walk, 0.0))
        elif key == "d":
            self._set_camera(cam.pan(self._walk, 0.0))
        elif key == "r":
            self._set_camera(cam.pan(0.0, self._walk))
        elif key == "f":
            self._set_camera(cam.pan(0.0, -self._walk))
        elif key in ("+", "="):
            self._set_camera(cam.zoom(0.1))
        elif key == "-":
            self._set_camera(cam.zoom(-0.1))
        elif key == "up":
            self._set_camera(cam.rotate(self._rot, 0.0))
        elif key == "down":
            self._set_camera(cam.rotate(-self._rot, 0.0))
        elif key == "left":
            self._set_camera(cam.rotate(0.0, self._rot))
        elif key == "right":
            self._set_camera(cam.rotate(0.0, -self._rot))
        elif key == "\t" or key == "m":
            self.mode_idx = (self.mode_idx + 1) % len(SHADING_MODES)
        elif key.isdigit():
            idx = (int(key) - 1) % 10 if key != "0" else 9
            if idx < len(SHADING_MODES):
                self.mode_idx = idx
        elif key == "o":
            from fermat_tpu_torch.utils.image import write_tga

            path = f"view_{self.mode}_{self.ctx.instance:04d}.tga"
            write_tga(path, aov_image(self.ctx, self.mode, self.exposure))
            print(f"\nsaved {path}", file=sys.stderr)

    @staticmethod
    def decode_keys(data: bytes):
        """Decode raw bytes to key names (arrows = ESC [ A/B/C/D)."""
        keys = []
        i = 0
        arrows = {65: "up", 66: "down", 67: "right", 68: "left"}
        while i < len(data):
            b = data[i]
            if b == 27 and i + 2 < len(data) and data[i + 1] == 91:
                keys.append(arrows.get(data[i + 2], ""))
                i += 3
            else:
                keys.append(chr(b))
                i += 1
        return [k for k in keys if k]

    # -- frame loop -------------------------------------------------------
    def draw(self, max_cols: int = 0, max_rows: int = 0) -> str:
        img = aov_image(self.ctx, self.mode, self.exposure)
        frame = ansi_frame(img, max_cols, max_rows)
        hud = (
            f"[{self.ctx.renderer}] pass {self.ctx.instance} "
            f"mode={self.mode} (TAB cycles, 1-9 select, WASD/arrows move, "
            f"o=save, q=quit)"
        )
        return frame + "\n" + hud

    def run(
        self,
        passes_per_frame: int = 1,
        max_frames: Optional[int] = None,
        input_stream=None,
    ) -> int:
        """Blocking loop: render -> draw -> poll keys. `input_stream`
        overrides stdin (tests feed scripted bytes); `max_frames` bounds the
        loop for non-interactive use. Returns frames drawn."""
        stdin = input_stream if input_stream is not None else sys.stdin
        if input_stream is None and not stdin.isatty() and hasattr(stdin, "buffer"):
            stdin = stdin.buffer  # a pipe: read its bytes
        fd = None
        old = None
        if input_stream is None and hasattr(stdin, "fileno") and stdin.isatty():
            import termios
            import tty

            fd = stdin.fileno()
            old = termios.tcgetattr(fd)
            tty.setcbreak(fd)
        frames = 0
        try:
            while self.running and (max_frames is None or frames < max_frames):
                self.ctx.render(passes_per_frame)
                self.out.write("\x1b[H\x1b[2J" + self.draw() + "\n")
                self.out.flush()
                frames += 1
                data = b""
                if fd is not None:
                    while select.select([stdin], [], [], 0.0)[0]:
                        data += os.read(fd, 64)
                elif hasattr(stdin, "read"):
                    chunk = stdin.read(64)
                    if isinstance(chunk, str):
                        chunk = chunk.encode()
                    data = chunk or b""
                for k in self.decode_keys(data):
                    self.handle_key(k)
                    if not self.running:
                        break
                if input_stream is not None and not data:
                    # scripted stream exhausted -> stop after draining
                    self.running = False
        finally:
            if fd is not None and old is not None:
                import termios

                termios.tcsetattr(fd, termios.TCSADRAIN, old)
        return frames
