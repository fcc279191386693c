"""RenderingContext — owns the scene, the framebuffer and the renderer
registry (fermat_tpu/render/context.py).

`create` takes the scene's lights as the JAX context does
(context.py:266-285): directional lights (records with `direction` and
`color`, scene.lights.DirectionalLightDef), point lights ((position,
intensity) pairs), a lat-long environment map (an (H, W, 3) float32 image;
`env_radiance` then scales it) and the constant `env_radiance`. Analytic
area lights go through SceneView.build(area_light_defs=...). texture_dir is
where the materials' texture names are looked up (SceneView.build).

The context runs on "cuda" unless the caller passes device="cpu"; with
device="cuda" and no GPU it raises. The registry holds JAX's eight
renderers, "pt", "bpt", "mlt", "cmlt", "rpt", "pssmlt", "psfpt" and
"ptrl", and what a plugin registers (register_renderer); a renderer's
options are its options tuple's fields (PTOptions, bpt.BPTOptions,
mlt.MLTOptions, cmlt.CMLTOptions, rpt.RPTOptions, pssmlt.PssmltOptions,
psfpt.PsfptOptions, ptrl.PtrlOptions). tracer="bvh", "frontier",
"cluster", "binned", "dense" (JAX's "brute" and "pallas") or "mega" picks
the tracer (with tracer="bvh" the view gets its BVH, SceneView.with_bvh);
"mega" is the PT pass's alone. `lobes` defaults to the scene's for every
renderer but pssmlt, `clearcoat` to the scene's for pt, as in JAX
(context.py:286-298). rmse_vs holds the image to a reference;
dump_speed_stats(detailed=True) profiles one more pass and splits its time
into rt_ms, shadow_rt_ms and shade_ms (utils/profiling.py). An "mlt" pass
presamples its chains anew and runs steps_per_pass steps; its COMPOSITED
is the chains' image plus the directly visible environment
(pt.direct_env_image), and so is each "cmlt" pass, one step of the chains. The renderer option narrow=1 makes render()
run each PT pass through the narrowing driver (integrators/pt.NarrowPass,
context.py:316-372); render_batch keeps the monolithic pass, as in JAX.
"cmlt", "pssmlt", "psfpt" and "ptrl" are stateful: render and render_batch
carry their renderer_state from pass to pass, and restart() drops it, so
that the next pass starts it anew from the view as it is then (JAX keeps
it, context.py:445-448). CMLT's chains are seeded at the first pass
(cmlt.init_state, one chain a pixel unless n_chains is set), and so are
PSSMLT's (pssmlt.init_state, one chain a pixel); a PSSMLT pass is one
Metropolis step whose splat image is COMPOSITED; its `rays` stays 0, as in
JAX.
PSFPT's state is its hash cells (psfpt.PsfptState), PTRL's a ptrl.PtrlRun:
the Q table, the light clusters and the VTL cut, built at the first pass
and adapted every adapt_every passes. Both write COMPOSITED only.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import numpy as np
import torch

from fermat_tpu_torch import resolve_device
from fermat_tpu_torch.bsdf.composite import scene_clearcoat, scene_lobes
from fermat_tpu_torch.core.camera import Camera
from fermat_tpu_torch.core.math import Vec3
from fermat_tpu_torch.integrators import bpt as bpt_mod
from fermat_tpu_torch.integrators import cmlt as cmlt_mod
from fermat_tpu_torch.integrators import mlt as mlt_mod
from fermat_tpu_torch.integrators import psfpt as psf_mod
from fermat_tpu_torch.integrators import pssmlt as ps_mod
from fermat_tpu_torch.integrators import pt as pt_mod
from fermat_tpu_torch.integrators import ptrl as ptrl_mod
from fermat_tpu_torch.integrators import rpt as rpt_mod
from fermat_tpu_torch.ops import pt_mega
from fermat_tpu_torch.render.framebuffer import Framebuffer, rmse, to_rgba8
from fermat_tpu_torch.scene.mesh import MeshStorage
from fermat_tpu_torch.scene.view import SceneView

# renderer registry: name -> factory(**options) -> (render_pass_fn, options)
_RENDERER_REGISTRY: Dict[str, Callable] = {}


def register_renderer(name: str, factory: Callable) -> None:
    """The plugin entry point (context.py:33-37): factory(**options) ->
    (render_pass_fn, options)."""
    _RENDERER_REGISTRY[name] = factory


def _pt_factory(**kw):
    return pt_mod.render_pass, pt_mod.PTOptions(**kw)


def _bpt_factory(**kw):
    return bpt_mod.render_pass_fb, bpt_mod.BPTOptions(**kw)


def _pssmlt_factory(**kw):
    """A stateful pass (context.py:104-135): `init` seeds one chain a pixel,
    the pass runs one step and returns (output, state)."""
    opts = ps_mod.PssmltOptions(**kw)

    def init(view, res_x, res_y, seed):
        return ps_mod.init_state(view, opts, res_x, res_y, res_x * res_y, seed)

    def pass_fn(view, opts_, res_x, res_y, instance, seed, state):
        new_state, splat = ps_mod.step(view, opts_, res_x, res_y, state)
        n = res_x * res_y
        rays = torch.zeros((), device=view.device)
        return pt_mod.composited_output(Vec3(splat[:, 0], splat[:, 1], splat[:, 2]), rays,
                                        torch.zeros(n, device=view.device)), new_state

    pass_fn.stateful = True
    pass_fn.init = init
    return pass_fn, opts


def _psfpt_factory(**kw):
    """A stateful pass (context.py:136-167) over the persistent hash cells."""
    opts = psf_mod.PsfptOptions(**kw)

    def init(view, res_x, res_y, seed):
        return psf_mod.init_state(view, opts)

    def pass_fn(view, opts_, res_x, res_y, instance, seed, state):
        out, state, rays, rays_lane = psf_mod.render_pass(view, opts_, res_x, res_y, instance,
                                                          state, seed)
        return pt_mod.composited_output(out, rays, rays_lane), state

    pass_fn.stateful = True
    pass_fn.init = init
    return pass_fn, opts


def _ptrl_factory(**kw):
    """A stateful pass (context.py:169-240): `init` builds the clusters and
    Q, each pass adapts the cut on its cadence and renders."""
    opts = ptrl_mod.PtrlOptions(**kw)

    def init(view, res_x, res_y, seed):
        return ptrl_mod.start(view, opts)

    def pass_fn(view, opts_, res_x, res_y, instance, seed, run):
        out, rays, rays_lane, run = ptrl_mod.step(view, opts_, run, res_x, res_y, instance,
                                                  seed)
        return pt_mod.composited_output(out, rays, rays_lane), run

    pass_fn.stateful = True
    pass_fn.init = init
    return pass_fn, opts


def _rpt_factory(**kw):
    return rpt_mod.render_pass_fb, rpt_mod.RPTOptions(**kw)


def _mlt_factory(**kw):
    return mlt_mod.render_pass_fb, mlt_mod.MLTOptions(**kw)


def _cmlt_factory(**kw):
    """A stateful pass (context.py:65-101): `init` seeds the chains (one a
    pixel when n_chains is 0), each pass is one step plus the directly
    visible environment."""
    opts = cmlt_mod.CMLTOptions(**kw)

    def init(view, res_x, res_y, seed):
        n = opts.n_chains if opts.n_chains > 0 else res_x * res_y
        return cmlt_mod.init_state(view, opts, res_x, res_y, n, seed)

    def pass_fn(view, opts_, res_x, res_y, instance, seed, state):
        return cmlt_mod.render_step_fb(view, opts_, res_x, res_y, instance, seed, state)

    pass_fn.stateful = True
    pass_fn.init = init
    return pass_fn, opts


register_renderer("pt", _pt_factory)
register_renderer("bpt", _bpt_factory)
register_renderer("mlt", _mlt_factory)
register_renderer("cmlt", _cmlt_factory)
register_renderer("rpt", _rpt_factory)
register_renderer("pssmlt", _pssmlt_factory)
register_renderer("psfpt", _psfpt_factory)
register_renderer("ptrl", _ptrl_factory)


@dataclass
class RenderingContext:
    view: SceneView
    res_x: int
    res_y: int
    renderer: str = "pt"
    renderer_options: dict = field(default_factory=dict)
    seed: int = 0
    fb: Optional[Framebuffer] = None
    gbuffer: Optional[dict] = None
    instance: int = 0
    stats: dict = field(default_factory=dict)
    renderer_state: object = None  # a stateful renderer's state (chains, cells, Q)
    _pass: Optional[tuple] = None

    @staticmethod
    def create(storage: MeshStorage, camera: Camera, res_x: int, res_y: int,
               renderer: str = "pt", dir_lights=(), seed: int = 0, texture_dir=None,
               env_radiance=(0.0, 0.0, 0.0), point_lights=(), env_map=None,
               device="cuda", **renderer_options) -> "RenderingContext":
        if renderer not in _RENDERER_REGISTRY:
            raise NotImplementedError(
                f"renderer {renderer!r} is not ported; registered: {sorted(_RENDERER_REGISTRY)}")
        dev = resolve_device(device)
        view = SceneView.build(storage, camera, dev, env_radiance=env_radiance,
                               dir_light_defs=dir_lights, point_light_defs=point_lights,
                               env_map=env_map, texture_dir=texture_dir)
        if renderer_options.get("tracer") == "bvh":
            view = view.with_bvh()
        renderer_options = dict(renderer_options)
        # of the registered renderers (context.py:286-298)
        if renderer in ("pt", "bpt", "psfpt", "ptrl", "mlt", "cmlt", "rpt"):
            renderer_options.setdefault("lobes", scene_lobes(storage.materials))
        if renderer == "pt":
            renderer_options.setdefault("clearcoat", scene_clearcoat(storage.materials))
        ctx = RenderingContext(view=view, res_x=res_x, res_y=res_y, renderer=renderer,
                               renderer_options=renderer_options, seed=seed)
        ctx.fb = Framebuffer.create(res_y, res_x, dev)
        return ctx

    @property
    def device(self) -> torch.device:
        return self.view.device

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def _one_pass(self, batch: bool = False) -> None:
        res_x, res_y = self.res_x, self.res_y
        if self._pass is None:
            options = dict(self.renderer_options)
            narrow = bool(options.pop("narrow", False)) and self.renderer == "pt"
            pass_fn, opts = _RENDERER_REGISTRY[self.renderer](**options)
            kw = {}
            if self.renderer == "pt" and opts.tracer == "mega":
                # the megakernel's scene tables are baked from the view once
                # (a build reads the view back to the host); restart() rebakes
                kw["tables"] = pt_mega.build_mega_tables(self.view, res_x, res_y, opts.ray_eps)
            drv = pt_mod.NarrowPass(self.view, opts, res_x, res_y, self.seed) if narrow else None
            self._pass = (pass_fn, opts, kw, drv)
        pass_fn, opts, kw, drv = self._pass
        if drv is not None and not batch:
            out = drv(self.instance)
        elif getattr(pass_fn, "stateful", False):
            if self.renderer_state is None:
                self.renderer_state = pass_fn.init(self.view, res_x, res_y, self.seed)
            out, self.renderer_state = pass_fn(self.view, opts, res_x, res_y, self.instance,
                                               self.seed, self.renderer_state)
        else:
            out = pass_fn(self.view, opts, res_x, res_y, self.instance, self.seed, **kw)
        img = lambda v: v.stack().reshape(res_y, res_x, 3)
        self.fb = self.fb.accumulate_pass(
            self.instance, img(out.diffuse), img(out.specular), img(out.direct),
            img(out.composited), img(out.diffuse_albedo), img(out.specular_albedo))
        shape = (res_y, res_x)
        self.gbuffer = {
            "normal": img(out.normal),
            "position": img(out.position),
            "miss": (out.tri < 0).reshape(shape),
            "depth": out.depth.reshape(shape),
            "uv": out.uv.reshape(res_y, res_x, 2),
            "tri": out.tri.reshape(shape),
            "material": out.material.reshape(shape),
            # closest + shadow rays traced this pass (dead lanes excluded)
            "rays": out.rays,
        }
        # running device-side total over all passes (read without a sync per pass)
        self.stats["rays"] = self.stats.get("rays", 0.0) + out.rays
        self.instance += 1

    def render(self, n_passes: int = 1, progress: bool = False) -> Framebuffer:
        """Progressive render loop; each pass ends in a device sync so that
        `stats["pass_times"]` holds device-complete wall times."""
        for _ in range(n_passes):
            t0 = time.perf_counter()
            self._one_pass()
            self._sync()
            dt = time.perf_counter() - t0
            self.stats.setdefault("pass_times", []).append(dt)
            if progress:
                print(f"pass {self.instance - 1}: {dt * 1e3:.1f} ms")
        return self.fb

    def render_batch(self, n_passes: int) -> Framebuffer:
        """Progressive render of `n_passes` with one device sync at the end;
        always the monolithic pass (narrowing reads back a count per bounce)."""
        t0 = time.perf_counter()
        for _ in range(n_passes):
            self._one_pass(batch=True)
        self._sync()
        self.stats.setdefault("batch_times", []).append((n_passes, time.perf_counter() - t0))
        return self.fb

    def restart(self) -> None:
        """Invalidate accumulation (camera-move semantics); the next pass
        rebuilds the renderer, and with it the megakernel's tables and a
        stateful renderer's state from the view as it is then."""
        self.fb = Framebuffer.create(self.res_y, self.res_x, self.device)
        self.instance = 0
        self._pass = None
        self.renderer_state = None

    def image(self, exposure: float = 1.0, gamma: float = 2.2) -> np.ndarray:
        return to_rgba8(self.fb.composited, exposure, gamma).cpu().numpy()

    def hdr_image(self) -> np.ndarray:
        return self.fb.composited.cpu().numpy()

    def filtered_image(self, exposure: float = 1.0, gamma: float = 2.2,
                       method: str = "eaw") -> np.ndarray:
        """The denoised output, RGBA8 (context.py:457-473, the reference's
        kFiltered path); method eaw or xbl (render/denoise.py)."""
        from fermat_tpu_torch.render.denoise import denoise

        if self.gbuffer is None:
            raise ValueError("filtered_image needs a G-buffer: render at least one pass first")
        out = denoise(self.fb, self.gbuffer["normal"], self.gbuffer["position"],
                      self.gbuffer["miss"], self.view.camera, instance=self.instance - 1,
                      method=method)
        return to_rgba8(out, exposure, gamma).cpu().numpy()

    def rmse_vs(self, ref_hdr: np.ndarray) -> float:
        """RMSE of the accumulated image against a reference (context.py:475)."""
        ref = torch.as_tensor(np.asarray(ref_hdr, np.float32), device=self.device)
        return float(rmse(self.fb.composited, ref))

    def dump_speed_stats(self, detailed: bool = False) -> dict:
        """Pass-time stats and the ray rate from the `rays` counter
        (PathTracer::dump_speed_stats, pathtracer_impl.h:342-350). With
        `detailed` one more pass renders under torch.profiler and its time
        is split into the closest tracers' (rt_ms), the any-hit tracers'
        (shadow_rt_ms) and the rest (shade_ms) (context.py:478-523;
        utils/profiling.stage_split): on the card by device kernel, on the
        CPU by the tracer wrappers' record_function ranges. A profile, not a
        gate: CUPTI loses device records now and then."""
        times = self.stats.get("pass_times", [])
        if not times:
            return {}
        steady = times[1:] if len(times) > 1 else times
        mean = float(np.mean(steady))
        out = {"passes": len(times), "mean_pass_ms": 1e3 * mean,
               "first_pass_ms": 1e3 * times[0], "device": str(self.device)}
        if self.gbuffer is not None:
            rays = float(self.gbuffer["rays"])
            out["rays_per_pass"] = rays
            out["rays_per_s"] = rays / mean
        if detailed:
            from fermat_tpu_torch.utils.profiling import stage_split

            out.update(stage_split(lambda: self.render(1), self.device))
        return out
