"""The command-line batch renderer (fermat_tpu/utils/cli.py; main.cu:100-219):
progressive passes, the TGA, the RMSE against a reference image, the -diff
image compare, the -benchmark stats and the -save-intermediate
power-of-two snapshots.

Usage:
  python -m fermat_tpu_torch -pt -i scene.obj -c camera.txt -r 512 512 \\
      -passes 16 -o out.tga [-benchmark stats.json] [-cpu]

  -i FILE          the scene: .obj (with its .mtl), .ply, .stl, .off, .fa,
                   .pbrt, .gltf, .glb or .dae
  -c FILE          a camera file (eye, aim, up, fov); else the scene's own
                   camera, else one framing the mesh's bounding box
  -r W H           the resolution (a .pbrt scene's Film sets it when -r is
                   not given)
  -passes N        progressive passes (1)
  -o FILE          the output TGA (output.tga)
  -ref FILE        print the RMSE against this image after each batch
  -diff A B        only compare two images: print their RMSE and write
                   <-o's base>_diff.tga
  -benchmark FILE  write dump_speed_stats() as JSON, with the run's kernel
                   launches (every wrapper's count, none on the CPU)
  -save-intermediate   write <-o's base>_<passes>.tga at each power of two
  -seed N          the sampler's seed (0)
  -plugin MOD      import MOD and call MOD.register_plugin(), which
                   registers renderers (render.context.register_renderer)
  -opt KEY=VALUE   a renderer option (e.g. -opt max_path_length=8,
                   -opt tracer=mega, -opt narrow=1)
  -<renderer>      the renderer: -pt, -bpt, -mlt, -cmlt, -rpt, -pssmlt,
                   -psfpt, -ptrl, or one a plugin registered
  -cpu             render on the CPU with the plain PyTorch versions; the
                   default is the CUDA card, and without one the context
                   raises (the renderer never falls back to the CPU)
  -view            the progressive terminal viewer (render/viewer.py): one
                   pass a frame, keys from stdin (a pipe of scripted
                   bytes works; then -passes bounds the frames), then the
                   TGA of the last image

An unknown argument or a missing -i exits with code 2.
"""
from __future__ import annotations

import importlib
import json
import os
import sys
import time
from typing import List, Optional


def _parse_value(v: str):
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        return v


def _diff(paths, out_path: str) -> int:
    """-diff: the RMSE of two images and their normalized difference image."""
    import torch

    from fermat_tpu_torch.render.framebuffer import rmse
    from fermat_tpu_torch.utils.image import read_image, write_tga

    a, b = read_image(paths[0]), read_image(paths[1])
    r = float(rmse(torch.from_numpy(a), torch.from_numpy(b)))
    print(f"RMSE: {r:.6f}")
    fc = abs(a - b).mean(-1)
    base = os.path.splitext(out_path)[0]
    write_tga(base + "_diff.tga", (fc / max(fc.max(), 1e-6))[..., None].repeat(3, -1))
    return 0


def _load_scene(scene_path: str, res):
    """(mesh, camera or None, the RenderingContext.create lighting keywords,
    exposure, gamma, resolution) of a scene file."""
    from fermat_tpu_torch.scene.loaders.fa import load_fa, load_mesh_any

    ext = os.path.splitext(scene_path)[1].lower()
    light = dict(dir_lights=(), point_lights=(), env_radiance=(0.0, 0.0, 0.0), env_map=None)
    exposure, gamma = 1.0, 2.2
    if ext == ".fa":
        loaded = load_fa(scene_path, strict=False)
        mesh, camera = loaded.mesh, loaded.camera
        light["dir_lights"] = tuple(loaded.dir_lights)
    elif ext == ".pbrt":
        from fermat_tpu_torch.scene.loaders.pbrt import load_pbrt

        pb = load_pbrt(scene_path)
        mesh, camera = pb.mesh, pb.camera
        light.update(dir_lights=tuple(pb.dir_lights), point_lights=tuple(pb.point_lights),
                     env_radiance=pb.env_radiance, env_map=pb.env_map)
        exposure, gamma = pb.exposure, pb.gamma
        if res is None:
            res = pb.resolution
    else:
        mesh, camera = load_mesh_any(scene_path), None
    return mesh, camera, light, exposure, gamma, res or (512, 512)


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    scene_path = camera_path = ref_path = diff_paths = bench_path = None
    res = None
    renderer = "pt"
    passes = 1
    out_path = "output.tga"
    save_intermediate = False
    view_mode = False
    device = "cuda"
    seed = 0
    opts = {}

    from fermat_tpu_torch.render.context import _RENDERER_REGISTRY

    # plugins load first, so that their renderer flags parse
    for k, a in enumerate(argv):
        if a == "-plugin" and k + 1 < len(argv):
            importlib.import_module(argv[k + 1]).register_plugin()
            print(f"loaded plugin {argv[k + 1]}", file=sys.stderr)

    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-i":
            i += 1
            scene_path = argv[i]
        elif a == "-c":
            i += 1
            camera_path = argv[i]
        elif a == "-r":
            res = (int(argv[i + 1]), int(argv[i + 2]))
            i += 2
        elif a == "-passes":
            i += 1
            passes = int(argv[i])
        elif a == "-o":
            i += 1
            out_path = argv[i]
        elif a == "-ref":
            i += 1
            ref_path = argv[i]
        elif a == "-diff":
            diff_paths = (argv[i + 1], argv[i + 2])
            i += 2
        elif a == "-benchmark":
            i += 1
            bench_path = argv[i]
        elif a == "-save-intermediate":
            save_intermediate = True
        elif a == "-view":
            view_mode = True
        elif a == "-seed":
            i += 1
            seed = int(argv[i])
        elif a == "-cpu":
            device = "cpu"
        elif a == "-plugin":
            i += 1  # loaded above
        elif a == "-opt":
            i += 1
            k, v = argv[i].split("=", 1)
            opts[k] = _parse_value(v)
        elif a.startswith("-") and a[1:] in _RENDERER_REGISTRY:
            renderer = a[1:]
        else:
            print(f"unknown argument: {a}", file=sys.stderr)
            return 2
        i += 1

    if diff_paths is not None:
        return _diff(diff_paths, out_path)
    if scene_path is None:
        print("missing -i <scene>", file=sys.stderr)
        return 2

    from fermat_tpu_torch.core.camera import Camera, load_camera_file
    from fermat_tpu_torch.render.context import RenderingContext
    from fermat_tpu_torch.utils.image import read_image, write_tga

    mesh, camera, light, exposure, gamma, res = _load_scene(scene_path, res)
    if camera_path:
        camera = load_camera_file(camera_path)
    if camera is None:
        lo, hi = mesh.bbox()
        c = (lo + hi) / 2
        ext_len = float(max(hi - lo))
        camera = Camera.create((c[0], c[1], c[2] + 1.5 * ext_len), tuple(c), (0, 1, 0), 1.0)
        print("warning: no camera given; using bbox default", file=sys.stderr)
    print(f"scene: {mesh.n_triangles} triangles, {len(mesh.materials)} materials",
          file=sys.stderr)

    ctx = RenderingContext.create(
        mesh, camera, res[0], res[1], renderer=renderer, seed=seed,
        texture_dir=os.path.dirname(os.path.abspath(scene_path)), device=device,
        **light, **opts)

    ref_img = read_image(ref_path) if ref_path else None
    if view_mode:  # cli.py:196-207; `passes` bounds a session whose stdin is no terminal
        from fermat_tpu_torch.render.viewer import Viewer

        frames = Viewer(ctx).run(passes_per_frame=1,
                                 max_frames=None if sys.stdin.isatty() else max(passes, 1))
        write_tga(out_path, ctx.image(exposure, gamma))
        print(f"viewer: {frames} frames, wrote {out_path}", file=sys.stderr)
        return 0
    t0 = time.time()
    next_dump = 1
    done = 0
    while done < passes:
        step = (min(next_dump - done, passes - done) if save_intermediate
                else passes - done)
        ctx.render(step)
        done += step
        if save_intermediate and done == next_dump:
            base = os.path.splitext(out_path)[0]
            write_tga(f"{base}_{done:05d}.tga", ctx.image(exposure, gamma))
            next_dump *= 2
        if ref_img is not None:
            print(f"pass {done}: RMSE {ctx.rmse_vs(ref_img):.6f}", file=sys.stderr)

    elapsed = time.time() - t0
    write_tga(out_path, ctx.image(exposure, gamma))
    print(f"wrote {out_path} ({passes} passes, {elapsed:.2f}s) on {ctx.device}",
          file=sys.stderr)

    if bench_path:
        from fermat_tpu_torch.ops._cuda import CudaKernel

        stats = ctx.dump_speed_stats()
        stats["launches"] = {k.name: k.launches for k in CudaKernel.every if k.launches}
        stats["elapsed_s"] = elapsed
        stats["resolution"] = list(res)
        stats["renderer"] = renderer
        with open(bench_path, "w") as f:
            json.dump(stats, f, indent=2)
        print(f"wrote {bench_path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
