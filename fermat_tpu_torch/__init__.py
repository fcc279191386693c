"""fermat_tpu_torch — the PyTorch/CUDA port of fermat_tpu for NVIDIA Hopper.

The JAX package `fermat_tpu` is the reference; this package mirrors its
layout (core/, scene/, bsdf/, accel/, ops/, integrators/, render/,
parallel/, utils/) and
imports neither JAX nor anything of `fermat_tpu`.

Devices are explicit: entry points run on "cuda" unless the caller passes
device="cpu". On the CPU every hand-written kernel is replaced by its plain
PyTorch version (the tensor's device decides); on a CUDA tensor a wrapper
launches its kernel or raises.

Ported so far: progressive path tracing through RenderingContext, on scenes
of at most 4096 triangles with the dense tracer (ops/trace.py) and on larger
ones with the cluster-table frontier tracer (ops/frontier_trace.py) and the
fused light pick (ops/cdf_gather.py), monolithic or through the narrowing
driver (render option narrow=1); tracer="cluster" (ops/cluster_trace.py)
and tracer="binned" (ops/binned_trace.py) trace the same function over the
same table at any size. Every table fetch goes through the row gather
(ops/gather.py). With tracer="mega", on scenes within the megakernel's caps
(128 triangles, 32 materials, 32 emitters), a pass is one launch of the
whole-pass megakernel, and the replay-gradient train step is another
(ops/pt_mega.py). The PT pass carries the JAX package's light model:
mesh emitters, directional and point lights, analytic disk/rect area
lights, a lat-long environment map with importance-sampled NEE and MIS, and
the shadow sets of materials flagged FLAG_SHADOW_*_IGNORE, textures, and
every PTOptions field of JAX's PT pass: VPL NEE, the LTC glossy lobe, queue
compaction, the detach and debug switches, and tracer="bvh" (the skip-link
BVH walk, ops/bvh_trace.py). The bidirectional path tracer
(integrators/bpt.py), PSSMLT (integrators/pssmlt.py), path-space MLT
(integrators/mlt.py), charted MLT (integrators/cmlt.py, its chart swaps
through bsdf/inversion.py), the path-space-filtering tracer
(integrators/psfpt.py) and the clustered-RL path tracer
(integrators/ptrl.py), and the reuse path tracer (integrators/rpt.py)
render through the same tracers and gathers: JAX's eight renderers. JAX's
tracer names "brute" and "pallas" take the dense route. Every kernel is
hand-written CUDA.

The port covers every module of fermat_tpu: besides the above, the glTF
and COLLADA loaders, the compressed mesh attributes (scene/compression.py),
the native C++ host runtime for large OBJ files and BVH builds
(utils/native.py, built from native/fermat_native.cpp), the uv BVH and uv
charts (scene/uv_bvh.py), the EAW and XBL denoisers
(RenderingContext.filtered_image, render/denoise.py), checkpoints
(render/checkpoint.py), the terminal viewer (render/viewer.py), multi-device
rendering over torch.distributed (parallel/mesh.py) and the library
modules core/sh.py, core/distributions.py, accel/kdtree.py and
accel/lbvh.py. None of these reaches a Pallas kernel in JAX; here they are
plain tensor or host code.

The command line renders a scene file (OBJ+MTL, PLY, STL, OFF, .fa,
.pbrt, .gltf, .glb, .dae; scene/loaders/) on the card, or on the CPU with
-cpu, and -view opens the progressive terminal viewer:

    python -m fermat_tpu_torch -pt -i scene.obj -c camera.txt -r 512 512 \
        -passes 16 -o out.tga [-benchmark stats.json] [-cpu] [-view]

(utils/cli.py lists every flag; -rpt, -bpt, ... pick the renderer).
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """torch.device for `device`; raises when CUDA is asked for and absent
    (the port never carries on on the CPU behind the caller's back)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise NotImplementedError(f"device type {dev.type!r}")
    return dev
