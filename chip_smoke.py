#!/usr/bin/env python3
"""Drive fermat_tpu_torch on one CUDA card and hold it to its references.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, one line each, in order (any failure raises and exits non-zero; no
result is printed then):
  1. device   — a CUDA card must be present; prints its name and power limit;
  2. build    — compiles the port's CUDA sources (fermat_tpu_torch/ops/csrc:
                trace, gather, mega, frontier, cdf_gather, cluster, binned,
                sub, bvh) for sm_90a, one nvcc per source, all started
                together;
  3. kernels  — each kernel against its plain PyTorch version on the card:
                trace_closest / trace_any on 262,144 random rays against the
                CornellBox and random_soup(4096) (both also with every 7th
                lane active), gather_rows on (36, 52),
                (36, 23) and (4096, 52) tables with out-of-range indices;
                all bit-equal (the kernels are built with --fmad=false);
                K2's backward (gather_rows_bwd, K2b) at the AD path's two
                shapes, (36, 52) x 262,144 lanes (its deterministic shared-
                memory mode; two launches give the same bits) and
                (99,636, 52) x 1,433,600 lanes (its atomic mode), within
                ops/gather.py's BWD_RTOL of its plain version;
  3b. mega    — the megakernels against their plain versions on the card at
                128x128, 6 bounces: K3a (mega_forward) with the scene's lobes,
                all four lobes, all four with clearcoat, and all four with
                clearcoat on glass_cornell_box (rays equal, every
                channel within image_close, hit flag equal on >= 99.9% of
                pixels; prints the fraction of bit-equal pixels); K3b
                (mega_grad) with the scene's and all lobes for the adjoint of
                an MSE against 0.2, also on glass_cornell_box (within 1e-3
                of max|g|);
  3c. large   — the large-scene kernels against their plain versions:
                trace_closest_frontier / trace_any_frontier (K5a/K5b) on
                65,536 random rays against big_room(8300) and
                random_soup(4096) and on 256x256 camera rays of big_room,
                and the sort key they co-sort those rays by against its
                plain version; cdf_pick_rows (K4) on big_room's emissive subset and on a
                544-row table, NaN and out-of-range u included; all
                bit-equal; on the same rays the cluster tracer (K6a/K6b)
                and the binned tracer (K7a/K7b, also with a queue of one
                key and work items of 32 rays) bit-equal to the shared
                plain versions (t, tri,
                u, v; occlusion) and to K5's (t, tri) and occlusion; and
                the subcluster tracer (K8a/K8b) over the 32-triangle
                subcluster table of each scene bit-equal to its plain
                versions and to K5's on the same rays;
  4. main     — progressive PT through RenderingContext on cuda: glossy
                CornellBox, 512x512, max_path_length=6; best of 3 batches of
                8 passes after a warm-up pass; ms/pass and Mrays/s (closest +
                shadow rays actually traced, as bench.py counts them); the
                kernel launch counts of those passes;
  4b. mega    — the same render with tracer="mega": ms/pass, Mrays/s, the
                launch counts (mega_forward once per pass, no K1/K2), one
                pass under torch.profiler;
  4c. train   — bench.py's train step: a K3a pass, MSE against a zero
                target, adjoint 2(img - target)/(3N), K3b; best of 3 steps;
                ms/step and train Mrays/s (forward rays / step wall time);
  4d. large   — the big_room stage of tools/bench_secondaries.py through
                RenderingContext on cuda: big_room(8300) (99,636
                triangles), 1600x896, max_path_length=6, the scene's lobes;
                the monolithic pass (render_batch) and narrow=1 (render,
                NarrowPass); best of 3 batches of 3 passes after a warm-up
                pass; ms/pass, Mrays/s, launch counts (6 of each of K5a,
                K5b and K4 per monolithic pass; no K1 or K3), the narrowing
                widths, one pass of each under torch.profiler;
  4e. tracers — the same big_room pass through RenderingContext with
                tracer="cluster" and tracer="binned" (render_batch): ms/pass,
                Mrays/s, launches (6 K6a + 6 K6b a pass, or 6 K7a and 6 K7b
                launch groups with their rounds, host readbacks and scans;
                no K5), one profiled pass each (K7's in-pass time by
                kernel); then one 400x224 pass with each tracer and one with
                the plain versions forced in their place, all three
                bit-equal (every channel, first hits, rays), and the
                frontier pass beside them within the golden tolerances;
  4f. AD     — the differentiable pass (render_pass under
                torch.autograd, K2b its shade fetch's backward) as
                bench.py:152-163 builds its train step: an MSE against a
                zero target, d loss / d materials.diffuse (a leaf (M, 3)
                tensor). The 512x512 6-bounce CornellBox dense pass, its
                gradient held within AD_K3B_RTOL of max|g| of K3b's on the
                same instance and adjoint; big_room(400) at the
                configuration of tests/golden/torch_port_grad_16.npz held
                to its stored jax.grad within AD_GOLDEN_RTOL; then
                big_room(8300) at 1600x896, 6 bounces, tracer="frontier":
                a warm-up step, best of 2 timed steps (the last held within
                AD_PLAIN_RTOL to the same step with K2b's plain version),
                one profiled step; ms/step, train Mrays/s (forward rays /
                step wall time), peak device memory
                (max_memory_allocated), idle share, launches per step;
  4g. lit    — the PT pass's full light model through RenderingContext
                (dir_lights, point_lights, env_map) and SceneView.build
                (area_light_defs), with a 2048x1024 float32 sky made from a
                fixed seed (its sample() picking the same texel on the card
                as on the CPU on 1,048,576 lanes): the glossy CornellBox with the blocker panel
                flagged FLAG_SHADOW_DIRECT_IGNORE (one shadow set), an
                analytic disk and rect, a point and a directional light,
                512x512, 6 bounces (K1a, K1b also over the set, K2); and
                big_room(8300) 1600x896, 6 bounces, with the sky, a
                directional sun through the open side and the clutter
                flagged FLAG_SHADOW_INDIRECT_IGNORE (K5a; K5b at bounce 0;
                K1b over the 36-triangle set at the later bounces; K4, K2),
                monolithic and narrow=1: ms/pass, Mrays/s (best of 3
                batches of 2 passes after a warm-up), launches per pass,
                one profiled pass each (busy, idle share, the route
                kernels' time a launch in it); tracer="mega" on the lit CornellBox raises; one
                pass with the kernels and one with the plain versions
                forced (512x512; big_room at 400x224): rays equal, every
                channel bit-equal; at the first shadow launch on each
                set, K1b on its soup and K5b on its cluster table
                bit-equal to their plain versions; the light-model golden
                (tests/golden/torch_port_lights_24.npz, JAX on the CPU,
                configurations A-D, D also with tracer="auto") within the
                tolerances of tests/test_torch_pt.py, its jax.grad cases
                within AD_GOLDEN_RTOL;
  4h. textured — textured surfaces and emitters, their gradients and the
                blue-noise sampler: the glossy CornellBox with seeded 8-bit
                TGA maps (procedural.write_cornell_textures at 1024 texels:
                diffuse on the walls and floor, the white one 999x767, a
                specular map on the boxes, an emissive map on the light;
                a 204 MiB atlas), 512x512, 6 bounces, bilinear, trilinear
                and sampler="bluenoise" (K1a, K1b, K2 also for the atlas's
                metadata rows and the shift table); the bathroom stand-in
                (procedural.bathroom_standin(8300), 99,612 triangles, 12
                seeded materials with 16 1024-texel TGAs, a 768 MiB atlas),
                1600x896, 6 bounces, monolithic and narrow=1 (K5a, K5b, K4,
                K2): ms/pass, Mrays/s (best of 3 batches of 2 passes after a
                warm-up), launches per pass, one profiled pass each, the
                atlas's bytes and the cell's peak memory; tracer="mega" on
                the textured CornellBox raises; one pass with the kernels
                and one with the plain versions forced (the CornellBox at
                512x512 bilinear and trilinear with blue noise, the
                bathroom at 400x224): rays equal, every channel, both
                albedos and the first hits bit-equal; the blue-noise
                sequence on 1,048,576 lanes equal to the CPU's; one AD step
                d loss / d texels at 512x512 (ms/step, peak memory); the
                texture golden (tests/golden/torch_port_textures_24.npz,
                JAX on the CPU, T_A-T_E) within the tolerances of
                tests/test_torch_pt.py and its jax.grad cases (the texels
                of T_C, at JAX's first-hit uv, and of C2; the emissive
                through a light table built on the card) within
                AD_GOLDEN_RTOL;
  4i. options — the remaining PT options and the BVH walk (`options_phase`):
                the glossy CornellBox, 512x512, 6 bounces, through
                RenderingContext with nee="vpl", glossy_model="ltc",
                queue_compaction=True and detach_nee=True (K1a, K1b, K2;
                the VPL pick is K2 too); big_room(8300) 1600x896, 6 bounces,
                with tracer="frontier" and tracer="bvh" on the same view
                (the walk, csrc/bvh.cu; K4, K2), its BVH built on the host
                (the seconds printed): ms/pass, Mrays/s, launches per pass,
                one profiled pass each (device kernels, busy, idle share);
                each CornellBox cell bit-equal to its forced plain versions
                (the BVH walk's and the VPL pick's included), the
                compaction cell also to the masked pass; on the bvh pass's
                1,433,600 camera rays the walk's t bit-equal to K5a's (tri
                too, except where two triangles tie in t); phase 6 holds the
                walk's kernels bit-equal to their plain version on every ray
                of bounces 0 and 1;
  4j. bpt    — the bidirectional path tracer and PSSMLT (`bpt_phase`):
                BPT through RenderingContext on the glossy CornellBox,
                512x512, max_path_length=6, light tracing on (K1a 10, K1b
                11, K2 a pass), and on big_room(8300) 1600x896 with
                tracer="auto" (K5a 10, K5b 11 with their sort keys, K2;
                (u, v) derived from the ray): ms/pass, Mrays/s (BPT's own
                ray counter), launches per pass, one profiled pass each
                (device kernels, busy, idle share); each held to its forced
                plain versions (the CornellBox at 512x512, big_room at
                400x224): rays equal, eye radiance bit-equal, the splat
                image within BPT_SPLAT_RTOL of its max (index_add_ adds in
                no fixed order); PSSMLT on the CornellBox at 512x512, one
                chain a pixel, path_space="bpt" (init_state ms and peak
                memory, ms a step, mutations a second, the acceptance rate,
                launches per step, one profiled step) and "pt" (init and
                one step): one step's chain state (u, i_lum, pixel, key)
                bit-equal to its forced plain versions, the splat within
                BPT_SPLAT_RTOL of its max; the BPT and PSSMLT golden
                (tests/golden/torch_port_bpt_24.npz, JAX on the CPU; big_room
                with tracer="auto" and "bvh"; PSSMLT's first step from
                JAX's stored chains) within the tolerances of
                tests/test_torch_bpt.py;
  4k. psf    — the path-space-filtering tracer and the clustered-RL path
                tracer (`psf_phase`): psfpt and ptrl (sampler="vtl") through
                RenderingContext, max_path_length=6, on the glossy
                CornellBox 512x512 (K1a 6, K1b 6 a pass; K2 17 psfpt, 12
                ptrl: the shade rows, the pdf and light rows or the
                16-column VTL rows) and on big_room(8300) 1600x896 with
                tracer="auto" (K5a 6, K5b 6 with their sort keys; psfpt K4 6
                and K2 11, ptrl K2 12); PSF_PASSES passes a cell from a
                fresh state, so that ptrl's adapt_every=8 adapts once and
                the last pass runs on the remapped Q: ms/pass (the median of
                the passes after the first), Mrays/s, launches per pass,
                one profiled pass (device kernels, busy, idle share), peak
                memory; ptrl's host VTL and cut build and its adaptation
                timed apart. Each cell's pass from its state held to its
                forced plain versions (the CornellBox at 512x512, big_room
                at 400x224): rays, psfpt's PSF slots and keys and the owner
                table bit-equal, its cell sums and image within PSF_RTOL of
                their max (index_add_ adds in no fixed order on the card);
                ptrl's image bit-equal (Q is fixed within a pass), its new
                Q within PSF_RTOL of max; the golden
                (tests/golden/torch_port_psf_24.npz, JAX on the CPU) on the
                card within the tolerances of tests/test_torch_psf.py;
  4l. mlt    — path-space MLT and charted MLT (`mlt_phase`): mlt and cmlt
                through RenderingContext with default options
                (max_path_length=6; mlt 12 steps a pass, an ST swap every
                4th; cmlt 8 seed rounds, a chart swap every 3rd step), one
                chain a pixel, on the glossy CornellBox 512x512 (K1a, K1b,
                K2) and on big_room(8300) 1600x896 with tracer="auto" (K5a,
                K5b with their sort keys, K2): MLT_PASSES passes or
                CMLT_STEPS steps a cell, each pass's tracer launches held to
                the count its options give, ms/pass, Mrays/s (the renderer's
                own ray counter), one profiled pass (device kernels, busy,
                idle share), peak memory (reckoned first on big_room),
                cmlt's init_state ms; mlt's presample and steps 0-3 and
                cmlt's steps 0-2 held to their forced plain versions (the
                CornellBox at 512x512, big_room at 400x224): chain states
                bit-equal, rays equal, splats within BPT_SPLAT_RTOL of their
                max (index_add_ adds in no fixed order), with the share of
                chains that moved each step; the golden
                (tests/golden/torch_port_mlt_24.npz, JAX on the CPU; each
                step from JAX's stored state) within the tolerances of
                tests/test_torch_mlt.py; convergence to PT on JAX's test
                scene at 32x32 (mlt 64 passes of 8 steps, cmlt 512 passes,
                mlt with st_swap_frequency=2; PT 192 passes, rr=False)
                within the bounds of tests/test_mlt.py and test_cmlt.py;
  4m. rpt    — the reuse path tracer (`rpt_phase`) through
                RenderingContext, max_path_length=6, 4x4 tiles, two reuse
                shadow samples, on the glossy CornellBox 512x512 (K1a 6,
                K1b 8, K2) and on big_room(8300) 1600x896 (K5a 6, K5b 8
                with their sort keys, K4 6, K2; 22.9 M (pixel, VPL) pairs):
                a warm-up pass, RPT_PASSES passes with their launches held
                to those counts, ms/pass, Mrays/s by its own ray counter,
                peak memory, one profiled pass (device kernels, busy, idle
                share, the kernels' us a launch); one pass with the kernels
                and one with every plain version forced (the CornellBox at
                512x512, big_room at 400x224): rays, rays per pixel and
                radiance bit-equal; tracer="brute" and "pallas" (JAX's
                names): K1a 6 a PT pass, bit-equal to tracer="dense"; JAX's
                convergence bounds at 32x32, each render a process of its own
                (RPT_CONV_CASES): rpt (96 passes) to PT (160, rr=False) on
                cornell_box(light_scale=0.5, light_size=2.0), channel means
                within 6% and the 4x4-pooled error under 0.12
                (tests/test_rpt.py); rpt to PT on the env-lit floor, means
                within 6% (tests/test_envmap.py);
  4n. cli    — `python -m fermat_tpu_torch` as two processes on the card
                (`cli_phase`), on a CornellBox OBJ+MTL and a camera file
                written at run time: -pt at 512x512, 4 passes, and -rpt at
                64x64, 2 passes, each with -benchmark; each exits 0 and
                writes its TGA, its -benchmark JSON has rays_per_s and a
                cuda device; the -pt TGA equals, byte for byte, that of a
                RenderingContext in this process on the loaded scene with
                the same seed and passes; dump_speed_stats(detailed=True)
                there gives rt_ms + shadow_rt_ms + shade_ms > 0;
  4o. slice  — the last slice's modules (`slice_phase`): big_room(8300)
                written as an OBJ of ~8 MiB (scene/loaders/obj.save_obj),
                its native parse and native BVH build timed against the
                Python parser and builder on the same file (equal meshes),
                the library built into fermat_tpu_torch/_build/; five
                processes of `python -m fermat_tpu_torch -pt` on the card
                meanwhile: that OBJ at 1600x896, 3 passes (-benchmark, with
                the run's launches), the glossy
                CornellBox written as .gltf, .glb and .dae at 512x512 (each
                TGA equal, byte for byte, to the in-process context's on
                the loaded mesh), and -view on the .glb fed a scripted key
                stream through a pipe (TAB through all 14 shading modes,
                `filtered` included, a step forward, q: 15 frames);
                build_lbvh_for_mesh on big_room(8300) (best of 3) equal to
                its CPU build array for array; knn (k=4) on 2^20 queries
                over 2^16 points, its first 2^11 held to the CPU's;
                filtered_image with eaw and xbl on the CornellBox at
                512x512 and big_room at 1600x896 (best of 3), the denoised
                images held to the same call on the CPU within
                DENOISE_RTOL / DENOISE_ATOL, every pixel for EAW and 99%
                for XBL (big_room's at 400x224);
                checkpoints of pt (512x512) and pssmlt (256x256): saved
                after 2 passes, restored into a new context and rendered 1
                more, equal to 3 passes (pssmlt: its chains bit-equal, its
                splatted channels within BPT_SPLAT_RTOL of their max); render_pass_sharded,
                render_bpt_pass_sharded and train_step_sharded at world
                size 1 on nccl equal to the unsharded pass and step, the
                sharded pass's launches counted and its time beside the
                unsharded pass's (5 rounds, alternating, after the
                processes ended);
  5. parity   — one 512x512 pass with the kernels and one with the plain
                versions forced in their place: equal `rays`, equal images;
                then the golden configuration (tests/golden/
                torch_port_cornell_32.npz, the JAX package's CPU output and
                scene view) on the card's kernel path, within the tolerances
                of tests/test_torch_pt.py;
  5b. parity  — K3a at 512x512 against _mega_plain (rays equal, images
                close), and K3b at 512x512 on the train step's own adjoint
                against _mega_grad_plain (within 1e-3 of max|g|; two
                launches give the same bits): the kernels
                line's max_abs_err is from these main-path shapes; the card's
                K3a and K3b at every configuration of
                tests/golden/torch_port_mega_32.npz (the JAX megakernel's CPU
                output), within the tolerances of tests/test_torch_mega.py;
  5c. large   — the big_room golden (tests/golden/torch_port_bigroom_24.npz,
                the JAX package's frontier pass on the CPU) on the card
                within the tolerances of tests/test_torch_bigroom.py, and one
                400x224 big_room pass with the kernels and one with the
                plain versions forced in their place: equal `rays`, equal
                first hits, close images; the JAX goldens of the cluster
                and binned passes (tests/golden/
                torch_port_bigroom_cluster_24.npz) on the card with each
                tracer, within the same tolerances;
  6. timing   — every launch of one main-path pass is held to its plain
                version (K1a's t/u/v bits and tri, K2 bit-equal, K1b equal)
                and replayed alone (device_ms:
                CUDA events around 20 replays, K7's groups 5, queued
                behind a spin kernel, median and min-max, warm and cold
                L2): device
                time of the kernel, of its plain version and (gather only) of
                `index_select`, beside the bound from the bytes and
                operations the inputs need; K3a and K3b at 512x512 likewise
                (the train step's instance and adjoint),
                their bound from the 27 output lanes (K3b: the adjoint in,
                the partials out) plus the tables, and the FP32 operations
                of the pass's events (MEGA_FLOPS: 46 flops per ray-triangle
                test, closest rays testing every triangle and shadow rays up
                to their first hit, plus each vertex's shading, NEE sample,
                scatter and K3b term, the events counted from the plain
                version's pass); the tests alone (a tracing-only lower
                bound) and the bound without E(|w.z|)'s 32-knot sums are
                logged beside it, not in the kernels line. K4 and K5 at the
                inputs of one monolithic big_room pass, every launch
                replayed, their plain versions too, and every launch's
                output held to its plain version's (bit-equal; the kernels
                line's max_abs_err for K4/K5 is from these comparisons);
                K5's kernel alone, its co-sort and its whole wrapper timed
                apart, beside its device time in phase 4d's profiled pass
                (K3a's beside 4b's);
                K2 also at the 11 launches of the same big_room pass, each
                held bit-equal to its plain version, with its plain
                version's and index_select's times and its bytes bound
                (the gather_rows row's at_big_room); K1a's time at each
                launch of the CornellBox pass beside its active lanes;
                K5's bound counts 46 flops for every real triangle of every
                cluster a ray must enter (see phase 6's code), K4's is its
                bytes; each plain version runs once a launch, under the
                profiler. K6 and K7 at the inputs of one phase 4e pass,
                checked bit-equal to the frontier pass's (the tracers
                compute one function), so every launch is held to the plain
                answer that K5 was held to, and the bound is K5's; K7's
                time is the device time of one launch group (one wrapper
                call: every round's scan, sort and test), split into scan,
                sort, test and the rest, with its rounds and wall time.
                The dense kernels' device time a launch inside phase 4's
                profiled pass, and K2b's inside one profiled CornellBox AD
                step (in_pass_ms), beside their replays.
                K2b at every launch of the two 4f steps (the CornellBox's
                in the kernels line, big_room's beside it), its plain
                version and index_add_ into fresh zeros (what index_select's
                autograd runs) timed too, each launch held to its plain
                version; bound: its bytes (idx and the cotangent in,
                d_table out). K8a/K8b driven through trace_closest_sub /
                trace_any_sub at the rays of every K5 launch of the big_room
                pass above (K8 is not routed by render_pass; its entry
                points are its path), each launch held bit-equal to K5's
                plain answer there, and timed; K8's own plain version at
                the first launch of each kind (bounce 0), held bit-equal
                and timed there; bound: 46 flops a test over K8's own
                leaves, with K5's bound on the same rays beside it.
                The BVH walk (walk_rows) at the rays of the first two K5a
                and K5b launches of the same big_room pass (bounces 0 and
                1) over phase 4i's BVH: each launch bit-equal to its plain
                version and to K5's plain answer, timed, the plain version
                once a launch with its counters (node visits and triangle
                tests per ray, mean and max, printed); bound, per launch:
                the rays' bytes and the tree once, or 24 flops a visit and
                46 a test over the work the answer needs, counted as K5's
                is: the walk of each closest ray with its final t from the
                start (the boxes entered before it, every triangle of each
                such leaf), an unoccluded shadow ray's whole walk, one
                visit and one test for an occluded one; K5's bound on the
                same rays beside it; time, bound and counts each launch.
Then the card's nvidia-smi line, one JSON line {"kernels": [...]} (each row
also holds its launches per pass on phase 4g's lit, 4h's textured, 4i's
options, 4j's BPT and PSSMLT, 4k's psfpt and ptrl, 4l's mlt and cmlt and
4m's rpt paths and its device time a launch inside their profiled passes),
and last
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
RES, MPL, PASSES, REPS = 512, 6, 8, 3
N_RAYS = 262_144
# the big_room stage of tools/bench_secondaries.py; fewer passes per batch
BIG_BOXES, BIG_W, BIG_H, BIG_PASSES = 8300, 1600, 896, 3
PLAIN_W, PLAIN_H = 400, 224  # the big_room pass held to the forced plain versions
N_LARGE = 65_536
MEGA_RES = 128  # megakernel-vs-plain comparisons (the plain pass is eager PyTorch)
ALL_LOBES = (True, True, True, True)
# FP32 arithmetic operations of one Moller-Trumbore ray-triangle test as
# written in ops/trace.py:mt_test, the order of ops/csrc/trace.cu:record_test
# (comparisons not counted)
FLOPS_PER_TEST = 46
# FP32 operations of K3a/K3b per event, counted from ops/csrc/mega.cu's
# __device__ functions (+, -, *, /, sqrtf, rsqrtf, sinf, cosf one each;
# comparisons, clamps, fabsf, selects and integer hashing not counted) for
# the main path's option switches (mega.cu MEGA_MAIN_SWITCHES: the diffuse
# and glossy reflection lobes, no clearcoat, NEE and MIS at every vertex, RR),
# each term once where a vertex shares it (E(|wi.z|) and the
# lobe-selection probabilities once a vertex; K3b's d f / d diffuse from the
# lobe values f was built from); PERF.md section 6 lists the terms of each.
# MEGA_FLOPS_SOURCE is mega_source_digest() of the mega.cu they were counted
# from: mega_ops (and tests/test_torch_mega.py) fail when the device code
# changes, until it is recounted and the digest set anew
MEGA_FLOPS = {
    "camera": 35,  # begin_path: 2 samples, the film point, the direction, normalize
    "vertex": 207,  # a hit: position, shading normal, frame_of, to_local 75; vertex_terms 132
    "gbuffer": 10,  # the first vertex's uv
    "emit_first": 9,  # the first vertex's emission, routed
    "emit": 22,  # a later vertex's emission with its MIS weight
    "nee": 342,  # sample_3d, the light point, wo, to_local 56; f_split 275; pdf, MIS 11
    "shadow": 15,  # an able shadow ray's origin and t_lim (its tests counted apart)
    "lit_first": 20,  # an unoccluded first-vertex NEE term, split into two channels
    "lit": 17,  # a later one
    "scatter": 341,  # sample_3d 9, bsdf_sample 298 (diffuse lobe), to_world, origin 34
    "rr": 7,  # Russian roulette's sample and 1/q
    "g_miss": 6,  # K3b: the adjoint-weighted environment term
    "g_emit": 9,  # K3b: the adjoint-weighted emission term
    "g_nee": 21,  # K3b: kd/f and the NEE vertex's own term (add_g counted apart)
    "g_u": 9,  # K3b: a surviving vertex's kd/f into U
}
MEGA_FLOPS_PER_MAT = 6  # K3b add_g: 3 mul + 3 add per material at each miss, emission, lit NEE
# e_pwl's 32-knot sum (3 a knot), inside "vertex" (E(|wi.z|)), "nee" and
# "scatter" (E(|wo.z|)); reported apart, the bound without it beside the bound
MEGA_FLOPS_PWL = 96
MEGA_FLOPS_SOURCE = "b7dc1808c0270e53"
# published H100 peaks (NVIDIA data sheets): memory bytes/s, FP32 (non-tensor) flop/s
PEAKS = {"SXM": (3.35e12, 67e12), "PCIe": (2.0e12, 51e12), "NVL": (3.9e12, 60e12)}
# phase 6: replays a kernel is timed over, and the bytes written between
# replays for its cold-L2 figure (the H100's L2 is 50 MB)
REPLAYS = 20
# K7's launch groups (a trace each, its batches of rounds read back to the
# host) are timed over fewer replays
BINNED_REPLAYS = 5
FLUSH_BYTES = 128 * 2 ** 20
SPIN_CYCLES = 50_000_000  # ~25 ms at the H100's 1.98 GHz boost clock
_FLUSH = None
# phase 4f, of max|g|: the CornellBox AD gradient against K3b's (measured
# 1.12e-05 on an H100: on a few pixels the card's eager NEE arithmetic and
# mega.cu's round differently and a shadow ray or light pick flips, see
# ROADMAP Queue 3); big_room(400) against the stored jax.grad golden (the
# tolerance of tests/test_torch_grad.py; measured 1.9e-07); the big_room
# 1600x896 gradient against the same step with K2b's plain version (K2b's
# atomic mode sums in no fixed order; measured 6.5e-06)
AD_K3B_RTOL = 1e-4
AD_GOLDEN_RTOL = 1e-5
AD_PLAIN_RTOL = 1e-4
# phase 4g, the lit passes: a 2048x1024 float32 sky (25 MB, a common 2K
# HDRI's size), passes a batch of the lit CornellBox, and its lights: an
# analytic disk and rect under the blocker panel, a point light, and
# directional lights entering through the open side of each room
ENV_W, ENV_H = 2048, 1024
LIT_PASSES = 2  # a batch, both lit scenes (the lit CornellBox's pass is host-bound, ~1 s)
# device kernel names of the route kernels, for their time inside a profiled lit pass
# captures of one profiled pass before its expected kernels are given up
# (profile_one_pass)
PROFILE_TRIES = 3
LIT_IN_PASS = {"trace_closest": "closest_kernel", "trace_any": "any_kernel",
               "gather_rows": "gather_rows_kernel", "trace_closest_frontier": "trace_kernel<true>",
               "trace_any_frontier": "trace_kernel<false>", "cdf_pick_rows": "pick_kernel",
               "trace_closest_bvh": "walk_kernel<false>", "trace_any_bvh": "walk_kernel<true>"}
LIT_AREA = [dict(kind="disk", pos=(-0.45, 1.75, 0.25), normal=(0.15, -1.0, 0.1),
                 color=(6.0, 5.0, 4.0), radius=0.25),
            dict(kind="rect", pos=(0.45, 1.6, -0.35), normal=(-0.2, -1.0, 0.15),
                 color=(3.0, 4.0, 5.0), u_extent=0.3, v_extent=0.2)]
LIT_POINT = [((0.3, 1.2, 0.5), (1.5, 1.2, 0.9))]
LIT_DIR = ((0.25, -0.5, -1.0), (0.8, 0.7, 0.6))
LIT_SUN = ((0.3, -0.6, -1.0), (3.0, 2.8, 2.5))
# phase 4h, the textured passes: the maps' size (bathroom2's textures are
# 1024 and 2048 texels a side) and passes a batch
TEX_SIZE = 1024
TEX_PASSES = 2
# phase 4i: the remaining PT options on the CornellBox, and the BVH walk
OPT_CELLS = {"vpl": {"nee": "vpl"}, "ltc": {"glossy_model": "ltc"},
             "compaction": {"queue_compaction": True}, "detach_nee": {"detach_nee": True}}
OPT_PASSES = 2
# phase 4j: BPT passes and PSSMLT steps a batch, and the splat image's
# tolerance against the plain versions, of its max (index_add_ adds in no
# fixed order on the card)
BPT_PASSES, PSSMLT_STEPS, BPT_SPLAT_RTOL = 1, 1, 1e-5
# phase 4k: passes a psfpt or ptrl cell (ptrl's default adapt_every=8
# adapts once, before pass 8), and the tolerance of psfpt's cell sums and
# image and of ptrl's new Q against the plain versions, of their max
# (index_add_ adds in no fixed order on the card)
PSF_PASSES, PSF_RTOL = 9, 1e-5
# phase 4l: mlt passes and cmlt steps a cell (a cmlt pass is one step; step
# 2 is a chart swap), and the side of the convergence checks' images (JAX's
# tests/test_mlt.py and test_cmlt.py); the splats are held to the plain
# versions within BPT_SPLAT_RTOL
MLT_PASSES, CMLT_STEPS, CONV_RES = 2, 3, 32
# the convergence renders, each a process of its own: tag -> (renderer,
# passes, options beyond max_path_length=4), and a process's time limit (s)
CONV_CASES = {"pt": ("pt", 192, {"rr": False}), "mlt": ("mlt", 64, {"steps_per_pass": 8}),
              "cmlt": ("cmlt", 512, {}),
              "mlt_swap2": ("mlt", 64, {"steps_per_pass": 8, "st_swap_frequency": 2})}
CONV_TIMEOUT = 400
# phase 4m: rpt passes a cell, and its convergence renders at CONV_RES
# (JAX's tests/test_rpt.py:34-52 on the CornellBox, max_path_length=4,
# rr=False; tests/test_envmap.py:216-239 on the env-lit floor,
# max_path_length=2), each a process of its own: tag -> (renderer, passes,
# scene, options); the floor's map is ENV_FLOOR's value on an 8x16 grid
RPT_PASSES = 2
RPT_CONV_CASES = {"rpt_pt": ("pt", 160, "cornell", {"max_path_length": 4, "rr": False}),
                  "rpt": ("rpt", 96, "cornell", {"max_path_length": 4, "rr": False}),
                  "env_pt": ("pt", 8, "floor", {"max_path_length": 2}),
                  "env_rpt": ("rpt", 8, "floor", {"max_path_length": 2})}
ENV_FLOOR = 0.8
# phase 4n: the command line's passes at RES x RES, and the -rpt run's side
CLI_PASSES, CLI_RPT_RES = 4, 64
# phase 4o: the seed of its renders and data, the kNN cell, the PSSMLT
# checkpoint's side, the denoisers' tolerance against the CPU (the CPU test's,
# tests/test_torch_denoise.py) and the CLI processes' time limit (s)
SLICE_SEED = 11
KNN_POINTS, KNN_QUERIES, KNN_K, KNN_CPU_QUERIES = 1 << 16, 1 << 20, 4, 1 << 11
CKPT_PSSMLT_RES = 256
DENOISE_RTOL, DENOISE_ATOL = 2e-5, 1e-6
# the share of pixels held there: every one for EAW; XBL's taps sit at
# round(10 r cos(phi)), so an ulp of sin or cos apart moves a tap now and
# then and its pixel with it
DENOISE_NEAR = {"eaw": 1.0, "xbl": 0.99}
SLICE_TIMEOUT = 300
SHARD_ROUNDS = 5
# FP32 operations of one node visit of the walk: the slab test of
# accel/traverse.py _slab_test, ops/csrc/bvh.cu box_hit (6 subtractions, 6
# multiplications, 12 min/max; the compare not counted)
FLOPS_PER_VISIT = 24
STEP_ROUNDS = 2  # rounds of the binned loop held step by step to the plain steps (phase 6)
STEP_REPS = 5  # timed runs of each first-round step


class SmokeFailure(AssertionError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """A phase line, stamped with the seconds since the script started."""
    print(f"[+{time.perf_counter() - _T0:.1f} s] {msg}", flush=True)


def peaks_for(name: str):
    part = "PCIe" if "PCIe" in name else "NVL" if "NVL" in name else "SXM"
    return part, PEAKS[part]


def device_records(prof) -> list:
    """(name, ms) of each kernel, memcpy and memset the card ran under the
    torch.profiler `prof`, not the CPU ops that launched them, read from the
    profiler's raw records: prof.events() builds a Python object and its
    tree links for every record first, which takes tens of seconds for a
    pass of 190,000 kernels."""
    import torch

    names, out = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        raw = e.name()
        if raw not in names:
            names[raw] = torch._C._demangle(raw)
        ms = e.duration_ns() / 1e6 if hasattr(e, "duration_ns") else e.duration_us() / 1e3
        out.append((names[raw], ms))
    return out


def device_ms(fn, reps: int = REPLAYS, cold: bool = True) -> dict:
    """Device time of one call from CUDA events around each of `reps`
    back-to-back replays after a warm-up call: the median and the min/max
    (ms, ms_min, ms_max) with the L2 as the previous replay left it, and
    with `cold` the same again with FLUSH_BYTES written to a scratch buffer
    before each replay (cold_ms, cold_ms_min, cold_ms_max). A spin kernel
    first holds the card while the host queues every replay, so a pair of
    events brackets the call's device work and not the host's time to
    issue it (a call that reads back from the card, as the binned tracer's
    rounds do, still waits for the host inside its bracket).
    torch.profiler is not used: it lost some replays' kernels in earlier
    runs, which read as a 2-10x faster kernel."""
    import statistics

    import torch

    global _FLUSH
    fn()
    torch.cuda.synchronize()
    out = {}
    for tag in ("", "cold_") if cold else ("",):
        if tag and _FLUSH is None:
            _FLUSH = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
        ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
        torch.cuda._sleep(SPIN_CYCLES)
        for start, end in ev:
            if tag:
                _FLUSH.fill_(1.0)
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        t = [start.elapsed_time(end) for start, end in ev]
        out.update({f"{tag}ms": statistics.median(t), f"{tag}ms_min": min(t),
                    f"{tag}ms_max": max(t)})
    return out


def add_times(acc: dict, times: dict) -> None:
    """Sums device_ms results over launches (a row divides by the count)."""
    for k, v in times.items():
        acc[k] = acc.get(k, 0.0) + v


def per_launch(acc: dict, nc: int) -> dict:
    """A row's timing fields: device_ms's sums over nc launches, per launch."""
    out = {k: v / nc for k, v in acc.items()}
    out.update(us_per_launch=out["ms"] * 1e3, timer="events")
    return out


def fmt_times(t: dict) -> str:
    """'<median> us (min-max <a>-<b>; cold <median> us)' of per_launch fields."""
    return (f"{t['ms'] * 1e3:.2f} us (min-max {t['ms_min'] * 1e3:.2f}-{t['ms_max'] * 1e3:.2f}"
            + (f"; cold L2 {t['cold_ms'] * 1e3:.2f} us" if "cold_ms" in t else "") + ")")


@contextlib.contextmanager
def patched(replacements):
    """Temporarily replace module attributes [(module, name, value)]."""
    saved = [(m, n, getattr(m, n)) for m, n, _ in replacements]
    for m, n, v in replacements:
        setattr(m, n, v)
    try:
        yield
    finally:
        for m, n, v in saved:
            setattr(m, n, v)


def image_close(got, want) -> tuple:
    """tests/test_torch_pt.py tolerance on (N, 3) images: >= 99% of pixels
    within atol 1e-4, rtol 1e-3, channel means within 1e-3 relative."""
    import numpy as np

    near = np.isclose(got, want, atol=1e-4, rtol=1e-3).all(axis=1).mean()
    gm, wm = got.mean(axis=0), want.mean(axis=0)
    mean_rel = float(np.max(np.abs(gm - wm) / np.maximum(np.abs(wm), 1e-7)))
    return near >= 0.99 and mean_rel <= 1e-3, float(near), mean_rel


def profiled(fn):
    """(fn(), ms of that one call): CUDA events around one call on an idle
    card. For the plain versions at the big_room pass's size (0.3-0.7 s
    each), where a warm-up call and replays would multiply the cost."""
    import torch

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def device_split(fn, kernels: int, reps: int = 3) -> dict:
    """Device time of one call of the binned tracer by kernel family, from
    torch.profiler: its scan, counting-sort and test kernels, and the rest
    (the box table's concatenation, the counts' readbacks). `kernels` is the
    number of the tracer's kernels one call launches (its launch counters):
    a capture that records fewer lost records (CUPTI) and is taken again,
    up to PROFILE_TRIES times, the fullest kept (the log says when none was
    whole). Of `reps` captures, the one with the median total is kept."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fermat_tpu_torch.ops import binned_trace as bt

    fn()
    torch.cuda.synchronize()
    splits = []
    for _ in range(reps):
        best = (-1, None)
        for attempt in range(1, PROFILE_TRIES + 1):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            split = {"scan": 0.0, "bin": 0.0, "test": 0.0, "other": 0.0}
            got = 0
            for name, ms in device_records(prof):
                split[bt.kernel_family(name)] += ms
                got += bt.kernel_family(name) != "other"
            best = max(best, (got, split), key=lambda b: b[0])
            if got >= kernels:
                break
            log(f"[profile] capture {attempt} of {PROFILE_TRIES} holds {got} of the binned "
                f"tracer's {kernels} kernels")
        splits.append(best[1])
    return sorted(splits, key=lambda sp: sum(sp.values()))[len(splits) // 2]


def profile_one_pass(ctx, narrow: bool = False, expect: tuple = ()):
    """(device kernels, device-busy ms, top entries, {kernel name: [ms of
    each launch]}) of one pass under torch.profiler; the device is idle for
    the rest of the pass. narrow: the pass goes through render()
    (NarrowPass when the context has narrow=1). Device activity only:
    nothing here reads the host's op records. expect: parts of the names of
    device kernels the pass launches; a capture that holds no record of one
    of them (CUPTI now and then drops a pass's device records) is taken
    again, up to PROFILE_TRIES captures, and the last is returned."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            if narrow:
                ctx.render(1)
            else:
                ctx.render_batch(1)
        by_name, each = {}, {}
        for name, ms in device_records(prof):
            t, c = by_name.get(name, (0.0, 0))
            by_name[name] = (t + 1e3 * ms, c + 1)
            each.setdefault(name, []).append(ms)
        missing = [k for k in expect if not launches_named(each, k)]
        if not missing:
            break
        log(f"[profile] capture {attempt} of {PROFILE_TRIES} holds no record of {missing} "
            f"({sum(c for _, c in by_name.values())} device kernels recorded)")
    busy_ms = sum(t for t, _ in by_name.values()) / 1e3
    n_kern = sum(c for _, c in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    return n_kern, busy_ms, top, each


def launches_named(each: dict, part: str) -> list:
    """The per-launch ms of profile_one_pass's kernels whose name holds part."""
    return [ms for name, v in each.items() if part in name for ms in v]


def best_batches(ctx, passes: int = PASSES, narrow: bool = False):
    """Best of REPS batches of `passes` passes: (seconds, rays of that
    batch). narrow: render() (one sync per pass) instead of render_batch."""
    import torch

    best, best_rays = float("inf"), 0.0
    for _ in range(REPS):
        rays0 = float(ctx.stats["rays"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if narrow:
            ctx.render(passes)  # each pass ends in torch.cuda.synchronize()
        else:
            ctx.render_batch(passes)  # ends in torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if dt < best:
            best, best_rays = dt, float(ctx.stats["rays"]) - rays0
    return best, best_rays


def first_hit_tests(tris, o, d, tmax, active) -> float:
    """Ray-triangle tests an any-hit ray needs: up to its first hit."""
    import torch

    from fermat_tpu_torch.ops import trace as trace_mod

    tt, _, _, inside = trace_mod._mt(tris, o, d)
    ok = inside & (tt > 0.0) & (tt < tmax[:, None])
    first = torch.where(ok.any(1), ok.int().argmax(1) + 1, tris.shape[1])
    return float(first[active].sum())


def mega_source_digest() -> str:
    """sha256 (16 hex digits) of mega.cu's device code, the text before its
    host code (opts_of), with comments and whitespace taken out."""
    src = (ROOT / "fermat_tpu_torch" / "ops" / "csrc" / "mega.cu").read_text()
    code = src[:src.index("\nOpts opts_of(")]
    code = re.sub(r"\s+", "", re.sub(r"//[^\n]*|/\*.*?\*/", "", code, flags=re.S))
    return hashlib.sha256(code.encode()).hexdigest()[:16]


def mega_events(tb, opts, res: int, n: int, inst: int) -> list:
    """Per vertex b of one mega pass, as the plain version counts it on the
    card: [(rays alive, hits, closest tests, able shadow rays, occluded,
    shadow tests up to the first hit)]. Its rays equal the kernel's."""
    from fermat_tpu_torch.ops import pt_mega
    from fermat_tpu_torch.ops import trace as trace_mod

    closest, shadow = [], []

    def rec_closest(tris, o, d, tmin, tmax, active):
        hit = trace_mod._closest_plain(tris, o, d, tmin, tmax, active)
        alive = float(active.sum())
        closest.append((alive, float(((hit.tri >= 0) & active).sum()), alive * tris.shape[1]))
        return hit

    def rec_any(tris, o, d, tmin, tmax, active):
        occ = trace_mod._any_plain(tris, o, d, tmin, tmax, active)
        shadow.append((float(active.sum()), float((occ & active).sum()),
                       first_hit_tests(tris, o, d, tmax, active)))
        return occ

    with patched([(pt_mega, "_closest_plain", rec_closest), (pt_mega, "_any_plain", rec_any)]):
        pt_mega._mega_plain(tb, opts, res, n, inst, 0)
    check(len(closest) == len(shadow), "mega_events: a vertex without its NEE")
    return [c + s for c, s in zip(closest, shadow)]


def mega_ops(events: list, n: int, n_mats: int, opts) -> dict:
    """FP32 operations one pass needs (MEGA_FLOPS times the events): K3a's,
    K3b's, and the ray-triangle tests alone (a tracing-only lower bound). The
    scatter of the last vertex is not counted: its direction is never used."""
    from fermat_tpu_torch.ops import pt_mega

    check(pt_mega.main_switches(opts),
          f"MEGA_FLOPS counts the main path's switches, not {pt_mega._opt_vector(opts)}")
    digest = mega_source_digest()
    check(digest == MEGA_FLOPS_SOURCE, "mega.cu's device code changed since MEGA_FLOPS was "
          f"counted: recount it, then set MEGA_FLOPS_SOURCE = {digest!r}")
    f, last = MEGA_FLOPS, len(events) - 1
    tests = sum(e[2] + e[5] for e in events) * FLOPS_PER_TEST
    hits = sum(e[1] for e in events)
    lit = [e[3] - e[4] for e in events]
    scat = sum(e[1] for b, e in enumerate(events) if b < last)
    rr = sum(e[1] for b, e in enumerate(events) if opts.rr_start_bounce <= b < last and b > 0)
    radiance = (n * f["camera"] + tests + hits * (f["vertex"] + f["nee"])
                + events[0][1] * f["emit_first"] + (hits - events[0][1]) * f["emit"]
                + sum(e[3] for e in events) * f["shadow"] + lit[0] * f["lit_first"]
                + sum(lit[1:]) * f["lit"] + scat * f["scatter"] + rr * f["rr"])
    per_mat = MEGA_FLOPS_PER_MAT * n_mats
    misses = sum(e[0] - e[1] for e in events)
    survivors = sum(events[b + 1][0] for b in range(last))
    grad = (radiance + misses * (f["g_miss"] + per_mat) + hits * (f["g_emit"] + per_mat)
            + sum(lit) * (f["g_nee"] + per_mat) + survivors * f["g_u"])
    return {"forward": radiance + events[0][1] * f["gbuffer"], "grad": grad, "tests": tests,
            "pwl": (2 * hits + scat) * MEGA_FLOPS_PWL, "hits": hits, "lit": sum(lit),
            "misses": misses, "survivors": survivors}


def lanes_close(got, want) -> tuple:
    """image_close on (3, N) lane blocks of the megakernel's output."""
    return image_close(got.t().cpu().numpy(), want.t().cpu().numpy())


def sky_map(h: int, w: int, seed: int = 7):
    """An (h, w, 3) float32 lat-long HDR sky from a fixed numpy seed: a
    gradient above the horizon, a dim ground, noise, and a small bright sun
    36 degrees from the zenith on the side the rooms open to (+z)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    v = (np.arange(h, dtype=np.float32) + 0.5) / h  # 0 at the zenith
    sky = np.stack([0.3 + 0.6 * v, 0.5 + 0.4 * v, 1.0 - 0.2 * v], axis=1)
    img = (np.where((v < 0.5)[:, None, None], sky[:, None, :], 0.1)
           + rng.random((h, w, 3), dtype=np.float32) * 0.05).astype(np.float32)
    img[h // 5:h // 5 + h // 128, w // 8:w // 8 + w // 256] = (400.0, 380.0, 320.0)
    return img


def lit_cornell():
    """The glossy CornellBox with the blocker panel of
    tests/test_shadow_masks.py:24-52 under its ceiling light, flagged
    FLAG_SHADOW_DIRECT_IGNORE: one shadow set (the direct one)."""
    import numpy as np

    from fermat_tpu_torch.scene.materials import FLAG_SHADOW_DIRECT_IGNORE, HostMaterial
    from fermat_tpu_torch.scene.mesh import MeshStorage
    from fermat_tpu_torch.scene.procedural import _quad, cornell_box

    vs, tris, ids = [], [], []
    _quad(vs, tris, ids, [-0.99, 1.9, 0.99], [0.99, 1.9, 0.99], [0.99, 1.9, -0.99],
          [-0.99, 1.9, -0.99], 0)
    m = HostMaterial("blocker")
    m.diffuse = (0.2, 0.2, 0.2)
    m.flags = FLAG_SHADOW_DIRECT_IGNORE
    t = np.asarray(tris, np.int32)
    return cornell_box(glossy_boxes=True).merge(MeshStorage(
        vertices=np.asarray(vs, np.float32), triangles=t, normal_indices=np.full_like(t, -1),
        uv_indices=np.full_like(t, -1), material_ids=np.asarray(ids, np.int32),
        materials=[m]))


def forced_plain(dev) -> list:
    """patched() replacements that put every kernel's plain version in the
    pass's place: the dense and frontier tracers, the BVH walk, the light
    pick and the row gathers (the VPL pick's, the material rows' and the
    VTL rows' too)."""
    import torch

    from fermat_tpu_torch.accel.traverse import Hit, walk_any, walk_closest
    from fermat_tpu_torch.integrators import pt
    from fermat_tpu_torch.integrators import rl as rl_mod
    from fermat_tpu_torch.ops import cdf_gather
    from fermat_tpu_torch.ops import frontier_trace as ft
    from fermat_tpu_torch.ops import gather as gather_mod
    from fermat_tpu_torch.ops import trace as trace_mod
    from fermat_tpu_torch.core import rng as rng_mod
    from fermat_tpu_torch.scene import lights as lights_mod
    from fermat_tpu_torch.scene import mesh as mesh_mod
    from fermat_tpu_torch.scene import mesh_lights as mesh_lights_mod
    from fermat_tpu_torch.scene import textures as textures_mod

    def lanes(o, tmin, tmax):
        n = o.x.shape[0]
        return trace_mod._lanes(tmin, n, dev), trace_mod._lanes(tmax, n, dev)

    def closest(tris, o, d, tmin, tmax, active=None):
        return trace_mod._closest_plain(tris, o, d, *lanes(o, tmin, tmax), active)

    def any_(tris, o, d, tmin, tmax, active=None):
        return trace_mod._any_plain(tris, o, d, *lanes(o, tmin, tmax), active)

    def closest_frontier(cl, o, d, tmin, tmax, active=None, with_uv=True):
        t, tri = ft._closest_plain(cl, o, d, *lanes(o, tmin, tmax), active)
        return Hit(t=t, tri=tri, u=torch.zeros_like(t), v=torch.zeros_like(t))

    def any_frontier(cl, o, d, tmin, tmax, active=None):
        return ft._any_plain(cl, o, d, *lanes(o, tmin, tmax), active)

    def closest_bvh(bvh, tris, o, d, tmin, tmax, active=None):
        return walk_closest(bvh, tris, o, d, *trace_mod._lane_args(o, tmin, tmax, active))

    def any_bvh(bvh, tris, o, d, tmin, tmax, active=None):
        return walk_any(bvh, tris, o, d, *trace_mod._lane_args(o, tmin, tmax, active))

    return [(pt, "trace_closest", closest), (pt, "trace_any", any_),
            (pt, "trace_closest_frontier", closest_frontier),
            (pt, "trace_any_frontier", any_frontier),
            (pt, "trace_closest_bvh", closest_bvh), (pt, "trace_any_bvh", any_bvh),
            (pt, "cdf_pick_rows", cdf_gather._pick_plain),
            (mesh_mod, "gather_rows", gather_mod._gather_plain),
            (lights_mod, "gather_rows", gather_mod._gather_plain),
            (mesh_lights_mod, "gather_rows", gather_mod._gather_plain),
            (textures_mod, "gather_rows", gather_mod._gather_plain),
            (rng_mod, "gather_rows", gather_mod._gather_plain),
            (rl_mod, "gather_rows", gather_mod._gather_plain)]


def kernels_then_plain(dev, counts, fn):
    """(fn() with the kernels, fn() with every plain version forced); the
    forced call launches no kernel."""
    import torch

    got = fn()
    before = counts()
    with patched(forced_plain(dev)):
        want = fn()
    torch.cuda.synchronize()
    check(before == counts(), "the forced plain pass launched a kernel")
    return got, want


def drive_cell(tag: str, cell: str, ctx, passes: int, smi: str, reset_counts, counts,
               narrow: bool = False) -> dict:
    """Phases 4g and 4h: a warm-up pass, best of REPS batches of `passes`,
    launches per pass, one profiled pass (busy, idle share, the route
    kernels' time a launch in it) and the peak memory allocated above the
    cell's start (earlier phases' tensors stay allocated)."""
    import numpy as np
    import torch

    dev = ctx.device
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    ctx.render(1)
    reset_counts()
    best, rays = best_batches(ctx, passes, narrow=narrow)
    per = {n: c / (passes * REPS) for n, c in counts().items() if c}
    hdr = ctx.hdr_image()
    check(np.isfinite(hdr).all() and float(hdr.mean()) > 0.001,
          f"{cell}: image not finite or black (mean {hdr.mean()})")
    n_kern, busy, top, each = profile_one_pass(
        ctx, narrow=narrow, expect=tuple(LIT_IN_PASS[n] for n in per if n in LIT_IN_PASS))
    ms = best / passes * 1e3
    # each route kernel's device time a launch inside the profiled pass (us)
    in_pass = {n: 1e3 * sum(v) / len(v) for n, k in LIT_IN_PASS.items()
               for v in [launches_named(each, k)] if v}
    peak = torch.cuda.max_memory_allocated(dev) - base
    log(f"[{tag}] {cell} {ctx.res_x}x{ctx.res_y} mpl={MPL}: {ms:.2f} ms/pass, "
        f"{rays / best / 1e6:.3f} Mrays/s ({rays / passes:.0f} rays/pass; best of {REPS} x "
        f"{passes} passes) on {smi}; image mean {hdr.mean():.4f}; peak memory "
        f"{peak / 2 ** 30:.2f} GiB above the cell's start; launches per pass: {per}")
    log(f"[{tag}] {cell}: one pass under torch.profiler: {n_kern} device kernels, device "
        f"busy {busy:.2f} ms of the {ms:.2f} ms pass (idle share {1 - busy / ms:.3f}); route "
        "kernels' us a launch in it: " + ", ".join(f"{n} {v:.2f}" for n, v in in_pass.items())
        + "; top: " + "; ".join(f"{n[:60]} {t / 1e3:.2f} ms x{c}" for n, (t, c) in top))
    return dict(ms=ms, mrays=rays / best / 1e6, rays=rays / passes, kernels=n_kern,
                busy_ms=busy, idle=1 - busy / ms, launches=per, in_pass_us=in_pass,
                peak_bytes=peak)


def lit_phase(dev, smi: str, reset_counts, counts) -> dict:
    """Phase 4g: the PT pass's full light model on the card (see the module
    docstring). Returns the cells' numbers and their launches per pass."""
    import numpy as np
    import torch

    from fermat_tpu_torch.core.math import Vec3
    from fermat_tpu_torch.integrators import pt
    from fermat_tpu_torch.ops import frontier_trace as ft
    from fermat_tpu_torch.ops import pt_mega
    from fermat_tpu_torch.ops import trace as trace_mod
    from fermat_tpu_torch.render.context import RenderingContext
    from fermat_tpu_torch.scene.lights import DirectionalLightDef
    from fermat_tpu_torch.scene.materials import FLAG_SHADOW_INDIRECT_IGNORE
    from fermat_tpu_torch.scene.procedural import big_room, big_room_camera, cornell_camera
    from fermat_tpu_torch.scene.view import SceneView

    t_phase = time.perf_counter()
    bits = lambda t: t.contiguous().view(torch.int32)
    emap = sky_map(ENV_H, ENV_W)
    cells, launches = {}, {}

    def drive(cell, ctx, passes, narrow=False):
        cells[cell] = drive_cell("4g lit", cell, ctx, passes, smi, reset_counts, counts, narrow)
        return cells[cell]["launches"]

    def plain_parity(cell, view, opts, res_x, res_y, ss):
        """One pass with the kernels (recording the first K1b launch on the
        shadow set `ss`) and one with every plain version forced: rays equal,
        every channel bit-equal. Then K1b on the set's soup and K5b on its
        cluster table at that launch's rays, each bit-equal to its plain
        version."""
        rec, trace_any = [], pt.trace_any

        def rec_any(tris, *a):
            if tris is ss.tris and not rec:
                rec.append(a)
            return trace_any(tris, *a)

        with patched([(pt, "trace_any", rec_any)]):
            out_k = pt.render_pass(view, opts, res_x, res_y, 1000, 0)
        before = counts()
        with patched(forced_plain(dev)):
            out_p = pt.render_pass(view, opts, res_x, res_y, 1000, 0)
        torch.cuda.synchronize()
        check(before == counts(), f"{cell}: the forced plain pass launched a kernel")
        check(float(out_k.rays) == float(out_p.rays),
              f"{cell}: kernel vs plain pass: rays {float(out_k.rays)} vs {float(out_p.rays)}")
        for c in ("composited", "direct", "diffuse", "specular", "normal", "position"):
            check(torch.equal(bits(getattr(out_k, c).stack()), bits(getattr(out_p, c).stack())),
                  f"{cell}: kernel vs plain pass: {c} not bit-equal")
        check(torch.equal(out_k.tri, out_p.tri), f"{cell}: kernel vs plain pass: first hits differ")
        check(len(rec) == 1, f"{cell}: no K1b launch on the shadow set")
        o, d, tmin, tmax, active = rec[0]
        n = o.x.shape[0]
        t0l, t1l = trace_mod._lanes(tmin, n, dev), trace_mod._lanes(tmax, n, dev)
        k1 = trace_mod.trace_any(ss.tris, o, d, tmin, tmax, active)
        p1 = trace_mod._any_plain(ss.tris, o, d, t0l, t1l, active)
        k5 = ft.trace_any_frontier(ss.clusters, o, d, tmin, tmax, active)
        p5 = ft._any_plain(ss.clusters, o, d, t0l, t1l, active)
        torch.cuda.synchronize()
        check(torch.equal(k1, p1), f"{cell}: K1b on the shadow set's soup differs from plain")
        check(torch.equal(k5, p5), f"{cell}: K5b on the shadow set's table differs from plain")
        log(f"[4g lit] {cell} {res_x}x{res_y}: kernels vs plain versions: rays equal "
            f"({float(out_k.rays):.0f}), every channel, normal, position and first hit "
            f"bit-equal; at the first shadow launch on the set ({ss.mesh.n_triangles} "
            f"triangles, {int(active.sum())} of {n} lanes able): K1b on its soup and K5b on "
            f"its cluster table each equal to plain ({int(k1.sum())} / {int(k5.sum())} "
            f"occluded, {int((k1 != k5).sum())} lanes where K1b and K5b differ)")

    # ---- the lit CornellBox: K1a, K1b (also over the shadow set), K2 ----
    cstore, cam = lit_cornell(), cornell_camera()
    sun = [DirectionalLightDef(*LIT_DIR)]
    ctx = RenderingContext.create(cstore, cam, RES, RES, renderer="pt", max_path_length=MPL,
                                  dir_lights=sun, point_lights=LIT_POINT, env_map=emap)
    ctx.view = SceneView.build(cstore, cam, dev, dir_light_defs=sun, point_light_defs=LIT_POINT,
                               env_map=emap, area_light_defs=LIT_AREA)
    view = ctx.view
    check(view.device.type == "cuda" and view.area_lights.count == 2
          and view.shadow_sets[1] is None
          and view.shadow_sets[0].mesh.n_triangles == view.mesh.n_triangles - 2,
          "the lit CornellBox's view: lights or shadow sets not as built")
    # the env map's texel choice on the card against the CPU's, on the same
    # host-built CDF: the chosen texel's radiance bit-equal on every lane
    gen = torch.Generator(device=dev).manual_seed(3)
    u = torch.rand(2, 1 << 20, generator=gen, device=dev)
    card = view.env_map.sample(u[0], u[1])
    host = type(view.env_map)(*(t.cpu() for t in view.env_map)).sample(u[0].cpu(), u[1].cpu())
    check(all(torch.equal(a.cpu(), b) for a, b in zip(card[2], host[2])),
          "env map sample: the card chose another texel than the CPU")
    log(f"[4g lit] env map {ENV_W}x{ENV_H}: sample() on {u.shape[1]} lanes picks the same "
        f"texel on the card as on the CPU; max |dir card - dir cpu| "
        f"{max(float((a.cpu() - b).abs().max()) for a, b in zip(card[0], host[0])):.3g}, max "
        f"pdf rel {float(((card[1].cpu() - host[1]).abs() / host[1]).max()):.3g}")
    opts = pt.PTOptions(**ctx.renderer_options)
    refused = False
    try:
        pt.render_pass(view, opts._replace(tracer="mega"), 16, 16, 0)
    except NotImplementedError:
        refused = True
    check(refused and not pt_mega.mega_eligible(view, opts),
          "tracer='mega' on the lit CornellBox did not raise NotImplementedError")
    per = drive("lit CornellBox", ctx, LIT_PASSES)
    # a strategy a bounce: mesh lights, the env map, 2 area, 1 point, 1 directional
    check(per.get("trace_closest") == MPL and per.get("trace_any") == 6 * MPL
          and per.get("gather_rows", 0) > 0 and set(per) == {"trace_closest", "trace_any",
                                                            "gather_rows"},
          f"lit CornellBox launches per pass: {per}")
    launches["lit_cornell"] = per
    plain_parity("lit CornellBox", view, opts, RES, RES, view.shadow_sets[0])

    # ---- the lit big_room: K5a, K5b at bounce 0, K1b over the 36-triangle
    # indirect shadow set at the later bounces, K4, K2 ----
    room = big_room(BIG_BOXES)
    for m in room.materials:
        if m.name == "clutter":
            m.flags |= FLAG_SHADOW_INDIRECT_IGNORE
    bctx = RenderingContext.create(room, big_room_camera(), BIG_W, BIG_H, renderer="pt",
                                   max_path_length=MPL, dir_lights=[DirectionalLightDef(*LIT_SUN)],
                                   env_map=emap)
    bview = bctx.view
    ss = bview.shadow_sets[1]
    check(bview.shadow_sets[0] is None and ss.mesh.n_triangles == 36,
          "the lit big_room's indirect shadow set is not the 36-triangle room")
    per = drive("lit big_room monolithic", bctx, LIT_PASSES)
    # mesh lights, the env map and the sun a bounce; bounce 0 over the scene
    # (K5b), the later bounces over the set (K1b); each frontier trace sorts
    check(per.get("trace_closest_frontier") == MPL and per.get("trace_any_frontier") == 3
          and per.get("trace_any") == 3 * (MPL - 1) and per.get("cdf_pick_rows") == MPL
          and per.get("frontier_sort_key") == MPL + 3 and "trace_closest" not in per,
          f"lit big_room launches per pass: {per}")
    launches["lit_big_room"] = per
    bctx.renderer_options["narrow"] = 1
    bctx.restart()
    per = drive("lit big_room narrow=1", bctx, LIT_PASSES, narrow=True)
    check(all(per.get(n, 0) > 0 for n in ("trace_closest_frontier", "trace_any_frontier",
                                          "trace_any", "cdf_pick_rows", "gather_rows")),
          f"lit big_room narrow=1 launches per pass: {per}")
    launches["lit_big_room_narrow"] = per
    bctx.renderer_options.pop("narrow")
    bctx.restart()
    plain_parity("lit big_room", bview, pt.PTOptions(**bctx.renderer_options), PLAIN_W,
                 PLAIN_H, ss)
    del ctx, bctx, view, bview
    torch.cuda.empty_cache()

    # ---- the JAX golden of the light model on the card's kernel path ----
    gz = np.load(ROOT / "tests" / "golden" / "torch_port_lights_24.npz")
    gres, ginst, gseed = int(gz["res"]), int(gz["instance"]), int(gz["seed"])
    gviews, report = {}, []
    for name, (key, fields) in json.loads(str(gz["configs"])).items():
        if key not in gviews:
            p = f"{key}.view."
            gviews[key] = SceneView.from_numpy({k[len(p):]: gz[k] for k in gz.files
                                                if k.startswith(p)}, dev)
        gopts = pt.PTOptions(lobes=tuple(bool(x) for x in gz[f"{name}.lobes"]),
                             clearcoat=bool(gz[f"{name}.clearcoat"]), **fields)
        for tracer in (gopts.tracer, "auto") if key == "D" else (gopts.tracer,):
            out = pt.render_pass(gviews[key], gopts._replace(tracer=tracer), gres, gres, ginst,
                                 gseed)
            want = float(gz[f"{name}.rays"])
            check(abs(float(out.rays) - want) <= 0.005 * want,
                  f"lights golden {name} ({tracer}): rays {float(out.rays)} vs JAX {want}")
            worst = 1.0
            for c in ("composited", "direct", "diffuse", "specular"):
                ok, near, mean_rel = image_close(getattr(out, c).stack().cpu().numpy(),
                                                 gz[f"{name}.{c}"].reshape(-1, 3))
                check(ok, f"lights golden {name} ({tracer}) {c}: {near:.4f} of pixels close, "
                          f"mean rel {mean_rel:.2e}")
                worst = min(worst, near)
            report.append(f"{name} ({tracer}) rays {float(out.rays):.0f}/{want:.0f}, "
                          f"pixels close >= {worst:.4f}")
    g_report = []
    for name, leaf in json.loads(str(gz["grads"])):
        key = name.split("_")[0]
        gopts = pt.PTOptions(lobes=tuple(bool(x) for x in gz[f"{name}.lobes"]),
                             clearcoat=bool(gz[f"{name}.clearcoat"]),
                             **json.loads(str(gz["configs"]))[name][1])
        v = gviews[key]
        if leaf == "env":
            g_leaf = v.env.detach().clone().requires_grad_(True)
            v = v._replace(env=g_leaf)
        else:
            g_leaf = v.mesh.materials.diffuse.stack().detach().clone().requires_grad_(True)
            mats = v.mesh.materials._replace(
                diffuse=Vec3(g_leaf[:, 0], g_leaf[:, 1], g_leaf[:, 2]))
            v = v._replace(mesh=v.mesh._replace(materials=mats))
        pt.render_pass(v, gopts, gres, gres, ginst, gseed).composited.stack().mean().backward()
        want = gz[f"{name}.grad.{leaf}"]
        rel = float(np.abs(g_leaf.grad.cpu().numpy() - want).max() / np.abs(want).max())
        check(rel <= AD_GOLDEN_RTOL, f"lights golden d/d {leaf} on {name}: {rel:.3g} of max|g|")
        g_report.append(f"{name} d/d {leaf} {rel:.2e}")
    log(f"[4g lit] the light-model golden ({gres}x{gres}, JAX on the CPU) on the card's kernel "
        f"path within the tolerances of tests/test_torch_pt.py: " + "; ".join(report)
        + f"; jax.grad within {AD_GOLDEN_RTOL:g} of max|g|: " + ", ".join(g_report)
        + f"; {time.perf_counter() - t_phase:.1f} s for the phase")
    return {"cells": cells, "launches": launches}


def atlas_bytes(atlas) -> int:
    """Device bytes of a texture atlas: texels, tables and the RGBA8 mirror."""
    return sum(t.numel() * t.element_size() for t in atlas if t is not None)


def first_hit_uv(shade, uv, hit):
    """scene.mesh._shade `shade` with bounce 0's uv replaced by `uv` (N, 2)
    on the lanes where `hit` is set: the first call in a pass shades the
    camera rays' hits."""
    import torch

    calls = []

    def wrapped(r, u, v):
        sh = shade(r, u, v)
        calls.append(r.shape[0])
        if len(calls) > 1:
            return sh
        if r.shape[0] != uv.shape[0]:
            raise ValueError(f"first_hit_uv: {r.shape[0]} lanes, {uv.shape[0]} uv rows")
        return sh._replace(uv=torch.where(hit[:, None], uv, sh.uv))

    return wrapped


def textured_phase(dev, smi: str, reset_counts, counts) -> dict:
    """Phase 4h: textured surfaces and emitters, the texel and emitter
    gradients and the blue-noise sampler on the card (see the module
    docstring). Returns the cells' numbers and their launches per pass."""
    import tempfile

    import numpy as np
    import torch

    from fermat_tpu_torch.core.math import Vec3
    from fermat_tpu_torch.core.rng import BlueNoiseSequence
    from fermat_tpu_torch.integrators import pt
    from fermat_tpu_torch.ops import pt_mega
    from fermat_tpu_torch.render.context import RenderingContext
    from fermat_tpu_torch.scene import mesh as mesh_mod
    from fermat_tpu_torch.scene import procedural as proc
    from fermat_tpu_torch.scene.lights import MeshLightsView
    from fermat_tpu_torch.scene.view import SceneView

    t_phase = time.perf_counter()
    bits = lambda t: t.contiguous().view(torch.int32)
    cells, launches = {}, {}
    tmp = tempfile.TemporaryDirectory()

    def drive(cell, ctx, narrow=False):
        """drive_cell, and the atlas's device bytes."""
        cells[cell] = drive_cell("4h textured", cell, ctx, TEX_PASSES, smi, reset_counts,
                                 counts, narrow)
        cells[cell]["atlas_bytes"] = atlas_bytes(ctx.view.textures)
        return cells[cell]["launches"]

    def plain_parity(cell, view, opts, res_x, res_y):
        """One pass with the kernels and one with every plain version forced:
        rays equal, every channel, albedo and first hit bit-equal."""
        out_k = pt.render_pass(view, opts, res_x, res_y, 1000, 0)
        before = counts()
        with patched(forced_plain(dev)):
            out_p = pt.render_pass(view, opts, res_x, res_y, 1000, 0)
        torch.cuda.synchronize()
        check(before == counts(), f"{cell}: the forced plain pass launched a kernel")
        check(float(out_k.rays) == float(out_p.rays),
              f"{cell}: kernel vs plain pass: rays {float(out_k.rays)} vs {float(out_p.rays)}")
        for c in ("composited", "direct", "diffuse", "specular", "diffuse_albedo",
                  "specular_albedo", "normal"):
            check(torch.equal(bits(getattr(out_k, c).stack()), bits(getattr(out_p, c).stack())),
                  f"{cell}: kernel vs plain pass: {c} not bit-equal")
        check(torch.equal(out_k.tri, out_p.tri), f"{cell}: kernel vs plain pass: first hits differ")
        log(f"[4h textured] {cell} {res_x}x{res_y} ({opts.texture_filter}, {opts.sampler}): "
            f"kernels vs plain versions: rays equal ({float(out_k.rays):.0f}), every channel, "
            "both albedos, normal and first hit bit-equal")

    # ---- the textured CornellBox: K1a, K1b, K2 (also the atlas's metadata) ----
    t0 = time.perf_counter()
    names = proc.write_cornell_textures(tmp.name, size=TEX_SIZE)
    cstore = proc.set_texture_names(proc.cornell_box(glossy_boxes=True), names)
    ctx = RenderingContext.create(cstore, proc.cornell_camera(), RES, RES, renderer="pt",
                                  max_path_length=MPL, texture_dir=tmp.name)
    view = ctx.view
    check(view.has_textures and bool(view.textured_emitters) and view.textures.count == 5
          and view.textures.packed_q is not None,
          "the textured CornellBox's view: atlas or textured emitters not as built")
    log(f"[4h textured] CornellBox: 5 seeded 8-bit TGAs (the white one "
        f"{int(view.textures.width[0, 0])}x{int(view.textures.height[0, 0])} after padding "
        f"from non-power-of-two), atlas {view.textures.texels.shape[0]} texels, "
        f"{atlas_bytes(view.textures) / 2 ** 20:.2f} MiB with its RGBA8 mirror; view built in "
        f"{time.perf_counter() - t0:.1f} s")
    opts = pt.PTOptions(**ctx.renderer_options)
    refused = False
    try:
        pt.render_pass(view, opts._replace(tracer="mega"), 16, 16, 0)
    except NotImplementedError:
        refused = True
    check(refused and not pt_mega.mega_eligible(view, opts),
          "tracer='mega' on the textured CornellBox did not raise NotImplementedError")
    for cell, extra in (("textured CornellBox bilinear", {}),
                        ("textured CornellBox trilinear", {"texture_filter": "trilinear"}),
                        ("textured CornellBox bluenoise", {"sampler": "bluenoise"})):
        ctx.renderer_options.update(extra)
        ctx.restart()
        per = drive(cell, ctx)
        check(per.get("trace_closest") == MPL and per.get("trace_any") == MPL
              and per.get("gather_rows", 0) > 0
              and set(per) == {"trace_closest", "trace_any", "gather_rows"},
              f"{cell} launches per pass: {per}")
        launches[cell.replace("textured CornellBox ", "textured_cornell_")] = per
        for k in extra:
            ctx.renderer_options.pop(k)
    plain_parity("textured CornellBox", view, opts, RES, RES)
    plain_parity("textured CornellBox", view,
                 opts._replace(texture_filter="trilinear", sampler="bluenoise"), RES, RES)

    # the blue-noise sequence on the card against the CPU's, 2^20 lanes
    seq = BlueNoiseSequence.create(seed=0, instance=5, res_x=1024)
    pix = torch.arange(1 << 20, dtype=torch.int64)
    for dim in (0, 2, 5):
        for a, b in zip(seq.sample_3d(pix.to(dev), dim), seq.sample_3d(pix, dim)):
            check(torch.equal(bits(a.cpu()), bits(b)),
                  f"bluenoise sample_3d at dimension {dim}: the card differs from the CPU")
    log(f"[4h textured] bluenoise sample_3d on {pix.shape[0]} lanes (dimensions 0, 2, 5): the "
        "card's values equal the CPU's bit for bit")

    # ---- one textured AD step: d loss / d texels at 512x512 ----
    def tex_step(inst):
        x = view.textures.texels.detach().clone().requires_grad_(True)
        v = view._replace(textures=view.textures._replace(texels=x))
        img = pt.render_pass(v, opts, RES, RES, inst, 0).composited.stack()
        (img * img).mean().backward()
        return x.grad

    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    tex_step(0)
    steps = []
    for i in range(2):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        g = tex_step(1 + i)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t1)
    peak = torch.cuda.max_memory_allocated(dev) - base
    check(bool(torch.isfinite(g).all()) and float(g[:, :3].abs().max()) > 0.0,
          "textured AD step: the texel gradient is not finite or all zero")
    cells["textured CornellBox AD step (texels)"] = dict(ms=min(steps) * 1e3, peak_bytes=peak)
    log(f"[4h textured] AD step d loss / d texels ({view.textures.texels.shape[0]} x 4), 512x512, "
        f"{MPL} bounces: {min(steps) * 1e3:.2f} ms/step (best of 2 after a warm-up), peak "
        f"{peak / 2 ** 30:.2f} GiB above the step's start; max|g| {float(g.abs().max()):.4g}, "
        f"{int((g[:, :3] != 0).any(1).sum())} texels with a gradient")
    del ctx, view, g
    torch.cuda.empty_cache()

    # ---- the bathroom-class stand-in: K5a, K5b, K4, K2 ----
    t0 = time.perf_counter()
    bdir = Path(tmp.name) / "bathroom"
    proc.write_standin_assets(str(bdir), size=TEX_SIZE)
    bstore, bcam, btex = proc.bathroom_standin(BIG_BOXES, 3, str(bdir))
    bctx = RenderingContext.create(bstore, bcam, BIG_W, BIG_H, renderer="pt",
                                   max_path_length=MPL, texture_dir=btex)
    bview = bctx.view
    check(bview.mesh.n_triangles == 99_612 and bview.has_textures
          and not bool(bview.textured_emitters) and bview.textures.count == 16
          and bview.lights.compact is not None,
          "the bathroom stand-in's view: triangles, atlas or light table not as built")
    log(f"[4h textured] bathroom stand-in: {bview.mesh.n_triangles} triangles, 12 materials, "
        f"16 seeded {TEX_SIZE}x{TEX_SIZE} TGAs, atlas {bview.textures.texels.shape[0]} texels, "
        f"{atlas_bytes(bview.textures) / 2 ** 20:.2f} MiB; view built in "
        f"{time.perf_counter() - t0:.1f} s")
    per = drive("bathroom monolithic", bctx)
    check(per.get("trace_closest_frontier") == MPL and per.get("trace_any_frontier") == MPL
          and per.get("cdf_pick_rows") == MPL and per.get("gather_rows", 0) > 0
          and "trace_closest" not in per, f"bathroom launches per pass: {per}")
    launches["bathroom"] = per
    bctx.renderer_options["narrow"] = 1
    bctx.restart()
    per = drive("bathroom narrow=1", bctx, narrow=True)
    check(all(per.get(n, 0) > 0 for n in ("trace_closest_frontier", "trace_any_frontier",
                                          "cdf_pick_rows", "gather_rows")),
          f"bathroom narrow=1 launches per pass: {per}")
    launches["bathroom_narrow"] = per
    bctx.renderer_options.pop("narrow")
    bctx.restart()
    plain_parity("bathroom", bview, pt.PTOptions(**bctx.renderer_options), PLAIN_W, PLAIN_H)
    del bctx, bview
    tmp.cleanup()
    torch.cuda.empty_cache()

    # ---- the texture golden on the card's kernel path ----
    gz = np.load(ROOT / "tests" / "golden" / "torch_port_textures_24.npz")
    gres, ginst, gseed = int(gz["res"]), int(gz["instance"]), int(gz["seed"])
    configs = json.loads(str(gz["configs"]))
    gviews, report = {}, []
    for key in sorted({k for k, _ in configs.values()}):
        p = f"{key}.view."
        gviews[key] = SceneView.from_numpy({k[len(p):]: gz[k] for k in gz.files
                                            if k.startswith(p)}, dev)
    gopts = lambda name: pt.PTOptions(lobes=tuple(bool(x) for x in gz[f"{name}.lobes"]),
                                      clearcoat=bool(gz[f"{name}.clearcoat"]), **configs[name][1])
    for name, (key, _) in configs.items():
        if f"{name}.rays" not in gz.files:
            continue  # a gradient's configuration only
        out = pt.render_pass(gviews[key], gopts(name), gres, gres, ginst, gseed)
        want = float(gz[f"{name}.rays"])
        check(abs(float(out.rays) - want) <= 0.005 * want,
              f"textures golden {name}: rays {float(out.rays)} vs JAX {want}")
        same = float((out.tri.cpu().numpy() == gz[f"{name}.tri"]).mean())
        check(same >= (0.99 if key == "D" else 1.0), f"textures golden {name}: first hits {same}")
        worst = 1.0
        for c in ("composited", "direct", "diffuse", "specular"):
            ok, near, mean_rel = image_close(getattr(out, c).stack().cpu().numpy(),
                                             gz[f"{name}.{c}"].reshape(-1, 3))
            check(ok, f"textures golden {name} {c}: {near:.4f} of pixels close, "
                      f"mean rel {mean_rel:.2e}")
            worst = min(worst, near)
        report.append(f"{name} rays {float(out.rays):.0f}/{want:.0f}, first hits {same:.4f}, "
                      f"pixels close >= {worst:.4f}")
    g_report = []
    shade = mesh_mod._shade
    for name, leaf, at_jax_uv in json.loads(str(gz["grads"])):
        v = gviews[configs[name][0]]
        # T_C's gradient is held at JAX's own first-hit uv: JAX's uv on the
        # light's grazing hits lies 1.3e-6 from the float64 value, the
        # port's 2.8e-7 (tests/test_torch_textures.py)
        mesh_mod._shade = shade if not at_jax_uv else first_hit_uv(
            shade, torch.from_numpy(gz[f"{name}.uv"].reshape(-1, 2)).to(dev),
            torch.from_numpy(gz[f"{name}.tri"] >= 0).to(dev))
        if leaf == "texels":
            x = v.textures.texels.detach().clone().requires_grad_(True)
            v = v._replace(textures=v.textures._replace(texels=x))
        else:
            x = v.mesh.materials.emissive.stack().detach().clone().requires_grad_(True)
            mesh = v.mesh._replace(materials=v.mesh.materials._replace(
                emissive=Vec3(x[:, 0], x[:, 1], x[:, 2])))
            v = v._replace(mesh=mesh, lights=MeshLightsView.build_on_device(mesh))
        try:
            pt.render_pass(v, gopts(name), gres, gres, ginst, gseed).composited.stack().mean() \
                .backward()
        finally:
            mesh_mod._shade = shade
        want = gz[f"{name}.grad.{leaf}"]
        rel = float(np.abs(x.grad.cpu().numpy() - want).max() / np.abs(want).max())
        check(rel <= AD_GOLDEN_RTOL, f"textures golden d/d {leaf} on {name}: {rel:.3g} of max|g|")
        g_report.append(f"{name} d/d {leaf} {rel:.2e}")
    log(f"[4h textured] the texture golden ({gres}x{gres}, JAX on the CPU) on the card's kernel "
        f"path within the tolerances of tests/test_torch_pt.py: " + "; ".join(report)
        + f"; jax.grad within {AD_GOLDEN_RTOL:g} of max|g|: " + ", ".join(g_report)
        + f"; {time.perf_counter() - t_phase:.1f} s for the phase")
    return {"cells": cells, "launches": launches}


def options_phase(dev, smi: str, reset_counts, counts, bview, room_options: dict) -> dict:
    """Phase 4i: the remaining PT options on the CornellBox and the BVH walk
    on big_room (see the module docstring). Returns the cells' numbers, their
    launches per pass, the walk's BVH of big_room and its build seconds."""
    import torch

    from fermat_tpu_torch.integrators import pt
    from fermat_tpu_torch.ops import bvh_trace
    from fermat_tpu_torch.ops import frontier_trace as ft
    from fermat_tpu_torch.render.context import RenderingContext
    from fermat_tpu_torch.render.framebuffer import Framebuffer
    from fermat_tpu_torch.scene.procedural import cornell_box, cornell_camera

    t_phase = time.perf_counter()
    bits = lambda t: t.contiguous().view(torch.int32)
    cells, launches = {}, {}

    def drive(cell, ctx, key):
        cells[cell] = drive_cell("4i options", cell, ctx, OPT_PASSES, smi, reset_counts, counts)
        launches[key] = cells[cell]["launches"]
        return launches[key]

    def same_pass(a, b) -> bool:
        vec = lambda x: x.stack() if hasattr(x, "stack") else x
        return all(torch.equal(bits(vec(getattr(a, f))) if vec(getattr(a, f)).is_floating_point()
                               else vec(getattr(a, f)),
                               bits(vec(getattr(b, f))) if vec(getattr(b, f)).is_floating_point()
                               else vec(getattr(b, f))) for f in a._fields)

    def plain_equal(cell, view, opts, res_x, res_y):
        """One pass with the kernels and one with every plain version
        forced: every output bit-equal. Returns the kernels' pass."""
        out_k = pt.render_pass(view, opts, res_x, res_y, 1000, 0)
        before = counts()
        with patched(forced_plain(dev)):
            out_p = pt.render_pass(view, opts, res_x, res_y, 1000, 0)
        torch.cuda.synchronize()
        check(before == counts(), f"{cell}: the forced plain pass launched a kernel")
        check(same_pass(out_k, out_p), f"{cell}: kernel vs plain pass not bit-equal")
        return out_k

    # ---- the CornellBox under each option: K1a, K1b, K2 (the VPL pick too) ----
    for cell, kw in OPT_CELLS.items():
        ctx = RenderingContext.create(cornell_box(glossy_boxes=True), cornell_camera(), RES, RES,
                                      renderer="pt", max_path_length=MPL, **kw)
        per = drive(f"CornellBox {cell}", ctx, f"options_{cell}")
        check(per.get("trace_closest") == MPL and per.get("trace_any") == MPL
              and per.get("gather_rows", 0) > 0
              and set(per) == {"trace_closest", "trace_any", "gather_rows"},
              f"CornellBox {cell} launches per pass: {per}")
        opts = pt.PTOptions(**ctx.renderer_options)
        out = plain_equal(f"CornellBox {cell}", ctx.view, opts, RES, RES)
        extra = ""
        if cell == "compaction":
            masked = pt.render_pass(ctx.view, opts._replace(queue_compaction=False), RES, RES,
                                    1000, 0)
            check(same_pass(out, masked), "the compaction pass is not bit-equal to the masked one")
            extra = "; bit-equal to the masked pass"
        log(f"[4i options] CornellBox {cell} {RES}x{RES}: kernels vs forced plain versions: "
            f"rays equal ({float(out.rays):.0f}), every output bit-equal{extra}")
        del ctx

    # ---- big_room: the BVH walk beside the frontier tracer ----
    t0 = time.perf_counter()
    room_view = bview.with_bvh()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    bvh = room_view.bvh
    log(f"[4i options] big_room: the walk's BVH of {bview.mesh.n_triangles} triangles built on "
        f"the host in {build_s:.2f} s ({bvh.n_nodes} nodes, leaf_size {bvh.leaf_size})")

    def room_ctx(view, tracer):
        ctx = RenderingContext(view=view, res_x=BIG_W, res_y=BIG_H, renderer="pt",
                               renderer_options={**room_options, "tracer": tracer})
        ctx.fb = Framebuffer.create(BIG_H, BIG_W, dev)
        return ctx

    drive("big_room frontier", room_ctx(bview, "frontier"), "options_big_room_frontier")
    per = drive("big_room bvh", room_ctx(room_view, "bvh"), "options_big_room_bvh")
    check(per.get("trace_closest_bvh") == MPL and per.get("trace_any_bvh") == MPL
          and set(per) <= {"trace_closest_bvh", "trace_any_bvh", "cdf_pick_rows", "gather_rows"},
          f"big_room bvh launches per pass: {per}")
    # the pass's camera rays
    rec = []

    def recorder(fn):
        def wrapper(*args):
            rec.append(args)
            return fn(*args)
        return wrapper

    bopts = pt.PTOptions(**{**room_options, "tracer": "bvh"})
    with patched([(pt, "trace_closest_bvh", recorder(pt.trace_closest_bvh))]):
        pt.render_pass(room_view, bopts, BIG_W, BIG_H, 1000, 0)
    _, tris, o, d, tmin, tmax, active = rec[0]
    n = o.x.shape[0]
    walk = bvh_trace.trace_closest_bvh(bvh, tris, o, d, tmin, tmax, active)
    k5 = ft.trace_closest_frontier(bview.clusters, o, d, tmin, tmax, active, with_uv=False)
    torch.cuda.synchronize()
    same_t = bits(walk.t) == bits(k5.t)
    ties = int((same_t & (walk.tri != k5.tri)).sum())
    check(bool(same_t.all()), f"big_room camera rays: the walk's t differs from K5a's on "
                              f"{int((~same_t).sum())} of {n} rays")
    log(f"[4i options] big_room {BIG_W}x{BIG_H} camera rays: the walk's closest hits equal "
        f"K5a's on all {n} rays (t bit-equal; {ties} ties in t with another triangle id; "
        f"phase 6 holds the walk to its plain version on every ray of bounces 0 and 1); "
        f"{time.perf_counter() - t_phase:.1f} s for the phase")
    return {"cells": cells, "launches": launches, "bvh": bvh, "build_s": build_s, "ties": ties}


def bpt_phase(dev, smi: str, reset_counts, counts, bview, lobes: tuple) -> dict:
    """Phase 4j: the bidirectional path tracer and PSSMLT on the ported
    tracers (see the module docstring). Returns the cells' numbers and their
    launches per pass (a PSSMLT step is a pass)."""
    import numpy as np
    import torch

    from fermat_tpu_torch.core.rng import hash_combine
    from fermat_tpu_torch.integrators import bpt
    from fermat_tpu_torch.integrators import pssmlt as ps
    from fermat_tpu_torch.render.context import RenderingContext
    from fermat_tpu_torch.render.framebuffer import Framebuffer
    from fermat_tpu_torch.scene.procedural import cornell_box, cornell_camera
    from fermat_tpu_torch.scene.view import SceneView

    t_phase = time.perf_counter()
    bits = lambda t: t.contiguous().view(torch.int32)
    cells, launches = {}, {}
    dense_route = {"trace_closest", "trace_any", "gather_rows"}
    frontier_route = {"trace_closest_frontier", "trace_any_frontier", "gather_rows",
                      "frontier_sort_key"}
    # a pass of max_path_length L traces L-1 light and L-1 eye segments; its
    # shadow launches: one light-tracing launch over the L-1 slots, L-1 NEE
    # launches, L-1 connection launches (each over the L-1 slots)
    n_closest, n_any = 2 * (MPL - 1), 2 * (MPL - 1) + 1

    def drive(cell, ctx, key, passes):
        cells[cell] = drive_cell("4j bpt", cell, ctx, passes, smi, reset_counts, counts)
        launches[key] = cells[cell]["launches"]
        return launches[key]

    def splat_close(a, b) -> float:
        """max |a - b| over max |b|: index_add_ adds in no fixed order."""
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    def plain_equal(cell, view, opts, res_x, res_y):
        """One BPT pass with the kernels and one with every plain version
        forced: radiance and rays bit-equal, the splat image within
        BPT_SPLAT_RTOL of its max."""
        out_k = bpt.render_pass(view, opts, res_x, res_y, 1000, 0)
        before = counts()
        with patched(forced_plain(dev)):
            out_p = bpt.render_pass(view, opts, res_x, res_y, 1000, 0)
        torch.cuda.synchronize()
        check(before == counts(), f"{cell}: the forced plain pass launched a kernel")
        check(torch.equal(bits(out_k[0].stack()), bits(out_p[0].stack())),
              f"{cell}: kernel vs plain eye radiance not bit-equal")
        check(float(out_k[2]) == float(out_p[2]), f"{cell}: rays {float(out_k[2])} vs plain "
                                                  f"{float(out_p[2])}")
        err = splat_close(out_k[1], out_p[1])
        check(err <= BPT_SPLAT_RTOL, f"{cell}: splat {err:.3g} of max from the plain pass")
        log(f"[4j bpt] {cell} {res_x}x{res_y}: kernels vs forced plain versions: rays equal "
            f"({float(out_k[2]):.0f}), eye radiance bit-equal, splat within {err:.2e} of max")

    # ---- BPT on the CornellBox: K1a, K1b, K2 ----
    ctx = RenderingContext.create(cornell_box(glossy_boxes=True), cornell_camera(), RES, RES,
                                  renderer="bpt", max_path_length=MPL)
    per = drive("CornellBox bpt", ctx, "bpt_cornell", BPT_PASSES)
    check(per.get("trace_closest") == n_closest and per.get("trace_any") == n_any
          and per.get("gather_rows", 0) > 0 and set(per) == dense_route,
          f"CornellBox bpt launches per pass: {per}")
    plain_equal("CornellBox bpt", ctx.view, bpt.BPTOptions(**ctx.renderer_options), RES, RES)
    del ctx

    # ---- BPT on big_room: K5a, K5b (uv from the ray), K2 ----
    ropts = {"max_path_length": MPL, "lobes": lobes}
    rctx = RenderingContext(view=bview, res_x=BIG_W, res_y=BIG_H, renderer="bpt",
                            renderer_options=ropts)
    rctx.fb = Framebuffer.create(BIG_H, BIG_W, dev)
    per = drive("big_room bpt", rctx, "bpt_big_room", BPT_PASSES)
    check(per.get("trace_closest_frontier") == n_closest
          and per.get("trace_any_frontier") == n_any and set(per) == frontier_route,
          f"big_room bpt launches per pass: {per}")
    del rctx
    plain_equal("big_room bpt", bview, bpt.BPTOptions(**ropts), PLAIN_W, PLAIN_H)

    # ---- PSSMLT on the CornellBox, one chain a pixel ----
    for space in ("bpt", "pt"):
        cell = f"CornellBox pssmlt {space}"
        ctx = RenderingContext.create(cornell_box(glossy_boxes=True), cornell_camera(), RES,
                                      RES, renderer="pssmlt", max_path_length=MPL,
                                      path_space=space)
        opts = ps.PssmltOptions(**ctx.renderer_options)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        ctx.renderer_state = ps.init_state(ctx.view, opts, RES, RES, RES * RES, 0)
        torch.cuda.synchronize()
        init_ms = (time.perf_counter() - t0) * 1e3
        init_peak = torch.cuda.max_memory_allocated(dev) - base
        s0 = ctx.renderer_state
        s1, splat_k = ps.step(ctx.view, opts, RES, RES, s0)
        before = counts()
        with patched(forced_plain(dev)):
            s1p, splat_p = ps.step(ctx.view, opts, RES, RES, s0)
        torch.cuda.synchronize()
        check(before == counts(), f"{cell}: the forced plain step launched a kernel")
        check(torch.equal(bits(s1.u), bits(s1p.u)) and torch.equal(bits(s1.i_lum),
                                                                     bits(s1p.i_lum))
              and torch.equal(s1.pixel, s1p.pixel) and s1.key == s1p.key,
              f"{cell}: kernel vs plain chain state not bit-equal")
        err = splat_close(splat_k, splat_p)
        check(err <= BPT_SPLAT_RTOL, f"{cell}: splat {err:.3g} of max from the plain step")
        accept = float((s1.u != s0.u).any(dim=1).float().mean())
        u_prop = ps._mutate(s0.u, hash_combine(s0.key, 0x1234567), opts)
        check(bool(((s1.u == u_prop).all(dim=1) | (s1.u == s0.u).all(dim=1)).all()),
              f"{cell}: a chain holds neither its state nor its proposal")
        del s1, s1p, splat_k, splat_p, u_prop
        per = drive(cell, ctx, f"pssmlt_{space}", PSSMLT_STEPS)
        # path_space="pt": one PT pass a step (rr=False), a closest and an
        # NEE shadow launch a bounce
        want = (n_closest, n_any) if space == "bpt" else (MPL, MPL)
        check((per.get("trace_closest"), per.get("trace_any")) == want
              and set(per) == dense_route, f"{cell} launches per step: {per}")
        c = cells[cell]
        c.update(init_ms=init_ms, init_peak_bytes=init_peak, accept=accept,
                 mutations_per_s=RES * RES / c["ms"] * 1e3,
                 step_peak_bytes=c.get("peak_bytes", 0), dims=ps._dims(opts))
        hdr = ctx.hdr_image()
        check(np.isfinite(hdr).all() and float(hdr.mean()) > 0.001,
              f"{cell}: image not finite or black (mean {hdr.mean()})")
        log(f"[4j bpt] {cell} {RES}x{RES} mpl={MPL}: init_state {init_ms:.1f} ms "
            f"({opts.n_seed_candidates} candidates, D = {ps._dims(opts)}; peak memory "
            f"{init_peak / 2 ** 30:.2f} GiB above its start), {c['ms']:.2f} ms/step, "
            f"{c['mutations_per_s'] / 1e6:.3f} M mutations/s, acceptance {accept:.4f} on {smi};"
            f" one step bit-equal to forced plain (u, i_lum, pixel, key; splat within "
            f"{err:.2e} of max)")
        del ctx

    # ---- the BPT and PSSMLT golden on the card's kernel path ----
    gz = np.load(ROOT / "tests" / "golden" / "torch_port_bpt_24.npz")
    gres, gmpl = int(gz["res"]), int(gz["max_path_length"])
    gseed, ginst = int(gz["seed"]), int(gz["instance"])
    view_of = lambda p: SceneView.from_numpy({k[len(p):]: gz[k] for k in gz.files
                                              if k.startswith(p)}, dev)
    gviews, report = {}, []

    def held(name, view, opts, res):
        rad, splat, rays, _ = bpt.render_pass(view, opts, res, res, ginst, gseed)
        want = float(gz[f"{name}.rays"])
        check(abs(float(rays) - want) <= 0.005 * want,
              f"bpt golden {name}: rays {float(rays)} vs JAX {want}")
        worst = 1.0
        for part, got in (("rad", rad.stack()), ("splat", splat)):
            ok, near, mean_rel = image_close(got.cpu().numpy(), gz[f"{name}.{part}"])
            check(ok, f"bpt golden {name} {part}: {near:.4f} of pixels close, mean rel "
                      f"{mean_rel:.2e}")
            worst = min(worst, near)
        report.append(f"{name} ({opts.tracer}) rays {float(rays):.0f}/{want:.0f}, pixels close "
                      f">= {worst:.4f}")

    for name, (key, fields) in json.loads(str(gz["cases"])).items():
        if key not in gviews:
            gviews[key] = view_of(f"{key}.view.")
        held(name, gviews[key], bpt.BPTOptions(
            max_path_length=gmpl, lobes=tuple(bool(x) for x in gz[f"{key}.lobes"]), **fields),
            gres)
    bz = np.load(ROOT / "tests" / "golden" / "torch_port_bigroom_24.npz")
    room = SceneView.from_numpy({k[5:]: bz[k] for k in bz.files if k.startswith("view.")}, dev)
    for tracer in ("auto", "bvh"):
        held("big_room", room, bpt.BPTOptions(
            max_path_length=gmpl, lobes=tuple(bool(x) for x in gz["big_room.lobes"]),
            tracer=tracer), int(gz["big_res"]))
    pres, pn = int(gz["ps_res"]), int(gz["ps_chains"])
    for space in ("bpt", "pt"):
        p = f"ps_{space}."
        opts = ps.PssmltOptions(max_path_length=int(gz["ps_max_path_length"]),
                                n_seed_candidates=int(gz["ps_seed_candidates"]),
                                path_space=space)
        t = lambda k: torch.from_numpy(gz[p + k]).to(dev)
        s0 = ps.PssmltState(u=t("init.u"), i_lum=t("init.i_lum"), contrib=t("init.contrib"),
                            pixel=t("init.pixel"), brightness=t("init.brightness"),
                            key=int(gz[p + "init.key"]))
        s1, splat = ps.step(gviews["A"], opts, pres, pres, s0)
        # acceptance: a chain holds its proposal (JAX's and the port's
        # proposals differ in the last bits, exp and log round apart)
        took = (s1.u == ps._mutate(s0.u, hash_combine(s0.key, 0x1234567), opts)).all(dim=1)
        same = float((took == (t("step.u") == t("u_prop")).all(dim=1)).float().mean())
        check(same >= 0.99, f"pssmlt golden {space}: the same acceptance on {same:.4f} of chains")
        ok, near, mean_rel = image_close(splat.cpu().numpy(), gz[p + "splat"])
        check(ok, f"pssmlt golden {space} splat: {near:.4f} of pixels close, mean rel "
                  f"{mean_rel:.2e}")
        report.append(f"pssmlt {space} step: same acceptance on {same:.4f} of {pn} chains, "
                      f"splat pixels close {near:.4f}")
    log(f"[4j bpt] the BPT and PSSMLT golden (JAX on the CPU) on the card's kernel path within "
        f"the tolerances of tests/test_torch_bpt.py: " + "; ".join(report)
        + f"; {time.perf_counter() - t_phase:.1f} s for the phase")
    return {"cells": cells, "launches": launches}


def psf_phase(dev, smi: str, reset_counts, counts, bview, lobes: tuple) -> dict:
    """Phase 4k: the path-space-filtering tracer and the clustered-RL path
    tracer on the ported tracers (see the module docstring). Returns the
    cells' numbers and their launches per pass."""
    import copy

    import numpy as np
    import torch

    from fermat_tpu_torch.integrators import psfpt, ptrl
    from fermat_tpu_torch.integrators import rl
    from fermat_tpu_torch.render.context import RenderingContext
    from fermat_tpu_torch.render.framebuffer import Framebuffer
    from fermat_tpu_torch.scene import mesh_lights
    from fermat_tpu_torch.scene.procedural import cornell_box, cornell_camera
    from fermat_tpu_torch.scene.spatial_hash import HashAccumulator
    from fermat_tpu_torch.scene.view import SceneView

    t_phase = time.perf_counter()
    bits = lambda t: t.contiguous().view(torch.int32)
    cells, launches = {}, {}
    of_max = lambda a, b: float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
    dense = {"trace_closest": MPL, "trace_any": MPL}
    frontier = {"trace_closest_frontier": MPL, "trace_any_frontier": MPL,
                "frontier_sort_key": 2 * MPL}

    def drive(cell, key, ctx, want):
        """PSF_PASSES passes through render() from a fresh state (each ends
        in a sync), launches per pass, one profiled pass after them."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        reset_counts()
        rays0 = float(ctx.stats.get("rays", 0.0))
        ctx.render(PSF_PASSES)
        per = {n: c / PSF_PASSES for n, c in counts().items() if c}
        rays = (float(ctx.stats["rays"]) - rays0) / PSF_PASSES
        times = ctx.stats["pass_times"]
        ms = 1e3 * float(np.median(times[1:]))
        hdr = ctx.hdr_image()
        check(np.isfinite(hdr).all() and float(hdr.mean()) > 0.001,
              f"{cell}: image not finite or black (mean {hdr.mean()})")
        check(per == want, f"{cell} launches per pass: {per}, want {want}")
        n_kern, busy, top, each = profile_one_pass(
            ctx, expect=tuple(LIT_IN_PASS[n] for n in per if n in LIT_IN_PASS))
        in_pass = {n: 1e3 * sum(v) / len(v) for n, k in LIT_IN_PASS.items()
                   for v in [launches_named(each, k)] if v}
        peak = torch.cuda.max_memory_allocated(dev) - base
        log(f"[4k psf] {cell} {ctx.res_x}x{ctx.res_y} mpl={MPL}: {ms:.2f} ms/pass (median of "
            f"passes 2-{PSF_PASSES}; pass 1 {1e3 * times[0]:.1f} ms, each "
            + ", ".join(f"{1e3 * t:.1f}" for t in times[1:]) + f"), {rays / ms / 1e3:.3f} "
            f"Mrays/s ({rays:.0f} rays/pass) on {smi}; image mean {hdr.mean():.4f}; peak memory "
            f"{peak / 2 ** 30:.2f} GiB above the cell's start; launches per pass: {per}")
        log(f"[4k psf] {cell}: one pass under torch.profiler: {n_kern} device kernels, device "
            f"busy {busy:.2f} ms of the {ms:.2f} ms pass (idle share {1 - busy / ms:.3f}); route "
            "kernels' us a launch in it: " + ", ".join(f"{n} {v:.2f}" for n, v in in_pass.items())
            + "; top: " + "; ".join(f"{n[:60]} {t / 1e3:.2f} ms x{c}" for n, (t, c) in top))
        cells[cell] = dict(ms=ms, mrays=rays / ms / 1e3, rays=rays, kernels=n_kern,
                           busy_ms=busy, idle=1 - busy / ms, launches=per, in_pass_us=in_pass,
                           peak_bytes=peak, first_pass_ms=1e3 * times[0],
                           pass_ms=[1e3 * t for t in times])
        launches[key] = per

    forced = lambda fn: kernels_then_plain(dev, counts, fn)

    def psf_plain(cell, view, opts, res_x, res_y, state):
        (ik, sk, rk, _, lk), (ip, sp, rp, _, lp) = forced(lambda: psfpt.render_pass(
            view, opts, res_x, res_y, 1000, state, 0, with_psf=True))
        check(float(rk) == float(rp), f"{cell}: rays {float(rk)} vs plain {float(rp)}")
        check(all(torch.equal(a, b) for a, b in zip(lk, lp)),
              f"{cell}: PSF slots, keys or flags differ from the plain pass")
        check(torch.equal(sk.cells.key, sp.cells.key) and torch.equal(
            bits(sk.cells.weight), bits(sp.cells.weight)),
            f"{cell}: owner table or weights differ from the plain pass")
        errs = [of_max(getattr(sk.cells, f), getattr(sp.cells, f))
                for f in ("sum_x", "sum_y", "sum_z")] + [of_max(ik.stack(), ip.stack())]
        check(max(errs) <= PSF_RTOL, f"{cell}: sums / image {errs} of max from the plain pass")
        log(f"[4k psf] {cell} {res_x}x{res_y}: kernels vs forced plain versions: rays equal "
            f"({float(rk):.0f}), PSF slots and keys ({int(lk.has.sum())} lanes with a vertex), "
            f"owners and weights bit-equal; cell sums within {max(errs[:3]):.2e}, image within "
            f"{errs[3]:.2e} of max")

    def rl_plain(cell, view, opts, res_x, res_y, run):
        (ik, sk, rk, _), (ip, sp, rp, _) = forced(lambda: ptrl.render_pass(
            view, opts, run.clusters, res_x, res_y, 1000, run.state, 0))
        check(float(rk) == float(rp), f"{cell}: rays {float(rk)} vs plain {float(rp)}")
        check(torch.equal(bits(ik.stack()), bits(ip.stack())),
              f"{cell}: kernel vs plain image not bit-equal")
        err = of_max(sk.qstate.q, sp.qstate.q)
        check(err <= PSF_RTOL, f"{cell}: Q {err:.3g} of max from the plain pass")
        log(f"[4k psf] {cell} {res_x}x{res_y}: kernels vs forced plain versions: rays equal "
            f"({float(rk):.0f}), image bit-equal, new Q within {err:.2e} of max")

    def rl_host(cell, view, opts, run):
        """ptrl's host work timed apart: the clusters' build (the VTL set and
        its cut); the adaptation step of pass 8 on a copy of the run, as the
        pass ran it, and on a copy whose Q's column 0 is 50 times larger, so
        that the step pays (reclustering and the Q remap included)."""
        t0 = time.perf_counter()
        fresh = ptrl.start(view, opts)
        build_ms = 1e3 * (time.perf_counter() - t0)
        ms = []
        for scale in (1.0, 50.0):
            q = run.state.qstate.q.clone()
            q[:, 0] *= scale
            trial = run._replace(passes=opts.adapt_every - 1, cut=copy.deepcopy(run.cut),
                                 state=ptrl.PtrlState(rl.RLState(q)))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            after = ptrl.adapt(trial, opts)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            paid = after.cut.cut != run.cut.cut
        check(paid, f"{cell}: the adaptation step does not pay with an uneven Q")
        moved = run.cut.cut != fresh.cut.cut
        log(f"[4k psf] {cell}: host VTL set and cut build {build_ms:.1f} ms "
            f"({fresh.clusters.n_vtls} VTLs, {fresh.cut.n_clusters} clusters); the adaptation "
            f"step {ms[0]:.2f} ms as pass 8 ran it (Q's mean to the host, the cut step; after "
            f"{PSF_PASSES} passes the cut {'moved' if moved else 'stayed: no step paid'}), "
            f"{ms[1]:.2f} ms with column 0 of Q x50 (the step pays: reclustering and the Q "
            f"remap)")
        cells[cell].update(build_ms=build_ms, adapt_ms=ms[0], adapt_paying_ms=ms[1],
                           cut_moved=moved, n_vtls=fresh.clusters.n_vtls)

    # ---- the CornellBox: K1a, K1b, K2 ----
    storage = cornell_box(glossy_boxes=True)
    ctx = RenderingContext.create(storage, cornell_camera(), RES, RES, renderer="psfpt",
                                  max_path_length=MPL)
    drive("CornellBox psfpt", "psfpt_cornell", ctx, {**dense, "gather_rows": 17})
    psf_plain("CornellBox psfpt", ctx.view, psfpt.PsfptOptions(**ctx.renderer_options), RES,
              RES, ctx.renderer_state)
    ctx = RenderingContext.create(storage, cornell_camera(), RES, RES, renderer="ptrl",
                                  max_path_length=MPL)
    drive("CornellBox ptrl", "ptrl_cornell", ctx, {**dense, "gather_rows": 12})
    opts = ptrl.PtrlOptions(**ctx.renderer_options)
    rl_plain("CornellBox ptrl", ctx.view, opts, RES, RES, ctx.renderer_state)
    rl_host("CornellBox ptrl", ctx.view, opts, ctx.renderer_state)
    del ctx

    # ---- big_room: K5a, K5b ((u, v) from the ray), K4 (psfpt), K2 ----
    ropts = {"max_path_length": MPL, "lobes": lobes}
    for renderer, want in (("psfpt", {**frontier, "cdf_pick_rows": MPL, "gather_rows": 11}),
                           ("ptrl", {**frontier, "gather_rows": 12})):
        cell = f"big_room {renderer}"
        rctx = RenderingContext(view=bview, res_x=BIG_W, res_y=BIG_H, renderer=renderer,
                                renderer_options=ropts)
        rctx.fb = Framebuffer.create(BIG_H, BIG_W, dev)
        drive(cell, f"{renderer}_big_room", rctx, want)
        if renderer == "psfpt":
            psf_plain(cell, bview, psfpt.PsfptOptions(**ropts), PLAIN_W, PLAIN_H,
                      rctx.renderer_state)
        else:
            opts = ptrl.PtrlOptions(**ropts)
            rl_plain(cell, bview, opts, PLAIN_W, PLAIN_H, rctx.renderer_state)
            rl_host(cell, bview, opts, rctx.renderer_state)
        del rctx
    torch.cuda.empty_cache()

    # ---- the golden on the card's kernel path ----
    gz = np.load(ROOT / "tests" / "golden" / "torch_port_psf_24.npz")
    bz = np.load(ROOT / "tests" / "golden" / "torch_port_bigroom_24.npz")
    gseed = int(gz["seed"])
    views, report = {}, []

    def view_of(scene):
        if scene not in views:
            z, p = (bz, "view.") if scene == "big_room" else (gz, f"{scene}.view.")
            views[scene] = SceneView.from_numpy({k[len(p):]: z[k] for k in z.files
                                                 if k.startswith(p)}, dev)
        return views[scene]

    t = lambda k: torch.from_numpy(gz[k]).to(dev)
    for name, (scene, renderer, fields, passes) in json.loads(str(gz["cases"])).items():
        big = scene == "big_room"
        res = int(gz["big_res"]) if big else int(gz["res"])
        view, lobes_s = view_of(scene), tuple(bool(x) for x in gz[f"{scene}.lobes"])
        worst = 1.0
        for tracer in (("auto", "bvh") if big else ("auto",)):
            for k in range(1 if tracer == "bvh" else passes):
                if renderer == "psfpt":
                    opts = psfpt.PsfptOptions(lobes=lobes_s, tracer=tracer, **fields)
                    state = (psfpt.init_state(view, opts) if k == 0 else psfpt.PsfptState(
                        HashAccumulator.from_numpy(*(gz[f"{name}.{k}.cells.{f}"] for f in (
                            "sum_x", "sum_y", "sum_z", "weight", "key")), dev)))
                    img, state, rays, _ = psfpt.render_pass(view, opts, res, res, k, state,
                                                            gseed)
                else:
                    opts = ptrl.PtrlOptions(lobes=lobes_s, tracer=tracer, **fields)
                    run = ptrl.start(view, opts)
                    if k:
                        if run.cut is not None:
                            run.cut.cut = list(gz[f"{name}.{k}.cut"])
                            run = run._replace(clusters=mesh_lights.VTLView.from_numpy(
                                {f: gz[f"{name}.{k}.vtl.{f}"]
                                 for f in mesh_lights.VTLView._fields[:-1]},
                                opts.n_clusters, dev))
                        run = run._replace(state=ptrl.PtrlState(rl.RLState(t(f"{name}.{k}.q"))),
                                           passes=k)
                    elif f"{name}.q0" in gz.files:
                        run = run._replace(state=ptrl.PtrlState(rl.RLState(t(f"{name}.q0"))))
                    img, rays, _, run = ptrl.step(view, opts, run, res, res, k, gseed)
                    if run.cut is not None:
                        check(run.cut.cut == list(gz[f"{name}.{k + 1}.cut"]),
                              f"psf golden {name} pass {k + 1}: the cut differs from JAX's")
                want = float(gz[f"{name}.{k + 1}.rays"])
                check(float(rays) == want or (big and abs(float(rays) - want) <= 0.005 * want),
                      f"psf golden {name} ({tracer}) pass {k + 1}: rays {float(rays)} vs JAX "
                      f"{want}")
                ok, near, mean_rel = image_close(img.stack().cpu().numpy(),
                                                 gz[f"{name}.{k + 1}.img"])
                check(ok, f"psf golden {name} ({tracer}) pass {k + 1}: {near:.4f} of pixels "
                          f"close, mean rel {mean_rel:.2e}")
                worst = min(worst, near)
        report.append(f"{name} pixels close >= {worst:.4f}")
    log("[4k psf] the psfpt and ptrl golden (JAX on the CPU; each pass from JAX's state "
        "before it) on the card's kernel path within the tolerances of "
        "tests/test_torch_psf.py: " + "; ".join(report)
        + f"; {time.perf_counter() - t_phase:.1f} s for the phase")
    return {"cells": cells, "launches": launches}


def reckon_peak(renderer: str, n: int, K: int, rounds: int = 8) -> int:
    """Phase 4l's reckoning of a cell's peak device bytes above its start,
    printed before the big_room run: the shade rows (52 float32) the step
    keeps alive, one a vertex, plus the chain state; for cmlt's init_state
    a walk's slots and the (round, chart, lane) luminances with their
    float64 and float32 prefix sums."""
    LS = max(K - 2, 1)
    row = 52 * 4
    if renderer == "mlt":
        # a step: K + LS old and new vertices and y_0, the state, the temporaries
        return n * ((2 * (K + LS) + 1) * row + 3 * 4 * (K + LS) + 600)
    n_charts = sum(K + 2 - t for t in range(2, K + 2)) + K - 1
    return n * ((K + LS) * (row + 26 * 4) + rounds * n_charts * (4 + 8 + 4) + 600)


def mlt_phase(dev, smi: str, reset_counts, counts, bview, lobes: tuple) -> dict:
    """Phase 4l: path-space MLT and charted MLT on the ported tracers (see
    the module docstring). Returns the cells' numbers and their launches
    per pass (a cmlt step is a pass)."""
    import numpy as np
    import torch

    from fermat_tpu_torch.integrators import cmlt, mlt
    from fermat_tpu_torch.render.context import RenderingContext
    from fermat_tpu_torch.render.framebuffer import Framebuffer
    from fermat_tpu_torch.scene.procedural import cornell_box, cornell_camera
    from fermat_tpu_torch.scene.view import SceneView

    t_phase = time.perf_counter()
    bits = lambda t: t.contiguous().view(torch.int32)
    cells, launches = {}, {}
    of_max = lambda a, b: float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
    K = MPL
    LS = K - 2
    routes = {"dense": ("trace_closest", "trace_any"),
              "frontier": ("trace_closest_frontier", "trace_any_frontier")}

    def mlt_launches(route):
        """The tracer launches of a default MLT pass: the presample's LS + K
        closest and K-1 + pairs shadow launches, K + LS + 1 closest and one
        shadow launch a perturbation step, none in an ST swap."""
        opts = mlt.MLTOptions(max_path_length=K)
        pert = sum(not mlt.is_swap_step(opts, i) for i in range(opts.steps_per_pass))
        pairs = sum(1 for i in range(K) for j in range(LS) if i + j + 3 <= K)
        c, a = routes[route]
        return {c: LS + K + pert * (K + LS + 1), a: K - 1 + pairs + pert}

    def cmlt_launches(route, swap):
        """A cmlt step's tracer launches: one walk (2K - 2 closest) and one
        connection, twice in a chart swap."""
        c, a = routes[route]
        return {c: (2 if swap else 1) * (2 * K - 2), a: 2 if swap else 1}

    def states_equal(a, b) -> bool:
        for x, y in zip(a, b):
            if isinstance(x, torch.Tensor):
                if x.dtype == torch.float32:
                    x, y = bits(x), bits(y)
                if not torch.equal(x, y):
                    return False
            elif x != y:
                return False
        return True

    def moved(new, old):
        out = None
        for x, y in zip(new, old):
            if isinstance(x, torch.Tensor) and x.ndim:
                m = (x != y).reshape(x.shape[0], -1).any(dim=1)
                out = m if out is None else out | m
        return out

    def drive(cell, key, ctx, passes, want, init=None):
        """`passes` passes through render(), each synced, its launches held
        to want(i) (the tracer launches; K2 counted), one profiled pass
        after them; cmlt's init_state timed apart first."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        extra, state0 = {}, None
        if init is not None:
            t0 = time.perf_counter()
            ctx.renderer_state = state0 = init()
            torch.cuda.synchronize()
            extra = dict(init_ms=1e3 * (time.perf_counter() - t0),
                         init_peak_bytes=torch.cuda.max_memory_allocated(dev) - base)
        per, rays = [], []
        for i in range(passes):
            reset_counts()
            ctx.render(1)
            got = {n: c for n, c in counts().items() if c}
            tr = {n: c for n, c in got.items() if n in want(i)}
            check(tr == want(i) and got.get("gather_rows", 0) > 0
                  and set(got) <= set(want(i)) | {"gather_rows", "frontier_sort_key"},
                  f"{cell} pass {i + 1} launches {got}, want the tracers' {want(i)}")
            per.append(got)
            rays.append(float(ctx.gbuffer["rays"]))
        times = ctx.stats["pass_times"][-passes:]
        ms = 1e3 * float(np.median(times))
        hdr = ctx.hdr_image()
        check(np.isfinite(hdr).all() and float(hdr.mean()) > 0.001,
              f"{cell}: image not finite or black (mean {hdr.mean()})")
        n_kern, busy, top, each = profile_one_pass(
            ctx, expect=tuple(LIT_IN_PASS[n] for n in per[-1] if n in LIT_IN_PASS))
        prof_ms = 1e3 * ctx.stats["batch_times"][-1][1]
        in_pass = {n: 1e3 * sum(v) / len(v) for n, k in LIT_IN_PASS.items()
                   for v in [launches_named(each, k)] if v}
        peak = torch.cuda.max_memory_allocated(dev) - base
        avg = {n: sum(p.get(n, 0) for p in per) / passes for n in set().union(*per)}
        ray = float(np.mean(rays))
        log(f"[4l mlt] {cell} {ctx.res_x}x{ctx.res_y} mpl={K}: {ms:.2f} ms/pass (median of "
            f"{passes}: " + ", ".join(f"{1e3 * t:.1f}" for t in times) + f"), "
            f"{ray / ms / 1e3:.3f} Mrays/s ({ray:.0f} rays/pass) on {smi}; image mean "
            f"{hdr.mean():.4f}; peak memory {peak / 2 ** 30:.2f} GiB above the cell's start"
            + (f"; init_state {extra['init_ms']:.1f} ms (peak "
               f"{extra['init_peak_bytes'] / 2 ** 30:.2f} GiB)" if extra else "")
            + f"; launches per pass: {per}")
        log(f"[4l mlt] {cell}: one pass under torch.profiler: {n_kern} device kernels, device "
            f"busy {busy:.2f} ms of the {prof_ms:.2f} ms pass (idle share "
            f"{1 - busy / prof_ms:.3f}); route kernels' us a launch in it: "
            + ", ".join(f"{n} {v:.2f}" for n, v in in_pass.items())
            + "; top: " + "; ".join(f"{n[:60]} {t / 1e3:.2f} ms x{c}" for n, (t, c) in top))
        cells[cell] = dict(ms=ms, mrays=ray / ms / 1e3, rays=ray, kernels=n_kern, busy_ms=busy,
                           prof_ms=prof_ms, idle=1 - busy / prof_ms, launches=avg,
                           in_pass_us=in_pass, peak_bytes=peak,
                           pass_ms=[1e3 * t for t in times], **extra)
        launches[key] = avg
        return state0

    forced = lambda fn: kernels_then_plain(dev, counts, fn)

    def chains_plain(cell, what, run):
        """run() -> (chain states, the steps' splats, rays) with the kernels
        and with every plain version forced: the states bit-equal, the rays
        equal, the splats within BPT_SPLAT_RTOL of max. Returns the share of
        chains that moved at each step of the kernels' run."""
        (sk, pk, rk), (sp, pp, rp) = forced(run)
        check(rk == rp, f"{cell}: rays {rk} vs plain {rp}")
        check(all(states_equal(a, b) for a, b in zip(sk, sp)),
              f"{cell}: kernel vs plain chain states not bit-equal")
        err = max(of_max(a, b) for a, b in zip(pk, pp))
        check(err <= BPT_SPLAT_RTOL, f"{cell}: splat {err:.3g} of max from the plain steps")
        acc = [float(moved(b, a).float().mean()) for a, b in zip(sk, sk[1:])]
        log(f"[4l mlt] {cell}: {what} vs forced plain versions: rays equal ("
            + ", ".join(f"{r:.0f}" for r in rk) + f"), states bit-equal, splats within {err:.2e}"
            " of max; chains that moved a step: " + ", ".join(f"{a:.4f}" for a in acc))
        return acc

    def mlt_run(view, opts, res_x, res_y):
        """The presample and steps 0-3 (step 3 an ST swap)."""
        def run():
            st, r = mlt.presample(view, opts, res_x, res_y, 1000, 0)
            states, splats, rays = [st], [], [float(r)]
            for k in range(4):
                st, sp, r = mlt.step(view, opts, res_x, res_y, 1000, 0, st, k)
                states.append(st)
                splats.append(sp)
                rays.append(float(r))
            return states, splats, rays
        return run

    def cmlt_run(view, opts, res_x, res_y, state):
        """Steps 0-2 (step 2 a chart swap) from `state`."""
        def run():
            st, states, splats, rays = state, [state], [], []
            for _ in range(3):
                st, sp, r = cmlt.step(view, opts, res_x, res_y, st)
                states.append(st)
                splats.append(sp)
                rays.append(float(r))
            return states, splats, rays
        return run

    storage = cornell_box(glossy_boxes=True)
    ropts = {"max_path_length": K, "lobes": lobes}
    n_big = BIG_W * BIG_H

    def room_ctx(renderer):
        ctx = RenderingContext(view=bview, res_x=BIG_W, res_y=BIG_H, renderer=renderer,
                               renderer_options=dict(ropts))
        ctx.fb = Framebuffer.create(BIG_H, BIG_W, dev)
        return ctx

    # ---- the timed cells: mlt, then cmlt, on the CornellBox (K1a, K1b, K2)
    # and on big_room (K5a, K5b, K2) ----
    ctx = RenderingContext.create(storage, cornell_camera(), RES, RES, renderer="mlt",
                                  max_path_length=K)
    cb_view, m_opts = ctx.view, mlt.MLTOptions(**ctx.renderer_options)
    drive("CornellBox mlt", "mlt_cornell", ctx, MLT_PASSES, lambda i: mlt_launches("dense"))
    del ctx
    log(f"[4l mlt] big_room mlt: reckoned peak {reckon_peak('mlt', n_big, K) / 2 ** 30:.2f} GiB "
        f"above the cell's start at {n_big} chains")
    drive("big_room mlt", "mlt_big_room", room_ctx("mlt"), MLT_PASSES,
          lambda i: mlt_launches("frontier"))
    torch.cuda.empty_cache()
    copts = lambda: cmlt.CMLTOptions(**ropts)
    swap = lambda i: cmlt.is_swap_step(copts(), i)
    ctx = RenderingContext.create(storage, cornell_camera(), RES, RES, renderer="cmlt",
                                  max_path_length=K)
    c_opts = cmlt.CMLTOptions(**ctx.renderer_options)
    cb_s0 = drive("CornellBox cmlt", "cmlt_cornell", ctx, CMLT_STEPS,
                  lambda i: cmlt_launches("dense", swap(i)),
                  init=lambda: cmlt.init_state(cb_view, c_opts, RES, RES, RES * RES, 0))
    del ctx
    log(f"[4l mlt] big_room cmlt: reckoned init_state peak "
        f"{reckon_peak('cmlt', n_big, K) / 2 ** 30:.2f} GiB above the cell's start at {n_big} "
        "chains")
    drive("big_room cmlt", "cmlt_big_room", room_ctx("cmlt"), CMLT_STEPS,
          lambda i: cmlt_launches("frontier", swap(i)),
          init=lambda: cmlt.init_state(bview, copts(), BIG_W, BIG_H, n_big, 0))
    torch.cuda.empty_cache()

    def golden_held():
        """The golden on the card's kernel path."""
        gz = np.load(ROOT / "tests" / "golden" / "torch_port_mlt_24.npz")
        bz = np.load(ROOT / "tests" / "golden" / "torch_port_bigroom_24.npz")
        gseed, views, report = int(gz["seed"]), {}, []
        for name, (scene, renderer, fields) in json.loads(str(gz["cases"])).items():
            if scene not in views:
                z, p = (bz, "view.") if scene == "big_room" else (gz, f"{scene}.view.")
                views[scene] = SceneView.from_numpy({k[len(p):]: z[k] for k in z.files
                                                     if k.startswith(p)}, dev)
            view = views[scene]
            res = int(gz["big_res"]) if scene == "big_room" else int(gz["res"])
            lobes_s = tuple(bool(x) for x in gz[f"{scene}.lobes"])
            if renderer == "mlt":
                opts, cls = mlt.MLTOptions(lobes=lobes_s, **fields), mlt.ChainState
                n_steps = opts.steps_per_pass
                state = mlt.presample(view, opts, res, res, 0, gseed)[0]
            else:
                opts, cls = cmlt.CMLTOptions(lobes=lobes_s, **fields), cmlt.CMLTState
                state, n_steps = cmlt.init_state(view, opts, res, res, res * res, gseed), 3
            load = lambda k: cls.from_numpy({f: gz[f"{name}.{k}.{f}"] for f in cls._fields},
                                            dev)
            seeded = min(float((x == y).reshape(x.shape[0], -1).all(dim=1).float().mean())
                         for x, y in zip(state, load(0)) if isinstance(x, torch.Tensor)
                         and x.dtype in (torch.int32, torch.int64, torch.bool))
            check(seeded >= 0.99,
                  f"mlt golden {name}: seeded ids equal on {seeded:.4f} of chains")
            worst, same_min = 1.0, 1.0
            for k in range(n_steps):
                old = load(k)
                if renderer == "mlt":
                    new, splat, rays = mlt.step(view, opts, res, res, 0, gseed, old, k)
                else:
                    new, splat, rays = cmlt.step(view, opts, res, res, old)
                same = float((moved(new, old) == moved(load(k + 1), old)).float().mean())
                ok, near, mean_rel = image_close(splat.cpu().numpy(),
                                                 gz[f"{name}.{k + 1}.splat"])
                want = float(gz[f"{name}.{k + 1}.rays"])
                check(same >= 0.99 and ok and abs(float(rays) - want) <= 0.005 * want,
                      f"mlt golden {name} step {k}: same decision on {same:.4f}, splat pixels "
                      f"close {near:.4f} (mean rel {mean_rel:.2e}), rays {float(rays)} vs {want}")
                worst, same_min = min(worst, near), min(same_min, same)
            report.append(f"{name} seeded ids {seeded:.4f}, decisions >= {same_min:.4f}, splat "
                          f"pixels >= {worst:.4f}")
        log("[4l mlt] the mlt and cmlt golden (JAX on the CPU; each step from JAX's state "
            "before it) on the card's kernel path within the tolerances of "
            "tests/test_torch_mlt.py: " + "; ".join(report))

    # ---- convergence to PT on JAX's test scene (tests/test_mlt.py,
    # test_cmlt.py): the four renders are host-bound, so each runs in a
    # process of its own, started after the timed cells; the checks against
    # the plain versions and the golden, untimed, run meanwhile ----
    cres = CONV_RES
    t0 = time.perf_counter()
    imgs = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        procs = {}
        try:
            for tag in CONV_CASES:
                with open(tmp / f"{tag}.log", "w") as out:
                    procs[tag] = subprocess.Popen(
                        [sys.executable, str(ROOT / "chip_smoke.py"), "--convergence", tag,
                         str(tmp / f"{tag}.npz")], stdout=out, stderr=subprocess.STDOUT)
            m_steps = "presample and steps 0-3 (step 3 the ST swap)"
            c_steps = "steps 0-2 (step 2 the chart swap)"
            cells["CornellBox mlt"]["accept"] = chains_plain(
                f"CornellBox mlt {RES}x{RES}", m_steps, mlt_run(cb_view, m_opts, RES, RES))
            cells["big_room mlt"]["accept"] = chains_plain(
                f"big_room mlt {PLAIN_W}x{PLAIN_H}", m_steps,
                mlt_run(bview, mlt.MLTOptions(**ropts), PLAIN_W, PLAIN_H))
            cells["CornellBox cmlt"]["accept"] = chains_plain(
                f"CornellBox cmlt {RES}x{RES}", c_steps, cmlt_run(cb_view, c_opts, RES, RES,
                                                                  cb_s0))
            del cb_s0
            s0 = cmlt.init_state(bview, copts(), PLAIN_W, PLAIN_H, PLAIN_W * PLAIN_H, 0)
            cells["big_room cmlt"]["accept"] = chains_plain(
                f"big_room cmlt {PLAIN_W}x{PLAIN_H}", c_steps,
                cmlt_run(bview, copts(), PLAIN_W, PLAIN_H, s0))
            del s0
            torch.cuda.empty_cache()
            golden_held()
            t_wait = time.perf_counter()
            for tag, proc in procs.items():
                rc = proc.wait(timeout=CONV_TIMEOUT)
                check(rc == 0, f"convergence {tag}: exit {rc}: "
                               f"{(tmp / f'{tag}.log').read_text()[-2000:]}")
                z = np.load(tmp / f"{tag}.npz")
                imgs[tag] = (z["img"], float(z["seconds"]))
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    log(f"[4l mlt] the convergence processes ran {time.perf_counter() - t0:.1f} s, "
        f"{time.perf_counter() - t_wait:.1f} s of it waited for after the checks above")

    def pool(x):
        return x.reshape(4, cres // 4, 4, cres // 4, 3).mean((1, 3))

    img_pt, t_pt = imgs["pt"]
    m_pt = img_pt.mean((0, 1))
    conv = {}
    for tag, pooled in (("mlt", 0.15), ("cmlt", 0.17), ("mlt_swap2", None)):
        img, secs = imgs[tag]
        check(np.isfinite(img).all(), f"convergence {tag}: image not finite")
        m = img.mean((0, 1))
        rel = float((np.abs(m_pt - m) / np.maximum(m_pt, 1e-3)).max())
        a, b = pool(img_pt), pool(img)
        relp = float((np.abs(a - b) / np.maximum(np.maximum(a, b), 0.05)).mean())
        check(rel < 0.08 and (pooled is None or relp < pooled),
              f"convergence {tag}: channel means {m} vs PT {m_pt} (max rel {rel:.4f}, bound "
              f"0.08), pooled error {relp:.4f} (bound {pooled})")
        conv[tag] = dict(rel=rel, pooled=relp, seconds=secs)
        renderer, passes, kw = CONV_CASES[tag]
        log(f"[4l mlt] convergence {tag} ({renderer}, {passes} passes {kw} at {cres}x{cres}, "
            f"{secs:.1f} s) to PT (192 passes, rr=False, {t_pt:.1f} s): channel means {m} vs "
            f"{m_pt}, max rel {rel:.4f} (< 0.08), 4x4-pooled error {relp:.4f}"
            + (f" (< {pooled})" if pooled else ""))
    log(f"[4l mlt] phase {time.perf_counter() - t_phase:.1f} s")
    return {"cells": cells, "launches": launches, "convergence": conv}


def start_processes(tmp: Path, jobs: dict) -> dict:
    """Popen each argv of `jobs` (tag -> argv), its output to tmp/<tag>.log."""
    procs = {}
    for tag, argv in jobs.items():
        with open(tmp / f"{tag}.log", "w") as out:
            procs[tag] = subprocess.Popen(argv, stdout=out, stderr=subprocess.STDOUT, cwd=ROOT)
    return procs


def wait_processes(tmp: Path, procs: dict, timeout: float) -> None:
    """Wait for every process; a non-zero exit fails with its log's tail."""
    for tag, proc in procs.items():
        rc = proc.wait(timeout=timeout)
        check(rc == 0, f"{tag}: exit {rc}: {(tmp / f'{tag}.log').read_text()[-2000:]}")


def stop_processes(procs: dict) -> None:
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def rpt_phase(dev, smi: str, reset_counts, counts, bview, lobes: tuple) -> dict:
    """Phase 4m: the reuse path tracer and JAX's tracer names (see the
    module docstring). Returns the cells' numbers and their launches per
    pass."""
    import numpy as np
    import torch

    from fermat_tpu_torch.integrators import pt
    from fermat_tpu_torch.integrators import rpt
    from fermat_tpu_torch.render.context import RenderingContext
    from fermat_tpu_torch.render.framebuffer import Framebuffer
    from fermat_tpu_torch.scene.procedural import cornell_box, cornell_camera

    t_phase = time.perf_counter()
    bits = lambda t: t.contiguous().view(torch.int32)
    cells, launches = {}, {}
    # x, y and MPL - 2 walk bounces; NEE at x, y and each walk vertex, and
    # the two reuse connections
    n_any = MPL + rpt.RPTOptions().reuse_shadow_samples
    dense = {"trace_closest": MPL, "trace_any": n_any}
    frontier = {"trace_closest_frontier": MPL, "trace_any_frontier": n_any,
                "cdf_pick_rows": MPL, "frontier_sort_key": MPL + n_any}

    def drive(cell, key, ctx, want):
        """A warm-up pass, RPT_PASSES passes through render() (each synced),
        their launches held to `want` (K2 counted), one profiled pass."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        ctx.render(1)
        per, rays = [], []
        for i in range(RPT_PASSES):
            reset_counts()
            ctx.render(1)
            got = {n: c for n, c in counts().items() if c}
            check({n: c for n, c in got.items() if n in want} == want
                  and got.get("gather_rows", 0) > 0 and set(got) <= set(want) | {"gather_rows"},
                  f"{cell} pass {i + 1} launches {got}, want {want} and K2")
            per.append(got)
            rays.append(float(ctx.gbuffer["rays"]))
        times = ctx.stats["pass_times"][-RPT_PASSES:]
        ms = 1e3 * float(np.median(times))
        hdr = ctx.hdr_image()
        check(np.isfinite(hdr).all() and float(hdr.mean()) > 0.001,
              f"{cell}: image not finite or black (mean {hdr.mean()})")
        n_kern, busy, top, each = profile_one_pass(
            ctx, expect=tuple(LIT_IN_PASS[n] for n in per[-1] if n in LIT_IN_PASS))
        prof_ms = 1e3 * ctx.stats["batch_times"][-1][1]
        in_pass = {n: 1e3 * sum(v) / len(v) for n, k in LIT_IN_PASS.items()
                   for v in [launches_named(each, k)] if v}
        peak = torch.cuda.max_memory_allocated(dev) - base
        ray = float(np.mean(rays))
        log(f"[4m rpt] {cell} {ctx.res_x}x{ctx.res_y} mpl={MPL}: {ms:.2f} ms/pass (median of "
            f"{RPT_PASSES}: " + ", ".join(f"{1e3 * t:.1f}" for t in times) + f"), "
            f"{ray / ms / 1e3:.3f} Mrays/s ({ray:.0f} rays/pass by its counter) on {smi}; image "
            f"mean {hdr.mean():.4f}; peak memory {peak / 2 ** 30:.2f} GiB above the cell's start;"
            f" launches per pass: {per[-1]}")
        log(f"[4m rpt] {cell}: one pass under torch.profiler: {n_kern} device kernels, device "
            f"busy {busy:.2f} ms of the {prof_ms:.2f} ms pass (idle share "
            f"{1 - busy / prof_ms:.3f}); route kernels' us a launch in it: "
            + ", ".join(f"{n} {v:.2f}" for n, v in in_pass.items())
            + "; top: " + "; ".join(f"{n[:60]} {t / 1e3:.2f} ms x{c}" for n, (t, c) in top))
        cells[cell] = dict(ms=ms, mrays=ray / ms / 1e3, rays=ray, kernels=n_kern, busy_ms=busy,
                           prof_ms=prof_ms, idle=1 - busy / prof_ms, launches=per[-1],
                           in_pass_us=in_pass, peak_bytes=peak,
                           pass_ms=[1e3 * t for t in times])
        launches[key] = per[-1]

    def rpt_plain(cell, view, opts, res_x, res_y):
        """One pass with the kernels and one with every plain version
        forced: rays, the rays per pixel and the radiance bit-equal."""
        run = lambda: rpt.render_pass(view, opts, res_x, res_y, 1000, 0)
        (rk, nk, lk), (rp, np_, lp) = kernels_then_plain(dev, counts, run)
        check(float(nk) == float(np_) and torch.equal(lk, lp)
              and torch.equal(bits(rk.stack()), bits(rp.stack())),
              f"{cell}: the rpt pass is not bit-equal to its forced plain versions (rays "
              f"{float(nk)} vs {float(np_)})")
        log(f"[4m rpt] {cell} {res_x}x{res_y}: a pass with the kernels and one with every "
            f"plain version forced: rays equal ({float(nk):.0f}), radiance and rays per pixel "
            "bit-equal")

    # ---- the timed cells: the glossy CornellBox (K1a, K1b, K2) and big_room
    # (K5a, K5b, K4, K2) ----
    ctx = RenderingContext.create(cornell_box(glossy_boxes=True), cornell_camera(), RES, RES,
                                  renderer="rpt", max_path_length=MPL)
    drive("CornellBox rpt", "rpt_cornell", ctx, dense)
    cb_view, cb_opts = ctx.view, rpt.RPTOptions(**ctx.renderer_options)
    del ctx
    n_big, pairs = BIG_W * BIG_H, BIG_W * BIG_H * 16
    log(f"[4m rpt] big_room rpt: {pairs} (pixel, VPL) pairs, one (tiles, 16, 16) float32 "
        f"tensor {pairs * 4 / 2 ** 20:.1f} MiB")
    rctx = RenderingContext(view=bview, res_x=BIG_W, res_y=BIG_H, renderer="rpt",
                            renderer_options={"max_path_length": MPL, "lobes": lobes})
    rctx.fb = Framebuffer.create(BIG_H, BIG_W, dev)
    drive("big_room rpt", "rpt_big_room", rctx, frontier)
    del rctx
    torch.cuda.empty_cache()

    # ---- JAX's convergence bounds (tests/test_rpt.py, tests/test_envmap.py)
    # in processes of their own, started after the timed cells; the checks
    # against the plain versions run meanwhile ----
    t0 = time.perf_counter()
    imgs = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        procs = {}
        try:
            procs = start_processes(tmp, {
                tag: [sys.executable, str(ROOT / "chip_smoke.py"), "--convergence", tag,
                      str(tmp / f"{tag}.npz")] for tag in RPT_CONV_CASES})
            rpt_plain("CornellBox rpt", cb_view, cb_opts, RES, RES)
            rpt_plain("big_room rpt", bview, rpt.RPTOptions(max_path_length=MPL, lobes=lobes),
                      PLAIN_W, PLAIN_H)
            # JAX's tracer names: the dense route, bit-equal to tracer="dense"
            for name in ("brute", "pallas"):
                outs = []
                for tracer in (name, "dense"):
                    reset_counts()
                    outs.append(pt.render_pass(cb_view, pt.PTOptions(tracer=tracer,
                                                                     lobes=cb_opts.lobes),
                                               RES, RES, 7, 0))
                    torch.cuda.synchronize()
                    check(counts()["trace_closest"] == MPL,
                          f"tracer={tracer!r}: {counts()['trace_closest']} K1a launches")
                check(float(outs[0].rays) == float(outs[1].rays)
                      and all(torch.equal(bits(getattr(outs[0], c).stack()),
                                          bits(getattr(outs[1], c).stack()))
                              for c in ("composited", "direct", "diffuse", "specular")),
                      f"tracer={name!r}: the pass is not bit-equal to tracer='dense'")
            log(f"[4m rpt] tracer='brute' and 'pallas': K1a {MPL} a pass, each PT pass at "
                f"{RES}x{RES} bit-equal to tracer='dense'")
            del outs
            t_wait = time.perf_counter()
            wait_processes(tmp, procs, CONV_TIMEOUT)
            for tag in RPT_CONV_CASES:
                z = np.load(tmp / f"{tag}.npz")
                imgs[tag] = (z["img"], float(z["seconds"]))
        finally:
            stop_processes(procs)
    log(f"[4m rpt] the convergence processes ran {time.perf_counter() - t0:.1f} s, "
        f"{time.perf_counter() - t_wait:.1f} s of it waited for after the checks above")
    cres = CONV_RES
    pool = lambda x: x.reshape(4, cres // 4, 4, cres // 4, 3).mean((1, 3))
    (a_pt, s_pt), (a_rpt, s_rpt) = imgs["rpt_pt"], imgs["rpt"]
    check(np.isfinite(a_rpt).all(), "convergence rpt: image not finite")
    m_pt, m_rpt = a_pt.mean((0, 1)), a_rpt.mean((0, 1))
    rel = float((np.abs(m_pt - m_rpt) / np.maximum(m_pt, 1e-3)).max())
    a, b = pool(a_pt), pool(a_rpt)
    relp = float((np.abs(a - b) / np.maximum(np.maximum(a, b), 0.05)).mean())
    check(rel < 0.06 and relp < 0.12,
          f"convergence rpt: channel means {m_rpt} vs PT {m_pt} (max rel {rel:.4f}, bound "
          f"0.06), pooled error {relp:.4f} (bound 0.12)")
    (e_pt, _), (e_rpt, _) = imgs["env_pt"], imgs["env_rpt"]
    rel_env = float(abs(e_rpt.mean() - e_pt.mean()) / e_pt.mean())
    check(np.isfinite(e_rpt).all() and e_pt.mean() > 0.2 and rel_env < 0.06,
          f"convergence rpt on the env-lit floor: mean {e_rpt.mean()} vs PT {e_pt.mean()} "
          f"(rel {rel_env:.4f}, bound 0.06)")
    conv = dict(rel=rel, pooled=relp, env_rel=rel_env, seconds=s_rpt, pt_seconds=s_pt)
    log(f"[4m rpt] convergence at {cres}x{cres} (JAX's bounds): rpt (96 passes, {s_rpt:.1f} s) "
        f"to PT (160 passes, rr=False, {s_pt:.1f} s) on cornell_box(light_scale=0.5, "
        f"light_size=2.0): channel means {m_rpt} vs {m_pt}, max rel {rel:.4f} (< 0.06), 4x4-"
        f"pooled error {relp:.4f} (< 0.12); the env-lit floor (8 passes each): mean "
        f"{e_rpt.mean():.4f} vs {e_pt.mean():.4f}, rel {rel_env:.4f} (< 0.06)")
    log(f"[4m rpt] phase {time.perf_counter() - t_phase:.1f} s")
    return {"cells": cells, "launches": launches, "convergence": conv}


def cli_phase(dev, smi: str) -> dict:
    """Phase 4n: `python -m fermat_tpu_torch` on the card (see the module
    docstring)."""
    import numpy as np
    import torch

    from fermat_tpu_torch.core.camera import load_camera_file
    from fermat_tpu_torch.render.context import RenderingContext
    from fermat_tpu_torch.scene.loaders.obj import load_obj, save_obj
    from fermat_tpu_torch.scene.procedural import cornell_box
    from fermat_tpu_torch.utils.image import read_tga, write_tga

    t_phase = time.perf_counter()
    seed = 5
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        scene, cam = tmp / "cornell.obj", tmp / "camera.txt"
        save_obj(cornell_box(glossy_boxes=True), str(scene))
        cam.write_text("0 1 3.5\n0 1 0\n0 1 0\n0.8\n")
        cli = [sys.executable, "-m", "fermat_tpu_torch", "-i", str(scene), "-c", str(cam),
               "-seed", str(seed)]
        jobs = {
            "cli_pt": cli + ["-pt", "-r", str(RES), str(RES), "-passes", str(CLI_PASSES),
                             "-o", str(tmp / "pt.tga"), "-benchmark", str(tmp / "pt.json")],
            "cli_rpt": cli + ["-rpt", "-r", str(CLI_RPT_RES), str(CLI_RPT_RES), "-passes", "2",
                              "-o", str(tmp / "rpt.tga"), "-benchmark", str(tmp / "rpt.json")]}
        procs = {}
        t0 = time.perf_counter()
        try:
            procs = start_processes(tmp, jobs)
            # the same scene, loaded and rendered in this process meanwhile
            ctx = RenderingContext.create(load_obj(str(scene)), load_camera_file(str(cam)),
                                          RES, RES, seed=seed, texture_dir=str(tmp))
            ctx.render(CLI_PASSES)
            write_tga(str(tmp / "want.tga"), ctx.image())
            stats = ctx.dump_speed_stats(detailed=True)
            wait_processes(tmp, procs, CONV_TIMEOUT)
        finally:
            stop_processes(procs)
        wall = time.perf_counter() - t0
        bench = {k: json.loads((tmp / f"{k}.json").read_text()) for k in ("pt", "rpt")}
        for k, res in (("pt", RES), ("rpt", CLI_RPT_RES)):
            img = read_tga(str(tmp / f"{k}.tga"))
            check(img.shape == (res, res, 3) and img.mean() > 1.0,
                  f"-{k}: the TGA is {img.shape}, mean {img.mean()}")
            b = bench[k]
            check(b["device"].startswith("cuda") and b["rays_per_s"] > 0
                  and b["renderer"] == k and b["passes"] == (CLI_PASSES if k == "pt" else 2),
                  f"-{k}: -benchmark {b}")
        same = (tmp / "pt.tga").read_bytes() == (tmp / "want.tga").read_bytes()
        check(same, "-pt: the CLI's TGA differs from the in-process RenderingContext's")
        stage = stats["rt_ms"] + stats["shadow_rt_ms"] + stats["shade_ms"]
        check(stage > 0.0, f"dump_speed_stats(detailed=True): {stats}")
        for k in ("pt", "rpt"):
            log(f"[4n cli] python -m fermat_tpu_torch -{k} on {bench[k]['device']}: "
                f"{bench[k]['resolution']}, {bench[k]['passes']} passes, "
                f"{bench[k]['mean_pass_ms']:.2f} ms/pass, {bench[k]['rays_per_s'] / 1e6:.3f} "
                f"Mrays/s (-benchmark; alongside the other process) on {smi}; the "
                f"{(tmp / f'cli_{k}.log').read_text().strip().splitlines()[-1][:120]}")
        log(f"[4n cli] -pt's TGA equals the in-process RenderingContext's byte for byte "
            f"({RES}x{RES}, {CLI_PASSES} passes, seed {seed}); dump_speed_stats(detailed=True):"
            f" rt {stats['rt_ms']:.2f} ms, shadow_rt {stats['shadow_rt_ms']:.2f} ms, shade "
            f"{stats['shade_ms']:.2f} ms of the profiled pass; both processes {wall:.1f} s")
        out = dict(bench=bench, stages={k: stats[k] for k in ("rt_ms", "shadow_rt_ms",
                                                             "shade_ms")}, wall_s=wall)
    del ctx
    torch.cuda.empty_cache()
    log(f"[4n cli] phase {time.perf_counter() - t_phase:.1f} s")
    return out


def camera_text(cam) -> str:
    """A camera file's text (core/camera.load_camera_file): eye, aim, up, fov."""
    row = lambda v: " ".join(repr(float(x)) for x in v.stack().tolist())
    return f"{row(cam.eye)}\n{row(cam.aim)}\n{row(cam.up)}\n{float(cam.fov)!r}\n"


def slice_phase(dev, smi: str, reset_counts, counts, bview, room_options: dict) -> dict:
    """Phase 4o: the modules of the last slice on the card (see the module
    docstring)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from fermat_tpu_torch.accel.bvh import build_bvh_for_mesh
    from fermat_tpu_torch.accel.kdtree import build_kdtree, knn
    from fermat_tpu_torch.accel.lbvh import build_lbvh_for_mesh
    from fermat_tpu_torch.core.camera import load_camera_file
    from fermat_tpu_torch.core.math import Vec3
    from fermat_tpu_torch.integrators import bpt as bpt_mod
    from fermat_tpu_torch.integrators import pt
    from fermat_tpu_torch.parallel import mesh as pmesh
    from fermat_tpu_torch.render.checkpoint import load_checkpoint, save_checkpoint
    from fermat_tpu_torch.render.context import RenderingContext
    from fermat_tpu_torch.render.denoise import denoise
    from fermat_tpu_torch.render.framebuffer import Framebuffer
    from fermat_tpu_torch.scene.loaders import obj as obj_mod
    from fermat_tpu_torch.scene.loaders.dae import save_dae
    from fermat_tpu_torch.scene.loaders.fa import load_mesh_any
    from fermat_tpu_torch.scene.loaders.gltf import save_gltf
    from fermat_tpu_torch.scene.procedural import big_room, big_room_camera, cornell_box
    from fermat_tpu_torch.utils import native
    from fermat_tpu_torch.utils.image import read_tga, write_tga

    t_phase = time.perf_counter()
    out = {}
    sync = torch.cuda.synchronize

    def timed(fn, reps=1):
        """(result, best seconds of reps synced calls)."""
        best, r = float("inf"), None
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            r = fn()
            sync()
            best = min(best, time.perf_counter() - t0)
        return r, best

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        room, box = big_room(BIG_BOXES), cornell_box(glossy_boxes=True)
        t0 = time.perf_counter()
        obj_mod.save_obj(room, str(tmp / "room.obj"))
        t_write = time.perf_counter() - t0
        for ext in ("gltf", "glb"):
            save_gltf(box, str(tmp / f"cornell.{ext}"))
        save_dae(box, str(tmp / "cornell.dae"))
        (tmp / "room.txt").write_text(camera_text(big_room_camera()))
        cam = tmp / "camera.txt"
        cam.write_text("0 1 3.5\n0 1 0\n0 1 0\n0.8\n")
        # the viewer's keys, one 64-byte read a frame: TAB through the 13
        # other modes, a step forward, quit
        keys = b"".join(k.ljust(64) for k in [b"\t"] * 13 + [b"w", b"q"])
        cli = [sys.executable, "-m", "fermat_tpu_torch", "-pt", "-seed", str(SLICE_SEED)]
        jobs = {"room": cli + ["-i", str(tmp / "room.obj"), "-c", str(tmp / "room.txt"), "-r",
                               str(BIG_W), str(BIG_H), "-passes", "3", "-o",
                               str(tmp / "room.tga"), "-benchmark", str(tmp / "room.json")]}
        for ext in ("gltf", "glb", "dae"):
            jobs[ext] = cli + ["-i", str(tmp / f"cornell.{ext}"), "-c", str(cam), "-r",
                               str(RES), str(RES), "-o", str(tmp / f"{ext}.tga")]
        procs = {}
        try:
            procs = start_processes(tmp, jobs)
            with open(tmp / "view.log", "w") as log_f:
                procs["view"] = subprocess.Popen(
                    cli + ["-i", str(tmp / "cornell.glb"), "-c", str(cam), "-r", str(RES),
                           str(RES), "-passes", "20", "-o", str(tmp / "view.tga"), "-view"],
                    stdin=subprocess.PIPE, stdout=log_f, stderr=subprocess.STDOUT, cwd=ROOT)
            procs["view"].stdin.write(keys)
            procs["view"].stdin.close()

            # -- the native runtime against the Python parser and builder --
            lib = native.build()
            check(lib.parent == native.BUILD_DIR and "native" not in lib.parts[-2:],
                  f"the native library is built at {lib}")
            mesh_n, t_native = timed(lambda: obj_mod.load_obj(str(tmp / "room.obj")))
            mesh_p, t_python = timed(lambda: obj_mod._load_obj_python(str(tmp / "room.obj")))
            names = lambda m: np.array([m.materials[i].name for i in m.material_ids])
            check(all(np.array_equal(getattr(mesh_n, k), getattr(mesh_p, k))
                      for k in ("vertices", "triangles", "normal_indices", "uv_indices"))
                  and (names(mesh_n) == names(mesh_p)).all(),
                  "the native OBJ parse differs from the Python parse")
            mv = mesh_n.device_view(dev)
            bvh_n, tb_native = timed(lambda: build_bvh_for_mesh(mv))
            bvh_p, tb_python = timed(lambda: build_bvh_for_mesh(mv, use_native=False))
            check(bvh_n.n_nodes > 1 and bvh_p.n_nodes > 1, "empty BVH")
            log(f"[4o slice] big_room({BIG_BOXES}) as OBJ: {mesh_n.n_triangles} triangles, "
                f"{(tmp / 'room.obj').stat().st_size / 2 ** 20:.1f} MiB written in "
                f"{t_write:.2f} s; parse {t_native * 1e3:.1f} ms native vs {t_python * 1e3:.1f} "
                f"ms Python (equal meshes); BVH {tb_native * 1e3:.1f} ms native "
                f"({bvh_n.n_nodes} nodes) vs {tb_python * 1e3:.1f} ms Python "
                f"({bvh_p.n_nodes} nodes), host work, beside {smi}")
            out["native"] = dict(parse_ms=t_native * 1e3, parse_python_ms=t_python * 1e3,
                                 bvh_ms=tb_native * 1e3, bvh_python_ms=tb_python * 1e3,
                                 triangles=int(mesh_n.n_triangles))
            del mv, bvh_n, bvh_p

            # -- the LBVH on the card, held to its CPU build --
            _, _ = timed(lambda: build_lbvh_for_mesh(bview.mesh))
            lb, t_lbvh = timed(lambda: build_lbvh_for_mesh(bview.mesh), reps=3)
            cpu_mesh = bview.mesh._replace(**{k: Vec3(*(c.cpu() for c in getattr(bview.mesh, k)))
                                              for k in ("p0", "e1", "e2")})
            lb_cpu = build_lbvh_for_mesh(cpu_mesh)
            for k in ("lo_x", "lo_y", "lo_z", "hi_x", "hi_y", "hi_z", "skip", "prim_start",
                      "is_leaf", "prims", "child"):
                check(torch.equal(getattr(lb, k).cpu(), getattr(lb_cpu, k)),
                      f"the LBVH's {k} on the card differs from its CPU build")
            log(f"[4o slice] build_lbvh_for_mesh on big_room({BIG_BOXES}): {t_lbvh * 1e3:.2f} ms"
                f" (best of 3, after a warm-up; {lb.n_nodes} nodes), equal to its CPU build array "
                f"for array, on {smi}")
            out["lbvh_ms"] = t_lbvh * 1e3
            del lb, lb_cpu

            # -- kNN on 2^20 queries --
            gen = np.random.default_rng(SLICE_SEED)
            pts = gen.random((KNN_POINTS, 3), dtype=np.float32)
            q = torch.from_numpy(gen.random((KNN_QUERIES, 3), dtype=np.float32))
            tree, t_kd = timed(lambda: build_kdtree(pts, device=dev))
            qd = q.to(dev)
            (d2, ids), t_knn = timed(lambda: knn(tree, qd[:, 0], qd[:, 1], qd[:, 2], k=KNN_K))
            tree_cpu = build_kdtree(pts, device="cpu")
            n_cpu = KNN_CPU_QUERIES
            d2c, idc = knn(tree_cpu, q[:n_cpu, 0], q[:n_cpu, 1], q[:n_cpu, 2], k=KNN_K)
            check(torch.equal(ids[:n_cpu].cpu(), idc)
                  and torch.allclose(d2[:n_cpu].cpu(), d2c, rtol=1e-6, atol=0),
                  "knn on the card differs from the CPU's")
            log(f"[4o slice] knn k={KNN_K}: {KNN_QUERIES} queries over {KNN_POINTS} points in "
                f"{t_knn * 1e3:.1f} ms on the card (host tree build {t_kd * 1e3:.0f} ms); the first "
                f"{n_cpu} queries' ids equal to the CPU's, distances within 1e-6, on {smi}")
            out["knn_ms"] = t_knn * 1e3
            del tree, qd, d2, ids

            # -- the CornellBox files in this process, each with a pass at RES --
            ctxs = {}
            for ext in ("gltf", "glb", "dae"):
                ctxs[ext] = RenderingContext.create(
                    load_mesh_any(str(tmp / f"cornell.{ext}")), load_camera_file(str(cam)),
                    RES, RES, seed=SLICE_SEED)
                ctxs[ext].render(1)
                write_tga(str(tmp / f"want_{ext}.tga"), ctxs[ext].image())

            # -- the denoisers: timed at full size, held to the same call on
            # the CPU (big_room's at PLAIN_W x PLAIN_H: the CPU's EAW takes
            # ~40 s at 1600x896)
            def room_ctx(w, h):
                c = RenderingContext(view=bview, res_x=w, res_y=h,
                                     renderer_options=dict(room_options), seed=SLICE_SEED,
                                     fb=Framebuffer.create(h, w, dev))
                c.render(1)
                return c

            out["denoise"] = {}
            for cell, c, held in (("cornell", ctxs["glb"], ctxs["glb"]),
                                  ("big_room", room_ctx(BIG_W, BIG_H), room_ctx(PLAIN_W, PLAIN_H))):
                gb = held.gbuffer
                args = (held.fb, gb["normal"], gb["position"], gb["miss"], held.view.camera)
                cpu_args = (Framebuffer(*(t.cpu() for t in held.fb)),
                            *(gb[k].cpu() for k in ("normal", "position", "miss")),
                            held.view.camera.to("cpu"))
                for method in ("eaw", "xbl"):
                    c.filtered_image(method=method)  # a warm-up
                    _, t_f = timed(lambda: c.filtered_image(method=method), reps=3)
                    got = denoise(*args, instance=held.instance - 1, method=method).cpu()
                    want = denoise(*cpu_args, instance=held.instance - 1, method=method)
                    off = ((got - want).abs() / (want.abs() * DENOISE_RTOL + DENOISE_ATOL))
                    near = float((off <= 1.0).all(-1).double().mean())
                    check(near >= DENOISE_NEAR[method], f"denoise {method} on {cell} "
                          f"{held.res_x}x{held.res_y}: {near:.6f} of the pixels within (rtol "
                          f"{DENOISE_RTOL}, atol {DENOISE_ATOL}) of the CPU's, max "
                          f"{float(off.max()):.2f} x")
                    log(f"[4o slice] filtered_image({method!r}) on {cell} {c.res_x}x{c.res_y}: "
                        f"{t_f * 1e3:.2f} ms (best of 3, RGBA8 on the host included); at "
                        f"{held.res_x}x{held.res_y} {near:.6f} of the denoised pixels within "
                        f"(rtol {DENOISE_RTOL}, atol {DENOISE_ATOL}) of the CPU's (the CPU "
                        f"test's), the rest at most {float(off.max()):.3f} x that, on {smi}")
                    out["denoise"][f"{cell}_{method}"] = t_f * 1e3

            # -- checkpoints: restored after 2 passes + 1 equals 3 passes --
            for renderer, res in (("pt", RES), ("pssmlt", CKPT_PSSMLT_RES)):
                mk = lambda: RenderingContext.create(box, load_camera_file(str(cam)), res, res,
                                                     renderer=renderer, seed=SLICE_SEED)
                full = mk()
                full.render(2)
                save_checkpoint(str(tmp / f"{renderer}.npz"), full)
                full.render(1)
                resumed = mk()
                load_checkpoint(str(tmp / f"{renderer}.npz"), resumed)
                resumed.render(1)
                if renderer == "pt":
                    same = all(torch.equal(a, b) for a, b in zip(resumed.fb, full.fb))
                    how = "every framebuffer channel equal"
                else:  # the splat is an index_add_, in no fixed order on the card
                    same = all(float((a - b).abs().max()) <= BPT_SPLAT_RTOL * float(
                        b.abs().max()) for a, b in zip(resumed.fb, full.fb)) and all(
                        torch.equal(getattr(resumed.renderer_state, f),
                                    getattr(full.renderer_state, f))
                        for f in ("u", "i_lum", "contrib", "pixel", "brightness"))
                    how = (f"the chains (u, i_lum, contrib, pixel, b) bit-equal, every channel "
                           f"within {BPT_SPLAT_RTOL} of its max")
                check(same, f"{renderer}: the restored run differs from the uninterrupted one")
                log(f"[4o slice] checkpoint {renderer} {res}x{res}: saved after 2 passes, "
                    f"restored in a new context ({(tmp / f'{renderer}.npz').stat().st_size} B) "
                    f"and rendered 1 more: {how} to 3 passes")

            wait_processes(tmp, procs, SLICE_TIMEOUT)  # the card to this process alone

            # -- the sharded passes and train step at world size 1 on nccl --
            dist.init_process_group("nccl", init_method=f"file://{tmp / 'rendezvous'}",
                                    world_size=1, rank=0, device_id=dev)
            try:
                mesh = pmesh.make_mesh(dev)
                view = ctxs["glb"].view
                opts = pt.PTOptions(**ctxs["glb"].renderer_options)
                inst = 7
                pmesh.render_pass_sharded(view, opts, RES, RES, inst, mesh)
                reset_counts()
                o_s, t_s = timed(lambda: pmesh.render_pass_sharded(view, opts, RES, RES, inst,
                                                                   mesh))
                launched = {k: v for k, v in counts().items() if v}
                o_u, t_u = timed(lambda: pt.render_pass(view, opts, RES, RES, inst))
                ts, tu = [], []
                for _ in range(SHARD_ROUNDS):  # alternating, the host clock swings
                    ts.append(timed(lambda: pmesh.render_pass_sharded(view, opts, RES, RES,
                                                                      inst, mesh))[1])
                    tu.append(timed(lambda: pt.render_pass(view, opts, RES, RES, inst))[1])
                check(all(torch.equal(getattr(o_s, f).stack() if isinstance(getattr(o_s, f), Vec3)
                                      else getattr(o_s, f),
                                      getattr(o_u, f).stack() if isinstance(getattr(o_u, f), Vec3)
                                      else getattr(o_u, f)) for f in o_s._fields),
                      "render_pass_sharded at world size 1 differs from render_pass")
                check(launched.get("trace_closest", 0) > 0 and launched.get("gather_rows", 0) > 0,
                      f"the sharded pass launched {launched}")
                target = torch.rand((RES * RES, 3), generator=torch.Generator(dev).manual_seed(3),
                                    device=dev)
                v_s, loss_s = pmesh.train_step_sharded(view, target, opts, RES, RES, inst, mesh)
                leaf = view.mesh.materials.diffuse.stack().detach().clone().requires_grad_(True)
                mats = view.mesh.materials._replace(diffuse=Vec3(leaf[:, 0], leaf[:, 1],
                                                                 leaf[:, 2]))
                with torch.enable_grad():
                    o = pt.render_pass(view._replace(mesh=view.mesh._replace(materials=mats)),
                                       opts, RES, RES, inst)
                    d = o.composited.stack() - target
                    loss = torch.mean(d * d) * 1.0  # train_step_sharded's at one rank
                    loss.backward()
                new = torch.clamp(leaf.detach() - 0.05 * leaf.grad, 0.0, 1.0)
                check(torch.equal(loss_s, loss.detach())
                      and torch.equal(v_s.mesh.materials.diffuse.stack(), new),
                      "train_step_sharded at world size 1 differs from the unsharded step")
                bopts = bpt_mod.BPTOptions(lobes=opts.lobes)
                rad_s, splat_s, rays_s = pmesh.render_bpt_pass_sharded(view, bopts, RES, RES,
                                                                        inst, mesh)
                rad, splat, rays, _ = bpt_mod.render_pass(view, bopts, RES, RES, inst)
                scale = float(splat.abs().max())
                check(torch.equal(rad_s.stack(), rad.stack()) and torch.equal(rays_s, rays)
                      and float((splat_s - splat).abs().max()) <= BPT_SPLAT_RTOL * scale,
                      "render_bpt_pass_sharded at world size 1 differs from the BPT pass")
            finally:
                dist.destroy_process_group()
            med = lambda xs: sorted(xs)[len(xs) // 2]
            log(f"[4o slice] render_pass_sharded at world size 1 on nccl, CornellBox {RES}x{RES} "
                f"mpl={MPL}: {med(ts) * 1e3:.2f} ms vs {med(tu) * 1e3:.2f} ms unsharded (medians "
                f"of {SHARD_ROUNDS} synced calls each, alternating; the first {t_s * 1e3:.2f} / "
                f"{t_u * 1e3:.2f} ms), bit-equal, "
                f"launches {launched}; train_step_sharded equal to the unsharded step (loss "
                f"{float(loss_s):.6g}); render_bpt_pass_sharded equal (splat within "
                f"{BPT_SPLAT_RTOL} of its max); on {smi}")
            out["sharded"] = dict(ms=med(ts) * 1e3, unsharded_ms=med(tu) * 1e3,
                                  launches=launched)
        finally:
            stop_processes(procs)
        for ext in ("gltf", "glb", "dae"):
            same = (tmp / f"{ext}.tga").read_bytes() == (tmp / f"want_{ext}.tga").read_bytes()
            check(same, f"-i cornell.{ext}: the CLI's TGA differs from the in-process context's")
        bench = json.loads((tmp / "room.json").read_text())
        img = read_tga(str(tmp / "room.tga"))
        check(img.shape == (BIG_H, BIG_W, 3) and img.mean() > 1.0 and
              bench["device"].startswith("cuda") and bench["rays_per_s"] > 0 and
              all(bench["launches"].get(k, 0) > 0 for k in (
                  "trace_closest_frontier", "trace_any_frontier", "cdf_pick_rows",
                  "gather_rows")),
              f"-i room.obj: the TGA is {img.shape} (mean {img.mean()}), -benchmark {bench}")
        view_log = (tmp / "view.log").read_text(errors="replace")
        modes = re.findall(r"pass (\d+) mode=(\w+)", view_log)
        seen = {m for _, m in modes}
        check(len(seen) == 14 and "viewer: 15 frames" in view_log
              and modes[-1] == ("1", "depth"),
              f"-view: modes {modes}; {view_log[-300:]}")
        log(f"[4o slice] python -m fermat_tpu_torch -pt -i room.obj ({BIG_W}x{BIG_H}, the native "
            f"parse and BVH route): {bench['mean_pass_ms']:.2f} ms/pass, "
            f"{bench['rays_per_s'] / 1e6:.3f} Mrays/s (-benchmark, beside four other processes), "
            f"launches {bench['launches']}; "
            f"-i cornell.gltf / .glb / .dae at {RES}x{RES}: each TGA equal to the in-process "
            f"context's byte for byte; -view through a pipe: 15 frames, all 14 modes drawn, the "
            f"camera moved (pass 1 again), q; on {smi}")
        out["cli_room"] = bench
    torch.cuda.empty_cache()
    log(f"[4o slice] phase {time.perf_counter() - t_phase:.1f} s")
    out["seconds"] = time.perf_counter() - t_phase
    return out


def scan_box_tests(cl, o, d, t0, t1, active, closest: bool) -> tuple:
    """(box tests the answer needs, box tests the kernel makes) of the binned
    tracer's first scan over the active rays: the scan tests the union box
    of each bt.SCAN_GROUP boxes and the boxes of a group only when the ray
    enters its union (for the closest hit with E' <= its best t, tmax at the
    first scan; for occlusion up to its (QUEUE + 1)-th entered box, the
    scan's stop). Needed, for the closest hit: the union tests and the
    boxes of the groups entered with E' <= the ray's final t (the answer's
    t, from a binned trace of the same rays); for occlusion: what the scan
    makes."""
    import torch

    from fermat_tpu_torch.core.math import Vec3
    from fermat_tpu_torch.ops import binned_trace as bt
    from fermat_tpu_torch.ops import frontier_trace as ft

    c_pad, w, inf = cl.rows.shape[0], bt.SCAN_GROUP, float("inf")
    groups = -(-c_pad // w)
    box = [getattr(cl, f)[0, :c_pad] for f in ("lo_x", "lo_y", "lo_z", "hi_x", "hi_y", "hi_z")]
    real = box[0] <= box[3]
    union = {}
    for f, b, far in zip(("lo_x", "lo_y", "lo_z", "hi_x", "hi_y", "hi_z"), box,
                         (inf, inf, inf, -inf, -inf, -inf)):
        col = torch.full((groups * w,), far, device=b.device)
        col[:c_pad] = torch.where(real, b, far)
        col = col.view(groups, w)
        union[f] = (col.min(dim=1).values if far > 0 else col.max(dim=1).values)[None]
    ucl = cl._replace(**union)
    size = torch.clamp(c_pad - w * torch.arange(groups, device=real.device), max=w).double()
    t_end = bt.trace_closest_binned(cl, o, d, t0, t1, active).t if closest else None
    lanes = torch.nonzero(active)[:, 0]
    need = made = 0.0
    for sl in ft._chunks(lanes.shape[0], c_pad):
        g = lanes[sl]
        pick = lambda a: a[g]
        ray = (Vec3(*map(pick, o)), Vec3(*map(pick, d)), pick(t0), pick(t1))
        eu = ft._slack(ft.cluster_entries(ucl, *ray))
        hit_u = eu < inf
        if closest:
            made += groups * g.shape[0] + float(((hit_u & (eu <= t1[g][:, None])) * size).sum())
            need += groups * g.shape[0] + float(((hit_u & (eu <= t_end[g][:, None]))
                                                 * size).sum())
            continue
        e = ft._slack(ft.cluster_entries(cl, *ray)[:, :c_pad]) < inf
        reach = torch.cumsum(e.to(torch.int32), dim=1) == bt.QUEUE + 1
        stop = torch.where(reach.any(dim=1), reach.int().argmax(dim=1), c_pad - 1)
        col = torch.arange(c_pad, device=e.device)
        tested = hit_u[:, col // w] & (col[None, :] <= stop[:, None])
        made += float(tested.sum()) + float((stop // w + 1).sum())
        need = made
    return need, made


def binned_step_rows(dev, bw: float, fp32: float, tcalls: dict, launches: dict,
                     max_err: dict) -> tuple:
    """The binned tracer's round loop step by step, at the first call of each
    kind of one cluster pass (bounce 0's rays): the first STEP_ROUNDS rounds,
    each kernel step (scan, counting sort, test) on a copy of the state
    beside its plain version on another, the two held equal
    (binned_trace._state_diff: the state and bins bit for bit, the lists
    bin by bin). The first round's steps are timed (CUDA events around the
    step on a fresh copy, behind a short spin, median of STEP_REPS) beside
    the plain step and their bounds: the scan by FP32 operations
    (FLOPS_PER_VISIT a box test over the box tests the answer needs,
    `scan_box_tests`) or bytes; the counting sort by bytes (the
    ready list in, the sorted list out, the bins); the test by FP32
    operations (FLOPS_PER_TEST over each ray's cluster, an occluded ray
    counted at one test) or bytes. -> (rows of the scan and counting-sort
    kernels, {kind: the test step's first-round numbers})."""
    import statistics

    import torch

    from fermat_tpu_torch.ops import binned_trace as bt
    from fermat_tpu_torch.ops import trace as trace_mod

    copy = lambda lp: bt._Loop(*(x.clone() for x in lp))

    def timed(fn, base):
        ms = []
        for _ in range(STEP_REPS):
            lp = copy(base)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            torch.cuda._sleep(SPIN_CYCLES // 10)
            start.record()
            fn(lp)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
        return statistics.median(ms), lp

    rows, tests, first_round = [], {}, {}
    for kind in ("closest", "any"):
        closest = kind == "closest"
        cl, o, d, tmin, tmax, active = tcalls[kind][0]
        n, c_pad, k = o.x.shape[0], cl.rows.shape[0], bt.QUEUE
        t0, t1, active = trace_mod._lane_args(o, tmin, tmax, active)
        rays = bt._Rays(o, d, t0, t1)
        kern = bt._kernel_run(cl, rays, active, closest)
        plain = bt._plain_run(cl, rays, active, closest)
        state = bt._new_loop(n, c_pad, closest, dev)
        for r in range(STEP_ROUNDS):
            for step, fam in ((bt.STEP_SCAN, "scan"), (bt.STEP_BIN, "bin"), (bt.STEP_TEST, "test")):
                first = r == 0 and step == bt.STEP_SCAN
                base, ref = state, copy(state)
                if r == 0:
                    ms, state = timed(lambda lp: kern(lp, 1, first, step), base)
                    _, plain_ms = profiled(lambda: plain(ref, 1, first, step))
                else:
                    state = copy(base)
                    kern(state, 1, first, step)
                    plain(ref, 1, first, step)
                torch.cuda.synchronize()
                diff = bt._state_diff(state, ref, closest)
                check(not diff, f"binned {kind} {fam} step, round {r + 1}: differs from its "
                                f"plain version in {diff}")
                if r:
                    continue
                ctl = state.ctl.tolist()
                if fam == "scan":
                    boxes, made = scan_box_tests(cl, o, d, t0, t1, active, closest)
                    ops = boxes * FLOPS_PER_VISIT
                    nbytes = (ctl[bt.CTL_SCANS] * (32 + k * (8 if closest else 4) + 9 + 8)
                              + 24 * c_pad)
                    work = (f"{ctl[bt.CTL_SCANS]} rays scanned, {boxes:.0f} box tests needed "
                            f"({made:.0f} made)")
                elif fam == "bin":
                    m = ctl[bt.CTL_LIVE]
                    ops, nbytes = 0.0, 12.0 * m + 20.0 * c_pad
                    cids = base.ready_cid[:m].clone()
                    lib = device_ms(lambda: torch.sort(cids), reps=STEP_REPS, cold=False)["ms"]
                    work = f"{m} rays into {c_pad} bins"
                else:
                    m = ctl[bt.CTL_LIVE]
                    lanes = base.lists[0, :m].long()
                    cnt = cl.count[base.qc[base.qhead[lanes].long(), lanes].long()].double()
                    if not closest:
                        cnt = torch.where(state.occ[lanes], 1.0, cnt)
                    ops = float(cnt.sum()) * FLOPS_PER_TEST
                    # each ray and its state in and out once, each cluster's rows once
                    bins = torch.unique(base.qc[base.qhead[lanes].long(), lanes].long())
                    nbytes = 64.0 * m + 48.0 * float(cl.count[bins].sum())
                    work = f"{m} rays, {float(cnt.sum()):.0f} triangle tests"
                bound = max(nbytes / bw, ops / fp32) * 1e3
                first_round[(kind, fam)] = dict(
                    ms=ms, plain_ms=plain_ms, bound_ms=bound,
                    bound_by="bytes" if nbytes / bw >= ops / fp32 else "operations",
                    library_ms=lib if fam == "bin" else None, work=work)
                log(f"[6 timing] binned {kind} {fam} step, first round at bounce 0's {n} rays "
                    f"({work}): {ms * 1e3:.2f} us (median of {STEP_REPS}), plain "
                    f"{plain_ms * 1e3:.1f} us, bound {bound * 1e3:.2f} us by "
                    f"{first_round[(kind, fam)]['bound_by']}"
                    + (f", torch.sort of its cids {lib * 1e3:.2f} us" if fam == "bin" else "")
                    + f"; rounds 1-{STEP_ROUNDS} equal to the plain steps")
        tests[kind] = first_round[(kind, "test")]
    for name, key in (("binned_scan_closest", ("closest", "scan")),
                      ("binned_scan_any", ("any", "scan")), ("binned_bin", ("closest", "bin"))):
        kern = {"binned_scan_closest": bt.SCAN_CLOSEST, "binned_scan_any": bt.SCAN_ANY,
                "binned_bin": bt.BIN}[name]
        f = first_round[key]
        max_err[name] = 0.0
        rows.append({
            "name": name, "route": "cuda", "source": f"fermat_tpu_torch/ops/csrc/{kern.source}",
            "replaces": kern.replaces, "launches": launches[name], "max_abs_err": 0.0,
            "ms": f["ms"], "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"],
            "bound_by": f["bound_by"], "library_ms": f["library_ms"],
            "library_call": "torch.sort of the ready rays' cids" if f["library_ms"] else None,
            "timed_at": f"the first round of bounce 0's {key[0]} trace: {f['work']}",
            "timer": "events", "shapes": [f["work"]]})
    return rows, tests


def walk_rows(dev, bw: float, fp32: float, bview, opt: dict, lcalls: dict, k5_plain: dict,
              bvhk: dict, max_err: dict) -> list:
    """Phase 6's rows of the BVH walk, at big_room's bounce-0 and bounce-1
    rays: the closest and shadow rays of the monolithic frontier pass that
    phase 6 records (`lcalls`, the function K5 computes), over phase 4i's BVH
    of the same mesh. Each launch is held bit-equal to the plain walk (t, u,
    v, tri; occlusion), which also counts each ray's node visits and
    triangle tests, and to K5's plain answer there (`k5_plain`; closest: t).
    The plain version runs once a launch, with its counters.

    Bound of a launch: the larger of the bytes (the rays in, the hits out,
    the nodes, prims and soup once) and the FP32 operations
    (FLOPS_PER_VISIT a box test, FLOPS_PER_TEST a triangle test) of the work
    the answer needs over this tree, counted as K5's is: a closest ray
    tests the box of every node its walk reaches with its final t from the
    start, and every triangle of each such leaf whose box it enters (a
    second plain walk, with tmax = the final t, counts them; it must find
    nothing nearer); an unoccluded shadow ray its whole walk; an occluded
    one one box and one triangle. The row's ms and bound are the means of
    its two launches; `each_launch` keeps each launch's time, bound, K5's
    bound on the same rays and the counts."""
    import torch

    from fermat_tpu_torch.accel.traverse import walk_any, walk_closest
    from fermat_tpu_torch.ops import bvh_trace
    from fermat_tpu_torch.ops import trace as trace_mod

    bits = lambda t: t.contiguous().view(torch.int32)
    lanes = lambda x, n: trace_mod._lanes(x, n, dev)
    rows = []
    bvh_room, tris_room = opt["bvh"], bview.mesh.tri_soup()
    tree_bytes = (bvh_room.nodes.numel() * 4 + bvh_room.prims.numel() * 4
                  + tris_room.numel() * 4)
    mean_max = lambda x: (float(x.mean()), int(x.max()))
    for kind in ("closest", "any"):
        kname = f"trace_{kind}_bvh"
        a = dict(bound=0.0, by_bytes=0.0, by_ops=0.0, plain=0.0, err=0.0)
        times, each = {}, []
        t0 = time.perf_counter()
        for b, args in enumerate(lcalls[f"trace_{kind}_frontier"][:2]):
            _, o, d, tmin, tmax, active = args
            n = o.x.shape[0]
            tmin_l, tmax_l = lanes(tmin, n), lanes(tmax, n)
            act = active if active is not None else torch.ones(n, dtype=torch.bool, device=dev)
            k5 = k5_plain[f"trace_{kind}_frontier"][b]
            if kind == "closest":
                f_k = lambda: bvh_trace.trace_closest_bvh(bvh_room, tris_room, o, d, tmin, tmax,
                                                          active)
                f_p = lambda: walk_closest(bvh_room, tris_room, o, d, tmin_l, tmax_l, active,
                                           stats=True)
                (want, vis, tst), p_ms = profiled(f_p)
                got = f_k()
                torch.cuda.synchronize()
                check(torch.equal(got.tri, want.tri) and all(
                    torch.equal(bits(x), bits(y)) for x, y in ((got.t, want.t), (got.u, want.u),
                                                               (got.v, want.v))),
                      f"{kname} at big_room's bounce-{b} rays: differs from its plain version")
                check(torch.equal(bits(got.t), bits(k5["want"][0])),
                      f"{kname} at big_room's bounce-{b} rays: t differs from K5's plain answer")
                a["err"] = max(a["err"], float((got.t - want.t).abs().max()))
                # the needed work: each ray's walk with its final t from the start
                near, n_vis, n_tst = walk_closest(bvh_room, tris_room, o, d, tmin_l, want.t,
                                                  active, stats=True)
                check(bool((near.tri[act] < 0).all()),
                      f"{kname} at big_room's bounce-{b} rays: a hit nearer than the final t")
                del near
                byt = n * (33 + 13) + tree_bytes
            else:
                f_k = lambda: bvh_trace.trace_any_bvh(bvh_room, tris_room, o, d, tmin, tmax,
                                                      active)
                f_p = lambda: walk_any(bvh_room, tris_room, o, d, tmin_l, tmax_l, active,
                                       stats=True)
                (want, vis, tst), p_ms = profiled(f_p)
                got = f_k()
                torch.cuda.synchronize()
                check(torch.equal(got, want),
                      f"{kname} at big_room's bounce-{b} rays: differs from its plain version")
                check(torch.equal(got, k5["want"]),
                      f"{kname} at big_room's bounce-{b} rays: differs from K5's plain answer")
                a["err"] = max(a["err"], float((got != want).sum()))
                one = torch.ones_like(vis)
                n_vis, n_tst = torch.where(want, one, vis), torch.where(want, one, tst)
                byt = n * (33 + 1) + tree_bytes
            v_a, t_a = vis[act].double(), tst[act].double()
            nv_a, nt_a = n_vis[act].double(), n_tst[act].double()
            ops = float(nv_a.sum()) * FLOPS_PER_VISIT + float(nt_a.sum()) * FLOPS_PER_TEST
            del want, vis, tst, n_vis, n_tst
            tk = device_ms(f_k)
            add_times(times, tk)
            b_bytes, b_ops = byt / bw * 1e3, ops / fp32 * 1e3
            (vm, vx), (tm, tx), (nvm, nvx), (ntm, ntx) = map(mean_max, (v_a, t_a, nv_a, nt_a))
            each.append(dict(
                bounce=b, rays=n, active=int(act.sum()), ms=tk["ms"], plain_ms=p_ms,
                bound_ms=max(b_bytes, b_ops), bound_by="bytes" if b_bytes >= b_ops
                else "operations", k5_bound_ms=max(k5["b_bytes"], k5["b_ops"]),
                visits_mean=vm, visits_max=vx, tests_mean=tm, tests_max=tx,
                needed_visits_mean=nvm, needed_visits_max=nvx, needed_tests_mean=ntm,
                needed_tests_max=ntx))
            a["bound"] += max(b_bytes, b_ops)
            a["by_bytes"] += b_bytes
            a["by_ops"] += b_ops
            a["plain"] += p_ms
        nc = len(each)
        check(nc == 2, f"{kname}: {nc} recorded launches at big_room's first two bounces")
        max_err[kname] = a["err"]
        kern = bvhk[kname]
        t = per_launch(times, nc)
        per_pass = opt["launches"]["options_big_room_bvh"].get(kname, 0)
        row = {
            "name": kname, "route": "cuda",
            "source": f"fermat_tpu_torch/ops/csrc/{kern.source}",
            "replaces": kern.replaces,
            "launches": int(round(per_pass * OPT_PASSES * REPS)),
            "launches_per_pass": per_pass,
            "max_abs_err": a["err"], "max_abs_err_vs_plain": a["err"],
            **t, "plain_ms": a["plain"] / nc, "bound_ms": a["bound"] / nc,
            "bound_by": "bytes" if a["by_bytes"] >= a["by_ops"] else "operations",
            "library_ms": None,
            "shapes": [f"{e['rays']} rays x {bview.mesh.n_triangles} tris, bounce {e['bounce']}"
                       for e in each],
            "plain_ms_with": "its visit and test counters",
            "each_launch": each,
            "bvh_nodes": bvh_room.n_nodes, "bvh_host_build_s": opt["build_s"],
        }
        rows.append(row)
        log(f"[6 timing] {kname}: {fmt_times(t)}/launch, the mean of its launches at big_room's "
            f"bounce-0 and bounce-1 rays, each bit-equal to its plain version and to K5's "
            f"answer; each launch: "
            + "; ".join(f"bounce {e['bounce']}: {e['ms'] * 1e3:.2f} us (plain "
                        f"{e['plain_ms'] * 1e3:.1f} us with its counters), bound "
                        f"{e['bound_ms'] * 1e3:.2f} us by {e['bound_by']} (K5's "
                        f"{e['k5_bound_ms'] * 1e3:.2f} us), {e['active']} active rays, a ray "
                        f"visits mean {e['visits_mean']:.1f} max {e['visits_max']}, tests mean "
                        f"{e['tests_mean']:.1f} max {e['tests_max']}; needed visits mean "
                        f"{e['needed_visits_mean']:.1f} max {e['needed_visits_max']}, tests "
                        f"mean {e['needed_tests_mean']:.1f} max {e['needed_tests_max']}"
                        for e in each)
            + f"; {time.perf_counter() - t0:.1f} s for the phase")
    return rows


def convergence_render(tag: str, out: str) -> int:
    """A convergence render of phase 4l (CONV_CASES: JAX's test scene of
    tests/test_mlt.py, max_path_length=4) or 4m (RPT_CONV_CASES) in a
    process of its own, at CONV_RES x CONV_RES on the card; writes the HDR
    image and the seconds to `out` (.npz)."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        return 1
    sys.path.insert(0, str(ROOT))
    from fermat_tpu_torch.core.camera import Camera
    from fermat_tpu_torch.render.context import RenderingContext
    from fermat_tpu_torch.scene.procedural import cornell_box, cornell_camera, floor_quad

    t0 = time.perf_counter()
    if tag in CONV_CASES:
        renderer, passes, kw = CONV_CASES[tag]
        scene = (cornell_box(light_scale=0.5, light_size=2.0, glossy_boxes=True),
                 cornell_camera())
        kw = {"max_path_length": 4, **kw}
    else:
        renderer, passes, key, kw = RPT_CONV_CASES[tag]
        if key == "cornell":
            scene = cornell_box(light_scale=0.5, light_size=2.0), cornell_camera()
        else:
            scene = (floor_quad(1.0, (0.6, 0.6, 0.6)),
                     Camera.create((0, 2.0, 2.0), (0, 0, 0), (0, 1, 0), 0.7))
            kw = {**kw, "env_map": np.full((8, 16, 3), ENV_FLOOR, np.float32)}
    ctx = RenderingContext.create(*scene, CONV_RES, CONV_RES, renderer=renderer, **kw)
    ctx.render_batch(passes)
    np.savez(out, img=ctx.hdr_image(), seconds=time.perf_counter() - t0)
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to drive",
              file=sys.stderr)
        return 1
    if not (ROOT / "fermat_tpu_torch" / "ops" / "csrc").is_dir():
        print("chip_smoke: run it from the root of a checkout (fermat_tpu_torch/ missing)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from fermat_tpu_torch.accel.cluster import build_clusters, build_subclusters
    from fermat_tpu_torch.accel.traverse import Hit
    from fermat_tpu_torch.bsdf.composite import scene_lobes
    from fermat_tpu_torch.core.camera import generate_camera_rays
    from fermat_tpu_torch.core.math import Vec3
    from fermat_tpu_torch.core.rng import TiledSequence
    from fermat_tpu_torch.integrators import pt
    from fermat_tpu_torch.ops import _cuda
    from fermat_tpu_torch.ops import binned_trace as bt
    from fermat_tpu_torch.ops import bvh_trace
    from fermat_tpu_torch.ops import cdf_gather
    from fermat_tpu_torch.ops import cluster_trace as ct
    from fermat_tpu_torch.ops import frontier_trace as ft
    from fermat_tpu_torch.ops import gather as gather_mod
    from fermat_tpu_torch.ops import pt_mega
    from fermat_tpu_torch.ops import sub_trace as st
    from fermat_tpu_torch.ops import trace as trace_mod
    from fermat_tpu_torch.render.context import RenderingContext
    from fermat_tpu_torch.scene import lights as lights_mod
    from fermat_tpu_torch.scene import mesh as mesh_mod
    from fermat_tpu_torch.scene.procedural import (big_room, big_room_camera, cornell_box,
                                                   cornell_camera, glass_cornell_box,
                                                   random_soup)
    from fermat_tpu_torch.scene.view import SceneView

    dense = {"trace_closest": trace_mod.CLOSEST, "trace_any": trace_mod.ANY,
             "gather_rows": gather_mod.GATHER}
    mega = {"mega_forward": pt_mega.FORWARD, "mega_grad": pt_mega.GRAD}
    large = {"trace_closest_frontier": ft.CLOSEST, "trace_any_frontier": ft.ANY,
             "cdf_pick_rows": cdf_gather.PICK}
    tracers = {"trace_closest_cluster": ct.CLOSEST, "trace_any_cluster": ct.ANY,
               "trace_closest_binned": bt.CLOSEST, "trace_any_binned": bt.ANY}
    ad = {"gather_rows_bwd": gather_mod.GATHER_BWD}
    subk = {"trace_closest_sub": st.CLOSEST, "trace_any_sub": st.ANY}
    bvhk = {"trace_closest_bvh": bvh_trace.CLOSEST, "trace_any_bvh": bvh_trace.ANY}
    kernels = {**dense, **mega, **large, **tracers, **ad, **subk, **bvhk}
    # helper kernels, counted: the binned tracer's scan and counting sort
    # (rows of their own, phase 6), and the frontier tracer's ray sort key
    # (held to its plain version in phases 3c and 6, its time beside K5's)
    scans = {"binned_scan_closest": bt.SCAN_CLOSEST, "binned_scan_any": bt.SCAN_ANY,
             "binned_bin": bt.BIN}
    helpers = {**scans, "frontier_sort_key": ft.KEY}

    def reset_counts():
        for k in (*kernels.values(), *helpers.values()):
            k.launches = 0
        bt.LOOP.reset()

    def counts():
        return {n: k.launches for n, k in {**kernels, **helpers}.items()}

    phase_s = {}
    last = [None, time.perf_counter()]

    def mark(name):
        """Close the running phase and start `name` (the seconds-per-phase line)."""
        now = time.perf_counter()
        if last[0] is not None:
            phase_s[last[0]] = round(now - last[1], 1)
        last[:] = [name, now]

    mark("1")
    # ---- 1. device ----
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    device_name = torch.cuda.get_device_name(0)
    part, (bw, fp32) = peaks_for(device_name)
    log(f"[1 device] {device_name} ({torch.cuda.device_count()} visible); nvidia-smi: {smi}; "
        f"bounds use H100 {part} peaks {bw / 1e12:.2f} TB/s, {fp32 / 1e12:.0f} TFLOP/s FP32")

    mark("2")
    # ---- 2. build ----
    t0 = time.perf_counter()
    built = _cuda.build(sorted({k.source for k in (*kernels.values(), *helpers.values())}))
    log(f"[2 build] {time.perf_counter() - t0:.1f} s wall: "
        + ", ".join(f"{s} {r.seconds:.1f} s" for s, r in built.items()))
    for r in built.values():
        for line in r.log.splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                log(f"    ptxas {r.source}: {line.split(':', 1)[-1].strip()}")

    mark("3")
    # ---- 3. kernel vs plain on the card ----
    gen = torch.Generator(device=dev).manual_seed(20261016)
    max_err = {k: 0.0 for k in kernels}
    bits = lambda t: t.contiguous().view(torch.int32)

    def lanes(x, n):
        return trace_mod._lanes(x, n, dev)

    for scene, storage in (("cornell", cornell_box(glossy_boxes=True)),
                           ("soup4096", random_soup(4096))):
        tris = storage.device_view(dev).tri_soup()
        lo = torch.tensor(storage.vertices.min(0), device=dev)[:, None]
        hi = torch.tensor(storage.vertices.max(0), device=dev)[:, None]
        o = torch.rand(3, N_RAYS, generator=gen, device=dev) * (hi - lo) + lo
        d = torch.randn(3, N_RAYS, generator=gen, device=dev)
        d = d / d.norm(dim=0, keepdim=True)
        o, d = Vec3(*o), Vec3(*d)
        active = torch.rand(N_RAYS, generator=gen, device=dev) < 0.8
        tmax = torch.rand(N_RAYS, generator=gen, device=dev) * float((hi - lo).norm())
        hit = trace_mod.trace_closest(tris, o, d, 1e-4, 3.0e38, active)
        ref = trace_mod._closest_plain(tris, o, d, lanes(1e-4, N_RAYS), lanes(3.0e38, N_RAYS),
                                       active)
        torch.cuda.synchronize()
        check(torch.equal(hit.tri, ref.tri), f"trace_closest {scene}: tri differs from plain")
        for a, b in ((hit.t, ref.t), (hit.u, ref.u), (hit.v, ref.v)):
            check(torch.equal(bits(a), bits(b)), f"trace_closest {scene}: t/u/v not bit-equal")
        err = max(float((a - b).abs().max()) for a, b in
                  ((hit.t, ref.t), (hit.u, ref.u), (hit.v, ref.v)))
        max_err["trace_closest"] = max(max_err["trace_closest"], err)
        sparse = torch.arange(N_RAYS, device=dev) % 7 == 0  # K1a's compaction, few lanes
        s_hit = trace_mod.trace_closest(tris, o, d, 1e-4, 3.0e38, sparse)
        s_ref = trace_mod._closest_plain(tris, o, d, lanes(1e-4, N_RAYS),
                                         lanes(3.0e38, N_RAYS), sparse)
        torch.cuda.synchronize()
        check(torch.equal(s_hit.tri, s_ref.tri) and all(
            torch.equal(bits(a), bits(b)) for a, b in
            ((s_hit.t, s_ref.t), (s_hit.u, s_ref.u), (s_hit.v, s_ref.v))),
            f"trace_closest {scene}, every 7th lane active: not bit-equal to plain")
        occ = trace_mod.trace_any(tris, o, d, 0.0, tmax, active)
        occ_ref = trace_mod._any_plain(tris, o, d, lanes(0.0, N_RAYS), tmax, active)
        s_occ = trace_mod.trace_any(tris, o, d, 0.0, tmax, sparse)  # K1b's split rays
        s_occ_ref = trace_mod._any_plain(tris, o, d, lanes(0.0, N_RAYS), tmax, sparse)
        torch.cuda.synchronize()
        check(torch.equal(occ, occ_ref), f"trace_any {scene}: occ differs from plain")
        check(torch.equal(s_occ, s_occ_ref),
              f"trace_any {scene}, every 7th lane active: occ differs from plain")
        max_err["trace_any"] = max(max_err["trace_any"], float((occ != occ_ref).sum()))
        hits = float((hit.tri >= 0).float().mean())
        check(0.05 < hits and bool(occ.any()) and not bool(occ.all()),
              f"{scene}: degenerate test rays (hit fraction {hits})")
        log(f"[3 kernels] {scene} ({tris.shape[1]} tris, {N_RAYS} rays, "
            f"{float(active.float().mean()):.2f} active): trace_closest tri equal, t/u/v "
            f"bit-equal (hit {hits:.3f}), also with every 7th lane active; trace_any equal "
            f"(occluded {float(occ.float().mean()):.3f}), also with every 7th lane active")
    for rows, cols in ((36, 52), (36, 23), (4096, 52)):
        table = torch.randn(rows, cols, generator=gen, device=dev)
        idx = torch.randint(-4, rows + 4, (N_RAYS,), generator=gen, device=dev,
                            dtype=torch.int32)
        out = gather_mod.gather_rows(table, idx)
        ref = gather_mod._gather_plain(table, idx)
        torch.cuda.synchronize()
        check(torch.equal(bits(out), bits(ref)), f"gather_rows ({rows}, {cols}): not bit-equal")
        max_err["gather_rows"] = max(max_err["gather_rows"], float((out - ref).abs().max()))
        log(f"[3 kernels] gather_rows ({rows}, {cols}) x {N_RAYS} indices "
            f"({float(((idx < 0) | (idx >= rows)).float().mean()):.3f} out of range): bit-equal")
    # K2b at the AD path's two shapes: the CornellBox's shade table (the
    # shared-memory mode) and big_room's (the atomic mode)
    for rows, cols, n in ((36, 52, N_RAYS), (99_636, 52, BIG_W * BIG_H)):
        idx = torch.randint(-4, rows + 4, (n,), generator=gen, device=dev, dtype=torch.int32)
        g = torch.randn(n, cols, generator=gen, device=dev)
        out = gather_mod.gather_rows_bwd(g, idx, rows)
        again = gather_mod.gather_rows_bwd(g, idx, rows)
        ref = gather_mod._gather_bwd_plain(g, idx, rows)
        scale = gather_mod._gather_bwd_plain(g.abs(), idx, rows)
        torch.cuda.synchronize()
        rel = float(((out - ref).abs() / scale.clamp_min(1e-30)).max())
        check(rel <= gather_mod.BWD_RTOL, f"gather_rows_bwd ({rows}, {cols}): {rel:.3g} of sum|g|"
                                          f" from plain, over BWD_RTOL {gather_mod.BWD_RTOL}")
        shared = gather_mod.bwd_slices(rows, cols) > 0
        same = torch.equal(bits(out), bits(again))
        check(same or not shared, f"gather_rows_bwd ({rows}, {cols}): the shared-memory mode "
                                  "gave other bits on a second launch")
        log(f"[3 kernels] gather_rows_bwd ({rows}, {cols}) x {n} lanes "
            f"({'shared-memory' if shared else 'atomic'} mode): max |K2b - plain| "
            f"{float((out - ref).abs().max()):.3g} = {rel:.3g} of sum|g| (tolerance "
            f"{gather_mod.BWD_RTOL:g}); two launches bit-equal: {same}")

    mark("3b")
    # ---- 3b. megakernels vs plain on the card ----
    # the CornellBox has no transmissive or coated material, so its three
    # lobe sets trace the same paths; glass_cornell_box drives those lobes
    glossy = cornell_box(glossy_boxes=True)
    mview = SceneView.build(glossy, cornell_camera(), dev)
    glass_view = SceneView.build(glass_cornell_box(), cornell_camera(), dev)
    lobes_scene = tuple(scene_lobes(glossy.materials))
    nm = MEGA_RES * MEGA_RES
    for label, lobes, cc, mv in (
            ("scene lobes", lobes_scene, False, mview), ("all lobes", ALL_LOBES, False, mview),
            ("all lobes + clearcoat", ALL_LOBES, True, mview),
            ("glass boxes, all lobes + clearcoat", ALL_LOBES, True, glass_view)):
        mopts = pt.PTOptions(tracer="mega", max_path_length=MPL, lobes=lobes, clearcoat=cc)
        tb = pt_mega.build_mega_tables(mv, MEGA_RES, MEGA_RES, mopts.ray_eps)
        out = pt_mega._mega_forward(tb, mopts, MEGA_RES, nm, 7, 0)
        ref = pt_mega._mega_plain(tb, mopts, MEGA_RES, nm, 7, 0)
        torch.cuda.synchronize()
        check(float(out[26].sum()) == float(ref[26].sum()),
              f"mega_forward {label}: rays {float(out[26].sum())} vs plain {float(ref[26].sum())}")
        worst = 1.0
        for c0, cname in ((0, "direct"), (3, "diffuse"), (6, "specular")):
            ok, near, mean_rel = lanes_close(out[c0:c0 + 3], ref[c0:c0 + 3])
            check(ok, f"mega_forward {label}: {cname} differs ({near}, {mean_rel})")
            worst = min(worst, near)
        ok, near, _ = lanes_close(out[0:3] + out[3:6] + out[6:9], ref[0:3] + ref[3:6] + ref[6:9])
        check(ok, f"mega_forward {label}: composited differs")
        hit_eq = float((out[10] == ref[10]).float().mean())
        check(hit_eq >= 0.999, f"mega_forward {label}: hit flag equal on {hit_eq}")
        bit_eq = float((bits(out) == bits(ref)).all(dim=0).float().mean())
        max_err["mega_forward"] = max(max_err["mega_forward"],
                                      float((out[:9] - ref[:9]).abs().max()))
        check(float(out[:9].sum()) > 0.0, f"mega_forward {label}: black image")
        log(f"[3b mega] mega_forward {label}, {MEGA_RES}x{MEGA_RES} mpl={MPL}: rays equal "
            f"({float(out[26].sum()):.0f}); pixels close >= {worst:.4f}; hit flag equal "
            f"{hit_eq:.4f}; bit-equal pixels (all 27 lanes) {bit_eq:.4f}")
    for label, lobes, mv in (("scene lobes", lobes_scene, mview),
                             ("all lobes", ALL_LOBES, mview),
                             ("glass boxes, all lobes", ALL_LOBES, glass_view)):
        mopts = pt.PTOptions(tracer="mega", max_path_length=MPL, lobes=lobes)
        tb = pt_mega.build_mega_tables(mv, MEGA_RES, MEGA_RES, mopts.ray_eps)
        img = pt_mega._mega_forward(tb, mopts, MEGA_RES, nm, 9, 0)
        comp = (img[0:3] + img[3:6] + img[6:9]).t().contiguous()
        adjoint = 2.0 * (comp - 0.2) / (nm * 3)
        g = pt_mega._mega_grad(tb, mopts, MEGA_RES, nm, 9, 0, adjoint)
        g_ref = pt_mega._mega_grad_plain(tb, mopts, MEGA_RES, nm, 9, 0, adjoint)
        torch.cuda.synchronize()
        scale = float(g_ref.abs().max())
        err = float((g - g_ref).abs().max())
        check(scale > 0.0 and err <= 1e-3 * scale,
              f"mega_grad {label}: max err {err} vs max|g| {scale}")
        max_err["mega_grad"] = max(max_err["mega_grad"], err)
        log(f"[3b mega] mega_grad {label}, {MEGA_RES}x{MEGA_RES} mpl={MPL}, MSE vs 0.2: "
            f"max |g - plain| {err:.3g} = {err / scale:.2e} of max|g| {scale:.4g}")

    mark("3c")
    # ---- 3c. large-scene kernels vs plain on the card ----
    t0 = time.perf_counter()
    room = big_room(BIG_BOXES)
    bctx = RenderingContext.create(room, big_room_camera(), BIG_W, BIG_H, renderer="pt",
                                   max_path_length=MPL)
    bview = bctx.view
    cl_room = bview.clusters
    check(cl_room is not None and bview.lights.compact is not None,
          "big_room's view has no cluster table or no emissive subset")
    log(f"[3c large] big_room({BIG_BOXES}): {room.n_triangles} triangles, "
        f"{int((cl_room.count > 0).sum())} clusters ({cl_room.rows.shape[0]} padded to groups, "
        f"{cl_room.lo_x.shape[1]} box columns), {cl_room.node_box.shape[0]} top-level nodes, "
        f"{bview.lights.compact[0].shape[0]} emissive rows; view built in "
        f"{time.perf_counter() - t0:.1f} s")
    soup_storage = random_soup(4096)
    soup_mesh = soup_storage.device_view(dev)
    soup_cl = build_clusters(soup_mesh)
    t0 = time.perf_counter()
    sub_room = build_subclusters(bview.mesh)
    log(f"[3c large] big_room({BIG_BOXES}) subcluster table: {sub_room.n_subclusters} "
        f"subclusters of at most 32 triangles ({float(sub_room.count.float().mean()):.1f} on "
        f"average, {sub_room.lo_x.shape[1]} box columns), built in "
        f"{time.perf_counter() - t0:.1f} s")
    subs_of = {"big_room": sub_room, "soup4096": build_subclusters(soup_mesh)}
    pix = torch.arange(256 * 256, device=dev)
    jx, jy = TiledSequence.create(0, 0).sample_2d(pix, 0)
    cam_o, cam_d, _ = generate_camera_rays(bview.camera, 256, 256, jx, jy, pix)
    for scene, cl, lo, hi in (("big_room", cl_room, (-8.0, 0.0, -8.0), (8.0, 8.0, 8.0)),
                              ("soup4096", soup_cl, tuple(soup_storage.vertices.min(0)),
                               tuple(soup_storage.vertices.max(0)))):
        lo_t = torch.tensor(lo, device=dev)[:, None]
        hi_t = torch.tensor(hi, device=dev)[:, None]
        o = torch.rand(3, N_LARGE, generator=gen, device=dev) * (hi_t - lo_t) + lo_t
        d = torch.randn(3, N_LARGE, generator=gen, device=dev)
        d = d / d.norm(dim=0, keepdim=True)
        ray_sets = [("random", Vec3(*o), Vec3(*d))]
        if scene == "big_room":
            ray_sets.append(("camera", cam_o, cam_d))
        for rays, o, d in ray_sets:
            n = o.x.shape[0]
            active = torch.rand(n, generator=gen, device=dev) < 0.8
            tmax = torch.rand(n, generator=gen, device=dev) * float((hi_t - lo_t).norm())
            hit = ft.trace_closest_frontier(cl, o, d, 1e-4, 3.0e38, active, with_uv=False)
            ref = ft._closest_uv_plain(cl, o, d, lanes(1e-4, n), lanes(3.0e38, n), active)
            occ = ft.trace_any_frontier(cl, o, d, 0.0, tmax, active)
            occ_ref = ft._any_plain(cl, o, d, lanes(0.0, n), tmax, active)
            torch.cuda.synchronize()
            check(torch.equal(hit.tri, ref.tri), f"K5a {scene} {rays}: tri differs from plain")
            check(torch.equal(bits(hit.t), bits(ref.t)), f"K5a {scene} {rays}: t not bit-equal")
            check(torch.equal(occ, occ_ref), f"K5b {scene} {rays}: occ differs from plain")
            for t0, t1 in ((1e-4, 3.0e38), (0.0, tmax)):  # the keys K5a and K5b sorted by
                key = ft.sort_key(cl, o, d, t0, t1, active)
                check(torch.equal(key, ft._sort_key_plain(cl, o, d, lanes(t0, n), lanes(t1, n),
                                                          active)),
                      f"K5 sort key {scene} {rays}: differs from its plain version")
            # K6 and K7 on the same rays: bit-equal to the plain versions
            # (u, v included) and so to K5
            for label, f_c, f_a, consts in (
                    ("K6", ct.trace_closest_cluster, ct.trace_any_cluster, []),
                    ("K7", bt.trace_closest_binned, bt.trace_any_binned, []),
                    ("K7 queue=1 block=32", bt.trace_closest_binned, bt.trace_any_binned,
                     [(bt, "BLOCK", 32), (bt, "QUEUE", 1)])):
                with patched(consts):
                    h6 = f_c(cl, o, d, 1e-4, 3.0e38, active)
                    o6 = f_a(cl, o, d, 0.0, tmax, active)
                    torch.cuda.synchronize()
                check(torch.equal(h6.tri, ref.tri) and torch.equal(h6.tri, hit.tri),
                      f"{label} {scene} {rays}: tri differs from plain or K5")
                for a, b, what in ((h6.t, ref.t, "t"), (h6.u, ref.u, "u"), (h6.v, ref.v, "v")):
                    check(torch.equal(bits(a), bits(b)), f"{label} {scene} {rays}: {what} not "
                                                         "bit-equal to plain")
                check(torch.equal(o6, occ_ref) and torch.equal(o6, occ),
                      f"{label} {scene} {rays}: occ differs from plain or K5")
            # K8 over the subcluster table: bit-equal to its plain versions
            # (K5's over that table) and to K5
            subs = subs_of[scene]
            h8 = st.trace_closest_sub(subs, o, d, 1e-4, 3.0e38, active)
            o8 = st.trace_any_sub(subs, o, d, 0.0, tmax, active)
            r8 = ft._closest_uv_plain(subs, o, d, lanes(1e-4, n), lanes(3.0e38, n), active)
            p8 = ft._any_plain(subs, o, d, lanes(0.0, n), tmax, active)
            torch.cuda.synchronize()
            check(torch.equal(h8.tri, r8.tri) and torch.equal(h8.tri, ref.tri),
                  f"K8a {scene} {rays}: tri differs from plain or K5")
            for a, b, what in ((h8.t, r8.t, "t"), (h8.u, r8.u, "u"), (h8.v, r8.v, "v"),
                               (h8.t, ref.t, "t vs K5")):
                check(torch.equal(bits(a), bits(b)), f"K8a {scene} {rays}: {what} not bit-equal")
            check(torch.equal(o8, p8) and torch.equal(o8, occ_ref),
                  f"K8b {scene} {rays}: occ differs from plain or K5")
            hits = float((hit.tri >= 0).float().mean())
            check(0.05 < hits and bool(occ.any()) and not bool(occ.all()),
                  f"{scene} {rays}: degenerate test rays (hit fraction {hits})")
            log(f"[3c large] {scene} ({cl.rows.shape[0]} clusters), {n} {rays} rays "
                f"({float(active.float().mean()):.2f} active): trace_closest_frontier tri equal, "
                f"t bit-equal (hit {hits:.3f}); trace_any_frontier equal (occluded "
                f"{float(occ.float().mean()):.3f}); their sort keys equal to plain; K6a/K6b, "
                f"K7a/K7b and K7 with a queue of 1 and "
                f"work items of 32 rays bit-equal to the plain versions (t, tri, u, v; occ) and to K5; "
                f"K8a/K8b over {subs_of[scene].n_subclusters} subclusters bit-equal to their "
                f"plain versions and to K5")
    w = torch.rand(544, generator=gen, device=dev) + 1e-3
    for label, rows, cdf in (("big_room emissive subset", *bview.lights.compact),
                             ("544 rows", torch.randn(544, 23, generator=gen, device=dev),
                              (torch.cumsum(w, 0) / w.sum()).contiguous())):
        u = torch.rand(N_RAYS, generator=gen, device=dev)
        u[:rows.shape[0]] = cdf
        u[rows.shape[0]:rows.shape[0] + 3] = torch.tensor([float("nan"), 1.0, 1.5], device=dev)
        out = cdf_gather.cdf_pick_rows(rows, cdf, u)
        ref = cdf_gather._pick_plain(rows, cdf, u)
        torch.cuda.synchronize()
        check(torch.equal(bits(out), bits(ref)), f"cdf_pick_rows {label}: not bit-equal")
        check(torch.equal(out[rows.shape[0]], rows[0]), f"cdf_pick_rows {label}: NaN u")
        log(f"[3c large] cdf_pick_rows {label} ({rows.shape[0]}x{rows.shape[1]}) x {N_RAYS} "
            f"(u = cdf entries, NaN, 1.0, 1.5 included): bit-equal")

    mark("4")
    # ---- 4. main path ----
    ctx = RenderingContext.create(cornell_box(glossy_boxes=True), cornell_camera(), RES, RES,
                                  renderer="pt", max_path_length=MPL)
    check(ctx.device.type == "cuda", "RenderingContext did not default to cuda")
    ctx.render(1)  # warm-up (first-use costs)
    reset_counts()
    best, best_rays = best_batches(ctx)
    launches = {n: k.launches for n, k in kernels.items()}
    n_main = PASSES * REPS
    hdr = ctx.hdr_image()
    check(np.isfinite(hdr).all() and hdr.shape == (RES, RES, 3), "image not finite")
    check(float(hdr.mean()) > 0.01, f"image is black (mean {hdr.mean()})")
    for n in dense:
        check(launches[n] > 0, f"kernel {n} was never launched on the main path")
    check(all(launches[n] == 0 for n in (*mega, *large, *tracers, *ad, *subk, *bvhk)),
          f"the dense CornellBox path launched another kernel: {launches}")
    mrays = best_rays / best / 1e6
    ms_pass = best / PASSES * 1e3
    log(f"[4 main] CornellBox glossy {RES}x{RES} mpl={MPL}: {ms_pass:.2f} ms/pass, "
        f"{mrays:.2f} Mrays/s ({best_rays / PASSES:.0f} rays/pass; best of {REPS} x "
        f"{PASSES} passes) on {smi}; image mean {hdr.mean():.4f}; launches over "
        f"{n_main} passes: {launches}")
    n_kern, busy_ms, top, d_each = profile_one_pass(
        ctx, expect=("closest_kernel", "any_kernel", "gather_rows_kernel"))
    # the dense kernels' own device time inside the profiled pass, beside
    # phase 6's replays
    d_in_pass = {"trace_closest": launches_named(d_each, "closest_kernel"),
                 "trace_any": launches_named(d_each, "any_kernel"),
                 "gather_rows": launches_named(d_each, "gather_rows_kernel")}
    check(len(d_in_pass["trace_closest"]) == MPL and len(d_in_pass["trace_any"]) == MPL,
          f"the profiled dense pass: K1a/K1b launches {d_in_pass}")
    log(f"[4 main] one pass under torch.profiler: {n_kern} device kernels, device busy "
        f"{busy_ms:.2f} ms of the {ms_pass:.2f} ms pass (idle share "
        f"{1 - busy_ms / ms_pass:.3f}); top by device time: "
        + "; ".join(f"{n[:60]} {t / 1e3:.2f} ms x{c}" for n, (t, c) in top))

    mark("4b")
    # ---- 4b. the megakernel path ----
    mctx = RenderingContext.create(glossy, cornell_camera(), RES, RES, renderer="pt",
                                   max_path_length=MPL, tracer="mega")
    mctx.render(1)  # warm-up (first-use costs: the build, the tables)
    reset_counts()
    m_best, m_rays = best_batches(mctx)
    m_launches = {n: k.launches for n, k in kernels.items()}
    m_hdr = mctx.hdr_image()
    check(np.isfinite(m_hdr).all() and m_hdr.shape == (RES, RES, 3), "mega image not finite")
    check(float(m_hdr.mean()) > 0.01, f"mega image is black (mean {m_hdr.mean()})")
    check(m_launches["mega_forward"] == n_main,
          f"mega_forward launched {m_launches['mega_forward']} times in {n_main} passes")
    check(all(m_launches[n] == 0 for n in dense) and m_launches["mega_grad"] == 0,
          f"the mega path launched another kernel: {m_launches}")
    m_ms = m_best / PASSES * 1e3
    m_mrays = m_rays / m_best / 1e6
    log(f"[4b mega] CornellBox glossy {RES}x{RES} mpl={MPL} tracer=mega: {m_ms:.3f} ms/pass, "
        f"{m_mrays:.2f} Mrays/s ({m_rays / PASSES:.0f} rays/pass; best of {REPS} x {PASSES} "
        f"passes) on {smi}; image mean {m_hdr.mean():.4f}; launches over {n_main} passes: "
        f"{m_launches}")
    mk_n, m_busy, m_top, m_each = profile_one_pass(mctx, expect=("mega_forward_kernel",))
    # the kernels' own device time inside the profiled passes, beside phase
    # 6's replays of the same kernels
    in_pass = {"mega_forward": launches_named(m_each, "mega_forward_kernel")}
    log(f"[4b mega] one pass under torch.profiler: {mk_n} device kernels, device busy "
        f"{m_busy:.3f} ms of the {m_ms:.3f} ms pass (idle share {1 - m_busy / m_ms:.3f}); top: "
        + "; ".join(f"{n[:50]} {t / 1e3:.3f} ms x{c}" for n, (t, c) in m_top))

    mark("4c")
    # ---- 4c. train step (bench.py:129-150) ----
    t_opts = pt.PTOptions(**mctx.renderer_options)
    check(pt_mega.mega_grad_eligible(mctx.view, t_opts), "mega_grad_eligible fails")
    t_tb = pt_mega.build_mega_tables(mctx.view, RES, RES, t_opts.ray_eps)
    target = torch.zeros((RES * RES, 3), device=dev)

    def train_step(inst):
        out = pt_mega.render_pass_mega(mctx.view, t_opts, RES, RES, inst, 0, tables=t_tb)
        img = out.composited.stack()
        loss = torch.mean((img - target) ** 2)
        adjoint = 2.0 * (img - target) / (img.shape[0] * 3)
        grad = pt_mega.render_grad_diffuse_mega(mctx.view, t_opts, RES, RES, inst, adjoint, 0,
                                                tables=t_tb)
        return loss, out.rays, grad, adjoint

    train_step(0)
    torch.cuda.synchronize()
    reset_counts()
    t_best, t_rays, t_grad = float("inf"), 0.0, None
    for rep in range(REPS):
        t0 = time.perf_counter()
        loss, rays_v, grad, adjoint = train_step(rep + 1)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if dt < t_best:
            t_best, t_rays, t_grad = dt, float(rays_v), grad
    # the last step's own inputs: K3b is held to its plain version on them (5b)
    # and timed on them (6)
    t_inst, t_adj = REPS, adjoint
    t_launches = {n: k.launches for n, k in kernels.items()}
    check(t_launches["mega_forward"] == REPS and t_launches["mega_grad"] == REPS,
          f"train steps launched {t_launches}")
    check(bool(torch.isfinite(t_grad).all()) and float(t_grad.abs().max()) > 0.0,
          "train-step gradient is not finite or is zero")
    t_mrays = t_rays / t_best / 1e6
    log(f"[4c train] {RES}x{RES} mpl={MPL} MSE vs 0, K3a + K3b: {t_best * 1e3:.3f} ms/step, "
        f"train {t_mrays:.2f} Mrays/s (forward rays / step wall time; best of {REPS}) on {smi}; "
        f"loss {float(loss):.5g}; launches over {REPS} steps: {t_launches}; dL/d diffuse "
        f"{np.round(t_grad.cpu().numpy(), 6).tolist()}")

    mark("4d")
    # ---- 4d. the large-scene path: big_room 1600x896 (tools/bench_secondaries.py) ----
    bopts = pt.PTOptions(**bctx.renderer_options)
    n_big = BIG_PASSES * REPS
    per_bounce = MPL * n_big
    big = {}
    for mode in ("monolithic", "narrow=1"):
        narrow = mode != "monolithic"
        if narrow:
            bctx.renderer_options["narrow"] = 1
            bctx.restart()
        bctx.render(1)  # warm-up (first-use costs)
        reset_counts()
        b_best, b_rays = best_batches(bctx, BIG_PASSES, narrow=narrow)
        b_launches = {n: k.launches for n, k in kernels.items()}
        b_hdr = bctx.hdr_image()
        check(np.isfinite(b_hdr).all() and b_hdr.shape == (BIG_H, BIG_W, 3),
              f"big_room {mode}: image not finite")
        check(float(b_hdr.mean()) > 0.001, f"big_room {mode}: image is black ({b_hdr.mean()})")
        check(all(b_launches[n] == 0 for n in ("trace_closest", "trace_any", *mega, *tracers,
                                               *ad, *subk, *bvhk)),
              f"big_room {mode} launched a kernel of another path: {b_launches}")
        for n in large:
            check(b_launches[n] > 0, f"kernel {n} was never launched on the big_room path")
        if not narrow:  # every bounce runs: one closest trace, NEE, one shadow ray set;
            # each trace sorts its 1,433,600 rays first
            check(all(b_launches[n] == per_bounce for n in large)
                  and ft.KEY.launches == 2 * per_bounce,
                  f"big_room monolithic: {counts()} over {n_big} passes of {MPL} bounces")
        b_ms = b_best / BIG_PASSES * 1e3
        b_mrays = b_rays / b_best / 1e6
        n_kern, busy_ms, top, each = profile_one_pass(
            bctx, narrow=narrow, expect=("trace_kernel<true>", "trace_kernel<false>"))
        if not narrow:
            in_pass.update(trace_closest_frontier=launches_named(each, "trace_kernel<true>"),
                           trace_any_frontier=launches_named(each, "trace_kernel<false>"),
                           frontier_sort_key=launches_named(each, "key_kernel"),
                           radix_sort=launches_named(each, "Radix"))
            check(len(in_pass["trace_closest_frontier"]) == MPL
                  and len(in_pass["trace_any_frontier"]) == MPL,
                  f"big_room monolithic: K5 launches in the profiled pass: {in_pass}")
        prof = bctx._pass[3].last_profile if narrow else None
        big[mode] = dict(ms=b_ms, mrays=b_mrays, rays=b_rays / BIG_PASSES, launches=b_launches,
                         kernels=n_kern, busy_ms=busy_ms, idle=1 - busy_ms / b_ms)
        log(f"[4d large] big_room({BIG_BOXES}) {BIG_W}x{BIG_H} mpl={MPL} {mode}: {b_ms:.2f} "
            f"ms/pass, {b_mrays:.3f} Mrays/s ({b_rays / BIG_PASSES:.0f} rays/pass; best of "
            f"{REPS} x {BIG_PASSES} passes) on {smi}; image mean {b_hdr.mean():.4f}; launches "
            f"over {n_big} passes: {b_launches}"
            + (f"; (bounce, live, width): {prof}" if prof else ""))
        log(f"[4d large] {mode}: one pass under torch.profiler: {n_kern} device kernels, device "
            f"busy {busy_ms:.2f} ms of the {b_ms:.2f} ms pass (idle share "
            f"{1 - busy_ms / b_ms:.3f}); top by device time: "
            + "; ".join(f"{n[:60]} {t / 1e3:.2f} ms x{c}" for n, (t, c) in top))
    bctx.renderer_options.pop("narrow")
    bctx.restart()

    mark("4e")
    # ---- 4e. tracer="cluster" and tracer="binned" on big_room ----
    groups = {"closest": 0, "any": 0}

    def grouped(kind, fn):
        def wrapper(*args, **kw):
            groups[kind] += 1
            return fn(*args, **kw)
        return wrapper

    tctx = {}
    for tracer in ("cluster", "binned"):
        c4 = RenderingContext.create(room, big_room_camera(), BIG_W, BIG_H, renderer="pt",
                                     max_path_length=MPL, tracer=tracer)
        check(c4.view.clusters is not None, f"tracer={tracer}: the view has no cluster table")
        c4.render(1)  # warm-up (first-use costs)
        reset_counts()
        groups.update(closest=0, any=0)
        with patched([(pt, f"trace_closest_{tracer}",
                       grouped("closest", getattr(pt, f"trace_closest_{tracer}"))),
                      (pt, f"trace_any_{tracer}", grouped("any", getattr(pt, f"trace_any_{tracer}")))]):
            e_best, e_rays = best_batches(c4, BIG_PASSES)
        e_launches = counts()
        e_hdr = c4.hdr_image()
        check(np.isfinite(e_hdr).all() and e_hdr.shape == (BIG_H, BIG_W, 3),
              f"big_room tracer={tracer}: image not finite")
        check(float(e_hdr.mean()) > 0.001, f"big_room tracer={tracer}: image is black")
        mine = [n for n in tracers if n.endswith(tracer)]
        others = [n for n in (*dense, *mega, *tracers, *ad, *subk)
                  if n not in mine and n != "gather_rows"]
        check(all(e_launches[n] == 0 for n in (*others, "trace_closest_frontier",
                                                "trace_any_frontier", "frontier_sort_key")),
              f"big_room tracer={tracer} launched a kernel of another path: {e_launches}")
        check(groups["closest"] == per_bounce and groups["any"] == per_bounce,
              f"tracer={tracer}: {groups} tracer calls over {n_big} passes of {MPL} bounces")
        check(e_launches["cdf_pick_rows"] == per_bounce, f"tracer={tracer}: K4 {e_launches}")
        if tracer == "cluster":
            check(all(e_launches[n] == per_bounce for n in mine),
                  f"tracer=cluster: {e_launches} over {n_big} passes of {MPL} bounces")
            loop = None
        else:
            check(all(e_launches[n] > 0 for n in (*mine, *scans)),
                  f"tracer=binned: a kernel was never launched: {e_launches}")
            loop = dict(vars(bt.LOOP))  # the loop's totals over these passes
            # the round loop on the device: a readback of its counts per
            # batch of ROUND_BATCH rounds, the last finding the loop over
            check(loop["traces"] == 2 * per_bounce
                  and loop["readbacks"] <= loop["rounds"] / bt.ROUND_BATCH + loop["traces"],
                  f"tracer=binned: {loop} over {2 * per_bounce} traces")
        e_ms = e_best / BIG_PASSES * 1e3
        n_kern, busy_ms, top, each = profile_one_pass(c4)
        # K7's device time in the pass, by kind (the kernels' template
        # argument) and family
        fam = {k: {"scan": 0.0, "bin": 0.0, "test": 0.0} for k in ("closest", "any")}
        for name, v in each.items():
            if bt.kernel_family(name) != "other":
                fam["closest" if "<true" in name else "any"][bt.kernel_family(name)] += sum(v)
        # test launches: every enqueued round, the empty ones of a group's
        # last batch included; rounds: those that tested rays
        rounds = {k: e_launches[f"trace_{k}_binned"] / per_bounce for k in ("closest", "any")}
        big[tracer] = dict(ms=e_ms, mrays=e_rays / e_best / 1e6, rays=e_rays / BIG_PASSES,
                           launches=e_launches, groups=dict(groups), kernels=n_kern,
                           busy_ms=busy_ms, idle=1 - busy_ms / e_ms, rounds=rounds,
                           loop=loop, in_pass_ms=fam)
        log(f"[4e tracers] big_room({BIG_BOXES}) {BIG_W}x{BIG_H} mpl={MPL} tracer={tracer}: "
            f"{e_ms:.2f} ms/pass, {e_rays / e_best / 1e6:.3f} Mrays/s ({e_rays / BIG_PASSES:.0f} "
            f"rays/pass; best of {REPS} x {BIG_PASSES} passes) on {smi}; image mean "
            f"{e_hdr.mean():.4f}; launches over {n_big} passes: "
            f"{ {n: e_launches[n] for n in (*mine, *large, *scans)} }; tracer calls "
            f"(launch groups) {groups}"
            + (f"; enqueued rounds per launch group: closest {rounds['closest']:.1f}, any "
               f"{rounds['any']:.1f}; over both kinds, rounds that tested rays per group "
               f"{loop['rounds'] / loop['traces']:.1f}, host readbacks per group "
               f"{loop['readbacks'] / loop['traces']:.2f} (batches of {bt.ROUND_BATCH}, a "
               f"graph launch each), full "
               f"box scans per visit {loop['scans'] / max(loop['pairs'], 1):.3f} "
               f"({loop['scans']} scans, {loop['pairs']} ray-cluster visits)"
               if tracer == "binned" else ""))
        log(f"[4e tracers] tracer={tracer}: one pass under torch.profiler: {n_kern} device "
            f"kernels, device busy {busy_ms:.2f} ms of the {e_ms:.2f} ms pass (idle share "
            f"{1 - busy_ms / e_ms:.3f}); top by device time: "
            + "; ".join(f"{n[:60]} {t / 1e3:.2f} ms x{c}" for n, (t, c) in top)
            + "".join(f"; K7 {k} in the pass: scan {f['scan']:.2f} ms, counting sort "
                      f"{f['bin']:.2f} ms, test {f['test']:.2f} ms ({sum(f.values()):.2f} ms, "
                      f"{sum(f.values()) / MPL * 1e3:.1f} us a launch group)"
                      for k, f in fam.items() if tracer == "binned"))
        tctx[tracer] = c4

    # one PLAIN_W x PLAIN_H pass with each tracer and one with the plain
    # versions forced in their place: bit-equal; the frontier pass beside
    # them (phase 6 holds K6 and K7 to K5's plain answer on every ray of a
    # full-width pass)
    def plain_closest_uv(cl, o, d, tmin, tmax, active=None, **_):
        n = o.x.shape[0]
        return ft._closest_uv_plain(cl, o, d, lanes(tmin, n), lanes(tmax, n), active)

    def plain_any(cl, o, d, tmin, tmax, active=None, **_):
        n = o.x.shape[0]
        return ft._any_plain(cl, o, d, lanes(tmin, n), lanes(tmax, n), active)

    copts = pt.PTOptions(**tctx["cluster"].renderer_options)
    cview = tctx["cluster"].view
    t0 = time.perf_counter()
    out_c = pt.render_pass(cview, copts, PLAIN_W, PLAIN_H, 1000, 0)
    out_b = pt.render_pass(cview, copts._replace(tracer="binned"), PLAIN_W, PLAIN_H, 1000, 0)
    before = counts()
    with patched([(pt, "trace_closest_cluster", plain_closest_uv),
                  (pt, "trace_any_cluster", plain_any),
                  (pt, "cdf_pick_rows", cdf_gather._pick_plain),
                  (mesh_mod, "gather_rows", gather_mod._gather_plain),
                  (lights_mod, "gather_rows", gather_mod._gather_plain)]):
        out_p = pt.render_pass(cview, copts, PLAIN_W, PLAIN_H, 1000, 0)
    torch.cuda.synchronize()
    check(before == counts(), "the forced plain cluster pass launched a kernel")
    chans = ("composited", "direct", "diffuse", "specular", "diffuse_albedo", "specular_albedo",
             "normal", "position")
    for label, other in (("binned", out_b), ("forced plain", out_p)):
        for c in chans:
            check(torch.equal(bits(getattr(out_c, c).stack()), bits(getattr(other, c).stack())),
                  f"cluster vs {label} pass: {c} not bit-equal")
        check(torch.equal(out_c.tri, other.tri) and torch.equal(bits(out_c.depth), bits(other.depth))
              and float(out_c.rays) == float(other.rays), f"cluster vs {label} pass: hits differ")
    out_f = pt.render_pass(cview, copts._replace(tracer="frontier"), PLAIN_W, PLAIN_H, 1000, 0)
    report = []
    for c in ("composited", "direct", "diffuse", "specular"):
        ok, near, mean_rel = image_close(getattr(out_c, c).stack().cpu().numpy(),
                                         getattr(out_f, c).stack().cpu().numpy())
        check(ok, f"cluster vs frontier pass: {c} outside the golden tolerance")
        report.append(f"{c} {near:.4f}/{mean_rel:.1e}")
    f_tri = float((out_c.tri == out_f.tri).float().mean())
    log(f"[4e tracers] {PLAIN_W}x{PLAIN_H} pass (instance 1000) with tracer=cluster, tracer=binned "
        f"and the plain versions forced: bit-equal (every channel, G-buffer, first hits, rays "
        f"{float(out_c.rays):.0f}); against the frontier pass: rays {float(out_f.rays):.0f}, "
        f"first hits equal {f_tri:.5f}, pixels close/mean rel " + ", ".join(report)
        + f" ({time.perf_counter() - t0:.1f} s for the four passes)")
    del out_c, out_b, out_p, out_f

    mark("4f")
    # ---- 4f. the differentiable pass: AD train steps (bench.py:152-163) ----
    bwd_calls = {"cornell": [], "big_room": []}

    def bwd_recorder(key):
        def wrapper(g, idx, rows):
            bwd_calls[key].append((g, idx, rows))
            return gather_rows_bwd(g, idx, rows)
        return wrapper

    gather_rows_bwd = gather_mod.gather_rows_bwd

    def ad_step(view, opts, res_x, res_y, inst):
        """One AD train step: (loss, forward rays, d loss / d diffuse (M, 3),
        the adjoint d loss / d composited). The diffuse albedos are a leaf
        (M, 3) tensor; loss = MSE against a zero target."""
        leaf = view.mesh.materials.diffuse.stack().detach().clone().requires_grad_(True)
        mats = view.mesh.materials._replace(diffuse=Vec3(leaf[:, 0], leaf[:, 1], leaf[:, 2]))
        out = pt.render_pass(view._replace(mesh=view.mesh._replace(materials=mats)), opts,
                             res_x, res_y, inst, 0)
        img = out.composited.stack()
        loss = torch.mean(img ** 2)
        loss.backward()
        return loss.detach(), out.rays, leaf.grad, (2.0 * img / img.numel()).detach()

    def timed_steps(view, opts, res_x, res_y, steps, first_inst):
        """Best wall time of `steps` synced AD steps, its forward rays, the
        last step's (instance, gradient, adjoint), the peak device memory."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        best, rays, last = float("inf"), 0.0, None
        for k in range(steps):
            t0 = time.perf_counter()
            _, rays_v, grad, adj = ad_step(view, opts, res_x, res_y, first_inst + k)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if dt < best:
                best, rays = dt, float(rays_v)
            last = (first_inst + k, grad, adj)
        return best, rays, last, torch.cuda.max_memory_allocated(dev)

    adr = {}
    a_opts = pt.PTOptions(**ctx.renderer_options)
    ad_step(ctx.view, a_opts, RES, RES, 1)  # warm-up
    reset_counts()
    a_best, a_rays, (a_inst, a_grad, a_adj), a_peak = timed_steps(ctx.view, a_opts, RES, RES,
                                                                  1, 2)
    a_launches = counts()
    check(a_launches["gather_rows_bwd"] > 0 and all(a_launches[n] > 0 for n in dense),
          f"the CornellBox AD step did not launch K1, K2 and K2b: {a_launches}")
    check(all(a_launches[n] == 0 for n in (*mega, *large, *tracers, *subk)),
          f"the CornellBox AD step launched a kernel of another path: {a_launches}")
    g3 = pt_mega.render_grad_diffuse_mega(ctx.view, a_opts, RES, RES, a_inst, a_adj, 0)
    torch.cuda.synchronize()
    a_scale, a_err = float(g3.abs().max()), float((a_grad - g3).abs().max())
    check(bool(torch.isfinite(a_grad).all()) and a_scale > 0.0
          and a_err <= AD_K3B_RTOL * a_scale,
          f"CornellBox AD gradient vs K3b: max err {a_err} vs max|g| {a_scale}")
    from torch.profiler import ProfilerActivity, profile
    with patched([(gather_mod, "gather_rows_bwd", bwd_recorder("cornell"))]):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ad_step(ctx.view, a_opts, RES, RES, a_inst)  # K2b's inputs for phase 6
            torch.cuda.synchronize()
    a_each = {}
    for kern, ms in device_records(prof):
        a_each.setdefault(kern, []).append(ms)
    a_busy = sum(sum(v) for v in a_each.values())
    # K2b's device time a launch inside the step (its kernels summed over its
    # launches), and K1b's
    a_in_step = {"gather_rows_bwd": sum(launches_named(a_each, "gather_bwd"))
                 / max(1, len(bwd_calls["cornell"])),
                 "trace_any": launches_named(a_each, "any_kernel")}
    del prof
    adr["cornell"] = dict(ms=a_best * 1e3, mrays=a_rays / a_best / 1e6, peak=a_peak,
                          launches=a_launches, busy_ms=a_busy, idle=1 - a_busy / (a_best * 1e3))
    log(f"[4f AD] CornellBox glossy {RES}x{RES} mpl={MPL} dense pass under autograd, MSE vs 0, "
        f"d/d diffuse (M, 3): {a_best * 1e3:.2f} ms/step, train {a_rays / a_best / 1e6:.3f} "
        f"Mrays/s ({a_rays:.0f} forward rays), peak memory {a_peak / 2 ** 30:.2f} GiB, on "
        f"{smi}; gradient vs K3b on the same instance ({a_inst}) and adjoint: max |g - K3b| "
        f"{a_err:.3g} = {a_err / a_scale:.2e} of max|g| {a_scale:.4g} (tolerance "
        f"{AD_K3B_RTOL:g}); launches in the step: "
        f"{ {n: c for n, c in a_launches.items() if c} }; one step under torch.profiler: device "
        f"busy {a_busy:.2f} ms (idle share {1 - a_busy / (a_best * 1e3):.3f}), K2b "
        f"{a_in_step['gather_rows_bwd'] * 1e3:.2f} us a launch, K1b "
        f"{sum(a_in_step['trace_any']) / max(1, len(a_in_step['trace_any'])) * 1e3:.2f} us a "
        "launch")
    del g3

    # the configuration of tests/golden/torch_port_grad_16.npz's "bigroom"
    # case on the card: jax.grad of the mean image of big_room(400), 16x16,
    # 4 bounces, tracer="frontier", with respect to the (M, 3) diffuse
    gg = np.load(ROOT / "tests" / "golden" / "torch_port_grad_16.npz")
    gbz = np.load(ROOT / "tests" / "golden" / "torch_port_bigroom_24.npz")
    ggview = SceneView.from_numpy({k[5:]: gbz[k] for k in gbz.files if k.startswith("view.")},
                                  dev)
    g_opts = pt.PTOptions(max_path_length=4, tracer="frontier",
                          lobes=tuple(bool(x) for x in gg["bigroom.lobes"]))
    leaf = ggview.mesh.materials.diffuse.stack().detach().clone().requires_grad_(True)
    gmats = ggview.mesh.materials._replace(diffuse=Vec3(leaf[:, 0], leaf[:, 1], leaf[:, 2]))
    g_loss = pt.render_pass(ggview._replace(mesh=ggview.mesh._replace(materials=gmats)), g_opts,
                            int(gg["res"]), int(gg["res"]), 0, int(gg["seed"]))
    g_loss = g_loss.composited.stack().mean()
    g_loss.backward()
    g_want = gg["bigroom.grad"]
    g_rel = float(np.abs(leaf.grad.cpu().numpy() - g_want).max() / np.abs(g_want).max())
    check(g_rel <= AD_GOLDEN_RTOL, f"big_room(400) AD gradient vs the jax.grad golden: {g_rel:.3g}"
                                   f" of max|g|, over {AD_GOLDEN_RTOL:g}")
    log(f"[4f AD] big_room(400) {int(gg['res'])}x{int(gg['res'])} mpl=4 tracer=frontier, d mean "
        f"image / d diffuse on the card vs the stored jax.grad golden: {g_rel:.3g} of max|g| "
        f"(tolerance {AD_GOLDEN_RTOL:g}); loss {float(g_loss):.8g} vs {float(gg['bigroom.loss']):.8g}")
    del ggview, leaf, gmats

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ad_step(bview, bopts, BIG_W, BIG_H, 1)  # warm-up
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    reset_counts()
    b_best, b_rays, (b_inst, b_grad, _), b_peak = timed_steps(bview, bopts, BIG_W, BIG_H, 2, 2)
    b_launches = counts()
    check(b_launches["gather_rows_bwd"] > 0 and b_launches["gather_rows"] > 0
          and all(b_launches[n] > 0 for n in large),
          f"the big_room AD step did not launch K2, K2b, K4 and K5: {b_launches}")
    check(all(b_launches[n] == 0 for n in ("trace_closest", "trace_any", *mega, *tracers,
                                           *subk)),
          f"the big_room AD step launched a kernel of another path: {b_launches}")
    check(bool(torch.isfinite(b_grad).all()) and float(b_grad.abs().max()) > 0.0,
          "big_room AD gradient is not finite or is zero")
    # the same step (instance, so adjoint) with K2b's plain version
    with patched([(gather_mod, "gather_rows_bwd", gather_mod._gather_bwd_plain)]):
        _, _, b_grad_p, _ = ad_step(bview, bopts, BIG_W, BIG_H, b_inst)
    b_scale = float(b_grad_p.abs().max())
    b_rel = float((b_grad - b_grad_p).abs().max()) / b_scale
    check(b_rel <= AD_PLAIN_RTOL, f"big_room AD gradient vs the step with K2b's plain version: "
                                  f"{b_rel:.3g} of max|g|, over {AD_PLAIN_RTOL:g}")
    del b_grad_p
    torch.cuda.empty_cache()
    with patched([(gather_mod, "gather_rows_bwd", bwd_recorder("big_room"))]):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ad_step(bview, bopts, BIG_W, BIG_H, 4)
            torch.cuda.synchronize()
    by_name = {}
    for kern, ms in device_records(prof):
        t, c = by_name.get(kern, (0.0, 0))
        by_name[kern] = (t + 1e3 * ms, c + 1)
    b_busy = sum(t for t, _ in by_name.values()) / 1e3
    b_kern = sum(c for _, c in by_name.values())
    b_top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    b_ms = b_best * 1e3
    adr["big_room"] = dict(ms=b_ms, mrays=b_rays / b_best / 1e6, peak=b_peak,
                           launches=b_launches, busy_ms=b_busy, kernels=b_kern,
                           idle=1 - b_busy / b_ms)
    per_step = {n: c / 2 for n, c in b_launches.items() if c}
    log(f"[4f AD] big_room({BIG_BOXES}) {BIG_W}x{BIG_H} mpl={MPL} frontier pass under "
        f"autograd, MSE vs 0, d/d diffuse ({b_grad.shape[0]}, 3): {b_ms:.2f} ms/step (best of "
        f"2; warm-up step {warm_s * 1e3:.0f} ms), train {b_rays / b_best / 1e6:.3f} Mrays/s "
        f"({b_rays:.0f} forward rays), peak memory {b_peak / 2 ** 30:.2f} GiB, on {smi}; "
        f"launches per step: {per_step} (K2b {per_step.get('gather_rows_bwd', 0):g}); "
        f"max|g| {float(b_grad.abs().max()):.4g}; vs the same step (instance {b_inst}) with "
        f"K2b's plain version: {b_rel:.3g} of max|g| (tolerance {AD_PLAIN_RTOL:g})")
    log(f"[4f AD] big_room: one step under torch.profiler: {b_kern} device kernels, device busy "
        f"{b_busy:.2f} ms of the {b_ms:.2f} ms step (idle share {1 - b_busy / b_ms:.3f}); top "
        "by device time: " + "; ".join(f"{n[:60]} {t / 1e3:.2f} ms x{c}"
                                        for n, (t, c) in b_top))
    del b_grad, prof
    torch.cuda.empty_cache()

    mark("4g")
    # ---- 4g. the light model: the lit CornellBox and big_room, their golden ----
    lit = lit_phase(dev, smi, reset_counts, counts)

    mark("4h")
    # ---- 4h. textures, their gradients and the blue-noise sampler ----
    tex = textured_phase(dev, smi, reset_counts, counts)

    mark("4i")
    # ---- 4i. the remaining PT options and the BVH walk ----
    opt = options_phase(dev, smi, reset_counts, counts, bview, dict(bctx.renderer_options))

    mark("4j")
    # ---- 4j. the bidirectional path tracer and PSSMLT ----
    bp = bpt_phase(dev, smi, reset_counts, counts, bview, tuple(bctx.renderer_options["lobes"]))

    mark("4k")
    # ---- 4k. the path-space-filtering and clustered-RL path tracers ----
    pf = psf_phase(dev, smi, reset_counts, counts, bview, tuple(bctx.renderer_options["lobes"]))

    mark("4l")
    # ---- 4l. path-space MLT and charted MLT ----
    ml = mlt_phase(dev, smi, reset_counts, counts, bview, tuple(bctx.renderer_options["lobes"]))

    mark("4m")
    # ---- 4m. the reuse path tracer and JAX's tracer names ----
    rm = rpt_phase(dev, smi, reset_counts, counts, bview, tuple(bctx.renderer_options["lobes"]))

    mark("4n")
    # ---- 4n. the command line ----
    cli = cli_phase(dev, smi)

    mark("4o")
    # ---- 4o. the last slice's modules ----
    sl = slice_phase(dev, smi, reset_counts, counts, bview, dict(bctx.renderer_options))

    mark("5")
    # ---- 5. parity on the card ----
    opts = pt.PTOptions(**ctx.renderer_options)
    out_k = pt.render_pass(ctx.view, opts, RES, RES, 1000, 0)
    before = {n: k.launches for n, k in kernels.items()}
    with patched(forced_plain(dev)):
        out_p = pt.render_pass(ctx.view, opts, RES, RES, 1000, 0)
    torch.cuda.synchronize()
    check(before == {n: k.launches for n, k in kernels.items()},
          "the forced plain pass launched a kernel")
    check(float(out_k.rays) == float(out_p.rays), "kernel vs plain pass: rays differ")
    diffs = [float((getattr(out_k, c).stack() - getattr(out_p, c).stack()).abs().max())
             for c in ("composited", "direct", "diffuse", "specular")]
    for c in ("composited", "direct", "diffuse", "specular"):
        ok, near, mean_rel = image_close(getattr(out_k, c).stack().cpu().numpy(),
                                         getattr(out_p, c).stack().cpu().numpy())
        check(ok, f"kernel vs plain pass: {c} differs ({near}, {mean_rel})")
    log(f"[5 parity] {RES}x{RES} pass, kernels vs plain versions: rays equal "
        f"({float(out_k.rays):.0f}), max |image diff| {max(diffs):.3g}")

    gz = np.load(ROOT / "tests" / "golden" / "torch_port_cornell_32.npz")
    gview = SceneView.from_numpy({k[5:]: gz[k] for k in gz.files if k.startswith("view.")}, dev)
    gres = int(gz["res"])
    gopts = pt.PTOptions(max_path_length=int(gz["max_path_length"]),
                         lobes=tuple(bool(x) for x in gz["lobes"]),
                         clearcoat=bool(gz["clearcoat"]))
    gout = pt.render_pass(gview, gopts, gres, gres, int(gz["instance"]), int(gz["seed"]))
    grays = float(gout.rays)
    check(abs(grays - float(gz["rays"])) <= 0.005 * float(gz["rays"]),
          f"golden: rays {grays} vs JAX {float(gz['rays'])}")
    report = []
    for c in ("composited", "direct", "diffuse", "specular"):
        ok, near, mean_rel = image_close(getattr(gout, c).stack().cpu().numpy(),
                                         gz[c].reshape(-1, 3))
        check(ok, f"golden {c}: {near:.4f} of pixels close, mean rel {mean_rel:.2e}")
        report.append(f"{c} {near:.4f}/{mean_rel:.1e}")
    log(f"[5 parity] golden {gres}x{gres} mpl={int(gz['max_path_length'])} vs the JAX CPU "
        f"image: rays {grays:.0f} vs {float(gz['rays']):.0f}; pixels close/mean rel: "
        + ", ".join(report))

    mark("5b")
    # ---- 5b. megakernel parity: 512x512 against the plain version; JAX golden ----
    m_opts, m_tb = t_opts, t_tb  # the mega pass's options and tables
    n_full = RES * RES
    out_k = pt_mega._mega_forward(m_tb, m_opts, RES, n_full, 1000, 0)
    out_p = pt_mega._mega_plain(m_tb, m_opts, RES, n_full, 1000, 0)
    torch.cuda.synchronize()
    check(float(out_k[26].sum()) == float(out_p[26].sum()), "mega 512: rays differ from plain")
    report = []
    for c0, cname in ((0, "direct"), (3, "diffuse"), (6, "specular")):
        ok, near, mean_rel = lanes_close(out_k[c0:c0 + 3], out_p[c0:c0 + 3])
        check(ok, f"mega 512 vs plain: {cname} differs ({near}, {mean_rel})")
        report.append(f"{cname} {near:.4f}/{mean_rel:.1e}")
    ok, near, mean_rel = lanes_close(out_k[0:3] + out_k[3:6] + out_k[6:9],
                                     out_p[0:3] + out_p[3:6] + out_p[6:9])
    check(ok, "mega 512 vs plain: composited differs")
    # the kernels line reports the errors at the main path's shapes (3b's at
    # 128x128 are in its log lines)
    max_err["mega_forward"] = float((out_k[:9] - out_p[:9]).abs().max())
    log(f"[5b parity] mega_forward {RES}x{RES} mpl={MPL} vs _mega_plain: rays equal "
        f"({float(out_k[26].sum()):.0f}); pixels close/mean rel: composited {near:.4f}/"
        f"{mean_rel:.1e}, " + ", ".join(report) + "; bit-equal pixels "
        f"{float((bits(out_k) == bits(out_p)).all(dim=0).float().mean()):.4f}; max |radiance "
        f"diff| {max_err['mega_forward']:.3g}")
    del out_k, out_p
    g = pt_mega._mega_grad(t_tb, t_opts, RES, n_full, t_inst, 0, t_adj)
    g_again = pt_mega._mega_grad(t_tb, t_opts, RES, n_full, t_inst, 0, t_adj)
    g_ref = pt_mega._mega_grad_plain(t_tb, t_opts, RES, n_full, t_inst, 0, t_adj)
    torch.cuda.synchronize()
    scale, err = float(g_ref.abs().max()), float((g - g_ref).abs().max())
    check(scale > 0.0 and err <= 1e-3 * scale,
          f"mega_grad {RES}x{RES}: max err {err} vs max|g| {scale}")
    check(torch.equal(bits(g), bits(g_again)), f"mega_grad {RES}x{RES}: two launches differ")
    max_err["mega_grad"] = err
    log(f"[5b parity] mega_grad {RES}x{RES} mpl={MPL} on the train step's adjoint (instance "
        f"{t_inst}, MSE vs 0) vs _mega_grad_plain: max |g - plain| {err:.3g} = "
        f"{err / scale:.2e} of max|g| {scale:.4g}; two launches bit-equal")

    gm = np.load(ROOT / "tests" / "golden" / "torch_port_mega_32.npz")
    mres, mseed = int(gm["res"]), int(gm["seed"])
    report = []
    gm_glass = SceneView.build(glass_cornell_box(), cornell_camera(), dev)
    for cfg in ("A", "B", "C", "D"):  # D renders glass_cornell_box
        c_opts = pt.PTOptions(tracer="mega", max_path_length=int(gm[f"{cfg}.max_path_length"]),
                              lobes=tuple(bool(x) for x in gm[f"{cfg}.lobes"]),
                              clearcoat=bool(gm[f"{cfg}.clearcoat"]))
        c_out = pt.render_pass(gm_glass if cfg == "D" else gview, c_opts, mres, mres,
                               int(gm[f"{cfg}.instance"]), mseed)
        c_rays, want = float(c_out.rays), float(gm[f"{cfg}.rays"])
        check(abs(c_rays - want) <= 0.005 * want, f"mega golden {cfg}: rays {c_rays} vs {want}")
        worst = 1.0
        for c in ("composited", "direct", "diffuse", "specular"):
            ok, near, mean_rel = image_close(getattr(c_out, c).stack().cpu().numpy(),
                                             gm[f"{cfg}.{c}"].reshape(-1, 3))
            check(ok, f"mega golden {cfg} {c}: {near:.4f} close, mean rel {mean_rel:.2e}")
            worst = min(worst, near)
        for key in ("tri", "material"):
            eq = float((getattr(c_out, key).cpu().numpy() == gm[f"{cfg}.{key}"].ravel()).mean())
            check(eq >= 0.999, f"mega golden {cfg}: {key} equal on {eq}")
        report.append(f"{cfg} rays {c_rays:.0f}/{want:.0f} pixels close >= {worst:.4f}")
    for cfg in ("A", "D"):  # D: glass_cornell_box without the coat (K3b gates it out)
        g_opts = pt.PTOptions(tracer="mega", max_path_length=int(gm[f"{cfg}.max_path_length"]),
                              lobes=tuple(bool(x) for x in gm[f"{cfg}.lobes"]),
                              clearcoat=bool(gm[f"grad.{cfg}.clearcoat"]))
        g_card = pt_mega.render_grad_diffuse_mega(
            gm_glass if cfg == "D" else gview, g_opts, mres, mres, int(gm[f"{cfg}.instance"]),
            torch.from_numpy(gm[f"grad.{cfg}.adjoint"]).to(dev), mseed).cpu().numpy()
        want = gm[f"grad.{cfg}"]
        g_err = float(np.abs(g_card - want).max() / np.abs(want).max())
        check(g_err <= 1e-3, f"mega golden: gradient {cfg} off by {g_err} of max|g|")
        report.append(f"gradient {cfg} within {g_err:.2e} of max|g|")
    log(f"[5b parity] JAX megakernel golden {mres}x{mres} on the card: " + "; ".join(report))

    mark("5c")
    # ---- 5c. large-scene parity: the JAX golden; kernels vs forced plain ----
    gb = np.load(ROOT / "tests" / "golden" / "torch_port_bigroom_24.npz")
    gbview = SceneView.from_numpy({k[5:]: gb[k] for k in gb.files if k.startswith("view.")},
                                  dev)
    check(gbview.clusters is not None, "big_room golden view has no cluster table")
    gbres = int(gb["res"])
    gbopts = pt.PTOptions(max_path_length=int(gb["max_path_length"]),
                          lobes=tuple(bool(x) for x in gb["lobes"]))
    before = {n: k.launches for n, k in kernels.items()}
    gbout = pt.render_pass(gbview, gbopts, gbres, gbres, int(gb["instance"]), int(gb["seed"]))
    check(all(kernels[n].launches > before[n] for n in large),
          "the golden big_room pass did not launch the large-scene kernels")
    gb_rays = float(gbout.rays)
    check(abs(gb_rays - float(gb["rays"])) <= 0.005 * float(gb["rays"]),
          f"big_room golden: rays {gb_rays} vs JAX {float(gb['rays'])}")
    report = []
    for c in ("composited", "direct", "diffuse", "specular"):
        ok, near, mean_rel = image_close(getattr(gbout, c).stack().cpu().numpy(),
                                         gb[c].reshape(-1, 3))
        check(ok, f"big_room golden {c}: {near:.4f} of pixels close, mean rel {mean_rel:.2e}")
        report.append(f"{c} {near:.4f}/{mean_rel:.1e}")
    tri_eq = float((gbout.tri.cpu().numpy() == gb["tri"].ravel()).mean())
    check(tri_eq >= 0.99, f"big_room golden: first-hit triangle equal on {tri_eq}")
    log(f"[5c large] big_room({int(gb['n_boxes'])}) golden {gbres}x{gbres} "
        f"mpl={int(gb['max_path_length'])} (JAX render_pass, tracer='frontier', CPU) on the "
        f"card: rays {gb_rays:.0f} vs {float(gb['rays']):.0f}; first-hit triangle equal "
        f"{tri_eq:.4f}; pixels close/mean rel: " + ", ".join(report))
    gc = np.load(ROOT / "tests" / "golden" / "torch_port_bigroom_cluster_24.npz")
    check(int(gc["n_boxes"]) == int(gb["n_boxes"]) and int(gc["res"]) == gbres,
          "the cluster/binned golden is not of the big_room golden's view")
    for tracer in ("cluster", "binned"):
        before = counts()
        gcout = pt.render_pass(gbview, gbopts._replace(tracer=tracer), gbres, gbres,
                               int(gc["instance"]), int(gc["seed"]))
        mine = [n for n in tracers if n.endswith(tracer)]
        check(all(kernels[n].launches > before[n] for n in mine)
              and ft.CLOSEST.launches == before["trace_closest_frontier"],
              f"the golden big_room pass with tracer={tracer} did not launch its kernels only")
        gc_rays, want = float(gcout.rays), float(gc[f"{tracer}.rays"])
        check(abs(gc_rays - want) <= 0.005 * want,
              f"big_room {tracer} golden: rays {gc_rays} vs JAX {want}")
        report = []
        for c in ("composited", "direct", "diffuse", "specular"):
            ok, near, mean_rel = image_close(getattr(gcout, c).stack().cpu().numpy(),
                                             gc[f"{tracer}.{c}"].reshape(-1, 3))
            check(ok, f"big_room {tracer} golden {c}: {near:.4f} close, mean rel {mean_rel:.2e}")
            report.append(f"{c} {near:.4f}/{mean_rel:.1e}")
        tri_eq = float((gcout.tri.cpu().numpy() == gc[f"{tracer}.tri"].ravel()).mean())
        check(tri_eq >= 0.99, f"big_room {tracer} golden: first-hit triangle equal on {tri_eq}")
        log(f"[5c large] big_room({int(gc['n_boxes'])}) golden {gbres}x{gbres} (JAX render_pass, "
            f"tracer='{tracer}', CPU) on the card with tracer={tracer}: rays {gc_rays:.0f} vs "
            f"{want:.0f}; first-hit triangle equal {tri_eq:.4f}; pixels close/mean rel: "
            + ", ".join(report))

    t0 = time.perf_counter()
    out_k = pt.render_pass(bview, bopts, PLAIN_W, PLAIN_H, 1000, 0)
    before = {n: k.launches for n, k in kernels.items()}
    with patched(forced_plain(dev)):
        out_p = pt.render_pass(bview, bopts, PLAIN_W, PLAIN_H, 1000, 0)
    torch.cuda.synchronize()
    check(before == {n: k.launches for n, k in kernels.items()},
          "the forced plain big_room pass launched a kernel")
    check(float(out_k.rays) == float(out_p.rays), "big_room kernel vs plain pass: rays differ")
    diffs = []
    for c in ("composited", "direct", "diffuse", "specular"):
        a, b = getattr(out_k, c).stack(), getattr(out_p, c).stack()
        ok, near, mean_rel = image_close(a.cpu().numpy(), b.cpu().numpy())
        check(ok, f"big_room kernel vs plain pass: {c} differs ({near}, {mean_rel})")
        diffs.append(float((a - b).abs().max()))
    check(torch.equal(out_k.tri, out_p.tri), "big_room kernel vs plain pass: first hits differ")
    log(f"[5c large] big_room({BIG_BOXES}) {PLAIN_W}x{PLAIN_H} mpl={MPL} pass, kernels vs "
        f"plain versions: rays equal ({float(out_k.rays):.0f}), first hits equal, max |image "
        f"diff| {max(diffs):.3g} ({time.perf_counter() - t0:.1f} s for both passes)")
    del out_k, out_p

    mark("6")
    # ---- 6. per-launch timing at the main path's inputs ----
    calls = {n: [] for n in kernels}

    def recorder(name, fn):
        def wrapper(*args):
            calls[name].append(args)
            return fn(*args)
        return wrapper

    with patched([(pt, "trace_closest", recorder("trace_closest", pt.trace_closest)),
                  (pt, "trace_any", recorder("trace_any", pt.trace_any)),
                  (mesh_mod, "gather_rows", recorder("gather_rows", mesh_mod.gather_rows)),
                  (lights_mod, "gather_rows", recorder("gather_rows", lights_mod.gather_rows))]):
        pt.render_pass(ctx.view, opts, RES, RES, 2000, 0)
    torch.cuda.synchronize()

    rows = []
    for kname, kern in dense.items():
        plain_ms = lib_ms = bound = 0.0
        by_bytes = by_ops = 0.0
        times = {}
        shapes = set()
        each, alive = [], []  # K1a: each launch's ms and active lanes
        for args in calls[kname]:
            if kname == "gather_rows":
                table, idx = args
                n, (r, k) = idx.shape[0], table.shape
                byt, ops = n * 4 + r * k * 4 + n * k * 4, 0.0
                f_k = lambda: gather_mod.gather_rows(table, idx)
                f_p = lambda: gather_mod._gather_plain(table, idx)
                idx64 = idx.long()
                f_l = lambda: table.index_select(0, idx64)
                shapes.add(f"table {r}x{k}, {n} idx")
            else:
                tris, o, d, tmin, tmax, active = args
                n, t = o.x.shape[0], tris.shape[1]
                act = active if active is not None else torch.ones(n, dtype=torch.bool,
                                                                   device=dev)
                tmin_l, tmax_l = lanes(tmin, n), lanes(tmax, n)
                # bytes: every lane's flag in and result out (K1a's miss
                # also reads tmax), the rays and the rest of tmin/tmax of
                # the active lanes only, the soup once
                n_act = float(act.sum())
                if kname == "trace_closest":
                    byt = n * (1 + 4 + 16) + n_act * (24 + 4) + 36 * t
                    ops = n_act * t * FLOPS_PER_TEST
                    f_k = lambda: trace_mod.trace_closest(tris, o, d, tmin, tmax, active)
                    f_p = lambda: trace_mod._closest_plain(tris, o, d, tmin_l, tmax_l, act)
                else:
                    byt = n * (1 + 1) + n_act * (24 + 8) + 36 * t
                    ops = first_hit_tests(tris, o, d, tmax_l, act) * FLOPS_PER_TEST
                    f_k = lambda: trace_mod.trace_any(tris, o, d, tmin, tmax, active)
                    f_p = lambda: trace_mod._any_plain(tris, o, d, tmin_l, tmax_l, act)
                f_l = None
                shapes.add(f"{n} rays x {t} tris")
            got, want = f_k(), f_p()
            torch.cuda.synchronize()
            if kname == "trace_closest":
                pairs = [(got.tri, want.tri)] + [(bits(a), bits(b)) for a, b in (
                    (got.t, want.t), (got.u, want.u), (got.v, want.v))]
            else:
                pairs = [(bits(got), bits(want)) if kname == "gather_rows" else (got, want)]
            check(all(torch.equal(a, b) for a, b in pairs),
                  f"{kname} at the main pass's inputs ({sorted(shapes)}): differs from its plain "
                  "version")
            del got, want, pairs
            tk = device_ms(f_k)
            add_times(times, tk)
            if kname == "trace_closest":
                each.append(tk["ms"])
                alive.append(int(act.sum()))
            plain_ms += device_ms(f_p, reps=5, cold=False)["ms"]
            if f_l is not None:
                lib_ms += device_ms(f_l, cold=False)["ms"]
            b_bytes, b_ops = byt / bw * 1e3, ops / fp32 * 1e3
            bound += max(b_bytes, b_ops)
            by_bytes += b_bytes
            by_ops += b_ops
        nc = len(calls[kname])
        check(nc > 0, f"{kname}: no launch captured in the timing pass")
        err = max_err[kname]
        t = per_launch(times, nc)
        rows.append({
            "name": kname, "route": "cuda",
            "source": f"fermat_tpu_torch/ops/csrc/{kern.source}",
            "replaces": kern.replaces,
            "launches": launches[kname],
            "launches_per_pass": launches[kname] / n_main,
            "max_abs_err": err, "max_abs_err_vs_plain": err,
            **t, "plain_ms": plain_ms / nc, "bound_ms": bound / nc,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": (lib_ms / nc) if kname == "gather_rows" else None,
            "shapes": sorted(shapes),
            "in_pass_ms": sum(d_in_pass[kname]) / len(d_in_pass[kname]),
        })
        if each:
            rows[-1].update(ms_each_launch=each, active_lanes_each_launch=alive)
        log(f"[6 timing] {kname}: {fmt_times(t)}/launch, "
            f"{rows[-1]['in_pass_ms'] * 1e3:.2f} us inside phase 4's profiled pass (plain "
            f"{plain_ms / nc * 1e3:.1f} us, bound {bound / nc * 1e3:.2f} us by "
            f"{rows[-1]['bound_by']}) over the {nc} launches of one pass, each equal to its "
            f"plain version; {sorted(shapes)}"
            + ("; each launch (us, active lanes): " + ", ".join(
                f"{m * 1e3:.2f} ({a})" for m, a in zip(each, alive)) if each else ""))

    # the megakernels at the main path's inputs; the bound counts what this
    # pass's paths need (MEGA_FLOPS per event, the events counted from the
    # plain version's pass, whose rays equal the kernel's): every closest ray
    # tests all triangles, every shadow ray up to its first hit, and each
    # vertex, NEE sample, scatter and K3b term its shading arithmetic. The
    # tracing-only count, the bound before the shading was counted, is
    # reported beside it as a lower bound.
    inst_t = t_inst
    events = mega_events(m_tb, m_opts, RES, n_full, inst_t)
    torch.cuda.synchronize()
    m_ops = mega_ops(events, n_full, m_tb.n_mats, m_opts)
    table_bytes = 4 * sum(t.numel() for t in (m_tb.tri, m_tb.mat, m_tb.light, m_tb.cam))
    blocks = -(-n_full // pt_mega.BLOCK)
    for kname, f_k, f_p, byt, ops, n_launch, per in (
            ("mega_forward", lambda: pt_mega._mega_forward(m_tb, m_opts, RES, n_full, inst_t, 0),
             lambda: pt_mega._mega_plain(m_tb, m_opts, RES, n_full, inst_t, 0),
             pt_mega.N_OUT * n_full * 4 + table_bytes, m_ops["forward"],
             m_launches["mega_forward"], n_main),
            ("mega_grad", lambda: pt_mega._mega_grad(m_tb, m_opts, RES, n_full, inst_t, 0, t_adj),
             lambda: pt_mega._mega_grad_plain(m_tb, m_opts, RES, n_full, inst_t, 0, t_adj),
             n_full * 12 + blocks * m_tb.n_mats * 12 + table_bytes, m_ops["grad"],
             t_launches["mega_grad"], REPS)):
        t = per_launch(device_ms(f_k), 1)
        plain_ms = profiled(f_p)[1]
        b_bytes, b_ops = byt / bw * 1e3, ops / fp32 * 1e3
        tests_ms = m_ops["tests"] / fp32 * 1e3
        no_pwl_ms = (ops - m_ops["pwl"]) / fp32 * 1e3
        kern = mega[kname]
        # its device time in phase 4b's profiled pass, where a capture held it
        if kname == "mega_forward" and in_pass["mega_forward"]:
            t["in_pass_ms"] = sum(in_pass["mega_forward"]) / len(in_pass["mega_forward"])
        rows.append({
            "name": kname, "route": "cuda",
            "source": f"fermat_tpu_torch/ops/csrc/{kern.source}",
            "replaces": kern.replaces,
            "launches": n_launch,
            ("launches_per_pass" if kname == "mega_forward" else "launches_per_step"):
                n_launch / per,
            "max_abs_err": max_err[kname], "max_abs_err_vs_plain": max_err[kname],
            **t, "plain_ms": plain_ms, "bound_ms": max(b_bytes, b_ops),
            "bound_by": "bytes" if b_bytes >= b_ops else "operations",
            "library_ms": None,
            "shapes": [f"{RES}x{RES} pixels, mpl {MPL}, {m_tb.n_tris} tris, "
                       f"{sum(e[2] for e in events):.0f} closest + "
                       f"{sum(e[5] for e in events):.0f} shadow tests, {m_ops['hits']:.0f} "
                       f"vertices, {m_ops['lit']:.0f} lit NEE samples"],
        })
        log(f"[6 timing] {kname}: {fmt_times(t)}/launch"
            + (f", {t['in_pass_ms'] * 1e3:.2f} us inside the profiled pass"
               if "in_pass_ms" in t else "") + f" (plain {plain_ms * 1e3:.1f} us, "
            f"bound {max(b_bytes, b_ops) * 1e3:.2f} us by {rows[-1]['bound_by']}: "
            f"{byt / 1e6:.2f} MB, {ops / 1e9:.4f} GFLOP, of which ray-triangle tests "
            f"{m_ops['tests'] / 1e9:.4f} (alone {tests_ms * 1e3:.2f} us), of which E(|w.z|) "
            f"32-knot sums {m_ops['pwl'] / 1e9:.4f} (without them {no_pwl_ms * 1e3:.2f} us); "
            f"per vertex b "
            f"(alive, hits, closest tests, shadow rays, occluded, shadow tests): "
            f"{[tuple(int(x) for x in e) for e in events]}) at {RES}x{RES}, "
            f"{n_launch / per:g} launch per {'pass' if kname == 'mega_forward' else 'step'}")

    # the large-scene kernels at the big_room main path's inputs (one
    # monolithic 1600x896 pass, every launch replayed): each launch's kernel
    # output is held to its plain version's (t bit-equal and tri equal, occ
    # equal, K4 rows bit-equal), and the kernels line's max_abs_err comes
    # from these comparisons. Bounds: K4 bytes (u in, the rows out, the table
    # once); K5 the larger of bytes (rays in, hits out, the cluster rows once)
    # and the tests any exact cluster-leaf tracer must do, 46 flops each: a
    # closest ray tests every real triangle of every cluster whose box entry
    # lies before its final hit, an unoccluded shadow ray every real triangle
    # of every cluster it enters, an occluded one at least the one triangle
    # that stops it (counted from the plain side's entries and hits)
    lcalls = {n: [] for n in (*large, "gather_rows")}

    def lrecorder(name, fn):
        def wrapper(*args, **kw):
            lcalls[name].append(args)
            return fn(*args, **kw)
        return wrapper

    with patched([(pt, n, lrecorder(n, getattr(pt, n))) for n in large]
                 + [(m, "gather_rows", lrecorder("gather_rows", m.gather_rows))
                    for m in (mesh_mod, lights_mod)]):
        pt.render_pass(bview, bopts, BIG_W, BIG_H, 2000, 0)
    torch.cuda.synchronize()

    def needed_tests(cl, o, d, tmin, tmax, active, t_final, occluded=None):
        """(ray-triangle tests, cluster entries) the active rays need (see
        above), summed."""
        tests = entries = 0.0
        cnt = torch.zeros(cl.lo_x.shape[1], dtype=torch.float32, device=dev)
        cnt[:cl.count.shape[0]] = cl.count.float()
        for sl in ft._chunks(o.x.shape[0], cl.lo_x.shape[1]):
            e = ft.cluster_entries(cl, Vec3(*(c[sl] for c in o)), Vec3(*(c[sl] for c in d)),
                                   tmin[sl], tmax[sl])
            enter = (e < t_final[sl][:, None]) if occluded is None else torch.isfinite(e)
            n_tri = enter.float() @ cnt
            n_cl = enter.sum(1).float()
            if occluded is not None:
                n_tri = torch.where(occluded[sl], 1.0, n_tri)
                n_cl = torch.where(occluded[sl], 1.0, n_cl)
            tests += float(n_tri[active[sl]].sum())
            entries += float(n_cl[active[sl]].sum())
        return tests, entries

    table_bytes = 4 * (cl_room.rows.numel() + cl_room.count.numel() + cl_room.node_box.numel()
                       + cl_room.node_ref.numel() + 6 * cl_room.lo_x.shape[1])
    # per launch of K5: the plain answer, its time and the bound, which K6
    # and K7 reuse below on the same rays
    k5_plain = {"trace_closest_frontier": [], "trace_any_frontier": []}
    for kname in large:
        kern = large[kname]
        plain_ms = bound = by_bytes = by_ops = err = 0.0
        visits = n_tests = 0.0
        times, wrapper, sort, each = {}, {}, {}, []
        shapes = set()
        for args in lcalls[kname]:
            if kname == "cdf_pick_rows":
                rows_t, cdf_t, u_t = args
                n, (r, k) = u_t.shape[0], rows_t.shape
                byt, ops = 4 * n + 4 * n * k + 4 * r * k + 4 * r, 0.0
                f_k = lambda: cdf_gather.cdf_pick_rows(rows_t, cdf_t, u_t)
                f_p = lambda: cdf_gather._pick_plain(rows_t, cdf_t, u_t)
                got, want = f_k(), f_p()
                p_ms = profiled(f_p)[1]
                torch.cuda.synchronize()
                check(torch.equal(bits(got), bits(want)),
                      "cdf_pick_rows at the big_room pass's inputs: not bit-equal to plain")
                err = max(err, float((got - want).abs().max()))
                shapes.add(f"rows {r}x{k}, {n} u")
            else:
                cl, o, d, tmin, tmax, active = args
                n = o.x.shape[0]
                tmin_l, tmax_l = lanes(tmin, n), lanes(tmax, n)
                if kname == "trace_closest_frontier":
                    f_k = lambda: ft.trace_closest_frontier(cl, o, d, tmin, tmax, active,
                                                            with_uv=False)
                    f_p = lambda: ft._closest_plain(cl, o, d, tmin_l, tmax_l, active)
                    (t_fin, tri_fin), p_ms = profiled(f_p)
                    hit = f_k()
                    torch.cuda.synchronize()
                    check(torch.equal(hit.tri, tri_fin) and torch.equal(bits(hit.t), bits(t_fin)),
                          "trace_closest_frontier at the big_room pass's inputs: t or tri "
                          "differs from plain")
                    err = max(err, float((hit.t - t_fin).abs().max()))
                    need, ent = needed_tests(cl, o, d, tmin_l, tmax_l, active, t_fin)
                    byt = n * (33 + 8) + table_bytes
                else:
                    f_k = lambda: ft.trace_any_frontier(cl, o, d, tmin, tmax, active)
                    f_p = lambda: ft._any_plain(cl, o, d, tmin_l, tmax_l, active)
                    occ_p, p_ms = profiled(f_p)
                    occ_k = f_k()
                    torch.cuda.synchronize()
                    check(torch.equal(occ_k, occ_p),
                          "trace_any_frontier at the big_room pass's inputs: occ differs "
                          "from plain")
                    err = max(err, float((occ_k != occ_p).sum()))
                    need, ent = needed_tests(cl, o, d, tmin_l, tmax_l, active, None, occ_p)
                    byt = n * (33 + 1) + table_bytes
                visits += ent
                n_tests += need
                ops = need * FLOPS_PER_TEST
                shapes.add(f"{n} rays x {int((cl.count > 0).sum())} clusters")
                # the kernel alone (its inputs, the co-sort's permutation
                # included, made once), the co-sort (the key kernel, held to
                # its plain version, and the argsort), and the whole wrapper
                rays_k = ft._ray_args(o, d, tmin_l, tmax_l, active)
                check(torch.equal(ft._key(cl, rays_k),
                                  ft._sort_key_plain(cl, o, d, tmin_l, tmax_l, active)),
                      f"{kname} at the big_room pass's inputs: the sort key differs from plain")
                args_k = ft._launch_args(cl, o, d, tmin_l, tmax_l, active)
                outs = ([torch.empty(n, device=dev), torch.empty(n, dtype=torch.int32, device=dev)]
                        if kname == "trace_closest_frontier"
                        else [torch.empty(n, dtype=torch.bool, device=dev)])
                add_times(wrapper, device_ms(f_k, cold=False))
                add_times(sort, device_ms(
                    lambda: torch.argsort(ft._key(cl, rays_k), stable=True), cold=False))
                f_k = (lambda: kern.launch(dev, *ft._ptrs(args_k), *(x.data_ptr() for x in outs)))
                k5_plain[kname].append(dict(
                    want=(t_fin, tri_fin) if kname == "trace_closest_frontier" else occ_p,
                    plain_ms=p_ms, need=need, ent=ent, b_bytes=byt / bw * 1e3,
                    b_ops=ops / fp32 * 1e3))
            tk = device_ms(f_k)
            add_times(times, tk)
            each.append(tk["ms"])
            plain_ms += p_ms
            b_bytes, b_ops = byt / bw * 1e3, ops / fp32 * 1e3
            bound += max(b_bytes, b_ops)
            by_bytes += b_bytes
            by_ops += b_ops
        nc = len(lcalls[kname])
        check(nc > 0, f"{kname}: no launch captured in the timing pass")
        max_err[kname] = err
        t = per_launch(times, nc)
        row = {
            "name": kname, "route": "cuda",
            "source": f"fermat_tpu_torch/ops/csrc/{kern.source}",
            "replaces": kern.replaces,
            "launches": big["monolithic"]["launches"][kname],
            "launches_per_pass": big["monolithic"]["launches"][kname] / n_big,
            "max_abs_err": err, "max_abs_err_vs_plain": err,
            **t, "plain_ms": plain_ms / nc, "bound_ms": bound / nc,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": None,
            "shapes": sorted(shapes),
            "ms_each_launch": each,
        }
        if kname != "cdf_pick_rows":
            inside = in_pass[kname]
            row.update(clusters_needed_per_launch=visits / nc, tests_needed_per_launch=n_tests / nc,
                       in_pass_ms=sum(inside) / len(inside), in_pass_ms_each_launch=inside,
                       wrapper_ms=wrapper["ms"] / nc, sort_ms=sort["ms"] / nc)
        rows.append(row)
        log(f"[6 timing] {kname}: {fmt_times(t)}/launch"
            + (f", in the profiled pass {row['in_pass_ms'] * 1e3:.1f} us; with the co-sort "
               f"(key and argsort {row['sort_ms'] * 1e3:.1f} us) the wrapper "
               f"{row['wrapper_ms'] * 1e3:.1f} us; each launch "
               + ", ".join(f"{x:.3f}" for x in each) + " ms, in the pass "
               + ", ".join(f"{x:.3f}" for x in inside) + " ms" if kname != "cdf_pick_rows" else "")
            + f" (plain {plain_ms / nc * 1e3:.1f} "
            f"us, bound {bound / nc * 1e3:.2f} us by {row['bound_by']}"
            + (f", {visits / nc:.0f} cluster entries and {n_tests / nc:.0f} ray-triangle tests "
               f"needed per launch" if visits else "")
            + f") over the {nc} launches of one big_room pass, each equal to its plain "
            f"version (max abs err {err:.3g}); {sorted(shapes)}")

    # K2 at the launches of the same big_room pass: each held bit-equal to its
    # plain version and timed with it and index_select; bound: bytes (idx and
    # the table once in, the rows out), in brackets beside the CornellBox's
    a = dict(plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    times, each, shapes = {}, [], set()
    for table, idx in lcalls["gather_rows"]:
        n, (r, k) = idx.shape[0], table.shape
        idx64 = idx.long()
        f_k = lambda: gather_mod.gather_rows(table, idx)
        f_p = lambda: gather_mod._gather_plain(table, idx)
        got, want = f_k(), f_p()
        torch.cuda.synchronize()
        check(torch.equal(bits(got), bits(want)),
              f"gather_rows at the big_room pass's inputs ({r}x{k}): not bit-equal to plain")
        del got, want
        tk = device_ms(f_k)
        add_times(times, tk)
        each.append(tk["ms"])
        a["plain_ms"] += device_ms(f_p, reps=5, cold=False)["ms"]
        a["library_ms"] += device_ms(lambda: table.index_select(0, idx64), cold=False)["ms"]
        a["bound_ms"] += (n * 4 + r * k * 4 + n * k * 4) / bw * 1e3
        shapes.add(f"table {r}x{k}, {n} idx")
    nc = len(lcalls["gather_rows"])
    check(nc > 0, "gather_rows: no launch captured in the big_room timing pass")
    t = per_launch(times, nc)
    big_k2 = {"launches": big["monolithic"]["launches"]["gather_rows"],
              "launches_per_pass": big["monolithic"]["launches"]["gather_rows"] / n_big,
              **{k: t[k] for k in ("ms", "ms_min", "ms_max", "cold_ms")},
              **{k: v / nc for k, v in a.items()}, "ms_each_launch": each,
              "shapes": sorted(shapes)}
    next(r for r in rows if r["name"] == "gather_rows")["at_big_room"] = big_k2
    log(f"[6 timing] gather_rows at the big_room pass: {fmt_times(t)}/launch (plain "
        f"{big_k2['plain_ms'] * 1e3:.1f} us, index_select {big_k2['library_ms'] * 1e3:.1f} us, "
        f"bound {big_k2['bound_ms'] * 1e3:.2f} us by bytes) over the {nc} launches of one "
        f"big_room pass, each bit-equal to its plain version; each launch "
        + ", ".join(f"{m * 1e3:.2f}" for m in each) + f" us; {sorted(shapes)}")
    del lcalls["gather_rows"]

    # K6 and K7 at the inputs of one phase 4e pass (tracer="cluster", the
    # instance above; the binned pass traces the same rays, its images being
    # bit-equal). Their active rays are checked bit-equal to the frontier
    # pass's recorded above (the three tracers compute one function, and the
    # kernels' u, v equal the row fetch's), so every launch of each tracer
    # is held to the plain answer K5 was held to there, and so to K5, and
    # the bound is that launch's: equal for K5, K6 and K7. The plain time
    # of K6a/K7a adds the winner's u, v (_recompute_uv) to K5a's
    tcalls = {"closest": [], "any": []}

    def trecorder(kind, fn):
        def wrapper(*args, **kw):
            tcalls[kind].append(args)
            return fn(*args, **kw)
        return wrapper

    with patched([(pt, "trace_closest_cluster", trecorder("closest", pt.trace_closest_cluster)),
                  (pt, "trace_any_cluster", trecorder("any", pt.trace_any_cluster))]):
        pt.render_pass(cview, copts, BIG_W, BIG_H, 2000, 0)
    torch.cuda.synchronize()

    def same_rays(args, args5) -> bool:
        """Equal active masks, and equal rays (o, d, tmin, tmax) on the
        active lanes. An inactive lane is never traced, and the routes
        leave different values there: on a miss the frontier route takes
        u, v from the ray, K6/K7 return 0, and the dead lane's next origin
        follows."""
        act, act5 = args[5], args5[5]
        if not torch.equal(act, act5):
            return False
        for x, y in zip(args[1:5], args5[1:5]):
            for p, q in zip(*((list(v) if isinstance(v, Vec3) else [v]) for v in (x, y))):
                if isinstance(p, torch.Tensor):
                    if not torch.equal(bits(p[act]), bits(q[act])):
                        return False
                elif p != q:
                    return False
        return True

    acc = {n: dict(times={}, plain_ms=0.0, bound=0.0, by_bytes=0.0, by_ops=0.0, err=0.0,
                   wall_ms=0.0, rounds=0, loop=dict(rounds=0, readbacks=0, scans=0, pairs=0),
                   split=dict(scan=0.0, bin=0.0, test=0.0, other=0.0))
           for n in tracers}
    fns = {"cluster": (ct.trace_closest_cluster, ct.trace_any_cluster),
           "binned": (bt.trace_closest_binned, bt.trace_any_binned)}
    t_visits = {"closest": 0.0, "any": 0.0}
    t_tests = {"closest": 0.0, "any": 0.0}
    for kind in ("closest", "any"):
        k5_name = f"trace_{kind}_frontier"
        check(len(tcalls[kind]) == len(lcalls[k5_name]) == MPL,
              f"{kind}: {len(tcalls[kind])} cluster-tracer calls in one pass of {MPL} bounces")
        for args, args5, k5 in zip(tcalls[kind], lcalls[k5_name], k5_plain[k5_name]):
            check(same_rays(args, args5),
                  f"{kind}: the cluster pass's active rays differ from the frontier pass's")
            cl, o, d, tmin, tmax, active = args
            if kind == "closest":
                (u_p, v_p), uv_ms = profiled(lambda: ft._recompute_uv(cl, o, d, k5["want"][1]))
                want = Hit(t=k5["want"][0], tri=k5["want"][1], u=u_p, v=v_p)
                plain_ms = k5["plain_ms"] + uv_ms
            else:
                want, plain_ms = k5["want"], k5["plain_ms"]
            t_visits[kind] += k5["ent"]
            t_tests[kind] += k5["need"]
            for tracer in ("cluster", "binned"):
                tname = f"trace_{kind}_{tracer}"
                f_k = (lambda fn=fns[tracer][kind == "any"]:
                       fn(cl, o, d, tmin, tmax, active))
                launches0 = tracers[tname].launches
                bt.LOOP.reset()
                got = f_k()
                torch.cuda.synchronize()
                enqueued = tracers[tname].launches - launches0  # rounds of a binned call
                a = acc[tname]
                if tracer == "binned":  # no readback a round: one per batch of rounds
                    lp = vars(bt.LOOP)
                    check(lp["readbacks"] == lp["rounds"] // bt.ROUND_BATCH + 1,
                          f"{tname}: {lp['readbacks']} readbacks for {lp['rounds']} rounds")
                    for k in a["loop"]:
                        a["loop"][k] += lp[k]
                if kind == "closest":
                    for x, y, what in ((got.t, want.t, "t"), (got.u, want.u, "u"),
                                       (got.v, want.v, "v")):
                        check(torch.equal(bits(x), bits(y)),
                              f"{tname} at the cluster pass's inputs: {what} not bit-equal")
                        a["err"] = max(a["err"], float((x - y).abs().max()))
                    check(torch.equal(got.tri, want.tri),
                          f"{tname} at the cluster pass's inputs: tri differs from plain and K5")
                else:
                    check(torch.equal(got, want),
                          f"{tname} at the cluster pass's inputs: occ differs from plain and K5")
                    a["err"] = max(a["err"], float((got != want).sum()))
                a["rounds"] += enqueued
                add_times(a["times"], device_ms(
                    f_k, reps=BINNED_REPLAYS if tracer == "binned" else REPLAYS))
                if tracer == "binned":  # its split by kernel family; its wall time
                    # the scan, offsets, scatter and test kernels of each round
                    sp = device_split(f_k, 4 * enqueued)
                    for k in sp:
                        a["split"][k] += sp[k]
                    walls = []
                    for _ in range(3):
                        torch.cuda.synchronize()
                        w0 = time.perf_counter()
                        f_k()
                        torch.cuda.synchronize()
                        walls.append((time.perf_counter() - w0) * 1e3)
                    a["wall_ms"] += sorted(walls)[1]
                a["plain_ms"] += plain_ms
                a["bound"] += max(k5["b_bytes"], k5["b_ops"])
                a["by_bytes"] += k5["b_bytes"]
                a["by_ops"] += k5["b_ops"]
    for tname, kern in tracers.items():
        a = acc[tname]
        kind, tracer = tname.split("_")[1], tname.split("_")[2]
        nc = len(tcalls[kind])
        max_err[tname] = a["err"]
        t = per_launch(a["times"], nc)
        row = {
            "name": tname, "route": "cuda",
            "source": f"fermat_tpu_torch/ops/csrc/{kern.source}",
            "replaces": kern.replaces,
            "launches": big[tracer]["launches"][tname],
            "launches_per_pass": big[tracer]["launches"][tname] / n_big,
            "max_abs_err": a["err"], "max_abs_err_vs_plain": a["err"],
            **t, "plain_ms": a["plain_ms"] / nc, "bound_ms": a["bound"] / nc,
            "bound_by": "bytes" if a["by_bytes"] >= a["by_ops"] else "operations",
            "library_ms": None,
            "shapes": [f"{tcalls[kind][0][1].x.shape[0]} rays x "
                       f"{int((cview.clusters.count > 0).sum())} clusters"],
            "clusters_needed_per_launch": t_visits[kind] / nc,
            "tests_needed_per_launch": t_tests[kind] / nc,
        }
        if tracer == "binned":  # one launch group = one wrapper call, all its rounds
            lp = a["loop"]
            row.update(launch_groups_per_pass=big[tracer]["groups"][kind] / n_big,
                       enqueued_rounds_per_launch_group=a["rounds"] / nc,
                       rounds_per_launch_group=lp["rounds"] / nc,
                       readbacks_per_launch_group=lp["readbacks"] / nc,
                       scans_per_visit=lp["scans"] / max(lp["pairs"], 1),
                       wall_ms_per_launch_group=a["wall_ms"] / nc,
                       device_work_ms_per_launch_group=sum(a["split"].values()) / nc,
                       in_pass_ms_per_launch_group=sum(big[tracer]["in_pass_ms"][kind].values())
                       / MPL,
                       **{f"{k}_ms": v / nc for k, v in a["split"].items()})
        rows.append(row)
        log(f"[6 timing] {tname}: {fmt_times(t)}/"
            + ("launch group" if tracer == "binned" else "launch")
            + f" (plain {a['plain_ms'] / nc * 1e3:.1f} us, bound {a['bound'] / nc * 1e3:.2f} us by "
            f"{row['bound_by']}, K5's on the same rays) over the {nc} calls of one cluster "
            f"pass, each equal to its plain version and to K5 (max abs err {a['err']:.3g})"
            + (f"; a group: {a['loop']['rounds'] / nc:.1f} rounds that tested rays "
               f"({a['rounds'] / nc:.1f} enqueued), {a['loop']['readbacks'] / nc:.2f} host "
               f"readbacks, {a['loop']['scans'] / max(a['loop']['pairs'], 1):.3f} full scans a "
               f"visit; device work {sum(a['split'].values()) / nc:.2f} ms (scan "
               f"{a['split']['scan'] / nc:.2f}, counting sort {a['split']['bin'] / nc:.2f}, test "
               f"{a['split']['test'] / nc:.2f}, other {a['split']['other'] / nc:.2f} ms), wall "
               f"{a['wall_ms'] / nc:.2f} ms (median of 3); in the 4e pass "
               f"{row['in_pass_ms_per_launch_group']:.2f} ms" if tracer == "binned" else ""))
    step_rows, first_tests = binned_step_rows(dev, bw, fp32, tcalls, big["binned"]["launches"],
                                              max_err)
    for row in rows:
        if row["name"] in ("trace_closest_binned", "trace_any_binned"):
            row["first_round_test_step"] = first_tests[row["name"].split("_")[1]]
    rows += step_rows

    # K2b at the inputs of the 4f steps (the recorded step of each scene):
    # each launch held to its plain version within BWD_RTOL, then timed with
    # the plain version and index_add_ into fresh zeros (the backward of
    # index_select); bound: bytes (idx and the cotangent in, d_table out)
    def bwd_timing(key):
        a = dict(plain_ms=0.0, library_ms=0.0, bound_ms=0.0, err=0.0, rel=0.0)
        times, shapes = {}, set()
        for g, idx, rows in bwd_calls[key]:
            n, k = g.shape
            idx64 = idx.long()
            f_k = lambda: gather_mod.gather_rows_bwd(g, idx, rows)
            f_p = lambda: gather_mod._gather_bwd_plain(g, idx, rows)
            f_l = lambda: torch.zeros((rows, k), device=dev).index_add_(0, idx64, g)
            got, want = f_k(), f_p()
            scale = gather_mod._gather_bwd_plain(g.abs(), idx, rows)
            torch.cuda.synchronize()
            rel = float(((got - want).abs() / scale.clamp_min(1e-30)).max())
            check(rel <= gather_mod.BWD_RTOL,
                  f"gather_rows_bwd at the {key} AD step's inputs: {rel:.3g} of sum|g| from plain")
            a["err"] = max(a["err"], float((got - want).abs().max()))
            a["rel"] = max(a["rel"], rel)
            add_times(times, device_ms(f_k))
            a["plain_ms"] += device_ms(f_p, reps=5, cold=False)["ms"]
            a["library_ms"] += device_ms(f_l, cold=False)["ms"]
            a["bound_ms"] += (4 * n + 4 * n * k + 4 * rows * k) / bw * 1e3
            shapes.add(f"cotangent {n}x{k} into {rows} rows "
                       f"({'shared-memory' if gather_mod.bwd_slices(rows, k) else 'atomic'} mode)")
        nc = len(bwd_calls[key])
        check(nc > 0, f"gather_rows_bwd: no launch captured in the {key} AD step")
        out = {k: (v / nc if k.endswith("ms") else v) for k, v in a.items()}
        out.update(per_launch(times, nc), n=nc, shapes=sorted(shapes))
        log(f"[6 timing] gather_rows_bwd at the {key} AD step: {fmt_times(out)}/launch "
            f"(plain {out['plain_ms'] * 1e3:.1f} us, index_add_ {out['library_ms'] * 1e3:.1f} us, "
            f"bound {out['bound_ms'] * 1e3:.2f} us by bytes) over its {nc} launches, each within "
            f"BWD_RTOL of its plain version (max abs err {a['err']:.3g}, {a['rel']:.3g} of "
            f"sum|g|); {sorted(shapes)}")
        return out

    bwd_c, bwd_b = bwd_timing("cornell"), bwd_timing("big_room")
    del bwd_calls
    max_err["gather_rows_bwd"] = bwd_c["err"]
    kern = ad["gather_rows_bwd"]
    rows.append({
        "name": "gather_rows_bwd", "route": "cuda",
        "source": f"fermat_tpu_torch/ops/csrc/{kern.source}",
        "replaces": kern.replaces,
        "launches": adr["cornell"]["launches"]["gather_rows_bwd"],
        "launches_per_step": adr["cornell"]["launches"]["gather_rows_bwd"],
        "max_abs_err": bwd_c["err"], "max_abs_err_vs_plain": bwd_c["err"],
        "max_err_over_sum_abs_g": bwd_c["rel"], "tolerance_over_sum_abs_g": gather_mod.BWD_RTOL,
        **{k: bwd_c[k] for k in ("ms", "ms_min", "ms_max", "cold_ms", "cold_ms_min",
                                 "cold_ms_max", "us_per_launch", "timer")},
        "plain_ms": bwd_c["plain_ms"], "bound_ms": bwd_c["bound_ms"],
        "bound_by": "bytes", "library_ms": bwd_c["library_ms"], "shapes": bwd_c["shapes"],
        "in_pass_ms": a_in_step["gather_rows_bwd"], "in_pass": "the profiled CornellBox AD step",
        "at_big_room": {
            "launches": adr["big_room"]["launches"]["gather_rows_bwd"],
            "launches_per_step": adr["big_room"]["launches"]["gather_rows_bwd"] / 2,
            **{k: bwd_b[k] for k in ("ms", "ms_min", "ms_max", "cold_ms", "plain_ms",
                                     "library_ms", "bound_ms", "shapes")},
            "max_abs_err": bwd_b["err"], "max_err_over_sum_abs_g": bwd_b["rel"]},
    })

    # K8 through its entry points at the rays of every K5 launch of the
    # monolithic big_room pass recorded above: the subcluster tracer is not
    # routed by render_pass, so this is its path. Every launch is held
    # bit-equal to the plain answer K5 was held to (the same function) and
    # timed; the bound counts 46 flops a test over K8's own leaves, K5's
    # beside it. K8's own plain version (K5's over the subcluster table)
    # runs at the first launch of each kind only (bounce 0, every lane
    # active), with 4x larger chunks than its default: at every launch it
    # took 640 s of host loop under the profiler. plain_ms is that launch's,
    # beside K8's time and bound at the same launch
    reset_counts()
    sub_out = {"closest": [], "any": []}
    for kind in ("closest", "any"):
        for cl, o, d, tmin, tmax, active in lcalls[f"trace_{kind}_frontier"]:
            f = st.trace_closest_sub if kind == "closest" else st.trace_any_sub
            sub_out[kind].append(f(sub_room, o, d, tmin, tmax, active))
    torch.cuda.synchronize()
    sub_launches = counts()
    check(all(sub_launches[n] == MPL for n in subk),
          f"K8 at the big_room pass's rays: {sub_launches} launches for {MPL} bounces")
    sub_table = 4 * (sub_room.rows.numel() + sub_room.count.numel() + 6 * sub_room.lo_x.shape[1])
    for kind in ("closest", "any"):
        kname = f"trace_{kind}_sub"
        a = dict(bound=0.0, by_bytes=0.0, by_ops=0.0, k5=0.0, err=0.0, need=0.0, ent=0.0)
        times = {}
        t0 = time.perf_counter()
        for k, (args, k5, got) in enumerate(zip(lcalls[f"trace_{kind}_frontier"],
                                                k5_plain[f"trace_{kind}_frontier"],
                                                sub_out[kind])):
            _, o, d, tmin, tmax, active = args
            n = o.x.shape[0]
            tmin_l, tmax_l = lanes(tmin, n), lanes(tmax, n)
            if kind == "closest":
                f_k = lambda: st.trace_closest_sub(sub_room, o, d, tmin, tmax, active)
                f_p = lambda: ft._closest_plain(sub_room, o, d, tmin_l, tmax_l, active)
                t5, tri5 = k5["want"]
                check(torch.equal(got.tri, tri5) and torch.equal(bits(got.t), bits(t5)),
                      "trace_closest_sub at the big_room pass's rays: differs from K5's answer")
                need, ent = needed_tests(sub_room, o, d, tmin_l, tmax_l, active, t5)
                byt = n * (33 + 8) + sub_table
            else:
                f_k = lambda: st.trace_any_sub(sub_room, o, d, tmin, tmax, active)
                f_p = lambda: ft._any_plain(sub_room, o, d, tmin_l, tmax_l, active)
                check(torch.equal(got, k5["want"]),
                      "trace_any_sub at the big_room pass's rays: differs from K5's answer")
                need, ent = needed_tests(sub_room, o, d, tmin_l, tmax_l, active, None, k5["want"])
                byt = n * (33 + 1) + sub_table
            if k == 0:  # K8's own plain version at the first launch
                with patched([(ft, "_CHUNK_ELEMS", 4 * ft._CHUNK_ELEMS)]):
                    want, p_ms = profiled(f_p)
                torch.cuda.synchronize()
                if kind == "closest":
                    same = torch.equal(got.tri, want[1]) and torch.equal(bits(got.t),
                                                                         bits(want[0]))
                    a["err"] = max(a["err"], float((got.t - want[0]).abs().max()))
                else:
                    same = torch.equal(got, want)
                    a["err"] = max(a["err"], float((got != want).sum()))
                check(same, f"{kname} at the big_room pass's rays: differs from its plain")
                del want
            tk = device_ms(f_k)
            add_times(times, tk)
            b_bytes, b_ops = byt / bw * 1e3, need * FLOPS_PER_TEST / fp32 * 1e3
            if k == 0:
                first = dict(ms=tk["ms"], plain_ms=p_ms, bound_ms=max(b_bytes, b_ops),
                             k5_bound_ms=max(k5["b_bytes"], k5["b_ops"]))
            a["bound"] += max(b_bytes, b_ops)
            a["by_bytes"] += b_bytes
            a["by_ops"] += b_ops
            a["k5"] += max(k5["b_bytes"], k5["b_ops"])
            a["need"] += need
            a["ent"] += ent
        nc = len(sub_out[kind])
        max_err[kname] = a["err"]
        kern = subk[kname]
        t = per_launch(times, nc)
        row = {
            "name": kname, "route": "cuda",
            "source": f"fermat_tpu_torch/ops/csrc/{kern.source}",
            "replaces": kern.replaces,
            "launches": sub_launches[kname],
            "launches_per_pass_of_rays": sub_launches[kname],
            "max_abs_err": a["err"], "max_abs_err_vs_plain": a["err"],
            **t, "plain_ms": first["plain_ms"], "bound_ms": a["bound"] / nc,
            "bound_by": "bytes" if a["by_bytes"] >= a["by_ops"] else "operations",
            "library_ms": None,
            "shapes": [f"{lcalls[f'trace_{kind}_frontier'][0][1].x.shape[0]} rays x "
                       f"{sub_room.n_subclusters} subclusters"],
            "plain_ms_at": "the first launch (bounce 0)",
            "at_first_launch": first,
            "k5_bound_ms_same_rays": a["k5"] / nc,
            "subclusters_needed_per_launch": a["ent"] / nc,
            "tests_needed_per_launch": a["need"] / nc,
        }
        rows.append(row)
        log(f"[6 timing] {kname}: {fmt_times(t)}/launch (bound "
            f"{a['bound'] / nc * 1e3:.2f} us by {row['bound_by']} over K8's leaves: "
            f"{a['ent'] / nc:.0f} subcluster entries and {a['need'] / nc:.0f} ray-triangle tests "
            f"needed per launch; K5's bound on the same rays {a['k5'] / nc * 1e3:.2f} us) over "
            f"the {nc} K5 launches' rays of one big_room pass, each equal to K5's answer; at the "
            f"first launch {first['ms'] * 1e3:.1f} us, plain {first['plain_ms'] * 1e3:.1f} us, "
            f"bound {first['bound_ms'] * 1e3:.2f} us (K5's {first['k5_bound_ms'] * 1e3:.2f} us), "
            f"equal to K8's plain version (max abs err {a['err']:.3g}); "
            f"{time.perf_counter() - t0:.1f} s for the phase")

    rows += walk_rows(dev, bw, fp32, bview, opt, lcalls, k5_plain, bvhk, max_err)

    log("[summary] big_room " + "; ".join(
        f"{m}: {v['ms']:.2f} ms/pass, {v['mrays']:.3f} Mrays/s, {v['kernels']} device kernels, "
        f"idle {v['idle']:.3f}" for m, v in big.items())
        + f"; AD step (frontier): {adr['big_room']['ms']:.2f} ms/step, "
          f"{adr['big_room']['mrays']:.3f} train Mrays/s, peak {adr['big_room']['peak'] / 2 ** 30:.2f}"
          f" GiB, idle {adr['big_room']['idle']:.3f}")
    for row in rows:  # the kernel's launches per pass on each lit (4g), textured (4h) and
        # options (4i) path
        for cell, per in (*lit["launches"].items(), *tex["launches"].items(),
                          *opt["launches"].items(), *bp["launches"].items(),
                          *pf["launches"].items(), *ml["launches"].items(),
                          *rm["launches"].items()):
            row[f"launches_per_pass_{cell}"] = per.get(row["name"], 0)
        for key, ph in (("in_lit_pass_us", lit), ("in_textured_pass_us", tex),
                        ("in_options_pass_us", opt), ("in_bpt_pass_us", bp),
                        ("in_psf_pass_us", pf), ("in_mlt_pass_us", ml),
                        ("in_rpt_pass_us", rm)):
            row[key] = {c: v["in_pass_us"][row["name"]] for c, v in ph["cells"].items()
                        if row["name"] in v.get("in_pass_us", {})}
    log("[summary] lit (4g) " + "; ".join(
        f"{c}: {v['ms']:.2f} ms/pass, {v['mrays']:.3f} Mrays/s, busy {v['busy_ms']:.2f} ms, "
        f"idle {v['idle']:.3f}" for c, v in lit["cells"].items()))
    log("[summary] options (4i) " + "; ".join(
        f"{c}: {v['ms']:.2f} ms/pass, {v['mrays']:.3f} Mrays/s, {v['kernels']} device kernels, "
        f"busy {v['busy_ms']:.2f} ms, idle {v['idle']:.3f}" for c, v in opt["cells"].items())
        + f"; big_room BVH host build {opt['build_s']:.2f} s")
    log("[summary] bpt and pssmlt (4j) " + "; ".join(
        f"{c}: {v['ms']:.2f} ms/" + ("step" if "init_ms" in v else "pass")
        + (f", {v['mrays']:.3f} Mrays/s" if "init_ms" not in v else "")
        + (f", {v['kernels']} device kernels, busy {v['busy_ms']:.2f} ms, idle {v['idle']:.3f}"
           if "kernels" in v else "")
        + (f", init {v['init_ms']:.1f} ms, {v['mutations_per_s'] / 1e6:.3f} M mutations/s, "
           f"acceptance {v['accept']:.4f}, init peak {v['init_peak_bytes'] / 2 ** 30:.2f} GiB"
           if "init_ms" in v else "") for c, v in bp["cells"].items()))
    log("[summary] psfpt and ptrl (4k) " + "; ".join(
        f"{c}: {v['ms']:.2f} ms/pass, {v['mrays']:.3f} Mrays/s, {v['kernels']} device kernels, "
        f"busy {v['busy_ms']:.2f} ms, idle {v['idle']:.3f}, "
        f"peak {v['peak_bytes'] / 2 ** 30:.2f} GiB"
        + (f", host build {v['build_ms']:.1f} ms, adaptation {v['adapt_ms']:.2f} ms "
           f"({v['adapt_paying_ms']:.2f} ms when it pays)"
           if "build_ms" in v else "") for c, v in pf["cells"].items()))
    log("[summary] mlt and cmlt (4l) " + "; ".join(
        f"{c}: {v['ms']:.2f} ms/" + ("step" if "init_ms" in v else "pass")
        + f", {v['mrays']:.3f} Mrays/s, {v['kernels']} device kernels, busy {v['busy_ms']:.2f}"
        f" ms, idle {v['idle']:.3f}, peak {v['peak_bytes'] / 2 ** 30:.2f} GiB, acceptance "
        + "/".join(f"{a:.4f}" for a in v["accept"])
        + (f", init {v['init_ms']:.1f} ms" if "init_ms" in v else "")
        for c, v in ml["cells"].items())
        + "; convergence to PT: " + "; ".join(
            f"{t} max rel {v['rel']:.4f}, pooled {v['pooled']:.4f}"
            for t, v in ml["convergence"].items()))
    log("[summary] rpt (4m) " + "; ".join(
        f"{c}: {v['ms']:.2f} ms/pass, {v['mrays']:.3f} Mrays/s, {v['kernels']} device kernels, "
        f"busy {v['busy_ms']:.2f} ms, idle {v['idle']:.3f}, peak {v['peak_bytes'] / 2 ** 30:.2f} "
        "GiB" for c, v in rm["cells"].items())
        + f"; convergence to PT: max rel {rm['convergence']['rel']:.4f}, pooled "
          f"{rm['convergence']['pooled']:.4f}, env floor {rm['convergence']['env_rel']:.4f}; "
          f"the CLI (4n): -pt {cli['bench']['pt']['mean_pass_ms']:.2f} ms/pass, stages "
          + ", ".join(f"{k} {v:.2f}" for k, v in cli["stages"].items()))
    log("[summary] textured (4h) " + "; ".join(
        f"{c}: {v['ms']:.2f} ms" + (f"/pass, {v['mrays']:.3f} Mrays/s, busy {v['busy_ms']:.2f} ms,"
                                     f" idle {v['idle']:.3f}, atlas {v['atlas_bytes']} B"
                                     if "mrays" in v else "/step")
        + f", peak {v['peak_bytes'] / 2 ** 30:.2f} GiB" for c, v in tex["cells"].items()))
    mark("summary")
    log("[summary] seconds per phase " + json.dumps(phase_s))
    log(f"[summary] the last slice (4o): native OBJ parse {sl['native']['parse_ms']:.1f} ms vs "
        f"{sl['native']['parse_python_ms']:.1f} ms Python, native BVH {sl['native']['bvh_ms']:.1f}"
        f" ms vs {sl['native']['bvh_python_ms']:.1f} ms Python; LBVH {sl['lbvh_ms']:.2f} ms; knn "
        f"{sl['knn_ms']:.1f} ms; filtered_image " + ", ".join(
            f"{k} {v:.2f} ms" for k, v in sl["denoise"].items())
        + f"; sharded pass {sl['sharded']['ms']:.2f} ms vs {sl['sharded']['unsharded_ms']:.2f} ms;"
        f" the large OBJ through the CLI {sl['cli_room']['mean_pass_ms']:.2f} ms/pass")
    log(f"[summary] chip_smoke.py ran {time.perf_counter() - _T0:.1f} s in total")
    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--convergence"]:
        sys.exit(convergence_render(*sys.argv[2:4]))
    sys.exit(main())
