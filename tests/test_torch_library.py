"""The port's library modules against fermat_tpu's on the same seeded inputs:
the uv BVH and uv_fix (scene/uv_bvh.py), spherical harmonics (core/sh.py),
the distributions and the mixture EM (core/distributions.py), the k-d tree
(accel/kdtree.py), the LBVH (accel/lbvh.py), the 2-D morton codes and the
small names of core/math, core/sampling, core/rng, bsdf/fresnel,
scene/lights, render/framebuffer, scene/procedural and utils/profiling.

Tolerances: host builds (uv BVH, k-d tree, LBVH), integer codes and the
kNN / locate triangle and point ids are held exactly; elementwise float
formulas to 1e-6 relative (XLA:CPU contracts and vectorizes some of them
apart from torch, ROADMAP Queue 3; the kNN distances round apart by an ulp
for that reason), the Gaussian transform to 2e-5 (torch's and XLA's erfinv
differ by up to 1.3e-5 relative in the tails), the EM step and the mixture
pdf to 1e-5 (a batched 2x2 inverse and a responsibility sum over 512
samples).
"""
import io
import math
import os
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from fermat_tpu_torch.core.math import Vec3  # noqa: E402
from fermat_tpu_torch.scene import procedural as tproc  # noqa: E402


def rng(seed=0):
    return np.random.default_rng(seed)


def close(got, want, rtol=1e-6, atol=1e-6):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def unit_vectors(n, seed):
    d = rng(seed).normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def tv(a):
    return Vec3(*(torch.from_numpy(np.ascontiguousarray(a[:, i])) for i in range(3)))


def jv(a):
    from fermat_tpu.core.math import Vec3 as JVec3

    return JVec3(*(jnp.asarray(a[:, i]) for i in range(3)))


# ---- uv BVH and uv_fix ----

def _uv_meshes():
    """The CornellBox (19 unit uv quads in one group) and a seeded soup with
    random uvs in three groups."""
    from fermat_tpu.scene.procedural import cornell_box as jcornell

    soup = tproc.random_soup(200, seed=5)
    r = rng(5)
    soup.uvs = r.random((soup.n_vertices, 2)).astype(np.float32)
    soup.uv_indices = soup.triangles.copy()
    soup.group_names = ["a", "b", "c"]
    soup.group_offsets = np.asarray([0, 60, 140, 200], np.int32)
    return [(tproc.cornell_box(), jcornell()), (soup, soup)]


@pytest.mark.parametrize("case", [0, 1])
def test_uv_bvh_and_locate_match_jax(case):
    from fermat_tpu.scene import uv_bvh as juv

    from fermat_tpu_torch.scene import uv_bvh as tuv

    mine_ms, jax_ms = _uv_meshes()[case]
    mine, ref = tuv.build_uv_bvh(mine_ms, device="cpu"), juv.build_uv_bvh(jax_ms)
    for k in tuv.UVBvhView._fields:
        np.testing.assert_array_equal(getattr(mine, k).numpy(), np.asarray(getattr(ref, k)),
                                      err_msg=k)
    r = rng(15 + case)
    n = 512
    su = (r.random(n, dtype=np.float32) * 1.2 - 0.1).astype(np.float32)
    sv = (r.random(n, dtype=np.float32) * 1.2 - 0.1).astype(np.float32)
    gid = r.integers(0, max(len(mine_ms.group_offsets) - 1, 1), n).astype(np.int32)
    tri, u, v = tuv.locate(mine, torch.from_numpy(gid), torch.from_numpy(su),
                           torch.from_numpy(sv))
    jtri, ju, jvv = juv.locate(ref, jnp.asarray(gid), jnp.asarray(su), jnp.asarray(sv))
    np.testing.assert_array_equal(tri.numpy(), np.asarray(jtri))
    assert (tri.numpy() >= 0).any() and (tri.numpy() < 0).any()
    close(u, ju, rtol=1e-6, atol=1e-6)
    close(v, jvv, rtol=1e-6, atol=1e-6)


def test_uv_fix_matches_jax_and_reads_packed_uvs():
    from fermat_tpu.scene import uv_bvh as juv
    from fermat_tpu.scene.procedural import cornell_box as jcornell

    from fermat_tpu_torch.scene import uv_bvh as tuv

    mine, ref = tproc.cornell_box(), jcornell()
    for ms in (mine, ref):  # one named group, which uv_fix splits into charts
        ms.group_names = ["cornell"]
        ms.group_offsets = np.asarray([0, ms.n_triangles], np.int32)
    n_charts = tuv.uv_fix(mine)
    assert n_charts == juv.uv_fix(ref) and n_charts > 1
    for k in ("triangles", "normal_indices", "uv_indices", "material_ids", "group_offsets"):
        np.testing.assert_array_equal(getattr(mine, k), getattr(ref, k), err_msg=k)
    assert mine.group_names == ref.group_names
    # the build reads compressed uvs through the resolver, as JAX's does
    a, b = tproc.cornell_box().compress_tex(), jcornell().compress_tex()
    np.testing.assert_array_equal(tuv.build_uv_bvh(a, device="cpu").uv1.numpy(),
                                  np.asarray(juv.build_uv_bvh(b).uv1))


# ---- spherical harmonics ----

def test_sh_matches_jax():
    from fermat_tpu.core import sh as jsh

    from fermat_tpu_torch.core import sh as tsh

    d = unit_vectors(256, 3)
    for L in range(4):
        close(tsh.sh_basis(L, tv(d)), jsh.sh_basis(L, jv(d)))
        close(tsh.rotate_zh(L, [1.0, 0.5, 0.25, 0.125][:L + 1], tv(d)),
              jsh.rotate_zh(L, [1.0, 0.5, 0.25, 0.125][:L + 1], jv(d)))
    assert tsh.n_coeffs(3) == jsh.n_coeffs(3) == 16
    close(tsh.sh(2, -1, tv(d)), jsh.sh(2, -1, jv(d)))
    vals = (d[:, 2] ** 2 + 0.5 * d[:, 0]).astype(np.float32)
    c = tsh.project(3, tv(d), torch.from_numpy(vals))
    close(c, jsh.project(3, jv(d), jnp.asarray(vals)), rtol=1e-5, atol=1e-6)
    close(tsh.reconstruct(c, tv(d)), jsh.reconstruct(jnp.asarray(c.numpy()), jv(d)),
          rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        tsh.sh_basis(4, tv(d))


# ---- distributions and the mixture ----

def _dists(mod):
    return [mod.Uniform(2.0), mod.Cosine(), mod.Pareto(2.5, 1.0), mod.BoundedPareto(1.5, 0.5, 4.0),
            mod.BoundedExponential(0.01, 1.0), mod.Cauchy(0.5), mod.Exponential(1.5),
            mod.Gaussian(0.25, 2.0)]


def test_distributions_match_jax_on_the_same_uniforms():
    from fermat_tpu.core import distributions as jd

    from fermat_tpu_torch.core import distributions as td

    u = rng(21).random(4096, dtype=np.float32)
    x = np.linspace(-3.0, 5.0, 257, dtype=np.float32)
    for mine, ref in zip(_dists(td), _dists(jd)):
        name = type(mine).__name__
        got = mine.map(torch.from_numpy(u))
        want = np.asarray(ref.map(jnp.asarray(u)))
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5 if name == "Gaussian" else 1e-6,
                                   atol=1e-6, err_msg=name)
        np.testing.assert_allclose(mine.density(torch.from_numpy(x)).numpy(),
                                   np.asarray(ref.density(jnp.asarray(x))),
                                   rtol=1e-6, atol=1e-7, err_msg=name)


def test_mixture_pdf_sample_and_em_match_jax():
    from fermat_tpu.core import distributions as jd

    from fermat_tpu_torch.core import distributions as td

    r = rng(7)
    x = np.concatenate([r.normal([0.25, 0.25], 0.05, (256, 2)),
                        r.normal([0.75, 0.7], 0.08, (256, 2))]).astype(np.float32)
    w = r.random(512).astype(np.float32)
    mine = td.GaussianMixture2D.create(4, spread=0.3, device="cpu")
    ref = jd.GaussianMixture2D.create(4, spread=0.3)
    for k in ("weights", "means", "covs"):
        close(getattr(mine, k), getattr(ref, k))
    step = jax.jit(jd.em_step)
    for _ in range(3):
        mine = td.em_step(mine, torch.from_numpy(x), torch.from_numpy(w))
        ref = step(ref, jnp.asarray(x), jnp.asarray(w))
        for k in ("weights", "means", "covs"):
            close(getattr(mine, k), getattr(ref, k), rtol=1e-5, atol=1e-6)
    close(mine.pdf(torch.from_numpy(x)), ref.pdf(jnp.asarray(x)), rtol=1e-5, atol=1e-5)
    u = [r.random(1024).astype(np.float32) for _ in range(3)]
    close(mine.sample(*(torch.from_numpy(a) for a in u)),
          ref.sample(*(jnp.asarray(a) for a in u)), rtol=1e-5, atol=1e-5)


# ---- k-d tree ----

def test_kdtree_build_and_knn_match_jax():
    from fermat_tpu.accel import kdtree as jkd

    from fermat_tpu_torch.accel import kdtree as tkd

    r = rng(17)
    pts = r.random((3000, 3)).astype(np.float32)
    mine, ref = tkd.build_kdtree(pts, device="cpu"), jkd.build_kdtree(pts)
    for k in tkd.KdTreeView._fields:
        np.testing.assert_array_equal(getattr(mine, k).numpy(), np.asarray(getattr(ref, k)),
                                      err_msg=k)
    q = r.random((512, 3)).astype(np.float32)
    for k in (4,):
        d2, ids = tkd.knn(mine, *(torch.from_numpy(q[:, i].copy()) for i in range(3)), k=k)
        jd2, jids = jkd.knn(ref, *(jnp.asarray(q[:, i]) for i in range(3)), k=k)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        close(d2, jd2, rtol=1e-6, atol=0)
    # fewer points than k: the empty slots carry 3e38 and -1
    small = tkd.build_kdtree(np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32),
                             device="cpu")
    d2, ids = tkd.knn(small, torch.tensor([0.1]), torch.tensor([0.0]), torch.tensor([0.0]), k=4)
    assert ids.tolist() == [[0, 1, 2, -1]] and float(d2[0, 3]) > 1e30


# ---- LBVH ----

@pytest.mark.parametrize("scene", ["cornell", "soup", "one"])
def test_lbvh_matches_jax_and_walks_to_the_brute_hits(scene):
    from fermat_tpu.accel.lbvh import build_lbvh_for_mesh as jbuild
    from fermat_tpu.scene import procedural as jproc

    from fermat_tpu_torch.accel.lbvh import build_lbvh_for_mesh
    from fermat_tpu_torch.accel.traverse import walk_closest
    from fermat_tpu_torch.ops.trace import trace_closest

    if scene == "cornell":
        mine_ms, jax_ms = tproc.cornell_box(), jproc.cornell_box()
    else:  # JAX's build of one triangle is the fixed single-leaf tree
        n_tris = 700 if scene == "soup" else 1
        mine_ms, jax_ms = tproc.random_soup(n_tris, seed=11), jproc.random_soup(n_tris, seed=11)
    mesh = mine_ms.device_view("cpu")
    mine = build_lbvh_for_mesh(mesh)
    if scene == "one":  # JAX's single-leaf tree (lbvh.py:200-212), held without a compile
        lo, hi = mine_ms.vertices.min(0) - 1e-7, mine_ms.vertices.max(0) + 1e-7
        want = dict(lo_x=lo[:1], lo_y=lo[1:2], lo_z=lo[2:], hi_x=hi[:1], hi_y=hi[1:2],
                    hi_z=hi[2:], skip=[-1], prim_start=[0], is_leaf=[True], prims=[0], child=[0])
    else:
        ref = jax.jit(jbuild)(jax_ms.device_view())
        want = {k: np.asarray(getattr(ref, k)) for k in ("lo_x", "lo_y", "lo_z", "hi_x", "hi_y",
                                                         "hi_z", "skip", "prim_start", "is_leaf",
                                                         "prims", "child")}
    for k, w in want.items():
        np.testing.assert_array_equal(getattr(mine, k).numpy(), np.asarray(w, dtype=getattr(
            mine, k).numpy().dtype), err_msg=k)
    assert mine.leaf_size == 1
    r = rng(0)
    n = 512
    o = tv(((r.random((n, 3)) - 0.5) * 8).astype(np.float32))
    d = tv(unit_vectors(n, 1))
    tris = mesh.tri_soup()
    lane = lambda x: torch.full((n,), x)
    h = walk_closest(mine, tris, o, d, lane(1e-4), lane(1e9), torch.ones(n, dtype=torch.bool))
    b = trace_closest(tris, o, d, lane(1e-4), lane(1e9))  # the plain brute force on the CPU
    np.testing.assert_array_equal(h.tri.numpy() >= 0, b.tri.numpy() >= 0)
    hit = b.tri.numpy() >= 0
    assert hit.sum() > 0
    np.testing.assert_allclose(h.t.numpy()[hit], b.t.numpy()[hit], rtol=1e-6)


def test_morton2d_matches_jax():
    from fermat_tpu.core import morton as jm

    from fermat_tpu_torch.core import morton as tm

    r = rng(4)
    x = np.concatenate([r.random(4096, dtype=np.float32), [0.0, 1.0, -0.5, 1.5]]).astype(
        np.float32)
    y = np.concatenate([r.random(4096, dtype=np.float32), [1.0, 0.0, 2.0, -1.0]]).astype(
        np.float32)
    got = tm.morton2d(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jm.morton2d(jnp.asarray(x), jnp.asarray(y)))
                                  .astype(np.int64))
    v = np.arange(0, 65536, 7, dtype=np.uint32)
    np.testing.assert_array_equal(tm.expand_bits_2d(torch.from_numpy(v.astype(np.int64))).numpy(),
                                  np.asarray(jm.expand_bits_2d(jnp.asarray(v))).astype(np.int64))


# ---- the small names ----

def test_math_and_sampling_helpers_match_jax():
    from fermat_tpu.core import math as jmath
    from fermat_tpu.core import sampling as js

    from fermat_tpu_torch.core import math as tmath
    from fermat_tpu_torch.core import sampling as ts

    n = unit_vectors(1024, 5)
    i = unit_vectors(1024, 6)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    p = tmath.oct_pack16(tv(n))
    jp = jmath.oct_pack16(jv(n))
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp).astype(np.int64))
    close(tmath.oct_unpack16(p).stack(), jmath.oct_unpack16(jp).stack())
    uu, vv = (rng(8).random(1024, dtype=np.float32) * 2 - 1 for _ in range(2))
    close(tmath.oct_decode(t(uu), t(vv)).stack(),
          jmath.oct_decode(jnp.asarray(uu), jnp.asarray(vv)).stack())
    close(tmath.reflect(tv(i), tv(n)).stack(), jmath.reflect(jv(i), jv(n)).stack())
    for eta in (1.0 / 1.5, 1.5):
        (dm, tirm), (dj, tirj) = tmath.refract(tv(i), tv(n), eta), jmath.refract(jv(i), jv(n), eta)
        np.testing.assert_array_equal(tirm.numpy(), np.asarray(tirj))
        close(dm.stack(), dj.stack(), rtol=1e-5, atol=1e-6)
    x = (rng(9).random(512, dtype=np.float32) - 0.5) * 1e-11
    close(tmath.safe_rcp(t(x)), jmath.safe_rcp(jnp.asarray(x)), rtol=1e-6, atol=0)
    close(tmath.luminance(*(t(n[:, c].copy()) for c in range(3))),
          jmath.luminance(*(jnp.asarray(n[:, c]) for c in range(3))))
    close(tmath.norm(tv(n)), jmath.norm(jv(n)))
    close(tmath.lerp(tv(n), tv(i), 0.25).stack(), jmath.lerp(jv(n), jv(i), 0.25).stack())
    m = n[:, 0] > 0
    close(tmath.where(t(m), tv(n), tv(i)).stack(), jmath.where(jnp.asarray(m), jv(n), jv(i)).stack())
    close(tmath.vec3(0.5).stack(), jmath.vec3(0.5).stack())
    assert tmath.sqr(3.0) == jmath.sqr(3.0) == 9.0
    u0, u1 = (rng(10).random(1024, dtype=np.float32) for _ in range(2))
    close(ts.square_to_uniform_sphere(t(u0), t(u1)).stack(),
          js.square_to_uniform_sphere(jnp.asarray(u0), jnp.asarray(u1)).stack())
    c = (u0 * 2 - 1).astype(np.float32)
    close(ts.cosine_hemisphere_pdf(t(c)), js.cosine_hemisphere_pdf(jnp.asarray(c)))
    a, b = (u0 * 1e3).astype(np.float32), (u1 * 1e3).astype(np.float32)
    a[::7] = 0.0
    close(ts.balance_heuristic(t(a), t(b)), js.balance_heuristic(jnp.asarray(a), jnp.asarray(b)))
    close(ts.pdf_solid_angle_to_area(t(a), t(b), t(c)),
          js.pdf_solid_angle_to_area(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c)))
    close(ts.pdf_area_to_solid_angle(t(a), t(b), t(c)),
          js.pdf_area_to_solid_angle(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c)),
          rtol=1e-6, atol=0)


def test_rng_fresnel_emitter_and_framebuffer_names_match_jax():
    from fermat_tpu.bsdf import fresnel as jf
    from fermat_tpu.core import rng as jr
    from fermat_tpu.render import framebuffer as jfb
    from fermat_tpu.scene import lights as jl
    from fermat_tpu.scene.procedural import cornell_box as jcornell

    from fermat_tpu_torch.bsdf import fresnel as tf
    from fermat_tpu_torch.core import rng as tr
    from fermat_tpu_torch.render import framebuffer as tfb
    from fermat_tpu_torch.scene import lights as tl

    key = np.arange(4096, dtype=np.uint32) * np.uint32(2654435761)
    ctr = np.arange(4096, dtype=np.uint32)
    np.testing.assert_array_equal(
        tr.uniform(torch.from_numpy(key.astype(np.int64)), torch.from_numpy(ctr.astype(np.int64)))
        .numpy(), np.asarray(jr.uniform(jnp.asarray(key), jnp.asarray(ctr))))
    c = rng(12).random(1024, dtype=np.float32)
    for eta in (1.0 / 1.33, 1.33):
        (fm, tm_), (fj, tj) = tf.dielectric(torch.from_numpy(c), eta), jf.dielectric(
            jnp.asarray(c), eta)
        np.testing.assert_array_equal(tm_.numpy(), np.asarray(tj))
        close(fm, fj)
    mesh = tproc.cornell_box().device_view("cpu")
    jmesh = jcornell().device_view()
    tri = rng(13).integers(-1, mesh.n_triangles, 512).astype(np.int32)
    wo = unit_vectors(512, 14)
    close(tl.emitter_radiance(mesh, torch.from_numpy(tri), tv(wo)).stack(),
          jl.emitter_radiance(jmesh, jnp.asarray(tri), jv(wo)).stack())
    for k in ("DIFFUSE_C", "SPECULAR_C", "DIRECT_C", "COMPOSITED_C", "DIFFUSE_A", "SPECULAR_A"):
        assert getattr(tfb, k) == getattr(jfb, k)
    g, jg = tfb.GBuffer.create(3, 5, "cpu"), jfb.GBuffer.create(3, 5)
    for k in tfb.GBuffer._fields:
        np.testing.assert_array_equal(getattr(g, k).numpy(), np.asarray(getattr(jg, k)))
    assert tfb.Framebuffer.create(3, 5, "cpu").res == (3, 5)


def test_caustic_standin_is_jaxs_bit_for_bit_and_op_breakdown_prints(tmp_path):
    from fermat_tpu.scene.procedural import caustic_standin as jcaustic

    from fermat_tpu_torch.scene.procedural import caustic_standin
    from fermat_tpu_torch.utils import profiling

    (m, cam), (jm, jcam) = caustic_standin(), jcaustic()
    for k in ("vertices", "triangles", "normal_indices", "uv_indices", "material_ids",
              "group_offsets"):
        a, b = getattr(m, k), getattr(jm, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert [vars(a) for a in m.materials] == [vars(b) for b in jm.materials]
    for f in ("eye", "aim", "up"):
        np.testing.assert_array_equal(getattr(cam, f).stack().numpy(),
                                      np.asarray(getattr(jcam, f).stack()))
    assert float(cam.fov) == float(jcam.fov) == 45.0
    profiling.capture_trace(lambda: torch.ones(64).sum(), str(tmp_path), n_runs=1)
    buf = io.StringIO()
    with redirect_stdout(buf):
        profiling.print_op_breakdown(str(tmp_path), top=5)
    assert buf.getvalue().count(" ms  x") >= 1
    assert math.isfinite(float(buf.getvalue().split()[0]))
