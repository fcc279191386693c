"""fermat_tpu_torch.bsdf against fermat_tpu.bsdf on numpy-seeded batches.

Tolerance. Discrete outputs (sampled lobe, validity) and the non-finite
pattern are equal and the albedo table is bit-equal. Float outputs are held
to rtol 1e-4 (atol 1e-6) on at least 99.5% of lanes, and on those lanes to
a mean offset of at most 1e-4 of the mean magnitude (measured 3.6e-5 at
worst, sampled glossy transmission), not to 1e-6 elementwise: XLA:CPU
contracts a*b+c into FMA, lowers x / 3.0 to x * f32(1/3) (the port writes
those two constants so) and has its own rsqrt/sin/cos, so the two sides
differ by an ulp in places, and the GGX NDF turns one ulp of the half vector
into up to ~1/alpha^2 ulps of D. Measured on these batches (roughness >= 0.3):
most lanes bit-equal or within 1e-6, at most 6e-5 relative, except 7 of 4096
grazing sampled directions; at roughness 0.02 a sampled pdf changes by O(1)
per ulp, which is why the batches keep away from mirror-sharp lobes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fermat_tpu.bsdf import composite as jc
from fermat_tpu.bsdf import ggx as jggx
from fermat_tpu.core.math import Vec3 as JV
from fermat_tpu_torch.bsdf import composite as tc
from fermat_tpu_torch.bsdf import ggx as tggx
from fermat_tpu_torch.core.math import Vec3 as TV

N = 4096
# every lobe mask scene_lobes can return: (True, has_dt, True, has_gt)
LOBES = [(True, dt, True, gt) for dt in (False, True) for gt in (False, True)]


@pytest.fixture(scope="module")
def batch():
    r = np.random.default_rng(7)
    f = lambda *s: r.random(s).astype(np.float32)

    def unit():
        v = r.standard_normal((3, N)).astype(np.float32)
        return v / np.linalg.norm(v, axis=0)

    params = dict(
        diffuse=f(3, N), diffuse_trans=f(3, N) * (f(N) < 0.5), specular=f(3, N) * 3.0,
        roughness=0.3 + 0.7 * f(N),
        ior=np.where(f(N) < 0.1, 0.0, 1.0 + f(N)).astype(np.float32),
        opacity=np.where(f(N) < 0.5, 1.0, f(N)).astype(np.float32),
        reflectivity=f(3, N) * (f(N) < 0.3),
    )
    return params, unit(), unit(), f(3, N)


def _jparams(p):
    return jc.BsdfParams(**{k: JV(*map(jnp.asarray, v)) if v.ndim == 2 else jnp.asarray(v)
                            for k, v in p.items()})


def _tparams(p):
    return tc.BsdfParams(**{k: TV(*map(torch.from_numpy, v)) if v.ndim == 2
                            else torch.from_numpy(v) for k, v in p.items()})


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    ok = np.isfinite(want)
    g, w = got[ok].astype(np.float64), want[ok].astype(np.float64)
    near = np.abs(g - w) <= 1e-4 * np.abs(w) + 1e-6
    assert near.mean() >= 0.995, (near.mean(), np.abs(g - w).max())
    # no systematic offset on the well-conditioned lanes
    assert abs((g - w)[near].mean()) <= 1e-4 * max(np.abs(w[near]).mean(), 1e-12)


def test_albedo_table_bit_equal():
    np.testing.assert_array_equal(
        tggx._build_albedo_table().view(np.uint32),
        jggx._build_albedo_table().view(np.uint32))


@pytest.mark.parametrize("clearcoat", [False, True])
@pytest.mark.parametrize("lobes", LOBES)
def test_f_split_matches(batch, lobes, clearcoat):
    p, wi, wo, _ = batch
    want = jax.jit(lambda pp, a, b: jc.f_split(pp, JV(*a), JV(*b), lobes, clearcoat))(
        _jparams(p), tuple(map(jnp.asarray, wi)), tuple(map(jnp.asarray, wo)))
    got = tc.f_split(_tparams(p), TV(*map(torch.from_numpy, wi)),
                     TV(*map(torch.from_numpy, wo)), lobes, clearcoat)
    for g, w in zip((*got[0], *got[1]), (*want[0], *want[1])):
        _close(g, w)
    _close(got[2], want[2])


@pytest.mark.parametrize("clearcoat", [False, True])
@pytest.mark.parametrize("lobes", LOBES)
def test_sample_matches(batch, lobes, clearcoat):
    p, wi, _, u = batch
    want = jax.jit(lambda pp, a, uu: jc.sample(pp, JV(*a), uu[0], uu[1], uu[2], lobes,
                                               clearcoat))(
        _jparams(p), tuple(map(jnp.asarray, wi)), jnp.asarray(u))
    got = tc.sample(_tparams(p), TV(*map(torch.from_numpy, wi)),
                    *map(torch.from_numpy, u), lobes, clearcoat)
    np.testing.assert_array_equal(got.component.numpy(), np.asarray(want.component))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    for g, w in zip((*got.wo, *got.f, *got.g, got.pdf), (*want.wo, *want.f, *want.g, want.pdf)):
        _close(g, w)


def test_glossy_model_ltc_raises(batch):
    """The LTC lobe is ported (tests/test_torch_options.py holds it to JAX):
    a glossy model name JAX does not know raises."""
    p, wi, wo, _ = batch
    with pytest.raises(NotImplementedError, match="glossy"):
        tc.f_split(_tparams(p), TV(*map(torch.from_numpy, wi)),
                   TV(*map(torch.from_numpy, wo)), glossy="beckmann")
