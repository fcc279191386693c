"""fermat_tpu_torch.core.rng is bit-identical to fermat_tpu.core.rng.

262,144 (pixel, dim, instance) triples from a numpy seed, with values next
to 2^32 and instances up to 2^31; integers must be equal and floats must
have equal bit patterns.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fermat_tpu.core import rng as jrng
from fermat_tpu_torch.core import rng as trng

N = 262_144


@pytest.fixture(scope="module")
def triples():
    r = np.random.default_rng(20261016)
    u32 = lambda: r.integers(0, 2 ** 32, N, dtype=np.uint64).astype(np.uint32)
    pix, dim, x = u32(), u32(), u32()
    edge = (2 ** 32 - 1 - np.arange(1024)).astype(np.uint32)
    pix[:1024], dim[1024:2048], x[:1024] = edge, edge, edge
    dim[2048:4096] = np.arange(2048, dtype=np.uint32) % 64  # the renderer's dims
    inst = r.integers(0, 2 ** 31 + 1, N, dtype=np.uint64).astype(np.uint32)
    inst[:4] = [0, 1, 2 ** 31 - 1, 2 ** 31]
    return pix, dim, inst, x


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


INT_CASES = {
    "hash_u32": (lambda m, p, d, i, x: m.hash_u32(x)),
    "hash_combine": (lambda m, p, d, i, x: m.hash_combine(x, p)),
    "reverse_bits32": (lambda m, p, d, i, x: m.reverse_bits32(x)),
    "owen_scramble": (lambda m, p, d, i, x: m.owen_scramble(x, d)),
    "sobol02_u32_d0": (lambda m, p, d, i, x: m.sobol02_u32(x)[0]),
    "sobol02_u32_d1": (lambda m, p, d, i, x: m.sobol02_u32(x)[1]),
}


@pytest.mark.parametrize("name", sorted(INT_CASES))
def test_integer_functions_bit_identical(triples, name):
    pix, dim, inst, x = triples
    f = INT_CASES[name]
    want = np.asarray(jax.jit(lambda p, d, i, x: f(jrng, p, d, i, x))(pix, dim, inst, x))
    got = f(trng, _t(pix), _t(dim), _t(inst), _t(x)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_uniform_from_bits_bit_identical_and_below_one(triples):
    x = triples[3].copy()
    x[:8] = [0xFFFFFFFF, 0xFFFFFF80, 0xFFFFFF7F, 0, 1, 0x80000000, 0xFFFF, 0x10000]
    want = np.asarray(jax.jit(jrng.uniform_from_bits)(x))
    got = trng.uniform_from_bits(_t(x)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert got.max() < 1.0


@pytest.mark.parametrize("kind", ["sample_2d", "sample_3d"])
def test_tiled_sequence_bit_identical(triples, kind):
    pix, dim, inst, _ = triples
    seed = 0x9E3779B9

    def jfun(p, d, i):
        seq = jrng.TiledSequence(jnp.uint32(seed), i)
        return getattr(seq, kind)(p, d)

    want = jax.jit(jfun)(pix, dim, inst)
    seq = trng.TiledSequence(seed, _t(inst))
    got = getattr(seq, kind)(_t(pix), _t(dim))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))


def test_tiled_sequence_scalar_instance_matches():
    """The renderer's own call shape: Python-int seed/instance/dim."""
    pix = np.arange(4096, dtype=np.uint32)
    for seed, inst, dim in [(0, 0, 0), (7, 5, 13), (0, 2 ** 31, 2 + 5 * 8)]:
        jseq = jrng.TiledSequence.create(seed).set_instance(jnp.uint32(inst))
        want = jseq.sample_3d(jnp.asarray(pix), jnp.uint32(dim))
        got = trng.TiledSequence.create(seed, inst).sample_3d(_t(pix), dim)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))
