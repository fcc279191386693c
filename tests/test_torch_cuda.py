"""Port kernels against their plain PyTorch versions ON THE CARD.

Marked `cuda`: they skip where torch.cuda.is_available() is false. This file
imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

With --fmad=false the kernels round like their plain versions, so every
comparison here is exact (bit-equal floats, equal hit ids and flags).
"""
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fermat_tpu_torch.core.math import Vec3  # noqa: E402
from fermat_tpu_torch.ops import gather as gather_mod  # noqa: E402
from fermat_tpu_torch.ops import trace as trace_mod  # noqa: E402
from fermat_tpu_torch.scene.procedural import cornell_box, random_soup  # noqa: E402


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _rays(n, lo, hi, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    o = torch.rand(3, n, generator=g, device=dev) * (hi - lo) + lo
    d = torch.randn(3, n, generator=g, device=dev)
    d = d / d.norm(dim=0, keepdim=True)
    active = torch.rand(n, generator=g, device=dev) < 0.9
    tmax = torch.rand(n, generator=g, device=dev) * 4.0
    return Vec3(*o), Vec3(*d), active, tmax


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["cornell", "soup300"])
def test_trace_kernels_match_plain_on_card(dev, scene):
    mesh = (cornell_box(glossy_boxes=True) if scene == "cornell" else random_soup(300))
    tris = mesh.device_view(dev).tri_soup()
    o, d, active, tmax = _rays(65536, -1.0, 1.0, dev, seed=1)
    o = Vec3(o.x, o.y + 1.0, o.z)  # inside the box
    hit = trace_mod.trace_closest(tris, o, d, 1e-4, 3.0e38, active)
    ref = trace_mod._closest_plain(tris, o, d, trace_mod._lanes(1e-4, 65536, dev),
                                   trace_mod._lanes(3.0e38, 65536, dev), active)
    torch.cuda.synchronize()
    assert torch.equal(hit.tri, ref.tri)
    for a, b in ((hit.t, ref.t), (hit.u, ref.u), (hit.v, ref.v)):
        assert torch.equal(_bits(a), _bits(b))
    assert (hit.tri >= 0).any()
    occ = trace_mod.trace_any(tris, o, d, 0.0, tmax, active)
    occ_ref = trace_mod._any_plain(tris, o, d, trace_mod._lanes(0.0, 65536, dev), tmax, active)
    torch.cuda.synchronize()
    assert torch.equal(occ, occ_ref)
    assert occ.any() and not occ.all()


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols", [(36, 52), (36, 23), (36, 1), (4096, 52)])
def test_gather_kernel_matches_plain_on_card(dev, rows, cols):
    g = torch.Generator(device=dev).manual_seed(rows + cols)
    table = torch.randn(rows, cols, generator=g, device=dev)
    idx = torch.randint(-3, rows + 3, (100_003,), generator=g, device=dev,
                        dtype=torch.int32)  # includes out-of-range rows
    out = gather_mod.gather_rows(table, idx)
    torch.cuda.synchronize()
    assert torch.equal(_bits(out), _bits(gather_mod._gather_plain(table, idx)))


@pytest.mark.cuda
def test_wrappers_count_launches_and_reject_bad_input(dev):
    table = torch.zeros(4, 3, device=dev)
    before = gather_mod.GATHER.launches
    gather_mod.gather_rows(table, torch.zeros(5, dtype=torch.int32, device=dev))
    assert gather_mod.GATHER.launches == before + 1
    with pytest.raises(TypeError):
        gather_mod.gather_rows(table, torch.zeros(5, dtype=torch.int64, device=dev))
