"""The port's design-step tools (tools/torch_k1b_k2b_steps.py,
tools/torch_k2_k1_steps.py, tools/torch_k3_steps.py, tools/torch_k5_steps.py)
and what they share (tools/torch_steps_common.py), without a card: the text
edits, ptxas's report, the parallel build, the attribute patch and the
per-call lanes of the steps before the lanes were cached. The tools' step edits
are a record of how each kernel was designed and are checked when a tool
runs, not against today's kernel sources here.
"""
import importlib.util
import sys
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _tool(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def common():
    return _tool("torch_steps_common")


def test_edited_makes_each_edit_or_stops(common):
    src = "a b a c\n"
    assert common.edited(src, [("a", "x", 2), ("c", "y")], "f.cu") == "x b x y\n"
    with pytest.raises(SystemExit, match="no longer applies to f.cu"):
        common.edited(src, [("a", "x")], "f.cu")  # twice, not once
    with pytest.raises(SystemExit, match="no longer applies to f.cu"):
        common.edited(src, [("d", "x")], "f.cu")


def test_k2_k1_ptxas_names(common):
    tool = _tool("torch_k2_k1_steps")
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_118gather_rows_kernelI6float4Lb1EEEvPKT_PKiiiiPS2_' for 'sm_90a'",
        "ptxas info    : Function properties for x",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 40 registers, used 0 barriers",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_114closest_kernelE7RayPtrsPKfS2_PKhS2_iiPfPiS4_S4_' for 'sm_90a'",
        "ptxas info    : Used 64 registers",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_114closest_kernelILi2EEEvNS_7RayPtrsEPKfS3_PKhS3_iiPfPiS6_S6_' for "
        "'sm_90a'",
        "ptxas info    : Used 56 registers",
    ])
    got = common.ptxas(log, tool.KERNELS)
    assert got == {"gather_rows_kernel<float4,true>": {"stack_bytes": 0, "spill_store_bytes": 0,
                                                       "spill_load_bytes": 0, "registers": 40},
                   "closest_kernel": {"registers": 64}, "closest_kernel<2>": {"registers": 56}}


def test_k1b_k2b_ptxas_names(common):
    tool = _tool("torch_k1b_k2b_steps")
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_110any_kernelILi2EEEvNS_7RayPtrsEPKfS3_PKhS3_iiPh' for 'sm_90a'",
        "ptxas info    : Function properties for x",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 48 registers, used 1 barriers",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_110any_kernelE7RayPtrsPKfS2_PKhS2_iiPh' for 'sm_90a'",
        "ptxas info    : Used 40 registers",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_124gather_bwd_shared_kernelI6float4EEvPKT_PKiiiiiiPjPfS8_' for "
        "'sm_90a'",
        "ptxas info    : Used 72 registers",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_124gather_bwd_shared_kernelIfEEvPKT_PKiiiiiiPjPfS6_' for 'sm_90a'",
        "ptxas info    : Used 40 registers",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_125gather_bwd_partial_kernelEPKfPKiiiiiPf' for 'sm_90a'",
        "ptxas info    : Used 39 registers",
    ])
    got = common.ptxas(log, tool.KERNELS)
    assert got == {"any_kernel<2>": {"stack_bytes": 0, "spill_store_bytes": 0,
                                     "spill_load_bytes": 0, "registers": 48},
                   "any_kernel": {"registers": 40},
                   "gather_bwd_shared_kernel<float4>": {"registers": 72},
                   "gather_bwd_shared_kernel<float>": {"registers": 40},
                   "gather_bwd_partial_kernel": {"registers": 39}}


def test_k1b_k2b_parent_slices_are_the_parents(common):
    """The parent's K2b is launched with the slices its own wrapper gave it
    (512-lane CTAs, 96 KB of partials, 128 rows at most)."""
    tool = _tool("torch_k1b_k2b_steps")
    assert tool.parent_slices(36, 52) == 4 and tool.parent_slices(36, 1) == 8
    assert tool.parent_slices(7, 300) == 1 and tool.parent_slices(129, 52) == 0
    assert tool.parent_slices(128, 52) == 2


def test_filled_lanes_fill_a_number_per_call(common):
    """The lanes of the steps before the cache: a fresh buffer each call."""
    import torch

    a, b = common.filled_lanes(0.5, 4, "cpu"), common.filled_lanes(0.5, 4, "cpu")
    assert torch.equal(a, torch.full((4,), 0.5)) and a.data_ptr() != b.data_ptr()
    t = torch.arange(3, dtype=torch.float32)
    assert torch.equal(common.filled_lanes(t, 3, "cpu"), t)
    assert torch.equal(common.filled_lanes(torch.tensor(2.0), 3, "cpu"), torch.full((3,), 2.0))


def test_k2_k1_tool_stays_importable():
    tool = _tool("torch_k2_k1_steps")
    assert tool.HERE["trace.cu"] == tool.CACHED_LANES and callable(tool.main)


def test_build_runs_one_compiler_a_variant(common, tmp_path):
    """Every variant gets its own directory with the headers beside it and
    one compiler process; a failed one is reported as None with its
    output, the others keep their library and ptxas's registers."""
    fake = tmp_path / "fake_nvcc.py"
    fake.write_text(
        "import sys\nfrom pathlib import Path\n"
        "out, src = sys.argv[sys.argv.index('-o') + 1], Path(sys.argv[-1])\n"
        "assert (src.parent / 'common.cuh').exists()\n"
        "if 'broken' in src.read_text():\n    print('error: broken'); sys.exit(1)\n"
        "Path(out).write_text('so')\n"
        "print(\"ptxas info    : Compiling entry function '_Z8k_kernelILb1EEvv' for 'sm_90a'\")\n"
        "print('ptxas info    : Used 33 registers')\n")
    header = tmp_path / "common.cuh"
    header.write_text("// shared\n")
    got = common.build({("a.cu", "+one step"): ("a.cu", "ok"), "other": ("b.cu", "broken")},
                       tmp_path / "out", ("k_kernel",), (header,), nvcc=[sys.executable, str(fake)])
    so, info, _ = got[("a.cu", "+one step")]
    assert so == tmp_path / "out" / "a_cu_one_step" / "lib.so" and so.read_text() == "so"
    assert info == {"k_kernel<true>": {"registers": 33}}
    assert got["other"][0] is None and "error: broken" in got["other"][2]


def test_patch_restores_what_it_replaced(common):
    mod = types.SimpleNamespace(f=1, g=2)
    with common.patch([(mod, "f", 10), (mod, "g", 20)]):
        assert (mod.f, mod.g) == (10, 20)
    assert (mod.f, mod.g) == (1, 2)
