"""The Pallas kernel (Triton route) in interpret mode on the CPU: every DG
class at every benchmark ndof against the numpy oracle, the in-kernel
padding and element masks, the per-block partials of a contracted long
axis, the shared-memory guard, and the platform/precision choices."""

import numpy as np
import pytest

import feinsum_tpu as f
from feinsum_tpu.diagnostics import InvalidParameterError
from feinsum_tpu.ops.kernel_lowering import padded_length
from feinsum_tpu.ops.pallas_emitter import (
    _dot_precision,
    block_tile,
    estimate_block_smem_bytes,
    interpret_mode,
)
from feinsum_tpu.tuning.impls._common import default_pallas_program


def chip_smoke():
    import importlib
    import os
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module("chip_smoke")


def dg_class(name, ndof, dtype="float32"):
    return chip_smoke().dg_classes(ndof, dtype)[name]


@pytest.mark.parametrize("ndof", [4, 10, 20, 35])
@pytest.mark.parametrize("name", ["div", "grad", "face", "mass", "curl"])
def test_kernel_matches_oracle(name, ndof):
    # 300 elements: three 128-element programs, the last one masked
    e = dg_class(name, ndof)
    f.validate_batched_einsum_transform(
        e, lambda p: default_pallas_program(p), long_dim_length=300)


@pytest.mark.parametrize("n,expected", [(1, 16), (4, 16), (16, 16),
                                        (17, 32), (35, 64), (105, 128)])
def test_small_axes_pad_to_a_power_of_two_of_at_least_16(n, expected):
    assert padded_length(n) == expected


@pytest.mark.parametrize("block,length,expected", [
    (128, 1_000_000, 128), (128, 100, 128), (256, 40, 64), (100, 10_000, 128)])
def test_element_block_is_a_power_of_two(block, length, expected):
    assert block_tile(block, length) == expected


@pytest.mark.parametrize("length", [1, 127, 129, 1000])
def test_masked_tail_block(length):
    """Lengths that do not fill the last program: the masked loads read 0
    and the masked stores leave nothing past the end."""
    e = f.einsum("ej,ij->ei", f.array("u", ("E", 35), "float32"),
                 f.array("D", (35, 35), "float32"))
    f.validate_batched_einsum_transform(
        e, lambda p: p.with_descriptor(backend="pallas", block_long=128),
        long_dim_length=length)


@pytest.mark.parametrize("subscripts,shapes", [
    ("ej->j", [("E", 35)]),
    ("ei,ej->ij", [("E", 7), ("E", 5)]),
    ("e,e->", [("E",), ("E",)]),
    ("ej,ij->i", [("E", 20), (20, 20)]),
])
def test_contracted_long_axis_sums_per_block_partials(subscripts, shapes):
    """A schedule that contracts the long axis writes one partial per
    program; XLA sums them (no program carries a sum to the next)."""
    names = "ABC"
    e = f.einsum(subscripts, *[f.array(names[k], s, "float32")
                               for k, s in enumerate(shapes)])
    prog = f.generate_program(e).with_descriptor(backend="pallas",
                                                 block_long=64)
    f.validate_batched_einsum_transform(e, lambda p: prog,
                                        long_dim_length=1000)
    from feinsum_tpu.measure import generate_input_arrays
    lowered = f.build_executable(prog, long_dim_length=1000).lower(
        generate_input_arrays(e, long_dim_length=1000))
    # 16 programs of 64 elements -> a (16, ...) partials array
    assert "tensor<16x" in lowered.as_text()


def test_smem_estimate_and_guard():
    e = dg_class("grad", 35)
    lengths = {"x": 3, "r": 3, "i": 35, "j": 35, "e": 100_000}
    canon = {ix: lengths.get(ix, 100_000)
             for ix in e.index_to_dim_length}
    # (128 x 64) f32 streamed tile + (64 x 64) f32 resident tile
    assert estimate_block_smem_bytes(e, 128, canon) == (128 * 64 + 64 * 64) * 4
    from feinsum_tpu.tuning.impls._common import guard_smem
    guard_smem(e, 256)
    with pytest.raises(InvalidParameterError, match="shared memory"):
        guard_smem(e, 1024)


def test_interpret_only_on_cpu_or_when_asked():
    desc = f.ScheduleDescriptor(backend="pallas")
    assert interpret_mode(desc) is True            # the CPU interprets
    assert interpret_mode(desc.copy(interpret=True)) is True


@pytest.mark.parametrize("name,interpret,expected", [
    ("default", False, "BF16_BF16_F32_X3"),
    ("bf16_3x", False, "BF16_BF16_F32_X3"),
    ("tf32_3x", False, "TF32_TF32_F32_X3"),
    ("tf32_3x", True, "HIGHEST"),
    ("highest", False, "HIGHEST"),
])
def test_kernel_dot_precision(name, interpret, expected):
    desc = f.ScheduleDescriptor(backend="pallas", precision=name)
    got = _dot_precision(desc, np.dtype("float32"), interpret)
    assert getattr(got, "name", str(got)) == expected


def test_kernel_refuses_what_it_cannot_lower():
    e64 = dg_class("mass", 8, "float64")
    prog = f.generate_program(e64).with_descriptor(backend="pallas")
    with pytest.raises(InvalidParameterError, match="xla backend"):
        f.build_executable(prog, long_dim_length=256)
    e = dg_class("mass", 8)
    prog = f.generate_program(e).with_descriptor(backend="pallas",
                                                 grid_index=("e", "i"))
    with pytest.raises(InvalidParameterError, match="multi-axis"):
        f.build_executable(prog, long_dim_length=256)
    prog = f.generate_program(e).with_descriptor(backend="pallas",
                                                 precision="bogus")
    with pytest.raises(InvalidParameterError, match="precision"):
        f.build_executable(prog, long_dim_length=256)


def test_split_rows_and_fused_rows_agree():
    e = dg_class("div", 10)
    fused = default_pallas_program(f.generate_program(e))
    split = fused.with_descriptor(multiple_results_in_one_kernel=False)
    from feinsum_tpu.measure import generate_input_arrays
    arrays = f.apply_layouts(fused, generate_input_arrays(
        e, long_dim_length=300))
    a = f.build_executable(fused, long_dim_length=300)(arrays)
    b = f.build_executable(split, long_dim_length=300)(arrays)
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                   rtol=1e-6, atol=1e-6)


def test_default_schedule_prereduces_curl():
    """curl's D is summed over its private r in XLA, so the kernel runs one
    dot per row instead of a resident x streamed outer product."""
    prog = default_pallas_program(f.generate_program(dg_class("curl", 35)))
    assert any(s.endswith("->ij") for s in prog.schedule.subscripts)
    prog = default_pallas_program(f.generate_program(dg_class("grad", 35)))
    assert prog.schedule.nsteps == 2
