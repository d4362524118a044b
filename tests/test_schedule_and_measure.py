"""Schedules, flop counting, codegen (XLA backend), and measurement —
modeled on the reference's test_codegen.py/test_measure.py coverage, with the
exact-flop assertions from test_loopy_utils.py:267-271."""

import numpy as np
import pytest

import feinsum_tpu as f
from feinsum_tpu.measure import (
    evaluate_giga_op_map,
    generate_input_arrays,
    get_giga_op_map,
)


def dg_grad(ndim=3, ndof=35, dtype="float64"):
    return f.einsum("xre,rij,ej->xei",
                    f.array("J", (ndim, ndim, "E"), dtype),
                    f.array("D", (ndim, ndof, ndof), dtype),
                    f.array("u", ("E", ndof), dtype))


def test_trivial_schedule():
    e = dg_grad()
    s = f.get_trivial_contraction_schedule(e)
    assert s.nsteps == 1
    assert s.result_names == ("_fe_out",)
    assert s.subscripts == ("xre,rij,ej->xei",)


def test_opt_einsum_schedule_reduces_flops():
    e = dg_grad()
    trivial = get_giga_op_map(e, f.get_trivial_contraction_schedule(e))
    opt = get_giga_op_map(e)  # defaults to opt_einsum schedule
    n = 1  # per-element comparison: evaluate at E=1
    t = sum(evaluate_giga_op_map(trivial, n).values()) * 1e9
    o = sum(evaluate_giga_op_map(opt, n).values()) * 1e9
    # reference asserts 33075 -> 7980 per element (4.14x cut)
    assert t == pytest.approx(33075)
    assert o == pytest.approx(7980)


def test_flop_poly_is_symbolic_in_E():
    e = dg_grad()
    gmap = get_giga_op_map(e, f.get_trivial_contraction_schedule(e))
    val = evaluate_giga_op_map(gmap, 1000)
    assert sum(val.values()) * 1e9 == pytest.approx(33075 * 1000)


def test_xla_backend_matches_numpy_trivial_and_opt():
    e = dg_grad(ndof=10)
    f.validate_batched_einsum_transform(e, None, long_dim_length=50)
    f.validate_batched_einsum_transform(
        e, lambda p: f.generate_program_with_opt_einsum_schedule(p.einsum),
        long_dim_length=50)


def test_xla_backend_batched_rows():
    e = f.batched_einsum(
        "es,sij,ej->ei",
        [[f.array("Jx", ("E", 3)), f.array("R", (3, 20, 20)),
          f.array("ux", ("E", 20))],
         [f.array("Jy", ("E", 3)), f.array("R", (3, 20, 20)),
          f.array("uy", ("E", 20))]])
    f.validate_batched_einsum_transform(e, None, long_dim_length=40)


def test_validation_catches_wrong_transform():
    e = dg_grad(ndof=5)

    def bad_transform(p):
        # compute a *different* einsum: drop the Jacobian factor
        wrong = f.einsum("rij,ej->rei",
                         f.array("D", (3, 5, 5)), f.array("u", ("E", 5)))
        return f.generate_program(wrong)

    with pytest.raises(Exception):
        f.validate_batched_einsum_transform(e, bad_transform,
                                            long_dim_length=30)


def test_mixed_dtype_promotion():
    e = f.einsum("ij,jk->ik",
                 f.array("A", (8, 8), "float32"),
                 f.array("B", (8, 8), "float64"))
    f.validate_batched_einsum_transform(e, None, long_dim_length=8)
    gmap = get_giga_op_map(e, f.get_trivial_contraction_schedule(e))
    assert set(gmap) == {"float64"}


def test_timeit_smoke():
    e = dg_grad(ndof=10, dtype="float32")
    t = f.timeit(e, long_dim_length=500, min_rounds=5, min_seconds=0.05)
    assert 0 < t < 5.0


def test_measure_giga_op_rate_smoke():
    e = dg_grad(ndof=10, dtype="float32")
    rates = f.measure_giga_op_rate(e, long_dim_length=500, min_rounds=5,
                                   min_seconds=0.05)
    assert rates["total"] > 0


def test_roofline():
    e = dg_grad(ndof=35)
    r = f.get_roofline_flop_rate(e, "NVIDIA TITAN V")
    assert r is not None and 0 < r <= 6144.0
    with pytest.raises(f.NoDevicePeaksInfoError):
        f.get_roofline_flop_rate(e, "bogus device")


def test_stringify_comparison_smoke():
    e = dg_grad(ndof=10, dtype="float32")
    s = f.stringify_comparison_vs_roofline(
        e, long_dim_length=500, min_rounds=5, min_seconds=0.05,
        device_name="NVIDIA H100 80GB HBM3")
    assert "measured" in s


def test_stringify_comparison_accepts_device_object():
    # the reference passes a cl_device object; ours accepts anything with a
    # .name (e.g. FakeDevice) via the `device` kwarg
    e = dg_grad(ndof=10, dtype="float32")
    s = f.stringify_comparison_vs_roofline(
        e, device=f.FakeDevice("NVIDIA H100 80GB HBM3"),
        long_dim_length=500, min_rounds=5, min_seconds=0.05)
    assert "% roofline" in s and "unknown" not in s


def test_complex_dtypes_validate_end_to_end():
    # reference measure.py:63-108 generates complex inputs and weights
    # complex ops (mul=6, add=2); our XLA backend executes complex einsums
    for dt in ("complex64", "complex128"):
        e = f.einsum("ej,ij->ei", f.array("u", ("E", 8), dt),
                     f.array("D", (8, 8), dt))
        f.validate_batched_einsum_transform(e, None, long_dim_length=512)
        gmap = f.get_giga_op_map(e)
        assert set(gmap) == {dt}


def test_footprint():
    e = f.einsum("ej,ij->ei", f.array("u", ("E", 10), "float64"),
                 f.array("D", (10, 10), "float64"))
    gb = f.get_footprint_gbytes(e, long_dim_length=1000)
    expected = (1000 * 10 * 8 + 10 * 10 * 8 + 1000 * 10 * 8) * 1e-9
    assert gb == pytest.approx(expected)


def test_input_arrays_respect_dtype():
    e = f.einsum("ij,jk->ik",
                 f.array("A", (4, 5), "complex64"),
                 f.array("B", (5, 6), "int32"))
    arrs = generate_input_arrays(e, long_dim_length=10, as_numpy=True)
    assert arrs["A"].dtype == np.complex64
    assert arrs["B"].dtype == np.int32


def test_write_gbytes_and_write_ceiling_roofline():
    """get_write_gbytes counts output bytes only; the roofline of an
    expansion einsum is set by its total bytes over the H100's 3350 GB/s
    (the device table holds no separate write ceiling)."""
    from feinsum_tpu.measure import (
        get_footprint_gbytes,
        get_roofline_flop_rate,
        get_write_gbytes,
    )

    # expansion: tiny inputs, big output
    e = f.einsum("i,j,k->ijk",
                 f.array("a", (64,), "float32"),
                 f.array("b", (64,), "float32"),
                 f.array("c", (64,), "float32"))
    w = get_write_gbytes(e, long_dim_length=100)
    total = get_footprint_gbytes(e, long_dim_length=100)
    assert abs(w - 64 ** 3 * 4e-9) < 1e-12
    assert abs(total - (w + 3 * 64 * 4e-9)) < 1e-12
    from feinsum_tpu.measure import evaluate_giga_op_map, get_giga_op_map
    gops = sum(evaluate_giga_op_map(get_giga_op_map(e), 100).values())
    roof = get_roofline_flop_rate(e, "NVIDIA H100 80GB HBM3",
                                  long_dim_length=100)
    assert abs(roof - gops / (total / 3350.0)) < 1e-6 * roof


def test_profile_program_smoke():
    """profile_program returns per-op spans (or an explanatory None) on the
    CPU backend without raising."""
    from feinsum_tpu.measure import profile_program

    e = f.einsum("ej,ij->ei", f.array("u", ("E", 8), "float32"),
                 f.array("D", (8, 8), "float32"))
    prog = f.generate_program(e)
    try:
        out = profile_program(prog, long_dim_length=256)
    except Exception as ex:  # noqa: BLE001 — must not raise blindly
        raise AssertionError(f"profile_program raised {type(ex).__name__}")
    assert out is None or out
