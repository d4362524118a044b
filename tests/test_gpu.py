"""Tests that only the card can run: the Pallas kernel compiled through
Triton (no interpret mode), the split-precision dots, and the host-clock
timer against the card's bandwidth floor.  They skip elsewhere; on the card
chip_smoke.py runs them in its own process (``pytest -m gpu``)."""

import numpy as np
import pytest

import feinsum_tpu as f

pytestmark = pytest.mark.gpu


def _grad(ndof=10):
    return f.einsum("xre,rij,ej->xei",
                    f.array("J", (3, 3, "E"), "float32"),
                    f.array("D", (3, ndof, ndof), "float32"),
                    f.array("u", ("E", ndof), "float32"))


def _kernel(einsum, **desc):
    from feinsum_tpu.tuning.impls._common import default_pallas_program
    return default_pallas_program(f.generate_program(einsum)
                                  ).with_descriptor(**desc)


def test_kernel_is_compiled_not_interpreted(gpu):
    from feinsum_tpu.ops.pallas_emitter import interpret_mode
    e = _grad()
    prog = _kernel(e)
    assert interpret_mode(prog.descriptor) is False
    import jax
    from feinsum_tpu.measure import generate_input_arrays
    arrays = f.apply_layouts(prog, generate_input_arrays(
        e, long_dim_length=4096))
    hlo = f.build_executable(prog, long_dim_length=4096).lower(
        arrays).as_text()
    assert "triton" in hlo.lower()
    f.validate_batched_einsum_transform(e, lambda p: _kernel(p.einsum),
                                        long_dim_length=4096)
    del jax


@pytest.mark.parametrize("precision", ["bf16_3x", "tf32_3x", "highest"])
def test_kernel_precisions_meet_the_f32_oracle(gpu, precision):
    e = _grad(35)
    f.validate_batched_einsum_transform(
        e, lambda p: _kernel(p.einsum, precision=precision),
        long_dim_length=5000)


def test_timer_is_above_the_bandwidth_floor(gpu):
    from feinsum_tpu.measure import (_bytes_floor_seconds,
                                     generate_input_arrays, timeit_on_device)
    e = _grad(35)
    prog = _kernel(e)
    arrays = f.apply_layouts(prog, generate_input_arrays(
        e, long_dim_length=200_000))
    fn = f.build_executable(prog, long_dim_length=200_000)
    dt = timeit_on_device(fn, arrays)
    assert dt >= _bytes_floor_seconds(arrays, fn(arrays))
    assert np.isfinite(dt) and dt < 1.0


@pytest.mark.parametrize("precision", ["bf16_3x", "tf32_3x"])
def test_xla_split_precisions_run_on_the_card(gpu, precision):
    """The XLA backend names the split dot algorithms explicitly on the
    card; they must compile and meet the f32 oracle."""
    e = _grad(35)
    f.validate_batched_einsum_transform(
        e, lambda p: f.generate_program_with_opt_einsum_schedule(
            p.einsum).with_descriptor(precision=precision),
        long_dim_length=5000)
