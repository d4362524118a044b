"""The pre-blocked tile-exact layout (descriptor.preblock_args): small
streamed args (DG Jacobians (3,E)/(3,3,E), mass jacobians (E,), face flux
factors (4,E)) stored (nb, *small, 8, blk_c) so every block exact-tiles HBM.
Runs in Pallas interpret mode on CPU (SURVEY.md SS4 strategy)."""

import numpy as np
import pytest

import feinsum_tpu as f
from feinsum_tpu.diagnostics import InvalidParameterError
from feinsum_tpu.ops.layouts import preblock_small_args
from feinsum_tpu.tuning.impls._common import fused_pallas_program

from test_fold_layout import suite


def test_preblock_small_args_selection():
    s = suite()
    assert preblock_small_args(s["div"]) == ("Jx", "Jy", "Jz")
    assert preblock_small_args(s["grad"]) == ("J",)
    assert preblock_small_args(s["mass"]) == ("jac",)
    assert preblock_small_args(s["face"]) == ("Fj",)
    # every row of u/copy operands is wide (35/20) or 8-divisible:
    # nothing qualifies
    assert preblock_small_args(s["matvec"]) == ()
    assert preblock_small_args(s["copy"]) == ()


@pytest.mark.parametrize("name", ["div", "grad", "mass", "face"])
@pytest.mark.parametrize("fold", [False, True])
def test_preblock_validates_against_numpy(name, fold):
    ens = suite()[name]

    def tr(program):
        return fused_pallas_program(program, block_long=256, hoist=True,
                                    dofmajor=True, fold=fold, preblock=True)
    f.validate_batched_einsum_transform(ens, tr, long_dim_length=4096)


@pytest.mark.parametrize("length", [1999, 3000, 2500])
def test_preblock_pads_partial_tails(length):
    """Lengths not divisible by the block (or even by 8) zero-pad the
    pre-blocked storage and the kernel crops the tail; results stay exact.

    Deliberately bypasses validate_batched_einsum_transform, which rounds
    long_dim_length up to a block multiple and would never exercise the
    pad/crop paths (advisor finding, ADVICE.md r1) — build the executable
    directly at the odd length and compare against numpy."""
    from feinsum_tpu.measure import (
        _apply_layouts, _numpy_oracle, generate_input_arrays)

    ens = suite()["div"]
    prog = fused_pallas_program(f.generate_program(ens), block_long=256,
                                hoist=True, dofmajor=True, preblock=True)
    raw = generate_input_arrays(ens, long_dim_length=length, as_numpy=True)
    arrays = _apply_layouts(prog, {k: np.asarray(v) for k, v in raw.items()})
    # the pre-blocked Jacobian really is padded: storage covers a block
    # multiple strictly greater than the requested length
    nb = arrays["Jx"].shape[0]
    assert nb * 1024 > length
    fn = f.build_executable(prog, long_dim_length=length)
    outs = fn(arrays)
    refs = _numpy_oracle(ens, raw)
    inv = np.argsort(prog.descriptor.out_layout)
    for out, ref in zip(outs, refs):
        got = np.transpose(np.asarray(out, np.float64), inv)
        np.testing.assert_allclose(got, ref, rtol=2e-5,
                                   atol=2e-5 * np.abs(ref).max())


def test_preblock_storage_shape_and_semantics():
    ens = suite()["mass"]

    def tr(program):
        return fused_pallas_program(program, block_long=256, hoist=False,
                                    dofmajor=True, preblock=True)
    prog = tr(f.generate_program(ens))
    from feinsum_tpu.measure import _apply_layouts, generate_input_arrays
    E = 4096
    arrays = _apply_layouts(prog, generate_input_arrays(
        ens, long_dim_length=E))
    # jac (E,) -> (nb=16, 8, 32): block g holds elements [g*256, (g+1)*256)
    assert arrays["jac"].shape == (16, 8, 32)
    flat = np.asarray(arrays["jac"]).reshape(16 * 256)
    raw = generate_input_arrays(ens, long_dim_length=E, as_numpy=True)
    np.testing.assert_array_equal(flat, raw["jac"])
    # executable consumes the pre-blocked jac and matches numpy
    fn = f.build_executable(prog, long_dim_length=E)
    (out,) = fn(arrays)
    ref = np.einsum("e,ij,je->ie", raw["jac"].astype(np.float64),
                    raw["M"].astype(np.float64),
                    np.asarray(arrays["u"], np.float64))
    np.testing.assert_allclose(np.asarray(out, np.float64), ref,
                               rtol=2e-5, atol=2e-5 * np.abs(ref).max())


def test_preblock_requires_dofmajor():
    with pytest.raises(InvalidParameterError):
        fused_pallas_program(f.generate_program(suite()["div"]),
                             block_long=256, hoist=True,
                             dofmajor=False, preblock=True)


def test_preblock_rejects_unqualified_einsums():
    with pytest.raises(InvalidParameterError):
        fused_pallas_program(f.generate_program(suite()["copy"]),
                             block_long=256, hoist=False,
                             dofmajor=True, preblock=True)


def test_preblock_rejects_xla_backend():
    prog = f.generate_program(suite()["div"]).with_descriptor(
        backend="xla", preblock_args=("Jx",))
    with pytest.raises(InvalidParameterError):
        f.build_executable(prog, long_dim_length=4096)


def test_preblock_rejects_unknown_and_nontrailing_args():
    base = fused_pallas_program(f.generate_program(suite()["div"]),
                                block_long=256, hoist=True,
                                dofmajor=True)
    with pytest.raises(InvalidParameterError):
        f.build_executable(base.with_descriptor(preblock_args=("nope",)),
                           long_dim_length=4096)
    # long axis not stored trailing (no dof-major perm on Jx)
    plain = f.generate_program(suite()["div"]).with_descriptor(
        backend="pallas", block_long=256, preblock_args=("Jx",))
    with pytest.raises(InvalidParameterError):
        f.build_executable(plain, long_dim_length=4096)


def test_preblock_tuning_space_point_roundtrips(tmp_path):
    """A preblock=True point recorded by the tuner replays identically; an
    old-style row without the key replays with the default."""
    from feinsum_tpu import sql_utils
    from feinsum_tpu.tuning import get_transform_func_from_module_path

    ens = suite()["div"]
    db = str(tmp_path / "t.sqlite")
    space = get_transform_func_from_module_path("dg_div_v0")
    params = {"log2_block": 8, "dofmajor": True, "fold": False,
              "preblock": True, "precision_3x": True, "hoist": True,
              "parallel_grid": True}
    tr = space.bind_args(ens, **params)
    f.validate_batched_einsum_transform(ens, tr, long_dim_length=4096)
    sql_utils.record_facts(ens, transform_id="dg_div_v0.py",
                           transform_params=params, runtime_in_sec=1e-3,
                           db_path=db, long_dim_length=4096)
    (q,) = sql_utils.query(ens, db_path=db)
    assert dict(q.transform_params)["preblock"] is True
    f.validate_batched_einsum_transform(ens, q.transform,
                                        long_dim_length=4096)
    # old-style params without the new keys
    old = space.bind_args(ens, log2_block=8, dofmajor=True, hoist=True,
                          parallel_grid=True)
    f.validate_batched_einsum_transform(ens, old, long_dim_length=4096)
