"""The folded long-axis layout (descriptor.fold_long): stored-layout plumbing,
emitter correctness on every suite family, and the InvalidParameterError
guards.  Runs in Pallas interpret mode on CPU (the POCL-analog path,
reference test strategy SURVEY.md SS4)."""

import numpy as np
import pytest

import feinsum_tpu as f
from feinsum_tpu.diagnostics import InvalidParameterError
from feinsum_tpu.tuning.impls._common import fused_pallas_program

NDOF = 35


def suite():
    return {
        "matvec": f.einsum("ej,ij->ei",
                           f.array("u", ("E", 20), "float32"),
                           f.array("D", (20, 20), "float32")),
        "mass": f.einsum("e,ij,ej->ei",
                         f.array("jac", ("E",), "float32"),
                         f.array("M", (NDOF, NDOF), "float32"),
                         f.array("u", ("E", NDOF), "float32")),
        "grad": f.einsum("xre,rij,ej->xei",
                         f.array("J", (3, 3, "E"), "float32"),
                         f.array("D", (3, NDOF, NDOF), "float32"),
                         f.array("u", ("E", NDOF), "float32")),
        "div": f.batched_einsum(
            "es,sij,ej->ei",
            [[f.array(jn, ("E", 3), "float32"),
              f.array("R", (3, NDOF, NDOF), "float32"),
              f.array(un, ("E", NDOF), "float32")]
             for jn, un in [("Jx", "ux"), ("Jy", "uy"), ("Jz", "uz")]]),
        "face": f.einsum("ifj,fe,fej->ei",
                         f.array("L", (NDOF, 4, 15), "float32"),
                         f.array("Fj", (4, "E"), "float32"),
                         f.array("flux", (4, "E", 15), "float32")),
        "copy": f.einsum("ij,ij->ij",
                         f.array("A", ("E", NDOF), "float32"),
                         f.array("B", ("E", NDOF), "float32")),
    }


@pytest.mark.parametrize("name", sorted(suite()))
@pytest.mark.parametrize("hoist", [False, True])
def test_fold_validates_against_numpy(name, hoist):
    ens = suite()[name]

    def tr(program):
        return fused_pallas_program(program, block_long=256, hoist=hoist,
                                    dofmajor=True, fold=True)
    f.validate_batched_einsum_transform(ens, tr, long_dim_length=4096)


def test_fold_output_is_stored_folded():
    ens = suite()["matvec"]

    def tr(program):
        return fused_pallas_program(program, block_long=256, hoist=False,
                                    dofmajor=True, fold=True)
    prog = tr(f.generate_program(ens))
    from feinsum_tpu.measure import _apply_layouts, generate_input_arrays
    E = 2048
    arrays = _apply_layouts(prog, generate_input_arrays(
        ens, long_dim_length=E))
    assert arrays["u"].shape == (20, 8, E // 8)
    fn = f.build_executable(prog, long_dim_length=E)
    (out,) = fn(arrays)
    assert out.shape == (20, 8, E // 8)
    # semantic: out[i, s, c] corresponds to logical element e = s*(E/8)+c
    logical_u = np.asarray(arrays["u"]).reshape(20, E)
    ref = np.einsum("ij,je->ie", np.asarray(arrays["D"], np.float64),
                    logical_u.astype(np.float64)).reshape(20, 8, E // 8)
    np.testing.assert_allclose(np.asarray(out, np.float64), ref,
                               rtol=2e-5, atol=2e-5 * np.abs(ref).max())


def test_fold_requires_dofmajor():
    ens = suite()["matvec"]
    with pytest.raises(InvalidParameterError):
        fused_pallas_program(f.generate_program(ens), block_long=256,
                             hoist=False, dofmajor=False, fold=True)


def test_fold_rejects_non_trailing_long_axis():
    ens = suite()["matvec"]
    prog = f.generate_program(ens).with_descriptor(
        backend="pallas", fold_long=8, block_long=256)
    # no dof-major layouts: u is stored (E, 20) with the long axis leading
    with pytest.raises(InvalidParameterError):
        f.build_executable(prog, long_dim_length=4096)


def test_fold_validation_rounds_odd_lengths():
    # default validation length (100) is not divisible by 8; the validator
    # rounds it up instead of failing
    ens = suite()["mass"]

    def tr(program):
        return fused_pallas_program(program, block_long=256, hoist=False,
                                    dofmajor=True, fold=True)
    f.validate_batched_einsum_transform(ens, tr, long_dim_length=100)


def test_fold_xla_backend_matches():
    ens = suite()["grad"]

    def tr(program):
        p = fused_pallas_program(program, block_long=256, hoist=True,
                                 dofmajor=True, fold=True)
        return p.with_descriptor(backend="xla")
    f.validate_batched_einsum_transform(ens, tr, long_dim_length=4096)


def test_fold_tuning_space_point_roundtrips(tmp_path):
    """A fold=True point recorded by the tuner replays identically, and an
    old-style row without the fold key replays with the default."""
    from feinsum_tpu import sql_utils
    from feinsum_tpu.tuning import get_transform_func_from_module_path

    ens = suite()["matvec"]
    db = str(tmp_path / "t.sqlite")
    space = get_transform_func_from_module_path("mass_v0")
    params = {"log2_block": 8, "dofmajor": True, "fold": True,
              "parallel_grid": True}
    tr = space.bind_args(ens, **params)
    f.validate_batched_einsum_transform(ens, tr, long_dim_length=4096)
    sql_utils.record_facts(ens, transform_id="mass_v0.py",
                           transform_params=params, runtime_in_sec=1e-3,
                           db_path=db, long_dim_length=4096)
    (q,) = sql_utils.query(ens, db_path=db)
    assert dict(q.transform_params)["fold"] is True
    f.validate_batched_einsum_transform(ens, q.transform,
                                        long_dim_length=4096)
    # old-style params without 'fold'
    old = space.bind_args(ens, log2_block=8, dofmajor=True,
                          parallel_grid=True)
    f.validate_batched_einsum_transform(ens, old, long_dim_length=4096)


def test_fold_guards_tiny_c_blocks():
    """The folded layout is a free view of the dof-major buffer, so a block
    much shorter than the folded c axis (32 of 1024 here) needs no guard:
    it builds and matches the oracle."""
    ens = suite()["matvec"]

    def tr(program):
        return fused_pallas_program(program, block_long=256, hoist=False,
                                    dofmajor=True, fold=True)
    f.validate_batched_einsum_transform(ens, tr, long_dim_length=8192)


def test_unpack_output_inverts_each_contract():
    """unpack_output is the exact inverse of every output storage contract
    (used by compile_fn_with_archive to deliver logical outputs)."""
    import numpy as np
    import feinsum_tpu as f
    from feinsum_tpu.ops.layouts import unpack_output

    rng = np.random.default_rng(0)
    E, d = 64, 8
    logical = rng.random((E, d), np.float32)

    # out_layout (dof-major transpose)
    e = f.einsum("ej,ij->ei", f.array("u", ("E", d), "float32"),
                 f.array("D", (d, d), "float32"))
    p = f.generate_program(e).with_descriptor(out_layout=(1, 0))
    assert np.array_equal(
        unpack_output(p, logical.T.copy(), (E, d)), logical)

    # out_layout + fold (stored (d, 8, E/8))
    p = f.generate_program(e).with_descriptor(
        backend="pallas", out_layout=(1, 0), fold_long=8,
        arg_layouts=(("u", (1, 0)),))
    stored = logical.T.reshape(d, 8, E // 8)
    assert np.array_equal(unpack_output(p, stored, (E, d)), logical)

    # lane_pack (packed (E/g, g*d))
    p = f.generate_program(e).with_descriptor(lane_pack=4)
    assert np.array_equal(
        unpack_output(p, logical.reshape(E // 4, 4 * d), (E, d)), logical)

    # lane_pack 1D output (vecmat): (E,) stored (E/g, g)
    vec = rng.random((E,), np.float32)
    p = f.generate_program(e).with_descriptor(lane_pack=8)
    assert np.array_equal(
        unpack_output(p, vec.reshape(E // 8, 8), (E,)), vec)

    # pre_out_layout (grouped 2D of a rank-3 logical output)
    lg3 = rng.random((4, 6, 5), np.float32)
    p = f.generate_program(e).with_descriptor(
        pre_out_layout=((2, 0), (1,)))
    stored = lg3.transpose(2, 0, 1).reshape(20, 6)
    assert np.array_equal(unpack_output(p, stored, (4, 6, 5)), lg3)

    # shape mismatch is an error, not a silent reshape
    import pytest
    p = f.generate_program(e).with_descriptor()
    with pytest.raises(ValueError, match="does not match"):
        unpack_output(p, logical, (E, d + 1))


def test_public_apply_layouts_unpack_output_roundtrip():
    """The public consumer pair (f.apply_layouts / f.unpack_output): replay
    a storage-contract champion by hand — pack logical inputs, run the
    executable, unpack the stored output back to the logical shape."""
    E, d = 128, 8
    e = f.einsum("es,sij,ej->ei",
                 f.array("J", ("E", 3), "float32"),
                 f.array("R", (3, d, d), "float32"),
                 f.array("u", ("E", d), "float32"))
    prog = fused_pallas_program(
        f.generate_program(e), block_long=E, hoist=False,
        dofmajor=True, fold=True)
    fn = f.build_executable(prog, long_dim_length=E)
    from feinsum_tpu.measure import generate_input_arrays
    arrs = generate_input_arrays(e, long_dim_length=E, as_numpy=True)
    out = fn(f.apply_layouts(prog, arrs))
    got = f.unpack_output(
        prog, out[0] if isinstance(out, (list, tuple)) else out, (E, d))
    ref = np.einsum("es,sij,ej->ei", arrs["J"], arrs["R"], arrs["u"])
    assert np.allclose(np.asarray(got), ref, rtol=2e-5, atol=2e-5)
