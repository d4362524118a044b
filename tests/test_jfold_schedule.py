"""The jfold (outer-product-first) schedule rewrite: streamed operands
multiply into one intermediate, residents contract in one
accumulated dot per row, and resident-private indices pre-reduce (the curl fix — opt_einsum's
literal pairwise path materializes a (ndof,ndof,E) intermediate there)."""

import pytest

import feinsum_tpu as f
from feinsum_tpu.diagnostics import InvalidParameterError
from feinsum_tpu.tuning.impls._common import fused_pallas_program

from test_fold_layout import suite


def curl_einsum():
    return f.batched_einsum(
        "e,rij,ej->ei",
        [[f.array(j, ("E",), "float32"),
          f.array("D", (3, 35, 35), "float32"),
          f.array(u, ("E", 35), "float32")]
         for j, u in [("Jy", "uz"), ("Jz", "ux"), ("Jx", "uy")]])


def tr_jfold(**kw):
    def tr(p):
        return fused_pallas_program(
            p, block_long=256, hoist=False, dofmajor=True, jfold=True,
            **kw)
    return tr


def test_jfold_schedule_shapes():
    div_prog = tr_jfold()(f.generate_program(suite()["div"]))
    assert div_prog.schedule.subscripts == ("es,ej->esj", "esj,sij->ei")
    grad_prog = tr_jfold()(f.generate_program(suite()["grad"]))
    assert grad_prog.schedule.subscripts == ("xre,ej->xrej", "xrej,rij->xei")
    # resident-private index r pre-reduces: curl becomes mass-shaped
    curl_prog = tr_jfold()(f.generate_program(curl_einsum()))
    assert curl_prog.schedule.subscripts == (
        "rij->ij", "e,ej->ej", "ej,ij->ei")
    face_prog = tr_jfold()(f.generate_program(suite()["face"]))
    assert face_prog.schedule.subscripts == ("fe,fej->fej", "fej,ifj->ei")


@pytest.mark.parametrize("name", ["div", "grad", "face"])
@pytest.mark.parametrize("fold", [False, True])
def test_jfold_validates_against_numpy(name, fold):
    ens = suite()[name]
    f.validate_batched_einsum_transform(
        ens, tr_jfold(fold=fold, preblock=(name != "face")),
        long_dim_length=4096)


@pytest.mark.parametrize("fold", [False, True])
def test_jfold_curl_validates(fold):
    f.validate_batched_einsum_transform(
        curl_einsum(), tr_jfold(fold=fold), long_dim_length=4096)


def test_jfold_requires_streamed_and_resident_operands():
    # copy: every operand streams, none resident
    with pytest.raises(InvalidParameterError):
        tr_jfold()(f.generate_program(suite()["copy"]))
    # matvec: only one streamed operand
    with pytest.raises(InvalidParameterError):
        tr_jfold()(f.generate_program(suite()["matvec"]))


def test_jfold_space_point_roundtrips(tmp_path):
    from feinsum_tpu import sql_utils
    from feinsum_tpu.tuning import get_transform_func_from_module_path

    ens = suite()["div"]
    db = str(tmp_path / "t.sqlite")
    space = get_transform_func_from_module_path("dg_div_v0")
    params = {"log2_block": 8, "dofmajor": True, "fold": True,
              "preblock": True, "precision_3x": True, "jfold": True,
              "hoist": True, "parallel_grid": True}
    tr = space.bind_args(ens, **params)
    f.validate_batched_einsum_transform(ens, tr, long_dim_length=4096)
    sql_utils.record_facts(ens, transform_id="dg_div_v0.py",
                           transform_params=params, runtime_in_sec=1e-3,
                           db_path=db, long_dim_length=4096)
    (q,) = sql_utils.query(ens, db_path=db)
    assert dict(q.transform_params)["jfold"] is True
    f.validate_batched_einsum_transform(ens, q.transform,
                                        long_dim_length=4096)


def test_hoist_resident_steps_curl_prereduce():
    """prereduce('rij->ij') with hoist_resident_steps=True evaluates the
    resident reduction in XLA outside the kernel, once per launch; results
    must match numpy, and
    the A/B knob must change the program but not the numerics."""
    ndof = 6
    curl = f.batched_einsum(
        "e,rij,ej->ei",
        [[f.array(j, ("E",), "float32"),
          f.array("D", (3, ndof, ndof), "float32"),
          f.array(u, ("E", ndof), "float32")]
         for j, u in [("Jy", "uz"), ("Jz", "ux"), ("Jx", "uy")]])

    for host in (True, False):
        def tr(program, host=host):
            return fused_pallas_program(
                program, block_long=64, hoist=False, dofmajor=True,
                prereduce=True, host_hoist=host)
        f.validate_batched_einsum_transform(curl, tr, long_dim_length=256)


def test_hoist_resident_steps_jfold_div():
    """div's jfold schedule prereduces nothing but extracts resident-only
    contraction steps on some paths; hoisting must stay numerically exact."""
    ens = suite()["div"]

    def tr(program):
        return fused_pallas_program(program, block_long=128, hoist=True,
                                    dofmajor=True, jfold=True,
                                    host_hoist=True)
    f.validate_batched_einsum_transform(ens, tr, long_dim_length=512)


def test_split_rows_matches_fused():
    """multiple_results_in_one_kernel=False (split_rows) builds one kernel
    per batch row; outputs must equal the fused kernel's."""
    import numpy as np
    from feinsum_tpu.measure import (_apply_layouts, generate_input_arrays)

    ens = suite()["div"]

    def tr(split):
        def t(program):
            return fused_pallas_program(
                program, block_long=128, hoist=True, dofmajor=True,
                split_rows=split)
        return t
    f.validate_batched_einsum_transform(ens, tr(True), long_dim_length=512)

    p_fused = tr(False)(f.generate_program(ens))
    p_split = tr(True)(f.generate_program(ens))
    arrays = _apply_layouts(
        p_fused, generate_input_arrays(ens, long_dim_length=512))
    outs_f = f.build_executable(p_fused, long_dim_length=512)(arrays)
    outs_s = f.build_executable(p_split, long_dim_length=512)(arrays)
    assert len(outs_f) == len(outs_s) == 3
    for a, b in zip(outs_f, outs_s):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-6, atol=1e-6)
