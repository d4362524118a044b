"""The lane_pack rewrite (descriptor.lane_pack): g elements share one packed
dof row — the small-dof matvec-class answer to the reference's n_e_per_wg
element packing (reference tuning/impls/xre_rij_xej_to_ei_v4.py:41-114;
VERDICT r2 next #3)."""

import numpy as np
import pytest

import feinsum_tpu as f
from feinsum_tpu.diagnostics import InvalidParameterError
from feinsum_tpu.tuning import (
    IntParameter,
    get_transform_func_from_module_path,
)
from feinsum_tpu.tuning.impls._common import lane_packable, rewrite_lane_pack


def matvec(ndof=20, dtype="float32"):
    return f.einsum("ej,ij->ei", f.array("u", ("E", ndof), dtype),
                    f.array("D", (ndof, ndof), dtype))


def test_lane_pack_validates_against_oracle():
    sp = get_transform_func_from_module_path("mass_v0")
    e = matvec()
    for kwargs in (dict(dofmajor=False, lane_pack_g=1),
                   dict(dofmajor=False, lane_pack_g=2),
                   dict(dofmajor=True, lane_pack_g=2)):
        tr = sp.bind_args(e, log2_block=6, parallel_grid=True, **kwargs)
        f.validate_batched_einsum_transform(e, tr, long_dim_length=2048)


def test_lane_pack_rect_and_transposed_resident():
    sp = get_transform_func_from_module_path("mass_v0")
    rect = f.einsum("ej,ij->ei", f.array("u", ("E", 16), "float32"),
                    f.array("D", (8, 16), "float32"))
    tr = sp.bind_args(rect, log2_block=6, dofmajor=True, parallel_grid=True,
                      lane_pack_g=3)
    f.validate_batched_einsum_transform(rect, tr, long_dim_length=2048)
    tr_ji = f.einsum("ej,ji->ei", f.array("u", ("E", 16), "float32"),
                     f.array("D", (16, 8), "float32"))
    tr = sp.bind_args(tr_ji, log2_block=6, dofmajor=True,
                      parallel_grid=True, lane_pack_g=2)
    f.validate_batched_einsum_transform(tr_ji, tr, long_dim_length=2048)


def test_lane_pack_gates_by_class():
    sp = get_transform_func_from_module_path("dg_div_v0")
    div = f.batched_einsum(
        "es,sij,ej->ei",
        [[f.array(j, ("E", 3), "float32"),
          f.array("R", (3, 5, 5), "float32"),
          f.array(u, ("E", 5), "float32")]
         for j, u in [("Jx", "ux"), ("Jy", "uy"), ("Jz", "uz")]])
    p = sp.get_param_space(div)["lane_pack_g"]
    # r4: the DG variant opened the gate for the div class too
    assert isinstance(p, IntParameter) and p.high == 5
    rowsum = f.einsum("ej->e", f.array("A", ("E", 35), "float32"))
    assert lane_packable(rowsum) is None        # single operand: no resident
    p0 = sp.get_param_space(rowsum)["lane_pack_g"]
    assert p0.high == 0                          # still gated off
    assert lane_packable(matvec()) is not None
    p2 = sp.get_param_space(matvec())["lane_pack_g"]
    assert p2.high == 5


def test_lane_pack_rejects_misaligned_g():
    # g*d must be 8-aligned: ndof 35 with g=2 -> 70 % 8 != 0
    prog = f.generate_program(matvec(35))
    with pytest.raises(InvalidParameterError, match="8-aligned"):
        rewrite_lane_pack(prog, 2)
    p2, extras = rewrite_lane_pack(prog, 8)      # 280 % 8 == 0
    assert extras["lane_pack"] == 8
    assert p2.einsum.arg_to_shape["D"] == (280, 280)


def test_lane_pack_requires_divisible_length():
    sp = get_transform_func_from_module_path("mass_v0")
    e = matvec()
    tr = sp.bind_args(e, log2_block=6, dofmajor=False, parallel_grid=True,
                      lane_pack_g=2)
    prog = tr(f.generate_program(e))
    with pytest.raises(InvalidParameterError, match="divisible"):
        f.build_executable(prog, long_dim_length=1002)   # 1002 % 4 != 0


def test_lane_pack_packed_output_contract():
    """The packed output (E/g, g*d) is a reshape of the logical (E, d)
    row-major output — callers unpack for free."""
    from feinsum_tpu.measure import (
        _apply_layouts, _numpy_oracle, generate_input_arrays)
    import jax

    sp = get_transform_func_from_module_path("mass_v0")
    e = matvec(8)
    tr = sp.bind_args(e, log2_block=6, dofmajor=False, parallel_grid=True,
                      lane_pack_g=4)
    prog = tr(f.generate_program(e))
    E = 1024
    raw = generate_input_arrays(e, long_dim_length=E, as_numpy=True)
    arrays = {k: jax.device_put(v) for k, v in
              _apply_layouts(prog, raw).items()}
    assert arrays["u"].shape == (E // 16, 16 * 8)
    assert arrays["D"].shape == (8, 8)           # kron happens in-graph
    fn = f.build_executable(prog, long_dim_length=E)
    (out,) = fn(arrays)
    assert out.shape == (E // 16, 16 * 8)
    ref = _numpy_oracle(e, raw)[0]
    np.testing.assert_allclose(np.asarray(out).reshape(E, 8), ref,
                               rtol=2e-5, atol=2e-5 * np.abs(ref).max())


def test_lane_pack_vecmat_variant():
    """ej,j->e packs too: resident x becomes kron(I_g, x[:,None]) and the
    output packs to (E/g, g)."""
    sp = get_transform_func_from_module_path("mass_v0")
    vm = f.einsum("ej,j->e", f.array("A", ("E", 35), "float32"),
                  f.array("x", (35,), "float32"))
    assert lane_packable(vm) is not None
    assert sp.get_param_space(vm)["lane_pack_g"].high == 5
    for g, dofmajor in ((3, False), (3, True)):
        tr = sp.bind_args(vm, log2_block=6, dofmajor=dofmajor,
                          parallel_grid=True, lane_pack_g=g)
        f.validate_batched_einsum_transform(vm, tr, long_dim_length=2048)
    # g must keep the packed output 8-aligned: g=2 -> out dim 2 % 8 != 0
    prog = f.generate_program(vm)
    with pytest.raises(InvalidParameterError, match="8-aligned"):
        rewrite_lane_pack(prog, 2)


# {{{ DG-family lane_pack (VERDICT r3 #3): div/grad/curl/mass/face classes
# pack too — the second streamed factor is lane-expanded by a dot against a
# synthesized 0/1 matrix (descriptor.lane_pack_expand)

def _div(ndof, b=3):
    rows = [[f.array(jn, ("E", 3), "float32"),
             f.array("R", (3, ndof, ndof), "float32"),
             f.array(un, ("E", ndof), "float32")]
            for jn, un in [("Jx", "ux"), ("Jy", "uy"), ("Jz", "uz")][:b]]
    return f.batched_einsum("es,sij,ej->ei", rows)


def _grad(ndof):
    return f.einsum("xre,rij,ej->xei",
                    f.array("J", (3, 3, "E"), "float32"),
                    f.array("D", (3, ndof, ndof), "float32"),
                    f.array("u", ("E", ndof), "float32"))


def _curl(ndof):
    return f.batched_einsum(
        "e,rij,ej->ei",
        [[f.array(j, ("E",), "float32"),
          f.array("D", (3, ndof, ndof), "float32"),
          f.array(u, ("E", ndof), "float32")]
         for j, u in [("Jy", "uz"), ("Jz", "ux"), ("Jx", "uy")]])


def _face(ndof):
    return f.einsum("ifj,fe,fej->ei",
                    f.array("L", (ndof, 4, 15), "float32"),
                    f.array("Fj", (4, "E"), "float32"),
                    f.array("flux", (4, "E", 15), "float32"))


def _mass(ndof):
    return f.einsum("e,ij,ej->ei",
                    f.array("jac", ("E",), "float32"),
                    f.array("M", (ndof, ndof), "float32"),
                    f.array("u", ("E", ndof), "float32"))


@pytest.mark.parametrize("mk,lg", [
    (lambda: _div(4), 3), (lambda: _div(4, b=1), 4), (lambda: _div(10), 3),
    (lambda: _grad(4), 3), (lambda: _grad(10), 3), (lambda: _curl(4), 3),
    (lambda: _mass(8), 3), (lambda: _face(8), 3)])
def test_lane_pack_dg_validates_against_oracle(mk, lg):
    from feinsum_tpu.tuning.impls._common import lane_pack_dg_applicable
    sp = get_transform_func_from_module_path("dg_div_v0")
    e = mk()
    assert lane_pack_dg_applicable(e)
    # block >= E keeps interpret-mode Pallas at grid=1 (CPU compile-time
    # cliff, CLAUDE.md); the rewrite itself is grid-agnostic
    for dofmajor in (False, True):
        tr = sp.bind_args(e, log2_block=6, dofmajor=dofmajor,
                          parallel_grid=True, lane_pack_g=lg)
        f.validate_batched_einsum_transform(e, tr, long_dim_length=512)


def test_lane_pack_dg_composes_with_rowcat():
    sp = get_transform_func_from_module_path("dg_div_v0")
    for e in (_div(4), _curl(4)):
        tr = sp.bind_args(e, log2_block=6, dofmajor=True,
                          parallel_grid=True, rowcat=True, lane_pack_g=3)
        f.validate_batched_einsum_transform(e, tr, long_dim_length=512)


def test_lane_pack_dg_rejects_schedule_knobs():
    sp = get_transform_func_from_module_path("dg_div_v0")
    e = _div(4)
    for bad in (dict(hoist=True), dict(jfold=True), dict(mfold=True)):
        with pytest.raises(InvalidParameterError):
            sp.bind_args(e, log2_block=6, dofmajor=False,
                         parallel_grid=True, lane_pack_g=1,
                         **bad)(f.generate_program(f.canonicalize_einsum(e)))


def test_lane_pack_dg_alignment_guard():
    from feinsum_tpu.tuning.impls._common import rewrite_lane_pack_dg
    e = _div(10)   # 1*10 lanes not 8-aligned
    with pytest.raises(InvalidParameterError):
        rewrite_lane_pack_dg(f.generate_program(e), 2 ** 0)


def test_lane_pack_dg_fold_composes():
    sp = get_transform_func_from_module_path("dg_div_v0")
    e = _grad(4)
    tr = sp.bind_args(e, log2_block=6, dofmajor=True, fold=True,
                      parallel_grid=True, lane_pack_g=3)
    f.validate_batched_einsum_transform(e, tr, long_dim_length=512)


def test_lane_pack_dg_unpack_output_roundtrip():
    """build_executable + unpack_output delivers the logical grad output
    (3D packed storage: (x, E/g, g*di))."""
    import jax.numpy as jnp
    from feinsum_tpu.tuning.impls._common import (
        fused_pallas_program, rewrite_lane_pack_dg)
    from feinsum_tpu.measure import apply_layouts, generate_input_arrays

    e = _grad(4)
    g = 8
    prog = f.generate_program(e)
    p2, extras = rewrite_lane_pack_dg(prog, g)
    p2 = fused_pallas_program(p2, block_long=64, hoist=False,
                              keep_schedule=True)
    p2 = p2.with_descriptor(**extras)
    arrays = generate_input_arrays(e, long_dim_length=512, as_numpy=True)
    fn = f.build_executable(p2, long_dim_length=512)
    (out,) = fn(apply_layouts(p2, arrays))
    assert out.shape == (3, 512 // g, g * 4)
    logical = f.unpack_output(p2, np.asarray(out), (3, 512, 4))
    ref = np.einsum("xre,rij,ej->xei",
                    arrays["J"].astype(np.float64),
                    arrays["D"].astype(np.float64),
                    arrays["u"].astype(np.float64))
    np.testing.assert_allclose(logical, ref, rtol=2e-5, atol=2e-5)

# }}}


def test_lane_pack_dg_validates_on_canonical_forms():
    """The archive-replay path rewrites the CANONICAL einsum (letters and
    operand order permuted by the canonicalizer) — every class must
    validate in that form too."""
    from feinsum_tpu.tuning.impls._common import (
        fused_pallas_program, rewrite_lane_pack_dg)

    for mk, g in [(lambda: _div(4), 8), (lambda: _grad(4), 8),
                  (lambda: _curl(4), 8), (lambda: _mass(8), 8),
                  (lambda: _face(8), 8)]:
        ce = f.canonicalize_einsum(mk())

        def tr(p, g=g):
            p2, extras = rewrite_lane_pack_dg(p, g)
            p2 = fused_pallas_program(p2, block_long=64, hoist=False,
                                      keep_schedule=True)
            return p2.with_descriptor(**extras)

        f.validate_batched_einsum_transform(ce, tr, long_dim_length=512)


def test_lane_pack_dg_scale_lane_alignment_guard():
    """Review r4: the packed SCALE lanes (g*s for div's J, g for the
    trail-packed classes) need 8-alignment too."""
    from feinsum_tpu.tuning.impls._common import rewrite_lane_pack_dg
    with pytest.raises(InvalidParameterError, match="scale lanes"):
        rewrite_lane_pack_dg(f.generate_program(_div(4)), 4)   # 4*3 = 12
    with pytest.raises(InvalidParameterError, match="scale lanes"):
        rewrite_lane_pack_dg(f.generate_program(_mass(8)), 4)  # g = 4
    p2, extras = rewrite_lane_pack_dg(f.generate_program(_div(4)), 8)
    assert extras["lane_pack"] == 8                            # 8*3 = 24 ok


def test_lane_pack_dg_vmem_guard_matches_live_evidence():
    """Pack points whose largest dot stages more shared memory than a
    thread block may use (the packed kron resident grows as (g*d)^2) are
    rejected as InvalidParameterError before any compile; small packs at
    small blocks stay valid."""
    from feinsum_tpu.tuning import get_transform_func_from_module_path

    sp = get_transform_func_from_module_path("dg_div_v0")
    ce = f.canonicalize_einsum(_div(4))
    base = dict(dofmajor=False, fold=False, preblock=False,
                precision_3x=False, hoist=False, jfold=False,
                prereduce=False, accum_f32=False, host_hoist=True)
    # (log2_block, rowcat, lane_pack_g, split_rows, ok?)
    cases = [(10, True, 5, False, False),    # 128-lane packs, 1024 block
             (10, False, 5, True, False),
             (4, True, 3, False, True),
             (6, False, 3, True, True)]
    for lb, rc, lg, sr, ok in cases:
        params = dict(base, log2_block=lb, rowcat=rc, lane_pack_g=lg,
                      split_rows=sr)
        if ok:
            sp(f.generate_program(ce), ce, **params)
        else:
            with pytest.raises(InvalidParameterError,
                               match="shared memory"):
                sp(f.generate_program(ce), ce, **params)


def test_generic_vmem_guard_uses_the_points_own_limit():
    """The plain (non-pack) guard: a grad35 point whose element block
    stages a (1024 x 64) f32 tile exceeds the per-block shared memory and
    is rejected; the same point at 256 elements is valid."""
    from feinsum_tpu.tuning import get_transform_func_from_module_path

    sp = get_transform_func_from_module_path("dg_grad_v0")
    ce = f.canonicalize_einsum(_grad(35))
    params = dict(log2_block=10, dofmajor=True, fold=False, preblock=True,
                  precision_3x=True, hoist=True, jfold=False,
                  prereduce=False, lane_pack_g=0, rowcat=False,
                  split_rows=False, accum_f32=False, host_hoist=False)
    with pytest.raises(InvalidParameterError, match="shared memory"):
        sp(f.generate_program(ce), ce, **params)
    sp(f.generate_program(ce), ce, **dict(params, log2_block=8))
