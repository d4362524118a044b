"""The full product loop, end to end on CPU: trace a user's JAX function,
match it, look up the archive, replay the transform, execute, validate —
the reference's transform-knowledge-transfer test (test_loopy_utils.py:
145-173)."""

import doctest

import jax.numpy as jnp
import numpy as np

import feinsum_tpu as f
from feinsum_tpu import sql_utils
from feinsum_tpu.matching import get_a_matched_einsum


def test_trace_match_retrieve_replay(tmp_path):
    db = str(tmp_path / "archive.sqlite")

    # 1. someone tuned the canonical DG divergence and recorded a fact
    ndof = 8
    tuned = f.batched_einsum(
        "es,sij,ej->ei",
        [[f.array("Jx", ("E", 3), "float32"),
          f.array("R", (3, ndof, ndof), "float32"),
          f.array("ux", ("E", ndof), "float32")]])
    sql_utils.record_facts(
        tuned, transform_id="dg_div_v0.py",
        transform_params={"log2_block": 8, "hoist": True,
                          "parallel_grid": True, "dofmajor": True},
        runtime_in_sec=1e-4, device="NVIDIA H100 80GB HBM3", db_path=db,
        long_dim_length=1000)

    # 2. a user writes their own differently-named computation
    def user_div(jac, ref_mat, dofs):
        return jnp.einsum("ns,sab,nb->na", jac, ref_mat, dofs)

    E = 640
    args = [jnp.ones((E, 3), jnp.float32),
            jnp.ones((3, ndof, ndof), jnp.float32),
            jnp.ones((E, ndof), jnp.float32)]
    matched, _ = get_a_matched_einsum(user_div, args)

    # 3. archive hit via canonical form, despite all-new names
    transform = sql_utils.retrieve(matched, "NVIDIA H100 80GB HBM3", db_path=db)

    # 4. replay onto the user's program and validate numerically
    f.validate_batched_einsum_transform(matched, transform,
                                        long_dim_length=E)
    program = transform(f.generate_program(matched))
    assert program.descriptor.backend == "pallas"
    assert program.descriptor.block_long == 256
    assert program.descriptor.arg_layouts  # dofmajor applied

    fn = f.build_executable(program, long_dim_length=E)
    from feinsum_tpu.measure import _apply_layouts
    arrays = _apply_layouts(program, {"jac": np.ones((E, 3), np.float32),
                                      "ref_mat": np.ones((3, ndof, ndof),
                                                         np.float32),
                                      "dofs": np.ones((E, ndof),
                                                      np.float32)})
    (out,) = fn(arrays)
    # out delivered in the descriptor's stored layout (dof-major)
    assert out.shape == (ndof, E)
    np.testing.assert_allclose(np.asarray(out), 3.0 * ndof, rtol=1e-5)


def test_doctests():
    import feinsum_tpu.utils as utils_mod
    failures, _ = doctest.testmod(utils_mod).failed, None
    assert not failures


def test_tc_gemm_v0_fused2d():
    """tc_gemm_v0: dense TC rewritten to a GEMM-natural fused-2D program
    (descriptor.pre_layouts storage contract) — both the XLA-dot route and
    the first-party Pallas streaming route validate against numpy on the
    original high-rank einsum."""
    from feinsum_tpu.diagnostics import InvalidParameterError
    from feinsum_tpu.tuning import get_transform_func_from_module_path

    e = f.einsum("dfgb,geac->abcdef",
                 f.array("A", (6, 4, 5, 7), "float32"),
                 f.array("B", (5, 8, 9, 10), "float32"))
    sp = get_transform_func_from_module_path("tc_gemm_v0")
    for backend_pallas, swap, dofmajor in (
            (False, False, False), (False, True, False),
            (True, False, True), (True, True, False)):
        tr = sp.bind_args(e, log2_block=8, blkc128=0,
                          backend_pallas=backend_pallas, precision_idx=0,
                          swap=swap, dofmajor=dofmajor, fold=False,
                          vmem_idx=2)
        f.validate_batched_einsum_transform(e, tr, long_dim_length=100)
    prog = sp.bind_args(e, log2_block=8, blkc128=0, backend_pallas=False,
                        precision_idx=0, swap=False, dofmajor=False,
                        fold=False, vmem_idx=2)(f.generate_program(e))
    # swap is canonical-relative (this einsum's canonical operand order is
    # (B, A), sigma_j=(1,0)): swap=False makes B(geac) the streamed lhs —
    # M=(e,a,c)->positions (1,2,3), K=(g,)->(0,) — and A the resident rhs
    # with K position (2,)
    assert dict(prog.descriptor.pre_layouts)["B"] == ((1, 2, 3), (0,))
    assert dict(prog.descriptor.pre_layouts)["A"][1] == (2,)
    assert prog.descriptor.bind_lengths == (("e", 8 * 9 * 10),)

    # batch-index (shared free axis) contractions are guarded
    import pytest

    be = f.einsum("abk,akc->abc", f.array("A", (4, 5, 6), "float32"),
                  f.array("B", (4, 6, 7), "float32"))
    with pytest.raises(InvalidParameterError):
        sp.bind_args(be, log2_block=8, blkc128=0, backend_pallas=False,
                     precision_idx=0, swap=False, dofmajor=False,
                     fold=False, vmem_idx=2)(f.generate_program(be))
