"""rowcat (descriptor.rowcat): merge batch rows sharing every resident
operand into ONE row over a b*E-long axis — identical traffic and dot
work, 1/b the grid steps (the small-ndof per-block-overhead amortizer)."""

import jax.numpy as jnp
import numpy as np
import pytest

import feinsum_tpu as f
from feinsum_tpu.diagnostics import InvalidParameterError
from feinsum_tpu.tuning import get_transform_func_from_module_path
from feinsum_tpu.tuning.impls._common import (
    rewrite_rowcat,
    rowcat_applicable,
)


def make_div(ndof=4):
    return f.batched_einsum(
        "es,sij,ej->ei",
        [[f.array(j, ("E", 3), "float32"),
          f.array("R", (3, ndof, ndof), "float32"),
          f.array(u, ("E", ndof), "float32")]
         for j, u in [("Jx", "ux"), ("Jy", "uy"), ("Jz", "uz")]])


@pytest.mark.parametrize("kwargs", [
    dict(dofmajor=False),
    dict(dofmajor=True, fold=True),
    dict(dofmajor=True, jfold=True),
])
def test_rowcat_validates(kwargs):
    sp = get_transform_func_from_module_path("dg_div_v0")
    div = make_div()
    tr = sp.bind_args(div, log2_block=8, parallel_grid=True, rowcat=True,
                      **kwargs)
    f.validate_batched_einsum_transform(div, tr, long_dim_length=1024)


def test_rowcat_gates_and_rewrite_shape():
    div = make_div(5)
    assert rowcat_applicable(div)
    p2, extras = rewrite_rowcat(f.generate_program(div))
    assert p2.einsum.b == 1 and extras["rowcat"] == 3
    assert len(extras["rowcat_args"]) == 2       # J stack + u stack
    # grad (b=1) and einsums with per-row DIFFERENT residents gate off
    grad = f.einsum("xre,rij,ej->xei",
                    f.array("J", (3, 3, "E"), "float32"),
                    f.array("D", (3, 5, 5), "float32"),
                    f.array("u", ("E", 5), "float32"))
    assert not rowcat_applicable(grad)
    two_res = f.batched_einsum(
        "es,sij,ej->ei",
        [[f.array("Jx", ("E", 3), "float32"),
          f.array("Rx", (3, 5, 5), "float32"),
          f.array("ux", ("E", 5), "float32")],
         [f.array("Jy", ("E", 3), "float32"),
          f.array("Ry", (3, 5, 5), "float32"),
          f.array("uy", ("E", 5), "float32")]])
    assert not rowcat_applicable(two_res)
    with pytest.raises(InvalidParameterError):
        rewrite_rowcat(f.generate_program(two_res))


def test_rowcat_champion_replays_through_apply(tmp_path):
    """A rowcat champion replayed via compile_fn_with_archive slices the
    concatenated output back into per-row results (with signs)."""
    from feinsum_tpu import sql_utils

    db = str(tmp_path / "scratch.sqlite")
    div = make_div(4)
    params = {"log2_block": 8, "blkc128": 0, "dofmajor": True,
              "fold": False, "preblock": False, "precision_3x": False,
              "hoist": False, "jfold": False, "mfold": False,
              "prereduce": False, "lane_pack_g": 0, "rowcat": True,
              "parallel_grid": True, "vmem_idx": 2, "split_rows": False,
              "accum_f32": False, "host_hoist": True}
    sql_utils.record_facts(div, transform_id="dg_div_v0.py",
                           transform_params=params, runtime_in_sec=1e-4,
                           device=f.FakeDevice("NVIDIA H100 80GB HBM3"), db_path=db,
                           long_dim_length=1024)

    rng = np.random.default_rng(9)
    E = 1024
    r = lambda *s: jnp.asarray(rng.random(s, np.float32))  # noqa: E731
    Jx, Jy, Jz, R = r(E, 3), r(E, 3), r(E, 3), r(3, 4, 4)
    ux, uy, uz = r(E, 4), r(E, 4), r(E, 4)

    def user(Jx, Jy, Jz, R, ux, uy, uz):
        return (jnp.einsum("es,sij,ej->ei", Jx, R, ux)
                + jnp.einsum("es,sij,ej->ei", Jy, R, uy)
                - jnp.einsum("es,sij,ej->ei", Jz, R, uz))

    args = [Jx, Jy, Jz, R, ux, uy, uz]
    fn2 = f.compile_fn_with_archive(user, args, db_path=db,
                                    device=f.FakeDevice("NVIDIA H100 80GB HBM3"),
                                    long_dim_length=500)
    assert fn2.plans[0][2].descriptor.rowcat == 3
    got, ref = fn2(*args), user(*args)
    scale = float(jnp.max(jnp.abs(ref)))
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=2e-5, atol=2e-5 * scale)


def test_rowcat_lane_pack_composes():
    """r3 rejected this combination (extras overwrote each other); r4
    merges the extras dicts, so rowcat (1/b grid steps) and lane_pack
    (dense lanes) stack — the batched small-ndof unlock."""
    mv = f.batched_einsum(
        "ej,ij->ei",
        [[f.array(u, ("E", 4), "float32"),
          f.array("D", (4, 4), "float32")]
         for u in ("ux", "uy")])
    sp = get_transform_func_from_module_path("mass_v0")
    tr = sp.bind_args(mv, log2_block=8, dofmajor=True, parallel_grid=True,
                      rowcat=True, lane_pack_g=2)
    f.validate_batched_einsum_transform(mv, tr, long_dim_length=1024)
    prog = tr(f.generate_program(f.canonicalize_einsum(mv)))
    assert prog.descriptor.rowcat == 2
    assert prog.descriptor.lane_pack == 4
