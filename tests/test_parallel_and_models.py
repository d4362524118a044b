"""Multi-chip sharding (8 virtual CPU devices) and the wave model."""

import numpy as np
import pytest

import feinsum_tpu as f
from feinsum_tpu.measure import _numpy_oracle, generate_input_arrays
from feinsum_tpu.parallel import (
    make_mesh,
    reduction_sharded_executable,
    sharded_einsum_executable,
)


def dg_grad(ndof=8):
    return f.einsum("xre,rij,ej->xei",
                    f.array("J", (3, 3, "E"), "float32"),
                    f.array("D", (3, ndof, ndof), "float32"),
                    f.array("u", ("E", ndof), "float32"))


def test_data_parallel_sharding_matches_oracle():
    import jax
    assert len(jax.devices()) >= 8
    mesh = make_mesh({"data": 8})
    e = dg_grad()
    prog = f.generate_program_with_opt_einsum_schedule(e).with_descriptor(
        backend="pallas", block_long=16)
    fn = sharded_einsum_executable(prog, mesh, long_dim_length=128)
    arrays = generate_input_arrays(e, long_dim_length=128)
    (out,) = fn(arrays)
    expected = _numpy_oracle(e, {k: np.asarray(v) for k, v in
                                 arrays.items()})[0]
    np.testing.assert_allclose(np.asarray(out), expected, rtol=2e-5,
                               atol=2e-5 * abs(expected).max())


def test_reduction_sharding_psum_matches_oracle():
    mesh = make_mesh({"data": 4, "model": 2})
    e = dg_grad(ndof=8)
    prog = f.generate_program(e)
    fn = reduction_sharded_executable(
        prog, mesh, reduction_index="j", long_dim_length=64)
    arrays = generate_input_arrays(e, long_dim_length=64)
    (out,) = fn(arrays)
    expected = _numpy_oracle(e, {k: np.asarray(v) for k, v in
                                 arrays.items()})[0]
    np.testing.assert_allclose(np.asarray(out), expected, rtol=2e-5,
                               atol=2e-5 * abs(expected).max())


def test_sharding_rejects_indivisible():
    mesh = make_mesh({"data": 8})
    e = dg_grad()
    prog = f.generate_program(e)
    with pytest.raises(ValueError):
        sharded_einsum_executable(prog, mesh, long_dim_length=100)


def test_wave_model_step():
    import jax
    from feinsum_tpu.models import WaveOperator3D, make_wave_state

    op = WaveOperator3D(ndof=10, nfacedof=6, dtype="float32",
                        use_pallas=True, block_long=64)
    step = jax.jit(op.make_step(256, dt=1e-3))
    state, geom = make_wave_state(256, ndof=10, nfacedof=6)
    out = step(state, geom)
    assert out["u"].shape == (10, 256)       # dof-major state
    assert out["v"].shape == (3, 10, 256)
    assert bool(np.isfinite(np.asarray(out["u"])).all())
    # energy-ish sanity: the update actually changed the state
    assert not np.allclose(np.asarray(out["u"]), np.asarray(state["u"]))


def test_wave_model_uses_db_schedule(tmp_path):
    from feinsum_tpu import sql_utils
    from feinsum_tpu.models import WaveOperator3D

    db = str(tmp_path / "db.sqlite")
    op_probe = WaveOperator3D(ndof=10, nfacedof=6, use_pallas=False)
    sql_utils.record_facts(
        op_probe.grad_einsum, transform_id="dg_grad_v0.py",
        transform_params={"log2_block": 9, "hoist": True,
                          "parallel_grid": True, "dofmajor": False},
        runtime_in_sec=1e-4, device=None, db_path=db, long_dim_length=1000)
    op = WaveOperator3D(ndof=10, nfacedof=6, db_path=db)
    assert op._programs["grad"].descriptor.block_long == 512
    # einsums without facts fall back to defaults
    assert op._programs["div"].descriptor.backend == "pallas"


def test_wave_model_strips_storage_layouts_from_db_schedules(tmp_path):
    """Archive champions may carry fold_long/preblock_args storage choices;
    the model's state contract is plain dof-major, so those must reset (a
    retrieved fold schedule once broke the wave example with a block-rank
    mismatch)."""
    import jax

    from feinsum_tpu import sql_utils
    from feinsum_tpu.models import WaveOperator3D, make_wave_state

    db = str(tmp_path / "db.sqlite")
    op_probe = WaveOperator3D(ndof=10, nfacedof=6, use_pallas=False)
    sql_utils.record_facts(
        op_probe.grad_einsum, transform_id="dg_grad_v0.py",
        transform_params={"log2_block": 10, "hoist": True,
                          "parallel_grid": True, "dofmajor": True,
                          "fold": True, "preblock": True,
                          "precision_3x": True},
        runtime_in_sec=1e-4, device=None, db_path=db, long_dim_length=2048)
    op = WaveOperator3D(ndof=10, nfacedof=6, db_path=db)
    desc = op._programs["grad"].descriptor
    assert desc.fold_long == 1 and desc.preblock_args == ()
    assert desc.precision == "tf32_3x"    # the dot precision carries over
    step = jax.jit(op.make_step(512, dt=1e-3))
    state, geom = make_wave_state(512, ndof=10, nfacedof=6)
    out = step(state, geom)
    assert out["u"].shape == (10, 512)


def test_graft_entry():
    import jax

    import __graft_entry__ as g
    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    assert set(out) == {"u", "v"}


def test_graft_dryrun_multichip():
    import __graft_entry__ as g
    g.dryrun_multichip(8)


def test_graft_dryrun_multichip_driver_style():
    """The exact invocation the driver uses: a fresh interpreter with NO
    pytest conftest pre-arranging XLA_FLAGS / platform — the bootstrap
    inside dryrun_multichip must do everything itself (round-1 regression:
    MULTICHIP_r01.json rc=1)."""
    import os
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    proc = subprocess.run(
        [sys.executable, "-c",
         "import __graft_entry__; __graft_entry__.dryrun_multichip(8)"],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "dryrun_multichip OK" in proc.stdout


def test_wave_model_numerics():
    """One wave step vs a numpy reference computed from the logical views of
    the dof-major state/geometry (catches layout plumbing mistakes)."""
    import jax
    from feinsum_tpu.models import WaveOperator3D, make_wave_state

    ndof, nfdof, E, dt = 6, 4, 64, 1e-3
    op = WaveOperator3D(ndof=ndof, nfacedof=nfdof, dtype="float32",
                        use_pallas=True, block_long=32)
    step = jax.jit(op.make_step(E, dt=dt))
    state, geom = make_wave_state(E, ndof=ndof, nfacedof=nfdof)
    out = step(state, geom)

    g = {k: np.asarray(v) for k, v in geom.items()}
    u = np.asarray(state["u"]).T                     # logical (E, P)
    v = np.asarray(state["v"]).transpose(0, 2, 1)    # (3, E, P)
    grad = np.einsum("xre,rij,ej->xei", g["J"],
                     g["D"], u)
    div = sum(np.einsum("es,sij,ej->ei", g[f"J{x}"].T, g["D"],
                        v[i].reshape(E, ndof))
              for i, x in enumerate("xyz"))
    flux = np.einsum("fji,ei->fej", g["Rface"], u)   # from the state
    lift = np.einsum("ifj,fe,fej->ei", g["L"].transpose(1, 0, 2),
                     g["Fj"], flux)
    exp_u = u + dt * (div + lift)
    exp_v = v + dt * grad.transpose(0, 1, 2)

    np.testing.assert_allclose(np.asarray(out["u"]).T, exp_u, rtol=2e-5,
                               atol=2e-5 * abs(exp_u).max())
    np.testing.assert_allclose(np.asarray(out["v"]).transpose(0, 2, 1),
                               exp_v, rtol=2e-5,
                               atol=2e-5 * abs(exp_v).max())


def test_maxwell_model_numerics():
    """One Maxwell step vs numpy: the 6-row batched curl must combine into
    eps_{abc} J_b D F_c pairs with the right signs, through the dof-major
    layout plumbing."""
    import jax
    from feinsum_tpu.models import MaxwellOperator3D, make_maxwell_state

    ndof, E, dt = 6, 64, 1e-3
    op = MaxwellOperator3D(ndof=ndof, dtype="float32", use_pallas=True,
                           block_long=32)
    step = jax.jit(op.make_step(E, dt=dt))
    state, geom = make_maxwell_state(E, ndof=ndof)
    out = step(state, geom)

    g = {k: np.asarray(v) for k, v in geom.items()}

    def np_curl(F):          # F logical (3, E, P)
        J = {"x": g["Jx"].T, "y": g["Jy"].T, "z": g["Jz"].T}  # (E, 3)
        c = {}
        for a, (b, cc) in zip("xyz", (("y", "z"), ("z", "x"), ("x", "y"))):
            comp = {"x": 0, "y": 1, "z": 2}
            c[a] = (np.einsum("es,sij,ej->ei", J[b], g["D"], F[comp[cc]])
                    - np.einsum("es,sij,ej->ei", J[cc], g["D"], F[comp[b]]))
        return np.stack([c["x"], c["y"], c["z"]])

    Ef = np.asarray(state["E"]).transpose(0, 2, 1)   # logical (3, E, P)
    Hf = np.asarray(state["H"]).transpose(0, 2, 1)
    exp_E = Ef + dt * np_curl(Hf)
    exp_H = Hf - dt * np_curl(Ef)
    got_E = np.asarray(out["E"]).transpose(0, 2, 1)
    got_H = np.asarray(out["H"]).transpose(0, 2, 1)
    np.testing.assert_allclose(got_E, exp_E, rtol=2e-5,
                               atol=2e-5 * abs(exp_E).max())
    np.testing.assert_allclose(got_H, exp_H, rtol=2e-5,
                               atol=2e-5 * abs(exp_H).max())


def test_maxwell_model_uses_db_schedule(tmp_path):
    from feinsum_tpu import sql_utils
    from feinsum_tpu.models import MaxwellOperator3D

    db = str(tmp_path / "db.sqlite")
    probe = MaxwellOperator3D(ndof=10, use_pallas=False)
    sql_utils.record_facts(
        probe.curl_einsum, transform_id="dg_div_v0.py",
        transform_params={"log2_block": 9, "hoist": True,
                          "parallel_grid": True, "dofmajor": True,
                          "precision_3x": True},
        runtime_in_sec=1e-4, device=None, db_path=db, long_dim_length=1024)
    op = MaxwellOperator3D(ndof=10, db_path=db)
    assert op._program.descriptor.block_long == 512
    assert op._program.descriptor.precision == "tf32_3x"


def test_row_sharding_matches_oracle():
    """Expert-parallel analog: batch rows sharded over a mesh axis, shared
    operands replicated, per-row operands stacked — no collectives."""
    import jax.numpy as jnp
    from feinsum_tpu.parallel import row_sharded_executable

    ndof = 6
    e = f.batched_einsum(
        "es,sij,ej->ei",
        [[f.array(j, ("E", 3), "float32"),
          f.array("R", (3, ndof, ndof), "float32"),
          f.array(u, ("E", ndof), "float32")]
         for j, u in [("Jx", "ux"), ("Jy", "uy"), ("Jz", "uz"),
                      ("Jw", "uw")]])
    arrays = generate_input_arrays(e, long_dim_length=64)
    stacked = {
        "Jx": jnp.stack([arrays[n] for n in ("Jx", "Jy", "Jz", "Jw")]),
        "ux": jnp.stack([arrays[n] for n in ("ux", "uy", "uz", "uw")]),
    }
    expected = _numpy_oracle(e, {k: np.asarray(v) for k, v in
                                 arrays.items()})
    # n=4 (one row per device) AND n=2 (b_local=2: the local program is a
    # 2-row batched einsum fed both rows in ONE call — regression: the
    # first version called it per-row and died with KeyError '_row1_Jx')
    for n in (4, 2):
        mesh = make_mesh({"rows": n})
        prog = f.generate_program(e).with_descriptor(backend="pallas",
                                                     block_long=16)
        fn = row_sharded_executable(prog, mesh, long_dim_length=64)
        out = fn(stacked, {"R": arrays["R"]})
        assert out.shape == (4, 64, ndof)
        for i in range(4):
            np.testing.assert_allclose(
                np.asarray(out[i]), expected[i], rtol=2e-5,
                atol=2e-5 * abs(expected[i]).max())


def test_pipeline_stage_executable_matches_oracle():
    """PP (GPipe-style ppermute ring) over a 2-stage mesh: wave RHS split
    as div -> mass+axpy, microbatched; outputs match the per-microbatch
    numpy oracle. (SURVEY §2.4 stretch: the pp member of tp/pp/dp/sp/ep.)"""
    import jax
    import jax.numpy as jnp

    from feinsum_tpu.parallel import make_mesh, pipeline_stage_executable

    ndof, mb, n_micro = 8, 16, 4
    mesh = make_mesh({"stage": 2})
    rng = np.random.default_rng(0)
    inputs = {
        "J": jnp.asarray(rng.random((n_micro, mb, 3), np.float32)),
        "R": jnp.broadcast_to(
            jnp.asarray(rng.random((3, ndof, ndof), np.float32)),
            (n_micro, 3, ndof, ndof)),
        "u": jnp.asarray(rng.random((n_micro, mb, ndof), np.float32)),
        "jac": jnp.asarray(rng.random((n_micro, mb), np.float32)),
        "M": jnp.broadcast_to(
            jnp.asarray(rng.random((ndof, ndof), np.float32)),
            (n_micro, ndof, ndof)),
    }

    def stage0(chunk, carry):
        return jnp.einsum("es,sij,ej->ei", chunk["J"], chunk["R"],
                          chunk["u"])

    def stage1(chunk, carry):
        return carry - 0.5 * jnp.einsum("e,ij,ej->ei", chunk["jac"],
                                        chunk["M"], chunk["u"])

    fn = pipeline_stage_executable(
        [stage0, stage1], mesh, n_microbatches=n_micro,
        carry_shape_dtype=jax.ShapeDtypeStruct((mb, ndof), jnp.float32))
    out = np.asarray(fn(inputs))
    ref = np.stack([
        np.einsum("es,sij,ej->ei", inputs["J"][m], inputs["R"][m],
                  inputs["u"][m])
        - 0.5 * np.einsum("e,ij,ej->ei", inputs["jac"][m], inputs["M"][m],
                          inputs["u"][m])
        for m in range(n_micro)])
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)


def test_pipeline_four_stages_deep_bubble():
    import jax
    import jax.numpy as jnp

    from feinsum_tpu.parallel import make_mesh, pipeline_stage_executable

    mesh = make_mesh({"stage": 4})
    rng = np.random.default_rng(1)
    u = jnp.asarray(rng.random((3, 16, 8), np.float32))

    def mk(i):
        def sfn(chunk, carry):
            return carry + (i + 1.0) * chunk["u"]
        return sfn

    fn = pipeline_stage_executable(
        [mk(i) for i in range(4)], mesh, n_microbatches=3,
        carry_shape_dtype=jax.ShapeDtypeStruct((16, 8), jnp.float32))
    np.testing.assert_allclose(np.asarray(fn({"u": u})),
                               10.0 * np.asarray(u), rtol=1e-6)


def test_pipeline_composes_on_two_axis_mesh():
    """PP shards compute; it must run unchanged on a 2-axis (data x stage)
    mesh — the composition story the docstring claims."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from feinsum_tpu.parallel import pipeline_stage_executable

    devs = np.array(jax.devices()[:8]).reshape(4, 2)
    mesh = Mesh(devs, ("data", "stage"))
    rng = np.random.default_rng(3)
    u = jnp.asarray(rng.random((3, 16, 8), np.float32))

    def mk(i):
        def sfn(chunk, carry):
            return carry + (i + 1.0) * chunk["u"]
        return sfn

    fn = pipeline_stage_executable(
        [mk(0), mk(1)], mesh, n_microbatches=3,
        carry_shape_dtype=jax.ShapeDtypeStruct((16, 8), jnp.float32))
    np.testing.assert_allclose(np.asarray(fn({"u": u})),
                               3.0 * np.asarray(u), rtol=1e-6)
