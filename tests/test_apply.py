"""compile_fn_with_archive: the end-to-end consumer flow — a user's traced
function runs with every einsum instruction executed through its archived
schedule (the reference applies transforms to the user's kernel in place;
codegen/loopy.py:94-95's substitution rules are what our operand-expression
evaluation mirrors)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import feinsum_tpu as f


def _data(E=1024, ndof=8, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "J": jnp.asarray(rng.random((E, 3), np.float32)),
        "D": jnp.asarray(rng.random((3, ndof, ndof), np.float32)),
        "u": jnp.asarray(rng.random((E, ndof), np.float32)),
        "L": jnp.asarray(rng.random((ndof, 4, 6), np.float32)),
        "F": jnp.asarray(rng.random((4, E), np.float32)),
        "flux": jnp.asarray(rng.random((4, E, 6), np.float32)),
    }


def _close(got, ref, tol=2e-5):
    scale = float(jnp.max(jnp.abs(ref))) or 1.0
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=tol, atol=tol * scale)


def test_sum_of_einsums_with_scales():
    d = _data()

    def user_rhs(J, D, u, L, F, flux):
        vol = jnp.einsum("es,sij,ej->ei", J, D, u)
        surf = jnp.einsum("ifj,fe,fej->ei", L, F, flux)
        return 2.0 * vol - surf

    args = [d["J"], d["D"], d["u"], d["L"], d["F"], d["flux"]]
    fn2 = f.compile_fn_with_archive(user_rhs, args)
    _close(fn2(*args), user_rhs(*args))


def test_expression_operand_and_captured_const():
    d = _data()
    M = jnp.asarray(np.random.default_rng(1).random((8, 8), np.float32))

    def user(J, u):
        return jnp.einsum("e,ej,ij->ei", 2.0 * J[:, 0] + 1.0, u, M)

    fn2 = f.compile_fn_with_archive(user, [d["J"], d["u"]])
    _close(fn2(d["J"], d["u"]), user(d["J"], d["u"]))


def test_tuple_outputs_and_nonlinear_operand():
    d = _data()

    def pair(J, D, u):
        a = jnp.einsum("es,sij,ej->ei", J, D, u)
        return a, -jnp.einsum("ei,ej->ij", jnp.exp(u), u)

    args = [d["J"], d["D"], d["u"]]
    fn2 = f.compile_fn_with_archive(pair, args)
    g1, g2 = fn2(*args)
    r1, r2 = pair(*args)
    _close(g1, r1)
    _close(g2, r2, tol=2e-4)


def _record_dg_row(db, einsum, transform_id, **params):
    """Plant one archived pallas fact for the H100 device key."""
    from feinsum_tpu import sql_utils
    base = {"log2_block": 7, "log2_warps": 2, "num_stages": 2,
            "dofmajor": True, "fold": False, "preblock": False,
            "precision_3x": False, "hoist": False, "jfold": False,
            "prereduce": False, "lane_pack_g": 0, "split_rows": False,
            "accum_f32": False, "host_hoist": True, "rowcat": False}
    sql_utils.record_facts(einsum, transform_id=transform_id,
                           transform_params=dict(base, **params),
                           runtime_in_sec=1e-4, device=H100, db_path=db,
                           long_dim_length=2048)


H100 = f.FakeDevice("NVIDIA H100 80GB HBM3")


def test_archive_hit_replays_tuned_schedule(tmp_path):
    """With an archived fact for the device, the matvec instruction must
    resolve to the archived pallas schedule (not the opt_einsum fallback)
    and still reproduce fn exactly (interpret-mode pallas on CPU)."""
    rng = np.random.default_rng(2)
    u = jnp.asarray(rng.random((2048, 20), np.float32))
    M = jnp.asarray(rng.random((20, 20), np.float32))
    db = str(tmp_path / "scratch.sqlite")
    _record_dg_row(db, f.einsum("ej,ij->ei",
                                f.array("u", ("E", 20), "float32"),
                                f.array("D", (20, 20), "float32")),
                   "mass_v0.py")

    def user(my_dofs, my_op):
        return jnp.einsum("nq,dq->nd", my_dofs, my_op)

    fn2 = f.compile_fn_with_archive(
        user, [u, M], device=H100, db_path=db, long_dim_length=500)
    assert fn2.plans[0][2].descriptor.backend == "pallas"   # archive hit
    _close(fn2(u, M), user(u, M))


def test_traced_scalar_factor_applied():
    """r3 review #4: a traced rank-0 multiplicative factor (dt * rhs) is
    captured as a scale_var and re-applied at call time."""
    d = _data()

    def user(u, alpha):
        return alpha * jnp.einsum("ej,ej->e", u, u)

    fn2 = f.compile_fn_with_archive(user, [d["u"], jnp.float32(2.0)])
    got = np.asarray(fn2(d["u"], jnp.float32(0.25)))
    ref = 0.25 * np.einsum("ej,ej->e", d["u"], d["u"])
    np.testing.assert_allclose(got, ref, rtol=2e-5)


def test_traced_scalar_divisor_applied():
    """r3: division by a traced scalar (rhs / dt) is captured as a
    scale_var with exponent -1 and re-applied at call time (it used to be
    the one rejected scalar-factor form)."""
    d = _data()

    def user(u, alpha):
        return jnp.einsum("ej,ej->e", u, u) / alpha

    fn2 = f.compile_fn_with_archive(user, [d["u"], jnp.float32(2.0)])
    got = np.asarray(fn2(d["u"], jnp.float32(4.0)))
    ref = np.einsum("ej,ej->e", d["u"], d["u"]) / 4.0
    np.testing.assert_allclose(got, ref, rtol=2e-5)


def test_mixed_mul_div_traced_scalars():
    """beta * einsum / alpha: two scale_vars with opposite exponents."""
    d = _data()

    def user(u, alpha, beta):
        return beta * jnp.einsum("ej,ej->e", u, u) / alpha

    fn2 = f.compile_fn_with_archive(
        user, [d["u"], jnp.float32(2.0), jnp.float32(3.0)])
    got = np.asarray(fn2(d["u"], jnp.float32(8.0), jnp.float32(5.0)))
    ref = 5.0 * np.einsum("ej,ej->e", d["u"], d["u"]) / 8.0
    np.testing.assert_allclose(got, ref, rtol=2e-5)


def test_componentwise_div_groups_into_batched_archive_hit(tmp_path):
    """A user writing div componentwise (3 separate jnp.einsum calls, summed
    into one output) must group into ONE b=3 batched plan and hit the
    archive's batched-div champion."""
    db = str(tmp_path / "scratch.sqlite")
    _record_dg_row(db, f.batched_einsum(
        "es,sij,ej->ei",
        [[f.array(jn, ("E", 3), "float32"),
          f.array("R", (3, 35, 35), "float32"),
          f.array(un, ("E", 35), "float32")]
         for jn, un in [("Jx", "ux"), ("Jy", "uy"), ("Jz", "uz")]]),
        "dg_div_v0.py")
    rng = np.random.default_rng(3)
    E = 2048
    Js = [jnp.asarray(rng.random((E, 3), np.float32)) for _ in range(3)]
    R = jnp.asarray(rng.random((3, 35, 35), np.float32))
    us = [jnp.asarray(rng.random((E, 35), np.float32)) for _ in range(3)]

    def user(Jx, Jy, Jz, R, ux, uy, uz):
        return (jnp.einsum("es,sij,ej->ei", Jx, R, ux)
                + jnp.einsum("es,sij,ej->ei", Jy, R, uy)
                - jnp.einsum("es,sij,ej->ei", Jz, R, uz))

    args = [Js[0], Js[1], Js[2], R, us[0], us[1], us[2]]
    fn2 = f.compile_fn_with_archive(
        user, args, device=H100, db_path=db, long_dim_length=500)
    assert len(fn2.plans) == 1
    row_infos, einsum, program = fn2.plans[0]
    assert len(row_infos) == 3 and einsum.b == 3
    assert program.descriptor.backend == "pallas"    # batched archive hit
    assert [i.scale for i in row_infos] == [1.0, 1.0, -1.0]
    _close(fn2(*args), user(*args))


def test_compiled_fn_is_jittable():
    import jax
    d = _data()

    def user(J, D, u):
        return jnp.einsum("es,sij,ej->ei", J, D, u)

    args = [d["J"], d["D"], d["u"]]
    fn2 = f.compile_fn_with_archive(user, args)
    _close(jax.jit(fn2)(*args), user(*args))


def test_einsum_rewriting_champion_replays(tmp_path):
    """Regression (r3 review #1/#2): an archived champion that REWRITES the
    einsum (lane_pack) must build with the rewritten dims, deliver the
    logical output, and fall through the ladder when its divisibility
    constraints don't fit the call's sizes."""
    from feinsum_tpu import sql_utils

    db = str(tmp_path / "scratch.sqlite")
    e = f.einsum("ej,ij->ei", f.array("u", ("E", 20), "float32"),
                 f.array("D", (20, 20), "float32"))
    params = {"log2_block": 6, "blkc128": 0, "dofmajor": True,
              "fold": False, "preblock": False, "precision_3x": False,
              "hoist": False, "jfold": False, "mfold": False,
              "prereduce": False, "lane_pack_g": 2, "parallel_grid": True,
              "vmem_idx": 2, "split_rows": False, "accum_f32": False,
              "host_hoist": True}
    sql_utils.record_facts(e, transform_id="mass_v0.py",
                           transform_params=params, runtime_in_sec=1e-4,
                           device=f.FakeDevice("NVIDIA H100 80GB HBM3"), db_path=db,
                           long_dim_length=2048)

    rng = np.random.default_rng(7)
    u = jnp.asarray(rng.random((2048, 20), np.float32))
    M = jnp.asarray(rng.random((20, 20), np.float32))

    def user(dofs, op):
        return jnp.einsum("nq,dq->nd", dofs, op)

    fn2 = f.compile_fn_with_archive(user, [u, M], db_path=db,
                                    device=f.FakeDevice("NVIDIA H100 80GB HBM3"),
                                    long_dim_length=500)
    prog = fn2.plans[0][2]
    assert prog.descriptor.lane_pack == 4            # the packed champion
    _close(fn2(u, M), user(u, M))

    # E=1002 breaks g=4 divisibility: ladder falls to the opt_einsum
    # program instead of crashing
    u2 = jnp.asarray(rng.random((1002, 20), np.float32))
    fn3 = f.compile_fn_with_archive(user, [u2, M], db_path=db,
                                    device=f.FakeDevice("NVIDIA H100 80GB HBM3"),
                                    long_dim_length=500)
    assert fn3.plans[0][2].descriptor.lane_pack == 1
    _close(fn3(u2, M), user(u2, M))


def test_epilogue_tanh():
    """r3: a non-grammar epilogue (tanh of an einsum) no longer rejects —
    the einsum runs through its archive plan and the epilogue replays the
    sliced jaxpr around it (reference parity: match_t_unit_to_einsum
    matches the einsum inside a larger kernel, leaving the other
    statements intact)."""
    d = _data()

    def user(u, D):
        return jnp.tanh(jnp.einsum("ej,ij->ei", u, D))

    fn2 = f.compile_fn_with_archive(user, [d["u"], d["D"][0]])
    got = np.asarray(fn2(d["u"], d["D"][0]))
    np.testing.assert_allclose(got, np.asarray(user(d["u"], d["D"][0])),
                               rtol=2e-5, atol=1e-6)
    assert len(fn2.plans) == 1
    # jit-compatible: the epilogue replays inside the traced graph
    got_j = np.asarray(jax.jit(fn2)(d["u"], d["D"][0]))
    np.testing.assert_allclose(got_j, got, rtol=2e-5, atol=1e-6)


def test_epilogue_mixed_outputs_maximal_frontier():
    """One output is a direct einsum, the other an exp() epilogue over a
    difference of einsums scaled by a traced dt.  The frontier is cut at
    the LAST grammar value (dt * (a - b)): its sum/sign/dt handling rides
    the normal instruction machinery and only exp() replays raw."""
    d = _data()

    def user(u, D, dt):
        a = jnp.einsum("ej,ij->ei", u, D)
        b = jnp.einsum("ej,ij->ei", u, 2.0 * D)
        return a, jnp.exp(dt * (a - b))

    fn2 = f.compile_fn_with_archive(user,
                                    [d["u"], d["D"][0], jnp.float32(0.1)])
    got = fn2(d["u"], d["D"][0], jnp.float32(0.25))
    ref = user(d["u"], d["D"][0], jnp.float32(0.25))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(np.asarray(g), np.asarray(r),
                                   rtol=2e-4, atol=1e-5)
    # a (direct) + the frontier sum's two addends, batched into one plan
    n_insns = sum(len(row_infos) for row_infos, _e, _p in fn2.plans)
    assert n_insns == 3 and len(fn2.plans) == 1


def test_epilogue_reuses_direct_output_slot():
    """An epilogue consuming exactly a traced-output einsum value reuses
    that output's instruction slot instead of recomputing it."""
    d = _data()

    def user(u, D):
        a = jnp.einsum("ej,ij->ei", u, D)
        return a, jnp.exp(a)

    fn2 = f.compile_fn_with_archive(user, [d["u"], d["D"][0]])
    got = fn2(d["u"], d["D"][0])
    ref = user(d["u"], d["D"][0])
    for g, r in zip(got, ref):
        np.testing.assert_allclose(np.asarray(g), np.asarray(r),
                                   rtol=2e-4, atol=1e-5)
    n_insns = sum(len(row_infos) for row_infos, _e, _p in fn2.plans)
    assert n_insns == 1


def test_epilogue_with_raw_input_term():
    """The epilogue slice may mix frontier einsum values with raw inputs."""
    d = _data()

    def user(u, D):
        return jnp.tanh(jnp.einsum("ej,ij->ei", u, D)) + u

    fn2 = f.compile_fn_with_archive(user, [d["u"], d["D"][0]])
    np.testing.assert_allclose(np.asarray(fn2(d["u"], d["D"][0])),
                               np.asarray(user(d["u"], d["D"][0])),
                               rtol=2e-5, atol=1e-6)


def test_pure_non_einsum_fn_still_rejects():
    from feinsum_tpu.diagnostics import EinsumMatchError
    d = _data()
    with pytest.raises(EinsumMatchError, match="outside the batched-einsum"):
        f.compile_fn_with_archive(lambda x: jnp.tanh(x), [d["u"]])


def test_get_a_matched_einsum_inside_larger_kernel():
    """Matching surfaces accept epilogues too (the lookup half of the
    reference's match_t_unit_to_einsum promise)."""
    d = _data()

    def user(u, D):
        return jnp.tanh(jnp.einsum("ej,ij->ei", u, D))

    einsum, name_map = f.get_a_matched_einsum(user, [d["u"], d["D"][0]])
    assert name_map == {"u": 0, "D": 1}
    assert len(einsum.out_idx_set) == 2


def test_epilogue_where_and_nested_jit_and_reduction():
    """Epilogue slices replay arbitrary primitives: select_n (a limiter's
    jnp.where), a user's nested-jit filter (pjit eqn), and a full
    reduction diagnostic (max-norm)."""
    d = _data()
    u, D = d["u"], d["D"][0]

    def limiter(u, D):
        a = jnp.einsum("ej,ij->ei", u, D)
        return jnp.where(a > 0, a, 0.1 * a)

    @jax.jit
    def filt(x):
        return jnp.tanh(x) * 0.5

    def filtered(u, D):
        return filt(jnp.einsum("ej,ij->ei", u, D))

    def norm(u, D):
        return jnp.max(jnp.abs(jnp.einsum("ej,ij->ei", u, D)))

    for user in (limiter, filtered, norm):
        fn2 = f.compile_fn_with_archive(user, [u, D])
        np.testing.assert_allclose(np.asarray(fn2(u, D)),
                                   np.asarray(user(u, D)),
                                   rtol=2e-4, atol=1e-5)


def test_default_spot_check_skips_corrupted_archive_row(tmp_path):
    """VERDICT r3 #6: a champion recorded under an emitter that now
    builds-but-miscomputes must not be served silently.  A corrupt impl
    (transposes the square operand: builds fine, wrong values) is planted
    as the top row; the default path must numerically spot-check it at
    tiny length and fall through to the opt_einsum program."""
    from feinsum_tpu import sql_utils

    corrupt_mod = tmp_path / "corrupt_v0.py"
    corrupt_mod.write_text(
        "from dataclasses import replace\n"
        "from feinsum_tpu.tuning import BoolParameter, transform_param\n"
        "\n"
        "@transform_param('corrupt', lambda e: BoolParameter())\n"
        "def transform(program, corrupt):\n"
        "    # transpose the SQUARE operand's indices: builds fine (same\n"
        "    # shapes), computes the wrong values\n"
        "    sch = program.schedule\n"
        "    ins, out = sch.subscripts[0].split('->')\n"
        "    a, b = ins.split(',')\n"
        "    new = a + ',' + b[::-1] + '->' + out\n"
        "    return program.copy(schedule=replace(\n"
        "        sch, subscripts=(new,) + sch.subscripts[1:]))\n")

    db = str(tmp_path / "scratch.sqlite")
    e = f.einsum("ej,ij->ei", f.array("u", ("E", 20), "float32"),
                 f.array("D", (20, 20), "float32"))
    sql_utils.record_facts(e, transform_id=str(corrupt_mod),
                           transform_params={"corrupt": True},
                           runtime_in_sec=1e-9,  # sorts first in the ladder
                           device=f.FakeDevice("NVIDIA H100 80GB HBM3"), db_path=db,
                           long_dim_length=2048)

    rng = np.random.default_rng(3)
    u = jnp.asarray(rng.random((2048, 20), np.float32))
    M = jnp.asarray(rng.random((20, 20), np.float32))

    def user(dofs, op):
        return jnp.einsum("nq,dq->nd", dofs, op)

    # spot_check=False serves the corrupt champion: WRONG values (this is
    # the failure mode the default guards against)
    fn_bad = f.compile_fn_with_archive(user, [u, M], db_path=db,
                                       device=f.FakeDevice("NVIDIA H100 80GB HBM3"),
                                       long_dim_length=500,
                                       spot_check=False)
    assert not np.allclose(np.asarray(fn_bad(u, M)),
                           np.asarray(user(u, M)), rtol=1e-3)

    # default path: the spot check rejects it, ladder falls through,
    # values are right
    fn2 = f.compile_fn_with_archive(user, [u, M], db_path=db,
                                    device=f.FakeDevice("NVIDIA H100 80GB HBM3"),
                                    long_dim_length=500)
    _close(fn2(u, M), user(u, M))


def test_dg_lane_pack_champion_served_from_archive(tmp_path):
    """A planted DG lane-pack champion (div class, g=32 + rowcat) replays
    through compile_fn_with_archive: pack/kron/expand contracts applied,
    packed rowcat output unpacked and row-sliced, values match."""
    from feinsum_tpu import sql_utils

    db = str(tmp_path / "scratch.sqlite")
    e = f.batched_einsum(
        "es,sij,ej->ei",
        [[f.array(jn, ("E", 3), "float32"),
          f.array("R", (3, 4, 4), "float32"),
          f.array(un, ("E", 4), "float32")]
         for jn, un in [("Jx", "ux"), ("Jy", "uy"), ("Jz", "uz")]])
    params = {"log2_block": 6, "blkc128": 0, "dofmajor": False,
              "fold": False, "preblock": False, "precision_3x": False,
              "hoist": False, "jfold": False, "mfold": False,
              "prereduce": False, "lane_pack_g": 5, "parallel_grid": True,
              "vmem_idx": 2, "split_rows": False, "accum_f32": False,
              "host_hoist": True, "rowcat": True}
    sql_utils.record_facts(e, transform_id="dg_div_v0.py",
                           transform_params=params, runtime_in_sec=1e-4,
                           device=f.FakeDevice("NVIDIA H100 80GB HBM3"), db_path=db,
                           long_dim_length=2048)

    rng = np.random.default_rng(11)
    d = {n: jnp.asarray(rng.random(s, np.float32))
         for n, s in [("Jx", (2048, 3)), ("Jy", (2048, 3)),
                      ("Jz", (2048, 3)), ("R", (3, 4, 4)),
                      ("ux", (2048, 4)), ("uy", (2048, 4)),
                      ("uz", (2048, 4))]}

    def user(Jx, Jy, Jz, R, ux, uy, uz):
        return (jnp.einsum("es,sij,ej->ei", Jx, R, ux),
                jnp.einsum("es,sij,ej->ei", Jy, R, uy),
                jnp.einsum("es,sij,ej->ei", Jz, R, uz))

    args = [d[n] for n in ("Jx", "Jy", "Jz", "R", "ux", "uy", "uz")]
    fn2 = f.compile_fn_with_archive(user, args, db_path=db,
                                    device=f.FakeDevice("NVIDIA H100 80GB HBM3"),
                                    long_dim_length=500)
    prog = fn2.plans[0][2]
    assert prog.descriptor.lane_pack == 32
    assert prog.descriptor.rowcat == 3
    got, ref = fn2(*args), user(*args)
    for g_, r_ in zip(got, ref):
        _close(g_, r_)


def test_plan_cache_memoizes_and_invalidates(tmp_path):
    import os
    import shutil
    import time

    from feinsum_tpu import apply as apply_mod
    from feinsum_tpu import sql_utils

    db = str(tmp_path / "memo.sqlite")
    shutil.copy(sql_utils.DEFAULT_DB, db)
    d = _data()

    def user(J, D, u):
        return jnp.einsum("es,sij,ej->ei", J, D, u)

    args = [d["J"], d["D"], d["u"]]
    fn_a = f.compile_fn_with_archive(user, args, db_path=db)
    fn_b = f.compile_fn_with_archive(user, args, db_path=db)
    assert fn_b is fn_a          # memo hit: same jaxpr + options + archive

    # a DIFFERENT structure (or option set) must not collide
    fn_c = f.compile_fn_with_archive(user, args, db_path=db,
                                     long_dim_length=777)
    assert fn_c is not fn_a

    # recording into the archive (any mtime bump) invalidates the memo
    t = time.time() + 2
    os.utime(db, (t, t))
    fn_d = f.compile_fn_with_archive(user, args, db_path=db)
    assert fn_d is not fn_a
    _close(fn_d(*args), user(*args))

    # a big on-device closure const would have to be copied to the host
    # to hash -> caching is skipped, never wrong
    big = jnp.asarray(np.random.default_rng(2).random((1024, 64),
                                                      np.float32))

    def closure_fn(J, D, u):
        return jnp.einsum("es,sij,ej->ei", J, D, u) + big[:, :8] * 0.0

    key = apply_mod._plan_cache_key(
        jax.make_jaxpr(closure_fn)(*args), 100, None, db, None, False, True)
    assert key is None


def test_shared_expr_operand_across_plans_evaluates_once():
    # reference cse.py's purpose at the consumer surface: an operand
    # EXPRESSION feeding two structurally-different einsums (two separate
    # plans) must be computed once per call, not once per plan.  The
    # whole expr/scale pass is a single _backward_slice_eval walk whose
    # env computes each equation once; this pins that contract.
    from feinsum_tpu import apply as apply_mod

    d = _data()

    def user(J, D, u):
        w = jnp.tanh(J)                              # shared expression
        vol = jnp.einsum("es,sij,ej->ei", w, D, u)   # div class
        tot = jnp.einsum("es->e", w)                 # rowsum class
        return vol, tot

    args = [d["J"], d["D"], d["u"]]
    fn2 = f.compile_fn_with_archive(user, args)
    assert len(fn2.plans) == 2     # genuinely separate plans

    calls = []
    orig = apply_mod._backward_slice_eval

    def counting(*a, **kw):
        calls.append(a[3])         # the targets argument
        return orig(*a, **kw)

    apply_mod._backward_slice_eval = counting
    try:
        got = fn2(*args)
    finally:
        apply_mod._backward_slice_eval = orig

    ref = user(*args)
    _close(got[0], ref[0])
    _close(got[1], ref[1])
    # one expr/scale pass for the whole call (no epilogue here); the
    # tanh var appears once in its targets even though both plans use it
    assert len(calls) == 1
    tanh_vars = [v for v in calls[0] if str(v.aval.shape) == str(d["J"].shape)]
    assert len(tanh_vars) == 1


def test_plan_shootout_picks_measured_winner(tmp_path, monkeypatch):
    """Live consumer probes (2026-08-19, twice) showed no host-side model
    can rank candidates the archive doesn't cover: the div class held no
    fast layout-free row, so the scorer's best pick still ran 7x slower
    than the user's raw XLA program.  With shootout=True the top finalists
    AND the raw opt_einsum program are timed on device and the measured
    winner is served."""
    from feinsum_tpu import measure, sql_utils

    mod = tmp_path / "slow_v0.py"
    mod.write_text(
        "from feinsum_tpu.codegen.descriptor import ScheduleDescriptor\n"
        "from feinsum_tpu.tuning import BoolParameter, transform_param\n"
        "\n"
        "@transform_param('x', lambda e: BoolParameter())\n"
        "def transform(program, x):\n"
        "    e = program.einsum\n"
        "    return program.copy(descriptor=ScheduleDescriptor(\n"
        "        backend='xla',\n"
        "        arg_layouts=((e.args[0][0].name, (0, 1)),)))\n")
    db = str(tmp_path / "scratch.sqlite")
    e = f.einsum("ej,ij->ei", f.array("u", ("E", 20), "float32"),
                 f.array("D", (20, 20), "float32"))
    dev = f.FakeDevice("NVIDIA H100 80GB HBM3")
    sql_utils.record_facts(e, transform_id=str(mod),
                           transform_params={"x": True},
                           runtime_in_sec=1e-6, device=dev, db_path=db,
                           long_dim_length=2048)

    rng = np.random.default_rng(7)
    u = jnp.asarray(rng.random((2048, 20), np.float32))
    M = jnp.asarray(rng.random((20, 20), np.float32))

    def user(dofs, op):
        return jnp.einsum("nq,dq->nd", dofs, op)

    # fake on-device timer: the archived candidate "measures" slow, the
    # raw opt_einsum program fast — the raw program must win the plan
    times = iter([5e-3, 1e-4])
    calls = []

    def fake_time(runner, arrays, **kw):
        calls.append(runner)
        return next(times)

    monkeypatch.setattr(measure, "_timeit_in_graph", fake_time)
    fn2 = f.compile_fn_with_archive(user, [u, M], db_path=db, device=dev,
                                    long_dim_length=500, shootout=True)
    _close(fn2(u, M), user(u, M))
    assert len(calls) == 2
    (_infos, _e, program), = fn2.plans
    # the raw opt_einsum program (empty arg_layouts) won on measured time
    assert program.descriptor.arg_layouts == ()
    # reversed measurement: the archived candidate (identity arg_layouts
    # marker) wins instead
    times2 = iter([1e-4, 5e-3])
    monkeypatch.setattr(measure, "_timeit_in_graph",
                        lambda r, a, **kw: next(times2))
    fn3 = f.compile_fn_with_archive(user, [u, M], db_path=db, device=dev,
                                    long_dim_length=501, shootout=True)
    _close(fn3(u, M), user(u, M))
    (_infos, _e, program3), = fn3.plans
    assert program3.descriptor.arg_layouts != ()
