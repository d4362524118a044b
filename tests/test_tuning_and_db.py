"""Autotuner DSL, search driver, sqlite archive, and the replay path —
modeled on the reference's tuning_impls_tests + sql_utils semantics."""

import os

import numpy as np
import pytest

import feinsum_tpu as f
from feinsum_tpu import sql_utils
from feinsum_tpu.tuning import (
    BoolParameter,
    IntParameter,
    TupleParameter,
    autotune,
    einsum_arg,
    get_transform_func_from_module_path,
    transform_param,
)


def small_div(ndof=8):
    return f.batched_einsum(
        "es,sij,ej->ei",
        [[f.array("Jx", ("E", 3), "float32"),
          f.array("R", (3, ndof, ndof), "float32"),
          f.array("ux", ("E", ndof), "float32")]])


def test_parameter_dsl():
    rng = np.random.default_rng(0)
    p = IntParameter(2, 5)
    for _ in range(20):
        assert 2 <= p.sample(rng) <= 5
        assert 2 <= p.mutate(3, rng) <= 5
    assert p.contains(4) and not p.contains(7)
    b = BoolParameter()
    assert b.contains(True) and not b.contains(3)
    t = TupleParameter((IntParameter(0, 3), BoolParameter()))
    v = t.sample(rng)
    assert t.contains(v)
    assert t.contains(t.mutate(v, rng))


def test_decorators_build_parametrized_transform():
    @transform_param("block", lambda e: IntParameter(3, 6))
    @einsum_arg("ndof", lambda e: int(e.index_to_dim_length["i"]))
    def transform(program, ndof, block):
        assert ndof == 8
        return program.with_descriptor(block_long=2 ** block)

    e = small_div()
    space = transform.get_param_space(e)
    assert set(space) == {"block"}
    tr = transform.bind_args(e, block=4)
    p = tr(f.generate_program(e))
    assert p.descriptor.block_long == 16


def test_impl_modules_load():
    for name in ("dg_div_v0", "dg_grad_v0", "face_mass_v0",
                 "elementwise_v1", "mass_v0", "tc_xla_v0",
                 "demo_transform_space"):
        pt = get_transform_func_from_module_path(name)
        assert pt.transform_params


def test_impl_transform_validates():
    e = small_div()
    pt = get_transform_func_from_module_path("dg_div_v0")
    tr = pt.bind_args(e, log2_block=8, hoist=True, parallel_grid=True,
                      dofmajor=False)
    f.validate_batched_einsum_transform(e, tr, long_dim_length=100)


def test_record_and_query_roundtrip(tmp_path):
    db = str(tmp_path / "test.sqlite")
    e = small_div()
    sql_utils.record_facts(
        e, transform_id="dg_div_v0.py",
        transform_params={"log2_block": 9, "hoist": True,
                          "parallel_grid": False, "dofmajor": False},
        runtime_in_sec=1.25e-4, device="NVIDIA H100 80GB HBM3", db_path=db,
        long_dim_length=1000)
    qs = sql_utils.query(e, "NVIDIA H100 80GB HBM3", db_path=db)
    assert len(qs) == 1
    q = qs[0]
    assert q.transform_id == "dg_div_v0.py"
    assert dict(q.transform_params)["log2_block"] == 9
    assert q.total_giga_op_rate > 0
    # renamed-but-isomorphic einsum must hit the same fact
    e2 = f.batched_einsum(
        "td,dkl,tl->tk",
        [[f.array("jac", ("NE", 3), "float32"),
          f.array("ref", (3, 8, 8), "float32"),
          f.array("dofs", ("NE", 8), "float32")]])
    qs2 = sql_utils.query(e2, "NVIDIA H100 80GB HBM3", db_path=db)
    assert len(qs2) == 1
    # and the lazy transform must bind+apply
    tr = qs2[0].transform
    prog = tr(f.generate_program(f.canonicalize_einsum(e2)))
    assert prog.descriptor.backend == "pallas"
    assert prog.descriptor.block_long == 512

    with pytest.raises(f.NoFactInDatabaseError):
        sql_utils.query(e, "NVIDIA TITAN V", db_path=db)


def test_retrieve_picks_best(tmp_path):
    db = str(tmp_path / "test.sqlite")
    e = small_div()
    for rt, blk in [(2e-4, 9), (1e-4, 10), (5e-4, 8)]:
        sql_utils.record_facts(
            e, transform_id="dg_div_v0.py",
            transform_params={"log2_block": blk, "hoist": False,
                              "parallel_grid": False, "dofmajor": False},
            runtime_in_sec=rt, device="NVIDIA H100 80GB HBM3", db_path=db,
            long_dim_length=1000)
    tr = sql_utils.retrieve(e, "NVIDIA H100 80GB HBM3", db_path=db)
    prog = tr(f.generate_program(f.canonicalize_einsum(e)))
    assert prog.descriptor.block_long == 1024


def test_get_timed_einsums_in_db(tmp_path):
    db = str(tmp_path / "test.sqlite")
    e = small_div()
    sql_utils.record_facts(
        e, transform_id="dg_div_v0.py",
        transform_params={"log2_block": 9, "hoist": True,
                          "parallel_grid": False, "dofmajor": False},
        runtime_in_sec=1e-4, device="NVIDIA H100 80GB HBM3", db_path=db,
        long_dim_length=1000)
    es = sql_utils.get_timed_einsums_in_db(db_path=db)
    assert len(es) == 1
    assert f.canonicalize_einsum(es[0]) == es[0]
    assert es[0] == f.canonicalize_einsum(e)


def test_autotune_smoke(tmp_path):
    db = str(tmp_path / "tune.sqlite")
    e = small_div()
    autotune(e, "dg_div_v0", db_path=db, long_dim_length=400,
             test_limit=3, device="NVIDIA H100 80GB HBM3",
             timeit_kwargs={"min_rounds": 5, "min_seconds": 0.02,
                            "validation_long_dim_length": 50,
                            "method": "host"})
    qs = sql_utils.query(f.canonicalize_einsum(e), "NVIDIA H100 80GB HBM3",
                         db_path=db)
    assert 1 <= len(qs) <= 3
    # resume: seeds + dedups from db, adds more points
    autotune(e, "dg_div_v0", db_path=db, long_dim_length=400,
             test_limit=2, device="NVIDIA H100 80GB HBM3",
             timeit_kwargs={"min_rounds": 5, "min_seconds": 0.02,
                            "validation_long_dim_length": 50,
                            "method": "host"})
    qs2 = sql_utils.query(f.canonicalize_einsum(e), "NVIDIA H100 80GB HBM3",
                          db_path=db)
    assert len(qs2) >= len(qs)
    params_seen = {q.transform_params for q in qs2}
    assert len(params_seen) == len(qs2), "duplicate configs re-measured"


def test_drifty_champion_ranks_by_reconfirmed_median(tmp_path):
    """VERDICT r4 weak #3 (live div10: a config claimed 4323 GOp/s, then
    re-measured 3112 = 28% drift, yet kept winning retrieve() on its lucky
    row).  With re-confirmations aggregated at the lower median, a config
    whose re-time is slow ranks by the slow sample — a consistently-
    reproducing runner-up overtakes it."""
    db = str(tmp_path / "drift.sqlite")
    e = f.einsum("ej,ij->ei", f.array("u", ("E", 16), "float32"),
                 f.array("D", (16, 16), "float32"))
    dev = f.FakeDevice("NVIDIA H100 80GB HBM3")
    # config A: lucky 1.0e-6 s + honest re-time 2.0e-6 s (drifty)
    for rt in (1.0e-6, 2.0e-6):
        sql_utils.record_facts(e, transform_id="mass_v0",
                               transform_params={"block_i": 8,
                                                 "vmem_idx": 0},
                               runtime_in_sec=rt, device=dev, db_path=db,
                               long_dim_length=2048)
    # config B: single consistent 1.5e-6 s row
    sql_utils.record_facts(e, transform_id="mass_v0",
                           transform_params={"block_i": 16, "vmem_idx": 0},
                           runtime_in_sec=1.5e-6, device=dev, db_path=db,
                           long_dim_length=2048)
    qs = sql_utils.query(e, dev, db_path=db)
    agg = sql_utils.aggregate_reconfirmations(qs)
    assert len(agg) == 2
    best = agg[0]
    assert dict(best.transform_params)["block_i"] == 16, \
        "the drifty config's lucky sample still leads"
    # A's representative is its honest (slow) re-time, not the lucky row
    a_row, = [q for q in agg
              if dict(q.transform_params)["block_i"] == 8]
    assert np.isclose(a_row.runtime_in_sec, 2.0e-6)


def test_aggregate_prefers_proto3_rows():
    """Rows measured under a retired timing instrument must not mix into
    a config's median once proto3 re-times exist."""
    from feinsum_tpu.sql_utils import QueryInfo, aggregate_reconfirmations

    def mk(rt, cver):
        return QueryInfo(transform_id="t", transform_params=(("k", "1"),),
                         runtime_in_sec=rt, compiler_version=cver,
                         giga_op_info_json='{"float32": 1.0}',
                         device_name="d", _einsum=None)

    rows = [mk(1.0e-6, "jax-x"),                      # pre-proto3, lucky
            mk(4.0e-6, "jax-x-timing-proto3"),
            mk(5.0e-6, "jax-x-timing-proto3"),
            mk(6.0e-6, "jax-x-timing-proto3")]
    agg = aggregate_reconfirmations(rows)
    assert len(agg) == 1
    assert np.isclose(agg[0].runtime_in_sec, 5.0e-6)  # proto3 median only


def test_migrate_from_reference_v6(tmp_path):
    """The migration tool reconstructs einsum classes from a reference-format
    archive (SizeParam axes come back parametric) and maps them to this
    library's schedule spaces."""
    import subprocess
    import sys

    import feinsum_tpu as f
    from feinsum_tpu import sql_utils

    src = str(tmp_path / "ref_v6.sqlite")
    e1 = f.einsum("xre,rij,ej->xei",
                  f.array("a", (3, 3, "E"), "float32"),
                  f.array("b", (3, 35, 35), "float32"),
                  f.array("c", ("E", 35), "float32"))
    e2 = f.get_tccg_benchmark(5, dtype="float32")
    for e in (e1, e2):
        sql_utils.record_facts(e, transform_id="xre_rij_ej_to_xei.py",
                               transform_params={"n_e_per_wg": 8},
                               runtime_in_sec=1e-3, db_path=src,
                               long_dim_length=1000)
    r = subprocess.run(
        [sys.executable, "-m",
         "feinsum_tpu.data.bin.migrate_from_reference_v6",
         "--src", src, "--dst", str(tmp_path / "out.sqlite")],
        capture_output=True, text=True, check=True)
    assert "2 einsum classes migrated, 0 skipped" in r.stdout, r.stdout


def test_db_hit_replay_budget(tmp_path):
    """The north-star consumer path (SURVEY.md §3.2, "<10 ms DB-hit→codegen"):
    with imports and the native canonicalizer warm, canonicalize → query the
    shipped archive → bind the stored transform → build the executable in
    under 10 ms (median of 20).  Compilation is NOT in this budget — jit is
    lazy and first-run compiles amortize through the persistent compile
    cache, exactly as the reference's caller-side generate_code_v2 is
    outside its replay path."""
    import time

    import feinsum_tpu as f
    from feinsum_tpu import sql_utils

    ndof = 35
    div = f.batched_einsum(
        "es,sij,ej->ei",
        [[f.array(jn, ("E", 3), "float32"),
          f.array("R", (3, ndof, ndof), "float32"),
          f.array(un, ("E", ndof), "float32")]
         for jn, un in [("Jx", "ux"), ("Jy", "uy"), ("Jz", "uz")]])
    dev = f.FakeDevice("NVIDIA H100 80GB HBM3")
    db = str(tmp_path / "scratch.sqlite")
    sql_utils.record_facts(
        div, transform_id="dg_div_v0.py",
        transform_params={"log2_block": 7, "dofmajor": True, "hoist": True},
        runtime_in_sec=1e-4, device=dev, db_path=db,
        long_dim_length=100_000)

    def replay():
        tr = sql_utils.retrieve(div, dev, db_path=db)
        prog = tr(f.generate_program(div))
        return f.build_executable(prog, long_dim_length=100_000)

    assert callable(replay())          # warm: imports, canon lib, sqlite
    ts = sorted((time.perf_counter(), replay(),
                 time.perf_counter())[::2] for _ in range(20))
    ts = sorted(t1 - t0 for t0, t1 in ts)
    median_ms = 1e3 * ts[len(ts) // 2]
    assert median_ms < 10.0, f"DB-hit replay took {median_ms:.2f} ms (median)"


def test_ttgt_replay_uses_target_program_names(tmp_path):
    """Archive replay binds params against the CANONICAL einsum (names
    arg_0...), but layout choices must land on the *target program's*
    operand names (bench r2 regression: KeyError 'arg_0' on every TCCG
    ttgt replay)."""
    import feinsum_tpu as f
    from feinsum_tpu import sql_utils

    e = f.einsum("ikl,ljk->ij",
                 f.array("left", (32, 24, 16), "float32"),
                 f.array("right", (16, 40, 24), "float32"))
    db = str(tmp_path / "t.sqlite")
    sql_utils.record_facts(
        e, transform_id="ttgt_v0.py",
        transform_params={"perm_a": 1, "perm_b": 1, "perm_out": 1,
                          "precision_idx": 1},
        runtime_in_sec=1e-3, db_path=db, long_dim_length=100)
    tr = sql_utils.retrieve(e, db_path=db)
    prog = tr(f.generate_program(e))
    names = {n for n, _ in prog.descriptor.arg_layouts}
    assert names == {"left", "right"}, names
    f.validate_batched_einsum_transform(e, tr, long_dim_length=100)


def test_position_sensitive_params_replay_canonically(tmp_path):
    """Operand-position-sensitive params (tc_gemm_v0 ``swap``, ttgt_v0
    ``perm_a``/``perm_b``) are archived relative to CANONICAL operand
    positions, but replay applies the transform to the user-ordered
    program.  On einsums whose canonical operand order differs from the
    user's (TCCG #02 ``dca,bd->abc`` -> ``jl,lki->ijk``, sigma_j=(1,0))
    the params must be routed through
    :func:`canonicalization.canonical_operand_positions` — bench r2
    regression: tccg_02's archived champion replayed with the
    resident/streamed roles flipped."""
    import feinsum_tpu as f
    from feinsum_tpu.canonicalization import (
        canonical_operand_positions,
        canonicalize_einsum,
    )
    from feinsum_tpu.tuning import get_transform_func_from_module_path

    e = f.einsum("dca,bd->abc",
                 f.array("T", (24, 16, 48), "float32"),
                 f.array("U", (32, 24), "float32"))
    ce = canonicalize_einsum(e)
    assert canonical_operand_positions(e) == (1, 0)
    # idempotence precondition: params tuned on the canonical einsum are
    # stored against identity positions
    assert canonical_operand_positions(ce) == (0, 1)

    pt = get_transform_func_from_module_path("tc_gemm_v0.py")
    params = dict(log2_block=9, blkc128=0, backend_pallas=False,
                  precision_idx=0, swap=False, dofmajor=False, fold=False,
                  vmem_idx=2)
    tr = pt.bind_args(ce, **params)
    p_canon = tr(f.generate_program(ce))
    p_user = tr(f.generate_program(e))
    # the rewritten 2D GEMM must have the same geometry either way: same
    # resident (N, K) factor, same streamed K width
    shapes_of = lambda p: sorted(
        tuple(int(d) for d in a.shape if not hasattr(d, "name"))
        for a in p.einsum.args[0])
    assert shapes_of(p_canon) == shapes_of(p_user)
    f.validate_batched_einsum_transform(e, tr, long_dim_length=100)

    # ttgt: rank-asymmetric operands — a perm applied to the wrong
    # position would have the wrong length
    pt2 = get_transform_func_from_module_path("ttgt_v0.py")
    tr2 = pt2.bind_args(ce, perm_a=0, perm_b=1, perm_out=0,
                        precision_idx=1, natural_out=1)
    prog2 = tr2(f.generate_program(e))
    ranks = {"T": 3, "U": 2}
    for name, perm in prog2.descriptor.arg_layouts:
        assert len(perm) == ranks[name], (name, perm)
    f.validate_batched_einsum_transform(e, tr2, long_dim_length=100)


def test_bench_candidate_ladder_dedups(monkeypatch):
    """bench's fallback ladder: re-timed copies of one champion collapse to
    one slot so a genuine runner-up is always reachable."""
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import bench
    import feinsum_tpu as f

    e = f.einsum("ej,ij->ei", f.array("u", ("E", 8), "float32"),
                 f.array("D", (8, 8), "float32"))

    class FakeQ:
        def __init__(self, rate, params):
            self.transform_id = "mass_v0.py"
            self.transform_params = tuple(sorted(params.items()))
            self.total_giga_op_rate = rate
            self.compiler_version = "jax=x timing-proto3"
            self.transform = lambda p: p

    dup = {"log2_block": 10}
    other = {"log2_block": 11}
    monkeypatch.setattr(bench.sql_utils, "query",
                        lambda einsum, *a, **k: [
                            FakeQ(100.0, dup), FakeQ(99.0, dup),
                            FakeQ(98.0, dup), FakeQ(97.0, dup),
                            FakeQ(50.0, other)])
    labels = [label for label, _ in
              bench.candidate_transforms("row", e)]
    assert len(labels) == 3            # dup champion, runner-up, default
    assert labels[-1] == "built-in default"


def test_shipped_archive_integrity():
    """Every einsum class in the SHIPPED archive reconstructs (canonical
    soundness asserts inside get_timed_einsums_in_db) and its best fact's
    transform binds against the canonical einsum — catches archive
    corruption and params/space drift after tuning sessions."""
    es = sql_utils.get_timed_einsums_in_db()     # asserts soundness per row
    assert len(es) >= 50
    bound = 0
    for e in es:
        qs = sql_utils.query(e, "TPU v5 lite", err_if_no_results=False)
        if not qs:
            continue                              # facts from another device
        best = max(qs, key=lambda q: q.total_giga_op_rate)
        assert callable(best.transform)           # lazy import + bind
        bound += 1
    assert bound >= 50, f"only {bound} classes have TPU_v5_lite champions"


def test_dg_spaces_share_full_knob_set():
    """VERDICT r2 weak #7 / next #6: ONE definition site for the DG spaces —
    every family exposes the full knob vocabulary; structurally inapplicable
    knobs gate to a pinned-off IntParameter(0,0)."""
    from feinsum_tpu.tuning import (
        BoolParameter, IntParameter, get_transform_func_from_module_path)
    import feinsum_tpu as f

    ndof = 7
    div = f.batched_einsum(
        "es,sij,ej->ei",
        [[f.array(j, ("E", 3), "float32"),
          f.array("R", (3, ndof, ndof), "float32"),
          f.array(u, ("E", ndof), "float32")]
         for j, u in [("Jx", "ux"), ("Jy", "uy"), ("Jz", "uz")]])
    curl = f.batched_einsum(
        "e,rij,ej->ei",
        [[f.array(j, ("E",), "float32"),
          f.array("D", (3, ndof, ndof), "float32"),
          f.array(u, ("E", ndof), "float32")]
         for j, u in [("Jy", "uz"), ("Jz", "ux"), ("Jx", "uy")]])
    matvec = f.einsum("ej,ij->ei", f.array("u", ("E", ndof), "float32"),
                      f.array("D", (ndof, ndof), "float32"))

    modules = ["dg_div_v0", "dg_grad_v0", "face_mass_v0", "curl_3d_v0",
               "mass_v0"]
    spaces = {m: get_transform_func_from_module_path(m).get_param_space(div)
              for m in modules}
    names = {m: set(sp) for m, sp in spaces.items()}
    assert len(set(map(frozenset, names.values()))) == 1, names
    for knob in ("prereduce", "jfold", "host_hoist", "hoist", "log2_warps",
                 "num_stages"):
        assert knob in names["dg_div_v0"]

    sp = get_transform_func_from_module_path("curl_3d_v0")
    # curl: prereduce gates ON (D's r is private); div: OFF (R's s is shared)
    assert isinstance(sp.get_param_space(curl)["prereduce"], BoolParameter)
    assert isinstance(sp.get_param_space(div)["prereduce"], IntParameter)
    # matvec: jfold gates OFF (single streamed operand)
    assert isinstance(sp.get_param_space(matvec)["jfold"], IntParameter)
    # archived params from the pre-consolidation narrower spaces still bind
    tr = sp.bind_args(curl, log2_block=7, dofmajor=True, parallel_grid=True,
                      hoist=False)
    f.validate_batched_einsum_transform(curl, tr, long_dim_length=640)


def test_permutation_parameter_and_ttgt_v1():
    """PermutationParameter: structured tuple values, transposition-swap
    mutation (VERDICT r2 missing #3); ttgt_v1 searches it directly."""
    import numpy as np
    from feinsum_tpu.tuning import (
        PermutationParameter, get_transform_func_from_module_path)
    import feinsum_tpu as f

    p = PermutationParameter(4)
    rng = np.random.default_rng(0)
    v = p.sample(rng)
    assert p.contains(v) and sorted(v) == [0, 1, 2, 3]
    m = p.mutate(v, rng)
    assert p.contains(m)
    assert sum(a != b for a, b in zip(v, m)) == 2    # one transposition
    assert not p.contains((0, 1, 1, 2))

    e = f.get_tccg_benchmark(3, dtype="float32")
    sp = get_transform_func_from_module_path("ttgt_v1")
    space = sp.get_param_space(e)
    assert isinstance(space["layout_a"], PermutationParameter)
    ra = space["layout_a"].ndim
    rb = space["layout_b"].ndim
    ro = space["layout_out"].ndim
    tr = sp.bind_args(e, layout_a=tuple(range(ra))[::-1],
                      layout_b=tuple(range(rb)),
                      layout_out=tuple(range(ro)), precision_idx=1,
                      natural_out=1)
    f.validate_batched_einsum_transform(e, tr, long_dim_length=24)




def test_autotune_shards_partition_the_sweep(tmp_path):
    """SURVEY §5: the measurement sweep shards across chips as concurrent
    processes sharing one archive — proposals hash into disjoint buckets,
    both shards record into the same DB, and the union seeds later runs."""
    from feinsum_tpu import sql_utils
    from feinsum_tpu.tuning import autotune

    e = f.einsum("ej,ij->ei", f.array("u", ("E", 16), "float32"),
                 f.array("D", (16, 16), "float32"))
    db = str(tmp_path / "t.sqlite")
    kw = dict(db_path=db, device=f.FakeDevice("NVIDIA H100 80GB HBM3"),
              long_dim_length=512, test_limit=4,
              timeit_kwargs=dict(min_rounds=1, min_seconds=0.01,
                                 validation_long_dim_length=512))
    autotune(e, "mass_v0", shard=(0, 2), seed=7, **kw)
    rows0 = sql_utils.query(e, f.FakeDevice("NVIDIA H100 80GB HBM3"), db_path=db,
                            err_if_no_results=False)
    autotune(e, "mass_v0", shard=(1, 2), seed=7, **kw)
    rows1 = sql_utils.query(e, f.FakeDevice("NVIDIA H100 80GB HBM3"), db_path=db,
                            err_if_no_results=False)
    assert len(rows1) > len(rows0) >= 1
    # every recorded config belongs to exactly the shard that measured it
    import zlib
    def bucket(params):
        return zlib.crc32(repr(tuple(sorted(params.items()))).encode()) % 2
    new0 = {tuple(sorted(q.transform_params)) for q in rows0}
    for q in rows0:
        assert bucket(dict(q.transform_params)) == 0
    for q in rows1:
        if tuple(sorted(q.transform_params)) not in new0:
            assert bucket(dict(q.transform_params)) == 1


def test_retire_is_nondestructive_and_restorable(tmp_path):
    """r4 incident: the over-reporter retire pass deleted two HONEST
    champion rows after contention-polluted re-timings.  Retire must move
    rows to the retired-facts stash, and restore_retired must bring them
    back byte-identical."""
    import sqlite3
    import subprocess
    import sys

    from feinsum_tpu import sql_utils

    db = str(tmp_path / "scratch.sqlite")
    e = f.einsum("ej,ij->ei", f.array("u", ("E", 8), "float32"),
                 f.array("D", (8, 8), "float32"))
    params = {"log2_block": 10}
    sql_utils.record_facts(e, transform_id="mass_v0.py",
                           transform_params=params, runtime_in_sec=1e-4,
                           device=f.FakeDevice("NVIDIA H100 80GB HBM3"), db_path=db,
                           long_dim_length=1024)
    conn = sqlite3.connect(db)
    before = conn.execute(
        f"SELECT * FROM {sql_utils.TIMINGS_TABLENAME}").fetchall()
    conn.close()
    assert len(before) == 1

    n = sql_utils.retire_rows_where("transform_id = ?", ["mass_v0.py"],
                                    reason="test", db_path=db)
    assert n == 1
    conn = sqlite3.connect(db)
    assert conn.execute(
        f"SELECT COUNT(*) FROM {sql_utils.TIMINGS_TABLENAME}"
        ).fetchone()[0] == 0
    stash = conn.execute(
        f"SELECT retire_reason FROM {sql_utils.RETIRED_TABLENAME}"
        ).fetchall()
    conn.close()
    assert stash == [("test",)]

    rc = subprocess.run(
        [sys.executable, "-m", "feinsum_tpu.data.bin.restore_retired",
         "--db", db, "--transform-id", "mass_v0.py"],
        capture_output=True, text=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert rc.returncode == 0, rc.stderr
    conn = sqlite3.connect(db)
    after = conn.execute(
        f"SELECT * FROM {sql_utils.TIMINGS_TABLENAME}").fetchall()
    n_stash = conn.execute(
        f"SELECT COUNT(*) FROM {sql_utils.RETIRED_TABLENAME}").fetchone()[0]
    conn.close()
    assert after == before
    assert n_stash == 0


