"""
End-to-end proof that feinsum runs on one NVIDIA GPU at full width.

    python chip_smoke.py            # one card: phases 1-6 below
    python chip_smoke.py --chips 4  # four cards: only the sharded phase

Phases (one process; any failure exits non-zero):

1. the device: JAX's platform must be ``gpu``; the card's name and power
   limit (``nvidia-smi``), its roofline-table row, and which canonicalizer
   runs;
2. every DG kernel class (div, grad, face-mass, mass, curl at ndof 35; div
   and grad at ndof 4, 10, 20) compiled for the card at E = 1M elements and
   compared once with the float64 numpy oracle (``measure._numpy_oracle``);
3. fp64 through XLA for the five DG classes at ndof 35, against the same
   oracle at rtol 1e-12;
4. the P4 wave operator (5 steps at E = 1M), a user's DG right-hand side
   through ``compile_fn_with_archive``, and the archive loop (autotune ->
   retrieve -> replay at E = 1M);
5. each phase-2 class at ndof 35 and the wave step, timed as the Pallas
   kernel and as the plain XLA program (median of 20 launches), and the
   bench's TCCG sample through XLA against the roofline;
6. the tests marked ``gpu``, in this process.

The last line of standard output is one JSON object naming the device.
The phase functions take the element count, so the tests rehearse them on
the CPU at a tiny size with Pallas in interpret mode; ``main`` refuses any
platform but ``gpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

E_FULL = 1_000_000
NDOF = 35
OUT_DIR = "smoke_out"   # scratch archive and phase-5 times (gitignored)
F32_TOL = 1e-5        # atol = F32_TOL * max|ref|
F64_RTOL = 1e-12


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them (a child
    process that never touches JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# {{{ einsums and programs

def dg_classes(ndof: int = NDOF, dtype: str = "float32") -> dict:
    """The five DG operator classes of the benchmark suite."""
    import feinsum_tpu as f

    def arr(name, shape):
        return f.array(name, shape, dtype)

    div = f.batched_einsum(
        "es,sij,ej->ei",
        [[arr(jn, ("E", 3)), arr("R", (3, ndof, ndof)), arr(un, ("E", ndof))]
         for jn, un in [("Jx", "ux"), ("Jy", "uy"), ("Jz", "uz")]])
    grad = f.einsum("xre,rij,ej->xei", arr("J", (3, 3, "E")),
                    arr("D", (3, ndof, ndof)), arr("u", ("E", ndof)))
    face = f.einsum("ifj,fe,fej->ei", arr("L", (ndof, 4, 15)),
                    arr("Fj", (4, "E")), arr("flux", (4, "E", 15)))
    mass = f.einsum("e,ij,ej->ei", arr("jac", ("E",)),
                    arr("M", (ndof, ndof)), arr("u", ("E", ndof)))
    curl = f.batched_einsum(
        "e,rij,ej->ei",
        [[arr(j, ("E",)), arr("D", (3, ndof, ndof)), arr(u, ("E", ndof))]
         for j, u in [("Jy", "uz"), ("Jz", "ux"), ("Jx", "uy")]])
    return {"div": div, "grad": grad, "face": face, "mass": mass,
            "curl": curl}


def kernel_program(einsum):
    """The built-in Pallas kernel schedule (no archive fact on the card)."""
    import feinsum_tpu as f
    from feinsum_tpu.tuning.impls._common import default_pallas_program
    return default_pallas_program(f.generate_program(einsum))


def xla_program(einsum):
    """The plain XLA program: opt_einsum schedule at HIGHEST precision."""
    import feinsum_tpu as f
    return f.generate_program_with_opt_einsum_schedule(
        einsum).with_descriptor(backend="xla", precision="highest")


def run_and_compare(einsum, program, n: int, *, rtol: float = 0.0,
                    atol_frac: float = F32_TOL, memory: bool = False,
                    seed: int = 0) -> float:
    """Compile *program* at long-axis length *n*, run it once and compare
    every row with the float64 oracle: |got - ref| <= atol_frac*max|ref| +
    rtol*|ref|.  Returns the worst error relative to max|ref|; raises on a
    mismatch, a non-finite value or a wrong shape."""
    import jax

    import feinsum_tpu as f
    from feinsum_tpu.measure import _numpy_oracle, generate_input_arrays

    raw = generate_input_arrays(einsum, long_dim_length=n, seed=seed,
                                as_numpy=True)
    refs = _numpy_oracle(einsum, {k: v.astype(np.float64)
                                  for k, v in raw.items()})
    fn = f.build_executable(program, long_dim_length=n)   # enables x64
    arrays = {k: jax.device_put(v)
              for k, v in f.apply_layouts(program, raw).items()}
    compiled = fn.lower(arrays).compile()
    if memory:
        log(f"    memory_analysis: {compiled.memory_analysis()}")
    outs = compiled(arrays)
    worst = 0.0
    for out, ref in zip(outs, refs):
        got = np.asarray(f.unpack_output(program, np.asarray(out),
                                         ref.shape), np.float64)
        if got.shape != ref.shape or not np.all(np.isfinite(got)):
            raise AssertionError(
                f"{einsum.get_subscripts()}: shape {got.shape} vs"
                f" {ref.shape}, finite={bool(np.all(np.isfinite(got)))}")
        scale = float(np.max(np.abs(ref))) or 1.0
        err = np.abs(got - ref)
        if np.any(err > atol_frac * scale + rtol * np.abs(ref)):
            raise AssertionError(
                f"{einsum.get_subscripts()}: max error"
                f" {float(err.max()) / scale:.3e}*max|ref| over tolerance"
                f" (atol {atol_frac:g}*max|ref|, rtol {rtol:g})")
        worst = max(worst, float(err.max()) / scale)
    return worst

# }}}


# {{{ phases

def phase_device(expect_count: int = 1) -> dict:
    """Phase 1: a GPU platform, its table row, and the canonicalizer."""
    import jax

    from feinsum_tpu.canonicalization import _get_native
    from feinsum_tpu.data.device_info import (
        DEV_TO_PEAK_BW, DEV_TO_PEAK_GFLOPS, get_device_key)

    devs = jax.devices()
    d = devs[0]
    if d.platform != "gpu":
        raise SystemExit(
            f"chip_smoke needs a GPU; JAX found {d.platform!r}")
    if len(devs) < expect_count:
        raise SystemExit(f"need {expect_count} cards, found {len(devs)}")
    key = get_device_key(d)
    if key not in DEV_TO_PEAK_GFLOPS:
        raise SystemExit(f"no roofline row for {key!r}")
    canon = "native (g++)" if _get_native() is not None else "python"
    info = {"platform": d.platform, "kind": d.device_kind,
            "count": len(devs)}
    log(f"phase 1 device: {info}; table row {key}: "
        f"{DEV_TO_PEAK_GFLOPS[key]} GFLOP/s, {DEV_TO_PEAK_BW[key]} GB/s;"
        f" canonicalizer {canon}")
    return info


def phase_kernels(n: int, extra_ndofs=(4, 10, 20)) -> None:
    """Phase 2: each Pallas kernel class against the f64 oracle."""
    cases = [(name, NDOF, e) for name, e in dg_classes(NDOF).items()]
    for ndof in extra_ndofs:
        classes = dg_classes(ndof)
        cases += [("div", ndof, classes["div"]),
                  ("grad", ndof, classes["grad"])]
    for name, ndof, einsum in cases:
        t0 = time.perf_counter()
        prog = kernel_program(einsum)
        err = run_and_compare(einsum, prog, n, memory=True)
        log(f"phase 2 kernel {name} ndof {ndof} E={n}: max err"
            f" {err:.2e}*max|ref| (tol {F32_TOL:g}*max|ref|, precision"
            f" {prog.descriptor.precision} = bf16_3x split, block"
            f" {prog.descriptor.block_long}), {time.perf_counter() - t0:.1f}"
            " s with compile")


def phase_fp64(n: int) -> None:
    """Phase 3: fp64 through XLA's native double arithmetic."""
    for name, einsum in dg_classes(NDOF, "float64").items():
        err = run_and_compare(einsum, xla_program(einsum), n,
                              rtol=F64_RTOL, atol_frac=F64_RTOL)
        log(f"phase 3 fp64 {name} ndof {NDOF} E={n}: max err"
            f" {err:.2e}*max|ref| (rtol {F64_RTOL:g}, XLA HIGHEST)")


def phase_wave(n: int, steps: int = 5) -> None:
    """Phase 4a: the P4 wave operator, kernel vs XLA programs."""
    import jax

    from feinsum_tpu.models.wave import WaveOperator3D, make_wave_state

    finals = {}
    for use_pallas in (True, False):
        op = WaveOperator3D(ndof=NDOF, nfacedof=15, nfaces=4,
                            use_pallas=use_pallas)
        step = jax.jit(op.make_step(n))
        state, geom = make_wave_state(n, ndof=NDOF)
        for _ in range(steps):
            state = step(state, geom)
        state = jax.block_until_ready(state)
        finals[use_pallas] = {k: np.asarray(v, np.float64)
                              for k, v in state.items()}
    for k, ref in finals[False].items():
        got = finals[True][k]
        if got.shape != ref.shape or not np.all(np.isfinite(got)):
            raise AssertionError(f"wave {k}: bad shape or non-finite")
        err = float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))
        if err > F32_TOL:
            raise AssertionError(f"wave {k}: kernel vs XLA {err:.2e}")
        log(f"phase 4 wave: {steps} steps at E={n}, {k} {got.shape}"
            f" finite; kernel vs XLA max diff {err:.2e}*max|ref|")


def user_rhs(dt, J, Jx, Jy, Jz, D, u, ux, uy, uz, L, Fj, flux):
    """A user's DG right-hand side in plain jnp.einsum calls: grad, a
    componentwise div with an affine-rescaled jacobian, a face lift, and a
    tanh epilogue."""
    import jax.numpy as jnp
    grad = jnp.einsum("xre,rij,ej->xei", J, D, u)
    div = (jnp.einsum("es,sij,ej->ei", Jx, D, ux)
           + jnp.einsum("es,sij,ej->ei", Jy, D, uy)
           - jnp.einsum("es,sij,ej->ei", 2.0 * Jz + 1.0, D, uz))
    lift = jnp.einsum("ifj,fe,fej->ei", L, Fj, flux)
    return jnp.tanh(dt * (div - 0.5 * lift)), grad


def phase_consumer(n: int) -> None:
    """Phase 4b: compile_fn_with_archive against plain jax.jit at
    HIGHEST.  The shipped archive holds no fact for this device, so every
    plan is the opt_einsum XLA program."""
    import jax
    import jax.numpy as jnp

    import feinsum_tpu as f

    rng = np.random.default_rng(1)

    def rand(*shape):
        return jnp.asarray(rng.random(shape, np.float32))

    args = [jnp.float32(0.125), rand(3, 3, n), rand(n, 3), rand(n, 3),
            rand(n, 3), rand(3, NDOF, NDOF), rand(n, NDOF), rand(n, NDOF),
            rand(n, NDOF), rand(n, NDOF), rand(NDOF, 4, 15), rand(4, n),
            rand(4, n, 15)]
    rhs = f.compile_fn_with_archive(user_rhs, args)
    backends = sorted({p.descriptor.backend for _i, _e, p in rhs.plans})
    with jax.default_matmul_precision("highest"):
        refs = jax.jit(user_rhs)(*args)
    outs = rhs(*args)
    for got, ref in zip(outs, refs):
        ref = np.asarray(ref, np.float64)
        got = np.asarray(got, np.float64)
        err = float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))
        if got.shape != ref.shape or not err <= F32_TOL:
            raise AssertionError(f"consumer rhs: {err:.2e} vs jax.jit")
        log(f"phase 4 consumer: output {got.shape} vs jax.jit HIGHEST max"
            f" diff {err:.2e}*max|ref|; {len(rhs.plans)} plans, backends"
            f" {backends}")


def phase_archive(n_tune: int, n_full: int, out_dir: str = OUT_DIR) -> None:
    """Phase 4c: autotune dg_grad_v0 (3 measured points) into a scratch
    archive, retrieve the card's own fact, replay it at full size."""
    import jax

    import feinsum_tpu as f
    from feinsum_tpu import sql_utils
    from feinsum_tpu.tuning import autotune

    grad = dg_classes(NDOF)["grad"]
    os.makedirs(out_dir, exist_ok=True)
    db = os.path.join(out_dir, "smoke_archive.sqlite")
    if os.path.exists(db):
        os.remove(db)
    device = jax.devices()[0]
    base = {"dofmajor": True, "log2_warps": 2, "num_stages": 2,
            "fold": False, "preblock": False, "precision_3x": False,
            "hoist": True, "jfold": False, "prereduce": False,
            "lane_pack_g": 0, "rowcat": False, "split_rows": False,
            "accum_f32": False, "host_hoist": True}
    seeds = [dict(base, log2_block=lb) for lb in (6, 7, 8)]
    autotune(grad, "dg_grad_v0", device=device, db_path=db,
             long_dim_length=n_tune, test_limit=3, seed_configs=seeds)
    facts = sql_utils.query(grad, device, db_path=db)
    transform = sql_utils.retrieve(grad, device, db_path=db)
    program = transform(f.generate_program(grad))
    err = run_and_compare(grad, program, n_full)
    log(f"phase 4 archive: {len(facts)} facts for"
        f" {sql_utils.get_device_key(device)} at E={n_tune}; hit replayed"
        f" at E={n_full} (block {program.descriptor.block_long}), max err"
        f" {err:.2e}*max|ref|")


def phase_timing(n: int, card: str, n_launches: int = 20) -> dict:
    """Phase 5: Pallas kernel vs the plain XLA program, per class and for
    the wave step (median of *n_launches* launches, after warm-up)."""
    import jax

    import feinsum_tpu as f
    from feinsum_tpu.measure import (_median_launch_seconds,
                                     generate_input_arrays)
    from feinsum_tpu.models.wave import WaveOperator3D, make_wave_state

    times = {}
    for name, einsum in dg_classes(NDOF).items():
        raw = generate_input_arrays(einsum, long_dim_length=n,
                                    as_numpy=True)
        row, temps = {}, {}
        for label, prog in (("kernel", kernel_program(einsum)),
                            ("xla", xla_program(einsum))):
            arrays = {k: jax.device_put(v)
                      for k, v in f.apply_layouts(prog, raw).items()}
            fn = f.build_executable(prog, long_dim_length=n)
            temps[label] = fn.lower(arrays).compile().memory_analysis(
                ).temp_size_in_bytes
            row[label] = _median_launch_seconds(fn, arrays,
                                                n_launches=n_launches)
            del arrays
        times[name] = row
        log(f"phase 5 [{card}] {name} ndof {NDOF} E={n}: kernel"
            f" {row['kernel'] * 1e6:.1f} us, xla {row['xla'] * 1e6:.1f} us"
            f" (median of {n_launches}); HBM temporaries: kernel"
            f" {temps['kernel'] / 1e6:.0f} MB, xla {temps['xla'] / 1e6:.0f}"
            " MB")
    row = {}
    state, geom = make_wave_state(n, ndof=NDOF)
    for label, use_pallas in (("kernel", True), ("xla", False)):
        step = jax.jit(WaveOperator3D(ndof=NDOF, use_pallas=use_pallas)
                       .make_step(n))
        row[label] = _median_launch_seconds(
            lambda a: step(*a), (state, geom), n_launches=n_launches)
    times["wave_step"] = row
    log(f"phase 5 [{card}] wave step ndof {NDOF} E={n}: kernel"
        f" {row['kernel'] * 1e6:.1f} us, xla {row['xla'] * 1e6:.1f} us"
        f" (median of {n_launches})")
    return times


def phase_tccg(card: str, device, ids=None, n_launches: int = 20) -> dict:
    """Phase 5b: the TCCG tensor contractions (default: bench.py's sample,
    one per structural family) through plain XLA (opt_einsum schedule,
    HIGHEST) — the route that replaced the removed multi-axis TC kernel —
    against the device's roofline."""
    import jax

    if ids is None:
        from bench import TCCG_SAMPLE as ids

    import feinsum_tpu as f
    from feinsum_tpu.measure import (_median_launch_seconds,
                                     evaluate_giga_op_map,
                                     generate_input_arrays,
                                     get_roofline_flop_rate)

    times = {}
    for idx in ids:
        einsum = f.get_tccg_benchmark(idx, dtype="float32")
        prog = xla_program(einsum)
        arrays = {k: jax.device_put(v) for k, v in generate_input_arrays(
            einsum, long_dim_length=1, as_numpy=True).items()}
        fn = f.build_executable(prog, long_dim_length=1)
        dt = _median_launch_seconds(fn, arrays, n_launches=n_launches)
        gops = sum(evaluate_giga_op_map(f.get_giga_op_map(einsum),
                                        1).values())
        roof = get_roofline_flop_rate(einsum, device, long_dim_length=1)
        times[f"tccg_{idx:02d}"] = dt
        log(f"phase 5 [{card}] tccg_{idx:02d} {einsum.get_subscripts()}"
            f" xla: {dt * 1e6:.1f} us = {gops / dt:.0f} GOp/s ="
            f" {100 * gops / dt / roof:.1f}% of the data-sheet roofline"
            f" (median of {n_launches})")
        del arrays
    return times


def phase_gpu_tests() -> None:
    """Phase 6: the tests only the card can run, in this process."""
    import pytest
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "tests/test_gpu.py"])
    if rc != 0:
        raise AssertionError(f"gpu-marked tests failed (pytest rc {rc})")
    log("phase 6 gpu tests: passed")


def phase_sharded(n: int) -> None:
    """The four-card path: grad over a 4-card data mesh, div over a 2x2
    data x model mesh, each against the same program on one card."""
    import jax

    import feinsum_tpu as f
    from feinsum_tpu.measure import generate_input_arrays
    from feinsum_tpu.parallel import (make_mesh, reduction_sharded_executable,
                                      sharded_einsum_executable)

    def compare(label, einsum, program, sharded_fn):
        raw = generate_input_arrays(einsum, long_dim_length=n,
                                    as_numpy=True)
        arrays = {k: jax.device_put(v)
                  for k, v in f.apply_layouts(program, raw).items()}
        one = f.build_executable(program, long_dim_length=n)(arrays)
        many = sharded_fn(arrays)
        for a, b in zip(one, many):
            a = np.asarray(a, np.float64)
            b = np.asarray(b, np.float64)
            err = float(np.max(np.abs(a - b)) / np.max(np.abs(a)))
            if a.shape != b.shape or not err <= F32_TOL:
                raise AssertionError(f"{label}: sharded vs one card {err}")
        log(f"sharded {label} E={n}: matches one card (max diff"
            f" {err:.2e}*max|ref|)")

    grad = dg_classes(NDOF)["grad"]
    prog = kernel_program(grad)
    compare("grad ndof 35, 4-card data mesh", grad, prog,
            sharded_einsum_executable(prog, make_mesh({"data": 4}),
                                      long_dim_length=n))
    # the reduction shards the contracted dof axis j over 2 cards, so it
    # needs an even ndof: 20 (the bench's P3 shape)
    div = dg_classes(20)["div"]
    prog = kernel_program(div)
    compare("div ndof 20, 2x2 data x model mesh", div, prog,
            reduction_sharded_executable(
                prog, make_mesh({"data": 2, "model": 2}),
                reduction_index="j", long_dim_length=n))

# }}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4))
    args = ap.parse_args(argv)

    info = phase_device(expect_count=args.chips)
    import jax

    import feinsum_tpu as f
    f.enable_persistent_compilation_cache()
    card = card_line()
    log(f"card: {card}")
    t0 = time.perf_counter()
    if args.chips == 4:
        phase_sharded(4 * E_FULL)
    else:
        phase_kernels(E_FULL)
        phase_fp64(E_FULL)
        phase_wave(E_FULL)
        phase_consumer(E_FULL)
        phase_archive(100_000, E_FULL)
        times = phase_timing(E_FULL, card)
        times.update(phase_tccg(card, jax.devices()[0]))
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, "smoke_times.json"), "w") as fh:
            json.dump({"card": card, "device": info, "seconds": times}, fh,
                      indent=1)
        phase_gpu_tests()
    log(f"all phases passed in {time.perf_counter() - t0:.0f} s")
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
