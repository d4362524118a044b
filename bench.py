"""
Headline benchmark: the reference's archived einsum suite on the GPU.

Prints ONE JSON line:
  {"metric": ..., "value": <geomean % of the device roofline across the
   suite>, "unit": "%roofline", "vs_baseline": <ours / reference's geomean
   roofline fraction on its own hardware (TITAN V, from BASELINE.md)>,
   "device": {...}}

Per-kernel details go to stderr, followed by the extended evidence tables:
the P1-P3 DG sizes, curl, the fp64 rows, a TCCG sample, and the
DB-hit->replay latency.  Schedules come from the shipped transform archive
when it holds facts for this device, else from the built-in schedules.
Runs only on a GPU; any other platform is an error.
"""

from __future__ import annotations

import json
import math
import sys
import time

import jax

import feinsum_tpu as f
from feinsum_tpu import sql_utils
from feinsum_tpu.data.device_info import get_device_key
from feinsum_tpu.diagnostics import NoFactInDatabaseError
from feinsum_tpu.measure import (
    evaluate_giga_op_map,
    generate_input_arrays,
    get_giga_op_map,
    get_roofline_flop_rate,
    timeit_on_device,
)

E_BENCH = 1_000_000   # streaming regime: working sets >> the 50 MB L2


def log(*args):
    print(*args, file=sys.stderr, flush=True)


# {{{ einsum builders (shapes = the reference's archived rows, BASELINE.md)

def make_div(ndof, dtype="float32"):
    return f.batched_einsum(
        "es,sij,ej->ei",
        [[f.array(jn, ("E", 3), dtype),
          f.array("R", (3, ndof, ndof), dtype),
          f.array(un, ("E", ndof), dtype)]
         for jn, un in [("Jx", "ux"), ("Jy", "uy"), ("Jz", "uz")]])


def make_grad(ndof, dtype="float32"):
    return f.einsum("xre,rij,ej->xei",
                    f.array("J", (3, 3, "E"), dtype),
                    f.array("D", (3, ndof, ndof), dtype),
                    f.array("u", ("E", ndof), dtype))


def make_curl(ndof=35, dtype="float32"):
    # (curl u) component rows: J_a (E,) geometry factor, D (3,ndof,ndof)
    # reference derivatives, u_b (E,ndof) dofs (reference class:
    # re_rji_ej_to_ei_3d_cross_product_v0.py)
    return f.batched_einsum(
        "e,rij,ej->ei",
        [[f.array(j, ("E",), dtype),
          f.array("D", (3, ndof, ndof), dtype),
          f.array(u, ("E", ndof), dtype)]
         for j, u in [("Jy", "uz"), ("Jz", "ux"), ("Jx", "uy")]])


def make_face(ndof=35, dtype="float32"):
    return f.einsum("ifj,fe,fej->ei",
                    f.array("L", (ndof, 4, 15), dtype),
                    f.array("Fj", (4, "E"), dtype),
                    f.array("flux", (4, "E", 15), dtype))


def make_mass(ndof=35, dtype="float32"):
    return f.einsum("e,ij,ej->ei",
                    f.array("jac", ("E",), dtype),
                    f.array("M", (ndof, ndof), dtype),
                    f.array("u", ("E", ndof), dtype))


def suite():
    ndof = 35
    matvec = f.einsum("ej,ij->ei",
                      f.array("u", ("E", 20), "float32"),
                      f.array("D", (20, 20), "float32"))
    copy2 = f.einsum("ij,ij->ij",
                     f.array("A", ("E", ndof), "float32"),
                     f.array("B", ("E", ndof), "float32"))
    # reference best GOp/s on TITAN V (fp64), BASELINE.md rows
    return [
        ("dg_div_ndof35", make_div(ndof), 1945.6),
        ("dg_grad_ndof35", make_grad(ndof), 2002.4),
        ("dg_face_mass", make_face(ndof), 2186.0),
        ("dg_mass_ndof35", make_mass(ndof), 1393.7),
        ("matvec_ndof20", matvec, 974.3),
        ("copy_ndof35", copy2, 24.6),
    ]


def extended_suite():
    """P1-P3 DG sizes, curl, bandwidth-bound rows — stderr evidence.
    Reference GOp/s from BASELINE.md where it records the size (fp64
    TITAN V); None where the reference DB has no row."""
    div1 = f.einsum("es,sij,ej->ei",
                    f.array("J", ("E", 3), "float32"),
                    f.array("R", (3, 35, 35), "float32"),
                    f.array("u", ("E", 35), "float32"))
    return [
        ("dg_div_single_ndof35", div1, 1918.8),
        ("dg_div_ndof20_P3", make_div(20), 1690.0),
        ("dg_div_ndof10_P2", make_div(10), 962.5),
        ("dg_div_ndof4_P1", make_div(4), 355.9),
        ("dg_grad_ndof20_P3", make_grad(20), 1675.5),
        ("dg_grad_ndof10_P2", make_grad(10), None),
        ("dg_grad_ndof4_P1", make_grad(4), None),
        ("dg_curl_ndof35", make_curl(35), None),
        # bandwidth-bound rows (BASELINE.md: ij,j->i 99.4 / ij->i 41.6)
        ("vecmat_ndof35", f.einsum("ej,j->e",
                                   f.array("A", ("E", 35), "float32"),
                                   f.array("x", (35,), "float32")), 99.4),
        ("rowsum_ndof35", f.einsum("ej->e",
                                   f.array("A", ("E", 35), "float32")),
         41.6),
    ]


def fp64_suite():
    """The fp64 rows (the reference archive is all-fp64): XLA's native
    double arithmetic on the card."""
    return [("dg_grad_ndof35_fp64", make_grad(35, "float64"), 2002.4),
            ("dg_div_ndof35_fp64", make_div(35, "float64"), 1945.6),
            ("dg_mass_ndof35_fp64", make_mass(35, "float64"), 1393.7),
            ("dg_face_mass_fp64", make_face(35, "float64"), 2186.0)]

# }}}


def default_transform(einsum):
    """Built-in schedule where the archive has no fact: the Pallas kernel
    for f32 DG-family einsums, XLA at HIGHEST for f64."""
    is_f64 = any(a.dtype == "float64" for row in einsum.args for a in row)

    def tr(program):
        e = program.einsum
        if is_f64:
            return f.generate_program_with_opt_einsum_schedule(
                e).with_descriptor(backend="xla", precision="highest")
        from feinsum_tpu.tuning.impls._common import default_pallas_program
        return default_pallas_program(program)
    return tr


def geomean(xs):
    xs = [x for x in xs if x > 0]
    return math.exp(sum(math.log(x) for x in xs) / len(xs)) if xs else 0.0


def candidate_transforms(name, einsum):
    """Archived facts in descending GOp-rate order, then the built-in
    default — a champion whose replay no longer builds must not zero out
    the row when the runner-up builds fine.  Archive misses fall back
    straight to the default."""
    try:
        qs = sql_utils.query(einsum)
    except NoFactInDatabaseError:
        log(f"{name}: no archive fact for this device; using the built-in"
            " schedule")
        qs = []
    # collapse re-timed copies of one config to its lower-median row, so
    # identical champions cannot occupy every fallback slot
    for rank, q in enumerate(sql_utils.aggregate_reconfirmations(qs)[:4]):
        yield (f"archive[{rank}] {q.transform_id}"
               f" ({q.total_giga_op_rate:.0f} GOp/s)"), q.transform
    yield "built-in default", default_transform(einsum)


def measure_row(name, einsum, device_key, *, long_dim_length=E_BENCH):
    """(rate GOp/s, fraction of roofline) for one suite row, archive-first
    with fallback to runner-up facts and the default schedule."""
    last_ex = None
    for label, transform in candidate_transforms(name, einsum):
        try:
            f.validate_batched_einsum_transform(
                einsum, transform, long_dim_length=2000)
            program = transform(f.generate_program(einsum))
            arrays = f.apply_layouts(program, generate_input_arrays(
                einsum, long_dim_length=long_dim_length))
            fn = f.build_executable(program, long_dim_length=long_dim_length)
            dt = timeit_on_device(fn, arrays)
        except Exception as ex:  # noqa: BLE001
            last_ex = ex
            log(f"{name}: candidate '{label}' failed"
                f" ({type(ex).__name__}: {str(ex)[:160]}); trying next")
            continue
        log(f"{name}: measured via {label}: {1e6 * dt:.1f} us")
        gops = sum(evaluate_giga_op_map(
            get_giga_op_map(einsum), long_dim_length).values())
        rate = gops / dt
        roof = get_roofline_flop_rate(einsum, device_key,
                                      long_dim_length=long_dim_length)
        return rate, rate / roof
    raise last_ex


def reference_roofline_fraction(einsum, ref_gops):
    """The reference's fraction-of-roofline on its own hardware (fp64
    TITAN V), for the vs_baseline ratio."""
    ref_einsum = einsum.copy(args=tuple(
        tuple(a.copy(dtype="float64") for a in row)
        for row in einsum.args))
    ref_roof = get_roofline_flop_rate(
        ref_einsum, "NVIDIA TITAN V", long_dim_length=100_000)
    return ref_gops / ref_roof


def _run_rows(rows, device_key):
    """Measure *rows*; returns [(our fraction, reference fraction)]."""
    fracs = []
    for name, einsum, ref_gops in rows:
        try:
            rate, frac = measure_row(name, einsum, device_key)
        except Exception as ex:  # noqa: BLE001
            log(f"{name}: FAILED {type(ex).__name__}: {str(ex)[:200]}")
            continue
        ref_s, ref_frac = "", None
        if ref_gops is not None:
            ref_frac = reference_roofline_fraction(einsum, ref_gops)
            ref_s = (f" | reference: {ref_gops:7.1f} GOp/s ="
                     f" {100 * ref_frac:5.1f}% of TITAN V roofline")
        fracs.append((frac, ref_frac))
        log(f"{name}: {rate:8.0f} GOp/s = {100 * frac:5.1f}% of"
            f" {device_key} roofline{ref_s}")
    return fracs


# TCCG sample: one benchmark per structural family of the 48
TCCG_SAMPLE = (2, 5, 12, 21, 35, 43)


def run_tccg(device_key):
    log("--- TCCG sample (dense tensor contractions, fp32, XLA) ---")
    for idx in TCCG_SAMPLE:
        einsum = f.get_tccg_benchmark(idx, dtype="float32")
        try:
            rate, frac = measure_row(f"tccg_{idx:02d}", einsum, device_key,
                                     long_dim_length=100_000)
        except Exception as ex:  # noqa: BLE001
            log(f"tccg_{idx:02d}: FAILED {type(ex).__name__}:"
                f" {str(ex)[:200]}")
            continue
        log(f"tccg_{idx:02d} [{einsum.get_subscripts():>22s}]:"
            f" {rate:8.0f} GOp/s = {100 * frac:5.1f}% of {device_key}"
            " roofline")


def run_replay_latency(device):
    """The <10 ms DB-hit->replay budget (SURVEY §3.2) on this device's
    archive facts; skipped when the archive holds none for it."""
    div = make_div(35)
    try:
        sql_utils.retrieve(div, device)
    except NoFactInDatabaseError:
        log("DB-hit->replay: no archive fact for this device; not measured")
        return

    def replay():
        tr = sql_utils.retrieve(div, device)
        prog = tr(f.generate_program(div))
        return f.build_executable(prog, long_dim_length=E_BENCH)

    replay()  # warm imports/canon/sqlite
    ts = []
    for _ in range(20):
        t0 = time.perf_counter()
        replay()
        ts.append(time.perf_counter() - t0)
    ts.sort()
    log(f"DB-hit->replay (retrieve->transform->build_executable):"
        f" median {1e3 * ts[len(ts) // 2]:.2f} ms over 20 reps"
        f" (north-star budget: 10 ms)")


def main() -> None:
    f.enable_persistent_compilation_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {dev.platform!r}")
    device_key = get_device_key(dev)
    log(f"benchmarking on {device_key}, E={E_BENCH}")

    fracs = _run_rows(suite(), device_key)
    ours = [a for a, _ in fracs]
    refs = [b for _, b in fracs]
    line = {
        "metric": "Batched-einsum geomean % of device roofline"
                  " (reference archive suite, fp32, E=1M)",
        "value": round(100.0 * geomean(ours), 2),
        "unit": "%roofline",
        "vs_baseline": round(geomean(ours) / geomean(refs), 3)
        if refs else 0.0,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    if len(ours) < len(suite()):
        line["partial"] = f"{len(ours)}/{len(suite())}"

    # evidence tables (stderr only; failures here never break the headline)
    log("--- extended suite (P-levels / curl / bandwidth-bound) ---")
    _run_rows(extended_suite(), device_key)
    run_tccg(device_key)
    run_replay_latency(dev)
    log("--- fp64 (XLA native double arithmetic) ---")
    _run_rows(fp64_suite(), device_key)
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
