"""Seed the transform archive by autotuning the reference suite on the GPU
(facts are keyed by the card's device kind).  One einsum at a time,
budgeted; resumable (DB dedup).

Usage: python scripts/tune_archive.py [seconds-per-einsum] [impl-filter]
"""
import logging
import sys
import time

import feinsum_tpu as f

f.enable_persistent_compilation_cache()
from feinsum_tpu import sql_utils
from feinsum_tpu.tuning import autotune

logging.basicConfig(level=logging.INFO,
                    format="%(asctime)s %(name)s: %(message)s")

NDOF = 35
E_TUNE = 1_000_000

SUITE = []

div = f.batched_einsum(
    "es,sij,ej->ei",
    [[f.array(jn, ("E", 3), "float32"),
      f.array("R", (3, NDOF, NDOF), "float32"),
      f.array(un, ("E", NDOF), "float32")]
     for jn, un in [("Jx", "ux"), ("Jy", "uy"), ("Jz", "uz")]])
SUITE.append(("dg_div_v0", div))

grad = f.einsum("xre,rij,ej->xei", f.array("J", (3, 3, "E"), "float32"),
                f.array("D", (3, NDOF, NDOF), "float32"),
                f.array("u", ("E", NDOF), "float32"))
SUITE.append(("dg_grad_v0", grad))

face = f.einsum("ifj,fe,fej->ei",
                f.array("L", (NDOF, 4, 15), "float32"),
                f.array("Fj", (4, "E"), "float32"),
                f.array("flux", (4, "E", 15), "float32"))
SUITE.append(("face_mass_v0", face))

mass = f.einsum("e,ij,ej->ei", f.array("jac", ("E",), "float32"),
                f.array("M", (NDOF, NDOF), "float32"),
                f.array("u", ("E", NDOF), "float32"))
SUITE.append(("mass_v0", mass))

matvec = f.einsum("ej,ij->ei", f.array("u", ("E", 20), "float32"),
                  f.array("D", (20, 20), "float32"))
SUITE.append(("mass_v0", matvec))

copy2 = f.einsum("ij,ij->ij", f.array("A", ("E", NDOF), "float32"),
                 f.array("B", ("E", NDOF), "float32"))
SUITE.append(("elementwise_v1", copy2))

# the reference archive spans P1-P4 (ndof 4/10/20/35, BASELINE.md rows);
# cover the smaller sizes too
for nd in (4, 10, 20):
    SUITE.append(("dg_div_v0", f.batched_einsum(
        "es,sij,ej->ei",
        [[f.array(jn, ("E", 3), "float32"),
          f.array("R", (3, nd, nd), "float32"),
          f.array(un, ("E", nd), "float32")]
         for jn, un in [("Jx", "ux"), ("Jy", "uy"), ("Jz", "uz")]])))
for nd in (10, 20):
    SUITE.append(("dg_grad_v0", f.einsum(
        "xre,rij,ej->xei", f.array("J", (3, 3, "E"), "float32"),
        f.array("D", (3, nd, nd), "float32"),
        f.array("u", ("E", nd), "float32"))))
    SUITE.append(("mass_v0", f.einsum(
        "e,ij,ej->ei", f.array("jac", ("E",), "float32"),
        f.array("M", (nd, nd), "float32"),
        f.array("u", ("E", nd), "float32"))))

curl = f.batched_einsum(
    "e,rij,ej->ei",
    [[f.array(j, ("E",), "float32"),
      f.array("D", (3, NDOF, NDOF), "float32"),
      f.array(u, ("E", NDOF), "float32")]
     for j, u in [("Jy", "uz"), ("Jz", "ux"), ("Jx", "uy")]])
SUITE.append(("curl_3d_v0", curl))

rowsum = f.einsum("ij->i", f.array("A", ("E", NDOF), "float32"))
SUITE.append(("mass_v0", rowsum))

vecmat = f.einsum("ij,j->i", f.array("A", ("E", NDOF), "float32"),
                  f.array("x", (NDOF,), "float32"))
SUITE.append(("mass_v0", vecmat))

if __name__ == "__main__":
    budget = float(sys.argv[1]) if len(sys.argv) > 1 else 600.0
    only = sys.argv[2] if len(sys.argv) > 2 else None
    for impl, einsum in SUITE:
        if only and only not in impl:
            continue
        print(f"=== tuning {impl}: {einsum.get_subscripts()} ===",
              flush=True)
        t0 = time.time()
        # seeds: the built-in kernel schedule (dof-major, hoisted) at the
        # block sizes Triton compiles well, both 3-pass precisions
        seeds = []
        if impl in ("dg_div_v0", "dg_grad_v0", "face_mass_v0",
                    "curl_3d_v0", "mass_v0"):
            for lb in (6, 7, 8):
                for p3 in (False, True):
                    seeds.append({"log2_block": lb, "log2_warps": 2,
                                  "num_stages": 2, "hoist": True,
                                  "dofmajor": True, "fold": False,
                                  "preblock": False, "precision_3x": p3,
                                  "jfold": impl == "curl_3d_v0"})
        elif impl == "elementwise_v1":
            for lb in (8, 9, 10):
                seeds.append({"log2_block": lb, "log2_warps": 2,
                              "dofmajor": True, "fold": False})
        try:
            autotune(einsum, impl, db_path=sql_utils.DEFAULT_DB,
                     long_dim_length=E_TUNE, stop_after=budget,
                     seed_configs=seeds,
                     timeit_kwargs={"validation_long_dim_length": 2000})
        except Exception as ex:  # noqa: BLE001
            print(f"{impl} tuning error: {str(ex)[:200]}", flush=True)
        print(f"=== {impl} done in {time.time()-t0:.0f}s ===", flush=True)
    print("TUNING COMPLETE", flush=True)
