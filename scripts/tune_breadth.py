"""Breadth pass: record one fact for each P1-P3 DG variant and an fp64 div
fact on the GPU.

Usage: python scripts/tune_breadth.py
"""
import time
import feinsum_tpu as f

f.enable_persistent_compilation_cache()
from feinsum_tpu import sql_utils

def record(e, impl, params, label, long_dim=1_000_000):
    t0 = time.time()
    try:
        sql_utils.record_facts(e, transform_id=impl, transform_params=params,
                               runtime_in_sec=None, db_path=sql_utils.DEFAULT_DB,
                               long_dim_length=long_dim,
                               timeit_kwargs={"validation_long_dim_length": 2000})
        qs = sql_utils.query(e, db_path=sql_utils.DEFAULT_DB)
        best = max(q.total_giga_op_rate for q in qs)
        print(f"{label}: recorded, best {best:.0f} GOp/s ({time.time()-t0:.0f}s)", flush=True)
    except Exception as ex:
        print(f"{label}: FAIL {str(ex)[:160]}", flush=True)

P = {"log2_block": 7, "hoist": True, "dofmajor": True}

def mk_div(ndof, dtype="float32"):
    return f.batched_einsum("es,sij,ej->ei",
        [[f.array(jn, ("E", 3), dtype), f.array("R", (3, ndof, ndof), dtype),
          f.array(un, ("E", ndof), dtype)]
         for jn, un in [("Jx", "ux"), ("Jy", "uy"), ("Jz", "uz")]])

for ndof in (20, 10, 4):
    record(mk_div(ndof), "dg_div_v0.py", P, f"div ndof={ndof}")
    record(f.einsum("xre,rij,ej->xei", f.array("J", (3, 3, "E"), "float32"),
                    f.array("D", (3, ndof, ndof), "float32"),
                    f.array("u", ("E", ndof), "float32")),
           "dg_grad_v0.py", P, f"grad ndof={ndof}")

# fp64 div through XLA's native double arithmetic (validates at 1e-12)
record(mk_div(35, "float64"), "xla_v0.py",
       {"use_opt_path": True, "precision_idx": 1}, "div fp64")
print("BREADTH DONE", flush=True)
