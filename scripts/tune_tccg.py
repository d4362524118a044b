"""Seed the archive with TCCG tensor-contraction facts (tc_xla_v0 +
ttgt_v0), mirroring the reference archive's cogent/ttgt coverage.

Usage: python scripts/tune_tccg.py [secs-per-bench] [bench-ids...]
"""
import sys
import time

import logging

import feinsum_tpu as f

f.enable_persistent_compilation_cache()
from feinsum_tpu import sql_utils
from feinsum_tpu.tuning import autotune

logging.basicConfig(level=logging.INFO,
                    format="%(asctime)s %(name)s: %(message)s")

# a representative spread of the 48 TCCG benchmarks: small/large K, matricized
# tensor products, transpose-heavy cases
DEFAULT_IDS = (1, 5, 12, 19, 25, 31, 38, 44)

# tc_gemm_v0 seeds: fused-2D storage, both operand orientations, the XLA
# dot and the Pallas streaming kernel at 128- and 256-element blocks
_GEMM_SEEDS = []
for swap in (False, True):
    for precision_idx in (0, 1):
        _GEMM_SEEDS.append({
            "log2_block": 7, "backend_pallas": False,
            "precision_idx": precision_idx, "swap": swap,
            "dofmajor": False, "fold": False})
    for lb in (7, 8):
        _GEMM_SEEDS.append({
            "log2_block": lb, "backend_pallas": True, "precision_idx": 1,
            "swap": swap, "dofmajor": True, "fold": False})

import os

IMPLS = tuple((os.environ.get("TCCG_IMPLS")
               or "tc_gemm_v0,tc_xla_v0,ttgt_v1").split(","))

if __name__ == "__main__":
    budget = float(sys.argv[1]) if len(sys.argv) > 1 else 120.0
    ids = ([int(a) for a in sys.argv[2:]] if len(sys.argv) > 2
           else DEFAULT_IDS)
    for bench_id in ids:
        einsum = f.get_tccg_benchmark(bench_id, dtype="float32")
        print(f"=== TCCG #{bench_id}: {einsum.get_subscripts()}"
              f" {einsum.arg_to_shape} ===", flush=True)
        for impl in IMPLS:
            t0 = time.time()
            try:
                autotune(einsum, impl, db_path=sql_utils.DEFAULT_DB,
                         long_dim_length=100, stop_after=budget,
                         seed_configs=(_GEMM_SEEDS
                                       if impl == "tc_gemm_v0" else None),
                         skip_value_mismatch=True)
            except Exception as ex:  # noqa: BLE001
                print(f"  {impl} error: {str(ex)[:200]}", flush=True)
            print(f"  {impl}: {time.time()-t0:.0f}s", flush=True)
    print("TCCG TUNING COMPLETE", flush=True)
