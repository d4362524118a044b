"""Static physics-floor audit: flag archive rows whose recorded GOp rate
beats the HBM bandwidth bound (logical bytes / peak bus) — impossible on
the hardware, i.e. a timing-instrument artifact.

Usage: python -m feinsum_tpu.data.bin.audit_floor [--db PATH]
       [--device "NVIDIA H100 80GB HBM3"] [--slack 1.02]

Exit code 1 when violations exist (CI-able).  Complements the re-timing
based retire tools (retire_rows / reevaluate_best_k): this one is
CPU-only and instant.
"""
import argparse
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

import feinsum_tpu as f  # noqa: E402
from feinsum_tpu import sql_utils  # noqa: E402
from feinsum_tpu.data.device_info import (  # noqa: E402
    DEV_TO_PEAK_BW,
    sanitize_device_name,
)
from feinsum_tpu.measure import (  # noqa: E402
    evaluate_giga_op_map,
    get_footprint_gbytes,
    get_giga_op_map,
)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--db", default=None)
    ap.add_argument("--device", default="NVIDIA H100 80GB HBM3")
    ap.add_argument("--slack", type=float, default=1.02)
    args = ap.parse_args()

    bw = DEV_TO_PEAK_BW.get(sanitize_device_name(args.device))
    if not bw:
        print(f"no peak-BW entry for {args.device!r}")
        return 2
    dev = f.FakeDevice(args.device)
    n_viol = n_rows = 0
    for e in sql_utils.get_timed_einsums_in_db(db_path=args.db):
        qs = [q for q in sql_utils.query(e, dev, db_path=args.db,
                                         err_if_no_results=False)
              if np.isfinite(q.runtime_in_sec)]
        if not qs:
            continue
        L = 1_000_000 if e.all_size_params else 100_000
        try:
            gops = sum(evaluate_giga_op_map(get_giga_op_map(e), L).values())
            gbytes = get_footprint_gbytes(e, long_dim_length=L)
        except Exception:  # noqa: BLE001
            continue
        bound = gops / (gbytes / bw)
        n_rows += len(qs)
        bad = [q for q in qs if q.total_giga_op_rate > args.slack * bound]
        for q in bad:
            n_viol += 1
            print(f"{e.get_subscripts():24s} {q.transform_id:16s}"
                  f" {q.total_giga_op_rate:8.0f} GOp/s >"
                  f" {bound:8.0f} bound  params={dict(q.transform_params)}")
    print(f"{n_rows} rows audited, {n_viol} physics-floor violations")
    return 1 if n_viol else 0


if __name__ == "__main__":
    sys.exit(main())
