"""Re-time the top-K facts per einsum into a fresh archive (parity:
reference data/bin/reevalutate_best_k_configurations.py) — used when
migrating to a new device or jax version."""
import argparse

from feinsum_tpu import sql_utils


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=sql_utils.DEFAULT_DB)
    ap.add_argument("--dst", required=True)
    ap.add_argument("-k", type=int, default=3)
    ap.add_argument("--long-dim-length", type=int, default=1_000_000)
    ap.add_argument("--skip-dtypes", default="",
                    help="comma-separated dtypes to skip (e.g."
                         " 'float64', to re-time those rows in a separate"
                         " pass)")
    ap.add_argument("--only-subscripts", default=None,
                    help="restrict to one canonical subscripts string")
    args = ap.parse_args()

    skip = {s.strip() for s in args.skip_dtypes.split(",") if s.strip()}
    for e in sql_utils.get_timed_einsums_in_db(db_path=args.src):
        if skip & {dt.name for dt in e.arg_to_dtype.values()}:
            continue
        if args.only_subscripts and e.get_subscripts() != args.only_subscripts:
            continue
        qs = sorted(sql_utils.query(e, db_path=args.src),
                    key=lambda q: -q.total_giga_op_rate)[:args.k]
        for q in qs:
            print(f"re-timing {q.transform_id} {dict(q.transform_params)}"
                  f" on {e.get_subscripts()}", flush=True)
            try:
                sql_utils.record_facts(
                    e, transform_id=q.transform_id,
                    transform_params=dict(q.transform_params),
                    runtime_in_sec=None,      # re-time on this device
                    db_path=args.dst,
                    long_dim_length=args.long_dim_length)
            except Exception as ex:  # noqa: BLE001 (one bad row must not
                print(f"  FAILED {type(ex).__name__}:"  # kill the sweep)
                      f" {str(ex)[:160]}", flush=True)


if __name__ == "__main__":
    main()
