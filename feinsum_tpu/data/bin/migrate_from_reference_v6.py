"""Import a reference (kaushikcfd/feinsum) v6-format transform archive.

The reference's sqlite schema (its ``sql_utils.py:399-414``) and ours share
the same FEINSUM_TIMING_FACTS column set, and both key rows on the
*canonicalized* einsum — so the einsum identity carries over directly.  What
does NOT carry over is the transform itself: the reference's
``transform_id``/``transform_params`` name loopy transform scripts tuned for
an OpenCL device, which have no meaning for this library's emitters.

This tool therefore migrates the *tuning knowledge worth keeping*:

* ``--list`` (default): show every distinct canonical einsum in the source
  archive with its best recorded rate, so you can see what you had tuned.
* ``--retune``: autotune each migrated einsum class against the matching
  schedule space (chosen by einsum shape) on the current device and record
  fresh facts into the destination archive — the switcher's path from a
  reference DB to one for this library.

Rows whose einsums cannot be reconstructed (e.g. impl-specific dtypes we
don't support) are reported and skipped.
"""
import argparse
import json
import sqlite3

from feinsum_tpu import sql_utils
from feinsum_tpu.einsum import BatchedEinsum  # noqa: F401  (docs)


def _einsums_in_reference_db(path: str):
    con = sqlite3.connect(f"file:{path}?mode=ro", uri=True)
    try:
        rows = con.execute(
            "SELECT DISTINCT subscripts, index_to_length, args, arg_to_dtype"
            f" FROM {sql_utils.TIMINGS_TABLENAME}").fetchall()
    finally:
        con.close()
    for subscripts, index_to_length, args, arg_to_dtype in rows:
        yield (subscripts, json.loads(index_to_length), json.loads(args),
               json.loads(arg_to_dtype))


def _reconstruct(subscripts, index_to_length, args, arg_to_dtype):
    from feinsum_tpu.make_einsum import array, batched_einsum
    in_specs, _ = subscripts.replace(" ", "").split("->")
    in_specs = in_specs.split(",")
    rows = args if args and isinstance(args[0], (list, tuple)) else [args]
    built = []
    for row in rows:
        built.append([
            array(name,
                  # letters absent from index_to_length are parametric
                  # (the reference omits SizeParam axes from the dump);
                  # name them apart from the index-letter namespace
                  tuple(index_to_length.get(ix, f"N{ix}_") for ix in spec),
                  arg_to_dtype[name])
            for name, spec in zip(row, in_specs)])
    return batched_einsum(subscripts.replace(" ", ""), built)


def _pick_space(einsum) -> str:
    """Best-guess schedule space for a migrated einsum class."""
    if einsum.sum_indices and einsum.n == 2 and not einsum.all_size_params:
        return "tc_xla_v0"
    if not einsum.sum_indices:
        return "elementwise_v1"
    if einsum.n >= 3:
        return "dg_div_v0" if einsum.b > 1 else "dg_grad_v0"
    return "mass_v0"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True,
                    help="reference v6 sqlite archive")
    ap.add_argument("--dst", default=sql_utils.DEFAULT_DB)
    ap.add_argument("--retune", action="store_true",
                    help="autotune each migrated einsum on this device")
    ap.add_argument("--stop-after", type=float, default=120.0)
    ap.add_argument("--long-dim-length", type=int, default=1_000_000)
    args = ap.parse_args()

    n_ok = n_skip = 0
    for key in _einsums_in_reference_db(args.src):
        subscripts = key[0]
        try:
            einsum = _reconstruct(*key)
        except Exception as ex:  # noqa: BLE001
            print(f"SKIP {subscripts}: {type(ex).__name__}: {str(ex)[:120]}")
            n_skip += 1
            continue
        n_ok += 1
        space = _pick_space(einsum)
        print(f"{subscripts:30} -> space {space}")
        if args.retune:
            from feinsum_tpu.tuning import autotune
            autotune(einsum, space, db_path=args.dst,
                     long_dim_length=args.long_dim_length,
                     stop_after=args.stop_after,
                     skip_value_mismatch=True)
    print(f"{n_ok} einsum classes migrated, {n_skip} skipped"
          + ("" if args.retune else " (re-run with --retune to tune them)"))


if __name__ == "__main__":
    main()
