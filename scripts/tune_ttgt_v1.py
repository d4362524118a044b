"""Seed ttgt_v1 (structured PermutationParameter layouts, VERDICT r2
missing #3) with archive facts on a TCCG sample: a shipped space must not
carry zero evidence (VERDICT r2 weak #4's standard).  Seeds = each class's
ttgt_v0 champion translated to v1's tuple encoding, then the structured
mutation search runs from there.

Usage: python scripts/tune_ttgt_v1.py [benchmark-index] [seconds-budget]
"""
import sys

import feinsum_tpu as f
from feinsum_tpu import sql_utils
from feinsum_tpu.tuning import autotune

f.enable_persistent_compilation_cache()

import logging  # noqa: E402

logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")


def _perm_from_index(idx, rank):
    """ttgt_v0's exact decoding (itertools.permutations order, mod len)."""
    import itertools
    perms = list(itertools.permutations(range(rank)))
    return perms[int(idx) % len(perms)]


def v0_champion_seeds(e):
    """Translate the class's best ttgt_v0 facts into v1 tuple configs."""
    try:
        qs = [q for q in sql_utils.query(f.canonicalize_einsum(e))
              if q.transform_id == "ttgt_v0.py"]
    except Exception:  # noqa: BLE001
        return []
    qs.sort(key=lambda q: q.total_giga_op_rate, reverse=True)
    from feinsum_tpu.canonicalization import canonical_operand_positions
    ce = f.canonicalize_einsum(e)
    pos_a, pos_b = canonical_operand_positions(ce)
    rank_a = len(ce.in_idx_sets[pos_a])
    rank_b = len(ce.in_idx_sets[pos_b])
    out = []
    for q in qs[:3]:
        p = dict(q.transform_params)
        try:
            out.append({
                "layout_a": _perm_from_index(p["perm_a"], rank_a),
                "layout_b": _perm_from_index(p["perm_b"], rank_b),
                "layout_out": _perm_from_index(
                    p.get("perm_out", 0), len(ce.out_idx_set)),
                "precision_idx": int(p.get("precision_idx", 0)),
                "natural_out": int(p.get("natural_out", 0)),
            })
        except Exception:  # noqa: BLE001
            continue
    return out


if __name__ == "__main__":
    idx = int(sys.argv[1]) if len(sys.argv) > 1 else 12
    budget = float(sys.argv[2]) if len(sys.argv) > 2 else 400.0
    e = f.get_tccg_benchmark(idx, dtype="float32")
    seeds = v0_champion_seeds(e)
    print(f"tccg_{idx:02d}: {len(seeds)} v0-champion seeds", flush=True)
    autotune(e, "ttgt_v1", stop_after=budget, long_dim_length=100_000,
             seed_configs=seeds)
    print("TTGT_V1 TUNE DONE", flush=True)
