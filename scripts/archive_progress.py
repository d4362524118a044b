"""Summarize what a tuning session added to the shipped archive.

CPU-only, read-only sqlite — safe to run while a tuning process INSERTs.
For every einsum class: the current champion (rate, transform_id, proto
tag), the pre-session champion, and the delta.  Run as:

    python scripts/archive_progress.py [since-iso-utc]

Default ``since`` is today's 00:00 UTC.  The "class" key here is the raw
(subscripts, index_to_length, arg_to_dtype) triple — adequate for a human
session report (sql_utils.query remains the precise canonical-key path).
"""

from __future__ import annotations

import json
import sqlite3
import sys
import time

DB = "feinsum_tpu/data/transform_archive_v1_tpu.sqlite"


def rate(giga_op_info: str, runtime: float) -> float:
    info = json.loads(giga_op_info)
    return sum(info.values()) / runtime if runtime > 0 else 0.0


def main() -> None:
    since = (sys.argv[1] if len(sys.argv) > 1
             else time.strftime("%Y-%m-%dT00:00:00", time.gmtime()))
    con = sqlite3.connect(f"file:{DB}?mode=ro", uri=True)
    rows = con.execute(
        "SELECT subscripts, index_to_length, arg_to_dtype, transform_id,"
        " transform_params, runtime_in_sec, giga_op_info, timestamp,"
        " compiler_version FROM FEINSUM_TIMING_FACTS").fetchall()
    by_class: dict = {}
    for (sub, i2l, a2d, tid, params, rt, gi, ts, cv) in rows:
        key = (sub, i2l, a2d)
        by_class.setdefault(key, []).append(
            (rate(gi, rt), tid, params, ts, cv or ""))
    print(f"archive: {len(rows)} rows, {len(by_class)} classes;"
          f" session = rows since {since}\n")
    changed = unchanged = 0
    for key, facts in sorted(by_class.items(),
                             key=lambda kv: -max(f[0] for f in kv[1])):
        sub, i2l, a2d = key
        new = [f for f in facts if f[3] >= since]
        best = max(facts, key=lambda f: f[0])
        old = [f for f in facts if f[3] < since]
        old_best = max(old, key=lambda f: f[0]) if old else None
        dtype = sorted(set(json.loads(a2d).values()))
        tag = "proto3" if "timing-proto3" in best[4] else "pre3"
        line = (f"{sub:>28s} {'/'.join(d.replace('float','f') for d in dtype)}"
                f" | best {best[0]:9.1f} GOp/s {best[1]:>18s} [{tag}]")
        if new:
            if old_best is None:
                line += f" | NEW CLASS ({len(new)} rows)"
                changed += 1
            elif best[3] >= since and best[0] > old_best[0] * 1.005:
                line += (f" | IMPROVED +{100*(best[0]/old_best[0]-1):.1f}%"
                         f" (was {old_best[0]:.1f} via {old_best[1]},"
                         f" {len(new)} new rows)")
                changed += 1
            else:
                line += f" | retained ({len(new)} new rows)"
                unchanged += 1
        if new or "-v" in sys.argv:
            print(line)
    print(f"\n{changed} classes improved/new, {unchanged} retained"
          f" champions among touched classes")


if __name__ == "__main__":
    main()
