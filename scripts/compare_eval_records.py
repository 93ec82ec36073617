"""Hold the port's evaluation rows to a JAX record's, scenario by scenario,
with Wilson 95% intervals.

    python scripts/compare_eval_records.py \\
        --port <outdir>/td3_training_test.csv \\
        --record results/r5/final_full/td3_training_test.csv \\
        --rows 2-7 --scenarios crowd_dense/crowd_highspeed,...

Both files are in the reference's 8-column CSV schema that
``drivers/evaluate`` writes (one row per scenario). ``--rows`` picks the
record's data rows (1-based, the header not counted) that line up with
the port file's rows. Prints one JSON line per scenario (successes,
episodes, rate and interval on each side, whether the intervals overlap)
and a markdown table; exits 1 if any pair does not overlap.
"""
from __future__ import annotations

import argparse
import csv
import json
import math
import sys


def wilson(k: int, n: int, z: float = 1.96):
    p = k / n
    den = 1 + z * z / n
    mid = (p + z * z / (2 * n)) / den
    half = z * math.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / den
    return mid - half, mid + half


def _rows(path):
    with open(path) as fp:
        return [(int(r["success_episode"]), int(r["episode_number"]))
                for r in csv.DictReader(fp)]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--port", required=True)
    p.add_argument("--record", required=True)
    p.add_argument("--rows", required=True, help="e.g. 2-7")
    p.add_argument("--scenarios", default=None,
                   help="comma-separated names, in the rows' order")
    args = p.parse_args(argv)
    lo, hi = (int(x) for x in args.rows.split("-"))
    record = _rows(args.record)[lo - 1:hi]
    port = _rows(args.port)
    if len(port) != len(record):
        raise SystemExit(f"{len(port)} port rows for {len(record)} record "
                         f"rows")
    names = (args.scenarios.split(",") if args.scenarios
             else [str(i) for i in range(lo, hi + 1)])
    table, ok = [], True
    for name, (ks, ns), (kr, nr) in zip(names, port, record):
        wp, wr = wilson(ks, ns), wilson(kr, nr)
        overlap = wp[0] <= wr[1] and wr[0] <= wp[1]
        ok &= overlap
        row = {"scenario": name, "port": [ks, ns], "port_rate": ks / ns,
               "port_wilson95": [round(x, 4) for x in wp],
               "record": [kr, nr], "record_rate": kr / nr,
               "record_wilson95": [round(x, 4) for x in wr],
               "overlap": overlap}
        print(json.dumps(row))
        table.append(f"| {name} | {ks:,}/{ns:,} = {ks / ns:.4f} "
                     f"[{wp[0]:.4f}, {wp[1]:.4f}] | {kr:,}/{nr:,} = "
                     f"{kr / nr:.4f} [{wr[0]:.4f}, {wr[1]:.4f}] | "
                     f"{'yes' if overlap else 'NO'} |")
    print("\n".join(table))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
