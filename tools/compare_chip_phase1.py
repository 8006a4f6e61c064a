#!/usr/bin/env python3
"""Compare the kernel times of two versions of the port, from the output of
their `chip_smoke.py` runs on one card:

    python3 tools/compare_chip_phase1.py BASE.log [BASE.log ...] \\
        --new NEW.log [NEW.log ...]

Each log holds the JSON lines one `chip_smoke.py` run printed (phase 1 at
least). For every timed shape that both versions report (a GEMV check row,
an expert check row, a kernel's summary line, the extra summary lines of
phase 1), it prints one JSON line: the kernel, the shape, the least ms of
the base runs and of the new runs, and new / base; then a line with the
count of shapes and of those where the new version is slower. Compare runs
of one call only (one card, one power limit), in the order base, new, new,
base.
"""
from __future__ import annotations

import argparse
import json
import sys

# check rows whose "ms" is a kernel time, and the fields that name the shape
SHAPE_FIELDS = {
    "bcq_gemv": ("M", "K", "N", "group_size", "scale_dtype", "x_dtype"),
    "bcq_expert_matmul": ("E", "M", "K", "N", "group_size", "scale_dtype"),
}
# summary lines: (check or kernel name) -> their "shape" field names it
SUMMARIES = ("bcq_gemv_shape", "bcq_matmul_shape", "bcq_expert_matmul_prefill",
             "paged_attention_rep16", "paged_attention_quant_rep16")


def times(path: str) -> dict:
    """{(kernel, shape): ms} of one run's log."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line.startswith("{"):
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                continue
            check = row.get("check")
            if check in SHAPE_FIELDS and "ms" in row:
                shape = " ".join(f"{k}={row.get(k)}"
                                 for k in SHAPE_FIELDS[check])
                out[(check, shape)] = row["ms"]
            elif check in SUMMARIES and "ms" in row:
                out[(check, row["shape"])] = row["ms"]
            for k in row.get("kernels", ()):
                out[(k["name"], k["shape"])] = k["ms"]
                if "ms_every_row" in k:
                    out[(k["name"], k["shape"] + " every row")] = \
                        k["ms_every_row"]
    return out


def least(runs: list) -> dict:
    best: dict = {}
    for run in runs:
        for key, ms in run.items():
            best[key] = min(ms, best.get(key, ms))
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("base", nargs="+")
    ap.add_argument("--new", nargs="+", required=True)
    args = ap.parse_args(argv)
    base = least([times(p) for p in args.base])
    new = least([times(p) for p in args.new])
    slower = 0
    keys = sorted(set(base) & set(new))
    for key in keys:
        ratio = new[key] / base[key]
        slower += ratio > 1
        print(json.dumps({"compare": key[0], "shape": key[1],
                          "base_ms": base[key], "new_ms": new[key],
                          "new_over_base": ratio}))
    print(json.dumps({"compared": len(keys), "new_slower": slower}))
    return 0 if keys else 1


if __name__ == "__main__":
    sys.exit(main())
