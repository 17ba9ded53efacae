#!/usr/bin/env python3
"""Inspect the calibration blob stored in an RTAB-Map database.

The port's counterpart of get_calibration.py, on txr_torch.io.rtabmap_db:
the same arguments and the same output. Parity with the reference utility
(get_calibration.py:8-47), which dumped the blob as int32/float64 at
several offsets to reverse-engineer the layout (int32 width/height at
indices 4/5; float64 K at byte offset 44).

Usage:
    python get_calibration_torch.py session.db
"""

import argparse
import sqlite3

import numpy as np

from txr_torch.io.rtabmap_db import parse_calibration_blob


def main():
    parser = argparse.ArgumentParser(description="RTAB-Map calibration inspector")
    parser.add_argument("db", help="Path to .db file")
    parser.add_argument("--raw", action="store_true",
                        help="Also dump raw int32/float64 views at offsets 0/44")
    args = parser.parse_args()

    conn = sqlite3.connect(args.db)
    cur = conn.cursor()
    cur.execute("SELECT calibration FROM Data WHERE calibration IS NOT NULL LIMIT 1")
    row = cur.fetchone()
    if not row or not row[0]:
        print("No calibration blob found")
        return
    blob = row[0]
    print(f"Calibration blob: {len(blob)} bytes")

    if args.raw:
        ints = np.frombuffer(blob, dtype=np.int32)
        print("int32 view  [:12]:", ints[:12])
        doubles = np.frombuffer(blob, dtype=np.float64, offset=44)
        print("float64 @44 [:9]:", doubles[:9])

    intr = parse_calibration_blob(blob)
    if intr is None:
        print("Failed to parse calibration")
    else:
        print(f"Parsed: {intr.width}x{intr.height} fx={intr.fx} fy={intr.fy} "
              f"cx={intr.cx} cy={intr.cy}")
    conn.close()


if __name__ == "__main__":
    main()
