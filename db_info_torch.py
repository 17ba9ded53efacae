#!/usr/bin/env python3
"""Dump the schema and row counts of an RTAB-Map sqlite database.

The port's counterpart of db_info.py, on txr_torch.io.rtabmap_db: the same
arguments and the same output. Parity with the reference utility
(db_info.py:10-29), which produced db_schema.txt (tables Node, Data, Link,
Word, Feature, ...).

Usage:
    python db_info_torch.py session.db [-o db_schema.txt]
"""

import argparse
import json

from txr_torch.io.rtabmap_db import db_info


def main():
    parser = argparse.ArgumentParser(description="RTAB-Map DB inspector")
    parser.add_argument("db", help="Path to .db file")
    parser.add_argument("-o", "--output", default=None,
                        help="Write schema dump to this file")
    args = parser.parse_args()

    info = db_info(args.db)
    lines = []
    for table, meta in info["tables"].items():
        lines.append(f"Table: {table} ({meta['rows']} rows)")
        for col in meta["columns"]:
            lines.append(f"  {col}")
        lines.append("")
    text = "\n".join(lines)
    print(text)
    if args.output:
        with open(args.output, "w") as f:
            f.write(text)
        print(f"Written to {args.output}")


if __name__ == "__main__":
    main()
