#!/usr/bin/env python3
"""Stand-alone check for work on one CUDA kernel of ``txr_torch``.

    timeout 240 python3 tools/kernel_dev.py attention
    timeout 240 python3 tools/kernel_dev.py boundmax
    timeout 240 python3 tools/kernel_dev.py conv
    timeout 240 python3 tools/kernel_dev.py int8
    timeout 240 python3 tools/kernel_dev.py tail
    timeout 240 python3 tools/kernel_dev.py scan
    timeout 240 python3 tools/kernel_dev.py qk_prep
    timeout 240 python3 tools/kernel_dev.py merge
    timeout 240 python3 tools/kernel_dev.py cached
    timeout 240 python3 tools/kernel_dev.py residual_norm
    timeout 240 python3 tools/kernel_dev.py upsample

builds the kernel library with ``-Xptxas -v``, prints what ptxas said about
the chosen source (registers, spills, and the "wgmma ... serialized"
warnings that cost most of the speed when they appear), then runs that
kernel's checks from ``chip_smoke.KERNEL_CHECKS`` at ``chip_smoke.py``'s
default of 8 frames: the same cases, tolerances and timing loop as the full
run, each comparison a ``kernel_check`` line, then each check's row (name,
ms, bound; then the whole row, its shapes' timings too, as JSON) and
``ok``. It is the short first run of a changed kernel: a
wrong mbarrier phase hangs rather than fails, so run it under ``timeout``
before ``chip_smoke.py``. Needs one CUDA device; exits 1 on a failed check.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch

import txr_torch._cuda as kernels
from chip_smoke import KERNEL_CHECKS

BATCH = 8                       # chip_smoke.py's default --frames


def ptxas_lines(source: str) -> None:
    log = kernels.build_log
    start = log.find(f"== {source} ==")
    end = log.find("\n== ", start + 1)
    for line in log[start:end if end > 0 else None].splitlines():
        if any(key in line for key in ("==", "C75", "Used", "spill",
                                       "Compiling entry")):
            print(line[:200], flush=True)


def main() -> int:
    which = sys.argv[1] if len(sys.argv) > 1 else ""
    if which not in KERNEL_CHECKS:
        print(__doc__)
        return 2
    if not torch.cuda.is_available():
        print("kernel_dev: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.build(verbose=True)
    source, checks = KERNEL_CHECKS[which]
    ptxas_lines(source)
    kernels.lib()
    gen = torch.Generator(device="cuda").manual_seed(0)
    try:
        for check in checks:
            rows = check(BATCH, gen)
            for row in rows if isinstance(rows, list) else [rows]:
                print(f"{row.get('name', row.get('entry'))}: "
                      f"{row['ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
                      f"({row['bound_by']})", flush=True)
                print(json.dumps(row, default=str), flush=True)
    except AssertionError as exc:
        print(f"FAILED {exc}", flush=True)
        return 1
    print("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
