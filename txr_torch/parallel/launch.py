"""Run a function on N ranks of one ``torch.distributed`` group, each in a
process of its own, and hand their results back to the caller.

``run_ranks(fn, n, args)`` starts n processes with the ``spawn`` method.
Rank r joins a process group of world size n through a ``file://``
rendezvous in a fresh temporary directory (no TCP port, so concurrent
launches on one machine cannot collide), sets one CPU thread, calls
``fn(r, n, *args)`` and sends back what it returns (numpy arrays, numbers,
strings: anything picklable). ``fn`` must be importable by the ranks, so a
module-level function. The group is torn down in every rank, and a rank that
raises, dies or outlives ``timeout_s`` makes the call raise with its
traceback; every process is gone when the call returns.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence


def _rank_main(fn, rank: int, world: int, args, store: str, backend: str,
               results) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group(backend, init_method=f"file://{store}",
                                world_size=world, rank=rank)
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:          # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable[..., Any], world_size: int,
              args: Sequence[Any] = (), backend: str = "gloo",
              timeout_s: float = 300.0) -> List[Any]:
    """``[fn(0, n, *args), ..., fn(n - 1, n, *args)]``, each run on its own
    rank of an n-process group over ``backend``."""
    if world_size < 1:
        raise ValueError(f"world_size must be at least 1, got {world_size}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="txr_ranks_")
    store = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world_size, tuple(args), store,
                               backend, results), daemon=True)
             for r in range(world_size)]
    out: dict = {}
    failed: dict = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        # a failed rank ends the wait: its peers may be blocked in a
        # collective it will never join
        while len(out) < world_size and not failed:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"{world_size - len(out)} of {world_size} ranks did not "
                    f"finish within {timeout_s} s")
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    raise RuntimeError(
                        f"rank {dead[0]} exited with code "
                        f"{procs[dead[0]].exitcode} before it reported")
                continue
            (out if ok else failed)[rank] = payload
        if not failed:
            for p in procs:
                p.join(timeout=30)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if failed:
        rank = min(failed)
        raise RuntimeError(f"rank {rank} of {world_size} failed:\n"
                           f"{failed[rank]}")
    return [out[r] for r in range(world_size)]
