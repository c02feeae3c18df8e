"""Run a function on N ranks of one machine, each a spawned process in a
process group of its own, and collect what each returns.

    results = run_ranks(fn, 4, backend="gloo", store_dir=tmp, args=(...))

``fn(rank, world_size, *args)`` runs in every rank after the default
process group is initialised through a ``FileStore`` under
``store_dir`` (no network port), with ``WORLD_SIZE``, ``RANK`` and
``LOCAL_RANK`` set as ``torchrun`` sets them and one intra-op thread.
``fn`` must be importable by name (a module-level function), and what it
returns must pickle (numbers, numpy arrays, host tensors).  Each rank
pickles its result to bytes itself: a tensor put on a queue as it is
would travel as a handle to the rank's shared memory, which the parent
cannot open once the rank has exited.  A rank that
raises, dies, or outlives ``timeout`` seconds fails the whole run: the
parent kills every rank still alive and raises, so a collective that
hangs cannot hang the caller.  The ranks' devices are ``fn``'s choice;
several ranks may share one card (then only over ``gloo``: NCCL takes
one rank a device).
"""
from __future__ import annotations

import multiprocessing
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback


def _rank_main(call_path, rank, world, backend, store_path, threads, out):
    import torch
    import torch.distributed as dist
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(threads)
    try:
        with open(call_path, "rb") as f:
            fn, args = pickle.load(f)     # written by run_ranks below
        dist.init_process_group(backend, rank=rank, world_size=world,
                                store=dist.FileStore(store_path, world))
        try:
            out.put((rank, True, pickle.dumps(fn(rank, world, *args),
                                              pickle.HIGHEST_PROTOCOL)))
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn, world_size: int, *, backend: str = "gloo",
              store_dir: str = None, args: tuple = (), timeout: float = 120,
              threads: int = 1) -> list:
    """``fn(rank, world_size, *args)`` on ``world_size`` spawned ranks;
    returns their results in rank order."""
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    store = tempfile.mkdtemp(prefix="ranks-", dir=store_dir)
    store_path = os.path.join(store, "store")
    # the call goes through a file: a large argument pickled into each
    # Process would make every start wait for the previous child's imports
    call_path = os.path.join(store, "call.pkl")
    with open(call_path, "wb") as f:
        pickle.dump((fn, args), f)
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(call_path, r, world_size, backend, store_path,
                               threads, out))
             for r in range(world_size)]
    for p in procs:
        p.start()
    results, deadline = {}, time.monotonic() + timeout
    try:
        while len(results) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{world_size - len(results)} of "
                                   f"{world_size} ranks still running "
                                   f"after {timeout} s")
            try:
                rank, ok, res = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank(s) {dead} died (exit codes "
                                       f"{[procs[r].exitcode for r in dead]})")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{res}")
            results[rank] = pickle.loads(res)
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
        out.close()
        shutil.rmtree(store, ignore_errors=True)
    return [results[r] for r in range(world_size)]
