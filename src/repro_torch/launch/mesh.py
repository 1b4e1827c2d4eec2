"""Process groups for tensor parallelism (the counterpart of
`repro.launch.mesh`).

The reference is single-controller: one program lays its arrays out on a
JAX mesh.  The port follows PyTorch's idiom instead: one process per
rank, each running the same program on its own device, joined by a
`torch.distributed` group.  `make_tp_group` joins the calling process to
a group of `tp` ranks; `run_ranks` spawns the ranks of one group from a
parent process and gathers what each returns.

The backend is always the caller's choice: "nccl" (cards, one rank per
card) or "gloo" (the CPU, or ranks that share one card).  Nothing here
picks it.  Rank r runs on `cuda:{r % device_count}`, or on the CPU when
the caller asks for it (`rank_device`).
"""
from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback
from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.core.device import resolve_device

BACKENDS = ("nccl", "gloo")


def rank_device(rank: int, device="cuda") -> torch.device:
    """Rank `rank`'s device: the CPU when `device` is "cpu", else
    `cuda:{rank % device_count}` (raises without CUDA)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return dev
    return torch.device("cuda", rank % torch.cuda.device_count())


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")


def make_tp_group(tp: int, *, rank: int, backend: str, init_method: str,
                  timeout: float = 600.0):
    """Join this process to the `tp`-rank group as `rank` and return the
    group.  `init_method` is a `file://` store (tests) or
    `tcp://host:port`; the world is the group, so tp = the world size."""
    _check_backend(backend)
    if not 0 <= rank < tp:
        raise ValueError(f"rank {rank} outside a group of {tp}")
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=init_method, world_size=tp, rank=rank,
            timeout=datetime.timedelta(seconds=timeout))
    if dist.get_world_size() != tp or dist.get_rank() != rank:
        raise RuntimeError(
            f"the process group is rank {dist.get_rank()} of "
            f"{dist.get_world_size()}, not rank {rank} of {tp}")
    return dist.group.WORLD


def _rank_main(rank, fn, tp, backend, device, init_method, timeout,
               threads, args, results):
    """One spawned rank: its device, the group, `fn(rank, device, *args)`
    with the group active (`distributed.tp.activate`), and its outcome
    on `results` as (rank, ok, value or traceback)."""
    from repro_torch.distributed import tp as TP
    try:
        if threads:
            torch.set_num_threads(threads)
        dev = rank_device(rank, device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        group = make_tp_group(tp, rank=rank, backend=backend,
                              init_method=init_method, timeout=timeout)
        with TP.activate(group):
            out = fn(rank, dev, *args)
        dist.barrier(group)
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 — the parent reports and fails
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(5)


def run_ranks(fn: Callable, tp: int, *, backend: str, device="cuda",
              timeout: float = 600.0, args: tuple = (),
              init_method: str = None, threads: int = None) -> list:
    """Spawn `tp` ranks (`torch.multiprocessing`'s spawn context), each
    running `fn(rank, device, *args)` inside the group with the group
    active; -> [rank 0's return, rank 1's, ...].

    `fn` and `args` must pickle (a module-level function).  Raises
    `RuntimeError` with the rank's traceback if any rank fails or exits
    without a result, and `TimeoutError` if the ranks overrun `timeout`
    seconds; either way every rank is stopped.  `init_method` defaults
    to a file store in a fresh temporary directory.  `threads`: each
    rank's intra-op threads; by default the host's cores split among the
    ranks (ranks that each take every core slow one another down many
    times over); 0 keeps torch's default."""
    _check_backend(backend)
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if threads is None:
        threads = max(1, (os.cpu_count() or 1) // tp)
    tmp = None
    if init_method is None:
        tmp = tempfile.mkdtemp(prefix="repro_torch_tp_")
        init_method = "file://" + os.path.join(tmp, "store")
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, fn, tp, backend, str(device), init_method,
                               timeout, threads, args, results))
             for r in range(tp)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        out = {}
        while len(out) < tp:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{tp} ranks overran {timeout:.0f} s; "
                                   f"results from ranks {sorted(out)}")
            try:
                rank, ok, value = results.get(timeout=min(left, 0.5))
            except queue.Empty:
                dead = [(i, p.exitcode) for i, p in enumerate(procs)
                        if i not in out and p.exitcode is not None]
                if dead:
                    raise RuntimeError(f"rank(s) exited without a result "
                                       f"(rank, exit code): {dead}")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {tp} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
            if p.exitcode != 0:
                raise RuntimeError(f"a rank exited with {p.exitcode} after "
                                   "its result")
        return [out[r] for r in range(tp)]
    finally:
        _stop(procs)
        if tmp is not None:
            for name in os.listdir(tmp):
                os.remove(os.path.join(tmp, name))
            os.rmdir(tmp)
