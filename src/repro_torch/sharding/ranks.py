"""A pool of ranks: N processes, each one rank of a ``torch.distributed``
process group, that run the functions sent to them in turn.

The CPU tests hold the sharded paths against the unsharded ones on gloo
groups of 2 and 4 such processes, and ``chip_smoke.py`` runs its ranks on
the cards through one (NCCL, rank r on ``cuda:r``). A pool pays the
processes' start (importing torch, joining the group) once for every
function it runs.

    with RankPool(2, init_method=f"file://{tmp}/rdv") as pool:
        rows = pool.run(fn, arg)      # fn(arg) on every rank: [rank 0's, ...]

``fn`` must be importable by name in a fresh interpreter (a module-level
function; the processes are spawned). The constructor returns at once:
the ranks start and join the group meanwhile, and the first ``run``
waits for them, so that two pools can start side by side. A function
that raises on any rank fails ``run`` with its traceback, and the pool
closes: the other ranks may be waiting in a collective that will never
complete. Nothing falls back to fewer ranks.
"""
from __future__ import annotations

import datetime
import queue
import traceback
from typing import Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _serve(rank: int, world: int, backend: str, init_method: str,
           cuda_index: Optional[int], threads: int, timeout_s: float,
           inbox, outbox) -> None:
    torch.set_num_threads(threads)
    kw = {}
    if cuda_index is not None:
        torch.cuda.set_device(cuda_index)
        if backend == "nccl":
            kw["device_id"] = torch.device("cuda", cuda_index)
    try:
        dist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    except Exception:  # noqa: BLE001 - reported to the parent
        outbox.put((rank, False, traceback.format_exc()))
        return
    outbox.put((rank, True, None))
    while True:
        item = inbox.get()
        if item is None:
            break
        fn, args, kwargs = item
        try:
            outbox.put((rank, True, fn(*args, **kwargs)))
        except Exception:  # noqa: BLE001 - reported to the parent
            outbox.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class RankPool:
    """``world`` spawned processes in one process group (``backend``
    gloo or nccl, rendezvous at ``init_method``). ``cuda_devices`` gives
    each rank its card (None: no card); ``timeout_s`` bounds the group's
    collectives and each wait for a rank's answer."""

    def __init__(self, world: int, *, init_method: str,
                 backend: str = "gloo",
                 cuda_devices: Optional[Sequence[int]] = None,
                 threads: int = 1, timeout_s: float = 300.0):
        ctx = mp.get_context("spawn")
        self.world, self.timeout_s = world, timeout_s
        self._outbox = ctx.Queue()
        self._inboxes = [ctx.Queue() for _ in range(world)]
        self._procs = [
            ctx.Process(target=_serve, daemon=True, args=(
                r, world, backend, init_method,
                None if cuda_devices is None else cuda_devices[r], threads,
                timeout_s, self._inboxes[r], self._outbox))
            for r in range(world)]
        for p in self._procs:
            p.start()
        # the ranks join the group while the caller goes on; the first
        # ``run`` waits for them
        self._joined = False

    def _collect(self, what: str) -> list:
        out, failed = [None] * self.world, []
        for _ in range(self.world):
            try:
                rank, ok, value = self._outbox.get(timeout=self.timeout_s)
            except queue.Empty:
                failed.append(f"no answer within {self.timeout_s} s")
                break
            if ok:
                out[rank] = value
            else:
                failed.append(f"--- rank {rank}\n{value}")
                break
        if failed:
            self.close(wait=False)
            raise RuntimeError(f"RankPool({self.world}) failed {what}:\n"
                               + "\n".join(failed))
        return out

    def run(self, fn, *args, **kwargs) -> list:
        """``fn(*args, **kwargs)`` on every rank at once; the results in
        rank order."""
        if not self._procs:
            raise RuntimeError("the rank pool is closed")
        if not self._joined:
            self._collect("joining the process group")
            self._joined = True
        for q in self._inboxes:
            q.put((fn, args, kwargs))
        return self._collect(getattr(fn, "__name__", repr(fn)))

    def close(self, wait: bool = True) -> None:
        """Stop every rank: let them leave the group (``wait``), else
        terminate them."""
        if wait:
            for q in self._inboxes:
                q.put(None)
        for p in self._procs:
            p.join(timeout=30 if wait else 0)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        self._procs = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(wait=exc[0] is None)
        return False
