"""Start a mesh of ranks on one host: :func:`spawn`.

The port's counterpart of the JAX tests' virtual 8-device CPU mesh: each
rank is a process started by ``torch.multiprocessing`` (spawn), joined to one
process group through a ``FileStore`` in a temporary directory (no network),
with one intra-op thread. ``fn(mesh, *args)`` runs on every rank; what rank
``r`` returns comes back (``torch.save`` / ``torch.load``) as the ``r``-th
entry of the list. A rank that raises fails the call with its traceback; a
rank still running at the timeout (a hung collective, say) is killed and the
call raises :class:`TimeoutError`.

``fn`` must be importable by name (a module-level function), and its module
should import no more than the ranks need: every child imports it afresh.
"""

from __future__ import annotations

import datetime
import os
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from slam_loop_closing_tpu_torch.parallel import mesh as mesh_lib


def _rank_main(rank: int, fn, world_size: int, device: str, tmpdir: str,
               args: tuple, timeout_s: float) -> None:
    torch.set_num_threads(1)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        store=dist.FileStore(os.path.join(tmpdir, "store"), world_size),
        rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        mesh = mesh_lib.make_mesh(world_size, device=dev)
        out = fn(mesh, *args)
        torch.save(out, os.path.join(tmpdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn, world_size: int, *, device="cuda", args: tuple = (),
          timeout: float = 120.0) -> list:
    """Run ``fn(mesh, *args)`` on ``world_size`` spawned ranks (NCCL on
    CUDA, rank ``r`` on GPU ``r``, the default; gloo on ``device="cpu"``);
    returns every rank's result in rank order. Raises :class:`RuntimeError`
    before starting a rank when CUDA is asked for and the ranks' GPUs are
    not there, and :class:`TimeoutError` when the ranks have not all
    finished within ``timeout`` seconds (they are killed)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        need = world_size if dev.index is None else dev.index + 1
        have = torch.cuda.device_count()
        if have < need:
            raise RuntimeError(
                f"spawn on {device}: {world_size} rank(s) need {need} CUDA "
                f"device(s), this machine has {have}; pass device=\"cpu\" "
                "for gloo ranks on the CPU")
    with tempfile.TemporaryDirectory(prefix="slam_mesh_") as tmpdir:
        ctx = mp.start_processes(
            _rank_main, args=(fn, world_size, str(device), tmpdir, args,
                              timeout),
            nprocs=world_size, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(max(deadline - time.monotonic(), 0.0)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"{world_size} ranks of {fn.__name__} still running "
                        f"after {timeout:g} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        return [torch.load(Path(tmpdir) / f"rank{r}.pt", weights_only=False)
                for r in range(world_size)]
