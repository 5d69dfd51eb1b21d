"""Run jobs of ``parallel.sharding`` on several ranks, each a spawned process.

A job is ``(name, factory, factory_args, factory_kwargs, call_args)``: the
rank builds ``parallel.sharding.<factory>(mesh, *factory_args,
**factory_kwargs)`` on its mesh and calls it with ``call_args`` (host
arrays or CPU tensors, the global inputs); ``shard_chrom_batch``, which
takes the mesh last, is called as ``shard_chrom_batch(*call_args, mesh)``.  ``run_ranks``
saves the jobs into a working directory (``torch.save``; each rank maps the
file and copies only its shards to its device), starts ``world`` processes
by ``spawn`` (never ``fork``: a forked child of a process that has touched
CUDA cannot use it), and each rank joins the group through a ``file://``
rendezvous in that directory (no port to collide on), runs every job on its
device, and writes its results (on the CPU), the wall of each job and its
launches of K2, K3, K4 and K7.  A rank that raises, or a run past ``timeout`` seconds, fails the
whole run and stops every rank.

The children import this module and the port, nothing else: no test module,
no ``conftest``, no JAX.  The kernel library must be built before the ranks
start (``kernels._build.load()`` in the parent), so that they load it and
do not build it together.
"""

from __future__ import annotations

import datetime
import os
import time

import torch

# the kernels of the sharded functions, by the name chip_smoke.py gives them
COUNTED = {
    "sparse_marginal": ("sparse_marginal", "block_sym_matvec"),
    "escalation_prefix": ("escalation", "prefix_maps"),
    "escalation": ("escalation", "ladder"),
    "hmm_forward_backward": ("hmm_scan", "forward_backward"),
    "segment_marginal": ("segment_marginal", "segment_marginal"),
}


def counters() -> dict:
    """{kernel name: its wrapper}, whose ``launches`` the wrappers count."""
    import importlib

    return {k: getattr(importlib.import_module(
        f"hichap_master_tpu_torch.kernels.{mod}"), fn)
        for k, (mod, fn) in COUNTED.items()}


def to_cpu(x):
    """Tensors anywhere in tuples, lists and dicts moved to the CPU."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, (tuple, list)):
        return type(x)(to_cpu(v) for v in x)
    if isinstance(x, dict):
        return {k: to_cpu(v) for k, v in x.items()}
    return x


def _rank(rank: int, world: int, backend: str, device: str, workdir: str,
          timeout_s: float, threads: int) -> None:
    import torch.distributed as dist

    from hichap_master_tpu_torch.parallel import sharding

    torch.set_num_threads(threads)
    dev = torch.device(device.format(rank=rank))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    sharding.init_ranks(backend, f"file://{workdir}/rendezvous", world, rank,
                        datetime.timedelta(seconds=timeout_s))
    try:
        mesh = sharding.make_mesh(world, device=dev)
        jobs = torch.load(os.path.join(workdir, "jobs.pt"), mmap=True,
                          weights_only=False)
        count = counters()
        for fn in count.values():
            fn.launches = 0
        results, walls = {}, {}
        for name, factory, fargs, fkw, args in jobs:
            if factory == "shard_chrom_batch":
                args = (*args, mesh)
                fn = sharding.shard_chrom_batch
            else:
                fn = getattr(sharding, factory)(mesh, *fargs, **fkw)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out = fn(*args)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            walls[name] = time.perf_counter() - t0
            results[name] = to_cpu(out)
        launches = {k: fn.launches for k, fn in count.items()}
        torch.save({"results": results, "walls": walls,
                    "launches": launches, "shape": mesh.shape},
                   os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(jobs, world: int, workdir: str, *, backend: str = "gloo",
              device: str = "cpu", timeout: float = 600.0,
              threads: int = 1) -> list:
    """Run ``jobs`` on ``world`` spawned ranks, rank r on
    ``device.format(rank=r)`` (``"cuda:{rank}"``: a card each).  Returns each rank's record: ``results`` {name: output}, ``walls``
    {name: seconds}, ``launches`` {kernel: count}, ``shape`` (the mesh)."""
    import torch.multiprocessing as mp

    os.makedirs(workdir, exist_ok=True)
    torch.save(to_cpu(jobs), os.path.join(workdir, "jobs.pt"))
    ctx = mp.start_processes(
        _rank, args=(world, backend, device, workdir, timeout, threads),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{timeout:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]
