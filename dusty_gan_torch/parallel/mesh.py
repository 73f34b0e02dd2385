"""Data parallelism over ``torch.distributed``
(``dusty_gan_tpu/parallel/mesh.py``): one process per GPU, as the
reference trains (``mp.spawn`` at train.py:186, NCCL process groups at
train.py:44-50).

A process owns one device, so the JAX module's mesh helpers have no
counterpart here:

* ``create_mesh`` and ``create_local_mesh``: the process group stands for
  the mesh, and a rank's own device for the local mesh (rank-0-only work,
  validation and image logging, runs on it and issues no collective);
* ``batch_sharding`` and ``shard_batch``: each rank holds its share of
  the global batch as an ordinary tensor (the ``Loader`` yields it; its
  ``local_batch_slice`` of each accumulation round's rows, as the step's
  ``local_draws`` reads it); the step averages the gradients over ranks
  with ``all_reduce_mean_``, where XLA inserts the all-reduce itself,
  and a mean over the global batch inside a loss is ``global_mean``,
  whose backward all-reduces the gradient, where XLA differentiates
  through the sharded mean;
* ``replicated``: parameters are replicated by construction (same seed or
  the same checkpoint on every rank, the same averaged update);
* ``shard_eval_inputs``: the evaluation CLIs stripe whole blocks and
  batches across ranks instead of splitting a batch over local devices.

Groups: ``"cpu:gloo,cuda:nccl"`` on the card, so CUDA tensors reduce over
NCCL and host arrays gather over gloo; ``"gloo"`` on the CPU.  NCCL
communicators are made at the first CUDA collective, so two ranks may
share a card as long as they only gather host arrays (the evaluation
merges); training needs a card a rank.

Without a process group ``rank()``, ``world_size()`` and ``is_main()``
return 0, 1 and True, and nothing here issues a collective.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import signal
import socket
import threading
import warnings
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# the rendezvous that torchrun sets, and ``spawn`` sets for its children
ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
# Every collective waits at most this long.  It must outlast the longest
# stretch that rank 0 spends alone while the others wait in their next
# all-reduce: a validation at the ``test`` cadence and image logging (see
# PERF.md for their measured seconds).
GROUP_TIMEOUT = datetime.timedelta(minutes=30)


def distributed() -> bool:
    """Whether this process belongs to a process group."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if distributed() else 0


def world_size() -> int:
    return dist.get_world_size() if distributed() else 1


def is_main() -> bool:
    return rank() == 0


def init_distributed(device) -> torch.device:
    """Join the process group that the environment describes (``ENV``, as
    torchrun sets it) and return this rank's device: ``cuda:LOCAL_RANK``
    when ``device`` is a CUDA device, else the CPU.  Ends with one barrier
    over the host group.  A process already in a group keeps it."""
    device = torch.device(device)
    if not distributed():
        missing = [k for k in ENV if not os.environ.get(k)]
        if missing:
            raise SystemExit(
                f"multihost needs the rendezvous environment {', '.join(ENV)} "
                f"(torchrun sets it); missing: {', '.join(missing)}")
    local = int(os.environ["LOCAL_RANK"])
    if device.type == "cuda":
        if local >= torch.cuda.device_count():
            raise SystemExit(f"LOCAL_RANK {local} but {torch.cuda.device_count()} "
                             "visible GPU(s)")
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    if distributed():
        return device
    dist.init_process_group(
        "cpu:gloo,cuda:nccl" if device.type == "cuda" else "gloo",
        init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
        rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]),
        timeout=GROUP_TIMEOUT)
    host_barrier()
    return device


def host_barrier() -> None:
    """Every rank waits here for every other: one all-reduce of a host
    tensor, over gloo."""
    dist.all_reduce(torch.zeros(1))


def shutdown() -> None:
    if distributed():
        dist.destroy_process_group()


@contextlib.contextmanager
def process_group(device, join: bool = True):
    """Yields this rank's device inside the group of ``init_distributed``
    (with ``join``; else ``device`` as it is), and shuts the group down
    after the body if this call made it."""
    if not join:
        yield torch.device(device)
        return
    made = not distributed()
    device = init_distributed(device)
    try:
        yield device
    finally:
        if made:
            shutdown()


def num_processes(device, requested: Optional[int]) -> int:
    """``num_devices`` -> the processes to run: None means every visible
    GPU on CUDA and one process on the CPU.  More GPUs than are visible
    raise."""
    device = torch.device(device)
    if device.type != "cuda":
        return 1 if requested is None else int(requested)
    visible = torch.cuda.device_count()
    if requested is None:
        return visible
    if int(requested) > visible:
        raise ValueError(f"num_devices={requested} but {visible} GPU(s) are visible")
    return int(requested)


def local_batch_slice(global_batch: int, process_index: Optional[int] = None,
                      process_count: Optional[int] = None) -> slice:
    """This rank's slice of the global batch (the reference's
    DistributedSampler, trainers/dcgan_amp.py:87)."""
    pi = rank() if process_index is None else process_index
    pc = world_size() if process_count is None else process_count
    assert global_batch % pc == 0, (global_batch, pc)
    per = global_batch // pc
    return slice(pi * per, (pi + 1) * per)


def pad_to_multiple(tree: Dict, multiple: int) -> Tuple[Dict, int]:
    """Edge-pad the leading axis of every array or tensor of a dict up to a
    multiple; returns (padded, original leading size)."""
    sizes = {x.shape[0] for x in tree.values()}
    assert len(sizes) == 1, f"ragged leading axes: {sizes}"
    n = sizes.pop()
    r = (-n) % multiple
    if r == 0:
        return tree, n

    def pad(x):
        if isinstance(x, torch.Tensor):
            return torch.cat([x, x[-1:].expand(r, *x.shape[1:])])
        x = np.asarray(x)
        return np.pad(x, [(0, r)] + [(0, 0)] * (x.ndim - 1), mode="edge")

    return {k: pad(v) for k, v in tree.items()}, n


def pod_allgather(x) -> np.ndarray:
    """Every rank's host array, stacked (W, *x.shape), over the host
    group.  Every rank calls it in lockstep with the same shape."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    out = [torch.empty_like(t) for _ in range(world_size())]
    dist.all_gather(out, t)
    return torch.stack(out).numpy()


def all_reduce_mean_(tensors: Sequence[torch.Tensor]) -> None:
    """Replace each tensor by its mean over ranks, in place, through one
    flat bucket (one all-reduce)."""
    tensors = list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    flat /= world_size()
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over dim 0 across every rank's rows, kept as dim 0
    of size 1 (``x.mean(dim=0, keepdim=True)`` over the global batch; the
    ranks hold equally many rows).  Differentiable: the local sum goes
    through ``torch.distributed.nn``'s all-reduce (SUM), whose backward
    all-reduces (SUMs) the gradient, so each rank's rows take the gradient
    of every rank's use of the mean; with the step's average of the
    parameter gradients over ranks this is the gradient of the global
    loss (``tests/test_torch_multigpu.py`` holds it).  One collective
    forward and one backward; without a group of more than one rank it is
    the plain mean and issues none."""
    if world_size() == 1:
        return x.mean(dim=0, keepdim=True)
    import torch.distributed.nn.functional as dist_nn

    with warnings.catch_warnings():
        # recent torch marks these autograd collectives deprecated; the
        # loss needs their backward
        warnings.simplefilter("ignore", FutureWarning)
        total = dist_nn.all_reduce(x.sum(dim=0, keepdim=True), op=dist.ReduceOp.SUM)
    return total / (x.shape[0] * world_size())


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawned(index: int, fn, args) -> None:
    os.environ["RANK"] = os.environ["LOCAL_RANK"] = str(index)
    fn(*args)


def spawn(fn, nprocs: int, *args) -> None:
    """Run ``fn(*args)`` in ``nprocs`` local processes (started fresh, as
    ``torch.multiprocessing.spawn`` starts them), each with the rendezvous
    environment of rank i of ``nprocs`` on a free local port.  A SIGTERM to
    this process is passed on to every child.  Raises if a child fails."""
    import torch.multiprocessing as mp

    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()),
           "WORLD_SIZE": str(nprocs)}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    prev = None
    try:
        ctx = mp.start_processes(_spawned, args=(fn, args), nprocs=nprocs, join=False,
                                 start_method="spawn")
        if threading.current_thread() is threading.main_thread():
            def forward(signum, frame):
                for p in ctx.processes:
                    if p.is_alive():
                        os.kill(p.pid, signum)
            prev = signal.signal(signal.SIGTERM, forward)
        while not ctx.join():
            pass
    finally:
        if prev is not None:
            signal.signal(signal.SIGTERM, prev)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
