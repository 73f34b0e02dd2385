"""Chunked training over a process group of ``ranks`` cards
(``dusty2_kitti.train_dp4``): the loop of ``train_chunks`` as
``cli/train.py num_devices=4 steps_per_call=K cache_device=true`` runs it,
one process a card, each holding the whole train split in its device
cache and training on its ``mesh.local_batch_slice`` of every global
round, the gradients averaged by NCCL all-reduces captured in the chunk's
CUDA graph (``train/step.py``, ``train/graphs.py``).

The harness process is rank 0 (``cuda:0``).  It starts ranks 1.. as
processes of this module (``--child``, a rank each, ``cuda:r``) with the
rendezvous on a free local port, as torchrun starts a node's ranks; the
process group is ``cpu:gloo,cuda:nccl`` (gloo alone on the CPU), every
collective outside the graph waits at most ``group_timeout_s``.  A
captured collective has no timeout, so nothing may be left to hang:

* rank 0 watches its ranks: one that exits with an error, or a run past
  ``deadline_s``, ends rank 0's process at once with exit code 5, after
  every process has written the stacks of its threads to standard error
  (``faulthandler``; the ranks on SIGUSR1);
* a rank watches rank 0: when it is gone, the rank ends too.

Every rank writes its phases to standard error (``gpubench dp rank <r>
+<s> <phase>``), so that a run that stops shows where each rank stood.
At the end every rank frees its chunk graphs, which hold NCCL work,
before the group is torn down.

Every rank makes the seed's inputs (scans, weights, the checked chunk's
global rows and draws) itself, and its rows of them are its local batch.
Rank by rank, the run is ``train_chunks``': the checked chunk (taps of
each slot's augmented reals and D's logits of slot 0's; Adam's first
moment after slot 0, which the all-reduce has made the global batch's;
each leaf's change), warm-up chunks, the window, the traced segment.  The
window runs a number of chunks that rank 0 sets from a timed warm-up
chunk and sends every rank, so that all replay equally many;
``train_scans_per_s`` counts the global batch.

The check gathers the ranks' reals and logits into the global batch's
rows, in rank order, and compares them with the single-process reference
at the global batch by ``train_chunks.compare``, and adds

* ``rank_gap``: after the checked chunk, the largest over ranks of the
  norm of the difference between that rank's parameters (G, D, G_ema,
  flat) and rank 0's, over rank 0's norm: 0 exactly, since every rank
  applies the same averaged gradients to the same state.
"""

from __future__ import annotations

import argparse
import datetime
import faulthandler
import json
import math
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

from gpubench.drivers import train_chunks as tc

NUMBERS = tc.NUMBERS + ("rank_gap",)
EXIT_RANK_LOST = 5


def _local(d, rank: int, world: int):
    """This rank's rows of one step's global draws (a 0-d tensor kept)."""
    from dusty_gan_torch.parallel import mesh

    if isinstance(d, torch.Tensor):
        return d[mesh.local_batch_slice(d.shape[0], rank, world)] if d.dim() else d
    if isinstance(d, dict):
        return {k: _local(v, rank, world) for k, v in d.items()}
    if isinstance(d, (list, tuple)):
        return type(d)(_local(v, rank, world) for v in d)
    return d


_T0 = time.monotonic()


def phase(rank: int, what: str) -> None:
    print(f"gpubench dp rank {rank} +{time.monotonic() - _T0:.1f}s {what}", file=sys.stderr,
          flush=True)


def child_argv(spec_file: str, rank: int, port: int, seed: int, device_type: str) -> list:
    """The command of rank ``rank``'s process."""
    return [sys.executable, "-m", "gpubench.drivers.train_chunks_dp", "--child", spec_file,
            "--rank", str(rank), "--port", str(port), "--seed", str(seed),
            "--device", device_type]


def join_group(rank: int, world: int, port: int, device, timeout_s: float) -> None:
    import torch.distributed as dist

    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("cpu:gloo,cuda:nccl" if device.type == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    phase(rank, "joined the group")


class Rank(tc.Run):
    """One rank's part of the run: ``train_chunks.Run`` on this rank's rows,
    in the process group."""

    def __init__(self, spec: dict, seed: int, device, rec, rank: int):
        super().__init__(spec, seed, device, rec)
        self.rank, self.world = rank, int(self.traffic["ranks"])

    def checked_chunk(self) -> None:
        inp = self.inp
        draws = inp.draws
        with mock.patch.object(inp, "rows", inp.rows[:, self._slice(inp.batch)]), \
                mock.patch.object(inp, "draws", lambda: [_local(d, self.rank, self.world)
                                                         for d in draws()]):
            super().checked_chunk()
        phase(self.rank, "checked chunk done")
        self.exchange()
        phase(self.rank, "exchange done")

    def _slice(self, n: int) -> slice:
        from dusty_gan_torch.parallel import mesh

        return mesh.local_batch_slice(n, self.rank, self.world)

    def exchange(self) -> None:
        """Rank 0 gathers every rank's reals and slot 0's logits, and every
        rank's parameters after the checked chunk (``gathered``,
        ``rank_gap``)."""
        import torch.distributed as dist

        from dusty_gan_torch.parallel import mesh

        rec = self.record
        reals = mesh.pod_allgather(torch.stack(rec["reals"]).numpy())  # (W, K, b, 1, H, W)
        logits = mesh.pod_allgather(rec["d_real"][0].numpy())  # (W, b)
        st = self.trainer.state
        flat = torch.cat([p.detach().reshape(-1) for m in (st.G, st.D, st.G_ema)
                          for p in m.parameters()])
        every = [torch.empty_like(flat) for _ in range(self.world)]
        dist.all_gather(every, flat)
        if self.rank == 0:
            ref0 = every[0].double()
            self.rank_gap = max(float(torch.linalg.vector_norm(e.double() - ref0))
                                for e in every) / float(torch.linalg.vector_norm(ref0))
            self.gathered = dict(rec, reals=[torch.from_numpy(np.concatenate(list(reals[:, j])))
                                             for j in range(self.K)],
                                 d_real=[torch.from_numpy(np.concatenate(list(logits)))])
        del every

    def setup(self) -> None:
        self.build()
        phase(self.rank, "built")
        with self.rec.span("setup.checked_chunk"):
            self.checked_chunk()
        self.ix = self.trainer.loader.index_stream(self.done)
        with self.rec.span("setup.warmup"):
            for _ in range(int(self.traffic["warmup_chunks"])):
                self._chunk()
            self._sync()
            t0 = time.perf_counter()
            self._chunk()
            self._sync()
            self.chunk_s = time.perf_counter() - t0
        phase(self.rank, "warm-up done")
        self.context["setup_parts_s"] = {n: b - a for n, a, b in self.rec.spans
                                         if n.startswith("setup.")}

    def chunks_of_window(self, seconds: float) -> int:
        """Rank 0's chunk count for ``seconds``, sent to every rank."""
        import torch.distributed as dist

        n = torch.tensor([max(1, math.ceil(seconds / self.chunk_s)) if self.rank == 0 else 0])
        dist.broadcast(n, 0)
        phase(self.rank, f"window of {int(n)} chunks")
        return int(n)

    def leave(self) -> None:
        """Free the chunk graphs (they hold NCCL work), then leave the group
        with every other rank."""
        import torch.distributed as dist

        from dusty_gan_torch.parallel import mesh

        self._sync()
        tc.Run.release(self)
        phase(self.rank, "graphs freed")
        mesh.host_barrier()
        dist.destroy_process_group()
        phase(self.rank, "left the group")


class Run(Rank):
    """Rank 0, in the harness process."""

    def __init__(self, spec: dict, seed: int, device, rec):
        super().__init__(spec, seed, device, rec, 0)
        self.children = []
        self.spec = spec
        self.watching = True

    def setup(self) -> None:
        from dusty_gan_torch.parallel import mesh

        self.t0 = time.monotonic()
        port = mesh.free_port()
        self.spec_file = tempfile.NamedTemporaryFile("w", suffix=".json", delete=False)
        json.dump(self.spec, self.spec_file, default=str)
        self.spec_file.close()
        root = str(Path(__file__).resolve().parents[2])
        path = [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]
        for r in range(1, self.world):
            # the rendezvous environment torchrun sets, beside the arguments
            env = dict(os.environ, PYTHONPATH=os.pathsep.join(path), RANK=str(r),
                       LOCAL_RANK=str(r), WORLD_SIZE=str(self.world),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
            self.children.append(subprocess.Popen(
                child_argv(self.spec_file.name, r, port, self.seed, self.device.type),
                cwd=root, env=env, stdout=subprocess.DEVNULL))
        threading.Thread(target=self._watch, daemon=True).start()
        join_group(0, self.world, port, self.device, float(self.traffic["group_timeout_s"]))
        super().setup()

    def _watch(self) -> None:
        deadline = self.t0 + float(self.traffic["deadline_s"])
        while self.watching:
            codes = [p.poll() for p in self.children]
            lost = [r + 1 for r, c in enumerate(codes) if c not in (None, 0)]
            if lost or time.monotonic() > deadline:
                why = (f"rank(s) {lost} exited with an error" if lost
                       else "the run passed its deadline")
                print(f"gpubench: {why}; ending every rank", file=sys.stderr, flush=True)
                if not lost:
                    faulthandler.dump_traceback(all_threads=True)
                    for p in self.children:
                        if p.poll() is None:
                            p.send_signal(signal.SIGUSR1)
                    time.sleep(2.0)
                for p in self.children:
                    if p.poll() is None:
                        p.kill()
                os._exit(EXIT_RANK_LOST)
            time.sleep(0.5)

    def window(self, seconds: float, trace_on: bool) -> dict:
        n = self.chunks_of_window(seconds)
        self._sync()
        self.rec.spans.clear()
        t0 = time.perf_counter()
        for _ in range(n):
            self._chunk()
        self._sync()
        window_s = time.perf_counter() - t0
        steps = n * self.K
        self.attempted = steps
        self.trace_on = trace_on
        self.context.update(window_s=window_s, window_steps=steps, batch=self.inp.batch)
        return {"train_scans_per_s": steps * self.inp.batch / window_s}

    def traced(self) -> dict:
        self._tell_trace(True)
        out = super().traced()
        phase(0, "traced segment done")
        return out

    def _tell_trace(self, on: bool) -> None:
        import torch.distributed as dist

        flag = torch.tensor([int(on)])
        dist.broadcast(flag, 0)

    def release(self) -> None:
        if not self.trace_on:
            self._tell_trace(False)
        # every rank leaves the group together: NCCL's teardown waits for
        # the others, so rank 0 may not wait for its ranks' exit first
        self.leave()
        for p in self.children:
            p.wait(timeout=float(self.traffic["group_timeout_s"]))
        self.watching = False
        os.unlink(self.spec_file.name)
        phase(0, "every rank exited")

    def check(self) -> list:
        numbers = tc.compare(self.gathered, tc.reference_record(self.inp))
        numbers["rank_gap"] = self.rank_gap
        return [{"name": k, "value": numbers[k], "limit": float(self.limits[k])}
                for k in NUMBERS]


def child(spec_file: str, rank: int, port: int, seed: int, device_type: str) -> int:
    """Rank ``rank``: the set-up, the window's chunks and, when rank 0
    traces, the traced segment's, in step with rank 0."""
    from gpubench.harness import Recorder

    faulthandler.register(signal.SIGUSR1, all_threads=True)
    parent = os.getppid()

    def watch():
        while True:
            if os.getppid() != parent:
                os._exit(EXIT_RANK_LOST)
            time.sleep(0.5)

    threading.Thread(target=watch, daemon=True).start()
    with open(spec_file) as f:
        spec = json.load(f)
    spec["root"] = Path(spec["root"])
    device = torch.device("cuda", rank) if device_type == "cuda" else torch.device("cpu")
    import torch.distributed as dist

    join_group(rank, int(spec["traffic"]["ranks"]), port, device,
               float(spec["traffic"]["group_timeout_s"]))
    run = Rank(spec, seed, device, Recorder(), rank)
    run.setup()
    for _ in range(run.chunks_of_window(0.0)):
        run._chunk()
    run._sync()
    phase(rank, "window done")
    flag = torch.tensor([0])
    dist.broadcast(flag, 0)
    if int(flag):
        phase(rank, "tracing")
        for _ in range(2 * int(run.traffic["trace_chunks"])):
            run._chunk()
        run._sync()
        phase(rank, "traced chunks done")
    run.leave()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one rank of a train_chunks_dp cell")
    ap.add_argument("--child", required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return child(args.child, args.rank, args.port, args.seed, args.device)


if __name__ == "__main__":
    sys.exit(main())
