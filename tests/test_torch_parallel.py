"""dusty_gan_torch.parallel.mesh on the CPU.

Single process: ``local_batch_slice`` and ``pad_to_multiple`` equal the
JAX package's ``dusty_gan_tpu.parallel.mesh`` functions (tensors pad as
arrays do); without a process group ``rank``/``world_size``/``is_main``
are 0, 1 and True; ``num_devices`` resolves to processes (more GPUs than
are visible raise); ``init_distributed`` names the rendezvous variables
that are missing.  The port's ``Loader`` yields the JAX ``Loader``'s index
streams and flip bits for each rank at ``process_count=2``.

Two ranks over gloo (one launch, shared by a module fixture):
``pod_allgather`` stacks the ranks' arrays, ``all_reduce_mean_`` averages
in place, and the striped ``pairwise_cd`` (``process_shard``) equals the
single-process matrix exactly, symmetric and not, and JAX's
``_pairwise_cd_blocked`` on the CPU within the Chamfer tolerance of the
other metric tests (atol 1e-5 / rtol 1e-4).

The evaluation CLIs on two ranks (one launch): ``evaluate_synthesis
--multihost`` gives the single-process run's scores, with ``--metrics cd``
and ``cd,emd``, and writes its JSON once; ``evaluate_reconstruction
--multihost`` gives the single-process run's per-sample rows and writes
its CSV once; a group of two ranks without ``--multihost`` refuses to
repeat every batch."""

import argparse
import glob
import json
import os.path as osp

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dusty_gan_tpu.data.loader import Loader as JaxLoader
from dusty_gan_tpu.metrics.cov_mmd_1nna import _pairwise_cd_blocked
from dusty_gan_tpu.parallel import mesh as jax_mesh

from dusty_gan_torch.cli import evaluate_reconstruction as er
from dusty_gan_torch.cli import evaluate_synthesis as es
from dusty_gan_torch.config import compose, save_config
from dusty_gan_torch.data.loader import Loader
from dusty_gan_torch.data.synthetic import build_synthetic_kitti
from dusty_gan_torch.metrics.cov_mmd_1nna import ROW_BLOCK, pairwise_cd
from dusty_gan_torch.models.factory import define_G
from dusty_gan_torch.parallel import mesh

from torch_parity import one_torch_thread  # noqa: F401  (autouse)
from torch_parity import run_ranks

# rows > 2 block-rows, so that both ranks compute some
N_ROWS, N_COLS, N_POINTS, COL_CHUNK = 2 * ROW_BLOCK + 5, 21, 24, 8
CONFIG_DIR = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "configs")
TINY = ["model=dusty2_dcgan_eqlr", "model.gen.in_ch=16", "model.gen.ch_base=8",
        "model.gen.ch_max=16"]
EVAL_SCANS = 40  # test scans: three block-rows of pairwise CD at 16 rows a block
SYNTH = ["--num-test", str(EVAL_SCANS), "--num-points", "32", "--cd-batch", "8",
         "--device", "cpu"]
SYNTH_EMD = ["--num-test", "20", "--num-points", "16", "--cd-batch", "8",
             "--metrics", "cd,emd", "--device", "cpu"]
# three batches of one scan: rank 0 inverts two, rank 1 one
REC = ["--batch-size", "1", "--num-step", "2", "--max-batches", "3", "--device", "cpu"]

CHILD = """
import json, sys
import numpy as np, torch
from dusty_gan_torch.metrics.cov_mmd_1nna import pairwise_cd
from dusty_gan_torch.parallel import mesh

dev = mesh.init_distributed("cpu")
r, w = mesh.rank(), mesh.world_size()
clouds = np.load(sys.argv[1])
a, b = torch.from_numpy(clouds["a"]), torch.from_numpy(clouds["b"])
gathered = mesh.pod_allgather(np.arange(3, dtype=np.float32) + 10 * r)
t = [torch.full((2, 3), float(r + 1)), torch.arange(4.0) * (r + 1)]
mesh.all_reduce_mean_(t)
chunk = int(sys.argv[4])
np.savez(sys.argv[2] % r, ab=pairwise_cd(a, b, chunk, process_shard=True),
         aa=pairwise_cd(a, a, chunk, process_shard=True), gathered=gathered,
         t0=t[0].numpy(), t1=t[1].numpy())
with open(sys.argv[3] % r, "w") as f:
    json.dump({"rank": r, "world": w, "main": mesh.is_main(), "device": str(dev)}, f)
mesh.shutdown()
"""


@pytest.mark.parametrize("case", [
    (8, 0, 2), (8, 1, 2), (12, 2, 3), (5, 0, 1), (7, 1, 2)])
def test_local_batch_slice_equals_jax(case):
    global_batch, index, count = case
    try:
        want = jax_mesh.local_batch_slice(global_batch, index, count)
    except AssertionError:
        with pytest.raises(AssertionError):
            mesh.local_batch_slice(global_batch, index, count)
        return
    assert mesh.local_batch_slice(global_batch, index, count) == want


@pytest.mark.parametrize("n,multiple", [(5, 4), (8, 4), (3, 1), (1, 3), (6, 5)])
def test_pad_to_multiple_equals_jax(n, multiple):
    rng = np.random.RandomState(n)
    tree = {"depth": rng.rand(n, 2, 3).astype(np.float32),
            "index": np.arange(n, dtype=np.int64)}
    want, want_n = jax_mesh.pad_to_multiple(tree, multiple)
    got, got_n = mesh.pad_to_multiple(tree, multiple)
    tensors, t_n = mesh.pad_to_multiple({k: torch.from_numpy(v) for k, v in tree.items()},
                                        multiple)
    assert got_n == t_n == want_n == n
    for k in tree:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
        np.testing.assert_array_equal(tensors[k].numpy(), np.asarray(want[k]))
        assert got[k].shape[0] % multiple == 0


def test_pad_to_multiple_refuses_ragged_axes():
    tree = {"a": np.zeros((3, 1)), "b": np.zeros((4, 1))}
    with pytest.raises(AssertionError):
        jax_mesh.pad_to_multiple(tree, 2)
    with pytest.raises(AssertionError):
        mesh.pad_to_multiple(tree, 2)


def test_single_process_defaults():
    assert not mesh.distributed()
    assert (mesh.rank(), mesh.world_size(), mesh.is_main()) == (0, 1, True)
    assert mesh.local_batch_slice(8) == slice(0, 8)


def test_num_processes(monkeypatch):
    cpu = torch.device("cpu")
    assert mesh.num_processes(cpu, None) == 1
    assert mesh.num_processes(cpu, 2) == 2
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    cuda = torch.device("cuda")
    assert mesh.num_processes(cuda, None) == 1
    assert mesh.num_processes(cuda, 1) == 1
    with pytest.raises(ValueError, match="1 GPU"):
        mesh.num_processes(cuda, 2)


def test_init_distributed_names_missing_variables(monkeypatch):
    for k in mesh.ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match="LOCAL_RANK, MASTER_ADDR, MASTER_PORT"):
        mesh.init_distributed("cpu")
    assert not mesh.distributed()


class _Items:
    """The loaders' index paths read a dataset's length and flip flag only."""
    flip = True

    def __len__(self):
        return 23


@pytest.mark.parametrize("rank,start", [(0, 0), (1, 0), (0, 7), (1, 12)])
def test_loader_index_streams_equal_jax(rank, start):
    kw = dict(shuffle=True, drop_last=True, seed=3, process_index=rank, process_count=2)
    port, jax_loader = Loader(_Items(), 4, **kw), JaxLoader(_Items(), 4, **kw)
    assert len(port) == len(jax_loader)
    a, b = port.index_stream(start), jax_loader.index_stream(start)
    for _ in range(3 * len(port)):
        (ea, ia), (eb, ib) = next(a), next(b)
        assert ea == eb
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(port.flip_bits(ea, ia), jax_loader.flip_bits(eb, ib))


def test_ranks_shards_are_disjoint_and_cover_the_epoch():
    loaders = [Loader(_Items(), 4, shuffle=True, drop_last=True, seed=3, process_index=r,
                      process_count=2) for r in range(2)]
    seen = np.concatenate([i for ld in loaders for i in ld.index_batches(0)])
    assert len(seen) == len(set(seen.tolist())) == 2 * len(loaders[0]) * 2


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    base = tmp_path_factory.mktemp("parallel")
    rng = np.random.RandomState(0)
    clouds = {"a": rng.randn(N_ROWS, N_POINTS, 3).astype(np.float32),
              "b": rng.randn(N_COLS, N_POINTS, 3).astype(np.float32)}
    np.savez(base / "clouds.npz", **clouds)
    run_ranks(["-c", CHILD, str(base / "clouds.npz"), str(base / "out_%d.npz"),
               str(base / "info_%d.json"), str(COL_CHUNK)], base / "shim")
    out = []
    for r in range(2):
        with np.load(base / f"out_{r}.npz") as z, open(base / f"info_{r}.json") as f:
            out.append({**{k: z[k] for k in z.files}, **json.load(f)})
    return clouds, out


def test_two_rank_group_and_collectives(two_ranks):
    _, out = two_ranks
    assert [(o["rank"], o["world"], o["main"], o["device"]) for o in out] == \
        [(0, 2, True, "cpu"), (1, 2, False, "cpu")]
    for o in out:
        np.testing.assert_array_equal(o["gathered"], [[0, 1, 2], [10, 11, 12]])
        np.testing.assert_array_equal(o["t0"], np.full((2, 3), 1.5))
        np.testing.assert_array_equal(o["t1"], np.arange(4.0) * 1.5)


@pytest.mark.parametrize("which", ["ab", "aa"])
def test_striped_pairwise_cd_equals_one_process_and_jax(two_ranks, which):
    clouds, out = two_ranks
    a = torch.from_numpy(clouds["a"])
    b = a if which == "aa" else torch.from_numpy(clouds["b"])
    want = pairwise_cd(a, b, COL_CHUNK)
    assert want.shape == (N_ROWS, b.shape[0]) and -(-N_ROWS // ROW_BLOCK) > 2
    for o in out:  # every rank holds the merged matrix
        np.testing.assert_array_equal(o[which], want)
    ja = jnp.asarray(clouds["a"])
    jax_want = _pairwise_cd_blocked(ja, ja if which == "aa" else jnp.asarray(clouds["b"]),
                                    COL_CHUNK)
    np.testing.assert_allclose(out[0][which], jax_want, atol=1e-5, rtol=1e-4)


CHILD_EVAL = """
import json, sys
from dusty_gan_torch.cli import evaluate_reconstruction as er
from dusty_gan_torch.cli import evaluate_synthesis as es
from dusty_gan_torch.parallel import mesh

mesh.init_distributed("cpu")
synth, synth_emd, rec = (json.loads(a) + ["--multihost"] for a in sys.argv[1:4])
out = {"cd": es.main(synth), "cd,emd": es.main(synth_emd), "rec": er.main(rec)}
with open(sys.argv[4] % mesh.rank(), "w") as f:
    json.dump(out, f)
mesh.shutdown()
"""


@pytest.fixture(scope="module")
def eval_runs(tmp_path_factory):
    """A synthetic tree and a narrow DUSty-II .pth; both evaluation CLIs
    on two ranks (first, so that rank 0 writes the real-tensor caches),
    then in one process."""
    base = tmp_path_factory.mktemp("eval")
    root = build_synthetic_kitti(str(base / "data"), n_scans_per_seq=EVAL_SCANS, w0=512,
                                 sequences=(0, 11))
    cfg = compose(CONFIG_DIR, TINY + [f"dataset.root={root}", "solver.batch_size=8",
                                      "dataset.shape=[32,64]"])
    cfg_path = save_config(cfg, str(base / "run"))
    cfg.model.gen.shape = list(cfg.dataset.shape)
    torch.manual_seed(0)
    sd = define_G(cfg).state_dict()
    pth = str(base / "checkpoint.pth")
    torch.save({"step": 0, "G": sd, "G_ema": sd}, pth)
    common = ["--model-path", pth, "--config-path", cfg_path]
    args = {"cd": common + SYNTH + ["--save-dir-path", str(base / "synth_%s")],
            "cd,emd": common + SYNTH_EMD + ["--save-dir-path", str(base / "emd_%s")],
            "rec": common + REC + ["--save-dir-path", str(base / "rec_%s")]}
    run_ranks(["-c", CHILD_EVAL, *(json.dumps([a.replace("%s", "ranks") for a in args[k]])
                                   for k in ("cd", "cd,emd", "rec")),
               str(base / "ranks_%d.json")], base / "shim")
    ranks = []
    for r in range(2):
        with open(base / f"ranks_{r}.json") as f:
            ranks.append(json.load(f))
    one = {"cd": es.main([a.replace("%s", "one") for a in args["cd"]]),
           "cd,emd": es.main([a.replace("%s", "one") for a in args["cd,emd"]]),
           "rec": er.main([a.replace("%s", "one") for a in args["rec"]])}
    return base, ranks, one


@pytest.mark.parametrize("metrics", ["cd", "cd,emd"])
def test_striped_synthesis_scores_equal_one_process(eval_runs, metrics):
    base, ranks, one = eval_runs
    assert ranks[0][metrics] == ranks[1][metrics] == one[metrics]
    assert one[metrics]["#test"] == (EVAL_SCANS if metrics == "cd" else 20)
    prefix = "synth" if metrics == "cd" else "emd"
    assert len(glob.glob(str(base / f"{prefix}_ranks" / "*.json"))) == 1


def test_striped_reconstruction_rows_equal_one_process(eval_runs):
    base, ranks, one = eval_runs
    assert len(one["rec"]["cd"]) == 3
    assert ranks[0]["rec"] == ranks[1]["rec"] == one["rec"]
    assert len(glob.glob(str(base / "rec_ranks" / "*.csv"))) == 1


def test_reconstruction_in_a_group_needs_multihost(monkeypatch):
    monkeypatch.setattr(mesh, "world_size", lambda: 2)
    with pytest.raises(SystemExit, match="--multihost"):
        er._evaluate(argparse.Namespace(multihost=False), torch.device("cpu"), None)
