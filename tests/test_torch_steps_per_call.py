"""Chunk mode (``steps_per_call``, ``train/graphs.py``) on the CPU at tiny
sizes, where a chunk runs its steps eagerly through the buffers a CUDA
graph reads on the card: 6 iterations in chunks from iteration 2 (a
realigning chunk of 2, then one of 4) equal the per-step path bit for bit
and gather exactly its rows, with a learning-rate decay that steps inside
the chunks; one chunk of 2 iterations given the JAX package's draws is
held against the JAX ``Trainer.step_chunk`` under the float32 policy
(without DiffAugment, whose parity the one-step tests hold), to
the envelopes of the JAX package's own chunk-against-step test
(``tests/test_device_cache.py``: scalars rtol 1e-5; in every float leaf
of 10,000 elements or more, under 0.1% of the elements beyond 1e-4 +
2e-3 |b|, and every element within 2.2 lr, the room Adam's first update
leaves where a gradient's sign is below float32's reach); a capturable
optimizer's checkpoint is written in the per-step form; and the trace
summary reads a CPU torch.profiler trace."""

import os.path as osp

import jax
import numpy as np
import pytest
import torch

import dusty_gan_tpu.train.trainer as jax_trainer
from dusty_gan_tpu.config import compose as jax_compose
from dusty_gan_tpu.utils import torch_export as te

from dusty_gan_torch.config import compose
from dusty_gan_torch.data.synthetic import build_synthetic_kitti
from dusty_gan_torch.train.checkpoint import save_checkpoint
from dusty_gan_torch.train.state import make_capturable
from dusty_gan_torch.train.trainer import Trainer
from dusty_gan_torch.utils import profiling

from torch_parity import one_torch_thread  # noqa: F401  (autouse)
from torch_parity import jax_step_draws

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
CONFIG_DIR = osp.join(REPO, "configs")
TINY = ["model=dusty2_dcgan_eqlr", "model.gen.in_ch=16", "model.gen.ch_base=8",
        "model.gen.ch_max=16", "model.dis.ch_base=8", "model.dis.ch_max=16",
        "solver.batch_size=4", "dataset.shape=[32,64]", "cache_device=true"]
LR = 2e-3  # configs/solver/nsgan_eqlr.yaml


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return build_synthetic_kitti(str(tmp_path_factory.mktemp("chunks") / "data"),
                                 n_scans_per_seq=10, w0=512, sequences=(0, 8))


def _trainer(root, *extra):
    cfg = compose(CONFIG_DIR, TINY + [f"dataset.root={root}", *extra])
    return Trainer(cfg, torch.device("cpu"), verbose=False)


def _state_tensors(trainer):
    st = trainer.state
    out = {f"{net}.{k}": v for net in ("G", "D", "G_ema")
           for k, v in getattr(st, net).state_dict().items()}
    for name, opt in (("opt_G", st.opt_G), ("opt_D", st.opt_D)):
        for i, s in opt.state_dict()["state"].items():
            out.update({f"{name}.{i}.{k}": v for k, v in s.items()})
    out["pl_ema"] = st.pl_ema
    return out


def test_chunks_equal_the_per_step_path_bit_for_bit(root):
    decay = ["solver.lr.alpha.decay.gamma=0.5", "solver.lr.alpha.decay.step_size=3"]
    per_step = _trainer(root, *decay)
    chunked = _trainer(root, *decay, "steps_per_call=4")
    assert chunked.chunks is not None and per_step.chunks is None
    it, it_chunked = per_step.device_iter(), chunked.device_iter()
    for i in (1, 2):
        per_step.step(i, next(it))
        chunked.step(i, next(it_chunked))
    ix_ps = per_step.loader.index_stream(2)
    ix = chunked.loader.index_stream(2)
    i, total, K = 2, 8, 4
    while i < total:
        k = min(K - i % K, total - i)
        rows = np.stack([chunked.device_cache.rows(*next(ix)) for _ in range(k)])
        for r in rows:
            np.testing.assert_array_equal(r, per_step.device_cache.rows(*next(ix_ps)))
        got = chunked.step_chunk(range(i + 1, i + k + 1), rows)
        for j in range(i + 1, i + k + 1):
            want = per_step.step(j, next(it))
        assert got.keys() == want.keys()
        for key in want:
            assert torch.equal(got[key], want[key]), key
        i += k
    assert chunked.state.step == per_step.state.step == total * 4
    a, b = _state_tensors(per_step), _state_tensors(chunked)
    assert a.keys() == b.keys()
    for key in a:
        assert torch.equal(a[key], b[key]), key
    # the staircase stepped inside the chunks: updates 3-5 at lr/2, 6-7 at lr/4
    assert chunked.state.opt_G.param_groups[0]["lr"] == LR / 4


def test_chunk_matches_jax_step_chunk(root, tmp_path, monkeypatch):
    # without DiffAugment, whose parity the one-step tests hold, the JAX
    # chunk compiles in about two thirds of the time
    over = TINY + [f"dataset.root={root}", "enable_amp=false", "steps_per_call=2",
                   "num_devices=1", "solver.augment=[]", "cache_dataset=false"]
    # both start from the port's initial state, Adam's zero moments written
    # out (the file says capturable off, so the port resumes per-step)
    init = Trainer(compose(CONFIG_DIR, over), torch.device("cpu"), verbose=False)
    make_capturable(init.state.opt_G)
    make_capturable(init.state.opt_D)
    path = save_checkpoint(str(tmp_path / "init.pth"), init.state, 0)
    port = Trainer(compose(CONFIG_DIR, over + [f"resume={path}"]), torch.device("cpu"),
                   verbose=False)
    # the JAX trainer replaces its initial state with the file's, so its
    # template needs shapes only (no compile of the initialisation)
    shapes_of = jax_trainer.create_train_state
    monkeypatch.setattr(jax_trainer, "create_train_state", lambda key, *a, **kw: jax.tree.map(
        lambda t: np.zeros(t.shape, t.dtype),
        jax.eval_shape(lambda k: shapes_of(k, *a, **kw), key)))
    jcfg = jax_compose(CONFIG_DIR, over + [f"resume={path}"])
    jtr = jax_trainer.Trainer(jcfg, verbose=False)

    ix = jtr.loader.index_stream(0)
    rows = np.stack([jtr.device_cache.global_indices(*next(ix)) for _ in range(2)])
    iters = np.array([1, 2], np.int32)
    draws = [jax_step_draws(jax.random.fold_in(jtr.root_key, int(i)), jtr.G,
                            jtr.state.params_G, 1, 4, False, False, in_ch=16,
                            shape=(32, 64), jit=True, policy=()) for i in iters]
    got = port.step_chunk(iters, rows, draws=draws)
    want = jtr.step_chunk(iters, rows)
    for k, v in got.items():
        np.testing.assert_allclose(float(v), float(want[k]), rtol=1e-5, atol=1e-6, err_msg=k)

    ref = te.reference_checkpoint_dict(jtr.state, jcfg)
    assert port.state.step == int(ref["step"]) == 8
    pairs = [(getattr(port.state, net).state_dict()[k], v)
             for net in ("G", "D", "G_ema") for k, v in ref[net].items()]
    for opt, name in ((port.state.opt_G, "optim_G"), (port.state.opt_D, "optim_D")):
        sd = opt.state_dict()["state"]
        for i, s in ref[name]["state"].items():
            assert int(sd[i]["step"]) == int(s["step"]) == 2
            pairs += [(sd[i][m], s[m]) for m in ("exp_avg", "exp_avg_sq")]
    for got_t, want_a in pairs:
        a, b = got_t.numpy(), np.asarray(want_a)
        if not np.issubdtype(b.dtype, np.floating):
            np.testing.assert_array_equal(a, b)
            continue
        diff = np.abs(a - b)
        if a.size >= 10_000:
            assert (diff > 1e-4 + 2e-3 * np.abs(b)).mean() < 1e-3
        assert diff.max() <= 2.2 * LR


def test_capturable_state_is_saved_in_the_per_step_form(root, tmp_path):
    """The capturable mode keeps Adam's count on the parameters' device and
    marks the group; the file says neither, so any mode resumes from it."""
    trainer = _trainer(root)
    make_capturable(trainer.state.opt_G)
    assert trainer.state.opt_G.param_groups[0]["capturable"]
    path = save_checkpoint(str(tmp_path / "c.pth"), trainer.state, 0)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    for name in ("optim_G", "optim_D"):
        assert all(not g["capturable"] for g in ckpt[name]["param_groups"])
        assert all(s["step"].dtype == torch.float32 and int(s["step"]) == 0
                   for s in ckpt[name]["state"].values())
    resumed = _trainer(root, f"resume={path}")
    assert not resumed.state.opt_G.param_groups[0]["capturable"]


def test_summarize_trace_reads_a_cpu_trace(tmp_path):
    # the input is made outside the trace: the two traced steps hold only
    # ops that each step runs (an op made once, such as a slow first
    # randn, could top the list with 1 // 2 = 0 calls a step)
    x = torch.randn(32, 32, requires_grad=True)
    prof = profiling.start_trace(torch.device("cpu"))
    for _ in range(2):
        (x @ x).relu().sum().backward()
    path = profiling.stop_trace(prof, str(tmp_path), "steps")
    assert osp.exists(path)
    summary = profiling.summarize_trace(str(tmp_path), steps=2)
    assert set(summary) == {"total_ms_per_step", "num_op_events", "by_category", "top_ops"}
    assert summary["total_ms_per_step"] > 0 and summary["num_op_events"] > 0
    assert [r["category"] for r in summary["by_category"]] == ["cpu_op"]
    assert summary["by_category"][0]["count"] > 0 and summary["top_ops"][0]["count"] > 0
    assert any("matmul" in r["op"] for r in summary["top_ops"])
    assert "-- top ops --" in profiling.format_summary(summary)
