"""dusty_gan_torch.cli.train on the CPU on a tiny synthetic tree: the run
writes its config, scalars (loss/D/*, score/*) and reference-format
checkpoints; a run resumed from a mid-run checkpoint ends bit-identical to
the uninterrupted run; the CLI refuses to run without a GPU unless
device=cpu.  Chunk mode
(``steps_per_call``): it raises the JAX CLI's errors without
``cache_device`` or when K does not divide a cadence; a chunk run logs
the per-step run's scalars at the same steps (iteration 1 apart, which
only the per-step loop logs) and ends on its checkpoint bit for bit; a
chunk run resumed off the K-grid realigns; the per-step CLI and the JAX
package resume from a chunk run's checkpoint.  ``profile_dir=`` writes a
trace and prints its summary.  Across frameworks: the JAX
package's ``train_state_from_torch`` loads the port's checkpoint and the
port resumes from ``save_reference_checkpoint``'s, weights and Adam
moments intact both ways.  The port's ``Loader`` yields the JAX
``Loader``'s batch stream bit for bit, flips and ``iter_from`` included."""

import json
import os
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dusty_gan_tpu.config import compose as jax_compose
from dusty_gan_tpu.data import native as jax_native
from dusty_gan_tpu.data.datasets import define_dataset as jax_define_dataset
from dusty_gan_tpu.data.loader import Loader as JaxLoader
from dusty_gan_tpu.models.factory import define_D as jax_define_D
from dusty_gan_tpu.models.factory import define_G as jax_define_G
from dusty_gan_tpu.train.state import create_train_state as jax_create_train_state
from dusty_gan_tpu.train.state import make_optimizer
from dusty_gan_tpu.utils import torch_export as te
from dusty_gan_tpu.utils.torch_import import train_state_from_torch

from dusty_gan_torch.cli.train import main
from dusty_gan_torch.config import compose
from dusty_gan_torch.data.datasets import define_dataset
from dusty_gan_torch.data.loader import Loader
from dusty_gan_torch.data.synthetic import build_synthetic_kitti
from dusty_gan_torch.train.trainer import Trainer, derived_seed

from torch_parity import one_torch_thread  # noqa: F401  (autouse)
from torch_parity import perturb

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
CONFIG_DIR = osp.join(REPO, "configs")
ARCH = "dusty2/dcgan_eqlr"
TINY = ["model=dusty2_dcgan_eqlr", "model.gen.in_ch=16", "model.gen.ch_base=8",
        "model.gen.ch_max=16", "model.dis.ch_base=8", "model.dis.ch_max=16",
        "solver.batch_size=4"]
CADENCE = ["solver.checkpoint.save_stats=2", "solver.checkpoint.test=4",
           "solver.checkpoint.save_model=3", "validate_samples=6"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return build_synthetic_kitti(str(tmp_path_factory.mktemp("train") / "data"),
                                 n_scans_per_seq=10, w0=512, sequences=(0, 8))


def _run(root, run_dir, *extra):
    return main([*TINY, f"dataset.root={root}", f"run_dir={run_dir}", *CADENCE,
                 "device=cpu", *extra])


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


@pytest.fixture(scope="module")
def runs(root, tmp_path_factory):
    """An uninterrupted 6-iteration run and one resumed from its iteration-3
    checkpoint."""
    base = tmp_path_factory.mktemp("runs")
    full = _run(root, str(base / "full"), "total_iterations=6")
    mid = osp.join(full, "models", "checkpoint_0000000012.pth")
    resumed = _run(root, str(base / "resumed"), "total_iterations=6", f"resume={mid}")
    return {"full": full, "resumed": resumed, "mid": mid}


def test_run_writes_config_scalars_and_checkpoints(runs):
    full = runs["full"]
    with open(osp.join(full, ".hydra", "config.yaml")) as f:
        cfg = yaml.safe_load(f)
    assert cfg["model"]["gen"]["arch"] == ARCH and cfg["solver"]["batch_size"] == 4
    with open(osp.join(full, "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    keys = {k for r in rows for k in r if k not in ("t", "step")}
    assert {"loss/D/adversarial", "loss/D/gradient_penalty", "loss/D/output/real",
            "loss/D/output/fake", "loss/G/adversarial", "perf/scans_per_sec"} <= keys
    assert {"score/mmd-cd", "score/cov-cd", "score/1-nn-accuracy-cd", "score/jsd",
            "score/swd-mean", "score/drop_rate/fake", "score/drop_rate/real",
            "score/drop_row_l1"} <= keys
    assert all(np.isfinite(v) for r in rows for k, v in r.items() if k != "t")
    ckpt = _load(osp.join(full, "models", "checkpoint_0000000024.pth"))
    assert set(ckpt) == {"step", "G", "D", "G_ema", "optim_G", "optim_D", "pl_ema", "seed"}
    assert ckpt["step"] == 24 and ckpt["seed"] == 0
    assert "0.blur_v.kernel" in ckpt["D"] and "drop_const" in ckpt["G"]


def test_resume_is_bit_identical(runs):
    a = _load(osp.join(runs["full"], "models", "checkpoint_0000000024.pth"))
    b = _load(osp.join(runs["resumed"], "models", "checkpoint_0000000024.pth"))
    for net in ("G", "D", "G_ema"):
        for k, v in a[net].items():
            assert torch.equal(v, b[net][k]), (net, k)
    for opt in ("optim_G", "optim_D"):
        for i, s in a[opt]["state"].items():
            for k in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(s[k], b[opt]["state"][i][k]), (opt, i, k)
    assert torch.equal(a["pl_ema"], b["pl_ema"])


def test_resume_takes_the_checkpoints_seed(root, runs, tmp_path):
    """A checkpoint's seed, not the config's, rules the resumed run's draws
    and its loader's shuffles and flips."""
    ckpt = _load(runs["mid"])
    ckpt["seed"] = 7
    path = str(tmp_path / "seed7.pth")
    torch.save(ckpt, path)
    cfg = compose(CONFIG_DIR, TINY + [f"dataset.root={root}", f"resume={path}", "seed=0"])
    trainer = Trainer(cfg, torch.device("cpu"), verbose=False)
    assert trainer.seed == trainer.loader.seed == 7 and trainer.start_iteration == 3


def test_iteration_seeds_differ_in_the_low_word():
    seeds = {derived_seed(s, stream, i) & 0xFFFFFFFF
             for s in (0, 1) for stream in (0, 1) for i in range(1000)}
    assert len(seeds) == 4000


def test_refuses_cpu_fallback_without_gpu(root, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="GPU"):
        main([*TINY, f"dataset.root={root}", f"run_dir={tmp_path}", "total_iterations=1"])


def _jax_template(root):
    jcfg = jax_compose(CONFIG_DIR, TINY + [f"dataset.root={root}"])
    for m in ("gen", "dis"):
        jcfg.model[m].shape = list(jcfg.dataset.shape)
    G, D = jax_define_G(jcfg), jax_define_D(jcfg)
    opt_g, opt_d = make_optimizer(2e-3, 0.0, 0.99), make_optimizer(2e-3, 0.0, 0.99)
    tmpl = jax_create_train_state(jax.random.PRNGKey(0), G, D, in_ch=16,
                                  image_shape=tuple(jcfg.dataset.shape), optimizer_g=opt_g,
                                  optimizer_d=opt_d, needs_gumbel=True)
    return jcfg, tmpl, opt_g, opt_d


def _sd(tree_sd):
    return {k: np.asarray(v) for k, v in tree_sd.items()}


def test_jax_loads_the_ports_checkpoint(root, runs):
    """train_state_from_torch on the port's final checkpoint: weights,
    moments, count, pl_ema and step arrive unchanged."""
    hold_jax_import(root, osp.join(runs["full"], "models", "checkpoint_0000000024.pth"))


def hold_jax_import(root, path):
    ckpt = _load(path)
    _, tmpl, opt_g, opt_d = _jax_template(root)
    state = train_state_from_torch(path, ARCH, tmpl, opt_g, opt_d)
    assert int(state.step) == 24
    for net, tree in (("G", state.params_G), ("G_ema", state.params_G_ema)):
        got = _sd(te.generator_state_dict(tree, ARCH))
        for k, v in ckpt[net].items():
            np.testing.assert_array_equal(got[k], v.numpy(), err_msg=(net, k))
    got = _sd(te.discriminator_state_dict(state.params_D))
    for k, v in ckpt["D"].items():
        np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)
    for opt, jopt, net in (("optim_G", state.opt_G, "G"), ("optim_D", state.opt_D, "D")):
        want = te.adam_state_dict(
            jopt, {k: v.numpy() for k, v in ckpt[net].items()},
            (lambda t: te.generator_state_dict(t, ARCH)) if net == "G"
            else te.discriminator_state_dict, lr=2e-3, beta1=0.0, beta2=0.99)
        for i, s in ckpt[opt]["state"].items():
            assert want["state"][i]["step"] == int(s["step"]) == 6
            np.testing.assert_array_equal(want["state"][i]["exp_avg"], s["exp_avg"].numpy())
            np.testing.assert_array_equal(want["state"][i]["exp_avg_sq"],
                                          s["exp_avg_sq"].numpy())
    assert float(state.pl_ema) == float(ckpt["pl_ema"])


def test_port_resumes_from_a_jax_export(root, tmp_path):
    """save_reference_checkpoint of a JAX state with random weights and
    moments -> the port's Trainer(resume=...) holds the same numbers, and
    trains on from it."""
    jcfg, tmpl, _, _ = _jax_template(root)
    rng = np.random.RandomState(0)
    rand = lambda t: jax.tree.map(  # noqa: E731
        lambda p: jnp.asarray(rng.rand(*p.shape), p.dtype), t)

    def with_moments(opt_state):
        return tuple(el._replace(count=jnp.asarray(3, el.count.dtype), mu=rand(el.mu),
                                 nu=rand(el.nu)) if hasattr(el, "mu") else el
                     for el in opt_state)

    state = tmpl.replace(step=jnp.asarray(12, tmpl.step.dtype),
                         params_G=perturb(tmpl.params_G, 1), params_D=perturb(tmpl.params_D, 2),
                         params_G_ema=perturb(tmpl.params_G, 3),
                         opt_G=with_moments(tmpl.opt_G), opt_D=with_moments(tmpl.opt_D))
    path = str(tmp_path / "jax.pth")
    te.save_reference_checkpoint(path, state, jcfg)

    cfg = compose(CONFIG_DIR, TINY + [f"dataset.root={root}", f"resume={path}"])
    trainer = Trainer(cfg, torch.device("cpu"), verbose=False)
    ts = trainer.state
    assert trainer.start_iteration == 3 and ts.step == 12
    want = te.reference_checkpoint_dict(state, jcfg)
    for net, module in (("G", ts.G), ("D", ts.D), ("G_ema", ts.G_ema)):
        for k, v in module.state_dict().items():
            np.testing.assert_array_equal(v.numpy(), want[net][k], err_msg=(net, k))
    for opt, net in ((ts.opt_G, "optim_G"), (ts.opt_D, "optim_D")):
        sd = opt.state_dict()
        for i, s in want[net]["state"].items():
            assert int(sd["state"][i]["step"]) == 3
            np.testing.assert_array_equal(sd["state"][i]["exp_avg"].numpy(), s["exp_avg"])
            np.testing.assert_array_equal(sd["state"][i]["exp_avg_sq"].numpy(),
                                          s["exp_avg_sq"])
    scalars = trainer.step(4, next(trainer.loader.iter_from(3)))
    assert all(np.isfinite(float(v)) for v in scalars.values()) and ts.step == 16


@pytest.mark.parametrize("flip", [False, True])
def test_loader_stream_equals_jax(root, flip):
    """Shuffled epochs, per-item flips and iter_from(k), across an epoch
    boundary (10 scans, batch 3: 3 batches an epoch).  Both datasets run
    their native C++ path, the same source, bit for bit."""
    assert jax_native.available()
    over = [f"dataset.root={root}", f"dataset.flip={str(flip).lower()}"]
    jds = jax_define_dataset(jax_compose(CONFIG_DIR, over).dataset, phase="train")
    ds = define_dataset(compose(CONFIG_DIR, over).dataset, phase="train")
    assert ds.flip == jds.flip == flip
    for start in (0, 2):
        kw = dict(shuffle=True, drop_last=True, seed=5, keys=("depth", "mask"))
        want = JaxLoader(jds, 3, **kw).iter_from(start)
        got = Loader(ds, 3, **kw).iter_from(start)
        for _ in range(5):
            a, b = next(want), next(got)
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(b[k], a[k])
        want.close()
        got.close()
    if flip:  # the flip draws are live: some item differs from its unflipped read
        plain = define_dataset(compose(CONFIG_DIR, over[:1]).dataset, phase="train")
        batch = next(Loader(ds, 10, shuffle=True, seed=5).epoch(0))
        order = np.random.RandomState(5).permutation(10)
        assert any(not np.array_equal(batch["depth"][j], plain[int(i)]["depth"])
                   for j, i in enumerate(order))


# ---------------------------------------------------------------------------
# chunk mode (steps_per_call) and profile_dir=
# ---------------------------------------------------------------------------

def _rows(run_dir):
    """scalars.jsonl as {image step: {tag: value}}."""
    out = {}
    with open(osp.join(run_dir, "scalars.jsonl")) as f:
        for line in f:
            row = json.loads(line)
            row.pop("t")
            out.setdefault(row.pop("step"), {}).update(row)
    return out


def _assert_same_checkpoint(a_path, b_path):
    a, b = _load(a_path), _load(b_path)
    assert a["step"] == b["step"]
    for net in ("G", "D", "G_ema"):
        for k, v in a[net].items():
            assert torch.equal(v, b[net][k]), (net, k)
    for opt in ("optim_G", "optim_D"):
        assert a[opt]["param_groups"] == b[opt]["param_groups"]
        for i, st in a[opt]["state"].items():
            for k in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(st[k], b[opt]["state"][i][k]), (opt, i, k)
    assert torch.equal(a["pl_ema"], b["pl_ema"])


CHUNK = ["cache_device=true", "steps_per_call=2", "solver.checkpoint.save_model=2"]
NO_VALIDATION = "solver.checkpoint.test=100"


@pytest.fixture(scope="module")
def chunk_runs(root, runs, tmp_path_factory):
    """A 6-iteration chunk run (K=2) beside ``runs``' per-step run; a chunk
    run resumed from the per-step run's iteration-3 checkpoint (off the
    K-grid); a per-step run resumed from the chunk run's iteration 2."""
    base = tmp_path_factory.mktemp("chunk_runs")
    chunk = _run(root, str(base / "chunk"), "total_iterations=6", *CHUNK)
    off_grid = _run(root, str(base / "off_grid"), "total_iterations=6", *CHUNK,
                    NO_VALIDATION, f"resume={runs['mid']}")
    per_step = _run(root, str(base / "per_step"), "total_iterations=6", NO_VALIDATION,
                    f"resume={osp.join(chunk, 'models', 'checkpoint_0000000008.pth')}")
    return {"chunk": chunk, "off_grid": off_grid, "per_step": per_step}


@pytest.mark.parametrize("extra, message", [
    (["steps_per_call=2"], "steps_per_call needs cache_device=true"),
    (["steps_per_call=4", "cache_device=true"],
     r"steps_per_call=4 must divide solver.checkpoint.save_stats=2"),
], ids=["without_cache_device", "cadence_not_divided"])
def test_chunk_mode_raises_the_jax_errors(root, tmp_path, extra, message):
    with pytest.raises(ValueError, match=message):
        _run(root, str(tmp_path), "total_iterations=4", "solver.checkpoint.save_model=4",
             *extra)


def test_chunk_run_logs_and_saves_as_the_per_step_run(runs, chunk_runs):
    full, chunk = _rows(runs["full"]), _rows(chunk_runs["chunk"])
    assert set(chunk) == set(full) - {4}  # iteration 1: the per-step loop's log
    for step, row in chunk.items():
        assert set(row) == set(full[step]), step
        for k, v in row.items():
            if k.startswith("loss/") or k.startswith("score/"):
                assert v == full[step][k], (step, k)
    models = osp.join(chunk_runs["chunk"], "models")
    assert sorted(os.listdir(models)) == [f"checkpoint_{4 * i:010d}.pth" for i in (2, 4, 6)]
    final = "checkpoint_0000000024.pth"
    _assert_same_checkpoint(osp.join(runs["full"], "models", final), osp.join(models, final))


def test_chunk_resume_off_the_grid_realigns(runs, chunk_runs):
    """From iteration 3 with K=2: a chunk of 1, then chunks ending on the
    grid (logs and checkpoints at iterations 4 and 6)."""
    rows = _rows(chunk_runs["off_grid"])
    assert sorted(rows) == [16, 24] and all("loss/G/adversarial" in r for r in rows.values())
    models = osp.join(chunk_runs["off_grid"], "models")
    assert sorted(os.listdir(models)) == ["checkpoint_0000000016.pth",
                                          "checkpoint_0000000024.pth"]
    final = "checkpoint_0000000024.pth"
    _assert_same_checkpoint(osp.join(runs["full"], "models", final), osp.join(models, final))


def test_per_step_and_jax_resume_from_a_chunk_checkpoint(root, runs, chunk_runs):
    final = "checkpoint_0000000024.pth"
    _assert_same_checkpoint(osp.join(runs["full"], "models", final),
                            osp.join(chunk_runs["per_step"], "models", final))
    hold_jax_import(root, osp.join(chunk_runs["chunk"], "models", final))


def test_profile_dir_writes_a_trace_and_prints_its_summary(root, tmp_path, capsys):
    prof = tmp_path / "prof"
    _run(root, str(tmp_path / "run"), "total_iterations=8", NO_VALIDATION,
         f"profile_dir={prof}")
    out = capsys.readouterr().out
    traces = os.listdir(prof)
    assert traces == ["train_4-8.pt.trace.json"]
    assert f"profile trace written to {prof / traces[0]}" in out
    assert "op time:" in out and "-- top ops --" in out
    assert "aten::" in out.split("-- top ops --")[1]
