"""The port reads the JAX package's native ``.ckpt`` without JAX
(``dusty_gan_torch/utils/jax_checkpoint.py``).  The JAX package writes a
``.ckpt`` of a train state after two real optax updates (non-zero
moments): DUSty-II, DUSty-II with ``lr`` decay and a path-length weight
(a schedule count beside Adam's, ``pl_ema`` kept), and DUSty-I.  Then:

* the port's ``cli/export_pth`` writes the JAX package's own export
  (``save_reference_checkpoint``) of that state, tensor for tensor and bit
  for bit, with equal ints and ``param_groups``;
* ``setup`` on the ``.ckpt`` gives the same G_ema, outputs bit-equal, as
  ``setup`` on that ``.pth``;
* ``resume=<.ckpt>`` and ``resume=<JAX .pth>`` give bit-equal states after
  one port step;
* the msgpack decoder equals ``msgpack.unpackb`` on an object that uses
  every tag it reads, and ``flax.serialization.msgpack_restore`` on flax's
  ext types; a chunked leaf and a tree without Adam raise.

Weights are initialised in the port and carried into JAX trees by the JAX
package's importer (no JAX init to compile op by op)."""

import os.path as osp

import flax.serialization
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import optax
import pytest
import torch

from dusty_gan_tpu.config import load_config as jax_load_config
from dusty_gan_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from dusty_gan_tpu.train.state import TrainState as JaxTrainState
from dusty_gan_tpu.train.state import make_optimizer
from dusty_gan_tpu.utils import torch_export as te
from dusty_gan_tpu.utils import torch_import as ti

from dusty_gan_torch.cli.export_pth import main as export_pth
from dusty_gan_torch.config import compose, load_config, save_config
from dusty_gan_torch.data.synthetic import build_synthetic_kitti
from dusty_gan_torch.models.factory import define_D, define_G
from dusty_gan_torch.train.trainer import Trainer
from dusty_gan_torch.utils import jax_checkpoint as jc
from dusty_gan_torch.utils.setup import make_eval_generator, setup

from torch_parity import one_torch_thread  # noqa: F401  (autouse)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
CONFIG_DIR = osp.join(REPO, "configs")
TINY = ["model.gen.in_ch=16", "model.gen.ch_base=8", "model.gen.ch_max=16",
        "model.dis.ch_base=8", "model.dis.ch_max=16", "solver.batch_size=4"]
CASES = {
    "dusty2": ("dusty2_dcgan_eqlr", []),
    "dusty2_decay_pl": ("dusty2_dcgan_eqlr", ["solver.lr.alpha.decay.gamma=0.5",
                                              "solver.lr.alpha.decay.step_size=1",
                                              "solver.loss.pl=2"]),
    "dusty1": ("dusty1_dcgan_eqlr", []),
}
STEP = 64  # images seen: iteration 16 at batch 4


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return build_synthetic_kitti(str(tmp_path_factory.mktemp("ckpt") / "data"),
                                 n_scans_per_seq=4, w0=512, sequences=(0, 8))


def _updated(params, opt, rng):
    """``params`` and ``opt``'s state after two updates with random
    gradients."""
    update, apply = jax.jit(opt.update), jax.jit(optax.apply_updates)
    state = opt.init(params)
    for _ in range(2):
        grads = jax.tree.map(lambda p: (0.01 * rng.randn(*p.shape)).astype(np.float32), params)
        updates, state = update(grads, state, params)
        params = apply(params, updates)
    return params, state


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request, root, tmp_path_factory):
    """A JAX ``.ckpt``, the JAX package's ``.pth`` export of it and the port's
    ``cli/export_pth`` output, with the run's config."""
    model, extra = CASES[request.param]
    base = tmp_path_factory.mktemp(request.param)
    cfg = compose(CONFIG_DIR, [f"model={model}", *TINY, f"dataset.root={root}", *extra])
    cfg_path = save_config(cfg, str(base / "run"))
    jcfg = jax_load_config(cfg_path)
    arch = str(cfg.model.gen.arch)
    cfg.model.gen.shape = cfg.model.dis.shape = list(cfg.dataset.shape)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(sorted(CASES).index(request.param))
        G, D = define_G(cfg), define_D(cfg)
    rng = np.random.RandomState(0)
    lr = cfg.solver.lr
    opt = lambda alpha: make_optimizer(  # noqa: E731
        float(alpha), float(lr.beta1), float(lr.beta2),
        decay_gamma=float(lr.alpha.decay.gamma), decay_step_size=int(lr.alpha.decay.step_size))
    pG0 = ti.generator_params_from_torch(G.state_dict(), arch)
    pG, oG = _updated(pG0, opt(lr.alpha.gen), rng)
    pD, oD = _updated(ti.discriminator_params_from_torch(D.state_dict()), opt(lr.alpha.dis), rng)
    ema = jax.tree.map(lambda a, b: (0.9 * np.asarray(a) + 0.1 * np.asarray(b))
                       .astype(np.float32), pG0, pG)
    state = JaxTrainState(step=jnp.asarray(STEP, jnp.int32), params_G=pG, params_D=pD,
                          params_G_ema=ema, opt_G=oG, opt_D=oD,
                          pl_ema=jnp.asarray(0.37, jnp.float32))
    ckpt = str(base / f"checkpoint_{STEP:010d}.ckpt")
    jax_save_checkpoint(ckpt, state, key=jax.random.PRNGKey(5))
    jax_pth = str(base / "jax.pth")
    te.save_reference_checkpoint(jax_pth, state, jcfg)
    port_pth = export_pth(["--model-path", ckpt, "--config-path", cfg_path,
                           "--output", str(base / "out" / "port.pth")])
    return {"name": request.param, "cfg_path": cfg_path, "ckpt": ckpt, "jax_pth": jax_pth,
            "port_pth": port_pth, "root": root, "extra": [f"model={model}", *extra]}


def _assert_same(got, want, where="ckpt"):
    """Equal types, keys in the same order, ints and floats, and tensors of
    one dtype and shape with equal bytes."""
    assert type(got) is type(want), (where, type(got), type(want))
    if isinstance(want, dict):
        assert list(got) == list(want), where
        for k in want:
            _assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, torch.Tensor):
        assert (got.dtype, got.shape) == (want.dtype, want.shape), where
        assert got.numpy().tobytes() == want.numpy().tobytes(), where
    else:
        assert got == want, (where, got, want)


def test_export_pth_equals_the_jax_export(case):
    load = lambda p: torch.load(p, map_location="cpu", weights_only=True)  # noqa: E731
    got, want = load(case["port_pth"]), load(case["jax_pth"])
    _assert_same(got, want)
    assert got["step"] == STEP
    assert (got["pl_ema"] is None) == (case["name"] != "dusty2_decay_pl")
    assert got["optim_G"]["state"][0]["step"] == 2
    assert float(got["optim_G"]["state"][0]["exp_avg"].abs().max()) > 0


def test_setup_reads_the_ckpt(case):
    """G_ema from the .ckpt equals G_ema from the JAX package's .pth: state
    dict and outputs, bit for bit."""
    dev = torch.device("cpu")
    _, Gc, _, noise = setup(case["ckpt"], case["cfg_path"], dev)
    _, Gp, _, _ = setup(case["jax_pth"], case["cfg_path"], dev)
    _assert_same(Gc.state_dict(), Gp.state_dict())
    z = torch.from_numpy(np.random.RandomState(1).randn(3, 16).astype(np.float32))
    a = make_eval_generator(Gc, noise, None)(z)
    b = make_eval_generator(Gp, noise, None)(z)
    assert all(torch.equal(a[k], b[k]) for k in b)


def test_resume_from_the_ckpt(case):
    """``resume=<.ckpt>`` and ``resume=<JAX .pth>``: the same state, and
    after one port step bit-equal weights, moments and scalars."""
    trainers = [Trainer(compose(CONFIG_DIR, [*case["extra"], *TINY, f"dataset.root={case['root']}",
                                             f"resume={path}"]), torch.device("cpu"),
                        verbose=False)
                for path in (case["ckpt"], case["jax_pth"])]
    scalars = []
    for t in trainers:
        assert t.start_iteration == STEP // 4 and t.state.step == STEP
        scalars.append(t.step(t.start_iteration + 1, next(t.device_iter())))
    a, b = (t.state for t in trainers)
    for name in ("G", "D", "G_ema", "opt_G", "opt_D"):
        _assert_same(getattr(a, name).state_dict(), getattr(b, name).state_dict(), name)
    assert torch.equal(a.pl_ema, b.pl_ema) and a.step == b.step == STEP + 4
    assert all(torch.equal(scalars[0][k], scalars[1][k]) for k in scalars[1])


def test_export_pth_refuses_a_pth(case, tmp_path):
    with pytest.raises(SystemExit, match=".ckpt"):
        export_pth(["--model-path", case["jax_pth"], "--config-path", case["cfg_path"],
                    "--output", str(tmp_path / "x.pth")])


def _raw(code, data):
    return code, bytes(data)


def test_decoder_equals_msgpack_on_every_tag():
    """fixint, negative fixint, int/uint 8-64, float32/64, nil, bool,
    fixstr and str 8/16/32, bin 8/16/32, fixarray and array 16/32, fixmap and
    map 16/32, fixext 1/2/4/8/16 and ext 8/16/32."""
    obj = {
        "fixint": [0, 5, 127], "negative_fixint": [-1, -32],
        "int": [-100, -30000, -2_000_000_000, -2**62],
        "uint": [200, 60000, 4_000_000_000, 2**63 + 5],
        "float64": [1.5e300, -0.0], "nil": None, "bool": [True, False],
        "str": ["", "abc", "x" * 40, "y" * 300, "z" * 70000, "Ümlaut"],
        "bin": [b"\x01" * 10, b"\x02" * 300, b"\x03" * 70000],
        "array": [[1, 2], list(range(20)), [0] * 70000],
        "map": [{str(i): i for i in range(20)}, {str(i): i for i in range(70000)}],
        "ext": [msgpack.ExtType(5, b"a" * n) for n in (1, 2, 4, 8, 16, 3, 300, 70000)],
    }
    packed = msgpack.packb(obj, use_bin_type=True)
    want = msgpack.unpackb(packed, raw=False, ext_hook=_raw, strict_map_key=False)
    assert jc.unpackb(packed, ext_hook=_raw) == want
    single = msgpack.packb([1.25, -3.5e-8], use_single_float=True)
    assert single[1] == 0xca and jc.unpackb(single) == msgpack.unpackb(single)


def test_decoder_equals_flax_on_its_ext_types():
    tree = {
        "f32": np.arange(12, dtype=np.float32).reshape(3, 4), "f64": np.float64([1.5, -2]),
        "i32": np.int32([[-7]]), "u32": np.uint32([0, 2**32 - 1]), "bool": np.array([True]),
        "scalar0d": np.float32(2.5) * np.ones((), np.float32), "empty": np.zeros((0, 3)),
        "bf16": jnp.asarray([1.5, -0.15625, 3e38], jnp.bfloat16),
        "npscalar": np.int64(-9), "complex": complex(1.0, -2.0),
        "nested": {"0": {"count": np.int32(3)}, "1": {}}, "none": None,
    }
    blob = flax.serialization.msgpack_serialize(tree)
    want = flax.serialization.msgpack_restore(blob)
    got = jc.unpackb(blob)
    assert list(got) == list(want)
    for k in want:
        if k == "bf16":
            np.testing.assert_array_equal(got[k], np.asarray(want[k], np.float32))
        elif isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].flags.writeable
        else:
            assert got[k] == want[k] and type(got[k]) is type(want[k]), k


@pytest.mark.parametrize("bad, match", [
    ({"a": {"__msgpack_chunked_array__": True, "shape": {}, "chunks": {}}},
     "__msgpack_chunked_array__"),
    (msgpack.ExtType(9, b""), "ext type 9"),
])
def test_decoder_refuses(bad, match):
    with pytest.raises(ValueError, match=match):
        jc.unpackb(msgpack.packb(bad))
    with pytest.raises(ValueError, match="ends inside"):
        jc.unpackb(msgpack.packb([1, 2, 3])[:-1])


def test_a_tree_without_adam_raises(case):
    payload = jc.read_jax_checkpoint(case["ckpt"])
    payload["state"]["opt_D"] = {"0": {}, "1": {"count": np.int32(2)}}
    with pytest.raises(ValueError, match="opt_D has no Adam state"):
        jc.reference_checkpoint_from_jax(payload, load_config(case["cfg_path"]))
