"""Export and serving in the port (``dusty_gan_torch/utils/export.py``,
``cli/export.py``, ``cli/serve.py``) on the CPU at a tiny width.

* ``ServingGenerator`` against the JAX package's ``make_serving_fn`` in
  float32, for DUSty-II, DUSty-I and the baseline (a mask of ones): the
  same weights (the port's, carried into JAX by the JAX package's
  importer) and JAX's fixed Gumbel field passed in.  Depth and points
  within rtol 1e-5 / atol 1e-5 (float32 convolutions in two frameworks,
  then a division and trigonometric functions), the mask equal.
* The saved and reloaded ``torch.export`` artifact equals the eager
  generator bit for bit at batches 1, 3 and 5 (dynamic batch); a
  calibrated threshold is baked into the program; a fixed-batch artifact
  refuses other sizes; the manifest's hash guards the artifact, and a GPU
  artifact does not load without a GPU.
* The server: ``/healthz``, an npz round trip, client latents in JSON, 400s
  for bad requests, a fixed batch padded and trimmed, and seeded latents
  equal to the JAX server's.
* ``cli/export`` end to end on ``--device cpu``: its manifest has the JAX
  CLI's keys with ``torch_version`` for ``jax_version`` and ``device`` for
  ``platforms``."""

import io
import json
import os.path as osp
import shutil
import threading
import types
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dusty_gan_tpu.utils.export as jax_export
import dusty_gan_tpu.utils.setup as jax_setup
from dusty_gan_tpu.cli.export import main as jax_export_main
from dusty_gan_tpu.cli.serve import _GeneratorService as JaxService
from dusty_gan_tpu.config import load_config as jax_load_config
from dusty_gan_tpu.geometry.lidar import Lidar as JaxLidar
from dusty_gan_tpu.models.factory import define_G as jax_define_G
from dusty_gan_tpu.utils.torch_import import generator_params_from_torch

from dusty_gan_torch.cli.export import main as export_main
from dusty_gan_torch.cli.serve import make_server
from dusty_gan_torch.config import compose, save_config
from dusty_gan_torch.data.synthetic import build_synthetic_kitti
from dusty_gan_torch.geometry.lidar import Lidar
from dusty_gan_torch.models.factory import define_G
from dusty_gan_torch.utils.export import (ServingGenerator, export_generator, load_exported,
                                          save_exported)

from torch_parity import one_torch_thread  # noqa: F401  (autouse)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
CONFIG_DIR = osp.join(REPO, "configs")
IN_CH = 16
TINY = [f"model.gen.in_ch={IN_CH}", "model.gen.ch_base=8", "model.gen.ch_max=16",
        "model.dis.ch_base=8", "model.dis.ch_max=16"]
MODELS = {"dusty2": "dusty2_dcgan_eqlr", "dusty1": "dusty1_dcgan_eqlr",
          "baseline": "dcgan_eqlr"}
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return build_synthetic_kitti(str(tmp_path_factory.mktemp("serve") / "data"),
                                 n_scans_per_seq=2, w0=512, sequences=(0,))


def _generator(model: str, root: str, base):
    """(port cfg, its config file, the port's generator with random weights
    and biases)."""
    cfg = compose(CONFIG_DIR, [f"model={model}", *TINY, f"dataset.root={root}"])
    path = save_config(cfg, str(base / model))
    cfg.model.gen.shape = list(cfg.dataset.shape)
    with torch.random.fork_rng(devices=[]), torch.no_grad():
        torch.manual_seed(3)
        G = define_G(cfg)
        for p in G.parameters():
            p.add_(0.1 * torch.randn(p.shape))
    return cfg, path, G.eval().requires_grad_(False)


def _angles(shape):
    h, w = shape
    return np.stack([np.tile(np.linspace(0.1, -0.3, h)[:, None], (1, w)),
                     np.tile(np.linspace(-np.pi, np.pi, w)[None, :], (h, 1))]).astype(np.float32)


def _nchw(noise):
    if noise is None:
        return None
    if isinstance(noise, dict):
        return {k: _nchw(v) for k, v in noise.items()}
    return torch.from_numpy(np.array(np.transpose(np.asarray(noise), (0, 3, 1, 2))))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_serving_generator_equals_jax(name, root, tmp_path):
    cfg, path, G = _generator(MODELS[name], root, tmp_path)
    jcfg = jax_load_config(path)
    jcfg.model.gen.shape = list(jcfg.dataset.shape)
    Gj = jax_define_G(jcfg)
    params = generator_params_from_torch(G.state_dict(), str(cfg.model.gen.arch))
    shape = tuple(cfg.dataset.shape)
    noise = jax_setup.make_fixed_noise(Gj, shape)
    tol = 0.02  # drops the pixels at the far end of the range too
    fn = jax.jit(jax_export.make_serving_fn(
        Gj, params, noise, JaxLidar.from_angle_array(_angles(shape), shape, 0.9, 120.0),
        compute_dtype=jnp.float32, tol=tol, with_points=True, mask_threshold=0.5))
    port = ServingGenerator(G, _nchw(noise), Lidar.from_angle_array(_angles(shape), shape,
                                                                  0.9, 120.0),
                            compute_dtype=torch.float32, tol=tol)
    z = np.random.RandomState(0).randn(3, IN_CH).astype(np.float32)
    want = {k: np.asarray(v) for k, v in fn(z).items()}
    with torch.inference_mode():
        got = {k: v.numpy() for k, v in port(torch.from_numpy(z)).items()}
    assert set(got) == set(want) == {"depth", "mask", "points"}
    np.testing.assert_array_equal(got["mask"], want["mask"])
    assert (name == "baseline") == bool((got["mask"] == 1).all())
    np.testing.assert_allclose(got["depth"], want["depth"], **TOL)
    np.testing.assert_allclose(got["points"], want["points"], **TOL)


@pytest.fixture(scope="module")
def exported(root, tmp_path_factory):
    """The DUSty-II generator, its lidar and noise; a dynamic-batch float32
    artifact and a batch-3 one with the threshold 0.3 baked in."""
    base = tmp_path_factory.mktemp("exported")
    cfg, path, G = _generator(MODELS["dusty2"], root, base)
    shape = tuple(cfg.dataset.shape)
    lidar = Lidar.from_angle_array(_angles(shape), shape, 0.9, 120.0)
    g = torch.Generator().manual_seed(0)
    noise = {"pixel": torch.randn((1, 1, *shape), generator=g),
             "image": torch.randn((1, 1, 1, 1), generator=g)}
    out = {"G": G, "lidar": lidar, "noise": noise, "cfg_path": path, "base": base}
    for name, batch, threshold in (("dynamic", None, 0.5), ("fixed", 3, 0.3)):
        program = export_generator(G, noise, lidar, in_ch=IN_CH, compute_dtype=torch.float32,
                                   batch_size=batch, mask_threshold=threshold)
        out[name] = str(base / name)
        save_exported(program, out[name], {"in_ch": IN_CH, "batch": batch or "dynamic",
                                           "device": "cpu", "arch": "dusty2/dcgan_eqlr"})
    return out


def _eager(ex, threshold=0.5):
    return ServingGenerator(ex["G"], ex["noise"], ex["lidar"], compute_dtype=torch.float32,
                            mask_threshold=threshold)


def _latents(b, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randn(b, IN_CH).astype(np.float32))


def test_reloaded_artifact_equals_eager(exported):
    call, manifest = load_exported(exported["dynamic"])
    assert manifest["batch"] == "dynamic" and manifest["torch_version"] == torch.__version__
    eager = _eager(exported)
    with torch.inference_mode():
        for b in (1, 3, 5):
            got, want = call(_latents(b, b)), eager(_latents(b, b))
            assert set(got) == set(want)
            assert all(torch.equal(got[k], want[k]) for k in want), b


def test_threshold_is_baked_in_and_fixed_batch_refuses_other_sizes(exported):
    call, manifest = load_exported(exported["fixed"])
    assert manifest["batch"] == 3
    z = _latents(3, 7)
    with torch.inference_mode():
        got = call(z)
        want = _eager(exported, 0.3)(z)
        assert all(torch.equal(got[k], want[k]) for k in want)
        assert not torch.equal(got["mask"], _eager(exported, 0.5)(z)["mask"])
        with pytest.raises(AssertionError, match="Guard failed"):
            call(_latents(2))


def test_manifest_guards_the_artifact(exported, tmp_path, monkeypatch):
    d = str(tmp_path / "copy")
    shutil.copytree(exported["dynamic"], d)
    with open(osp.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    with open(osp.join(d, "manifest.json"), "w") as f:
        json.dump({**manifest, "device": "cuda"}, f)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="exported on cuda"):
        load_exported(d)
    with open(osp.join(d, "generator.pt2"), "ab") as f:
        f.write(b"\0")
    with pytest.raises(ValueError, match="hash mismatch"):
        load_exported(d)


def _post(url, body, query=""):
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(url + "/generate" + query, data=data, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.fixture(scope="module")
def servers(exported):
    out = {}
    for name in ("dynamic", "fixed"):
        server, service = make_server(exported[name], port=0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        out[name] = (f"http://127.0.0.1:{server.server_address[1]}", service)
        out.setdefault("_stop", []).append((server, thread))
    yield out
    for server, thread in out["_stop"]:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        assert not thread.is_alive()


def test_server_answers(servers, exported):
    url, service = servers["dynamic"]
    with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
        health = json.loads(r.read())
    assert health == {"ok": True, "manifest": service.manifest}
    eager = _eager(exported)
    status, body = _post(url, {"batch": 2, "seed": 4})
    assert status == 200
    with np.load(io.BytesIO(body)) as npz:
        got = {k: npz[k] for k in npz.files}
    with torch.inference_mode():
        want = eager(torch.from_numpy(service.latents({"batch": 2, "seed": 4})))
    assert set(got) == set(want)
    assert all(np.array_equal(got[k], want[k].numpy()) for k in want)
    z = np.random.RandomState(9).randn(3, IN_CH).astype(np.float32)
    status, body = _post(url, {"latents": z.tolist()}, "?format=json")
    assert status == 200
    with torch.inference_mode():
        want = eager(torch.from_numpy(z))
    got = json.loads(body)
    assert all(np.array_equal(np.asarray(got[k], np.float32), want[k].numpy()) for k in want)


@pytest.mark.parametrize("body", [
    b"not json", b"[1, 2]", {"batch": 0}, {"latents": [[0.0] * (IN_CH + 1)]},
    {"latents": [1.0, 2.0]}, {"latents": [["a"] * IN_CH]}, {"batch": "x"},
])
def test_bad_requests_get_400(servers, body):
    status, answer = _post(servers["dynamic"][0], body)
    assert status == 400 and "error" in json.loads(answer)


def test_fixed_batch_is_padded_and_refuses_more(servers, exported):
    url, service = servers["fixed"]
    z = np.random.RandomState(2).randn(2, IN_CH).astype(np.float32)
    status, body = _post(url, {"latents": z.tolist()}, "?format=json")
    assert status == 200
    padded = torch.from_numpy(np.concatenate([z, z[-1:]]))
    with torch.inference_mode():
        want = _eager(exported, 0.3)(padded)
    got = json.loads(body)
    assert all(np.array_equal(np.asarray(got[k], np.float32), want[k][:2].numpy())
               for k in want)
    status, answer = _post(url, {"batch": 4})
    assert status == 400 and "fixed batch 3" in json.loads(answer)["error"]


def test_seeded_latents_equal_the_jax_servers(servers):
    service = servers["dynamic"][1]
    jax_like = types.SimpleNamespace(in_ch=IN_CH)
    for req in ({"batch": 3, "seed": 11}, {"batch": 1}, {"batch": 2, "seed": 2**40}):
        np.testing.assert_array_equal(service.latents(req), JaxService.latents(jax_like, req))


def _jax_manifest_keys(cfg_path, pth, out_dir, monkeypatch):
    """The JAX export CLI's manifest keys, with its setup and lowering
    stubbed (its manifest does not depend on them)."""
    cfg = jax_load_config(cfg_path)
    monkeypatch.setattr(jax_setup, "setup", lambda *a, **k: (cfg, None, None, None, None))
    monkeypatch.setattr(jax_export, "export_generator",
                        lambda *a, **k: types.SimpleNamespace(serialize=lambda: b"stub"))
    jax_export_main(["--model-path", pth, "--config-path", cfg_path, "--output-dir", out_dir,
                     "--no-verify"])
    with open(osp.join(out_dir, "manifest.json")) as f:
        return set(json.load(f))


def test_export_cli_on_the_cpu(exported, tmp_path, monkeypatch):
    sd = exported["G"].state_dict()
    pth = str(tmp_path / "checkpoint.pth")
    torch.save({"step": 8, "G": sd, "G_ema": sd}, pth)
    out_dir = str(tmp_path / "export")
    export_main(["--model-path", pth, "--config-path", exported["cfg_path"],
                 "--output-dir", out_dir, "--device", "cpu"])
    call, manifest = load_exported(out_dir)
    assert manifest["device"] == "cpu" and manifest["compute_dtype"] == "bf16"
    with torch.inference_mode():
        out = call(_latents(2))
    assert out["depth"].shape == (2, 64, 256, 1) and out["points"].shape == (2, 64 * 256, 3)
    want = _jax_manifest_keys(exported["cfg_path"], pth, str(tmp_path / "jax"), monkeypatch)
    assert set(manifest) == (want - {"jax_version", "platforms"}) | {"torch_version", "device"}
    with pytest.raises(RuntimeError, match="no GPU is visible"):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        export_main(["--model-path", pth, "--config-path", exported["cfg_path"],
                     "--output-dir", str(tmp_path / "gpu")])
