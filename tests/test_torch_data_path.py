"""The port's training data path against the JAX package's, on the CPU.

* The native library (``csrc/rangeproj.cpp``, built by ``kernels.py``)
  and the numpy pipeline give the same items bit for bit, and both equal
  the JAX package's ``_process`` (whose default is the same C++); JAX's
  own numpy fallback divides where the C++ multiplies by a reciprocal, so
  it is held within 1 ulp (rtol 1e-6 / atol 1e-7) with the masks equal.
* The resized cache and the flip cache serve the raw path's items bit for
  bit; a cache that either package built is read by the other.
* ``Loader.index_stream`` / ``flip_bits`` equal the JAX loader's.
* ``DeviceDatasetCache`` (on a CPU device) serves the host path's batches
  bit for bit, flips included; three ``Trainer`` steps with
  ``cache_device=true`` equal the host path's, also from a mid-stream start.
* ``transfer_dtype``: float16 crosses as float16 and is upcast before the
  mask is derived; an integer dtype raises ``ValueError``."""

import os.path as osp

import numpy as np
import pytest
import torch

from dusty_gan_tpu.config import compose as jax_compose
from dusty_gan_tpu.data import datasets as jds
from dusty_gan_tpu.data.loader import Loader as JaxLoader

from dusty_gan_torch import kernels
from dusty_gan_torch.cli.train import main as train_main
from dusty_gan_torch.config import compose
from dusty_gan_torch.data import datasets as tds
from dusty_gan_torch.data.device_cache import DeviceDatasetCache
from dusty_gan_torch.data.loader import Loader
from dusty_gan_torch.data.synthetic import build_synthetic_kitti
from dusty_gan_torch.geometry.lidar import Lidar
from dusty_gan_torch.train.step import fetch_reals
from dusty_gan_torch.train.trainer import Trainer

from torch_parity import one_torch_thread  # noqa: F401  (autouse)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
CONFIG_DIR = osp.join(REPO, "configs")
TINY = ["model=dusty2_dcgan_eqlr", "model.gen.in_ch=16", "model.gen.ch_base=8",
        "model.gen.ch_max=16", "model.dis.ch_base=8", "model.dis.ch_max=16",
        "solver.batch_size=4"]
ULP = dict(rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return build_synthetic_kitti(str(tmp_path_factory.mktemp("data_path") / "data"),
                                 n_scans_per_seq=10, w0=512, sequences=(0, 8))


def _bare(cls, modality=("depth",), shape=(64, 256)):
    ds = cls.__new__(cls)
    ds.min_depth, ds.max_depth, ds.shape, ds.modality = 0.9, 120.0, shape, modality
    return ds


def _scan(seed, h0=64, w0=512):
    """Scan with every case of the gate: zeros, below min, in range, above
    max, negative coordinates."""
    rng = np.random.RandomState(seed)
    scan = rng.uniform(-150, 150, (h0, w0, 4)).astype(np.float32)
    scan[rng.rand(h0, w0) < 0.1] = 0
    near = rng.rand(h0, w0) < 0.05
    scan[near, :3] *= 0.004
    return scan


def test_native_library_is_built_from_the_ports_source():
    path = kernels.library_path("rangeproj")
    assert path.parent.name == "dusty_gan_torch" and path.parent.parent.name == "build"
    assert path.name.startswith("librangeproj-")
    assert kernels.SOURCES["rangeproj"] == ("rangeproj.cpp", "c++")
    assert "-ffp-contract=off" in kernels.flags("rangeproj")
    assert not any("march" in f for f in kernels.flags("rangeproj"))
    kernels.build(["rangeproj"])
    assert path.exists() and not path.with_suffix(".log").exists()  # no ptxas log


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("shape", [(64, 256), (32, 128)])
def test_items_native_numpy_and_jax_agree(flip, shape):
    scan = _scan(1)
    ts = _bare(tds.KITTIOdometry, shape=shape)
    js = _bare(jds.KITTIOdometry, shape=shape)
    got = ts._process(scan, flip)
    numpy_path = ts._process(scan, flip, native=False)
    want = js._process(scan, flip)  # the JAX package's native path
    js.modality = ("depth", "numpy")  # the JAX package's numpy path
    jax_numpy = js._process(scan, flip)
    assert set(got) == set(numpy_path) == {"depth", "mask", "xyz"}
    for k in got:
        assert got[k].dtype == np.float32 and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], numpy_path[k], err_msg=k)
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_allclose(got[k], jax_numpy[k], **ULP, err_msg=k)
    np.testing.assert_array_equal(got["mask"], jax_numpy["mask"])
    assert 0 < got["mask"].mean() < 1


def test_reflectance_modality_matches_jax():
    scan = _scan(2)
    ts = _bare(tds.KITTIOdometry, modality=("depth", "reflectance"))
    js = _bare(jds.KITTIOdometry, modality=("depth", "reflectance"))
    got, want = ts._process(scan, True), js._process(scan, True)
    assert set(got) == set(want) == {"depth", "mask", "xyz", "reflectance"}
    np.testing.assert_array_equal(got["reflectance"], want["reflectance"])
    np.testing.assert_array_equal(got["mask"], want["mask"])
    for k in ("depth", "xyz"):
        np.testing.assert_allclose(got[k], want[k], **ULP, err_msg=k)
    # the depth keys equal the native library's
    native_item = _bare(tds.KITTIOdometry)._process(scan, True)
    np.testing.assert_array_equal(got["depth"], native_item["depth"])


@pytest.mark.parametrize("flip", [False, True])
def test_caches_serve_the_raw_items(root, tmp_path, flip):
    cfg = {"name": "kitti_odometry", "root": root, "shape": [64, 256], "min_depth": 0.9,
           "max_depth": 120.0, "flip": flip}
    cached = tds.define_dataset(cfg, "train", cache_dir=str(tmp_path))
    raw = tds.define_dataset(cfg, "train")
    assert cached.flip == flip and (cached._flip_cache is not None) == flip
    assert osp.isdir(cached.cache_path(str(tmp_path)))
    for i in range(len(raw)):
        for f in (False, True):
            for keys in (None, ("depth",), ("depth", "mask")):
                got, want = cached.item(i, f, keys), raw.item(i, f, keys)
                assert set(got) == set(want)
                for k in want:
                    np.testing.assert_array_equal(got[k], want[k], err_msg=(i, f, k))
    if flip:  # a flipped depth read comes from the flip cache, not the raw scan
        cached._load_raw = None
        cached.item(0, True, ("depth",))


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("flip", [False, True])
def test_cache_built_by_either_package_serves_the_other(root, tmp_path, monkeypatch,
                                                        writer, flip):
    over = [f"dataset.root={root}", f"dataset.flip={str(flip).lower()}"]
    cache = str(tmp_path / "cache")
    make = {"jax": lambda: jds.define_dataset(jax_compose(CONFIG_DIR, over).dataset,
                                              "train", cache_dir=cache),
            "torch": lambda: tds.define_dataset(compose(CONFIG_DIR, over).dataset,
                                                "train", cache_dir=cache)}
    built = make[writer]()
    reader_cls = {"jax": tds.RangeImageDataset, "torch": jds.RangeImageDataset}[writer]

    def no_build(*a, **k):
        raise AssertionError("the reader rebuilt the cache")

    monkeypatch.setattr(reader_cls, "_write_cache_dir", no_build)
    reader = make["torch" if writer == "jax" else "jax"]()
    assert reader._cache_key() == built._cache_key()
    for i in range(len(built)):
        for f, keys in ((False, None), (flip, ("depth", "mask"))):
            got, want = reader.item(i, f, keys), built.item(i, f, keys)
            for k in want:
                np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))


def test_cache_key_normalises_shape_and_depths(root):
    """A list shape and an int depth sign the same cache in both packages."""
    for shape, min_depth in (([64, 256], 0.9), ((64, 256), 0.9), ((32, 256), 1)):
        t = tds.KITTIOdometry(root, "val", shape=shape, min_depth=min_depth)
        j = jds.KITTIOdometry(root, "val", shape=shape, min_depth=min_depth)
        assert t._cache_key() == j._cache_key()


@pytest.mark.parametrize("start", [0, 4])
def test_index_stream_and_flip_bits_equal_jax(root, start):
    over = [f"dataset.root={root}", "dataset.flip=true"]
    ds = tds.define_dataset(compose(CONFIG_DIR, over).dataset, "train")
    jd = jds.define_dataset(jax_compose(CONFIG_DIR, over).dataset, "train")
    kw = dict(shuffle=True, drop_last=True, seed=7)
    got, want = Loader(ds, 3, **kw), JaxLoader(jd, 3, **kw)
    a, b = got.index_stream(start), want.index_stream(start)
    flips = 0
    for _ in range(7):  # across two epoch boundaries
        (ea, ia), (eb, ib) = next(a), next(b)
        assert ea == eb
        np.testing.assert_array_equal(ia, ib)
        bits = got.flip_bits(ea, ia)
        np.testing.assert_array_equal(bits, want.flip_bits(eb, ib))
        flips += int(bits.sum())
    assert 0 < flips < 21


@pytest.mark.parametrize("flip", [False, True])
def test_device_cache_equals_host_path(root, tmp_path, flip):
    over = [f"dataset.root={root}", f"dataset.flip={str(flip).lower()}"]
    ds = tds.define_dataset(compose(CONFIG_DIR, over).dataset, "train",
                            cache_dir=str(tmp_path))
    loader = Loader(ds, 3, shuffle=True, drop_last=True, seed=3, keys=("depth",))
    cache = DeviceDatasetCache(loader, "cpu")
    assert cache.nbytes == (2 if flip else 1) * len(ds) * 64 * 256 * 4
    host = loader.iter_from(1)
    ix = loader.index_stream(1)
    for _ in range(5):
        want = torch.from_numpy(next(host)["depth"]).permute(0, 3, 1, 2)
        got = cache.batch(*next(ix))["depth"]
        assert got.shape == (3, 1, 64, 256) and got.dtype == torch.float32
        assert torch.equal(got, want)
    host.close()
    # the seed is read at call time: a resumed trainer sets it after the upload
    loader.seed = 11
    epoch, idx = next(Loader(ds, 3, shuffle=True, drop_last=True, seed=11).index_stream(0))
    np.testing.assert_array_equal(
        cache.rows(epoch, idx),
        idx + len(ds) * Loader(ds, 3, seed=11).flip_bits(epoch, idx))


def _trainer(root, tmp_path, *extra):
    cfg = compose(CONFIG_DIR, TINY + [f"dataset.root={root}", "dataset.flip=true", *extra])
    return Trainer(cfg, torch.device("cpu"), verbose=False)


def test_cache_device_steps_equal_host_path(root, tmp_path):
    host = _trainer(root, tmp_path)
    dev = _trainer(root, tmp_path, "cache_device=true")
    assert host.device_cache is None and dev.device_cache is not None
    assert dev.dataset._cache is not None  # cache_dataset defaults to true
    a, b = host.device_iter(), dev.device_iter()
    for i in range(1, 4):
        ba, bb = next(a), next(b)
        assert torch.equal(ba["depth"], bb["depth"])
        sa, sb = host.step(i, ba), dev.step(i, bb)
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    for (ka, pa), (_, pb) in zip(host.state.G_ema.state_dict().items(),
                                 dev.state.G_ema.state_dict().items()):
        assert torch.equal(pa, pb), ka
    a.close()
    # a mid-stream start yields the uninterrupted stream's batches
    c = dev.device_iter(start_iteration=2)
    full = host.device_iter(start_iteration=0)
    for _ in range(2):
        next(full)
    for _ in range(3):
        assert torch.equal(next(c)["depth"], next(full)["depth"])
    full.close()


def test_transfer_dtype_float16_crosses_narrow_and_upcasts(root, tmp_path):
    tr = _trainer(root, tmp_path, "transfer_dtype=float16")
    batch = next(tr.loader.epoch(0))
    dev = tr.to_device(batch)
    assert dev["depth"].dtype == torch.float16
    inv, mask = fetch_reals(dev, tr.lidar, -1.0)
    assert inv.dtype == mask.dtype == torch.float32
    want = torch.from_numpy(batch["depth"]).permute(0, 3, 1, 2).half().float()
    assert torch.equal(mask, (want > 0).float())
    inv32, _ = fetch_reals({"depth": want}, tr.lidar, -1.0)
    assert torch.equal(inv, inv32)
    scalars = tr.step(1, next(tr.device_iter()))
    assert all(np.isfinite(float(v)) for v in scalars.values())


def test_fetch_reals_derives_the_mask_after_the_upcast():
    """float16 keeps depths down to 2^-24; a mask taken before the upcast
    would agree, but the inverse depth must come from float32 values."""
    lidar = Lidar(angle=torch.zeros(2, 2, 2), min_depth=0.9, max_depth=120.0)
    depth = torch.tensor([[[[0.0, 2.0 ** -24], [0.5, 1.0]]]], dtype=torch.float16)
    inv, mask = fetch_reals({"depth": depth}, lidar, -1.0)
    assert mask.dtype == torch.float32
    assert mask.flatten().tolist() == [0.0, 1.0, 1.0, 1.0]
    want, _ = fetch_reals({"depth": depth.float()}, lidar, -1.0)
    assert torch.equal(inv, want)


@pytest.mark.parametrize("dtype", ["int8", "int32", "uint8", "bool", "not_a_dtype"])
def test_transfer_dtype_must_be_floating(root, tmp_path, dtype):
    with pytest.raises(ValueError, match="floating"):
        _trainer(root, tmp_path, f"transfer_dtype={dtype}")


@pytest.mark.parametrize("extra", [["cache_device=true"], ["transfer_dtype=float16"],
                                   ["cache_dataset=false"]])
def test_cli_runs_with_each_data_mode(root, tmp_path, extra):
    run = train_main([*TINY, f"dataset.root={root}", f"run_dir={tmp_path}",
                      "total_iterations=2", "solver.checkpoint.save_stats=1",
                      "solver.checkpoint.test=100", "solver.checkpoint.save_model=100",
                      "device=cpu", *extra])
    assert osp.exists(osp.join(run, "models", "checkpoint_0000000008.pth"))
    if extra == ["cache_dataset=false"]:
        tr = _trainer(root, tmp_path, *extra)
        assert tr.dataset._cache is None and tr.val_dataset._cache is None
