"""The plain reference against ``dusty_gan_torch`` where the port has a CPU
path, at tiny widths in float32 (where the two compute alike), and the
controls: the reference computed a precision lower than the program's
fails one of each cell's limits."""

from __future__ import annotations

import pytest
import torch

from gpubench.drivers import recon, synth_cd, train_chunks
from gpubench.reference import inversion as ref_inv
from gpubench.reference import models
from gpubench.reference import synthesis as ref_syn

CPU = torch.device("cpu")
CELLS = {"dusty2_kitti.train": train_chunks, "dusty1_mpo.train": train_chunks,
         "dusty2_kitti.synth_cd": synth_cd, "dusty2_kitti.recon": recon}


@pytest.mark.parametrize("cell", ["dusty2_kitti.train", "dusty1_mpo.train"])
def test_train_step_matches_the_program_in_float32(tiny_spec, cell):
    spec = tiny_spec(cell)
    spec["config_data"]["enable_amp"] = False
    numbers = train_chunks.program_numbers(spec, 2 ** 31 + 3, CPU)
    assert max(numbers[k] for k in train_chunks.NUMBERS) < 1e-4


def test_generator_points_fps_chamfer_and_scores_match_the_program(tiny_spec):
    from dusty_gan_torch.geometry.lidar import Lidar
    from dusty_gan_torch.metrics import chamfer_cuda, cov_mmd_1nna, fps
    from dusty_gan_torch.models.factory import define_G
    from dusty_gan_torch.config import Config
    from dusty_gan_torch.utils.setup import make_eval_generator

    spec = tiny_spec("dusty2_kitti.synth_cd")
    run = synth_cd.Run(spec, 9, CPU, None)
    cfg, shape = run.cfg, run.shape
    pcfg = Config.wrap({"model": dict(cfg["model"])})
    pcfg.model.gen = Config.wrap(dict(cfg["model"]["gen"], shape=list(shape)))
    G = define_G(pcfg)
    G.load_state_dict(run.weights(), strict=False)
    gen = make_eval_generator(G.eval().requires_grad_(False), run.noise(), None)
    z = torch.randn(6, cfg["model"]["gen"]["in_ch"])
    fake = gen(z)["depth"]
    assert synth_cd._gap(fake, run.reference_fakes(z)) < 1e-5

    ds = cfg["dataset"]
    lidar = Lidar.from_angle_array(synth_cd.inputs.angles(ds["sensor"], shape), shape,
                                   ds["min_depth"], ds["max_depth"])
    from dusty_gan_torch.geometry.lidar import tanh_to_sigmoid
    want = lidar.inv_to_xyz(torch.clamp(tanh_to_sigmoid(fake), 0.0, 1.0), 0.0)
    got = run.xyz(fake, 0.0)
    assert torch.equal(got, want.reshape(got.shape))
    assert torch.equal(ref_syn.fps(got, 64), fps.downsample_point_clouds(got, 64))

    a, b = torch.rand(3, 50, 3), torch.rand(4, 40, 3)
    block = chamfer_cuda.cd_block_reference(a, b)
    pairs = ref_syn.chamfer_pairs(a.repeat_interleave(4, 0), b.repeat(3, 1, 1))
    torch.testing.assert_close(pairs.view(3, 4), block, rtol=1e-6, atol=0)

    gen_3d, ref_3d = torch.rand(7, 30, 3), torch.rand(7, 30, 3)
    m = [cov_mmd_1nna.pairwise_cd(x, y, 4) for x, y in
         ((ref_3d, ref_3d), (ref_3d, gen_3d), (gen_3d, gen_3d))]
    assert ref_syn.scores(*m) == cov_mmd_1nna.compute_cov_mmd_1nna(gen_3d, ref_3d, 4)


def test_inversion_matches_the_program_in_float32():
    from dusty_gan_torch.utils.inversion import make_inversion_loop

    w = torch.randn(6, 8)
    loss = lambda z: ((z @ w).tanh() - 0.3).abs().mean(dim=1)  # noqa: E731
    z0 = torch.randn(5, 6)
    noise = lambda seed: (lambda g: (lambda step, shape: torch.randn(  # noqa: E731
        shape, generator=g)))(torch.Generator().manual_seed(seed))
    want, lw = make_inversion_loop(loss, num_steps=20)(z0, noise(1))
    got, lg = ref_inv.invert(loss, z0, noise(1), 20)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(lg, lw, rtol=1e-5, atol=1e-6)
    a, b = torch.rand(100, 3), torch.rand(90, 3)
    from dusty_gan_torch.metrics.chamfer import compute_cd
    assert ref_inv.chamfer(a, b) == pytest.approx(float(compute_cd(a[None], b[None])[0]),
                                                  rel=1e-6)


def _fails_a_limit(spec, numbers):
    limits = spec["traffic"]["limits"]
    return [k for k, v in numbers.items() if k in limits and v > limits[k]]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_control_fails_a_limit(tiny_spec, cell):
    spec = tiny_spec(cell)
    readings = CELLS[cell].control_numbers(spec, 2 ** 31 + 5, CPU)
    control = readings.get("fp8") or readings["control"]
    assert _fails_a_limit(spec, control), control


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_at_the_cells_size_the_control_fails_and_the_program_passes(cuda_device, cell):
    from gpubench import harness

    spec = harness.cell_spec(cell)
    readings = CELLS[cell].control_numbers(spec, 2 ** 31 + 17, cuda_device)
    assert _fails_a_limit(spec, readings.get("fp8") or readings["control"])
    numbers = CELLS[cell].program_numbers(spec, 2 ** 31 + 19, cuda_device)
    assert not _fails_a_limit(spec, numbers), numbers


def test_reference_weights_cover_the_program_parameters():
    from dusty_gan_torch.config import Config
    from dusty_gan_torch.models.factory import define_D, define_G

    for arch, out in (("dusty2/dcgan_eqlr", {"depth": 1, "confidence": 2}),
                      ("dusty1/dcgan_eqlr", {"depth": 1, "confidence": 1})):
        model = {"gen": {"arch": arch, "in_ch": 16, "out_ch": out, "ch_base": 4, "ch_max": 8,
                         "drop_const": -1, "shape": [32, 64], "tau": 1},
                 "dis": {"arch": "dcgan_eqlr", "in_ch": 1, "ch_base": 4, "ch_max": 8,
                         "shape": [32, 64]}, "ring": True}
        cfg = Config.wrap({"model": model})
        for spec, module in ((models.generator_spec(model, (32, 64)), define_G(cfg)),
                             (models.discriminator_spec(model, (32, 64)), define_D(cfg))):
            assert {k: tuple(v) for k, v in spec} == {
                k: tuple(p.shape) for k, p in module.named_parameters()}
