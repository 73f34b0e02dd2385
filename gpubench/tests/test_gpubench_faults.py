"""A run with its timed path broken underneath comes out not correct: each
fault a cell can have is planted in the program, the rest of the run is
driven as on the card (on the CPU, at tiny sizes), and ``correct`` must
read false.  The faults: a step that returns its state unchanged; half
of the batch left out, the mean taken over the rest; an answer altered
where it is produced; and faults of one part of the timed path each: a
chunk's later slots reading slot 0's rows or draws, an inversion loop cut
short, real scans turned into wrong clouds.  Every cell runs on one chip,
so none has an exchange between chips to leave out."""

from __future__ import annotations

import pytest
import torch

from gpubench import harness

CPU = torch.device("cpu")


# the number that each fault of one part of the path must fail
CAUGHT_BY = {"slot_rows": "reals_gap", "slot_draws": "reals_gap",
             "real_clouds": "fps_mismatch", "truncated": "loop_steps_gap"}


def fails(out, fault):
    c = out["checks"].get(CAUGHT_BY.get(fault))
    return not out["correct"] and (c is None or c["value"] > c["limit"])


def run(spec, name):
    # float32, where the program and the reference agree to rounding at any
    # width, so that only the fault can fail a limit at these tiny widths
    spec["config_data"]["enable_amp"] = False
    return harness.run_cell(name, 2 ** 31 + 23, 0.2, False, CPU, spec=spec)


def test_the_cells_pass_unbroken(tiny_spec):
    for name in ("dusty2_kitti.train", "dusty1_mpo.train", "dusty2_kitti.synth_cd",
                 "dusty2_kitti.recon"):
        out = run(tiny_spec(name), name)
        assert out["correct"], (name, out["checks"])


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered", "slot_rows",
                                   "slot_draws"])
def test_training_faults(tiny_spec, monkeypatch, fault):
    from dusty_gan_torch.train import graphs, step

    if fault == "unchanged":
        monkeypatch.setattr(step, "scheduled_step", lambda *a, **k: None)
        monkeypatch.setattr(step, "ema_update", lambda *a, **k: None)
    elif fault == "half_batch":
        call = step.TrainStep.__call__

        def half(self, state, batch, draws, *a, **k):
            h = batch["depth"].shape[0] // 2
            return call(self, state, {key: v[:h] for key, v in batch.items()},
                        step.local_draws(draws, 0, 2), *a, **k)
        monkeypatch.setattr(step.TrainStep, "__call__", half)
    elif fault.startswith("slot_"):
        # every slot of a chunk after the first reads slot 0's rows, or its draws
        def slot0(self, state, j, lr):
            rows, draws = (0, j) if fault == "slot_rows" else (j, 0)
            return self.trainer.train_step(state, self.cache.gather(self.rows[rows]),
                                           self.slots[draws], lr, stop=self.stop)
        monkeypatch.setattr(graphs.ChunkRunner, "_step", slot0)
    else:
        # one leaf's update made twice where the optimizer produces it
        scheduled = step.scheduled_step

        def doubled(optimizer, schedule, lr=None):
            p = optimizer.param_groups[0]["params"][0]
            old = p.detach().clone()
            scheduled(optimizer, schedule, lr)
            with torch.no_grad():
                p.add_(p - old)
        monkeypatch.setattr(step, "scheduled_step", doubled)
    out = run(tiny_spec("dusty2_kitti.train"), "dusty2_kitti.train")
    assert fails(out, fault), out["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered", "real_clouds"])
def test_synthesis_faults(tiny_spec, monkeypatch, fault):
    from dusty_gan_torch.geometry.lidar import Lidar
    from dusty_gan_torch.metrics import cov_mmd_1nna, fps

    if fault == "unchanged":
        # FPS's step leaves its choice unchanged: the first k points
        monkeypatch.setattr(fps, "furthest_point_sampling", lambda xyz, k: torch.arange(
            k).expand(xyz.shape[0], k).contiguous())
    elif fault == "half_batch":
        block = cov_mmd_1nna.cd_block

        def half(rows, cols):
            out = block(rows, cols)
            out[out.shape[0] // 2:] = out[:out.shape[0] - out.shape[0] // 2].clone()
            return out
        monkeypatch.setattr(cov_mmd_1nna, "cd_block", half)
    elif fault == "real_clouds":
        # the real scans' inverse depth, which only the real pool's clouds
        # go through, off by a thousandth
        invert = Lidar.invert_depth
        monkeypatch.setattr(Lidar, "invert_depth", lambda self, d: invert(self, d) * 0.999)
    else:
        scores = cov_mmd_1nna._compute_cov_mmd
        monkeypatch.setattr(cov_mmd_1nna, "_compute_cov_mmd", lambda m: dict(
            scores(m), cov=scores(m)["cov"] + 1e-3))
    out = run(tiny_spec("dusty2_kitti.synth_cd"), "dusty2_kitti.synth_cd")
    assert fails(out, fault), out["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered", "truncated"])
def test_reconstruction_faults(tiny_spec, monkeypatch, fault):
    from dusty_gan_torch.cli import evaluate_reconstruction as er

    if fault == "unchanged":
        loop = er.make_inversion_loop
        monkeypatch.setattr(er, "make_inversion_loop",
                            lambda loss_fn, num_steps, lr: loop(loss_fn, 0, lr))
    elif fault == "truncated":
        # the loop's last step left out, step 5 still taken
        loop = er.make_inversion_loop
        monkeypatch.setattr(er, "make_inversion_loop",
                            lambda loss_fn, num_steps, lr: loop(loss_fn, num_steps - 1, lr))
    elif fault == "half_batch":
        cd = er.compute_cd

        def half(a, b):
            h = a.shape[0] // 2
            out = cd(a[:h], b[:h])
            return torch.cat([out, out[:a.shape[0] - h]])
        monkeypatch.setattr(er, "compute_cd", half)
    else:
        cd = er.compute_cd
        monkeypatch.setattr(er, "compute_cd", lambda a, b: cd(a, b) * 1.01)
    out = run(tiny_spec("dusty2_kitti.recon"), "dusty2_kitti.recon")
    assert fails(out, fault), out["checks"]
