"""The benchmark's reference against the port on the CPU, at 32² and 64²:
the render (the port's float32 ``SceneRenderer.frames`` on the same
checkpoint) and the training step (the port's ``Trainer.train_step`` from
the same weights and BN-noise seed)."""

import dataclasses
import os

import pytest
import torch

from benchmark import generate
from benchmark.drivers import render as drender
from benchmark.drivers import train as dtrain
from benchmark.harness import load_json
from benchmark.reference import render as ref_render

CFG = {n: load_json(f"benchmark/configs/{n}.json") for n in ("baseline", "slr")}


def _render_mix(size):
    mix = load_json("benchmark/traffic/claw768_sweep.json")
    mix.update(W=size, n_frames=4, order_groups=2, order_cycles=1,
               bands=[[0.2, 0.6, 0.3, 0.3], [0.9, 0.95, 0.5, 0.5]])
    return mix


@pytest.mark.parametrize("size", [32, 64])
def test_reference_render_matches_port(size, tmp_path):
    from slrsfs_tpu_torch.cli.render import SceneRenderer

    mix = _render_mix(size)
    opt = drender.options(CFG["baseline"], mix)
    model, state = drender.make_weights(opt, 7, torch.device("cpu"))
    ckpt = drender.write_checkpoint(os.path.join(tmp_path, "w.pth"), opt, state)
    pool = generate.scene_pool(mix, 7)
    N = mix["n_frames"]
    r = SceneRenderer(ckpt=ckpt, W=size, n_frames=N, dtype="float32",
                      sparsify_eps=0.5 / N, crop_decode="auto", p_bucket_ratio=1.25,
                      device="cpu")
    for i in range(len(pool["flows"])):
        flow = r.scene_flow(pool["images"][i], pool["flows"][i], "s")
        got = r.frames(pool["images"][i], flow)
        want, _ = ref_render.render_frames(
            model, pool["images"][i], pool["flows"][i], N, 0.5 / N, 1.25,
            r.decode_batch_for, torch.float32)
        assert torch.allclose(got, want, atol=1e-4, rtol=0), float((got - want).abs().max())


def _train_mix(size):
    mix = load_json("benchmark/traffic/train256_band.json")
    mix.update(batch_size=2, W=size, n_steps=4, pool=3, check_steps=2,
               middle_index_range=[1, 2], bands=[[0.2, 0.5, 0.3, 0.6], [0.4, 0.8, 0.6, 0.2]])
    return mix


@pytest.mark.parametrize("config,size", [("baseline", 32), ("baseline", 64), ("slr", 64)])
def test_reference_step_matches_port(config, size):
    from slrsfs_tpu_torch.cli.train import attach_moving_sets, to_device_batch

    mix = _train_mix(size)
    opt = dtrain.options(CFG[config], mix)
    mods, states = dtrain.make_weights(opt, 11, mix["n_steps"], torch.device("cpu"))
    pool = generate.batch_pool(mix, 11, dtrain.part_of(opt).batch_extras)
    trainer = dtrain.build_port(opt, states, mix, 11, "cpu")
    eps = 0.5 / mix["n_steps"]
    st = {}

    def step(j):
        b = attach_moving_sets(pool["batches"][pool["order"][j]], state=st, eps=eps)
        return float(trainer.train_step(to_device_batch(b, "cpu"))["Total Loss"])

    port = dtrain.port_readings(trainer, states, opt, step, mix["check_steps"])
    ref = dtrain.reference_readings(opt, mods, states, mix, pool, 11, torch.device("cpu"))
    assert trainer.g_names == [n for n, p in mods[0].named_parameters() if p.requires_grad]
    got = dtrain.compare(port, ref)
    assert got["loss_gap"] < 1e-5 and got["grad_gap"] < 1e-4, got
    # Adam's first updates are about lr·sign(g): a gradient element that
    # rounds to the other sign moves by 2 lr, so the change is held looser
    assert got["change_gap"] < 0.05, got


def test_options_match_the_port():
    """The reference's ``Options`` has the port's fields and defaults."""
    from slrsfs_tpu_torch.config import Options as PortOptions

    from benchmark.reference.config import Options

    assert dataclasses.asdict(Options()) == dataclasses.asdict(PortOptions())
