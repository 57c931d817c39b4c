"""The train CLI's new stages on the CPU, one step each on the synthetic
fixture scenes, each checkpoint read back by the JAX package's importers:

* bg stage 2 (``--model-type bg``): its ``_bg`` losses logged, the
  checkpoint read by JAX's ``import_checkpoint`` (``import_bg_model``),
  and SLR stage 3 warm-started from it with ``--init-bg-from``: stage 3's
  ``net_bg`` is stage 2's;
* the motion GAN (``--model-type SPADE_unet_mask_motion`` at 256², the
  smallest input of the reference's 8-down regressor, narrowed to width 4
  by the stage options, which the CLI does not expose): online
  hints, ``10.0_EndPointError``, read by JAX's ``import_checkpoint``
  (``import_motion_model``);
* the fix-motion finetune (``--embed-motion --freeze-motion``) from a
  stage-1 checkpoint and the motion GAN's (``--init-motion-from``): the
  regressor equals the motion GAN's and stays so, the fluid nets train;
  read by JAX's ``import_embedded_baseline``;
* the unfrozen joint stage (``--embed-motion``) from the fix-motion
  checkpoint: the regressor trains; read likewise; then
  ``cli/render.SceneRenderer`` renders with it as ``--motion-ckpt``;
* the CLI's three argument rules (JAX :320-329) and its defaults
  (datasets, motion losses, MVloss, online hints)."""

import json
import os

import numpy as np
import pytest
import torch

import torch_stage_parity as P
from slrsfs_tpu.io.checkpoint import (
    import_checkpoint,
    import_embedded_baseline,
    load_torch_checkpoint,
)
from slrsfs_tpu_torch.cli import render as port_render
from slrsfs_tpu_torch.cli import train as port_train
from slrsfs_tpu_torch.config import Options
from slrsfs_tpu_torch.io.convert import from_jax_variables
from slrsfs_tpu_torch.models.baseline import BaselineMotionTrainable
from slrsfs_tpu_torch.models.slr import BackgroundModel

torch.set_num_threads(1)

SLR_TYPE = "softmax_splating_2layers_alpha_seperate"
TINY = ["--ngf", "8", "--out-channel", "9", "--refine-model-type",
        "resnet_TinyTest_de_resnet_pconv2_nonorm", "--ndf", "8", "--num-D", "1",
        "--n-layers-D", "2"]
ONE_STEP = ["--batch-size", "1", "--niter", "1", "--niter-decay", "0",
            "--steps-per-epoch", "1", "--val-steps", "1", "--train-max-steps", "6",
            "--device", "cpu"]


def _run(root, out, *args):
    return port_train.main(["--data-root", root, "--out", str(out), *ONE_STEP, *args])


def _rows(ckpt):
    with open(os.path.join(os.path.dirname(ckpt), "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    for r in rows:
        assert all(np.isfinite(v) for k, v in r.items() if k != "split"), r
    return rows


def _sd(ckpt):
    return torch.load(ckpt, map_location="cpu", weights_only=False)["state_dict"]


def _opts(ckpt):
    with open(os.path.join(os.path.dirname(ckpt), "options.json")) as f:
        return json.load(f)


def _narrow_regressor(mp):
    """The motion stages' options with the regressor at width 4 (the
    shipped 32 is slow on the CPU)."""
    shipped = port_train.stage_options

    def stage_options(model_type, embed_motion=False):
        out = shipped(model_type, embed_motion)
        if embed_motion or model_type in port_train.MOTION_MODEL_TYPES:
            out["motion_num_filters"] = 4
        return out

    mp.setattr(port_train, "stage_options", stage_options)


@pytest.fixture(scope="module")
def chain(fixture_root, tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        _narrow_regressor(mp)
        return _chain(fixture_root, tmp_path_factory)


def _chain(fixture_root, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("stages")
    root = fixture_root
    out = {}
    out["stage1"] = _run(root, tmp / "s1", "--W", "32", *TINY)
    out["bg"] = _run(root, tmp / "bg", "--model-type", "bg", "--W", "32", "--ngf", "16")
    out["stage3"] = _run(root, tmp / "s3", "--model-type", SLR_TYPE, "--W", "32",
                         "--ngf", "16", "--init-from", _run(root, tmp / "s1w", "--W", "32",
                                                            "--ngf", "16"),
                         "--init-bg-from", out["bg"])
    out["motion"] = _run(root, tmp / "motion", "--model-type", "SPADE_unet_mask_motion",
                         "--W", "256", "--ndf", "8",
                         "--num-D", "1", "--n-layers-D", "2")
    out["fix"] = _run(root, tmp / "fix", "--embed-motion", "--freeze-motion", "--W", "256",
                      *TINY, "--init-from", out["stage1"],
                      "--init-motion-from", out["motion"])
    # --init-from restores the fix-motion run's Adam states and count (2
    # steps), which with one epoch and no decay puts its first step at the
    # end of the schedule; two steps an epoch keep the rate above 0
    out["joint"] = _run(root, tmp / "joint", "--embed-motion", "--W", "256", *TINY,
                        "--init-from", out["fix"], "--steps-per-epoch", "2")
    return out


def test_bg_stage_cli_and_stage3_from_it(chain):
    rows = _rows(chain["bg"])
    train = [r for r in rows if r["split"] == "train"]
    assert len(train) == 1 and {"L1_bg", "Perceptual_bg", "GAN"} <= set(train[0])
    opts = _opts(chain["bg"])
    assert opts["dataset"] == "eulerian_data_bg" and opts["MVloss"] == 1.0
    variables, jopt = import_checkpoint(chain["bg"])
    assert jopt.model_type == "bg" and set(variables["params"]) == {"net_bg"}
    popt = Options(W=32, ngf=16, model_type="bg")
    back = from_jax_variables(P.np_tree(variables), popt, BackgroundModel(popt))
    sd_bg = _sd(chain["bg"])
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), sd_bg[f"model.module.{k}"].numpy())
    # stage 3 took the port's own stage-2 net_bg (and trained it one step)
    rows3 = _rows(chain["stage3"])
    assert "RockRegionLoss" in [r for r in rows3 if r["split"] == "train"][0]


def test_stage3_warm_start_takes_the_port_bg(chain, tmp_path):
    """The warm start itself (before any step): stage 3's net_bg equals the
    port's stage-2 checkpoint's."""
    opt = Options(W=32, ngf=16, model_type=SLR_TYPE, **port_train.stage_options(SLR_TYPE))
    model, tr = port_train.build(opt, train_max_steps=6, device="cpu", seed=0)
    s1 = os.path.join(os.path.dirname(os.path.dirname(chain["stage3"])), "s1w",
                      "checkpoint.pth")
    port_train.warm_start(model, tr, s1, chain["bg"])
    bg = _sd(chain["bg"])
    n = 0
    for k, v in model.state_dict().items():
        if k.startswith("net_bg."):
            assert torch.equal(v, bg[f"model.module.{k}"]), k
            n += 1
    assert n > 10


def test_motion_gan_cli(chain):
    rows = _rows(chain["motion"])
    train = [r for r in rows if r["split"] == "train"][0]
    assert {"EndPointError", "PSNR_motion", "GAN", "D_Fake"} <= set(train)
    assert "Perceptual" not in train
    opts = _opts(chain["motion"])
    assert opts["dataset"] == "eulerian_data_motion_hint" and opts["use_online_hint"]
    assert opts["motion_losses"] == ["10.0_EndPointError"] and opts["motion_num_filters"] == 4
    variables, jopt = import_checkpoint(chain["motion"])
    assert jopt.model_type == "SPADE_unet_mask_motion"
    assert set(variables["params"]) == {"motion_predictor"}
    d = _sd(chain["motion"])["netD.netD.discriminator_0.model0.0.weight"]
    assert d.shape[1] == 2  # the motion D takes 2 channels


def _regressor(sd):
    head = "model.module.motion_regressor."
    return {k[len(head):]: v for k, v in sd.items() if k.startswith(head)}


def _embedded_back(ckpt):
    sd = load_torch_checkpoint(ckpt)["state_dict"]
    _, jopt = import_checkpoint(ckpt)
    assert jopt.train_motion
    variables = import_embedded_baseline(sd, jopt)
    popt = Options(**{k: (tuple(v) if isinstance(v, list) else v)
                      for k, v in _opts(ckpt).items()})
    model = BaselineMotionTrainable(popt)
    back = from_jax_variables(P.np_tree(variables), popt, model)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), sd[f"model.module.{k}"].numpy(), err_msg=k)


def test_fixmotion_cli(chain):
    rows = _rows(chain["fix"])
    train = [r for r in rows if r["split"] == "train"][0]
    assert {"EndPointError", "L1", "Perceptual"} <= set(train)
    opts = _opts(chain["fix"])
    assert opts["dataset"] == "eulerian_data_hint" and opts["freeze_motion"]
    assert opts["motion_losses"] == ["1.0_EndPointError"] and opts["train_motion"]
    _embedded_back(chain["fix"])
    # the regressor is the motion GAN's, bit for bit, after a frozen step
    motion = {k[len("model.module."):]: v for k, v in _sd(chain["motion"]).items()
              if k.startswith("model.module.motion_predictor.")}
    reg = _regressor(_sd(chain["fix"]))
    params = [k for k in reg if not k.endswith(("weight_u", "weight_v"))]
    assert params and all(torch.equal(reg[k], motion[k]) for k in params)
    # the fluid nets trained from stage 1's
    s1, fix = _sd(chain["stage1"]), _sd(chain["fix"])
    k = "model.module.encoder.gblocks.0.ch_a.2.weight_orig"
    assert not torch.equal(s1[k], fix[k])


def test_joint_cli_and_render_with_its_regressor(chain):
    rows = _rows(chain["joint"])
    assert "EndPointError" in [r for r in rows if r["split"] == "train"][0]
    assert not _opts(chain["joint"])["freeze_motion"]
    _embedded_back(chain["joint"])
    fix, joint = _regressor(_sd(chain["fix"])), _regressor(_sd(chain["joint"]))
    moved = [k for k in fix if not k.endswith(("weight_u", "weight_v"))
             and not torch.equal(fix[k], joint[k])]
    assert moved  # the unfrozen regressor trained
    r = port_render.SceneRenderer(ckpt=chain["joint"], motion_ckpt=chain["joint"], W=256,
                                  n_frames=2, decode_batch=2, device="cpu")
    rng = np.random.default_rng(3)
    img = rng.uniform(-1, 1, (256, 256, 3)).astype(np.float32)
    flow = np.zeros((256, 256, 2), np.float32)
    flow[128:, :, 0] = 1.0
    motion = r.regress_motion(img, flow)
    assert motion.shape == (256, 256, 2) and np.isfinite(motion).all()
    got = r.frames(img, motion).numpy()
    assert got.shape == (2, 256, 256, 3) and np.isfinite(got).all()


def test_cli_argument_rules(fixture_root, tmp_path):
    base = ["--data-root", fixture_root, "--out", str(tmp_path), "--device", "cpu"]
    for bad in (["--init-motion-from", "m.pth", "--embed-motion"],
                ["--init-from", "s.pth", "--init-motion-from", "m.pth"],
                ["--freeze-motion"]):
        with pytest.raises(SystemExit):
            port_train.main(base + bad)


def test_stage_defaults_match_jax():
    assert port_train.default_dataset("bg") == "eulerian_data_bg"
    assert port_train.default_dataset("unet_motion") == "eulerian_data_motion_hint"
    assert port_train.default_dataset("softmax_splating", True) == "eulerian_data_hint"
    assert port_train.stage_options("bg")["MVloss"] == 1.0
    assert port_train.stage_options("unet_motion")["use_online_hint"]
    assert port_train.stage_options("SPADE_unet_mask_motion")["motion_losses"] == (
        "10.0_EndPointError",)
    assert port_train.stage_options("softmax_splating", True)["motion_losses"] == (
        "1.0_EndPointError",)
    assert "motion_losses" not in port_train.stage_options("softmax_splating")
