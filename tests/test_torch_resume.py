"""Resumable training (``io/checkpoint.py``, ``cli/train.py``) on the CPU.

* The port's ``.pth`` holds both Adam states in ``torch.optim.Adam``'s
  layout; the JAX ``import_optimizer_states`` reads them (moments equal to
  the port's, the count carried), and one more step in each framework
  from there agrees: losses within 1e-4 relative, gradients within 2.5e-4
  of each sub-network's largest entry (tests/torch_stage_parity.py).
* A reference-style ``.pth`` written by ``torch.optim.Adam`` loads into the
  port's Adam: moments bit for bit, the count, and the next update within
  1e-6 of the parameter change plus two float32 ulps of the parameter (the
  two write the same update with other roundings: torch divides by sqrt
  of the second bias correction, optax corrects both moments first; the
  sum with the parameter then rounds).
* Restore then step equals step, bit for bit, BN noise on: the resume file
  carries weights, buffers, both Adam states, the count and the noise
  generator's state.
* The CLI: SIGUSR1 in a subprocess saves at epoch - 1 and exits; ``--resume``
  continues at the saved epoch + 1 and step + 1 from tensors bit-equal to
  the saved ones; a finished run writes HALT and a run that finds it
  returns at once; the best checkpoint follows the validation Perceptual
  loss and is copied to ``checkpoint_best{epoch}.pth`` at epoch 50; the
  validation images are written as PNG grids."""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import torch_stage_parity as P
from conftest import tiny_batch
from slrsfs_tpu.io.checkpoint import (
    import_baseline_model,
    import_discriminator,
    import_optimizer_states,
    load_torch_checkpoint,
)
from slrsfs_tpu_torch.cli import train as port_train
from slrsfs_tpu_torch.config import Options
from slrsfs_tpu_torch.engine.trainer import Trainer
from slrsfs_tpu_torch.io import checkpoint as ckpt_io
from slrsfs_tpu_torch.io.convert import from_jax_variables
from slrsfs_tpu_torch.models.baseline import BaselineTrainable
from slrsfs_tpu_torch.nn.discriminators import MultiscaleDiscriminator
from slrsfs_tpu_torch.nn.vgg import VGG19Features

torch.set_num_threads(1)

T = 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--W", "32", "--ngf", "8", "--refine-model-type",
        "resnet_TinyTest_de_resnet_pconv2_nonorm", "--out-channel", "9", "--ndf", "8",
        "--num-D", "1", "--n-layers-D", "2", "--batch-size", "2", "--val-steps", "1",
        "--train-max-steps", "12", "--device", "cpu"]


def _port_trainer(base, state, deterministic=True):
    opt = Options(**base["opt"].__dict__)
    model = BaselineTrainable(opt, train_max_steps=T)
    d = MultiscaleDiscriminator(opt)
    P.load_port(model, d, opt, state)
    vgg = VGG19Features()
    vgg.load_state_dict(from_jax_variables(P.np_tree(base["trainer"].vgg_vars), opt, vgg))
    return Trainer(opt, model, steps_per_epoch=10, vgg=vgg, d_model=d,
                   deterministic=deterministic, device="cpu")


def _save(tr, path, epoch=0, **meta):
    ckpt_io.save_checkpoint(path, tr.model, tr.d_model, tr.opt, epoch=epoch, trainer=tr,
                            meta={"best_perceptual": 1.0, **meta})


def test_jax_reads_the_ports_optimizer_states_and_steps_alike(base_trainer, tmp_path):
    jtr, batch = base_trainer["trainer"], base_trainer["batch"]
    state = P.settled_state(base_trainer["state"])
    tr = _port_trainer(base_trainer, state)
    pb = P.port_batch(batch)
    tr.train_step(pb)
    path = str(tmp_path / "resume.pth")
    _save(tr, path)

    ckpt = load_torch_checkpoint(path)
    assert ckpt["step"] == 1 and set(ckpt["optimizerG"]["state"]) == set(
        range(len(tr.g_names)))
    jopt = base_trainer["opt"]
    g_vars = import_baseline_model(ckpt["state_dict"], jopt)
    d_vars = import_discriminator(ckpt["state_dict"], jopt)
    opt_g, opt_d, count = import_optimizer_states(
        ckpt, jopt, jtr.tx_g, g_vars["params"], tx_d=jtr.tx_d, d_params=d_vars["params"])
    assert count == 1 and int(P.adam_state(opt_g).count) == 1
    for adam, jstate, module, cols in (
            (tr.opt_g, opt_g, tr.model, {k: g_vars[k] for k in ("batch_stats", "spectral")}),
            (tr.opt_d, opt_d, tr.d_model, {"spectral": d_vars["spectral"]})):
        a = P.adam_state(jstate)
        for moment, mine in ((a.mu, adam.mu), (a.nu, adam.nu)):
            want = from_jax_variables(P.np_tree({"params": moment, **cols}), tr.opt, module)
            for (n, _), got in zip(module.named_parameters(), mine):
                assert torch.equal(got, want[n]), n
    js = state.replace(g_params=g_vars["params"], g_stats=g_vars["batch_stats"],
                       g_spectral=g_vars["spectral"], d_params=d_vars["params"],
                       d_spectral=d_vars["spectral"], opt_g=opt_g, opt_d=opt_d)
    (js1, jlogs), = P.jax_steps(jtr, js, batch, n=1)
    logs = tr.train_step(pb)
    assert tr.step_count == 2 and int(P.adam_state(js1.opt_g).count) == 2
    P.check_losses(logs, jlogs, ("L1", "GAN", "D_Fake"))
    groups = P.g_groups(tr.model)
    P.check_grads(tr.opt, tr.model, tr.d_model, js1, dict(zip(tr.g_names, tr.last_grads["g"])),
                  dict(zip([n for n, _ in tr.d_model.named_parameters()], tr.last_grads["d"])),
                  groups)


def test_a_torch_adam_checkpoint_loads_into_the_ports_adam():
    opt = Options(ngf=8, out_channel=9, W=32, ndf=8, num_D=1, n_layers_D=2,
                  refine_model_type="resnet_TinyTest_de_resnet_pconv2_nonorm")
    model, tr = port_train.build(opt, train_max_steps=T, device="cpu", seed=1,
                                 steps_per_epoch=10)
    ref = BaselineTrainable(opt, train_max_steps=T)
    ref.load_state_dict(model.state_dict())
    adam = torch.optim.Adam(ref.parameters(), lr=opt.lr_g, betas=(opt.beta1, opt.beta2))
    rng = np.random.default_rng(4)
    grads = [torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32) * 0.01)
             for p in ref.parameters()]
    for _ in range(3):
        for p, g in zip(ref.parameters(), grads):
            p.grad = g.clone()
        adam.step()
    ckpt = {"state_dict": {f"model.module.{k}": v for k, v in ref.state_dict().items()},
            "optimizerG": adam.state_dict()}
    assert ckpt_io.load_trainer_adam_states(tr, ckpt) == 3 == tr.step_count
    want = adam.state_dict()["state"]
    for i, (mu, nu) in enumerate(zip(tr.opt_g.mu, tr.opt_g.nu)):
        assert torch.equal(mu, want[i]["exp_avg"]) and torch.equal(nu, want[i]["exp_avg_sq"])
    model.load_state_dict(ref.state_dict())
    before = [p.detach().clone() for p in ref.parameters()]
    tr.opt_g.step(grads)
    for p, g in zip(ref.parameters(), grads):
        p.grad = g.clone()
    adam.step()
    for (n, p), q, b in zip(model.named_parameters(), ref.parameters(), before):
        q = q.detach().numpy()
        change = np.abs(q - b.numpy()).max()
        ulps = 2 * np.spacing(np.abs(q).max())  # the sum p + update rounds
        np.testing.assert_allclose(p.detach().numpy(), q, rtol=0, atol=1e-6 * change + ulps,
                                   err_msg=n)


def test_restore_then_step_equals_step_bit_for_bit(tmp_path):
    opt = Options(ngf=8, out_channel=9, W=32, ndf=8, num_D=1, n_layers_D=2,
                  refine_model_type="resnet_TinyTest_de_resnet_pconv2_nonorm")
    b1, b2 = (port_train.to_device_batch(
        {k: ([np.asarray(x) for x in v] if k == "images" else np.asarray(v))
         for k, v in tiny_batch(np.random.default_rng(s)).items()}, "cpu") for s in (1, 2))
    model_a, tr_a = port_train.build(opt, train_max_steps=T, device="cpu", seed=3)
    tr_a.train_step(b1)
    path = str(tmp_path / "checkpoint.pth")
    _save(tr_a, path, epoch=4, best_perceptual=0.25)
    logs_a = tr_a.train_step(b2)
    snap_a = tr_a.snapshot()

    model_b, tr_b = port_train.build(opt, train_max_steps=T, device="cpu", seed=3)
    with torch.no_grad():  # another state, which the resume must replace
        for p in model_b.parameters():
            p.add_(0.01)
    tr_b.train_step(b2)
    torch.randn(5, generator=tr_b.noise)
    meta = port_train.load_resume(path, model_b, tr_b)
    assert meta["epoch"] == 4 and meta["best_perceptual"] == 0.25 and meta["step"] == 1
    assert tr_b.step_count == 1
    logs_b = tr_b.train_step(b2)
    snap_b = tr_b.snapshot()
    assert {k: float(v) for k, v in logs_a.items()} == {k: float(v) for k, v in logs_b.items()}
    for which in ("g", "d"):
        for k, v in snap_a[which].items():
            assert torch.equal(v, snap_b[which][k]), (which, k)
    for (ca, mua, nua), (cb, mub, nub) in zip(snap_a["adam"], snap_b["adam"]):
        assert ca == cb == 2
        assert all(torch.equal(x, y) for x, y in zip(mua + nua, mub + nub))
    assert torch.equal(snap_a["noise"], snap_b["noise"])


def _stepped_trainer(opt, seed):
    """A trainer whose Adam states are all non-zero, at count 5."""
    model, tr = port_train.build(opt, train_max_steps=T, device="cpu", seed=seed)
    for adam in (tr.opt_g, tr.opt_d):
        adam.count = 5
        for t in adam.mu + adam.nu:
            t.fill_(0.5)
    return model, tr


def _adam_untouched(tr):
    return all(adam.count == 0 and all(not t.any() for t in adam.mu + adam.nu)
               for adam in (tr.opt_g, tr.opt_d))


@pytest.mark.parametrize("case", ["stage1_into_slr", "d_does_not_fit"])
def test_an_optimizer_import_that_does_not_fit_changes_nothing(case, tmp_path, capsys):
    """``--init-from`` a checkpoint whose Adam states do not fit: both states
    stay as they were (zero moments, count 0), as JAX skips the whole import
    when it raises. A stage-1 file into SLR stage 3 shares the encoder's and
    projector's names and fails only at ``net_bg.*``; a file whose G state
    fits but whose D state does not must not keep G's."""
    from slrsfs_tpu.config import Options as JaxOptions
    from slrsfs_tpu_torch.models.slr import SLR_MODEL_TYPE

    base = dict(W=32, ngf=16)
    s1_model, s1 = _stepped_trainer(Options(**base), seed=1)
    path = str(tmp_path / "stage1.pth")
    _save(s1, path)
    if case == "stage1_into_slr":
        kw = dict(base, model_type=SLR_MODEL_TYPE, **port_train.stage_options(SLR_MODEL_TYPE))
        with pytest.raises(Exception):  # JAX's importer refuses the same file
            import_optimizer_states(load_torch_checkpoint(path), JaxOptions(**kw), None, None)
    else:
        kw = base
        ckpt = torch.load(path, weights_only=False)
        ent = ckpt["optimizerD"]["state"][0]
        ent["exp_avg"] = ent["exp_avg"][:1]
        torch.save(ckpt, path)
    model, tr = port_train.build(Options(**kw), train_max_steps=T, device="cpu", seed=2)
    port_train.warm_start(model, tr, path)
    assert "optimizer-state import skipped" in capsys.readouterr().out
    assert _adam_untouched(tr) and tr.step_count == 0
    if case == "stage1_into_slr":  # the weights still load
        enc = {k: v for k, v in s1_model.state_dict().items() if k.startswith("encoder.")}
        assert enc and all(torch.equal(model.state_dict()[k], v) for k, v in enc.items())


def test_a_weights_only_checkpoint_is_no_resume_file(tmp_path):
    opt = Options(ngf=8, out_channel=9, W=32, ndf=8, num_D=1, n_layers_D=2,
                  refine_model_type="resnet_TinyTest_de_resnet_pconv2_nonorm")
    model, tr = port_train.build(opt, train_max_steps=T, device="cpu", seed=3)
    path = str(tmp_path / "checkpoint.pth")
    ckpt_io.save_checkpoint(path, model, tr.d_model, opt, epoch=2)
    assert port_train.load_resume(path, model, tr) is None
    assert port_train.load_resume(str(tmp_path / "none.pth"), model, tr) is None


def _rows(out):
    with open(os.path.join(out, "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def preempted(fixture_root, tmp_path_factory):
    """A CLI run in a subprocess sent SIGUSR1 after its second step."""
    out = str(tmp_path_factory.mktemp("preempt") / "run")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("SLURM_JOB_ID", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "slrsfs_tpu_torch.cli.train", "--data-root", fixture_root,
         "--out", out, "--niter", "1", "--niter-decay", "0", "--steps-per-epoch", "500",
         *TINY], cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    log = os.path.join(out, "scalars.jsonl")
    t0 = time.time()
    while time.time() - t0 < 240:
        if proc.poll() is not None:
            break
        if os.path.exists(log) and len(_rows(out)) >= 2:
            proc.send_signal(signal.SIGUSR1)
            break
        time.sleep(0.2)
    text, _ = proc.communicate(timeout=240)
    return out, proc.returncode, text


def test_sigusr1_saves_at_the_previous_epoch_and_exits(preempted):
    out, rc, text = preempted
    assert rc == 0, text
    assert "preemption signal received" in text
    ckpt = torch.load(os.path.join(out, "checkpoint.pth"), weights_only=False)
    rows = _rows(out)
    assert ckpt["epoch"] == -1 and ckpt["step"] == len(rows) >= 2
    assert ckpt["step"] < 500 and all(r["split"] == "train" for r in rows)
    assert not os.path.exists(os.path.join(out, "HALT"))


def test_resume_continues_from_the_saved_tensors(preempted, fixture_root):
    out = preempted[0]
    path = os.path.join(out, "checkpoint.pth")
    saved = torch.load(path, weights_only=False)
    opt = Options(ngf=8, out_channel=9, W=32, ndf=8, num_D=1, n_layers_D=2,
                  refine_model_type="resnet_TinyTest_de_resnet_pconv2_nonorm")
    model, tr = port_train.build(opt, train_max_steps=12, device="cpu", seed=5)
    meta = port_train.load_resume(path, model, tr)
    assert meta["epoch"] == -1
    sd = saved["state_dict"]
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[f"model.module.{k}"]), k
    for k, v in tr.d_model.state_dict().items():
        assert torch.equal(v, sd[f"netD.netD.{k}"]), k
    assert tr.step_count == saved["step"]
    for i, (mu, nu) in enumerate(zip(tr.opt_g.mu, tr.opt_g.nu)):
        ent = saved["optimizerG"]["state"][i]
        assert torch.equal(mu, ent["exp_avg"]) and torch.equal(nu, ent["exp_avg_sq"])
    assert torch.equal(tr.noise.get_state(), saved["noise_state"])

    n_before = len(_rows(out))
    port_train.main(["--data-root", fixture_root, "--out", out, "--resume",
                     "--niter", "1", "--niter-decay", "0", "--steps-per-epoch", "2", *TINY])
    rows = _rows(out)[n_before:]
    train = [r for r in rows if r["split"] == "train"]
    assert [r["epoch"] for r in train] == [0, 0]
    assert [r["step"] for r in train] == [saved["step"] + 1, saved["step"] + 2]
    assert [r["split"] for r in rows] == ["train", "train", "val"]
    ckpt = torch.load(path, weights_only=False)
    assert ckpt["epoch"] == 0 and ckpt["step"] == saved["step"] + 2
    assert ckpt["best_perceptual"] == rows[-1]["Perceptual"]
    assert os.path.exists(os.path.join(out, "checkpoint_best.pth"))
    for key in ("PredImg", "GTMotion", "Z_f"):
        assert os.path.exists(os.path.join(out, "images", f"epoch0000_{key}.png")), key

    # finished: HALT written, and a later run returns at once
    assert os.path.exists(os.path.join(out, "HALT"))
    n_done = len(_rows(out))
    assert port_train.main(["--data-root", fixture_root, "--out", out, "--resume",
                            *TINY]) == path
    assert len(_rows(out)) == n_done


def test_best_checkpoint_is_copied_at_epoch_50(preempted, fixture_root, tmp_path):
    """A resume file forged at epoch 49 with no best yet: epoch 50 improves
    the best, writes checkpoint_best.pth and copies it to
    checkpoint_best50.pth."""
    src = torch.load(os.path.join(preempted[0], "checkpoint.pth"), weights_only=False)
    out = str(tmp_path / "run")
    os.makedirs(out)
    src.update(epoch=49, best_perceptual=float("inf"))
    torch.save(src, os.path.join(out, "checkpoint.pth"))
    port_train.main(["--data-root", fixture_root, "--out", out, "--resume",
                     "--niter", "51", "--niter-decay", "0", "--steps-per-epoch", "1", *TINY])
    rows = _rows(out)
    assert [r["epoch"] for r in rows] == [50, 50]
    best = torch.load(os.path.join(out, "checkpoint_best.pth"), weights_only=False)
    assert best["epoch"] == 50 and best["best_perceptual"] == rows[-1]["Perceptual"]
    with open(os.path.join(out, "checkpoint_best.pth"), "rb") as f, \
            open(os.path.join(out, "checkpoint_best50.pth"), "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("job, procid, calls", [(None, None, 0), ("77", "0", 1),
                                                ("77", "1", 0)])
def test_requeue_only_from_rank_0_of_a_slurm_job(monkeypatch, job, procid, calls):
    seen = []
    monkeypatch.setattr(port_train.subprocess, "run", lambda cmd, **kw: seen.append(cmd))
    for name, value in (("SLURM_JOB_ID", job), ("SLURM_PROCID", procid)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    port_train.trigger_job_requeue()
    assert seen == [["scontrol", "requeue", "77"]] * calls


def test_image_grids_map_images_flows_and_masks():
    rng = np.random.default_rng(0)
    pred = {"PredImg": torch.full((3, 4, 5, 3), -1.0), "GTMotion": torch.from_numpy(
        rng.standard_normal((3, 4, 5, 2)).astype(np.float32)),
        "Z_f": torch.full((3, 4, 5, 1), 0.5), "Wide": torch.zeros((3, 4, 5, 7)),
        "Scalar": torch.zeros(())}
    grids = port_train.image_grids(pred, n=2)
    assert set(grids) == {"PredImg", "GTMotion", "Z_f"}
    for g in grids.values():
        assert g.shape == (4, 10, 3) and g.dtype == np.uint8
    assert (grids["PredImg"] == 0).all()  # -1 maps to 0
    assert (grids["Z_f"] == 128).all()  # a 1-channel map stays in [0, 1]
    assert grids["GTMotion"].std() > 0
