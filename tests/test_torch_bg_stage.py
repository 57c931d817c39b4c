"""Stage 2, the background network (``--model-type bg``), against the JAX
package: ``models/slr.py:BackgroundModel`` and the port's
``Trainer(task='bg')`` against the JAX ``Trainer`` (tests/
torch_stage_parity.py's conventions and checks).

* ``forward`` and ``forward_train`` at the reference bg arch (ngf 16,
  W = 32, B = 2, numpy-drawn JAX variables): the background within 1e-4 of
  its largest magnitude, ``OutputImg`` the mean video, the BN statistics
  and spectral vectors within 1e-5; the keys are ``net_bg.*``, as stage 3
  takes them;
* two G+D steps at ``tiny_options`` with MVloss 1 and 2: the ``_bg`` loss
  keys and the MV-weighted total for both steps, gradients and parameters
  after the first, BN statistics and spectral vectors after both."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
from flax import linen as nn

import torch_stage_parity as P
from conftest import tiny_options
from slrsfs_tpu.config import Options as JaxOptions
from slrsfs_tpu.engine.trainer import Trainer as JaxTrainer
from slrsfs_tpu.models import slr as jslr
from slrsfs_tpu_torch.config import Options
from slrsfs_tpu_torch.engine.trainer import Trainer
from slrsfs_tpu_torch.io.convert import from_jax_variables
from slrsfs_tpu_torch.models import get_model
from slrsfs_tpu_torch.models import slr as pslr
from slrsfs_tpu_torch.nn.discriminators import MultiscaleDiscriminator
from slrsfs_tpu_torch.nn.vgg import VGG19Features

torch.set_num_threads(1)

B, HW = 2, 32


def bg_batch(seed: int):
    """Two views (start, end), counts and a mean video, as
    ``eulerian_data_bg`` gives them."""
    rng = np.random.default_rng(seed)
    idx = np.array([[1, 7, 7], [0, 9, 9]], np.int32)
    return {"images": [(rng.standard_normal((B, HW, HW, 3)) * 0.25).astype(np.float32)
                       for _ in range(2)],
            "index": idx,
            "motions": np.zeros((B, HW, HW, 2), np.float32),
            "mean_video": (rng.standard_normal((B, HW, HW, 3)) * 0.25).astype(np.float32)}


def test_background_model_matches_jax():
    jopt = JaxOptions(ngf=16, W=HW, model_type="bg", MVloss=1.0)
    popt = Options(**dataclasses.asdict(jopt))
    batch = bg_batch(2)
    jmodel = jslr.BackgroundModel(jopt)
    variables = P.numpy_init(jmodel, P.jnp_batch(batch), seed=9)

    @jax.jit
    def jforward(v, b):
        with nn.intercept_methods(P.zero_noise):
            return jmodel.apply(v, b, True, False, method=jmodel.forward_train,
                                mutable=["batch_stats", "spectral"],
                                rngs={"noise": jax.random.PRNGKey(2)})

    (jbg, want), ups = jforward(variables, P.jnp_batch(batch))
    model = get_model(popt)
    assert isinstance(model, pslr.BackgroundModel)
    assert all(k.startswith("net_bg.") for k in model.state_dict())
    model.load_state_dict(from_jax_variables(P.np_tree(variables), popt, model))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        bg, got = model.forward_train(P.port_batch(batch), train=True, deterministic=True)
    P.check_pred(got, P.np_tree(want))
    assert bg is got["PredImg"]
    after = from_jax_variables(P.np_tree({"params": variables["params"], **ups}), popt, model)
    params = {n for n, _ in model.named_parameters()}
    for name, t in model.state_dict().items():
        if name not in params:
            np.testing.assert_allclose(t.numpy(), after[name].numpy(), rtol=0, atol=1e-5,
                                       err_msg=name)
    # the eval forward: tanh(net_bg(img)) with the stored statistics
    model.load_state_dict(before)
    jeval = jmodel.apply(variables, P.jnp_batch(batch)["images"][0], False, True)
    with torch.no_grad():
        peval = model(torch.from_numpy(batch["images"][0]))
    np.testing.assert_allclose(peval.numpy(), np.asarray(jeval), rtol=0,
                               atol=1e-4 * float(np.abs(np.asarray(jeval)).max()))


@pytest.fixture(scope="module", params=[1.0, 2.0], ids=["mv1", "mv2"])
def runs(request, vgg_vars32):
    jopt = tiny_options(W=HW, batch_size=B, model_type="bg", MVloss=request.param)
    jtr = JaxTrainer(jopt, jslr.BackgroundModel(jopt), steps_per_epoch=10, task="bg")
    jtr.load_vgg(vgg_vars32)
    batch = bg_batch(5)
    state = P.settled_state(jtr.init_state(jax.random.PRNGKey(0), P.jnp_batch(batch)))
    jruns = P.jax_steps(jtr, state, batch)
    opt = Options(**dataclasses.asdict(jopt))
    model = pslr.BackgroundModel(opt)
    d = MultiscaleDiscriminator(opt)
    P.load_port(model, d, opt, state)
    vgg = VGG19Features()
    vgg.load_state_dict(from_jax_variables(P.np_tree(vgg_vars32), opt, vgg))
    tr = Trainer(opt, model, steps_per_epoch=10, vgg=vgg, d_model=d, deterministic=True,
                 device="cpu", task="bg")
    port = P.port_steps(tr, batch, sync=lambda k: P.sync_port(tr, opt, jruns[k - 1][0]))
    return dict(opt=opt, model=model, d=d, tr=tr, jax=jruns, port=port)


@pytest.mark.parametrize("k", [0, 1])
def test_bg_step_losses_match_jax(runs, k):
    got = runs["port"][k][0]
    P.check_losses(got, runs["jax"][k][1], ("L1_bg", "Perceptual_bg", "psnr", "ssim",
                                            "GAN", "D_Fake"))
    assert "L1" not in got


def test_bg_step_gradients_and_params_match_jax(runs):
    _, g, d, (sd_g, sd_d) = runs["port"][0]
    groups = P.g_groups(runs["model"])
    assert [n for n, _ in groups] == ["net_bg"]
    P.check_grads(runs["opt"], runs["model"], runs["d"], runs["jax"][0][0], g, d, groups)
    js = [s for s, _ in runs["jax"]]
    n = P.check_state(runs["opt"], sd_g, js, 0, runs["model"], "g", groups)
    n += P.check_state(runs["opt"], sd_d, js, 0, runs["d"], "d")
    assert n > 1000


def test_bg_second_step_stats_and_vectors_match_jax(runs):
    js = runs["jax"][1][0]
    sd_g, _ = runs["port"][1][3]
    want = from_jax_variables(P.np_tree({"params": js.g_params, "batch_stats": js.g_stats,
                                         "spectral": js.g_spectral}), runs["opt"],
                              runs["model"])
    params = {n for n, _ in runs["model"].named_parameters()}
    for name, t in sd_g.items():
        if name not in params:
            np.testing.assert_allclose(t.numpy(), want[name].numpy(), rtol=0,
                                       atol=P.STATE_TOL[0], err_msg=name)
