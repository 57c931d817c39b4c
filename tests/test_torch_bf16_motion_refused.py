"""bf16 training with an embedded motion regressor: neither package runs it.

The JAX trainer casts G's parameters to bf16 but keeps ``batch["motions"]``
in f32 (``slrsfs_tpu/engine/trainer.py:217-222``), so the moving-region
mask that the embedded regressor reads stays f32 while its weights are
bf16, and the regressor's first convolution raises a ``TypeError``
(``slrsfs_tpu/nn/conv.py:42``, reached from ``models/motion.py:147``).
The port refuses the combination up front with a ``ValueError``. The day
the JAX step runs, the second test fails and says so."""

import numpy as np
import pytest
import torch

import jax

from conftest import tiny_options
from slrsfs_tpu.engine.trainer import Trainer as JaxTrainer
from slrsfs_tpu.models import baseline as jbase
from slrsfs_tpu_torch.config import Options
from slrsfs_tpu_torch.engine.trainer import Trainer
from slrsfs_tpu_torch.models import baseline as pbase

torch.set_num_threads(1)

B, HW, T = 2, 32, 4
MOTION = dict(W=HW, motionW=HW, motionH=HW, train_motion=True, batch_size=B,
              train_compute_dtype="bfloat16",
              motion_losses=("1.0_EndPointError", "0.5_MotionL1"))


def test_the_port_refuses_bf16_with_an_embedded_regressor():
    opt = Options(ngf=8, out_channel=9, motion_num_filters=4, motion_unet_downs=4,
                  refine_model_type="resnet_TinyTest_de_resnet_pconv2_nonorm", **MOTION)
    model = pbase.BaselineMotionTrainable(opt, train_max_steps=T)
    with pytest.raises(ValueError, match="the JAX package does not run it either"):
        Trainer(opt, model, device="cpu", extra_losses_fn=pbase.baseline_motion_extra_losses)


def test_the_jax_trainer_cannot_run_bf16_with_an_embedded_regressor():
    jopt = tiny_options(**MOTION)
    jtr = JaxTrainer(jopt, jbase.BaselineMotionTrainable(jopt, train_max_steps=T),
                     steps_per_epoch=10, extra_losses_fn=jbase.baseline_motion_extra_losses)
    rng = np.random.default_rng(5)
    idx = np.zeros((B, 3), np.int32)
    idx[:, 1] = 2
    idx[:, 2] = 4
    motions = (rng.standard_normal((B, HW, HW, 2)) * 0.8).astype(np.float32)
    hints = (motions * (rng.random((B, HW, HW, 1)) < 0.2)).astype(np.float32)
    batch = {"images": [jax.numpy.asarray((rng.standard_normal((B, HW, HW, 3)) * 0.25)
                                          .astype(np.float32)) for _ in range(3)],
             "index": jax.numpy.asarray(idx), "motions": jax.numpy.asarray(motions),
             "hints": jax.numpy.asarray(hints)}
    state = jtr.init_state(jax.random.PRNGKey(0), batch)
    step = jtr.make_train_step()
    with pytest.raises(TypeError, match="conv_general_dilated requires arguments to have "
                                        "the same dtypes"):
        step(state, batch, jax.random.PRNGKey(1))
