"""Single-layer animating model (PyTorch port of
``slrsfs_tpu/models/baseline.py``): encoder → symmetric double-ended softmax
splat → partial-conv decoder, the (start, middle, end) training pass of
``BaselineTrainable``, and ``BaselineMotionTrainable``, the same pass with
the splat flow predicted by an embedded motion regressor (the fix-motion
finetune and the unfrozen joint stage). Public tensors are NHWC, as in the
JAX package. ``train`` and ``noise`` are the switches of ``nn/norm.py``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from slrsfs_tpu_torch.config import Options
from slrsfs_tpu_torch.losses.synthesis import MotionLoss
from slrsfs_tpu_torch.nn.archs import get_resnet_arch
from slrsfs_tpu_torch.nn.norm import l2_normalize
from slrsfs_tpu_torch.nn.resnets import ResNetDecoderPconv2, ResNetEncoderWithZ
from slrsfs_tpu_torch.ops.euler import (
    euler_integrate_phased,
    euler_integrate_phased_compact,
    euler_integrate_phased_compact_plain,
    euler_integrate_phased_plain,
)
from slrsfs_tpu_torch.ops.maxwarp import maximum_warp_norm_splat
from slrsfs_tpu_torch.ops.splat import (
    NORM_EPS,
    softsplat_sum,
    softsplat_sum_plain,
    softsplat_sum_plain_vjp,
)

Tensor = torch.Tensor


def _nchw(x: Tensor) -> Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: Tensor) -> Tensor:
    return x.permute(0, 2, 3, 1)


def feature_width(opt: Options) -> int:
    """Width of the encoder features the splat carries."""
    return get_resnet_arch(opt.refine_model_type, opt, 3)["layers_enc"][-1]


class BaselineModel(nn.Module):
    """``encoder`` and ``projector`` (the decoder), named as in the reference
    checkpoint."""

    def __init__(self, opt: Options):
        super().__init__()
        self.opt = opt
        self.encoder = ResNetEncoderWithZ(opt, in_channels=3)
        self.projector = ResNetDecoderPconv2(opt, in_channels=feature_width(opt))

    def encode(self, img: Tensor, train: bool = False,
               noise: Optional[torch.Generator] = None):
        """img (B, H, W, 3) → (features (B, H, W, C), Z (B, H, W, 1))."""
        fs, z = self.encoder(_nchw(img), train, noise)
        if "relu" in self.opt.Z_model:
            z = torch.relu(z)
        return _nhwc(fs), _nhwc(z)

    def decode(self, gen_fs: Tensor, train: bool = False,
               noise: Optional[torch.Generator] = None) -> Tensor:
        """(B, H, W, C) → (B, H, W, 3) in [-1, 1]. An NHWC-contiguous input
        reaches the convs as a channels_last NCHW view, without a copy."""
        return _nhwc(torch.tanh(self.projector(_nchw(gen_fs), train, noise)))

    def forward(self, img: Tensor, train: bool = False,
                noise: Optional[torch.Generator] = None):
        """The JAX ``__call__`` (the pass ``settle`` runs): encode, then
        decode the features."""
        fs, z = self.encode(img, train, noise)
        return self.decode(fs, train, noise), z


@torch.no_grad()
def init_random_weights(model: nn.Module, seed: int,
                        power_iters: int = 30) -> None:
    """Seeded random weights for a model built on the CPU (baseline or SLR:
    every conv and dense layer in ``model.modules()``): LeCun-normal
    kernels, zero biases, BN statistics (0, 1).

    Random spectral vectors would give a sigma far from the true spectral
    norm and a deep stack that overflows, so ``power_iters`` power
    iterations on each fresh kernel set (u, v) close to its top singular
    pair. ``engine/init_utils.py:settle`` then runs the train-mode passes
    the JAX package runs (the random-weight renderer does)."""
    g = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        params = mod._parameters
        w = params.get("weight_orig", params.get("weight"))
        if w is None:
            continue
        w.copy_(torch.randn(w.shape, generator=g) / w[0].numel() ** 0.5)
        if params.get("bias") is not None:
            params["bias"].zero_()
        if "weight_orig" in params:
            w_mat = w.reshape(w.shape[0], -1)
            u = l2_normalize(torch.randn(w.shape[0], generator=g))
            for _ in range(power_iters):
                v = l2_normalize(w_mat.t() @ u)
                u = l2_normalize(w_mat @ v)
            mod.weight_u.copy_(u)
            mod.weight_v.copy_(v)


def z_normalize(opt: Options, z: Tensor, flow: Tensor = None, mesh=None) -> Tensor:
    """Reference Z-norm variants (animating_softmax_splating.py:593-605).

    z (B, H, W, 1); flow (B, H, W, 2) f32, needed only for v2, whose
    per-source maximum-warp norm runs through K6. The default variant
    subtracts the batch's maximum: with a ``mesh`` of more than one rank,
    the global batch's (``parallel.mesh.all_reduce_max``), as the JAX
    maximum over a sharded batch."""
    if opt.use_softmax_splatter_v2:
        if flow is None:
            raise ValueError("the v2 Z-norm needs the flow")
        # the maximum carries no gradient (JAX stops it)
        zn = z - maximum_warp_norm_splat(z.detach().contiguous(),
                                         flow.contiguous())
    elif opt.use_softmax_splatter_v1:
        zn = z
    elif opt.use_softmax_splatter_v3:
        zn = torch.sigmoid(z) * 20.0
    elif mesh is not None and mesh.world > 1:
        from slrsfs_tpu_torch.parallel.mesh import all_reduce_max

        zn = z - all_reduce_max(z.max(), mesh)
    else:
        zn = z - z.max()
    if not opt.no_clamp_Z:
        zn = zn.clamp(-20.0, 20.0)
    return zn


def pack_splat_input(fs: Tensor, z_norm: Tensor) -> Tensor:
    """[fs·e^Z, e^Z]: the packed tensor whose summation splat implements
    softmax splatting after normalisation (reference :606,628-634)."""
    ez = torch.exp(z_norm).to(fs.dtype)
    return torch.cat([fs * ez, ez], dim=-1)


def splat_blend(u_f: Tensor, flow_f: Tensor, alpha, u_p: Tensor,
                flow_p: Tensor, plain: bool = False) -> Tensor:
    """Double-ended dense splat + joint normalisation (reference :606-692):
    two ``softsplat_sum`` (K3 on the card), or with ``plain`` two
    ``softsplat_sum_plain``."""
    splat = softsplat_sum_plain if plain else softsplat_sum
    g = splat(u_f, flow_f) * alpha + splat(u_p, flow_p) * (1.0 - alpha)
    return g[..., :-1] / torch.clamp(g[..., -1:], min=NORM_EPS)


def z_for_splat(opt: Options, fs: Tensor, z: Tensor) -> Tensor:
    """train_Z gate: without it Z is all-ones (reference :588-590)."""
    if opt.train_Z:
        return z
    return torch.ones_like(fs[..., :1])


def fold_uvm(motion: Tensor) -> Tensor:
    """uv·m 3-channel motion → 2-channel flow (reference
    animating_softmax_splating.py:524-543); 2-channel motion passes."""
    if motion.shape[-1] == 3:
        return motion[..., :2] * motion[..., 2:3]
    return motion


def train_integrate(batch: Dict, flow: Tensor, tf_c: Tensor, tp_c: Tensor,
                    T: int, plain: bool = False) -> Tuple[Tensor, Tensor]:
    """Phase-switched training integration of every sample (K7): the
    compact moving-set form when the batch carries ``mov_pos`` (B, P, 2)
    int32 / ``mov_valid`` (B, P) f32 (``cli/train.py:attach_moving_sets``),
    else the dense form. ``plain`` runs K7's plain versions."""
    flow = flow.contiguous()
    if "mov_pos" in batch:
        fn = (euler_integrate_phased_compact_plain if plain
              else euler_integrate_phased_compact)
        return fn(flow, batch["mov_pos"], batch["mov_valid"], tf_c, tp_c, T)
    fn = euler_integrate_phased_plain if plain else euler_integrate_phased
    return fn(flow, tf_c, tp_c, T)


class BaselineTrainable(BaselineModel):
    """Adds the (start, middle, end) training pass (reference
    ``AnimatingSoftmaxSplating.forward``, animating_softmax_splating.py:
    445-775): one phase-switched integration of ``train_max_steps`` steps
    per sample (K7) and two summation splats with their gather VJPs (K3).
    ``mesh`` (``parallel.mesh.attach``): the data-parallel group whose
    batch ``z_normalize``'s maximum spans."""

    mesh = None

    def __init__(self, opt: Options, train_max_steps: int = 60):
        super().__init__(opt)
        self.train_max_steps = train_max_steps

    def forward_train(self, batch: Dict, train: bool = True,
                      deterministic: bool = False,
                      noise: Optional[torch.Generator] = None,
                      plain: bool = False):
        """batch: ``images`` [start, middle, end] (B, H, W, 3), ``index``
        (B, 3) int [start, middle, end], ``motions`` (B, H, W, 2|3) f32,
        optionally ``mov_pos``/``mov_valid`` and ``ff_mask`` (B, H, W, 1),
        the free-form occlusion keep-mask. The BN noise comes from the
        generator ``noise`` unless ``deterministic``. ``plain`` runs the K3
        and K7 plain versions on any device. Returns (gen_img, pred)."""
        if not deterministic and noise is None:
            raise ValueError("forward_train needs a noise generator unless "
                             "deterministic")
        noise = None if deterministic else noise
        opt = self.opt
        start_img, middle_img, end_img = batch["images"]
        idx = batch["index"]
        flow = fold_uvm(batch["motions"])
        B = flow.shape[0]

        # two encodes in this order: each runs its own power iterations and
        # BN-statistics updates, the second from the state the first left
        fs_s, z_f = self.encode(start_img, train, noise)
        fs_e, z_p = self.encode(end_img, train, noise)

        t_f = (idx[:, 1] - idx[:, 0]).to(torch.int32)
        t_p = (idx[:, 2] + 1 - idx[:, 1]).to(torch.int32)
        T = self.train_max_steps
        tf_c = t_f.clamp(0, T)
        tp_c = torch.minimum(t_p.clamp(min=0), T - tf_c)
        flow_f, flow_p = train_integrate(batch, flow, tf_c, tp_c, T, plain)

        alpha = (1.0 - (idx[:, 1] - idx[:, 0]).to(fs_s.dtype)
                 / (idx[:, 2] - idx[:, 0] + 1).to(fs_s.dtype)).reshape(B, 1, 1, 1)
        z_f = z_for_splat(opt, fs_s, z_f)
        z_p = z_for_splat(opt, fs_e, z_p)
        # each end normalises with its own flow (reference :593-650)
        zn_f = z_normalize(opt, z_f, flow_f, self.mesh)
        zn_p = z_normalize(opt, z_p, flow_p, self.mesh)

        splat = softsplat_sum_plain_vjp if plain else softsplat_sum
        g = (splat(pack_splat_input(fs_s, zn_f), flow_f) * alpha
             + splat(pack_splat_input(fs_e, zn_p), flow_p) * (1.0 - alpha))
        feats = g[..., :-1]
        if "ff_mask" in batch:
            # the free-form occlusion mask multiplies the features, not the
            # normaliser (reference :680-692)
            feats = feats * batch["ff_mask"]
        gen_fs = feats / torch.clamp(g[..., -1:], min=NORM_EPS)
        gen_img = self.decode(gen_fs, train, noise)
        pred = {"PredImg": gen_img, "OutputImg": middle_img, "Z_f": zn_f,
                "GTMotion": flow}
        return gen_img, pred


class BaselineMotionTrainable(BaselineTrainable):
    """The baseline with an embedded motion regressor (reference
    ``train_motion`` branches, animating_softmax_splating.py:514-536): the
    splat flow comes from the regressor instead of the ground truth, and
    the motion losses join the total (``baseline_motion_extra_losses``).
    With ``opt.freeze_motion`` the prediction is detached (the fix-motion
    finetune) and the trainer leaves the regressor out of G's Adam;
    without it the synthesis loss's gradient reaches the regressor through
    dense K7's backward and K3's ``grad_flow`` (the unfrozen joint
    stage)."""

    def __init__(self, opt: Options, train_max_steps: int = 60):
        from slrsfs_tpu_torch.models.motion import MotionRegressor

        super().__init__(opt, train_max_steps)
        self.motion_regressor = MotionRegressor(opt)

    def forward_train(self, batch: Dict, train: bool = True,
                      deterministic: bool = False,
                      noise: Optional[torch.Generator] = None,
                      plain: bool = False):
        """``BaselineTrainable.forward_train`` on the regressor's motion
        from ``images[0]``, the ground truth's moving mask and ``hints``:
        the regressor predicts before the two encodes, as in JAX, at
        motionW x motionH, scaled by W/motionW and W/motionH for the splat.
        The moving sets are dropped (a predicted motion is dense). Adds
        ``PredMotion`` and ``GTMotionRaw`` (the batch's motion) to pred."""
        from slrsfs_tpu_torch.models.motion import moving_region_mask

        gt_motion = batch["motions"]
        mask = moving_region_mask(gt_motion)
        pred_scaled = self.motion_regressor.predict(
            batch["images"][0], mask, batch.get("hints"), train)
        if self.opt.freeze_motion:
            pred_scaled = pred_scaled.detach()
        scale = torch.tensor([self.opt.W / self.opt.motionW,
                              self.opt.W / self.opt.motionH],
                             dtype=pred_scaled.dtype, device=pred_scaled.device)
        batch = {k: v for k, v in batch.items() if k not in ("mov_pos", "mov_valid")}
        batch["motions"] = pred_scaled * scale
        gen_img, pred = super().forward_train(batch, train, deterministic, noise, plain)
        pred["PredMotion"] = pred_scaled
        pred["GTMotionRaw"] = gt_motion
        return gen_img, pred


def baseline_motion_extra_losses(opt: Options, pred: Dict[str, Tensor],
                                 synth_loss_fn=None, epoch=None) -> Dict[str, Tensor]:
    """The motion losses joining the fluid total (reference :748-754):
    ``MotionLoss`` of PredMotion against GTMotionRaw, logged; their total
    is "Total Extra", 0 when the regressor is frozen."""
    ml = MotionLoss(opt.motion_losses)(pred["PredMotion"], pred["GTMotionRaw"])
    out = {k: v for k, v in ml.items() if k != "Total Loss"}
    out["Total Extra"] = (torch.zeros((), device=ml["Total Loss"].device)
                          if opt.freeze_motion else ml["Total Loss"])
    return out
