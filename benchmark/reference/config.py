"""Typed configuration for the framework.

Mirrors the ~30 flags of the reference argparse tree that the shipped shell
scripts actually exercise (reference ``options/train_options.py``; the live
subset is documented in SURVEY.md §3.5/§5.6). Configs are serialized next to
checkpoints (the reference pickles its argparse namespace inside every .pth —
``train_animating.py:243-261``) so inference restores training-time settings.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass
class Options:
    # ---- model selection ---------------------------------------------------
    model_type: str = "softmax_splating"
    # architecture selector strings; substring matching mirrors the reference
    # (models/networks/utilities.py:18-73, configs.py:2)
    refine_model_type: str = "resnet_256W8UpDown64_de_resnet_pconv2_nonorm"
    bg_refine_model_type: str = "resnet_256W8UpDown64BG_nonorm"
    alpha_refine_model_type: str = "resnet_256W8UpDown64Layers_de_resnet_pconv2_nonorm"
    # arch-table key kept for checkpoint-opts parity; the motion UNets are
    # structural mirrors (models/motion.py) and do not read the table
    motion_refine_model_type: str = "resnet_256W4UpDown64Motion_nonorm"
    motion_model_type: str = "SPADE_unet_mask_motion"
    # width of the motion UNets. The reference hardcodes 32
    # (architectures.py:382,602); keep the default for parity — this knob
    # exists so mechanics tests can shrink the 8-down/8-up graphs, whose
    # min input (256²) makes them the suite's most expensive executions.
    motion_num_filters: int = 32
    # UNet depth (downsample count). Reference hardcodes 8; smaller depths
    # are the same mechanics-test knob as motion_num_filters — they cut the
    # minimum motion input from 256² to 2^downs squared.
    motion_unet_downs: int = 8

    ngf: int = 64
    out_channel: int = 65  # encoder output channels incl. the +1 Z channel
    W: int = 256  # square working resolution of the model
    motionW: int = 256
    motionH: int = 256

    norm_G: str = "sync:spectral_batch"
    pconv: str = "pconv_pbn_woresbias"

    # splatting / Z options (reference train_options.py:548,584-587,613)
    train_Z: bool = True
    use_softmax_splatter: bool = True
    use_softmax_splatter_v1: bool = False
    use_softmax_splatter_v2: bool = False
    use_softmax_splatter_v3: bool = False
    no_clamp_Z: bool = False
    Z_model: str = ""

    # noise-BN: when True the BigGAN noise vector is zeroed (deterministic);
    # inference always sets this (reference test_baseline_4eval.py:127)
    bn_noise_misc: bool = False

    addtional_decoder_input: int = 0  # [sic] reference spelling kept in spirit
    addtional_decoder_output: int = 0

    # ---- SLR two-layer options ---------------------------------------------
    use_alpha0_as_blending_weight: bool = False
    use_mask_as_alpha_input: bool = False
    use_bg_as_alpha_input: bool = False
    use_motion_as_alpha_input: bool = False  # reference flag name (:931)
    use_sum1_alpha: bool = False  # single-logit alpha head (:939-946)
    # composite variants (forward_flow :1066-1078 / forward :641-652)
    use_alpha_softmax: float = 0.0
    clamp_alpha: float = 0.0
    use_fluid_alpha_only: bool = False  # :423-426 / :1060-1063
    use_bg_alpha_only: bool = False
    AKLloss: float = 0.0
    ATVloss: float = 0.0
    ADCloss: float = 0.0
    MRADCloss: float = 0.0
    MVloss: float = 0.0
    FluidRegionloss: float = 0.0
    RockRegionloss: float = 0.0
    RockRegionlossDecay: float = 0.0
    RockRegionlosstarget: float = 0.25
    AlphaMSEloss: float = 0.0
    AlphaWeightDecay: float = 0.0  # per-epoch AlphaMSE decay (MSE training script :356)
    AlphaL1loss: float = 0.0
    balanced_weight: int = 1

    # free-form occlusion augmentation (train_options.py:569-574)
    random_ff_mask: bool = False
    random_ff_mask_rate: float = 0.5

    # ---- motion regressor ---------------------------------------------------
    train_motion: bool = False  # embed a motion regressor in the fluid model
    freeze_motion: bool = False  # fix-motion finetune: freeze its params
    use_mask_as_motion_input: bool = True
    use_hint_as_motion_input: bool = True
    div_flow: float = 1.0
    use_online_hint: bool = False
    motion_norm_G: str = "spectral_instance"

    # ---- losses / GAN --------------------------------------------------------
    losses: Tuple[str, ...] = ("1.0_l1", "10.0_content")
    motion_losses: Tuple[str, ...] = ("1.0_l1",)
    discriminator_losses: str = "pix2pixHD"
    gan_mode: str = "hinge"
    lambda_feat: float = 10.0
    ndf: int = 64
    num_D: int = 2
    n_layers_D: int = 4

    # ---- optimization ---------------------------------------------------------
    batch_size: int = 16
    lr_g: float = 1e-3 / 2
    lr_d: float = 1e-3 * 2
    beta1: float = 0.0
    beta2: float = 0.9
    niter: int = 100
    niter_decay: int = 10
    num_accumulations: int = 1  # micro-batches/step (base_model.py:95-163)
    # 'mean': grads averaged over micro-batches (sane default).
    # 'reference': each micro-batch loss scaled x num_accumulations and
    # grads summed, i.e. accum^2 x the mean — the reference's literal
    # loss/weight quirk (base_model.py:106,129-133). Only differs when
    # num_accumulations > 1.
    accum_scale: str = "mean"
    # 'float32' (default, reference numerics) or 'bfloat16': opt-in mixed
    # precision for the G forward/backward — f32 master params/optimizer,
    # model compute in bf16 (same cast the inference speed mode uses),
    # mutable BN/spectral state stored back as f32. No reference analog
    # (the reference trains f32); measured TPU speedup in GAPS.md.
    train_compute_dtype: str = "float32"
    seed: int = 0

    # ---- data -----------------------------------------------------------------
    dataset: str = "eulerian_data"
    use_mean_video: bool = False
    normalize_image: bool = True  # rescale logged *Img to [0,1] (base_model.py:110)

    # ---- checkpoint-opts compatibility only (NOT consumed) --------------------
    # These mirror reference argparse names so opts namespaces stored inside
    # .pth checkpoints import without loss; nothing in this framework reads
    # them (flow_* sizing is handled by data/transforms.py; use_rgb_features
    # and the motion arch-table key are unused by every shipped reference
    # config; the generic lr is superseded by lr_g/lr_d).
    lr: float = 1e-4
    flow_raw_W: int = 1920
    flow_raw_H: int = 1024
    flow_input_W: int = 480
    flow_input_H: int = 256
    use_rgb_features: bool = False

    def replace(self, **kw) -> "Options":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "Options":
        d = json.loads(s)
        known = {f.name for f in dataclasses.fields(cls)}
        kept = {k: v for k, v in d.items() if k in known}
        for k in ("losses", "motion_losses"):
            if k in kept and isinstance(kept[k], list):
                kept[k] = tuple(kept[k])
        return cls(**kept)


def spectral(opt: Options) -> bool:
    """'spectral' in norm_G selects spectrally-normalized convs
    (reference models/layers/blocks.py:25-38)."""
    return "spectral" in opt.norm_G


def partial_bn(opt: Options) -> bool:
    """'pbn' in pconv selects mask-aware BN in pconv blocks
    (reference models/layers/blocks.py:176-183)."""
    return "pbn" in opt.pconv


def woresbias(opt: Options) -> bool:
    return "woresbias" in opt.pconv
