"""Reference ``.pth`` checkpoints ↔ the port's models.

A reference checkpoint is ``{state_dict, ..., opts}`` with the
hyperparameters pickled as an argparse namespace (``train_animating.py:
243-261``). The port's modules keep the reference's key names, so after the
key surgery of ``slrsfs_tpu/io/checkpoint.py:64-77`` the state_dict loads
directly; ``save_checkpoint`` writes the same layout from a training run.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Dict, List, Mapping, Optional, Tuple

import torch

from slrsfs_tpu_torch.config import Options

_DROP_KEYS = ("xyzs", "ones", "Z_predictor", "min_z", "max_z", "discretized_zs")


def opts_from_namespace(ns) -> Options:
    """argparse.Namespace (pickled in the checkpoint) → typed Options."""
    known = {f.name for f in dataclasses.fields(Options)}
    kw = {}
    for k, v in vars(ns).items():
        if k in known:
            kw[k] = tuple(v) if isinstance(v, list) else v
    return Options(**kw)


def _strip_prefixes(k: str, prefixes=("model.", "module.")) -> str:
    stripped = True
    while stripped:
        stripped = False
        for p in prefixes:
            if k.startswith(p):
                k, stripped = k[len(p):], True
    return k


def clean_state_dict(sd: Mapping) -> Dict:
    """Drop DataParallel/BaseModel prefixes and the keys the reference drops;
    apply the fix-motion remap (train_animating_fixmotion.py:438-446)."""
    out = {}
    for k, v in sd.items():
        k = _strip_prefixes(k)
        if any(part in _DROP_KEYS for part in k.split(".")):
            continue
        if k.startswith("motion_predictor."):
            k = "motion_regressor." + k
        out[k] = v
    return out


def load_model_state(model: torch.nn.Module, sd: Mapping) -> None:
    """Copy the model's tensors out of a cleaned state_dict. Keys the model
    does not have (training-only buffers, other heads) are ignored; a key the
    model needs and the checkpoint lacks raises."""
    own = model.state_dict()
    missing = [k for k in own if k not in sd]
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} keys, e.g. {missing[:3]}")
    model.load_state_dict({k: sd[k] for k in own})


def load_model_state_with_fallback(model: torch.nn.Module, sd: Mapping) -> List[str]:
    """``load_model_state`` by top-level submodule: a submodule none of whose
    keys the checkpoint holds keeps its current (initial) values, as the
    JAX ``import_slr_model(fallback=...)`` (:121) keeps the fresh alpha
    nets of a stage-3 warm start; a submodule that is only partly present
    raises. Returns the names of the submodules kept."""
    own = model.state_dict()
    groups: Dict[str, List[str]] = {}
    for k in own:
        groups.setdefault(k.split(".", 1)[0], []).append(k)
    kept = []
    merged = dict(own)
    for name, keys in groups.items():
        have = [k for k in keys if k in sd]
        if not have:
            kept.append(name)
            continue
        if len(have) < len(keys):
            missing = [k for k in keys if k not in sd]
            raise KeyError(f"checkpoint holds part of {name}: it lacks "
                           f"{len(missing)} keys, e.g. {missing[:3]}")
        merged.update({k: sd[k] for k in keys})
    model.load_state_dict(merged)
    return kept


def merge_stage3_state_dict(sd_baseline: Mapping, sd_bg: Mapping = None,
                            sd_motion: Mapping = None) -> Dict:
    """A warm start's merged state_dict (the JAX ``merge_stage3_state_dict``
    :97-118, reference train_animating_alpha_2layers_joint_finetuneBGFluid_L1
    .py:430-462): the stage-1 checkpoint's keys with the stage-2
    checkpoint's ``net_bg`` keys laid over them (SLR stage 3), and a motion
    checkpoint's ``motion_predictor`` keys under ``motion_regressor.``
    (the fix-motion finetune, train_animating_fixmotion.py:438-446). The
    SLR alpha nets have no keys in any; load the SLR result with
    ``load_model_state_with_fallback``, the embedded one with
    ``load_embedded_baseline``."""
    out = {_strip_prefixes(k): v for k, v in sd_baseline.items()}
    if sd_bg is not None:
        out.update({_strip_prefixes(k): v for k, v in sd_bg.items() if "net_bg" in k})
    if sd_motion is not None:
        for k, v in sd_motion.items():
            k = _strip_prefixes(k)
            if "motion_predictor" in k and "motion_regressor" not in k:
                out["motion_regressor." + k] = v
    return out


def load_embedded_baseline(model: torch.nn.Module, sd: Mapping) -> bool:
    """Load a ``BaselineMotionTrainable`` from a cleaned state_dict by the
    JAX ``import_embedded_baseline`` rule (:175-205): the fluid nets must be
    there; the regressor comes from the ``motion_regressor.*`` keys when
    the checkpoint holds them and keeps its current (seeded initial)
    weights otherwise. A regressor that is only partly present raises.
    Returns whether the regressor was loaded."""
    own = model.state_dict()
    head = "motion_regressor."
    fluid = [k for k in own if not k.startswith(head)]
    missing = [k for k in fluid if k not in sd]
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} keys of the fluid nets, "
                       f"e.g. {missing[:3]}")
    regressor = [k for k in own if k.startswith(head)]
    have = [k for k in regressor if k in sd]
    if have and len(have) < len(regressor):
        missing = [k for k in regressor if k not in sd]
        raise KeyError(f"checkpoint holds part of motion_regressor: it lacks "
                       f"{len(missing)} keys, e.g. {missing[:3]}")
    model.load_state_dict({k: sd[k] if k in sd else v for k, v in own.items()})
    return bool(have)


# torchvision vgg19.features conv index → the reference loss's slice number
_VGG_SLICES = ((1, 0, 2), (2, 2, 7), (3, 7, 12), (4, 12, 21), (5, 21, 30))


def import_vgg_from_checkpoint(sd: Mapping) -> Optional[Dict]:
    """The pretrained VGG19 of a reference checkpoint's perceptual loss
    (``loss_function.losses.{i}.model.slice{s}.{j}.weight`` and ``.bias``)
    as ``nn/vgg.py:VGG19Features``'s state_dict, or None without such keys
    (the JAX ``import_vgg_from_checkpoint``, :240)."""
    from slrsfs_tpu_torch.nn.vgg import _CONVS

    sd = {_strip_prefixes(k): v for k, v in sd.items()}
    cand = [k for k in sd if "slice1.0.weight" in k]
    if not cand:
        return None
    base = cand[0].rsplit("slice1.0.weight", 1)[0]
    out = {}
    for li, _ in _CONVS:
        s = next(n for n, lo, hi in _VGG_SLICES if lo <= li < hi)
        for leaf in ("weight", "bias"):
            out[f"features.{li}.{leaf}"] = torch.as_tensor(
                sd[f"{base}slice{s}.{li}.{leaf}"], dtype=torch.float32)
    return out


RENDER_MODEL_TYPES = ("softmax_splating",
                      "softmax_splating_2layers_alpha_seperate")


def motion_state(sd: Mapping) -> Dict:
    """The motion regressor's keys of a raw or cleaned state_dict, named as
    a standalone ``MotionRegressor`` names them (``motion_predictor.*``):
    a motion checkpoint's own, which ``clean_state_dict`` moves under
    ``motion_regressor.``, or a fluid model's embedded regressor. The JAX
    ``import_motion_model`` (:272-276) takes either."""
    head = "motion_regressor."
    return {k[len(head):]: v for k, v in clean_state_dict(sd).items()
            if k.startswith(head + "motion_predictor.")}


def load_checkpoint(path: str) -> Tuple[Dict, Options]:
    """(cleaned state_dict, Options) of a reference-style baseline, SLR,
    motion-regressor or background (stage 2, the JAX ``import_bg_model``
    :208: ``net_bg.*``) checkpoint, with ``bn_noise_misc`` set as
    inference does (test_baseline_4eval.py:127); as the JAX
    ``import_checkpoint`` (:297) reads it. A regressor's weights are
    ``motion_state(sd)``."""
    from slrsfs_tpu_torch.models.motion import MOTION_MODEL_TYPES
    from slrsfs_tpu_torch.models.slr import BG_MODEL_TYPE

    # the options travel as a pickled argparse namespace
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    opt = opts_from_namespace(ckpt["opts"]) if "opts" in ckpt else Options()
    opt = opt.replace(bn_noise_misc=True)
    sd = ckpt["state_dict"] if "state_dict" in ckpt else ckpt
    known = RENDER_MODEL_TYPES + MOTION_MODEL_TYPES + (BG_MODEL_TYPE,)
    if opt.model_type not in known:
        raise ValueError(f"unknown model_type {opt.model_type!r}: the port loads "
                         f"{', '.join(known)}")
    return clean_state_dict(sd), opt


# ---------------------------------------------------------------------------
# Adam states in torch.optim.Adam's state_dict layout (the resume format)
# ---------------------------------------------------------------------------
#
# The reference resumes from its .pth with both optimizers' state_dicts
# (train_animating.py:270-288). torch's Adam numbers parameters by their
# place in ``parameters()``, which is the state_dict's order without the
# buffers, so a checkpoint's state_dict alone gives the numbering. The JAX
# package reads it the same way (slrsfs_tpu/io/checkpoint.py:333-344, whose
# rule this copy repeats).

BUFFER_SUFFIXES = (
    "stored_mean", "stored_var", "accumulation_counter",
    "weight_u", "weight_v", "num_batches_tracked",
    "running_mean", "running_var",
)


def ordered_param_names(raw_sd: Mapping, prefix: str = "") -> List[str]:
    """The parameter names of ``raw_sd`` under ``prefix`` in torch's
    ``parameters()`` order: its keys without the buffers."""
    return [k for k in raw_sd
            if k.startswith(prefix) and k.split(".")[-1] not in BUFFER_SUFFIXES]


def adam_state_dict(adam, names: List[str], numbering: List[str]) -> Dict:
    """``torch.optim.Adam.state_dict()`` of the port's ``Adam`` (engine/
    trainer.py) over the parameters ``names`` (``adam.params``' order):
    ``state[i]`` = {step, exp_avg, exp_avg_sq}, i the parameter's place in
    ``numbering`` (all of the module's parameters, as ``ordered_param_names``
    gives them); parameters the optimizer never steps have no entry."""
    at = {n: i for i, n in enumerate(numbering)}
    missing = [n for n in names if n not in at]
    if missing:
        raise KeyError(f"Adam parameters missing from the numbering: {missing[:3]}")
    step = torch.tensor(float(adam.count))
    state = {at[n]: {"step": step.clone(), "exp_avg": mu.detach().cpu().clone(),
                     "exp_avg_sq": nu.detach().cpu().clone()}
             for n, mu, nu in zip(names, adam.mu, adam.nu)}
    return {"state": state,
            "param_groups": [{"lr": float(adam.schedule(adam.count)),
                              "betas": (adam.b1, adam.b2), "eps": adam.eps,
                              "weight_decay": 0.0, "amsgrad": False,
                              "params": sorted(state)}]}


def read_adam_state(adam, opt_sd: Mapping, names: List[str],
                    numbering: List[str]) -> Tuple[List[torch.Tensor], List[torch.Tensor], int]:
    """The moments and count that a torch Adam state_dict numbered by
    ``numbering`` holds for the port's ``Adam`` over ``names``: new tensors
    on the moments' device, zeros where a parameter has no entry (as the
    JAX ``import_adam_moments`` does), the count from the entries' ``step``.
    ``adam`` is not changed; a name outside the numbering is a ``KeyError``
    and a shape that does not fit a ``ValueError``."""
    state = opt_sd["state"]
    at = {n: i for i, n in enumerate(numbering)}
    missing = [n for n in names if n not in at]
    if missing:
        raise KeyError(f"Adam parameters missing from the numbering: {missing[:3]}")
    mus, nus, count = [], [], 0
    for n, mu, nu in zip(names, adam.mu, adam.nu):
        ent = state.get(at[n], state.get(str(at[n])))
        if ent is None:
            mus.append(torch.zeros_like(mu))
            nus.append(torch.zeros_like(nu))
            continue
        for out, dst, key in ((mus, mu, "exp_avg"), (nus, nu, "exp_avg_sq")):
            src = torch.as_tensor(ent[key])
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{key} of {n}: {tuple(src.shape)}, the parameter "
                                 f"is {tuple(dst.shape)}")
            out.append(src.to(device=dst.device, dtype=dst.dtype, copy=True))
        s = ent["step"]
        count = int(s.item() if hasattr(s, "item") else s)
    return mus, nus, count


def trainer_adam_states(trainer) -> Dict:
    """``optimizerG`` and ``optimizerD`` of a trainer, numbered by G's and
    D's parameters in state_dict order (the numbering of the saved
    ``model.module.*`` and ``netD.netD.*`` keys)."""
    out = {}
    for key, adam, module, names in (
            ("optimizerG", trainer.opt_g, trainer.model, trainer.g_names),
            ("optimizerD", trainer.opt_d, trainer.d_model,
             [n for n, _ in trainer.d_model.named_parameters()])):
        numbering = ordered_param_names(module.state_dict())
        if numbering != [n for n, _ in module.named_parameters()]:
            raise ValueError("the state_dict's keys without BUFFER_SUFFIXES are not "
                             "the module's parameters: a buffer of another name")
        out[key] = adam_state_dict(adam, names, numbering)
    return out


def load_trainer_adam_states(trainer, ckpt: Mapping) -> int:
    """Restore both Adam states (and the counts) of a trainer from a
    checkpoint's ``optimizerG`` (and ``optimizerD``, when present),
    numbered by its ``state_dict``'s ``model.*`` and ``netD.netD.*`` keys
    (the JAX ``import_optimizer_states`` rule, :408). All or nothing: both
    states are read and checked first, and a ``KeyError`` or ``ValueError``
    leaves the trainer as it was, as JAX keeps its state when the import
    raises (cli/train.py:431-441). Returns G's count."""
    raw = ckpt["state_dict"]
    g_prefix = "model." if any(k.startswith("model.") for k in raw) else ""
    g_num = [_strip_prefixes(k) for k in ordered_param_names(raw, g_prefix)]
    read = [(trainer.opt_g, read_adam_state(trainer.opt_g, ckpt["optimizerG"],
                                            trainer.g_names, g_num))]
    if "optimizerD" in ckpt:
        d_num = [k[len("netD.netD."):] for k in ordered_param_names(raw, "netD.netD.")]
        read.append((trainer.opt_d, read_adam_state(
            trainer.opt_d, ckpt["optimizerD"],
            [n for n, _ in trainer.d_model.named_parameters()], d_num)))
    for adam, (mus, nus, count) in read:
        adam.mu, adam.nu, adam.count = mus, nus, count
    return read[0][1][2]


def save_checkpoint(path: str, G: torch.nn.Module, D: torch.nn.Module,
                    opt: Options, epoch: int = 0, trainer=None,
                    meta: Optional[Dict] = None) -> str:
    """Write a reference-style ``.pth``: the generator's state under
    ``model.module.`` (BaseModel + DataParallel) and the discriminator's
    under ``netD.netD.``, with ``opts`` as an argparse namespace. Every
    model kind keeps the reference's keys: the fluid models (with an
    embedded regressor under ``motion_regressor.motion_predictor.*``), the
    motion regressor (``motion_predictor.*``) and the background model
    (``net_bg.*``). The port's ``load_checkpoint`` and the JAX
    ``import_checkpoint`` (:297), ``import_embedded_baseline`` (:175) and
    ``import_discriminator`` (:227) read it. Written to a temporary file
    and renamed, so a crash leaves the previous checkpoint.

    With ``trainer`` it is also the resume file: ``optimizerG`` and
    ``optimizerD`` in torch Adam's layout (``trainer_adam_states``; the JAX
    ``import_optimizer_states`` reads them), ``step`` (the update count),
    ``noise_state`` (the BN-noise generator's state) and ``meta`` (e.g.
    ``best_perceptual`` and the validation means) at the top level. A
    data-parallel trainer's ranks other than 0 write nothing."""
    if trainer is not None and trainer.mesh is not None and trainer.mesh.rank != 0:
        return path
    sd = {f"model.module.{k}": v.detach().cpu()
          for k, v in G.state_dict().items()}
    sd.update({f"netD.netD.{k}": v.detach().cpu()
               for k, v in D.state_dict().items()})
    opts = argparse.Namespace(**{
        k: list(v) if isinstance(v, tuple) else v
        for k, v in dataclasses.asdict(opt).items()})
    ckpt = {"state_dict": sd, "opts": opts, "epoch": epoch}
    if trainer is not None:
        ckpt.update(trainer_adam_states(trainer), step=trainer.step_count,
                    noise_state=trainer.noise.get_state().cpu())
    ckpt.update(meta or {})
    tmp = f"{path}.tmp"
    torch.save(ckpt, tmp)
    os.replace(tmp, path)
    return path
