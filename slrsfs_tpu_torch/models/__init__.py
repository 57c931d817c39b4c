"""Model registry (PyTorch port of ``slrsfs_tpu/models/__init__.py``;
reference ``options/options.py:1-34`` get_model)."""

from __future__ import annotations

from slrsfs_tpu_torch.config import Options


def get_model(opt: Options):
    """The model ``opt.model_type`` names, built on the current default
    device with uninitialised weights."""
    from slrsfs_tpu_torch.models.baseline import BaselineModel
    from slrsfs_tpu_torch.models.motion import MOTION_MODEL_TYPES, MotionRegressor
    from slrsfs_tpu_torch.models.slr import (
        BG_MODEL_TYPE,
        SLR_MODEL_TYPE,
        BackgroundModel,
        SLRModel,
    )

    if opt.model_type == "softmax_splating":
        return BaselineModel(opt)
    if opt.model_type == SLR_MODEL_TYPE:
        return SLRModel(opt)
    if opt.model_type in MOTION_MODEL_TYPES:
        return MotionRegressor(opt)
    if opt.model_type == BG_MODEL_TYPE:
        return BackgroundModel(opt)
    raise ValueError(f"the port builds no model_type {opt.model_type!r}")
