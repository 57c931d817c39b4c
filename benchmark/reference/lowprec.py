"""The render's control: the reference's convolutions with their inputs and
weights rounded to float8 (e4m3, one scale a tensor from its largest
magnitude, as fp8 inference scales them), the precision below the bf16
that the render configuration states. The products still accumulate in
the model's dtype."""

from __future__ import annotations

import contextlib

import torch

from benchmark.reference.nn.conv import Conv

FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0


def fake_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded through e4m3 with a per-tensor scale, in t's dtype."""
    scale = t.detach().abs().amax().float().clamp(min=1e-30) / FP8_MAX
    return (t.float() / scale).to(FP8).float().mul(scale).to(t.dtype)


def _quantize_input(_module, args):
    return (fake_fp8(args[0]),) + tuple(args[1:])


@contextlib.contextmanager
def fp8_convs(model: torch.nn.Module):
    """Within the block every conv of ``model`` takes fp8-rounded inputs
    and weights; the weights are restored after it."""
    saved, hooks = [], []
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Conv):
                w = m._parameters.get("weight_orig", m._parameters.get("weight"))
                saved.append((w, w.detach().clone()))
                w.copy_(fake_fp8(w))
                hooks.append(m.register_forward_pre_hook(_quantize_input))
    try:
        yield
    finally:
        with torch.no_grad():
            for w, orig in saved:
                w.copy_(orig)
        for h in hooks:
            h.remove()
