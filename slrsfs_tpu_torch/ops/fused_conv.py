"""Fused bf16 conv3x3 → ReLU → conv3x3 (PyTorch port of the Pallas kernel
``tools/pallas_conv_prototype.py:fused``).

``fused_conv3x3_relu_conv3x3`` is the kernel wrapper (K9,
``csrc/fused_conv.cu``): on the card one launch computes both convolutions
with bf16 tensor cores and keeps the intermediate in shared memory.
``conv_chain_plain`` is its plain version (float32 convolutions with TF32
off, the intermediate rounded to bf16), which the wrapper runs for tensors
on the CPU. ``conv_chain_library`` is the yardstick the measurements time
beside the kernel (cuDNN bf16 convolutions, channels-last); the port never
calls it.

Layouts are the JAX function's: x (B, H, W, C) NHWC, weights (3, 3, C, F)
and (3, 3, F, F) HWIO, all bf16; the output is (B, H, W, F) bf16. Both
convolutions are SAME with zero padding, and the intermediate is zero
outside the image.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F_

from slrsfs_tpu_torch import kernels
from slrsfs_tpu_torch.engine.init_utils import no_tf32

Tensor = torch.Tensor

TILES = ((8, 8), (8, 16), (16, 8))  # (TH, TW) output tiles the kernel offers
DEFAULT_TILE = (8, 16)
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on an H100
_PAD = 8  # bf16 of padding per shared-memory row (csrc/fused_conv.cu kPad)


def smem_bytes(tile, C: int, F: int) -> int:
    """Dynamic shared memory of one block: the x slab (reused for the
    intermediate) and one tap of weights."""
    th, tw = tile
    slab = max((th + 4) * (tw + 4) * (C + _PAD), (th + 2) * (tw + 2) * (F + _PAD))
    return 2 * (slab + max(C, F) * (F + _PAD))


def _check(x: Tensor, waa: Tensor, wab: Tensor, tile) -> None:
    """What the kernel takes, refused on every device alike."""
    if x.ndim != 4:
        raise ValueError(f"x must be (B, H, W, C), got {tuple(x.shape)}")
    C = x.shape[-1]
    Fo = waa.shape[-1] if waa.ndim == 4 else -1
    for name, t, shape in (("waa", waa, (3, 3, C, Fo)), ("wab", wab, (3, 3, Fo, Fo))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape} HWIO, got {tuple(t.shape)}")
    for name, t in (("x", x), ("waa", waa), ("wab", wab)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous ({'NHWC' if name == 'x' else 'HWIO'})")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if C % 16 or C <= 0:
        raise ValueError(f"C must be a positive multiple of 16, got {C}")
    if Fo % 32 or not 0 < Fo <= 128:
        raise ValueError(f"F must be a multiple of 32 up to 128, got {Fo}")
    if tuple(tile) not in TILES:
        raise ValueError(f"tile must be one of {TILES}, got {tile}")
    if smem_bytes(tile, C, Fo) > SMEM_LIMIT:
        raise ValueError(f"C = {C}, F = {Fo} need {smem_bytes(tile, C, Fo)} bytes "
                         f"of shared memory at tile {tile}, over {SMEM_LIMIT}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def _oihw(w: Tensor) -> Tensor:
    return w.permute(3, 2, 0, 1)


def conv_chain_plain(x: Tensor, waa: Tensor, wab: Tensor) -> Tensor:
    """Plain K9: float32 convolutions with TF32 off, ReLU, a round to
    bf16, the second float32 convolution and a round to bf16. NHWC/HWIO in,
    (B, H, W, F) bf16 out."""
    with no_tf32():
        h = F_.conv2d(x.permute(0, 3, 1, 2).float(), _oihw(waa).float(), padding=1)
        h = torch.relu(h).to(torch.bfloat16).float()
        out = F_.conv2d(h, _oihw(wab).float(), padding=1)
    return out.to(torch.bfloat16).permute(0, 2, 3, 1).contiguous()


def conv_chain_library(x: Tensor, waa: Tensor, wab: Tensor) -> Tensor:
    """The yardstick: cuDNN's bf16 convolutions on the channels-last
    tensors (NHWC memory seen as NCHW), ReLU between them."""
    cl = torch.channels_last
    h = torch.relu(F_.conv2d(x.permute(0, 3, 1, 2),
                             _oihw(waa).contiguous(memory_format=cl), padding=1))
    out = F_.conv2d(h, _oihw(wab).contiguous(memory_format=cl), padding=1)
    return out.permute(0, 2, 3, 1)


def fused_conv3x3_relu_conv3x3(x: Tensor, waa: Tensor, wab: Tensor,
                               tile=DEFAULT_TILE) -> Tensor:
    """K9 wrapper: ``conv_chain_plain``'s result up to f32 summation order,
    from one kernel launch with (TH, TW) = ``tile`` output tiles for tensors
    on the card and from the plain version on the CPU. Any H and W; C a
    multiple of 16, F a multiple of 32 up to 128."""
    _check(x, waa, wab, tile)
    if x.device.type == "cpu":
        return conv_chain_plain(x, waa, wab)
    B, H, W, C = x.shape
    Fo = waa.shape[-1]
    out = torch.empty((B, H, W, Fo), dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        kernels.FUSED_CONV.launch(
            x.data_ptr(), waa.data_ptr(), wab.data_ptr(), out.data_ptr(), B, H,
            W, C, Fo, TILES.index(tuple(tile)),
            torch.cuda.current_stream().cuda_stream)
    return out
