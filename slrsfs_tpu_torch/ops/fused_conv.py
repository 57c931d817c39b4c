"""Fused bf16 conv3x3 → ReLU → conv3x3 (PyTorch port of the Pallas kernel
``tools/pallas_conv_prototype.py:fused``).

``fused_conv3x3_relu_conv3x3`` is the kernel wrapper (K9,
``csrc/fused_conv.cu``): on the card one launch computes both convolutions
with bf16 tensor cores (``wgmma``) and keeps the intermediate in shared
memory. ``pack_weights`` turns the weights into the kernel's stream of
swizzled tap images, on every call. ``conv_chain_plain`` is its plain
version (float32 convolutions with TF32 off, the intermediate rounded to
bf16), which the wrapper runs for tensors on the CPU.
``conv_chain_library`` is the yardstick the measurements time beside the
kernel (cuDNN bf16 convolutions, channels-last); the port never calls it.

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

TILE = (8, 16)  # (TH, TW): the output tile of one block (csrc/fused_conv.cu)
NP = 128  # output channels of a packed tap image, zeros past F (kNp)
ATOM_K = 64  # input channels per 128-byte swizzled row of a tap image
ROW_TILE = 64  # rows of the kernel's MMA tiles (wgmma m64)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def tap_image_bytes(K: int) -> int:
    """Bytes of one packed tap image of a conv with K input channels."""
    return _round_up(K, ATOM_K) * NP * 2


def work_ratio(C: int, F: int) -> float:
    """Multiply-adds the kernel issues over the useful ones: conv1 runs on
    the (TH + 2)(TW + 2) pixels of h, both convs on whole ROW_TILE-row
    tiles, on input channels rounded up to ATOM_K and on all NP packed
    output channels."""
    th, tw = TILE
    rows1 = _round_up((th + 2) * (tw + 2), ROW_TILE)
    rows2 = _round_up(th * tw, ROW_TILE)
    issued = (rows1 * _round_up(C, ATOM_K) + rows2 * _round_up(F, ATOM_K)) * NP
    return issued / (th * tw * (C * F + F * F))


def _pack(w: Tensor) -> Tensor:
    """One conv's (3, 3, K, F) HWIO weights as 9 tap images, flat. Image
    ``t`` is the (K, F) matrix of tap (t // 3, t % 3) padded with zeros to
    (Kp, NP), Kp = K rounded up to ATOM_K, laid out K-major with the
    128-byte swizzle: block ``k // 64`` of NP rows of 128 bytes, row ``n``
    holding k % 64 = 0..63 in eight 16-byte chunks, chunk ``c`` stored at
    position ``c ^ (n % 8)``."""
    K, F = w.shape[2], w.shape[3]
    kp = _round_up(K, ATOM_K)
    t = w.new_zeros((9, kp, NP))
    t[:, :K, :F] = w.reshape(9, K, F)
    t = t.reshape(9, kp // ATOM_K, 8, 8, NP).permute(0, 1, 4, 2, 3)  # tap, kb, n, c, e
    n = torch.arange(NP, device=w.device)
    chunk = torch.arange(8, device=w.device)[None, :] ^ (n % 8)[:, None]  # (n, pos) -> c
    return t.gather(3, chunk[None, None, :, :, None].expand(t.shape)).reshape(-1)


def pack_weights(waa: Tensor, wab: Tensor) -> Tensor:
    """The kernel's weight stream: the 9 tap images of ``waa`` then the 9
    of ``wab`` (see ``_pack``), one contiguous bf16 buffer on the weights'
    device. Each image is the exact shared-memory image a tap slot holds,
    so the kernel moves it with one bulk copy."""
    return torch.cat([_pack(waa), _pack(wab)])


def _check(x: Tensor, waa: Tensor, wab: Tensor) -> None:
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
    if C % 16 or not 0 < C <= 128:
        raise ValueError(f"C must be a multiple of 16 up to 128, got {C}")
    if Fo % 32 or not 0 < Fo <= 128:
        raise ValueError(f"F must be a multiple of 32 up to 128, got {Fo}")
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


def fused_conv3x3_relu_conv3x3(x: Tensor, waa: Tensor, wab: Tensor) -> Tensor:
    """K9 wrapper: ``conv_chain_plain``'s result up to f32 summation order,
    from one kernel launch (one block per ``TILE`` of the output) for
    tensors on the card and from the plain version on the CPU. Any H and W;
    C a multiple of 16 and F a multiple of 32, both up to 128. The weights
    are packed (``pack_weights``) on every call; a block that does not fit
    the card's shared memory fails its launch, which raises."""
    _check(x, waa, wab)
    if x.device.type == "cpu":
        return conv_chain_plain(x, waa, wab)
    B, H, W, C = x.shape
    Fo = waa.shape[-1]
    out = torch.empty((B, H, W, Fo), dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        packed = pack_weights(waa, wab)
        kernels.FUSED_CONV.launch(
            x.data_ptr(), packed.data_ptr(), out.data_ptr(), B, H, W, C, Fo,
            torch.cuda.current_stream().cuda_stream)
    return out
