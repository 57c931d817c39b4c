"""Euler integration of a constant-in-time motion field (PyTorch port of
``slrsfs_tpu/ops/euler.py``).

Starting from each pixel's own coordinate, the destination is advected by
the motion gathered at its half-to-even rounded position; a trajectory that
leaves the frame becomes invalid for good, is pinned back to its source and
reports a displacement of ``max(H, W) + 1`` so downstream splats drop it.

``euler_compact_dual`` is the render path's kernel wrapper (K1,
``csrc/euler.cu``); ``euler_compact_dual_plain`` is its plain PyTorch
version, a loop over steps on tensors. ``euler_integrate_all_dual`` (the
dense rollouts' integrator), ``euler_integrate_all``, ``euler_integrate``
and ``euler_integrate_compact`` are the dense and single-direction forms,
one kernel with options (K4, entry ``euler_all`` of ``csrc/euler.cu``);
``*_plain`` are their plain versions. The single-direction forms also
return visibility (1.0 where the trajectory never left the frame).

``euler_integrate_phased`` and ``euler_integrate_phased_compact`` are the
training pass's integrators (K7, ``csrc/euler_phased.cu``), batched over
samples with per-sample step counts; ``*_plain`` are their plain versions.

Dense K7 has a backward kernel (``euler_phased_bwd``, bound through
``_EulerPhased``): the unfrozen joint motion stage differentiates the
predicted motion through it. K1, K4 and compact K7 have none (JAX never
differentiates them: a predicted motion drops the moving sets): their card
branches refuse a motion that would need a gradient
(``_refuse_motion_grad``) instead of returning displacements that silently
drop it. The plain versions on the CPU carry the gradient through their
gathers, as JAX does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from slrsfs_tpu_torch import kernels

Tensor = torch.Tensor


def _scan_plain(motion: Tensor, coord: Tensor, sign: Tensor, n_steps: int
                ) -> Tuple[Tensor, Tensor]:
    """Steps 1..n_steps of the JAX scan body for rows ``coord`` (R, 2) f32
    [x, y], each adding the gathered motion times ``sign`` (R, 1), ±1 (an
    exact product). Returns (disps (n_steps, R, 2), visible (n_steps, R)
    bool)."""
    H, W, _ = motion.shape
    oob = torch.full_like(coord, float(max(H, W) + 1))
    motion_flat = motion.reshape(H * W, 2)
    dest = coord
    invalid = torch.zeros(coord.shape[:1], dtype=torch.bool, device=motion.device)
    disps, visible = [], []
    for _ in range(n_steps):
        ix = torch.round(dest[:, 0]).to(torch.int64).clamp(0, W - 1)
        iy = torch.round(dest[:, 1]).to(torch.int64).clamp(0, H - 1)
        m = motion_flat[iy * W + ix] * sign
        dest = dest + m
        out = ((dest[:, 0] > W - 1) | (dest[:, 0] < 0)
               | (dest[:, 1] > H - 1) | (dest[:, 1] < 0))
        invalid = invalid | out
        dest = torch.where(invalid[:, None], coord, dest)
        disps.append(torch.where(invalid[:, None], oob, dest - coord))
        visible.append(~invalid)
    if not disps:
        return (coord.new_zeros((0,) + tuple(coord.shape)),
                torch.zeros((0,) + tuple(coord.shape[:1]), dtype=torch.bool,
                            device=motion.device))
    return torch.stack(disps), torch.stack(visible)


def _grid(H: int, W: int, device) -> Tensor:
    """(H·W, 2) int32 [x, y] of every pixel, row-major."""
    ys, xs = torch.meshgrid(torch.arange(H, device=device),
                            torch.arange(W, device=device), indexing="ij")
    return torch.stack([xs, ys], dim=-1).reshape(H * W, 2).to(torch.int32)


def euler_compact_dual_plain(motion: Tensor, positions: Tensor, n_fwd: int,
                             n_bwd: int) -> Tuple[Tensor, Tensor]:
    """Both directions (M and -M) of P trajectories.

    motion (H, W, 2) f32; positions (P, 2) int [x, y]. Returns
    (disp_fwd (n_fwd+1, P, 2), disp_bwd (n_bwd+1, P, 2)); entry 0 is zero.
    Element for element the JAX ``euler_integrate_compact_dual``.
    """
    dtype = motion.dtype
    P = positions.shape[0]
    coord = torch.cat([positions, positions]).to(dtype)  # (2P, 2)
    sign = torch.cat([torch.ones((P, 1), dtype=dtype, device=motion.device),
                      -torch.ones((P, 1), dtype=dtype, device=motion.device)])
    stack, _ = _scan_plain(motion, coord, sign, max(n_fwd, n_bwd))
    zero = torch.zeros((1, P, 2), dtype=dtype, device=motion.device)
    disp_f = torch.cat([zero, stack[:n_fwd, :P]])
    disp_b = torch.cat([zero, stack[:n_bwd, P:]])
    return disp_f, disp_b


def euler_integrate_compact_plain(motion: Tensor, positions: Tensor,
                                  n_steps: int) -> Tuple[Tensor, Tensor]:
    """Plain K4, compact: trajectories of the pixels ``positions`` (P, 2)
    int [x, y]. Returns (disps (n_steps+1, P, 2), visible (n_steps+1, P)
    f32); entry 0 is zero displacement, all visible. Element for element
    the JAX ``euler_integrate_compact``."""
    dtype = motion.dtype
    coord = positions.to(dtype)
    P = coord.shape[0]
    disps, visible = _scan_plain(
        motion, coord, torch.ones((P, 1), dtype=dtype, device=motion.device),
        n_steps)
    return (torch.cat([coord.new_zeros((1, P, 2)), disps]),
            torch.cat([torch.ones((1, P), dtype=torch.bool, device=motion.device),
                       visible]).to(dtype))


def euler_integrate_all_plain(motion: Tensor, n_steps: int
                              ) -> Tuple[Tensor, Tensor]:
    """Plain K4, dense: every pixel's trajectory. Returns (disps
    (n_steps+1, H, W, 2), visible (n_steps+1, H, W) f32), element for
    element the JAX ``euler_integrate_all``."""
    H, W, _ = motion.shape
    d, v = euler_integrate_compact_plain(motion, _grid(H, W, motion.device),
                                         n_steps)
    return d.reshape(n_steps + 1, H, W, 2), v.reshape(n_steps + 1, H, W)


def euler_integrate_plain(motion: Tensor, n_steps: int) -> Tuple[Tensor, Tensor]:
    """Plain K4, last step: (displacement (H, W, 2), visible (H, W)) after
    exactly ``n_steps`` steps (the JAX ``euler_integrate``)."""
    d, v = euler_integrate_all_plain(motion, n_steps)
    return d[-1], v[-1]


def euler_integrate_all_dual_plain(motion: Tensor, n_fwd: int, n_bwd: int
                                   ) -> Tuple[Tensor, Tensor]:
    """Plain K4, dense and both directions: (disp_fwd (n_fwd+1, H, W, 2),
    disp_bwd (n_bwd+1, H, W, 2)), element for element the JAX
    ``euler_integrate_all_dual``."""
    H, W, _ = motion.shape
    disp_f, disp_b = euler_compact_dual_plain(motion, _grid(H, W, motion.device),
                                              n_fwd, n_bwd)
    return (disp_f.reshape(n_fwd + 1, H, W, 2),
            disp_b.reshape(n_bwd + 1, H, W, 2))


def _check(motion: Tensor, positions, *steps: int) -> None:
    """Shapes, types, devices and contiguity of an integrator's inputs;
    ``positions`` None for the dense grid."""
    if motion.ndim != 3 or motion.shape[-1] != 2:
        raise ValueError(f"motion must be (H, W, 2), got {tuple(motion.shape)}")
    if motion.dtype != torch.float32:
        raise TypeError(f"motion must be float32, got {motion.dtype}")
    if any(n < 0 for n in steps):
        raise ValueError(f"negative step counts {steps}")
    named = {"motion": motion}
    if positions is not None:
        if positions.ndim != 2 or positions.shape[-1] != 2:
            raise ValueError(
                f"positions must be (P, 2), got {tuple(positions.shape)}")
        if positions.dtype != torch.int32:
            raise TypeError(f"positions must be int32, got {positions.dtype}")
        if motion.device != positions.device:
            raise ValueError("motion and positions are on different devices")
        if motion.shape[0] * motion.shape[1] == 0 and positions.shape[0] \
                and max(steps) > 0:
            raise ValueError("an empty motion field has no cell to gather")
        named["positions"] = positions
    for name, t in named.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if motion.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {motion.device}")
    if motion.device.type == "cuda":
        for name, t in named.items():
            if t.data_ptr() % 8:
                raise ValueError(f"{name} must be 8-byte aligned")


# K1, K4 and K7 round by an add of 1.5 * 2^23, exact below 2^22, and index
# the motion field with 32-bit ints
EULER_MAX_SIDE = 1 << 22


def check_euler_limits(kernel: str, H: int, W: int) -> None:
    """Raise a ``ValueError`` naming the limit when an integrator kernel
    cannot take an (H, W) field: H or W at least ``EULER_MAX_SIDE``, or
    H·W beyond 32-bit indices. Every card branch calls it before it
    allocates or launches anything."""
    kernels.check_sides(kernel, H, W, EULER_MAX_SIDE,
                        "it rounds by an add of 1.5 * 2^23, exact below 2^22")
    if H * W >= 1 << 31:
        raise ValueError(f"{kernel} indexes the motion with 32-bit ints: H * W must "
                         f"be below 2^31, got {H} * {W}")


def _refuse_motion_grad(motion: Tensor) -> None:
    """Raise when ``motion`` would need a gradient: the CUDA integrators K1,
    K4 and compact K7 write fresh tensors with no backward. Their card
    branches call it before they allocate or launch anything; it does not
    look at the device."""
    if torch.is_grad_enabled() and motion.requires_grad:
        raise RuntimeError(
            "the CUDA Euler integrators K1 (euler_compact_dual), K4 (euler_all) "
            "and compact K7 (euler_integrate_phased_compact) have no backward: "
            "the motion requires grad, and the displacements would drop its "
            "gradient; detach the motion, run under torch.no_grad(), or use the "
            "dense euler_integrate_phased")


def euler_compact_dual(motion: Tensor, positions: Tensor, n_fwd: int,
                       n_bwd: int) -> Tuple[Tensor, Tensor]:
    """K1 wrapper: ``euler_compact_dual_plain``'s result, computed by the
    CUDA kernel for tensors on the card and by the plain version for tensors
    on the CPU."""
    _check(motion, positions, n_fwd, n_bwd)
    if motion.device.type == "cpu":
        return euler_compact_dual_plain(motion, positions, n_fwd, n_bwd)
    _refuse_motion_grad(motion)
    H, W, _ = motion.shape
    check_euler_limits("K1 (euler_compact_dual)", H, W)
    P = positions.shape[0]
    disp_f = torch.empty((n_fwd + 1, P, 2), dtype=torch.float32,
                         device=motion.device)
    disp_b = torch.empty((n_bwd + 1, P, 2), dtype=torch.float32,
                         device=motion.device)
    with torch.cuda.device(motion.device):
        stream = torch.cuda.current_stream().cuda_stream
        kernels.EULER.launch(motion.data_ptr(), positions.data_ptr(),
                             disp_f.data_ptr(), disp_b.data_ptr(), P, H, W,
                             n_fwd, n_bwd, stream)
    return disp_f, disp_b


euler_integrate_compact_dual = euler_compact_dual  # the JAX package's name


def _launch_all(motion: Tensor, positions: Optional[Tensor], n_fwd: int,
                n_bwd: Optional[int], last_only: bool, visibility: bool):
    """One K4 launch on the card: rows are the dense grid (``positions``
    None) or ``positions``; ``n_bwd`` None integrates +M only. Returns
    (disp_f, disp_b, vis_f): (E, R, 2), (E_b, R, 2) or None, (E, R) or None,
    with E = 1 for ``last_only`` and n + 1 otherwise."""
    _refuse_motion_grad(motion)
    H, W, _ = motion.shape
    check_euler_limits("K4 (euler_all)", H, W)
    R = H * W if positions is None else positions.shape[0]
    dev = motion.device

    def entries(n):
        return 1 if last_only else n + 1

    disp_f = torch.empty((entries(n_fwd), R, 2), dtype=torch.float32, device=dev)
    disp_b = (None if n_bwd is None else
              torch.empty((entries(n_bwd), R, 2), dtype=torch.float32, device=dev))
    vis_f = (torch.empty((entries(n_fwd), R), dtype=torch.float32, device=dev)
             if visibility else None)

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        kernels.EULER_ALL.launch(motion.data_ptr(), ptr(positions),
                                 disp_f.data_ptr(), ptr(disp_b), ptr(vis_f), 0,
                                 R, H, W, n_fwd, n_bwd or 0, int(last_only),
                                 stream)
    return disp_f, disp_b, vis_f


def euler_integrate_all(motion: Tensor, n_steps: int) -> Tuple[Tensor, Tensor]:
    """K4 wrapper, dense: ``euler_integrate_all_plain``'s result, from the
    kernel for tensors on the card and the plain version on the CPU."""
    _check(motion, None, n_steps)
    if motion.device.type == "cpu":
        return euler_integrate_all_plain(motion, n_steps)
    H, W, _ = motion.shape
    d, _, v = _launch_all(motion, None, n_steps, None, False, True)
    return d.reshape(n_steps + 1, H, W, 2), v.reshape(n_steps + 1, H, W)


def euler_integrate(motion: Tensor, n_steps: int) -> Tuple[Tensor, Tensor]:
    """K4 wrapper, last step only: ``euler_integrate_plain``'s result; the
    kernel writes the final displacement and visibility and no other
    step."""
    _check(motion, None, n_steps)
    if motion.device.type == "cpu":
        return euler_integrate_plain(motion, n_steps)
    H, W, _ = motion.shape
    d, _, v = _launch_all(motion, None, n_steps, None, True, True)
    return d.reshape(H, W, 2), v.reshape(H, W)


def euler_integrate_compact(motion: Tensor, positions: Tensor, n_steps: int
                            ) -> Tuple[Tensor, Tensor]:
    """K4 wrapper, compact: ``euler_integrate_compact_plain``'s result."""
    _check(motion, positions, n_steps)
    if motion.device.type == "cpu":
        return euler_integrate_compact_plain(motion, positions, n_steps)
    d, _, v = _launch_all(motion, positions, n_steps, None, False, True)
    return d, v


def euler_integrate_all_dual(motion: Tensor, n_fwd: int, n_bwd: int
                             ) -> Tuple[Tensor, Tensor]:
    """K4 wrapper, dense and both directions (the dense rollouts'
    integrator): ``euler_integrate_all_dual_plain``'s result."""
    _check(motion, None, n_fwd, n_bwd)
    if motion.device.type == "cpu":
        return euler_integrate_all_dual_plain(motion, n_fwd, n_bwd)
    H, W, _ = motion.shape
    d_f, d_b, _ = _launch_all(motion, None, n_fwd, n_bwd, False, False)
    return d_f.reshape(n_fwd + 1, H, W, 2), d_b.reshape(n_bwd + 1, H, W, 2)


def _phased_scan(motion: Tensor, coord: Tensor, t_fwd: Tensor,
                 t_bwd: Tensor, n_steps: int) -> Tuple[Tensor, Tensor]:
    """The phase-switched scan over rows ``coord`` (B, R, 2) f32 [x, y] of
    each sample: step for step the JAX scan body (``euler.py:273-299``),
    with the batch written out instead of vmapped. Returns the latched
    (out_f, out_p), each (B, R, 2)."""
    B, H, W, _ = motion.shape
    dtype = motion.dtype
    oob = torch.tensor(float(max(H, W) + 1), dtype=dtype, device=motion.device)
    motion_flat = motion.reshape(B, H * W, 2)
    tf = t_fwd.to(torch.int64)[:, None]  # (B, 1)
    tp = t_bwd.to(torch.int64)[:, None]
    one = torch.ones((), dtype=dtype, device=motion.device)
    dest = coord
    invalid = torch.zeros(coord.shape[:2], dtype=torch.bool, device=motion.device)
    out_f = torch.zeros_like(coord)
    out_p = torch.zeros_like(coord)
    for k in range(1, n_steps + 1):
        reset = k == tf + 1
        dest = torch.where(reset[..., None], coord, dest)
        invalid = torch.where(reset, False, invalid)
        sign = torch.where(k <= tf, one, -one)[..., None]  # (B, 1, 1)
        ix = torch.round(dest[..., 0]).to(torch.int64).clamp(0, W - 1)
        iy = torch.round(dest[..., 1]).to(torch.int64).clamp(0, H - 1)
        m = torch.gather(motion_flat, 1, (iy * W + ix)[..., None].expand(-1, -1, 2))
        dest = dest + m * sign
        out = ((dest[..., 0] > W - 1) | (dest[..., 0] < 0)
               | (dest[..., 1] > H - 1) | (dest[..., 1] < 0))
        invalid = invalid | out
        dest = torch.where(invalid[..., None], coord, dest)
        disp = torch.where(invalid[..., None], oob, dest - coord)
        out_f = torch.where((k == tf)[..., None], disp, out_f)
        out_p = torch.where(((k == tf + tp) & (tp > 0))[..., None], disp, out_p)
    return out_f, out_p


def euler_integrate_phased_plain(motion: Tensor, t_fwd: Tensor, t_bwd: Tensor,
                                 n_steps: int) -> Tuple[Tensor, Tensor]:
    """Plain version of dense K7: the JAX ``euler_integrate_phased`` for
    each sample. motion (B, H, W, 2) f32; t_fwd, t_bwd (B,) int with
    t_fwd + t_bwd <= n_steps. Returns (disp_fwd, disp_bwd), each
    (B, H, W, 2): the displacement after t_fwd steps of +M and after t_bwd
    steps of -M (zero where the count is 0)."""
    B, H, W, _ = motion.shape
    ys, xs = torch.meshgrid(torch.arange(H, device=motion.device),
                            torch.arange(W, device=motion.device),
                            indexing="ij")
    coord = torch.stack([xs, ys], dim=-1).reshape(1, H * W, 2).to(motion.dtype)
    out_f, out_p = _phased_scan(motion, coord.expand(B, -1, -1), t_fwd, t_bwd,
                                n_steps)
    return out_f.reshape(B, H, W, 2), out_p.reshape(B, H, W, 2)


def euler_integrate_phased_compact_plain(motion: Tensor, positions: Tensor,
                                         valid: Tensor, t_fwd: Tensor,
                                         t_bwd: Tensor, n_steps: int
                                         ) -> Tuple[Tensor, Tensor]:
    """Plain version of compact K7: the JAX ``euler_integrate_phased_compact``
    for each sample. positions (B, P, 2) int32 [x, y], the moving set padded
    with ``valid`` (B, P) f32 = 0. The rows' results, times ``valid``, are
    added onto a zero (B, H, W, 2) grid at their source pixels."""
    B, H, W, _ = motion.shape
    out_f, out_p = _phased_scan(motion, positions.to(motion.dtype), t_fwd,
                                t_bwd, n_steps)
    cell = (torch.arange(B, device=motion.device)[:, None] * (H * W)
            + positions[..., 1].to(torch.int64) * W
            + positions[..., 0].to(torch.int64)).reshape(-1)
    v = valid.to(motion.dtype)[..., None]
    grids = []
    for out in (out_f, out_p):
        grid = torch.zeros((B * H * W, 2), dtype=motion.dtype, device=motion.device)
        grid.index_put_((cell,), (out * v).reshape(-1, 2), accumulate=True)
        grids.append(grid.reshape(B, H, W, 2))
    return grids[0], grids[1]


def _check_phased(motion: Tensor, t_fwd: Tensor, t_bwd: Tensor,
                  n_steps: int) -> None:
    if motion.ndim != 4 or motion.shape[-1] != 2:
        raise ValueError(f"motion must be (B, H, W, 2), got {tuple(motion.shape)}")
    if motion.dtype != torch.float32:
        raise TypeError(f"motion must be float32, got {motion.dtype}")
    B = motion.shape[0]
    for name, t in (("t_fwd", t_fwd), ("t_bwd", t_bwd)):
        if tuple(t.shape) != (B,) or t.dtype != torch.int32:
            raise ValueError(f"{name} must be ({B},) int32, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != motion.device:
            raise ValueError(f"{name} is on {t.device}, motion on {motion.device}")
    if n_steps < 0:
        raise ValueError(f"negative n_steps {n_steps}")
    if not motion.is_contiguous():
        raise ValueError("motion must be contiguous")


def _launch_phased(motion, positions, valid, t_fwd, t_bwd, n_steps, R):
    B, H, W, _ = motion.shape
    check_euler_limits("K7 (euler_phased)", H, W)
    named = dict(motion=motion, t_fwd=t_fwd, t_bwd=t_bwd)
    if positions is not None:
        named.update(positions=positions, valid=valid)
    for name, t in named.items():
        if not t.is_contiguous() or t.data_ptr() % 8:
            raise ValueError(f"{name} must be contiguous and 8-byte aligned")
    alloc = torch.empty if positions is None else torch.zeros
    out_f = alloc((B, H, W, 2), dtype=torch.float32, device=motion.device)
    out_p = alloc((B, H, W, 2), dtype=torch.float32, device=motion.device)
    with torch.cuda.device(motion.device):
        stream = torch.cuda.current_stream().cuda_stream
        kernels.EULER_PHASED.launch(
            motion.data_ptr(), 0 if positions is None else positions.data_ptr(),
            0 if valid is None else valid.data_ptr(), t_fwd.data_ptr(),
            t_bwd.data_ptr(), out_f.data_ptr(), out_p.data_ptr(), B, R, H, W,
            n_steps, stream)
    return out_f, out_p


def euler_integrate_phased(motion: Tensor, t_fwd: Tensor, t_bwd: Tensor,
                           n_steps: int) -> Tuple[Tensor, Tensor]:
    """K7 wrapper, dense: ``euler_integrate_phased_plain``'s result, from
    the CUDA kernel for tensors on the card and from the plain version for
    tensors on the CPU."""
    _check_phased(motion, t_fwd, t_bwd, n_steps)
    if motion.device.type == "cpu":
        return euler_integrate_phased_plain(motion, t_fwd, t_bwd, n_steps)
    if motion.device.type != "cuda":
        raise ValueError(f"unsupported device {motion.device}")
    if torch.is_grad_enabled() and motion.requires_grad:
        return _EulerPhased.apply(motion, t_fwd, t_bwd, n_steps)
    B, H, W, _ = motion.shape
    return _launch_phased(motion, None, None, t_fwd, t_bwd, n_steps, H * W)


def euler_phased_bwd(motion: Tensor, t_fwd: Tensor, t_bwd: Tensor,
                     out_f: Tensor, out_p: Tensor, cot_f: Optional[Tensor],
                     cot_p: Optional[Tensor], n_steps: int) -> Tensor:
    """K7's backward kernel, dense: the motion's gradient (B, H, W, 2) f32
    from the cotangents ``cot_f``, ``cot_p`` (None: zero) of the forward's
    outputs ``out_f``, ``out_p``, which tell it the rows that left the
    frame (the sentinel). Card tensors only: on the CPU the gradient is the
    plain version's autograd."""
    _check_phased(motion, t_fwd, t_bwd, n_steps)
    if motion.device.type != "cuda":
        raise ValueError(f"euler_phased_bwd runs on the card, got {motion.device}")
    B, H, W, _ = motion.shape
    check_euler_limits("K7 (euler_phased_bwd)", H, W)
    named = dict(motion=motion, t_fwd=t_fwd, t_bwd=t_bwd, out_f=out_f, out_p=out_p)
    if cot_f is not None:
        named["cot_f"] = cot_f
    if cot_p is not None:
        named["cot_p"] = cot_p
    for name, t in named.items():
        if t.device != motion.device:
            raise ValueError(f"{name} is on {t.device}, motion on {motion.device}")
        if t.shape[0] != B or (t.ndim == 4 and tuple(t.shape) != tuple(motion.shape)):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, motion "
                             f"{tuple(motion.shape)}")
        if t.ndim == 4 and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 8:
            raise ValueError(f"{name} must be contiguous and 8-byte aligned")
    grad = torch.zeros_like(motion)

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    with torch.cuda.device(motion.device):
        stream = torch.cuda.current_stream().cuda_stream
        kernels.EULER_PHASED_BWD.launch(
            motion.data_ptr(), t_fwd.data_ptr(), t_bwd.data_ptr(), out_f.data_ptr(),
            out_p.data_ptr(), ptr(cot_f), ptr(cot_p), grad.data_ptr(), B, H, W,
            n_steps, stream)
    return grad


class _EulerPhased(torch.autograd.Function):
    """Dense K7 with its backward kernel: the forward launches
    ``euler_phased`` and keeps its outputs, the backward launches
    ``euler_phased_bwd``. The counts carry no gradient."""

    @staticmethod
    def forward(ctx, motion, t_fwd, t_bwd, n_steps):
        B, H, W, _ = motion.shape
        out_f, out_p = _launch_phased(motion, None, None, t_fwd, t_bwd, n_steps, H * W)
        ctx.save_for_backward(motion, t_fwd, t_bwd, out_f, out_p)
        ctx.n_steps = n_steps
        return out_f, out_p

    @staticmethod
    def backward(ctx, g_f, g_p):
        motion, t_fwd, t_bwd, out_f, out_p = ctx.saved_tensors

        def cot(g):
            return None if g is None else g.contiguous()

        grad = euler_phased_bwd(motion, t_fwd, t_bwd, out_f, out_p, cot(g_f),
                                cot(g_p), ctx.n_steps)
        return grad, None, None, None


def euler_integrate_phased_compact(motion: Tensor, positions: Tensor,
                                   valid: Tensor, t_fwd: Tensor, t_bwd: Tensor,
                                   n_steps: int) -> Tuple[Tensor, Tensor]:
    """K7 wrapper, compact: ``euler_integrate_phased_compact_plain``'s
    result, from the kernel on the card and the plain version on the CPU.
    The kernel stores each row's result instead of adding it, so the rows
    of a sample whose ``valid`` is not 0 must have distinct positions, as
    ``cli/train.py:attach_moving_sets`` gives them; rows with ``valid`` 0
    are not integrated."""
    _check_phased(motion, t_fwd, t_bwd, n_steps)
    B = motion.shape[0]
    if positions.ndim != 3 or positions.shape[0] != B or positions.shape[-1] != 2 \
            or positions.dtype != torch.int32:
        raise ValueError(f"positions must be (B, P, 2) int32, got "
                         f"{tuple(positions.shape)} {positions.dtype}")
    if tuple(valid.shape) != tuple(positions.shape[:2]) \
            or valid.dtype != torch.float32:
        raise ValueError(f"valid must be {tuple(positions.shape[:2])} float32")
    for name, t in (("positions", positions), ("valid", valid)):
        if t.device != motion.device:
            raise ValueError(f"{name} is on {t.device}, motion on {motion.device}")
    if motion.device.type == "cpu":
        return euler_integrate_phased_compact_plain(motion, positions, valid,
                                                    t_fwd, t_bwd, n_steps)
    if motion.device.type != "cuda":
        raise ValueError(f"unsupported device {motion.device}")
    _refuse_motion_grad(motion)
    return _launch_phased(motion, positions, valid, t_fwd, t_bwd, n_steps,
                          positions.shape[1])
