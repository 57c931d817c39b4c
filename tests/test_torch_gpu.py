"""The port's CUDA kernels against their plain versions on a card.

Every test here needs a CUDA device and skips without one. The file imports
no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

K1, K4, K5, K6 (and its two halves K6a, K6b) and K7 must match bit for
bit (same arithmetic, no FMA contraction; max is order-free; K7's compact form stores each moving
row's result at its own cell); K2 (both epilogues), K8 and K3's forward sum with atomics
in another order, so they are held at 1e-5 in float32, and K3's backward
at 1e-5 of each output's maximum (its grad_inp bit for bit); in bf16 accumulation K2 and K8 round
at every add in another order than their plain versions, so both are held
against the f32 sums of the same rows, the kernel at most twice as far as
the plain version (also at channel widths that are not multiples of the
quarters' 8-channel reductions, with P not a multiple of 32); K9
at 2^-7 of max |plain| with at most 0.1 % of the elements more than one
bf16 ulp apart; a rollout through the kernels is held at 1e-4 against one
through the plain versions. The card branches of K1, K4 and compact K7
refuse a motion that requires grad, before they launch anything; dense
K7 takes one and differentiates it through its backward kernel
(``euler_phased_bwd``), held against the plain version's autograd within
1e-5 of the gradient's largest magnitude (f32 atomics in a run-to-run
order), on two launches, also on cases that exercise its window (one run
a row, window misses, partial tiles, the count rules, a static band, rows
leaving the frame, the training shape). K3's bf16 mode (bf16 rows, f32
flow) is held against the f32 sums of the same rows within the per-cell
bf16 bound (forward) and against its plain version bit for bit
(grad_inp) and 1e-5 of the max (grad_flow); a bf16 training step through
it against the plain step (losses 1e-2, gradients 0.25 in L2)."""

import numpy as np
import pytest
import torch

from slrsfs_tpu_torch import kernels
from slrsfs_tpu_torch.config import Options
from slrsfs_tpu_torch.engine import rollout
from slrsfs_tpu_torch.engine.rollout import (
    baseline_rollout,
    baseline_rollout_sparse,
    prepare_scene_sparse,
    slr_rollout_dense,
    slr_rollout_sparse,
)
from slrsfs_tpu_torch.models.baseline import BaselineModel, init_random_weights
from slrsfs_tpu_torch.models.slr import SLR_MODEL_TYPE, SLRModel
from slrsfs_tpu_torch.ops import euler as port_euler
from slrsfs_tpu_torch.ops import fused_conv, maxwarp
from slrsfs_tpu_torch.ops import splat as port_splat
from slrsfs_tpu_torch.ops.euler import (
    euler_compact_dual,
    euler_compact_dual_plain,
    euler_integrate_phased,
    euler_integrate_phased_compact,
    euler_integrate_phased_compact_plain,
    euler_integrate_phased_plain,
)
from slrsfs_tpu_torch.ops.splat import (
    SoftsplatSum,
    softsplat_sum,
    softsplat_sum_grad_plain,
    softsplat_sum_plain,
    splat_dual_normalize,
    splat_dual_normalize_plain,
    splat_dual_normalize_slr,
    splat_dual_normalize_slr_plain,
)

H, W = 40, 36


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _motion(seed, half_integer=False):
    rng = np.random.default_rng(seed)
    m = (rng.standard_normal((H, W, 2)) * 1.4).astype(np.float32)
    if half_integer:
        m = np.round(m * 2.0) / 2.0
    m[H - 5:, :, 1] += 5.0  # leaves the frame within a few steps
    m[: H // 3] = 0.0
    return m.astype(np.float32)


def _leaving(seed):
    """Fast random motion (~13 px a step): most trajectories leave the
    frame within a few steps and are pinned to their source; the top third
    is static."""
    rng = np.random.default_rng(seed)
    m = (rng.standard_normal((H, W, 2)) * 9.0).astype(np.float32)
    m[: H // 3] = 0.0
    return m


@pytest.mark.gpu
@pytest.mark.parametrize("odd", [False, True])
@pytest.mark.parametrize("case", ["continuous", "half_integer", "leaving"])
def test_k1_matches_plain_on_card(case, odd):
    """K1 bit for bit: padded rows at a static (0, 0), an odd P (a thread
    with one row; entries at 8-byte offsets on every other step), and a
    motion that most trajectories leave within a few steps."""
    dev = _card()
    m = _leaving(0) if case == "leaving" else _motion(0, case == "half_integer")
    pos, val = prepare_scene_sparse(m, pad_multiple=64)
    if odd:
        pos = pos[:-1]
    motion, positions = torch.from_numpy(m).to(dev), torch.from_numpy(pos).to(dev)
    kernels.reset_counts()
    kf, kb = euler_compact_dual(motion, positions, 9, 10)
    assert kernels.counts()[kernels.EULER.name] == 1
    pf, pb = euler_compact_dual_plain(motion, positions, 9, 10)
    torch.cuda.synchronize()
    assert torch.equal(kf, pf) and torch.equal(kb, pb)
    oob = max(H, W) + 1
    assert (kb == oob).any()
    if case == "leaving":  # most moving rows have left after 3 steps
        moving = torch.from_numpy(val[:len(pos)] != 0).to(dev)
        assert (kf[3, moving, 0] == oob).float().mean() > 0.5


def _special(d: torch.Tensor) -> torch.Tensor:
    d = d.clone()
    d[0::3] = max(H, W) + 1  # OOB sentinel
    d[1::3] = torch.tensor([3.0, -2.0])  # integer shift
    d[2::3] = torch.tensor([-0.75, -5.5])  # fractional border landing
    return d


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("slr", [False, True])
def test_k2_matches_plain_on_card(out_dtype, slr):
    dev = _card()
    rng = np.random.default_rng(1)
    m = _motion(1)
    pos, val = prepare_scene_sparse(m, pad_multiple=64)
    C1 = 17
    ez = np.exp(-rng.uniform(0, 3, (H, W, 1))).astype(np.float32)
    u = np.concatenate([rng.standard_normal((H, W, C1 - 1)).astype(np.float32)
                        * ez, ez], -1)
    if slr:  # [fs·e^Z, af·e^C, e^C, e^Z]
        u[..., -2] = np.exp(rng.uniform(0, 1, (H, W)))
    static = np.all(m == 0, axis=-1).astype(np.float32)[..., None]
    disp_f, disp_b = euler_compact_dual_plain(torch.from_numpy(m),
                                              torch.from_numpy(pos), 4, 5)
    da = disp_f[3].clone()
    da[0::3] = max(H, W) + 1  # OOB sentinel
    da[1::3] = torch.tensor([3.0, -2.0])  # integer shift
    t = [torch.from_numpy(x).to(dev) for x in
         (u[pos[:, 1], pos[:, 0]] * val[:, None], pos, val)]
    t += [da.to(dev), disp_b[2].to(dev)]
    u_static = torch.from_numpy(u * static).to(dev)
    wrapper, plain, n_norm = ((splat_dual_normalize_slr,
                               splat_dual_normalize_slr_plain, 2) if slr else
                              (splat_dual_normalize, splat_dual_normalize_plain, 1))
    out = torch.empty((H, W, C1 - n_norm), dtype=out_dtype, device=dev)
    kernels.reset_counts()
    wrapper(*t, 0.4, 0.6, u_static, out=out)
    assert kernels.counts()[kernels.SPLAT_SLR.name if slr
                            else kernels.SPLAT.name] == 1
    ref = plain(*t, 0.4, 0.6, u_static, out_dtype)
    torch.cuda.synchronize()
    rtol = 1e-5 if out_dtype == torch.float32 else 2 ** -8
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol, atol=1e-5)
    assert torch.equal(out == 0, ref == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rollout_kernels_match_plain_on_card(dtype):
    dev = _card()
    opt = Options(ngf=16, W=32, bn_noise_misc=True)
    model = BaselineModel(opt).eval()
    init_random_weights(model, seed=0)
    model = model.to(dev)
    rng = np.random.default_rng(2)
    flow = (rng.standard_normal((32, 32, 2)) * 1.2).astype(np.float32)
    flow[:16] = 0.0
    pos, val = prepare_scene_sparse(flow, pad_multiple=64)
    img = torch.from_numpy(rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32))
    args = (model, img.to(dev), torch.from_numpy(flow).to(dev), 6,
            torch.from_numpy(pos).to(dev), torch.from_numpy(val).to(dev))
    kernels.reset_counts()
    got = baseline_rollout_sparse(*args, decode_batch=3, compute_dtype=dtype)
    counts = kernels.counts()
    assert counts["euler_compact_dual"] == 1
    assert counts["splat_dual_normalize"] == 6
    want = baseline_rollout_sparse(*args, decode_batch=3, compute_dtype=dtype,
                                   plain=True)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


def _maxwarp_inputs(dev, case: str):
    if case == "256x256":  # the render's shape: half the rows move, P = 32768
        n = 256
        m = np.random.default_rng(7).standard_normal((n, n, 2)).astype(np.float32)
        m[: n // 2] = 0.0
    else:
        n, m = None, _motion(3)
    pos, val = prepare_scene_sparse(m, pad_multiple=64)
    disp_f, _ = euler_compact_dual_plain(torch.from_numpy(m),
                                         torch.from_numpy(pos), 6, 6)
    d = _special(disp_f[5]) if case == "special" else disp_f[5]
    if case == "all_rows_padded":
        val = np.zeros_like(val)
    z = torch.from_numpy(np.random.default_rng(4).standard_normal(m.shape[:2])
                         .astype(np.float32) * 4.0)
    static = torch.from_numpy(np.all(m == 0, axis=-1).astype(np.float32))
    p = torch.from_numpy(pos)
    z_mov = z[p[:, 1].long(), p[:, 0].long()].contiguous()
    if n is not None:
        assert p.shape[0] == n * n // 2
    return [t.to(dev) for t in (z, static, z_mov, p, torch.from_numpy(val), d)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["trajectory", "special", "all_rows_padded",
                                  "256x256"])
def test_k5_matches_plain_on_card(case):
    dev = _card()
    args = _maxwarp_inputs(dev, case)
    kernels.reset_counts()
    kd, km = maxwarp.maximum_warp_norm_sparse(*args)
    assert kernels.counts()[kernels.MAXWARP_SPARSE.name] == 1
    pd, pm = maxwarp.maximum_warp_norm_sparse_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(kd, pd) and torch.equal(km, pm)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["trajectory", "special", "batch2_256x256"])
def test_k6_matches_plain_on_card(case):
    dev = _card()
    if case == "batch2_256x256":
        rng = np.random.default_rng(8)
        flow = torch.from_numpy(rng.standard_normal((2, 256, 256, 2))
                                .astype(np.float32) * 3.0).to(dev)
        z = torch.from_numpy(rng.standard_normal((2, 256, 256, 1))
                             .astype(np.float32) * 4.0).to(dev)
    else:
        m = _motion(5)
        grid = torch.from_numpy(np.stack(np.meshgrid(np.arange(W), np.arange(H)),
                                         -1).reshape(-1, 2).astype(np.int32))
        disp_f, _ = euler_compact_dual_plain(torch.from_numpy(m), grid, 4, 4)
        d = _special(disp_f[3]) if case == "special" else disp_f[3]
        flow = d.reshape(1, H, W, 2).to(dev)
        z = torch.from_numpy(np.random.default_rng(6).standard_normal((1, H, W, 1))
                             .astype(np.float32) * 4.0).to(dev)
    kernels.reset_counts()
    got = maxwarp.maximum_warp_norm_splat(z, flow)
    assert kernels.counts()[kernels.MAXWARP_SPLAT.name] == 1
    want = maxwarp.maximum_warp_norm_splat_plain(z, flow)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` that starts 4 bytes past an 8-byte
    boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.gpu
def test_maxwarp_wrappers_refuse_misaligned_pairs_on_card():
    """K5 reads positions and disp, K6 the flow, as 8-byte pairs."""
    dev = _card()
    z, static, z_mov, p, val, d = _maxwarp_inputs(dev, "trajectory")
    with pytest.raises(ValueError, match="8-byte aligned"):
        maxwarp.maximum_warp_norm_sparse(z, static, z_mov, _misaligned(p), val, d)
    with pytest.raises(ValueError, match="8-byte aligned"):
        maxwarp.maximum_warp_norm_sparse(z, static, z_mov, p, val, _misaligned(d))
    flow = torch.zeros((1, H, W, 2), device=dev)
    with pytest.raises(ValueError, match="8-byte aligned"):
        maxwarp.maximum_warp_norm_splat(z[None, ..., None].contiguous(),
                                        _misaligned(flow))


def _maxsplat_inputs(dev, C: int, shape=(2, H, W - 3)):
    """(inp, flow) on ``dev``: a random flow with the CPU tests' special
    rows (tests/test_torch_maxsplat.py): the sentinel, integer shifts,
    landings across the top edge and pixels off the right edge."""
    B, h, w = shape
    rng = np.random.default_rng(C)
    inp = (rng.standard_normal((B, h, w, C)) * 3.0).astype(np.float32)
    flow = (rng.standard_normal((B, h, w, 2)) * 2.5).astype(np.float32)
    flow[0, 0::5] = max(h, w) + 1
    flow[0, 1::5] = [3.0, -2.0]
    flow[-1, 2::5] = [-0.75, -h + 0.5]
    flow[-1, :, -3:] = [w + 4.0, 0.25]
    return torch.from_numpy(inp).to(dev), torch.from_numpy(flow).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("C", [1, 3, 65])
def test_k6a_and_k6b_match_plain_on_card(C):
    """K6a (max_splat) and K6b (inverse_max_gather, on K6a's map and on a
    random one) bit for bit (torch.equal: ±0 equal), one launch each."""
    dev = _card()
    inp, flow = _maxsplat_inputs(dev, C)
    kernels.reset_counts()
    mx = maxwarp.max_splat(inp, flow)
    assert kernels.counts()[kernels.MAX_SPLAT.name] == 1
    torch.cuda.synchronize()
    assert torch.equal(mx, maxwarp.max_splat_plain(inp, flow))
    for maxmap in (mx, torch.randn_like(inp) * 3.0):
        got = maxwarp.inverse_max_gather(maxmap, flow, inp)
        torch.cuda.synchronize()
        assert torch.equal(got, maxwarp.inverse_max_gather_plain(maxmap, flow, inp))
    assert kernels.counts()[kernels.INVERSE_MAX_GATHER.name] == 2


@pytest.mark.gpu
def test_k6_pair_equals_the_one_launch_on_card():
    """At the dense v2 render's (1, 256, 256, 1) the pair gives K6's bits;
    above one channel K6's wrapper runs the pair, not K6."""
    dev = _card()
    z, flow = _maxsplat_inputs(dev, 1, (1, 256, 256))
    kernels.reset_counts()
    pair = maxwarp.inverse_max_gather(maxwarp.max_splat(z, flow), flow, z)
    one = maxwarp.maximum_warp_norm_splat(z, flow)
    torch.cuda.synchronize()
    assert torch.equal(pair, one)
    z2, flow2 = _maxsplat_inputs(dev, 2)
    kernels.reset_counts()
    got = maxwarp.maximum_warp_norm_splat(z2, flow2)
    n = kernels.counts()
    assert (n[kernels.MAX_SPLAT.name], n[kernels.INVERSE_MAX_GATHER.name],
            n[kernels.MAXWARP_SPLAT.name]) == (1, 1, 0)
    torch.cuda.synchronize()
    assert torch.equal(got, maxwarp.maximum_warp_norm_splat_plain(z2, flow2))


@pytest.mark.gpu
@pytest.mark.parametrize("bad", ["dtype", "layout", "device", "misaligned"])
def test_k6a_and_k6b_wrappers_refuse_on_card(bad):
    """float64 is a ``TypeError`` that names it; a non-contiguous input, a
    flow on another device and a flow off 8-byte alignment are
    ``ValueError``s; nothing is launched."""
    dev = _card()
    inp, flow = _maxsplat_inputs(dev, 3)
    if bad == "dtype":
        inp = inp.double()
    elif bad == "layout":
        inp = inp.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "device":
        flow = flow.cpu()
    else:
        flow = _misaligned(flow)
    kernels.reset_counts()
    err, match = (TypeError, "float64") if bad == "dtype" else (ValueError, None)
    with pytest.raises(err, match=match):
        maxwarp.max_splat(inp, flow)
    with pytest.raises(err, match=match):
        maxwarp.inverse_max_gather(inp, flow, inp)
    assert kernels.counts()[kernels.MAX_SPLAT.name] == 0
    assert kernels.counts()[kernels.INVERSE_MAX_GATHER.name] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("v2", [False, True])
def test_slr_rollout_kernels_match_plain_on_card(v2):
    """K1, K2-SLR and (v2) K5 against the plain path, and the sparse render
    against the dense one, whose v2 Z-norm runs K6."""
    dev = _card()
    opt = Options(ngf=16, W=32, bn_noise_misc=True, model_type=SLR_MODEL_TYPE,
                  use_alpha0_as_blending_weight=True,
                  use_softmax_splatter_v2=v2)
    model = SLRModel(opt).eval()
    init_random_weights(model, seed=0)
    model = model.to(dev)
    rng = np.random.default_rng(7)
    flow = (rng.standard_normal((32, 32, 2)) * 1.2).astype(np.float32)
    flow[:16] = 0.0
    pos, val = prepare_scene_sparse(flow, pad_multiple=64)
    img = torch.from_numpy(rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32))
    args = (model, img.to(dev), torch.from_numpy(flow).to(dev), 6,
            torch.from_numpy(pos).to(dev), torch.from_numpy(val).to(dev))
    kernels.reset_counts()
    got = slr_rollout_sparse(*args, decode_batch=3)
    counts = kernels.counts()
    assert counts[kernels.EULER.name] == 1
    assert counts[kernels.SPLAT_SLR.name] == 6
    assert counts[kernels.MAXWARP_SPARSE.name] == (6 if v2 else 0)
    want = slr_rollout_sparse(*args, decode_batch=3, plain=True)
    kernels.reset_counts()
    dense = slr_rollout_dense(*args[:4], decode_batch=3)
    assert kernels.counts()[kernels.MAXWARP_SPLAT.name] == (6 if v2 else 0)
    for k in got:
        torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(got[k], dense[k], rtol=1e-4, atol=1e-4)


def _phased_inputs(dev):
    """Four samples covering t_p = 0, t_f = 0, t_f + t_p = T and a middle
    case, on motion that leaves the frame, with a moving pixel at (0, 0)."""
    T = 12
    m = np.stack([_motion(10 + b) for b in range(4)])
    m[:, 0, 0] = [0.6, 0.4]
    t_f = torch.tensor([5, 0, 7, 3], dtype=torch.int32)
    t_p = torch.tensor([0, 6, 5, 4], dtype=torch.int32)
    return torch.from_numpy(m).to(dev), t_f.to(dev), t_p.to(dev), T


@pytest.mark.gpu
def test_k7_matches_plain_on_card():
    dev = _card()
    motion, t_f, t_p, T = _phased_inputs(dev)
    kernels.reset_counts()
    kf, kp = euler_integrate_phased(motion, t_f, t_p, T)
    assert kernels.counts()[kernels.EULER_PHASED.name] == 1
    pf, pp = euler_integrate_phased_plain(motion, t_f, t_p, T)
    torch.cuda.synchronize()
    assert torch.equal(kf, pf) and torch.equal(kp, pp)
    assert (kp == max(H, W) + 1).any()  # trajectories left the frame
    # compact: each sample's moving set, padded rows at (0, 0)
    B = motion.shape[0]
    pos = np.zeros((B, 1536, 2), np.int32)
    val = np.zeros((B, 1536), np.float32)
    for b in range(B):
        ys, xs = np.nonzero(np.any(motion[b].cpu().numpy() != 0, -1))
        pos[b, :len(xs)] = np.stack([xs, ys], -1)
        val[b, :len(xs)] = 1.0
    args = (motion, torch.from_numpy(pos).to(dev), torch.from_numpy(val).to(dev),
            t_f, t_p, T)
    cf, cp = euler_integrate_phased_compact(*args)
    qf, qp = euler_integrate_phased_compact_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(cf, qf) and torch.equal(cp, qp)
    assert torch.equal(cf, pf) and torch.equal(cp, pp)  # compact == dense


def _integrator_calls(dev):
    """The seven card wrappers of K1, K4 and K7, each as (name, kernel,
    fn(motion)) on one small case."""
    m = _motion(8)
    pos = torch.from_numpy(prepare_scene_sparse(m, pad_multiple=64)[0]).to(dev)
    _, t_f, t_p, T = _phased_inputs(dev)
    B = t_f.shape[0]
    pos_b = torch.zeros((B, 64, 2), dtype=torch.int32, device=dev)
    val_b = torch.ones((B, 64), dtype=torch.float32, device=dev)
    e = port_euler
    return [
        ("euler_compact_dual", kernels.EULER, lambda mm: e.euler_compact_dual(mm, pos, 3, 4)),
        ("euler_integrate_all", kernels.EULER_ALL, lambda mm: e.euler_integrate_all(mm, 3)),
        ("euler_integrate", kernels.EULER_ALL, lambda mm: e.euler_integrate(mm, 3)),
        ("euler_integrate_compact", kernels.EULER_ALL,
         lambda mm: e.euler_integrate_compact(mm, pos, 3)),
        ("euler_integrate_all_dual", kernels.EULER_ALL,
         lambda mm: e.euler_integrate_all_dual(mm, 3, 4)),
        ("euler_integrate_phased", kernels.EULER_PHASED,
         lambda mm: e.euler_integrate_phased(mm.expand(B, -1, -1, -1).contiguous(),
                                             t_f, t_p, T)),
        ("euler_integrate_phased_compact", kernels.EULER_PHASED,
         lambda mm: e.euler_integrate_phased_compact(
             mm.expand(B, -1, -1, -1).contiguous(), pos_b, val_b, t_f, t_p, T)),
    ]


@pytest.mark.gpu
def test_integrators_refuse_a_motion_gradient_on_card():
    """K1, K4 and compact K7 have no backward: on the card each wrapper
    raises for a motion that requires grad under grad mode, before it
    launches anything, and runs under torch.no_grad(). Dense K7 has one and
    does not raise (``test_k7_backward_matches_plain_autograd_on_card``)."""
    dev = _card()
    motion = torch.from_numpy(_motion(8)).to(dev).requires_grad_(True)
    for name, kernel, fn in _integrator_calls(dev):
        if name == "euler_integrate_phased":
            continue
        kernels.reset_counts()
        with pytest.raises(RuntimeError, match="no backward"):
            fn(motion)
        assert sum(kernels.counts().values()) == 0, name
        with torch.no_grad():
            fn(motion)
        assert kernels.counts()[kernel.name] == 1, name
    torch.cuda.synchronize()


def _k3_inputs(dev, C=9, B=2):
    rng = np.random.default_rng(20)
    inp = rng.standard_normal((B, H, W, C)).astype(np.float32)
    flow = (rng.standard_normal((B, H, W, 2)) * 3.0).astype(np.float32)
    flow[:, ::5] = np.round(flow[:, ::5])  # integer landings
    flow[0, :4, :4] = max(H, W) + 1  # the OOB sentinel
    return (torch.from_numpy(inp).to(dev), torch.from_numpy(flow).to(dev),
            torch.from_numpy(rng.standard_normal((B, H, W, C))
                             .astype(np.float32)).to(dev))


@pytest.mark.gpu
def test_k3_matches_plain_on_card():
    dev = _card()
    inp, flow, g = _k3_inputs(dev, C=65)
    kernels.reset_counts()
    out = softsplat_sum(inp, flow)
    ref = softsplat_sum_plain(inp, flow)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    assert torch.equal(out == 0, ref == 0)
    x = inp.clone().requires_grad_(True)
    f = flow.clone().requires_grad_(True)
    SoftsplatSum.apply(x, f, False).backward(g)
    assert kernels.counts()[kernels.SPLAT_DENSE_FWD.name] == 2
    assert kernels.counts()[kernels.SPLAT_DENSE_BWD.name] == 1
    want_i, want_f = softsplat_sum_grad_plain(inp, flow, g)
    torch.cuda.synchronize()
    for got, want in ((x.grad, want_i), (f.grad, want_f)):
        scale = want.abs().max().item()
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * scale)


@pytest.mark.gpu
def test_k3_gradcheck_on_card():
    """The Function's gradients on the card (f32 kernels) against a
    finite-difference check of the plain version in float64 on the same
    inputs, on a flow with no integer landings (the splat is piecewise
    bilinear in the flow)."""
    dev = _card()
    rng = np.random.default_rng(21)
    x = torch.from_numpy(rng.standard_normal((1, 6, 7, 3))).to(dev)
    f = torch.from_numpy(rng.uniform(-1.7, 1.7, (1, 6, 7, 2)) + 0.123).to(dev)
    assert torch.autograd.gradcheck(
        lambda a, b: SoftsplatSum.apply(a, b, True),
        (x.clone().requires_grad_(True), f.clone().requires_grad_(True)))
    g = torch.from_numpy(rng.standard_normal((1, 6, 7, 3))).to(dev)
    want = softsplat_sum_grad_plain(x, f, g)
    x32 = x.float().requires_grad_(True)
    f32 = f.float().requires_grad_(True)
    softsplat_sum(x32, f32).backward(g.float())
    torch.testing.assert_close(x32.grad.double(), want[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(f32.grad.double(), want[1], rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("odd", [False, True])
@pytest.mark.parametrize("case", ["continuous", "half_integer", "leaving"])
def test_k4_matches_plain_on_card(case, odd):
    """Every form of K4: dense dual, dense and last-step with visibility,
    compact with visibility, and n_steps = 0; on a motion most trajectories
    leave within a few steps, and with an odd row count (a 39 x 35 grid and
    an odd P)."""
    dev = _card()
    m_np = _leaving(8) if case == "leaving" else _motion(8, case == "half_integer")
    if odd:
        m_np = np.ascontiguousarray(m_np[:H - 1, :W - 1])
    m = torch.from_numpy(m_np).to(dev)
    pos = torch.from_numpy(prepare_scene_sparse(m_np, pad_multiple=64)[0]).to(dev)
    if odd:
        pos = pos[:-1]
    kernels.reset_counts()
    pairs = [(port_euler.euler_integrate_all_dual(m, 9, 10),
              port_euler.euler_integrate_all_dual_plain(m, 9, 10))]
    for n in (0, 7):
        pairs += [(port_euler.euler_integrate_all(m, n),
                   port_euler.euler_integrate_all_plain(m, n)),
                  (port_euler.euler_integrate(m, n),
                   port_euler.euler_integrate_plain(m, n)),
                  (port_euler.euler_integrate_compact(m, pos, n),
                   port_euler.euler_integrate_compact_plain(m, pos, n))]
    assert kernels.counts()[kernels.EULER_ALL.name] == 7
    torch.cuda.synchronize()
    for got, want in pairs:
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (pairs[0][0][1] == max(m.shape[:2]) + 1).any()


def _splat_at_inputs(dev, dtype):
    m = _motion(9)
    pos, val = prepare_scene_sparse(m, pad_multiple=64)
    rng = np.random.default_rng(9)
    u = (rng.standard_normal((len(val), 17)) * val[:, None]).astype(np.float32)
    disp_f, disp_b = euler_compact_dual_plain(torch.from_numpy(m),
                                              torch.from_numpy(pos), 4, 5)
    return (torch.from_numpy(u).to(dev).to(dtype), torch.from_numpy(pos).to(dev),
            _special(disp_f[3]).to(dev), disp_b[2].to(dev))


def _held(got, want, dtype, ref32=None):
    """f32: 1e-5 and the same zeros; bf16: the kernel at most twice as far
    from the f32 sums ``ref32`` as the plain version ``want``."""
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        assert torch.equal(got == 0, want == 0)
    else:
        d_k = (got.float() - ref32).abs().max().item()
        d_p = (want.float() - ref32).abs().max().item()
        assert d_k <= 2.0 * d_p, (d_k, d_p)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k8_matches_plain_on_card(dtype):
    dev = _card()
    u, pos, da, db = _splat_at_inputs(dev, dtype)
    kernels.reset_counts()
    one = port_splat.softsplat_sum_at(u, pos, da, H, W)
    two = port_splat.softsplat_sum_at_quad_dual(u, pos, da, db, 0.3, 0.7, H, W)
    assert kernels.counts()[kernels.SPLAT_SUM_AT.name] == 2
    assert one.dtype == two.dtype == dtype
    want_one = port_splat.softsplat_sum_at_plain(u, pos, da, H, W)
    want_two = port_splat.softsplat_sum_at_quad_dual_plain(u, pos, da, db, 0.3,
                                                           0.7, H, W)
    u32 = u.float()
    ref_one = port_splat.softsplat_sum_at_plain(u32, pos, da, H, W)
    ref_two = port_splat.softsplat_sum_at_quad_dual_plain(u32, pos, da, db, 0.3,
                                                          0.7, H, W)
    torch.cuda.synchronize()
    _held(one, want_one, dtype, ref_one)
    _held(two, want_two, dtype, ref_two)


@pytest.mark.gpu
@pytest.mark.parametrize("slr", [False, True])
def test_k2_bf16_accumulation_matches_plain_on_card(slr):
    """K2 with bf16 rows, u_static and accumulator (the bfloat16-fast
    mode), both epilogues."""
    dev = _card()
    u, pos, da, db = _splat_at_inputs(dev, torch.float32)
    u = u.abs()  # [.., weight channels]: the normalisers are positive
    val = (u.abs().sum(-1) > 0).to(torch.float32)
    u_static = torch.from_numpy(np.abs(np.random.default_rng(10).standard_normal(
        (H, W, u.shape[1]))).astype(np.float32)).to(dev)
    u_static[: H // 2] = 0.0
    u, u_static = u.to(torch.bfloat16), u_static.to(torch.bfloat16)
    wrapper, plain, n_norm = ((splat_dual_normalize_slr,
                               splat_dual_normalize_slr_plain, 2) if slr else
                              (splat_dual_normalize, splat_dual_normalize_plain, 1))
    out = torch.empty((H, W, u.shape[1] - n_norm), dtype=torch.float32, device=dev)
    kernels.reset_counts()
    wrapper(u, pos, val, da, db, 0.4, 0.6, u_static, out=out)
    assert sum(kernels.counts().values()) == 1
    want = plain(u, pos, val, da, db, 0.4, 0.6, u_static, torch.float32)
    ref32 = plain(u.float(), pos, val, da, db, 0.4, 0.6, u_static.float(),
                  torch.float32)
    torch.cuda.synchronize()
    _held(out, want, torch.bfloat16, ref32)
    assert torch.equal(out == 0, want == 0)  # positive rows: no cancellation


def _quarter_inputs(dev, C1: int):
    """Positive rows of width C1 (normalisers > 0, so no sum cancels to 0),
    P = 999 (not a multiple of 32) with 27 padded rows (valid 0, zero rows
    at (0, 0)), the sentinel/integer/border displacements at one end, and
    a positive static identity in the bottom half."""
    m = _motion(11)
    pos, val = prepare_scene_sparse(m, pad_multiple=37)
    assert len(val) % 32 and (val == 0).any()
    rng = np.random.default_rng(C1)
    u = np.abs(rng.standard_normal((len(val), C1))).astype(np.float32) * val[:, None]
    u_static = np.abs(rng.standard_normal((H, W, C1))).astype(np.float32)
    u_static[: H // 2] = 0.0
    disp_f, disp_b = euler_compact_dual_plain(torch.from_numpy(m),
                                              torch.from_numpy(pos), 4, 5)
    bf = torch.bfloat16
    return (torch.from_numpy(u).to(dev).to(bf), torch.from_numpy(pos).to(dev),
            torch.from_numpy(val).to(dev), _special(disp_f[3]).to(dev),
            disp_b[2].to(dev), torch.from_numpy(u_static).to(dev).to(bf))


@pytest.mark.gpu
@pytest.mark.parametrize("C1", [3, 9, 65, 66, 67])
@pytest.mark.parametrize("entry", ["K2", "K2-SLR", "K8"])
def test_bf16_quarters_match_plain_on_card(entry, C1):
    """The bf16 quarters (channel stride C1 rounded up to a multiple of 8,
    8 channels per 16-byte reduction) of K2, K2-SLR and K8 (one end and two
    ends) at widths that are and are not multiples of 8: the kernel at
    most twice as far from the f32 sums as the plain version, with the
    same zeros."""
    dev = _card()
    u, pos, val, da, db, u_static = _quarter_inputs(dev, C1)
    kernels.reset_counts()
    if entry == "K8":
        got = [port_splat.softsplat_sum_at(u, pos, da, H, W),
               port_splat.softsplat_sum_at_quad_dual(u, pos, da, db, 0.3, 0.7, H, W)]
        launches = {kernels.SPLAT_SUM_AT.name: 2}
        want, ref32 = ([port_splat.softsplat_sum_at_plain(x, pos, da, H, W),
                        port_splat.softsplat_sum_at_quad_dual_plain(x, pos, da, db,
                                                                    0.3, 0.7, H, W)]
                       for x in (u, u.float()))
    else:
        slr = entry == "K2-SLR"
        wrapper, plain, n_norm, kernel = (
            (splat_dual_normalize_slr, splat_dual_normalize_slr_plain, 2,
             kernels.SPLAT_SLR) if slr else
            (splat_dual_normalize, splat_dual_normalize_plain, 1, kernels.SPLAT))
        out = torch.empty((H, W, C1 - n_norm), device=dev)
        got = [wrapper(u, pos, val, da, db, 0.4, 0.6, u_static, out=out)]
        launches = {kernel.name: 1}
        want, ref32 = ([plain(x, pos, val, da, db, 0.4, 0.6, us, torch.float32)]
                       for x, us in ((u, u_static), (u.float(), u_static.float())))
    assert {k: v for k, v in kernels.counts().items() if v} == launches
    torch.cuda.synchronize()
    for g, w, r in zip(got, want, ref32):
        _held(g, w, torch.bfloat16, r)
        assert torch.equal(g == 0, w == 0)


@pytest.mark.gpu
def test_k2_refuses_a_misaligned_bf16_scratch_on_card():
    """The quarters take 16-byte reductions: a bf16 scratch of the right
    size that is only 8-byte aligned is refused before any launch."""
    dev = _card()
    u, pos, val, da, db, u_static = _quarter_inputs(dev, 65)
    n = port_splat._scratch_numel(H, W, 65, torch.bfloat16)
    buf = torch.zeros((n + 8,), dtype=torch.bfloat16, device=dev)
    out = torch.empty((H, W, 64), device=dev)
    kernels.reset_counts()
    with pytest.raises(ValueError, match="16-byte aligned"):
        splat_dual_normalize(u, pos, val, da, db, 0.4, 0.6, u_static, out=out,
                             acc=buf[4:4 + n])
    assert sum(kernels.counts().values()) == 0


@pytest.mark.gpu
def test_dense_rollout_kernels_match_plain_on_card():
    """baseline_rollout through K4 and K3's forward against its plain
    path."""
    dev = _card()
    opt = Options(ngf=16, W=32, bn_noise_misc=True)
    model = BaselineModel(opt).eval()
    init_random_weights(model, seed=0)
    model = model.to(dev)
    rng = np.random.default_rng(12)
    flow = torch.from_numpy(rng.standard_normal((32, 32, 2)).astype(np.float32)).to(dev)
    img = torch.from_numpy(rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)).to(dev)
    kernels.reset_counts()
    got = baseline_rollout(model, img, flow, 5)
    counts = kernels.counts()
    assert counts[kernels.EULER_ALL.name] == 1
    assert counts[kernels.SPLAT_DENSE_FWD.name] == 10
    want = baseline_rollout(model, img, flow, 5, plain=True)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def _k9_check(shape, seed):
    from slrsfs_tpu_torch.tools.conv_prototype import compare, within_limits

    dev = _card()
    B, Hc, Wc, C, F = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn((B, Hc, Wc, C), generator=g, device=dev) * 0.5).to(torch.bfloat16)
    waa = (torch.randn((3, 3, C, F), generator=g, device=dev) / (9 * C) ** 0.5
           ).to(torch.bfloat16)
    wab = (torch.randn((3, 3, F, F), generator=g, device=dev) / (9 * F) ** 0.5
           ).to(torch.bfloat16)
    kernels.reset_counts()
    got = fused_conv.fused_conv3x3_relu_conv3x3(x, waa, wab)
    assert kernels.counts()[kernels.FUSED_CONV.name] == 1
    want = fused_conv.conv_chain_plain(x, waa, wab)
    torch.cuda.synchronize()
    c = compare(got, want)
    assert within_limits(c), c


@pytest.mark.gpu
def test_k9_matches_plain_on_card():
    _k9_check((2, 32, 48, 128, 128), seed=13)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 37, 29, 128, 128), (2, 9, 13, 32, 64)])
def test_k9_ragged_matches_plain_on_card(shape):
    """H and W that the tile does not divide, and narrower C and F."""
    _k9_check(shape, seed=14)


@pytest.mark.gpu
@pytest.mark.parametrize("C, F", [(128, 128), (16, 32), (64, 128), (128, 64)])
def test_k9_block_fits_the_card(C, F):
    """The kernel's block, at each of its instantiations (one or two
    64-channel swizzle rows of C and F), fits the card's shared memory;
    at C = F = 128 it is the 1024 alignment bytes, the 3-slot ring, the
    12 x 20 slab, the 10 x 18 h (rows of 128 + 8 bf16) and 6 mbarriers."""
    dev = _card()
    got = kernels.FUSED_CONV.query("fused_conv_smem_bytes", C, F)
    assert 0 < got <= torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    if C == F == 128:
        assert got == 1024 + 3 * 32768 + 12 * 20 * 136 * 2 + 10 * 18 * 136 * 2 + 48
    assert kernels.FUSED_CONV.query("fused_conv_smem_bytes", C + 8, F) == -1


# ---- the f32 tile-and-window scatter (K2, K8, K3's forward) -------------
#
# A ragged grid (37 x 53: neither side a multiple of K3's tile), channel
# widths 1, 3, 65 and 67, rows at the OOB sentinel, padded rows (valid 0),
# and either a smooth displacement (most corners in their window) or a
# uniform one of +-40 px (most corners outside it, each then an entry of
# its own). Held as chip_smoke.py holds them: atol/rtol 1e-5 and the same
# empty cells (every channel exactly 0), since both sides sum by atomics
# and a signed sum can cancel to exactly 0 in one order only.

HR, WR = 37, 53


def _same_empty_cells(got, want):
    assert torch.equal((got == 0).all(-1), (want == 0).all(-1))


def _window_rows(dev, C1: int, far: bool, slr: bool = False):
    """Rows of width C1 ([signed features · e^Z, (SLR: af·e^C, e^C,) e^Z])
    from the moving bottom two thirds of the grid, padded to a multiple of
    37 rows (valid 0, zero rows at (0, 0)), their static identity, and two
    ends' displacements: smooth or uniform +-40 px, every 7th row at the
    OOB sentinel."""
    rng = np.random.default_rng(100 + C1 + 7 * far + 3 * slr)
    m = np.zeros((HR, WR, 2), np.float32)
    m[HR // 3:] = 1.0
    pos, val = prepare_scene_sparse(m, pad_multiple=37)
    assert (val == 0).any()
    u = rng.standard_normal((HR, WR, C1)).astype(np.float32)
    n_pos = 2 if slr else 1
    u[..., -n_pos:] = np.exp(rng.uniform(-2, 1, (HR, WR, n_pos)))
    static = np.all(m == 0, axis=-1)[..., None].astype(np.float32)
    u_mov = u[pos[:, 1], pos[:, 0]] * val[:, None]
    disps = []
    for _ in range(2):
        if far:
            d = rng.uniform(-40.0, 40.0, (len(val), 2))
        else:
            yy = pos[:, 1].astype(np.float64)
            xx = pos[:, 0].astype(np.float64)
            d = np.stack([3.0 * np.sin(yy / 7.0) + 0.4 * xx / WR,
                          2.0 * np.cos(xx / 9.0) - 1.0], -1) + rng.normal(0, 0.3, (len(val), 2))
        d[0::7] = max(HR, WR) + 1
        disps.append(torch.from_numpy(d.astype(np.float32)).to(dev))
    return (torch.from_numpy(u_mov).to(dev), torch.from_numpy(pos).to(dev),
            torch.from_numpy(val).to(dev), disps[0], disps[1],
            torch.from_numpy(u * static).to(dev))


@pytest.mark.gpu
@pytest.mark.parametrize("far", [False, True], ids=["smooth", "far"])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("C1", [1, 3, 65, 67])
@pytest.mark.parametrize("slr", [False, True], ids=["K2", "K2-SLR"])
def test_k2_f32_window_scatter_matches_plain_on_card(slr, C1, out_dtype, far):
    """K2's f32 mode (both epilogues) at ragged shapes and widths; cells
    that no moving tap reaches give the plain version's quotient of
    u_static bit for bit. A bf16 output is the f32 quotient rounded once:
    it is held within 2^-8 (a bf16 rounding) of the plain version's f32
    quotient, plus 1e-5, since a quotient 1e-7 away from the plain one can
    round to the neighbouring bf16 value."""
    if slr and C1 < 3:
        pytest.skip("the SLR layout has at least 3 channels")
    dev = _card()
    u, pos, val, da, db, u_static = _window_rows(dev, C1, far, slr)
    wrapper, plain, n_norm, kernel = (
        (splat_dual_normalize_slr, splat_dual_normalize_slr_plain, 2, kernels.SPLAT_SLR)
        if slr else (splat_dual_normalize, splat_dual_normalize_plain, 1, kernels.SPLAT))
    out = torch.empty((HR, WR, C1 - n_norm), dtype=out_dtype, device=dev)
    kernels.reset_counts()
    wrapper(u, pos, val, da, db, 0.4, 0.6, u_static, out=out)
    assert {k: v for k, v in kernels.counts().items() if v} == {kernel.name: 1}
    ref = plain(u, pos, val, da, db, 0.4, 0.6, u_static, out_dtype)
    ref32 = plain(u, pos, val, da, db, 0.4, 0.6, u_static, torch.float32)
    torch.cuda.synchronize()
    rtol = 1e-5 if out_dtype == torch.float32 else 2 ** -8
    torch.testing.assert_close(out.float(), ref32, rtol=rtol, atol=1e-5)
    _same_empty_cells(out, ref)
    reached = port_splat.softsplat_sum_at_quad_dual_plain(
        (u.abs() + 1.0) * val[:, None], pos, da, db, 1.0, 1.0, HR, WR)[..., 0] != 0
    assert torch.equal(out[~reached], ref[~reached])


@pytest.mark.gpu
@pytest.mark.parametrize("far", [False, True], ids=["smooth", "far"])
@pytest.mark.parametrize("C", [1, 3, 65, 67])
def test_k8_f32_window_scatter_matches_plain_on_card(C, far):
    """K8's f32 mode, one end and two, at ragged shapes and widths (the
    padded rows are zero, K8 has no valid flags)."""
    dev = _card()
    u, pos, _, da, db, _ = _window_rows(dev, C, far)
    kernels.reset_counts()
    one = port_splat.softsplat_sum_at(u, pos, da, HR, WR)
    two = port_splat.softsplat_sum_at_quad_dual(u, pos, da, db, 0.3, 0.7, HR, WR)
    assert {k: v for k, v in kernels.counts().items() if v} == {kernels.SPLAT_SUM_AT.name: 2}
    want_one = port_splat.softsplat_sum_at_plain(u, pos, da, HR, WR)
    want_two = port_splat.softsplat_sum_at_quad_dual_plain(u, pos, da, db, 0.3, 0.7, HR, WR)
    torch.cuda.synchronize()
    for got, want in ((one, want_one), (two, want_two)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        _same_empty_cells(got, want)
        assert (want == 0).all(-1).any()  # some cells stay empty


@pytest.mark.gpu
@pytest.mark.parametrize("far", [False, True], ids=["smooth", "far"])
@pytest.mark.parametrize("C", [1, 3, 65, 67])
def test_k3_window_scatter_matches_plain_on_card(C, far):
    """K3's forward at B = 3 on a ragged grid, with integer landings and a
    block of OOB sentinels."""
    dev = _card()
    rng = np.random.default_rng(200 + C + 7 * far)
    inp = rng.standard_normal((3, HR, WR, C)).astype(np.float32)
    if far:
        flow = rng.uniform(-40.0, 40.0, (3, HR, WR, 2))
    else:
        yy, xx = np.mgrid[0:HR, 0:WR].astype(np.float64)
        flow = np.stack([2.5 * np.sin(yy / 6.0), 1.5 * np.cos(xx / 8.0)], -1)[None] \
            + rng.normal(0, 0.3, (3, HR, WR, 2))
    flow = flow.astype(np.float32)
    flow[:, ::5] = np.round(flow[:, ::5])  # integer landings
    flow[1, :6, :9] = max(HR, WR) + 1  # the OOB sentinel
    inp, flow = torch.from_numpy(inp).to(dev), torch.from_numpy(flow).to(dev)
    kernels.reset_counts()
    out = softsplat_sum(inp, flow)
    assert {k: v for k, v in kernels.counts().items() if v} == {
        kernels.SPLAT_DENSE_FWD.name: 1}
    ref = softsplat_sum_plain(inp, flow)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    _same_empty_cells(out, ref)


@pytest.mark.gpu
def test_k3_window_scatter_with_staged_rows_matches_plain_on_card():
    """K3's forward on an input larger than the card's L2 (4 x 256 x 256 x
    65 f32, 68 MB), where the kernel stages each tile's rows in shared
    memory: the training batch's path."""
    dev = _card()
    rng = np.random.default_rng(300)
    B, Hs, Ws, C = 4, 256, 256, 65
    assert B * Hs * Ws * C * 4 > torch.cuda.get_device_properties(dev).L2_cache_size
    yy, xx = np.mgrid[0:Hs, 0:Ws].astype(np.float64)
    flow = (np.stack([3.0 * np.sin(yy / 17.0), 2.0 * np.cos(xx / 23.0)], -1)[None]
            + rng.normal(0, 0.5, (B, Hs, Ws, 2))).astype(np.float32)
    flow[1, :8] = max(Hs, Ws) + 1  # the OOB sentinel
    flow[2] = rng.uniform(-40.0, 40.0, (Hs, Ws, 2))  # far: the direct path
    inp = torch.randn((B, Hs, Ws, C), generator=torch.Generator(device=dev).manual_seed(300),
                      device=dev)
    flow = torch.from_numpy(flow).to(dev)
    kernels.reset_counts()
    out = softsplat_sum(inp, flow)
    assert kernels.counts()[kernels.SPLAT_DENSE_FWD.name] == 1
    ref = softsplat_sum_plain(inp, flow)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    _same_empty_cells(out, ref)


@pytest.mark.gpu
def test_window_geometry_fits_the_card():
    """The libraries report the window geometry that the host's miss count
    (ops/splat.py) repeats: runs and tiles of at most 32 items, and windows
    of at least a unit's bounding box under smooth flow."""
    _card()
    run = kernels.SPLAT.query("splat_rows_run")
    ty = kernels.SPLAT_DENSE_FWD.query("splat_dense_tile_rows")
    tx = kernels.SPLAT_DENSE_FWD.query("splat_dense_tile_cols")
    assert 1 <= run <= 32 and 1 <= ty * tx <= 32
    assert kernels.SPLAT.query("splat_rows_window_cells") >= 2 * (run + 1)
    assert kernels.SPLAT_DENSE_FWD.query("splat_dense_window_cells") >= (ty + 1) * (tx + 1)


def _k3_bwd_case(dev, C: int, case: str):
    """K3's backward inputs on a ragged grid (37 x 45: neither a multiple of
    the 4 x 8 tile, and odd rows start at every phase of 16 bytes).
    "smooth": smooth flow with integer landings, a block of OOB sentinels
    and corners pushed off the grid on every side (B = 2); "far": flow of
    up to 40 pixels, most corners outside their tile's window (B = 1);
    "offset": the smooth case with inp and g starting 8 bytes past a
    16-byte boundary (B = 3)."""
    rng = np.random.default_rng(400 + C + 17 * len(case))
    B = {"smooth": 2, "far": 1, "offset": 3}[case]
    Hc, Wc = 37, 45
    if case == "far":
        flow = rng.uniform(-40.0, 40.0, (B, Hc, Wc, 2))
    else:
        yy, xx = np.mgrid[0:Hc, 0:Wc].astype(np.float64)
        flow = np.stack([2.5 * np.sin(yy / 6.0), 1.5 * np.cos(xx / 8.0)], -1)[None] \
            + rng.normal(0, 0.3, (B, Hc, Wc, 2))
        flow[:, ::5] = np.round(flow[:, ::5])  # integer landings
        flow[:, :, :3, 0] -= 4.0  # off the grid: left,
        flow[:, :, -3:, 0] += 4.0  # right,
        flow[:, :3, :, 1] -= 4.0  # top
        flow[:, -3:, :, 1] += 4.0  # and bottom
        flow[-1, 10:16, 8:20] = max(Hc, Wc) + 1  # the OOB sentinel
    shape = (B, Hc, Wc, C)

    def rows(seed):
        x = torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                             .astype(np.float32)).to(dev)
        if case != "offset":
            return x
        buf = torch.empty(x.numel() + 4, device=dev)
        start = (4 - buf.data_ptr() // 4 % 4 + 2) % 4  # 8 bytes past 16
        view = buf[start:start + x.numel()].view(shape)
        view.copy_(x)
        assert view.data_ptr() % 16 == 8
        return view

    return rows(1), torch.from_numpy(flow.astype(np.float32)).to(dev), rows(2)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["smooth", "far", "offset"])
@pytest.mark.parametrize("C", [1, 3, 64, 65, 67, 130])
def test_k3_backward_matches_plain_on_card(C, case):
    """K3's staged backward against its plain version, each output within
    1e-5 of its largest magnitude, grad_inp bit for bit (the same adds in
    the same order)."""
    dev = _card()
    inp, flow, g = _k3_bwd_case(dev, C, case)
    kernels.reset_counts()
    gi, gf = port_splat.softsplat_sum_bwd_kernel(inp, flow, g)
    assert {k: v for k, v in kernels.counts().items() if v} == {
        kernels.SPLAT_DENSE_BWD.name: 1}
    wi, wf = softsplat_sum_grad_plain(inp, flow, g)
    torch.cuda.synchronize()
    for got, want in ((gi, wi), (gf, wf)):
        scale = want.abs().max().item()
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * scale)
    assert torch.equal(gi, wi)


@pytest.mark.gpu
def test_k3_backward_geometry_fits_the_card():
    """The backward's tile is one pixel a lane and, at the training width
    C = 65, its window holds a tile's corners under smooth flow; the host's
    per-tile miss count runs on that geometry."""
    _card()
    lib = kernels.SPLAT_DENSE_BWD
    ty, tx = lib.query("splat_dense_bwd_tile_rows"), lib.query("splat_dense_bwd_tile_cols")
    assert ty * tx == 32
    assert lib.query("splat_dense_bwd_window_cells", 65) >= (ty + 1) * (tx + 1)
    assert lib.query("splat_dense_bwd_window_cells", 4096) == 0
    flow = torch.zeros((1, 16, 16, 2))
    assert port_splat.dense_window_units(flow, (ty, tx), 45) == (8, 0)


def _k7_case(dev, case: str):
    """K7's inputs on a 37 x 45 grid (1665 pixels, not a multiple of the
    kernel's 4 trajectories a thread), T = 14: "counts": t_f = 0, t_p = 0,
    t_f + t_p = T and t_f + t_p < T; "leaving": fast motion that leaves
    the frame early in each phase. A third of each sample is static and the
    pixel at (0, 0) moves."""
    T, Hc, Wc = 14, 37, 45
    rng = np.random.default_rng(500 + len(case))
    scale = 1.3 if case == "counts" else 6.0
    m = (rng.standard_normal((5, Hc, Wc, 2)) * scale).astype(np.float32)
    m[:, Hc - 4:, :, 1] += 4.0
    m[:, 1: Hc // 3] = 0.0
    m[:, 0, 0] = [0.5, 1.5]
    t_f = np.array([0, 9, 6, 3, 14], np.int32)
    t_p = np.array([14, 0, 8, 4, 0], np.int32)
    if case == "leaving":
        t_f, t_p = np.array([14, 0, 7, 2, 5], np.int32), np.array([0, 14, 7, 9, 3], np.int32)
    return (torch.from_numpy(m).to(dev), torch.from_numpy(t_f).to(dev),
            torch.from_numpy(t_p).to(dev), T)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["counts", "leaving"])
def test_k7_forms_match_plain_on_card(case):
    """K7 bit for bit against its plain versions, dense and compact, and
    compact equal to dense: counts that leave a phase out or stop short of
    T, trajectories that leave the frame in each phase (the kernel's early
    exit), a pixel count and a P that are not multiples of 4, padded rows
    at (0, 0) beside a moving pixel there."""
    dev = _card()
    motion, t_f, t_p, T = _k7_case(dev, case)
    kernels.reset_counts()
    kf, kp = euler_integrate_phased(motion, t_f, t_p, T)
    pf, pp = euler_integrate_phased_plain(motion, t_f, t_p, T)
    torch.cuda.synchronize()
    assert torch.equal(kf, pf) and torch.equal(kp, pp)
    oob = max(motion.shape[1:3]) + 1
    assert (pf == oob).any() and (pp == oob).any()  # left in each phase
    B = motion.shape[0]
    P = 1237  # not a multiple of 4; every sample has padded rows
    pos = np.zeros((B, P, 2), np.int32)
    val = np.zeros((B, P), np.float32)
    m_np = motion.cpu().numpy()
    for b in range(B):
        ys, xs = np.nonzero(np.any(m_np[b] != 0, -1))
        assert 0 < len(xs) < P
        pos[b, :len(xs)] = np.stack([xs, ys], -1)
        val[b, :len(xs)] = 1.0
    args = (motion, torch.from_numpy(pos).to(dev), torch.from_numpy(val).to(dev),
            t_f, t_p, T)
    cf, cp = euler_integrate_phased_compact(*args)
    qf, qp = euler_integrate_phased_compact_plain(*args)
    torch.cuda.synchronize()
    assert kernels.counts()[kernels.EULER_PHASED.name] == 2
    assert torch.equal(cf, qf) and torch.equal(cp, qp)
    assert torch.equal(cf, pf) and torch.equal(cp, pp)  # compact == dense
    assert (cf[:, 0, 0] != 0).any()  # the moving pixel at (0, 0)


@pytest.mark.gpu
def test_k3_backward_refuses_rows_larger_than_shared_memory():
    """K3's backward stages a tile's 32 inp rows in shared memory: a C
    whose rows do not fit one block is refused before any launch, with a
    ValueError that names the limit (the library's numbers)."""
    dev = _card()
    x = torch.zeros((1, 4, 8, 4096), device=dev)
    f = torch.zeros((1, 4, 8, 2), device=dev)
    lib = kernels.SPLAT_DENSE_BWD
    need = lib.query("splat_dense_bwd_smem_bytes", 4096)
    most = lib.query("splat_dense_bwd_smem_most")
    assert 0 < lib.query("splat_dense_bwd_smem_bytes", 65) <= most < need
    kernels.reset_counts()
    with pytest.raises(ValueError, match=f"{need} bytes of shared memory .* {most}"):
        port_splat.softsplat_sum_bwd_kernel(x, f, x)
    assert kernels.counts()[kernels.SPLAT_DENSE_BWD.name] == 0


@pytest.mark.gpu
def test_kernels_refuse_inputs_beyond_their_limits_on_card():
    """The integrators (K1, K4, K7) refuse a side of 2^22 and K3 one of
    32768 with a ValueError that names the limit, before they allocate or
    launch anything."""
    dev = _card()
    tall = torch.zeros((1 << 22, 1, 2), device=dev)
    for name, kernel, fn in _integrator_calls(dev):
        kernels.reset_counts()
        with pytest.raises(ValueError, match="below 4194304"):
            fn(tall)
        assert sum(kernels.counts().values()) == 0, name
    del tall
    x = torch.zeros((1, 32768, 1, 3), device=dev)
    f = torch.zeros((1, 32768, 1, 2), device=dev)
    kernels.reset_counts()
    with pytest.raises(ValueError, match="below 32768"):
        port_splat.softsplat_sum_fwd_kernel(x, f)
    with pytest.raises(ValueError, match="below 32768"):
        port_splat.softsplat_sum_bwd_kernel(x, f, x)
    assert sum(kernels.counts().values()) == 0


def _crop_window_inputs(dev):
    """A 96 x 128 scene whose moving block sits inside the frame, integrated
    by K1's plain version and windowed as ``plan_crop`` windows it: the
    window at a positive offset in both axes, so that the padding rows
    (valid 0, sources at (0, 0)) sit at negative window coordinates. →
    (crop, moving rows' frame positions, their window positions, valid,
    disp_f, disp_p)."""
    h, w = 96, 128
    m = np.zeros((h, w, 2), np.float32)
    m[52:70, 60:93] = np.random.default_rng(12).standard_normal((18, 33, 2)) * 1.1
    pos, val = prepare_scene_sparse(m, pad_multiple=64)
    assert (val == 0).any()
    disp_f, disp_p = euler_compact_dual_plain(torch.from_numpy(m),
                                              torch.from_numpy(pos), 9, 10)
    bounds = rollout._target_bounds(torch.from_numpy(pos), torch.from_numpy(val),
                                    disp_f, disp_p, h, w).tolist()
    crop = rollout.plan_crop(bounds, h, w, 15, 2, max_area_frac=1.01, bucket=8)
    assert crop is not None and crop.y0 > 0 and crop.x0 > 0
    shift = np.array([crop.x0, crop.y0], np.int32)
    return (crop, torch.from_numpy(pos).to(dev),
            torch.from_numpy(pos - shift).to(dev), torch.from_numpy(val).to(dev),
            disp_f.to(dev), disp_p.to(dev))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16_accumulation"])
@pytest.mark.parametrize("slr", [False, True], ids=["K2", "K2-SLR"])
def test_k2_on_a_crop_window_matches_plain_on_card(slr, dtype):
    """K2 on the (hc, wc) window grid at window coordinates, padding rows at
    negative ones: f32 at 1e-5 with the same zeros; bf16 accumulation at
    most twice the plain version's distance from the f32 sums."""
    dev = _card()
    crop, _, pos_c, val, disp_f, disp_p = _crop_window_inputs(dev)
    assert (pos_c < 0).any()
    rng = np.random.default_rng(13)
    C1 = 67 if slr else 65
    u = torch.from_numpy(np.abs(rng.standard_normal((len(val), C1)))
                         .astype(np.float32)).to(dev) * val[:, None]
    u_static = torch.from_numpy(np.abs(rng.standard_normal((crop.hc, crop.wc, C1)))
                                .astype(np.float32)).to(dev)
    u_static *= rollout._static_mask(pos_c, val, crop.hc, crop.wc)[..., None]
    u, u_static = u.to(dtype), u_static.to(dtype)
    wrapper, plain, n_norm = ((splat_dual_normalize_slr,
                               splat_dual_normalize_slr_plain, 2) if slr else
                              (splat_dual_normalize, splat_dual_normalize_plain, 1))
    out = torch.empty((crop.hc, crop.wc, C1 - n_norm), dtype=torch.float32, device=dev)
    args = (pos_c, val, disp_f[6], disp_p[4], 0.4, 0.6)
    kernels.reset_counts()
    wrapper(u, *args, u_static, out=out)
    assert sum(kernels.counts().values()) == 1
    want = plain(u, *args, u_static, torch.float32)
    ref32 = plain(u.float(), *args, u_static.float(), torch.float32)
    torch.cuda.synchronize()
    _held(out, want, dtype, ref32)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["window", "every_row_invalid"])
def test_k5_on_a_crop_window_matches_plain_on_card(case):
    """K5 bit for bit on the window grid at window coordinates (padding rows
    at negative ones), and on the full grid with every row invalid and no
    displacement, as the crop's static Z-norm calls it."""
    dev = _card()
    crop, pos, pos_c, val, disp_f, _ = _crop_window_inputs(dev)
    z_full = torch.from_numpy(np.random.default_rng(14).standard_normal((96, 128))
                              .astype(np.float32) * 4.0).to(dev)
    z_mov = z_full[pos[:, 1].long(), pos[:, 0].long()].contiguous()
    if case == "window":
        z = z_full[crop.y0:crop.y0 + crop.hc, crop.x0:crop.x0 + crop.wc].contiguous()
        args = (z, rollout._static_mask(pos_c, val, crop.hc, crop.wc), z_mov,
                pos_c, val, disp_f[7])
    else:
        args = (z_full, rollout._static_mask(pos, val, 96, 128), z_mov, pos,
                torch.zeros_like(val), torch.zeros_like(disp_f[7]))
    kernels.reset_counts()
    kd, km = maxwarp.maximum_warp_norm_sparse(*args)
    assert kernels.counts()[kernels.MAXWARP_SPARSE.name] == 1
    pd, pm = maxwarp.maximum_warp_norm_sparse_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(kd, pd) and torch.equal(km, pm)


@pytest.mark.gpu
@pytest.mark.parametrize("v2", [False, True])
def test_crop_render_matches_full_on_card(v2):
    """A 256^2 baseline render with its crop planned (K1 in prepare_crop,
    K2 on the window, v2: K5 per frame and once on the full grid) against
    the uncropped render, f32, TF32 off: 1e-4."""
    dev = _card()
    opt = Options(ngf=16, W=256, bn_noise_misc=True, use_softmax_splatter_v2=v2)
    model = BaselineModel(opt).eval()
    init_random_weights(model, seed=0)
    model = model.to(dev)
    rng = np.random.default_rng(15)
    flow = np.zeros((256, 256, 2), np.float32)
    flow[170:220, 120:200] = rng.standard_normal((50, 80, 2)) * 1.2
    pos, val = prepare_scene_sparse(flow)
    img = torch.from_numpy(rng.uniform(-1, 1, (1, 256, 256, 3)).astype(np.float32))
    args = (model, img.to(dev), torch.from_numpy(flow).to(dev), 6,
            torch.from_numpy(pos).to(dev), torch.from_numpy(val).to(dev))
    kernels.reset_counts()
    disp, crop = rollout.prepare_crop(opt, False, args[2], *args[4:], 6)
    assert crop is not None and crop.y0 > 0 and crop.x0 > 0
    got = baseline_rollout_sparse(*args, decode_batch=3, crop=crop, disp=disp)
    assert kernels.counts()["euler_compact_dual"] == 1
    assert kernels.counts()["splat_dual_normalize"] == 6
    assert kernels.counts()["maximum_warp_norm_sparse"] == (7 if v2 else 0)
    want = baseline_rollout_sparse(*args, decode_batch=3)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def _dense_motion(n: int = 256, seed: int = 21) -> np.ndarray:
    """Every pixel moves (a regressor's dense prediction): a smooth field
    with noise, nowhere exactly 0."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float32)
    m = np.stack([1.5 * np.sin(yy / 17.0) + 0.6 * np.cos(xx / 23.0) + 2.2,
                  0.8 * np.cos(xx / 29.0) + 0.3], -1)
    return (m + rng.normal(0, 0.1, m.shape)).astype(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("splat_dtype", [torch.float32, torch.bfloat16])
def test_k1_k2_match_plain_at_a_dense_moving_set_on_card(splat_dtype):
    """The motion-from-hints shapes: every pixel of a 256^2 grid moves (P =
    65,536, no static pixel), so K2 has no static identity and splats over
    the whole grid. K1 bit for bit; K2 f32 at 1e-5 with the same empty
    cells, bf16 accumulation at most twice as far from the f32 sums as its
    plain version."""
    dev = _card()
    n = 256
    m = _dense_motion(n)
    pos, val = prepare_scene_sparse(m)
    assert pos.shape[0] == n * n and val.all()
    motion, positions = torch.from_numpy(m).to(dev), torch.from_numpy(pos).to(dev)
    kernels.reset_counts()
    kf, kb = euler_compact_dual(motion, positions, 59, 60)
    assert kernels.counts()[kernels.EULER.name] == 1
    pf, pb = euler_compact_dual_plain(motion, positions, 59, 60)
    torch.cuda.synchronize()
    assert torch.equal(kf, pf) and torch.equal(kb, pb)
    rng = np.random.default_rng(22)
    ez = np.exp(-rng.uniform(0, 3, (n, n, 1))).astype(np.float32)
    u = torch.from_numpy(np.concatenate(
        [rng.standard_normal((n, n, 64)).astype(np.float32) * ez, ez], -1)).to(dev)
    valid = torch.from_numpy(val).to(dev)
    static = rollout._static_mask(positions, valid, n, n)
    assert not static.any()
    u_mov = u[positions[:, 1].long(), positions[:, 0].long()].contiguous()
    args = (positions, valid, pf[30], pb[30], 0.5, 0.5)
    f32 = splat_dual_normalize_plain(u_mov, *args, u * 0.0, torch.float32)
    rows, u_static = u_mov.to(splat_dtype), (u * 0.0).to(splat_dtype)
    out = torch.empty((n, n, 64), dtype=torch.float32, device=dev)
    splat_dual_normalize(rows, *args, u_static, out=out)
    want = splat_dual_normalize_plain(rows, *args, u_static, torch.float32)
    torch.cuda.synchronize()
    if splat_dtype == torch.float32:
        torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
        assert torch.equal((out == 0).all(-1), (want == 0).all(-1))
    else:
        assert (out - f32).abs().max() <= 2 * (want - f32).abs().max()


@pytest.mark.gpu
def test_warp_flow_rollout_kernels_match_plain_on_card():
    """warp_flow_rollout (K1 once, K2 with C1 = 4 a frame) against its plain
    path, 256^2, half the rows moving and then every pixel: 1e-5."""
    dev = _card()
    n, N = 256, 12
    rng = np.random.default_rng(23)
    img = torch.from_numpy(rng.uniform(-1, 1, (1, n, n, 3)).astype(np.float32)).to(dev)
    for half in (True, False):
        m = _dense_motion(n)
        if half:
            m[: n // 2] = 0.0
        pos, val = prepare_scene_sparse(m)
        args = (img, torch.from_numpy(m).to(dev), N, torch.from_numpy(pos).to(dev),
                torch.from_numpy(val).to(dev))
        kernels.reset_counts()
        got = rollout.warp_flow_rollout(*args)
        assert kernels.counts()["euler_compact_dual"] == 1
        assert kernels.counts()["splat_dual_normalize"] == N
        want = rollout.warp_flow_rollout(*args, plain=True)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_perceptual_metrics_card_matches_cpu(tmp_path):
    """The CLAW metrics of one 128^2 frame pair from seeded torchvision and
    LPIPS weights on the card against the CPU: PSNR and SSIM within 1e-5,
    Perceptual and LPIPS within 1e-4 relative (f32, TF32 off)."""
    from slrsfs_tpu_torch.eval.metrics import PerceptualMetrics
    from slrsfs_tpu_torch.eval.random_weights import write_random_weights

    _card()
    w = write_random_weights(str(tmp_path), seed=8)
    rng = np.random.default_rng(31)
    a = rng.uniform(0, 1, (1, 128, 128, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    args = (w["vgg16"], w["alexnet"], w["lpips_alex"])
    got = PerceptualMetrics(*args, device="cuda").all_metrics(a, b)
    want = PerceptualMetrics(*args, device="cpu").all_metrics(a, b)
    assert set(got) == set(want) == {"PSNR", "SSIM", "Perceptual", "LPIPS"}
    for k in ("PSNR", "SSIM"):
        assert abs(got[k] - want[k]) <= 1e-5, (k, got[k], want[k])
    for k in ("Perceptual", "LPIPS"):
        assert abs(got[k] - want[k]) <= 1e-4 * abs(want[k]), (k, got[k], want[k])


@pytest.mark.gpu
def test_i3d_card_matches_cpu():
    """InceptionI3D at (1, 9, 224, 224, 3) with seeded pytorch-i3d weights
    on the card against the CPU: 1e-4 of max |feature| (f32, TF32 off)."""
    from slrsfs_tpu_torch.engine.init_utils import no_tf32
    from slrsfs_tpu_torch.eval.i3d import InceptionI3D
    from slrsfs_tpu_torch.eval.random_weights import random_state_dict

    dev = _card()
    model = InceptionI3D().eval()
    model.load_state_dict(random_state_dict(model, np.random.default_rng(32)))
    x = torch.from_numpy(np.random.default_rng(33).uniform(
        -1, 1, (1, 9, 224, 224, 3)).astype(np.float32))
    with torch.no_grad(), no_tf32():
        want = model(x)
        got = model.to(dev)(x.to(dev)).cpu()
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_eval_cli_without_card_raises(tmp_path):
    """cli/eval refuses to run without a card unless asked for the CPU: no
    silent fallback."""
    from slrsfs_tpu_torch.cli import eval as eval_cli
    from slrsfs_tpu_torch.eval.i3d import FVD
    from slrsfs_tpu_torch.eval.metrics import PerceptualMetrics

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    for make in (PerceptualMetrics, FVD,
                 lambda: eval_cli.main([str(tmp_path), str(tmp_path)])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


@pytest.mark.gpu
@pytest.mark.parametrize("C", [66, 67])
def test_k3_at_the_slr_widths_on_card(C):
    """K3 forward and backward at SLR stage 3's packed widths (C = 67 with
    use_alpha0_as_blending_weight, 66 without), called between calls at
    stage 1's C = 65, as a process that trains both runs them: the
    backward's shared memory is set again at each change of C."""
    dev = _card()
    for c in (65, C, 65, C):
        inp, flow, g = _k3_inputs(dev, C=c)
        out = softsplat_sum(inp, flow)
        ref = softsplat_sum_plain(inp, flow)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
        assert torch.equal((out == 0).all(-1), (ref == 0).all(-1))
        gi, gf = port_splat.softsplat_sum_bwd_kernel(inp, flow, g)
        wi, wf = softsplat_sum_grad_plain(inp, flow, g)
        torch.cuda.synchronize()
        for got, want in ((gi, wi), (gf, wf)):
            torch.testing.assert_close(got, want, rtol=0,
                                       atol=1e-5 * want.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("compact", [False, True], ids=["dense", "compact"])
def test_slr_train_step_kernels_match_plain_on_card(compact):
    """The SLR stage-3 G+D step (TinyTest archs, W = 32, B = 2, T = 4, the
    CLI's stage-3 options) through K3 and K7 against the same step through
    their plain versions from one snapshot: losses within 1e-4 relative,
    gradients within 1e-3 of the largest; 2 K3 forward, 2 backward and 1
    K7 launch a step, nothing else."""
    from slrsfs_tpu_torch.cli.train import (
        SLR_MODEL_TYPE,
        attach_moving_sets,
        build,
        stage_options,
        to_device_batch,
    )

    dev = _card()
    opt = Options(ngf=8, W=32, out_channel=9, model_type=SLR_MODEL_TYPE, ndf=8, num_D=1,
                  n_layers_D=2, refine_model_type="resnet_TinyTest_de_resnet_pconv2_nonorm",
                  alpha_refine_model_type="resnet_TinyTest_de_resnet_pconv2_nonorm",
                  bg_refine_model_type="resnet_TinyTestBG_nonorm",
                  **stage_options(SLR_MODEL_TYPE))
    _, tr = build(opt, train_max_steps=4, device=dev, seed=0)
    rng = np.random.default_rng(40)
    B = 2
    motions = (rng.standard_normal((B, 32, 32, 2)) * 0.8).astype(np.float32)
    motions[:, :16] = 0.0
    batch = {"images": [(rng.standard_normal((B, 32, 32, 3)) * 0.25).astype(np.float32)
                        for _ in range(3)],
             "index": np.array([[0, 1, 4], [0, 3, 4]], np.int32), "motions": motions,
             "mask_rock": (rng.random((B, 32, 32, 1)) < 0.3).astype(np.float32),
             "mean_video": (rng.standard_normal((B, 32, 32, 3)) * 0.25).astype(np.float32)}
    if compact:
        batch = attach_moving_sets(batch)
        assert "mov_pos" in batch
    batch = to_device_batch(batch, dev)
    snap = tr.snapshot()
    kernels.reset_counts()
    got = tr.train_step(batch)
    torch.cuda.synchronize()
    launches = kernels.counts()
    g_k = [x.clone() for x in tr.last_grads["g"] + tr.last_grads["d"]]
    tr.restore(snap)
    want = tr.train_step(batch, plain=True)
    g_p = tr.last_grads["g"] + tr.last_grads["d"]
    assert launches == {**{k.name: 0 for k in kernels.KERNELS}, "splat_dense_fwd": 2,
                        "splat_dense_bwd": 2, "euler_phased": 1}
    assert set(got) == set(want) and "RockRegionLoss" in got
    for k in want:
        assert torch.isfinite(got[k]), k
        assert abs(got[k].item() - want[k].item()) <= 1e-4 * max(abs(want[k].item()), 1e-12), k
    scale = max(x.abs().max().item() for x in g_p)
    assert max((a - b).abs().max().item() for a, b in zip(g_k, g_p)) <= 1e-3 * scale


def _k7_grad(fn, motion, t_f, t_p, T, g_f, g_p):
    m = motion.clone().requires_grad_(True)
    out_f, out_p = fn(m, t_f, t_p, T)
    (grad,) = torch.autograd.grad((out_f * g_f).sum() + (out_p * g_p).sum(), m)
    return grad


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["phased", "static_and_leaving"])
def test_k7_backward_matches_plain_autograd_on_card(case):
    """Dense K7 under grad: one forward and one backward launch; the
    gradient against the plain version's autograd within 1e-5 of its
    largest magnitude, on two launches (atomics in another order each
    time), with static sources (their gradient is steps x cotangent, not
    0), rows that leave the frame (none), t_f = 0 and t_p = 0 samples."""
    dev = _card()
    motion, t_f, t_p, T = _phased_inputs(dev)
    if case == "static_and_leaving":
        motion = motion.clone()
        motion[:, : H // 3] = 0.0
        motion[:, H - 4:, :, 1] += 6.0
        t_f = torch.tensor([0, 3, T, 2], dtype=torch.int32, device=dev)
        t_p = torch.tensor([T, 0, 0, 5], dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    g_f = torch.randn(motion.shape, generator=gen, device=dev)
    g_p = torch.randn(motion.shape, generator=gen, device=dev)
    want = _k7_grad(euler_integrate_phased_plain, motion, t_f, t_p, T, g_f, g_p)
    for _ in range(2):
        kernels.reset_counts()
        got = _k7_grad(euler_integrate_phased, motion, t_f, t_p, T, g_f, g_p)
        torch.cuda.synchronize()
        assert kernels.counts()[kernels.EULER_PHASED.name] == 1
        assert kernels.counts()[kernels.EULER_PHASED_BWD.name] == 1
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * want.abs().max().item())
    static = (motion == 0).all(-1)
    assert static.any() and want[static].abs().max() > 0
    if case == "static_and_leaving":
        with torch.no_grad():
            out_f, out_p = euler_integrate_phased_plain(motion, t_f, t_p, T)
        oob = max(motion.shape[1], motion.shape[2]) + 1
        assert (out_f == oob).any() or (out_p == oob).any()


K7_WINDOW_CASES = ["one run a row", "drift leaves the window", "partial tiles",
                   "count rules", "static band", "rows leave the frame",
                   "training shape (16, 256, 256), T = 60"]


def _k7_window_case(dev, name: str):
    """K7's backward inputs that exercise its block rule at card sizes
    (tiles of 32 sources, windows with a margin of 32): (motion, t_f, t_p,
    T), from a numpy seed."""
    rng = np.random.default_rng(70 + K7_WINDOW_CASES.index(name))
    T, B, Hc, Wc = 14, 4, 101, 147  # neither side a multiple of the tile
    t_f = np.array([8, 0, 14, 5], np.int32)
    t_p = np.array([6, 14, 0, 4], np.int32)
    m = (rng.standard_normal((B, Hc, Wc, 2)) * 1.2).astype(np.float32)
    if name == "one run a row":
        m *= 0.01 / 1.2
    elif name == "drift leaves the window":
        # ~3 px a step to the right: most rows end past their window
        T, Hc, Wc = 20, 64, 256
        m = (rng.standard_normal((2, Hc, Wc, 2)) * 0.1).astype(np.float32)
        m[..., 0] += 3.0
        t_f, t_p = np.array([20, 16], np.int32), np.array([0, 4], np.int32)
    elif name == "count rules":
        t_f, t_p = np.array([14, 0, 6, 0], np.int32), np.array([0, 14, 8, 0], np.int32)
    elif name == "static band":
        m[:, 20:60] = 0.0
    elif name == "rows leave the frame":
        m[:, Hc - 10:, :, 1] += 4.0
    elif name.startswith("training shape"):
        T = 60
        m = (rng.standard_normal((16, 256, 256, 2)) * 0.6).astype(np.float32)
        m[:, :64] = 0.0
        t_f = rng.integers(0, T + 1, size=16).astype(np.int32)
        t_p = (rng.integers(0, T + 1, size=16) % (T - t_f + 1)).astype(np.int32)
    return (torch.from_numpy(m).to(dev), torch.from_numpy(t_f).to(dev),
            torch.from_numpy(t_p).to(dev), T)


@pytest.mark.gpu
@pytest.mark.parametrize("name", K7_WINDOW_CASES)
def test_k7_backward_window_cases_match_plain_autograd_on_card(name):
    """K7's backward (a block's window of the gradient in shared memory,
    runs summed in registers, misses added to device memory) against the
    plain autograd within 1e-5 of the gradient's largest magnitude, on two
    launches of one forward and one backward kernel each; the drift case
    misses the window (the host count)."""
    dev = _card()
    motion, t_f, t_p, T = _k7_window_case(dev, name)
    gen = torch.Generator(device=dev).manual_seed(7)
    g_f = torch.randn(motion.shape, generator=gen, device=dev)
    g_p = torch.randn(motion.shape, generator=gen, device=dev)
    want = _k7_grad(euler_integrate_phased_plain, motion, t_f, t_p, T, g_f, g_p)
    for _ in range(2):
        kernels.reset_counts()
        got = _k7_grad(euler_integrate_phased, motion, t_f, t_p, T, g_f, g_p)
        torch.cuda.synchronize()
        assert kernels.counts()[kernels.EULER_PHASED.name] == 1
        assert kernels.counts()[kernels.EULER_PHASED_BWD.name] == 1
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * want.abs().max().item())
    n = port_euler.phased_bwd_window_counts(motion, t_f, t_p, T)
    assert n["runs"] > 0
    if name == "drift leaves the window":
        assert n["misses"] > n["runs"] // 4
    if name == "one run a row":
        assert n["reductions"] > n["runs"] * T / 2


@pytest.mark.gpu
def test_k7_backward_with_a_non_finite_cotangent_on_card():
    """A block whose cotangents hold NaN or Inf has no fixed-point bound and
    adds every run in f32 to the gradient: the same cells as the plain
    autograd's are NaN, the rest within 1e-5 of the finite maximum."""
    dev = _card()
    motion, t_f, t_p, T = _k7_window_case(dev, "partial tiles")
    gen = torch.Generator(device=dev).manual_seed(8)
    g_f = torch.randn(motion.shape, generator=gen, device=dev)
    g_p = torch.randn(motion.shape, generator=gen, device=dev)
    g_f[0, 40, 50, 0] = float("nan")
    g_p[3, 70, 20, 1] = float("inf")
    want = _k7_grad(euler_integrate_phased_plain, motion, t_f, t_p, T, g_f, g_p)
    kernels.reset_counts()
    got = _k7_grad(euler_integrate_phased, motion, t_f, t_p, T, g_f, g_p)
    torch.cuda.synchronize()
    assert kernels.counts()[kernels.EULER_PHASED_BWD.name] == 1
    assert want.isnan().any() and torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.isinf(), want.isinf())
    ok = want.isfinite()
    torch.testing.assert_close(got[ok], want[ok], rtol=0,
                               atol=1e-5 * want[ok].abs().max().item())


@pytest.mark.gpu
def test_compact_k7_still_refuses_a_motion_gradient_on_card():
    """The compact form has no backward: under grad it raises before any
    launch, naming the dense form."""
    dev = _card()
    motion, t_f, t_p, T = _phased_inputs(dev)
    B = motion.shape[0]
    pos = torch.zeros((B, 64, 2), dtype=torch.int32, device=dev)
    val = torch.ones((B, 64), dtype=torch.float32, device=dev)
    kernels.reset_counts()
    with pytest.raises(RuntimeError, match="no backward.*dense euler_integrate_phased"):
        euler_integrate_phased_compact(motion.clone().requires_grad_(True), pos, val,
                                       t_f, t_p, T)
    assert sum(kernels.counts().values()) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("frozen", [False, True], ids=["joint", "frozen"])
def test_embedded_motion_step_kernels_match_plain_on_card(frozen):
    """The embedded-motion G+D step (TinyTest fluid archs, a depth-4
    regressor of width 4, W = 32, B = 2, T = 4) through K3 and K7 against
    the same step through their plain versions from one snapshot: losses
    within 1e-4 relative, gradients within 1e-3 of the largest and of each
    sub-network's own largest (the regressor's too when unfrozen); 2 K3
    forward, 2 backward, 1 K7 forward a step, and 1 K7 backward when
    unfrozen."""
    from slrsfs_tpu_torch.cli.train import build, stage_options, to_device_batch

    dev = _card()
    opt = Options(ngf=8, W=32, out_channel=9, ndf=8, num_D=1, n_layers_D=2,
                  refine_model_type="resnet_TinyTest_de_resnet_pconv2_nonorm",
                  motionW=32, motionH=32, motion_num_filters=4, motion_unet_downs=4,
                  freeze_motion=frozen, **stage_options("softmax_splating", True))
    _, tr = build(opt, train_max_steps=4, device=dev, seed=0)
    rng = np.random.default_rng(41)
    B = 2
    motions = (rng.standard_normal((B, 32, 32, 2)) * 0.8).astype(np.float32)
    batch = to_device_batch(
        {"images": [(rng.standard_normal((B, 32, 32, 3)) * 0.25).astype(np.float32)
                    for _ in range(3)],
         "index": np.array([[0, 1, 4], [0, 3, 4]], np.int32), "motions": motions,
         "hints": (motions * (rng.random((B, 32, 32, 1)) < 0.2)).astype(np.float32)}, dev)
    snap = tr.snapshot()
    kernels.reset_counts()
    got = tr.train_step(batch)
    torch.cuda.synchronize()
    launches = kernels.counts()
    g_k = [x.clone() for x in tr.last_grads["g"] + tr.last_grads["d"]]
    tr.restore(snap)
    want = tr.train_step(batch, plain=True)
    g_p = tr.last_grads["g"] + tr.last_grads["d"]
    assert launches == {**{k.name: 0 for k in kernels.KERNELS}, "splat_dense_fwd": 2,
                        "splat_dense_bwd": 2, "euler_phased": 1,
                        "euler_phased_bwd": 0 if frozen else 1}
    assert any(n.startswith("motion_regressor.") for n in tr.g_names) != frozen
    for k in want:
        assert torch.isfinite(got[k]), k
        assert abs(got[k].item() - want[k].item()) <= 1e-4 * max(abs(want[k].item()), 1e-12), k
    scale = max(x.abs().max().item() for x in g_p)
    assert max((a - b).abs().max().item() for a, b in zip(g_k, g_p)) <= 1e-3 * scale
    names = tr.g_names + [f"D.{n}" for n, _ in tr.d_model.named_parameters()]
    groups = {}
    for n, a, b in zip(names, g_k, g_p):
        d, s = groups.get(n.split(".", 1)[0], (0.0, 0.0))
        groups[n.split(".", 1)[0]] = (max(d, (a - b).abs().max().item()),
                                      max(s, b.abs().max().item()))
    assert ("motion_regressor" in groups) != frozen
    for n, (d, s) in groups.items():
        assert d <= 1e-3 * s, (n, d, s)


# ---- K3's bf16 mode --------------------------------------------------------

def _bf16_dense_bound(x, flow):
    """Per element, the most any order of K3's bf16 sum can move it from
    the f32 sums of the same bf16 rows: a cell of n nonzero taps sums terms
    that each pass at most n + 4 roundings to bf16 (the weight, the
    product, the quarter's adds, the three adds of the combine), so the
    distance is within gamma_(n+4)(2^-8) sum |terms| (plus the f32
    reference's own gamma at 2^-24)."""
    B, Hh, Ww, _ = x.shape
    abs_terms = softsplat_sum_plain(x.float().abs(), flow)
    n = torch.zeros((B, Hh * Ww), device=x.device)
    xs = torch.arange(Ww, dtype=torch.float32, device=x.device)[None, :]
    ys = torch.arange(Hh, dtype=torch.float32, device=x.device)[:, None]
    for b in range(B):
        ox = (xs + flow[b, ..., 0]).reshape(-1)
        oy = (ys + flow[b, ..., 1]).reshape(-1)
        for lin, w in port_splat._corner_taps(ox, oy, Hh, Ww):
            n[b].index_add_(0, lin, (w != 0).float())
    k = n.reshape(B, Hh, Ww, 1) + 4.0
    gamma = k * 2.0 ** -8 / (1.0 - k * 2.0 ** -8) + k * 2.0 ** -24
    return gamma * abs_terms + k * 2.0 ** -133


def _k3_bf16_cases(dev):
    """(label, inp, flow, g) of K3's bf16 checks: C = 65, then C = 67 in the
    same process (``_k3_inputs``: random flow, integer landings, the OOB
    sentinel); C of 1, 8, 65, 67, 130 and the wrapper's largest on a
    random flow (the window misses) and on a leaving flow (most corners off
    the grid), at B = 2 with odd H and W; and one of an odd element
    count."""
    for C in (65, 67):
        yield (f"C={C}",) + _k3_inputs(dev, C=C)
    rng = np.random.default_rng(23)
    Bo, Ho, Wo = 2, 17, 23
    for C in (1, 8, 65, 67, 130, port_splat.DENSE_BF16_MAX_C):
        for kind, scale in (("random", 4.0), ("leaving", 40.0)):
            flow = (rng.standard_normal((Bo, Ho, Wo, 2)) * scale).astype(np.float32)
            yield (f"C={C} {kind} ({Bo}, {Ho}, {Wo})",
                   *(torch.from_numpy(a).to(dev) for a in (
                       rng.standard_normal((Bo, Ho, Wo, C)).astype(np.float32), flow,
                       rng.standard_normal((Bo, Ho, Wo, C)).astype(np.float32))))
    # an odd count of elements: the last row ends inside a 4-byte word
    yield ("C=67 random (1, 17, 23)", *(torch.from_numpy(a).to(dev) for a in (
        rng.standard_normal((1, Ho, Wo, 67)).astype(np.float32),
        (rng.standard_normal((1, Ho, Wo, 2)) * 4.0).astype(np.float32),
        rng.standard_normal((1, Ho, Wo, 67)).astype(np.float32))))


@pytest.mark.gpu
def test_k3_bf16_matches_plain_on_card():
    """K3's bf16 forward and backward on each of ``_k3_bf16_cases``: the
    forward within the per-cell bf16 bound of the f32 sums of the same
    rows, cells whose terms are all 0 exactly 0; the backward's grad_inp
    bit for bit the plain version's (both sum the four corners in f32 in
    the order NW, NE, SW, SE and round once) and grad_flow within 1e-5 of
    its largest entry; one launch of each bf16 kernel and none of the f32
    ones."""
    dev = _card()
    for label, inp, flow, g in _k3_bf16_cases(dev):
        x = inp.to(torch.bfloat16).requires_grad_(True)
        f = flow.clone().requires_grad_(True)
        kernels.reset_counts()
        out = softsplat_sum(x, f)
        out.backward(g.to(torch.bfloat16))
        torch.cuda.synchronize()
        counts = kernels.counts()
        assert counts[kernels.SPLAT_DENSE_FWD_BF16.name] == 1, counts
        assert counts[kernels.SPLAT_DENSE_BWD_BF16.name] == 1, counts
        assert counts[kernels.SPLAT_DENSE_FWD.name] == counts[kernels.SPLAT_DENSE_BWD.name] == 0
        assert out.dtype == torch.bfloat16
        xb = x.detach()
        ref32 = softsplat_sum_plain(xb.float(), flow)
        bnd = _bf16_dense_bound(xb, flow)
        assert bool(((out.float() - ref32).abs() <= bnd).all()), label
        plain = softsplat_sum_plain(xb, flow)
        assert bool(((plain.float() - ref32).abs() <= bnd).all()), label
        empty = bnd == 0
        assert bool((out.float()[empty] == 0).all())
        no_terms = softsplat_sum_plain(xb.float().abs(), flow) == 0
        assert bool((out.float()[no_terms] == 0).all()), label
        want_i, want_f = softsplat_sum_grad_plain(xb, flow, g.to(torch.bfloat16))
        assert x.grad.dtype == torch.bfloat16 and f.grad.dtype == torch.float32
        torch.testing.assert_close(x.grad.float(), want_i.float(), rtol=2.0 ** -7, atol=0)
        assert torch.equal(x.grad, want_i), label
        scale = want_f.abs().max().item()
        torch.testing.assert_close(f.grad, want_f, rtol=0, atol=1e-5 * scale)


@pytest.mark.gpu
def test_k3_bf16_refuses_an_f32_flow_mismatch_on_card():
    """A bf16 input on the card takes the bf16 kernels or raises: a flow of
    another dtype is refused before any launch, never run on an upcast
    copy or by the plain version."""
    dev = _card()
    inp, flow, _ = _k3_inputs(dev, C=9)
    kernels.reset_counts()
    with pytest.raises(TypeError):
        softsplat_sum(inp.to(torch.bfloat16), flow.double())
    with pytest.raises(TypeError):
        port_splat.softsplat_sum_fwd_bf16_kernel(inp, flow)
    assert sum(kernels.counts().values()) == 0


@pytest.mark.gpu
def test_bf16_train_step_kernels_match_plain_on_card(capsys, monkeypatch):
    """The bf16 stage-1 G+D step (TinyTest archs, W = 32, B = 2, T = 4)
    through K3's bf16 kernels and K7 against the same step through their
    plain versions from one snapshot: 2 K3 bf16 forward, 2 backward and 1
    K7 launch, nothing else; every persistent tensor float32.

    The bf16 forward adds with atomics in no fixed order, and another order
    of the same bf16 sum moves this random-weight step's gradients by
    0.11-0.14 of their L2 norm (tests/test_torch_train_rest.py:
    test_bf16_step_gradients_move_with_the_splat_order). So the plain step
    is given the kernel forward's own output (its inputs checked bit-equal
    first; the forward is held against the f32 sums by the K3 bf16 tests),
    and only the backward differs: cuDNN deterministic, the losses are
    bit-equal and the splat's incoming cotangent too. The bf16 backward's
    grad_inp is then held within one bf16 ulp of the plain version's
    (2^-7 relative: both round an f32 sum, added in another order, to
    bf16) and its grad_flow within 1e-5 of its largest entry; each
    sub-network's gradient, entry by entry, within 2^-6 of its own largest
    entry (that ulp carried through the encoder's bf16 backward, one more
    rounding on)."""
    from slrsfs_tpu_torch.cli.train import build, to_device_batch

    dev = _card()
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    opt = Options(ngf=8, W=32, out_channel=9, ndf=8, num_D=1, n_layers_D=2,
                  refine_model_type="resnet_TinyTest_de_resnet_pconv2_nonorm",
                  train_compute_dtype="bfloat16")
    _, tr = build(opt, train_max_steps=4, device=dev, seed=0)
    rng = np.random.default_rng(41)
    B = 2
    batch = to_device_batch(
        {"images": [(rng.standard_normal((B, 32, 32, 3)) * 0.25).astype(np.float32)
                    for _ in range(3)],
         "index": np.array([[0, 1, 4], [0, 3, 4]], np.int32),
         "motions": (rng.standard_normal((B, 32, 32, 2)) * 0.8).astype(np.float32)}, dev)

    fwd, bwd, plain_bwd = [], [], []
    kernel_fwd = port_splat.softsplat_sum_fwd_bf16_kernel
    kernel_bwd = port_splat.softsplat_sum_bwd_bf16_kernel
    plain_grad = port_splat.softsplat_sum_grad_plain

    def record_fwd(inp, flow):
        out = kernel_fwd(inp, flow)
        fwd.append((inp.clone(), flow.clone(), out.clone()))
        return out

    def record_bwd(inp, flow, g):
        gi, gf = kernel_bwd(inp, flow, g)
        bwd.append((g.clone(), gi.clone(), gf.clone()))
        return gi, gf

    def replay_fwd(inp, flow):
        k_inp, k_flow, k_out = fwd[replay_fwd.n]
        replay_fwd.n += 1
        assert torch.equal(inp, k_inp) and torch.equal(flow, k_flow)
        return k_out.clone()
    replay_fwd.n = 0

    def record_plain_bwd(inp, flow, g):
        gi, gf = plain_grad(inp, flow, g)
        plain_bwd.append((g.clone(), gi, gf))
        return gi, gf

    snap = tr.snapshot()
    monkeypatch.setattr(port_splat, "softsplat_sum_fwd_bf16_kernel", record_fwd)
    monkeypatch.setattr(port_splat, "softsplat_sum_bwd_bf16_kernel", record_bwd)
    kernels.reset_counts()
    got = tr.train_step(batch)
    torch.cuda.synchronize()
    launches = kernels.counts()
    g_k = [x.clone() for x in tr.last_grads["g"] + tr.last_grads["d"]]
    for module in (tr.model, tr.d_model):
        for name, t in module.state_dict().items():
            assert not t.is_floating_point() or t.dtype == torch.float32, name
    assert all(t.dtype == torch.float32 for t in tr.opt_g.mu + tr.opt_g.nu + g_k)
    tr.restore(snap)
    monkeypatch.setattr(port_splat, "softsplat_sum_plain", replay_fwd)
    monkeypatch.setattr(port_splat, "softsplat_sum_grad_plain", record_plain_bwd)
    want = tr.train_step(batch, plain=True)
    g_p = tr.last_grads["g"] + tr.last_grads["d"]
    assert launches == {**{k.name: 0 for k in kernels.KERNELS}, "splat_dense_fwd_bf16": 2,
                        "splat_dense_bwd_bf16": 2, "euler_phased": 1}
    assert replay_fwd.n == 2 and len(bwd) == len(plain_bwd) == 2
    for k in want:
        assert torch.isfinite(got[k]), k
        assert got[k].item() == want[k].item(), (k, got[k].item(), want[k].item())
    bwd_err = []
    for (g, gi, gf), (pg, pgi, pgf) in zip(bwd, plain_bwd):
        assert torch.equal(g, pg)
        assert gi.dtype == torch.bfloat16 and gf.dtype == torch.float32
        torch.testing.assert_close(gi.float(), pgi.float(), rtol=2.0 ** -7, atol=0)
        scale = pgf.abs().max().item()
        torch.testing.assert_close(gf, pgf, rtol=0, atol=1e-5 * scale)
        bwd_err.append(((gi.float() - pgi.float()).abs().max().item()
                        / max(pgi.float().abs().max().item(), 1e-30)))
    names = tr.g_names + [f"D.{n}" for n, _ in tr.d_model.named_parameters()]
    groups = {}
    for n, a, b in zip(names, g_k, g_p):
        err, big = groups.get(n.split(".")[0], (0.0, 0.0))
        groups[n.split(".")[0]] = (max(err, (a - b).abs().max().item()),
                                   max(big, b.abs().max().item()))
    rel = {k: err / max(big, 1e-30) for k, (err, big) in groups.items()}
    with capsys.disabled():
        print(f"\nbf16 step kernel vs plain (forward replayed): losses bit-equal; "
              f"K3 bwd grad_inp {max(bwd_err):.3g} of its largest; by sub-network of its "
              f"own largest: " + ", ".join(f"{k} {v:.3g}" for k, v in rel.items()))
    assert set(rel) >= {"encoder", "projector", "D"}
    for k, v in rel.items():
        assert v <= 2.0 ** -6, (k, v)


@pytest.mark.gpu
def test_frame_sharded_render_on_one_nccl_rank_matches_unsharded():
    """``SceneRenderer(shard_frames=True)`` forms a 1-rank NCCL group (no
    torchrun environment), renders its block (all N frames), gathers it
    with ``all_gather_into_tensor`` and equals the unsharded render within
    1e-4, for the baseline and the SLR model (random weights from one
    seed, 64², N = 6); ``close()`` destroys the group."""
    import torch.distributed as dist

    from slrsfs_tpu_torch.cli.render import SceneRenderer

    _card()
    rng = np.random.default_rng(31)
    img = (rng.standard_normal((64, 64, 3)) * 0.25).astype(np.float32)
    flow = np.zeros((64, 64, 2), np.float32)
    flow[32:] = rng.standard_normal((32, 64, 2)).astype(np.float32) * 1.5
    for overrides in (None, dict(model_type=SLR_MODEL_TYPE,
                                 use_alpha0_as_blending_weight=True)):
        kw = dict(W=64, n_frames=6, seed=0, sparsify_eps=0.0, crop_decode="off",
                  opt_overrides=overrides)
        rs = SceneRenderer(shard_frames=True, **kw)
        try:
            assert rs.mesh.backend == "nccl" and rs.mesh.world == 1 and rs.mesh.owns_group
            got = rs.frames(img, flow)
            want = SceneRenderer(**kw).frames(img, flow)
            torch.cuda.synchronize()
        finally:
            rs.close()
        assert not dist.is_initialized()
        got, want = ({"PredImg": o} if torch.is_tensor(o) else o for o in (got, want))
        assert set(got) == set(want)
        for k in want:
            assert got[k].shape == want[k].shape, k
            assert (got[k] - want[k]).abs().max().item() <= 1e-4, k
