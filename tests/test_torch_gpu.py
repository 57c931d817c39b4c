"""The port's CUDA kernels against their plain versions on a card.

Every test here needs a CUDA device and skips without one. The file imports
no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

K1, K4, K5, K6 and K7 must match bit for bit (same arithmetic, no FMA
contraction; max is order-free; K7's compact scatter adds one non-zero
term per cell); K2 (both epilogues), K8 and K3's forward sum with atomics
in another order, so they are held at 1e-5 in float32, and K3's backward
at 1e-5 of each output's maximum; in bf16 accumulation K2 and K8 round
at every add in another order than their plain versions, so both are held
against the f32 sums of the same rows, the kernel at most twice as far as
the plain version; K9
at 2^-7 of max |plain| with at most 0.1 % of the elements more than one
bf16 ulp apart; a rollout through the kernels is held at 1e-4 against one
through the plain versions. The card branches of K1, K4 and K7 refuse a
motion that requires grad, before they launch anything."""

import numpy as np
import pytest
import torch

from slrsfs_tpu_torch import kernels
from slrsfs_tpu_torch.config import Options
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


@pytest.mark.gpu
@pytest.mark.parametrize("half_integer", [False, True])
def test_k1_matches_plain_on_card(half_integer):
    dev = _card()
    m = _motion(0, half_integer)
    pos, _ = prepare_scene_sparse(m, pad_multiple=64)
    motion, positions = torch.from_numpy(m).to(dev), torch.from_numpy(pos).to(dev)
    kf, kb = euler_compact_dual(motion, positions, 9, 10)
    pf, pb = euler_compact_dual_plain(motion, positions, 9, 10)
    torch.cuda.synchronize()
    assert torch.equal(kf, pf) and torch.equal(kb, pb)
    assert (kb == max(H, W) + 1).any()


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


def _maxwarp_inputs(dev, special: bool):
    m = _motion(3)
    pos, val = prepare_scene_sparse(m, pad_multiple=64)
    disp_f, _ = euler_compact_dual_plain(torch.from_numpy(m),
                                         torch.from_numpy(pos), 6, 6)
    d = _special(disp_f[5]) if special else disp_f[5]
    z = torch.from_numpy(np.random.default_rng(4).standard_normal((H, W))
                         .astype(np.float32) * 4.0)
    static = torch.from_numpy(np.all(m == 0, axis=-1).astype(np.float32))
    p = torch.from_numpy(pos)
    z_mov = z[p[:, 1].long(), p[:, 0].long()].contiguous()
    return [t.to(dev) for t in (z, static, z_mov, p, torch.from_numpy(val), d)]


@pytest.mark.gpu
@pytest.mark.parametrize("special", [False, True])
def test_k5_matches_plain_on_card(special):
    dev = _card()
    args = _maxwarp_inputs(dev, special)
    kernels.reset_counts()
    kd, km = maxwarp.maximum_warp_norm_sparse(*args)
    assert kernels.counts()[kernels.MAXWARP_SPARSE.name] == 1
    pd, pm = maxwarp.maximum_warp_norm_sparse_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(kd, pd) and torch.equal(km, pm)


@pytest.mark.gpu
@pytest.mark.parametrize("special", [False, True])
def test_k6_matches_plain_on_card(special):
    dev = _card()
    m = _motion(5)
    grid = torch.from_numpy(np.stack(np.meshgrid(np.arange(W), np.arange(H)),
                                     -1).reshape(-1, 2).astype(np.int32))
    disp_f, _ = euler_compact_dual_plain(torch.from_numpy(m), grid, 4, 4)
    d = _special(disp_f[3]) if special else disp_f[3]
    flow = d.reshape(1, H, W, 2).to(dev)
    z = torch.from_numpy(np.random.default_rng(6).standard_normal((1, H, W, 1))
                         .astype(np.float32) * 4.0).to(dev)
    kernels.reset_counts()
    got = maxwarp.maximum_warp_norm_splat(z, flow)
    assert kernels.counts()[kernels.MAXWARP_SPLAT.name] == 1
    want = maxwarp.maximum_warp_norm_splat_plain(z, flow)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


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
    """K1, K4 and K7 have no backward: on the card each wrapper raises for
    a motion that requires grad under grad mode, before it launches
    anything, and runs under torch.no_grad()."""
    dev = _card()
    motion = torch.from_numpy(_motion(8)).to(dev).requires_grad_(True)
    for name, kernel, fn in _integrator_calls(dev):
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
@pytest.mark.parametrize("half_integer", [False, True])
def test_k4_matches_plain_on_card(half_integer):
    """Every form of K4: dense dual, dense and last-step with visibility,
    compact with visibility, and n_steps = 0."""
    dev = _card()
    m = torch.from_numpy(_motion(8, half_integer)).to(dev)
    pos = torch.from_numpy(prepare_scene_sparse(m.cpu().numpy(),
                                                pad_multiple=64)[0]).to(dev)
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
    assert (pairs[0][0][1] == max(H, W) + 1).any()


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
