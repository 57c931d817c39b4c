"""The K2 wrappers' scratch contract (slrsfs_tpu_torch.ops.splat), on the CPU.

The bf16 accumulation mode of K2 sums each corner in its own bf16 quarter
of the cell; the kernel adds 8 channels at a time with one 16-byte vector
reduction, so the quarters' channel stride is C1 rounded up to a multiple
of 8 (65 and 67 both become 72; the pad channels receive 0 and are never
read). ``_scratch_numel`` holds that size, ``splat_scratch`` allocates it,
and a scratch passed to either wrapper is checked on every device: one of
the unpadded size that the kernel took before is refused."""

import numpy as np
import pytest
import torch

from slrsfs_tpu_torch.engine.rollout import prepare_scene_sparse
from slrsfs_tpu_torch.ops import splat as port_splat

torch.set_num_threads(1)

H, W = 12, 10


@pytest.mark.parametrize("C1, stride", [(2, 8), (3, 8), (8, 8), (9, 16), (64, 64),
                                        (65, 72), (66, 72), (67, 72), (72, 72)])
def test_bf16_scratch_pads_the_quarter_stride_to_a_multiple_of_8(C1, stride):
    bf, f32 = torch.bfloat16, torch.float32
    assert port_splat._scratch_numel(H, W, C1, bf) == H * W * 4 * stride
    assert port_splat._scratch_numel(H, W, C1, f32) == H * W * C1
    for dtype in (bf, f32):
        acc = port_splat.splat_scratch(H, W, C1, dtype, "cpu")
        assert acc.shape == (port_splat._scratch_numel(H, W, C1, dtype),)
        assert acc.dtype == dtype


def _inputs(C1: int, dtype: torch.dtype):
    rng = np.random.default_rng(C1)
    m = (rng.standard_normal((H, W, 2)) * 1.2).astype(np.float32)
    m[: H // 3] = 0.0
    pos, val = prepare_scene_sparse(m, pad_multiple=37)
    u = np.abs(rng.standard_normal((H, W, C1))).astype(np.float32)
    static = np.all(m == 0, axis=-1)[..., None].astype(np.float32)
    u_mov = u[pos[:, 1], pos[:, 0]] * val[:, None]
    disp = rng.uniform(-2.0, 2.0, (2, len(val), 2)).astype(np.float32)
    return [torch.from_numpy(x) for x in (u_mov, pos, val, disp[0], disp[1])] + [
        torch.from_numpy(u * static)], dtype


@pytest.mark.parametrize("slr", [False, True], ids=["K2", "K2-SLR"])
@pytest.mark.parametrize("C1", [65, 67])
def test_wrappers_refuse_a_bf16_scratch_of_the_unpadded_size(slr, C1):
    (u_mov, pos, val, da, db, u_static), bf = _inputs(C1, torch.bfloat16)
    u_mov, u_static = u_mov.to(bf), u_static.to(bf)
    n_norm = 2 if slr else 1
    wrapper = port_splat.splat_dual_normalize_slr if slr else port_splat.splat_dual_normalize
    out = torch.empty((H, W, C1 - n_norm))
    old = torch.zeros((H * W * 4 * C1,), dtype=bf)
    with pytest.raises(ValueError, match="acc must be"):
        wrapper(u_mov, pos, val, da, db, 0.4, 0.6, u_static, out=out, acc=old)
    with pytest.raises(TypeError, match="acc must be"):
        wrapper(u_mov, pos, val, da, db, 0.4, 0.6, u_static, out=out,
                acc=torch.zeros((port_splat._scratch_numel(H, W, C1, bf),)))


@pytest.mark.parametrize("slr", [False, True], ids=["K2", "K2-SLR"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_wrappers_take_the_padded_scratch_and_give_the_plain_result(slr, dtype):
    C1 = 67
    (u_mov, pos, val, da, db, u_static), _ = _inputs(C1, dtype)
    u_mov, u_static = u_mov.to(dtype), u_static.to(dtype)
    n_norm = 2 if slr else 1
    wrapper, plain = ((port_splat.splat_dual_normalize_slr,
                       port_splat.splat_dual_normalize_slr_plain) if slr else
                      (port_splat.splat_dual_normalize,
                       port_splat.splat_dual_normalize_plain))
    out = torch.empty((H, W, C1 - n_norm))
    acc = port_splat.splat_scratch(H, W, C1, dtype, "cpu")
    wrapper(u_mov, pos, val, da, db, 0.4, 0.6, u_static, out=out, acc=acc)
    want = plain(u_mov, pos, val, da, db, 0.4, 0.6, u_static, torch.float32)
    assert torch.equal(out, want)
