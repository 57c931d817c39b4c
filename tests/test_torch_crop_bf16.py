"""The port's crop rollouts in the bfloat16 render modes against the JAX
package's, on tests/test_torch_crop.py's scenes, models and weights.

In bf16 the port packs the static decode input in the networks' dtype, as
its per-frame rows are packed (``engine/rollout.py:
_baseline_static_decode_input``); JAX packs it in float32. So each case
holds the port's crop rollout, every output:

* against JAX's crop rollout in the same mode within 2e-2, the JAX
  package's bound for its bf16 modes (tests/test_rollout_sparse.py:88);
* at most twice as far from JAX's float32 crop rollout as JAX's own crop
  rollout in that mode is (the bf16 rule of tests/test_torch_rollout.py);
* against the port's uncropped rollout in the same mode within 2e-6, the
  crop's exactness."""

import numpy as np
import pytest

from test_torch_crop import SCENES, crop_rollouts, env  # noqa: F401 (fixture)


def _dist(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max())


@pytest.mark.parametrize("mode", ["bfloat16", "bfloat16-fast"])
@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("v2", [False, True])
@pytest.mark.parametrize("slr", [False, True], ids=["baseline", "slr"])
def test_bf16_crop_rollout_matches_jax(env, slr, v2, scene, mode):  # noqa: F811
    o = crop_rollouts(env, slr, v2, scene, mode)
    for k in o["port"]:
        port = o["port"][k].float().numpy()
        jax_mode = np.asarray(o["jax"][k], np.float32)
        jax_f32 = np.asarray(o["jax_f32"][k], np.float32)
        np.testing.assert_allclose(port, jax_mode, rtol=0, atol=2e-2, err_msg=k)
        jax_delta = _dist(jax_mode, jax_f32)
        assert jax_delta > 0.0, k  # the mode really ran in bf16
        assert _dist(port, jax_f32) <= 2.0 * jax_delta, (k, _dist(port, jax_f32),
                                                         jax_delta)
        np.testing.assert_allclose(port, o["full"][k].float().numpy(), rtol=0,
                                   atol=2e-6, err_msg=k)
