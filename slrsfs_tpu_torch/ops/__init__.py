"""The port's ops under the JAX ``slrsfs_tpu.ops`` names. ``max_splat`` and
``inverse_max_gather`` (the two halves of K6) are not exported: the K6
kernel runs them as one entry, ``maximum_warp_norm_splat``."""

from slrsfs_tpu_torch.ops.euler import (
    euler_integrate,
    euler_integrate_all,
    euler_integrate_all_dual,
    euler_integrate_compact,
    euler_integrate_compact_dual,
    euler_integrate_phased,
    euler_integrate_phased_compact,
)
from slrsfs_tpu_torch.ops.maxwarp import maximum_warp_norm_splat
from slrsfs_tpu_torch.ops.splat import softsplat, softsplat_sum, softsplat_sum_at

__all__ = [
    "softsplat",
    "softsplat_sum",
    "softsplat_sum_at",
    "maximum_warp_norm_splat",
    "euler_integrate",
    "euler_integrate_all",
    "euler_integrate_compact",
    "euler_integrate_compact_dual",
    "euler_integrate_all_dual",
    "euler_integrate_phased",
    "euler_integrate_phased_compact",
]
