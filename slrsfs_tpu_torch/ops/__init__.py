"""The port's ops under the JAX ``slrsfs_tpu.ops`` names, every one of
them: ``max_splat`` and ``inverse_max_gather`` are K6's two halves as
kernels of their own (K6a, K6b); ``maximum_warp_norm_splat`` runs K6's one
launch for one channel and the pair for more."""

from slrsfs_tpu_torch.ops.euler import (
    euler_integrate,
    euler_integrate_all,
    euler_integrate_all_dual,
    euler_integrate_compact,
    euler_integrate_compact_dual,
    euler_integrate_phased,
    euler_integrate_phased_compact,
)
from slrsfs_tpu_torch.ops.maxwarp import (
    inverse_max_gather,
    max_splat,
    maximum_warp_norm_splat,
)
from slrsfs_tpu_torch.ops.splat import softsplat, softsplat_sum, softsplat_sum_at

__all__ = [
    "softsplat",
    "softsplat_sum",
    "softsplat_sum_at",
    "max_splat",
    "inverse_max_gather",
    "maximum_warp_norm_splat",
    "euler_integrate",
    "euler_integrate_all",
    "euler_integrate_compact",
    "euler_integrate_compact_dual",
    "euler_integrate_all_dual",
    "euler_integrate_phased",
    "euler_integrate_phased_compact",
]
