"""How far repeated training steps of one path move their own gradients:
the nondeterminism inside which ``chip_smoke.py``'s kernel-vs-plain step
checks (phases 10, 17 and 18: gradients within 1e-3 of the largest) sit.

    python -m slrsfs_tpu_torch.tools.step_noise_probe     # from the repository root

Builds phase 18's joint and fix-motion trainers (``Options()`` widths, the
shipped 8-down regressor, B = 16, 256², T = 60, the seed), takes one
warm-up step, then, from one snapshot, three kernel-path steps (k1, k2,
k3) and two plain-path steps (p1, p2), first with cuDNN's default
algorithms and then with ``cudnn.deterministic``, and prints for each pair
the largest gradient difference over the largest gradient. f32 atomics
(K3's forward, ``index_add_``, K7's backward) and cuDNN's algorithms
reorder sums from run to run. A missing card raises.
"""

from __future__ import annotations

import gc

import numpy as np
import torch


def main() -> int:
    import chip_smoke as cs
    from slrsfs_tpu_torch import kernels
    from slrsfs_tpu_torch.cli.train import MODEL_TYPE, build, stage_options, to_device_batch
    from slrsfs_tpu_torch.config import Options

    if not torch.cuda.is_available():
        raise RuntimeError("step_noise_probe needs a CUDA device")
    kernels.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    def grads(tr, batch, plain):
        tr.train_step(batch, plain=plain)
        return [x.clone() for x in tr.last_grads["g"] + tr.last_grads["d"]]

    def rel(a, b):
        d, s = cs._max_grad_diff(a, b)
        return d / s

    for label, frozen in (("joint", False), ("fix-motion", True)):
        opt = Options(W=cs.W, batch_size=cs.TRAIN_B, freeze_motion=frozen,
                      **stage_options(MODEL_TYPE, True))
        _, tr = build(opt, train_max_steps=cs.TRAIN_T, device=dev, seed=cs.SEED)
        batch = to_device_batch(cs.make_motion_train_batch(
            np.random.default_rng(cs.SEED), cs.TRAIN_B, cs.W), dev)
        tr.train_step(batch)
        for det in (False, True):
            torch.backends.cudnn.deterministic = det
            torch.backends.cudnn.benchmark = False
            snap = tr.snapshot()
            g = {}
            for name, plain in (("k1", False), ("p1", True), ("k2", False), ("p2", True),
                                ("k3", False)):
                g[name] = grads(tr, batch, plain)
                tr.restore(snap)
            print(f"{label} cudnn.deterministic={det}: "
                  + ", ".join(f"{a}-{b} {rel(g[a], g[b]):.3g}" for a, b in (
                      ("k1", "p1"), ("k2", "p2"), ("k2", "k1"), ("k3", "k1"), ("p2", "p1"))),
                  flush=True)
            del g, snap
        torch.backends.cudnn.deterministic = False
        del tr, batch
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
