"""Training cells: the port's per-step path of ``cli/train.py`` on a seeded
pool of host batches: ``attach_moving_sets`` (the moving sets of the
compact K7, with the CLI's eps 0.5/T), ``to_device_batch``,
``Trainer.train_step`` and the logged losses read as floats, as the CLI's
loop reads them. One trainer is built in set-up; its first steps (the
checked steps) are also the warm-up, and the same trainer runs the window.

Correctness: the plain reference (``benchmark/reference/train.py``) starts
from the same weights and BN-noise seed and takes the same first steps on
the same batches; the run compares each step's loss, each leaf's first
gradient norm (from the Adam state after one step: b1 is 0, so mu is the
gradient) and each leaf's change after the checked steps, each leaf's gap
measured against its reference norm or the median leaf's, whichever is
larger. The window's own steps are not held to the reference, which would
have to replay every step before them; a window step whose loss is not
finite counts as failed, and a run with one is not correct.

What differs between model types (the generators on both sides, their
further losses and inputs) is in ``benchmark/models/<model_type>.train.py``.
"""

from __future__ import annotations

import dataclasses
import gc
from typing import Dict, List

import numpy as np

from benchmark import generate, harness
from benchmark.harness import Marks, Readings, now, span

# leaves whose reference gradient is below this share of the median leaf's
# move under Adam by round-off alone: their change is not compared
CHANGE_FLOOR = 1e-3


def _tuples(d: Dict) -> Dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def options(cfg: Dict, mix: Dict):
    from benchmark.reference.config import Options

    return Options(W=mix["W"], batch_size=mix["batch_size"],
                   train_compute_dtype=mix["compute_dtype"], **_tuples(cfg["options"]))


def part_of(opt):
    """The model part of ``opt``'s model type
    (``benchmark/models/<model_type>.train.py``)."""
    return harness.model_part(opt.model_type, "train")


def make_weights(opt, seed: int, T: int, device):
    """(reference G, D, VGG on the host, {"g", "d", "vgg"} state_dicts)."""
    from benchmark import weights
    from benchmark.reference.train import build_models

    mods = [m.to(device) for m in build_models(opt, part_of(opt).reference_g(opt, T))]
    for stream, m in enumerate(mods, start=1):
        weights.fill(m, weights.generator(seed, 10 + stream, device))
    states = {k: weights.state_of(m) for k, m in zip(("g", "d", "vgg"), mods)}
    return [m.cpu() for m in mods], states


def leaf_norms(tensors) -> np.ndarray:
    import torch

    return np.array([float(torch.linalg.vector_norm(t.detach().float())) for t in tensors])


def gap(port: np.ndarray, ref: np.ndarray, keep=None) -> float:
    """The worst leaf's |port - ref| over max(ref, the median leaf's ref)."""
    if keep is not None:
        port, ref = port[keep], ref[keep]
    if not len(ref):
        return 0.0
    scale = np.maximum(ref, np.median(ref))
    return float(np.max(np.abs(port - ref) / np.maximum(scale, 1e-30)))


def compare(port: Dict, ref: Dict) -> Dict[str, float]:
    """The three compared numbers (``loss_gap``, ``grad_gap``,
    ``change_gap``) of two sides' readings."""
    lp, lr = np.array(port["losses"]), np.array(ref["losses"])
    out = {"loss_gap": float(np.max(np.abs(lp - lr) / np.abs(lr)))}
    out["grad_gap"] = max(gap(port["grads"][k], ref["grads"][k]) for k in ("g", "d"))
    ch = []
    for k in ("g", "d"):
        g = ref["grads"][k]
        keep = g >= CHANGE_FLOOR * np.median(g)
        ch.append(gap(port["change"][k], ref["change"][k], keep))
    out["change_gap"] = max(ch)
    return out


def reference_readings(opt, mods, states, mix: Dict, pool: Dict, seed: int, device,
                       allow_tf32: bool = False) -> Dict:
    """The reference's losses, first gradient norms and changes over the
    checked steps, from the same weights, seed and batches."""
    from benchmark.reference import train as ref

    g, d, vgg = (m.to(device) for m in mods)
    for m, k in ((g, "g"), (d, "d"), (vgg, "vgg")):
        m.load_state_dict(states[k])
    tr = ref.ReferenceTrainer(opt, g, d, vgg, seed=trainer_seed(seed),
                              steps_per_epoch=mix["steps_per_epoch"], device=device,
                              allow_tf32=allow_tf32,
                              extra_losses=part_of(opt).reference_extra_losses)
    eps = mix["sparsify_eps_times_t"] / mix["n_steps"]
    state: Dict = {}
    losses, grads = [], {}
    for j in range(mix["check_steps"]):
        b = ref.attach_moving_sets(pool["batches"][pool["order"][j]], state=state, eps=eps)
        logs = tr.step(ref.to_device(b, device))
        losses.append(float(logs["Total Loss"]))
        if j == 0:
            grads = {"g": leaf_norms(tr.opt_g.mu) / (1.0 - opt.beta1),
                     "d": leaf_norms(tr.opt_d.mu) / (1.0 - opt.beta1)}
    change = {"g": leaf_norms([p.cpu() - states["g"][n] for n, p in
                               zip(tr.g_names, tr.g_params)]),
              "d": leaf_norms([p.cpu() - states["d"][n] for n, p in
                               d.named_parameters()])}
    return {"losses": losses, "grads": grads, "change": change}


def port_readings(trainer, states: Dict, opt, step, n: int) -> Dict:
    """The port's losses over its first ``n`` steps (``step(j)`` runs step
    j and returns its loss), its first gradient norms from G's and D's Adam
    state after one step, and each leaf's change after the ``n``."""
    losses, grads = [], {}
    for j in range(n):
        losses.append(step(j))
        if j == 0:
            b1 = 1.0 - opt.beta1
            grads = {"g": leaf_norms(trainer.opt_g.mu) / b1,
                     "d": leaf_norms(trainer.opt_d.mu) / b1}
    change = {"g": leaf_norms([p.detach().cpu() - states["g"][n] for n, p in
                               zip(trainer.g_names, trainer.g_params)]),
              "d": leaf_norms([p.detach().cpu() - states["d"][n] for n, p in
                               trainer.d_model.named_parameters()])}
    return {"losses": losses, "grads": grads, "change": change}


def trainer_seed(seed: int) -> int:
    """The BN-noise generator's seed, on both sides."""
    return seed % (1 << 63)


def step_bounds(opt, mix: Dict, cfg: Dict, batches: List[Dict], device) -> Dict:
    """K3 and K7 bounds (seconds) of the traced steps' batches and the
    reference flops of the whole batches, by the frozen counts
    (``benchmark/roofline``, ``flops.py``)."""
    import torch

    from benchmark import flops
    from benchmark.reference import train as ref
    from benchmark.roofline import counts

    B, W, T = mix["batch_size"], mix["W"], mix["n_steps"]
    C = cfg["splat_channels"]
    eps = mix["sparsify_eps_times_t"] / T
    k3 = k7 = fl = 0.0
    for b in batches:
        k3 += 2 * (counts.k3_fwd(B, W, W, C)[0] + counts.k3_bwd(B, W, W, C)[0])
        sb = ref.attach_moving_sets(b, eps=eps)
        rows = sb["mov_pos"].shape[1] if "mov_pos" in sb else 0
        fl += flops.train_step(opt, B, W, T, rows)
        idx = sb["index"].astype(np.int64)
        tf = np.clip(idx[:, 1] - idx[:, 0], 0, T)
        tp = np.minimum(np.clip(idx[:, 2] + 1 - idx[:, 1], 0, None), T - tf)
        m = torch.from_numpy(np.ascontiguousarray(sb["motions"])).to(device)
        pos = val = None
        if "mov_pos" in sb:
            pos = torch.from_numpy(sb["mov_pos"]).to(device)
            val = torch.from_numpy(sb["mov_valid"]).to(device)
        k7 += counts.k7(B, W, W, counts.k7_steps(m, tf, tp, T, pos, val))[0]
    return {"k3": k3, "k7": k7, "flops": fl}


def build_port(opt, states: Dict, mix: Dict, seed: int, device):
    """The port's trainer as ``cli/train.py:build`` makes it, with the
    benchmark's weights loaded instead of its own random ones."""
    from slrsfs_tpu_torch.config import Options
    from slrsfs_tpu_torch.engine.trainer import Trainer, make_discriminator
    from slrsfs_tpu_torch.nn.vgg import VGG19Features

    popt = Options(**dataclasses.asdict(opt))
    model, extra_losses = part_of(opt).port_g(popt, mix["n_steps"])
    d_model = make_discriminator(popt, 3)
    vgg = VGG19Features()
    for m, k in ((model, "g"), (d_model, "d"), (vgg, "vgg")):
        m.load_state_dict(states[k])
    return Trainer(popt, model, steps_per_epoch=mix["steps_per_epoch"], vgg=vgg,
                   d_model=d_model, seed=trainer_seed(seed), device=device,
                   extra_losses_fn=extra_losses, task="synthesis")


def run(args, cell: Dict, mix: Dict, cfg: Dict, limits: Dict, t_start: float,
        device="cuda") -> Dict:
    import torch

    from slrsfs_tpu_torch import kernels
    from slrsfs_tpu_torch.cli.train import attach_moving_sets, to_device_batch

    dev = torch.device(device)
    r = Readings(cell=cell, traffic=mix, config=cfg, dtype=mix["compute_dtype"])
    opt = options(cfg, mix)
    T, B = mix["n_steps"], mix["batch_size"]
    mods, states = make_weights(opt, args.seed, T, dev)
    pool = generate.batch_pool(mix, args.seed, part_of(opt).batch_extras)
    trainer = build_port(opt, states, mix, args.seed, dev)
    eps = mix["sparsify_eps_times_t"] / T
    mov_state: Dict = {}

    def step(j: int, timer=None) -> float:
        b = pool["batches"][pool["order"][j % len(pool["order"])]]
        with span("attach_moving_sets"):
            b = attach_moving_sets(b, state=mov_state, eps=eps, n_steps=T)
        with span("to_device"):
            batch = to_device_batch(b, trainer.device)
        with span("train_step"):
            logs = trainer.train_step(batch, timer=timer)
        with span("logs"):
            row = {k: float(v) for k, v in logs.items()}
        return row["Total Loss"]

    port = port_readings(trainer, states, opt, step, mix["check_steps"])
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    r.setup_s = now() - t_start
    j = mix["check_steps"]
    t0 = now()
    bad = 0
    while now() - t0 < args.seconds:
        loss = step(j)
        bad += not np.isfinite(loss)
        j += 1
        r.steps += 1
    r.window_s = now() - t0
    r.samples = r.steps * B
    if dev.type == "cuda":
        r.peak_bytes = torch.cuda.max_memory_allocated()
    print(f"window: {r.steps} steps of {B} samples in {r.window_s:.3f} s; launches "
          f"{({n: c for n, c in kernels.counts().items() if c})}; K7 path "
          f"{mov_state.get('mode')} with P = {mov_state.get('P')}; moving shares "
          f"{[round(a, 3) for a in pool['areas']]}", flush=True)

    breakdown = None
    if args.trace:
        import os

        tmp = harness.scratch_dir()
        marks = Marks(dev.type == "cuda")
        first = j

        def sl():
            for k in range(mix["trace_steps"]):
                marks.start()
                step(first + k, timer=marks)

        r.trace = harness.traced(sl, tmp)
        os.rmdir(tmp)
        r.marks = marks.per_stage()
        traced_batches = [pool["batches"][pool["order"][(first + k) % len(pool["order"])]]
                          for k in range(mix["trace_steps"])]
        b = step_bounds(opt, mix, cfg, traced_batches, dev)
        r.bounds.update(k3=b["k3"], k7=b["k7"])
        r.flops = b["flops"]
        breakdown = {"device_ops": r.trace["device_ops"], "idle_gaps": r.trace["idle_gaps"]}
    del trainer
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_readings(opt, mods, states, mix, pool, args.seed, dev)
    checks = {k: {"value": v, "limit": limits[k]} for k, v in compare(port, ref).items()}
    return {"readings": r, "checks": checks, "attempted": r.steps, "failed": bad,
            "breakdown": breakdown}
