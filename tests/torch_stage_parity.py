"""Shared helpers of the stage-trainer parity tests (the port's ``Trainer``
against the JAX ``Trainer``; not a test module).

The conventions are tests/test_torch_trainer.py's: zero BN noise on both
sides (the JAX ``NoiseBN`` called with ``deterministic=True`` through a
test-only ``flax.linen.intercept_methods`` interceptor, the port's
trainer ``deterministic``), the JAX trainer's initial variables carried
into the port by ``from_jax_variables``, two steps on one batch, the
port's second step from JAX's state after the first (variables and Adam
moments: with b1 = 0 Adam's first update is about ±lr, so a gradient whose
sign differs at round-off moves a parameter by 2·lr, and through a
predicted motion that moves trajectories across rounding boundaries). The
checks compare each top-level sub-network apart (``encoder``,
``projector``, ``motion_regressor``, ``net_bg``, the regressor's
``motion_predictor``, D):

* every logged loss within ``LOSS_RTOL`` relative (the PSNR and SSIM
  metrics, which may sit near 0, also within ``LOSS_RTOL`` absolute);
* gradients of the first step (Adam's first moment, which with b1 = 0 is
  the last gradient) within ``GRAD_REL`` of the sub-network's largest
  gradient entry (the reason beside the constant);
* parameters: test_torch_trainer.py's rule (where every step's |g| is
  above 1e-2 of the sub-network's largest, within 1e-6 after one step and
  1e-6 + 0.01·lr after two; everywhere within 2·k·lr + 1e-6), BN
  statistics and spectral vectors within ``STATE_TOL``."""

from __future__ import annotations

import numpy as np
import torch

import jax
import jax.numpy as jnp
import optax
from flax import linen as nn
from flax.traverse_util import flatten_dict, unflatten_dict

from slrsfs_tpu.nn.norm import NoiseBN as JaxNoiseBN
from slrsfs_tpu_torch.cli.train import to_device_batch
from slrsfs_tpu_torch.io.convert import from_jax_variables

LOSS_RTOL = 1e-4
# Of each sub-network's largest gradient entry. The losses' derivatives
# have kinks (the discriminator's leaky ReLUs and feature-matching L1
# signs, VGG's ReLUs): moving the port's own generated image by the
# 1.5e-5 that separates it from JAX's after one joint step moves the
# port's GAN-loss gradient by 7.4 % of its largest entry at 188 elements.
# After one step from the same state the sub-networks' gradients agree
# within 1.4e-4 of their largest (the regressor's within 1.6e-4 from
# unsettled spectral vectors), so they are held at 2.5e-4, above those
# readings and not at 1e-4, which they exceed; a second step's gradients
# are not compared.
GRAD_REL = 2.5e-4
STATE_TOL = (1e-5, 5e-4)  # after one step, after two


def zero_noise(next_fun, args, kwargs, context):
    """Calls every JAX NoiseBN with deterministic=True (zero noise)."""
    if isinstance(context.module, JaxNoiseBN) and context.method_name == "__call__":
        args = (args[0], args[1], True) + tuple(args[3:])
    return next_fun(*args, **kwargs)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def jnp_batch(batch):
    return {k: [jnp.asarray(x) for x in v] if k == "images" else jnp.asarray(v)
            for k, v in batch.items()}


def port_batch(batch):
    return to_device_batch({k: ([np.asarray(x) for x in v] if k == "images"
                                else np.asarray(v)) for k, v in batch.items()}, "cpu")


def adam_state(opt_state):
    """The (first) Adam state in an optax state; the leaves of masked-out
    (frozen) parameters are ``optax.MaskedNode``."""
    for s in jax.tree.leaves(opt_state,
                             is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState)):
        if isinstance(s, optax.ScaleByAdamState):
            return s
    raise AssertionError("no Adam state")


def adam_mu(opt_state):
    """Adam's first moment: with b1 = 0 the last step's gradient."""
    return adam_state(opt_state).mu


def jax_steps(jtr, state, batch, n: int = 2):
    """``n`` zero-noise JAX steps on ``batch`` (numpy): [(state, logs)]."""
    step_fn = jtr.make_train_step()

    @jax.jit
    def jstep(s, b):
        with nn.intercept_methods(zero_noise):
            return step_fn(s, b, jax.random.PRNGKey(1))

    out, jb = [], jnp_batch(batch)
    for _ in range(n):
        state, logs = jstep(state, jb)
        out.append((state, np_tree(logs)))
    return out


def load_port(model, d_model, opt, state):
    """The JAX trainer's G and D variables into the port's modules."""
    model.load_state_dict(from_jax_variables(np_tree(
        {"params": state.g_params, "batch_stats": state.g_stats,
         "spectral": state.g_spectral}), opt, model))
    d_model.load_state_dict(from_jax_variables(np_tree(
        {"params": state.d_params, "spectral": state.d_spectral}), opt, d_model))


def _named_params(opt, module, cols, names):
    """{name: tensor} of ``names`` (parameters of ``module``) from JAX
    collections whose params tree may hold optax.MaskedNode leaves for
    frozen sub-networks (those names are not asked for)."""
    tops = sorted({n.split(".", 1)[0] for n in names})
    out = {}
    children = dict(module.named_children())
    for top in tops:
        if top in children and top in cols["params"]:
            sd = from_jax_variables(np_tree(_sub(cols, top)), opt, children[top])
            out.update({f"{top}.{k}": v for k, v in sd.items()})
        else:  # a module whose parameters sit at its top (D)
            out.update(from_jax_variables(np_tree(cols), opt, module))
    return {n: out[n] for n in names}


def sync_port(tr, opt, js):
    """The port trainer set to the JAX state ``js``: G and D variables, both
    Adam states (moments and count)."""
    load_port(tr.model, tr.d_model, opt, js)
    for adam, state, module, names, cols in (
            (tr.opt_g, js.opt_g, tr.model, tr.g_names,
             dict(batch_stats=js.g_stats, spectral=js.g_spectral)),
            (tr.opt_d, js.opt_d, tr.d_model,
             [n for n, _ in tr.d_model.named_parameters()], dict(spectral=js.d_spectral))):
        a = adam_state(state)
        mu = _named_params(opt, module, {"params": a.mu, **cols}, names)
        nu = _named_params(opt, module, {"params": a.nu, **cols}, names)
        with torch.no_grad():
            for n, m, v in zip(names, adam.mu, adam.nu):
                m.copy_(mu[n])
                v.copy_(nu[n])
        adam.count = int(a.count)


def port_steps(tr, batch, n: int = 2, sync=None):
    """``n`` port steps: (logs, {name: grad} of G, D grads, (G, D) state
    dicts) after each. ``sync(k)``, when given, sets the trainer to JAX's
    state before step k > 0, so that every step starts where JAX's did."""
    pb = port_batch(batch)
    out = []
    for k in range(n):
        if sync is not None and k > 0:
            sync(k)
        logs = tr.train_step(pb)
        g = dict(zip(tr.g_names, tr.last_grads["g"]))
        d = dict(zip([k for k, _ in tr.d_model.named_parameters()], tr.last_grads["d"]))
        out.append((logs, g, d, ({k: v.clone() for k, v in tr.model.state_dict().items()},
                                 {k: v.clone() for k, v in tr.d_model.state_dict().items()})))
    return out


# metrics that may sit near 0 (a PSNR of about 0 dB at random weights):
# held at LOSS_RTOL of 1 as well as of their value
METRICS = ("psnr", "ssim", "PSNR_motion")


def check_losses(got, want, names=()):
    for name in names:
        assert name in got, (name, sorted(got))
    assert set(got) == set(want), (sorted(got), sorted(want))
    for name in want:
        atol = LOSS_RTOL if name in METRICS else 1e-6
        np.testing.assert_allclose(float(got[name]), float(want[name]),
                                   rtol=LOSS_RTOL, atol=atol, err_msg=name)


def _sub(tree_cols, name):
    return {c: t[name] for c, t in tree_cols.items() if name in t}


def g_groups(model, names=None):
    """The model's top-level sub-networks (the regressor's predictor for a
    standalone regressor): [(name, module)]."""
    groups = [(n, m) for n, m in model.named_children() if list(m.parameters())]
    return [g for g in groups if names is None or g[0] in names]


def check_grads(opt, model, d_model, js, g_got, d_got, groups):
    """Port gradients (by parameter name) against the JAX state's Adam
    first moments, sub-network by sub-network (``groups`` of G, then D);
    returns {group: max difference / largest entry}."""
    rel = {}
    mu_g = adam_mu(js.opt_g)
    for name, sub in groups:
        want = from_jax_variables(np_tree(_sub(
            {"params": mu_g, "batch_stats": js.g_stats, "spectral": js.g_spectral},
            name)), opt, sub)
        got = {k[len(name) + 1:]: v for k, v in g_got.items() if k.startswith(name + ".")}
        assert got, name
        rel[name] = _close_rel(got, want, name)
    want = from_jax_variables(np_tree({"params": adam_mu(js.opt_d),
                                       "spectral": js.d_spectral}), opt, d_model)
    rel["D"] = _close_rel(d_got, want, "D")
    return rel


def _close_rel(got, want, what):
    scale = max(np.abs(want[k].numpy()).max() for k in got)
    assert scale > 0, what
    worst = 0.0
    for k, g in got.items():
        d = np.abs(g.numpy() - want[k].numpy()).max()
        worst = max(worst, d / scale)
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=0,
                                   atol=GRAD_REL * scale, err_msg=f"{what} {k}")
    return worst


def check_state(opt, sd_got, js_list, k, module, which, groups=None):
    """Parameters, BN statistics and spectral vectors of ``module`` after
    step k against the JAX states (``js_list`` holds every step's state up
    to k), sub-network by sub-network for G. Returns the parameters
    checked at the tight bound."""
    lr = opt.lr_g if which == "g" else opt.lr_d
    js = js_list[k]

    def cols(s, params=None):
        if which == "g":
            return {"params": s.g_params if params is None else params,
                    "batch_stats": s.g_stats, "spectral": s.g_spectral}
        return {"params": s.d_params if params is None else params,
                "spectral": s.d_spectral}

    parts = groups if which == "g" else [("", module)]
    n_checked = 0
    for gname, sub in parts:
        def pick(tree):
            return _sub(tree, gname) if gname else tree

        want = from_jax_variables(np_tree(pick(cols(js))), opt, sub)
        grads = [from_jax_variables(np_tree(pick(cols(
            s, adam_mu(s.opt_g if which == "g" else s.opt_d)))), opt, sub)
            for s in js_list[:k + 1]]
        params = {n for n, _ in sub.named_parameters()}
        scales = [max(np.abs(gj[n].numpy()).max() for n in params) for gj in grads]
        pre = gname + "." if gname else ""
        for name in sub.state_dict():
            got, w = sd_got[pre + name].numpy(), want[name].numpy()
            if name not in params:
                np.testing.assert_allclose(got, w, rtol=0, atol=STATE_TOL[k],
                                           err_msg=pre + name)
                continue
            big = np.ones(w.shape, bool)
            for gj, scale in zip(grads, scales):
                big &= np.abs(gj[name].numpy()) > 1e-2 * scale
            n_checked += int(big.sum())
            np.testing.assert_allclose(got[big], w[big], rtol=0,
                                       atol=1e-6 + 1e-2 * k * lr, err_msg=pre + name)
            np.testing.assert_allclose(got, w, rtol=0, atol=2 * (k + 1) * lr + 1e-6,
                                       err_msg=pre + name)
    return n_checked


def numpy_init(model, batch, seed: int, method: str = "forward_train"):
    """JAX variables of ``model`` drawn with numpy into ``jax.eval_shape``'s
    shapes (tests/test_torch_slr_train.py's rule: LeCun-normal kernels,
    zero biases, BN statistics near (0, 1), each spectral pair settled by
    30 power iterations): a jitted JAX init of the reference archs takes
    minutes on one CPU."""
    shapes = jax.eval_shape(
        lambda r, b: model.init(r, b, True, False, method=getattr(model, method)),
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}, batch)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            a = rng.standard_normal(leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name in ("u", "v"):
            a = rng.standard_normal(leaf.shape)
            a /= np.linalg.norm(a)
        elif name == "stored_var":
            a = np.ones(leaf.shape)
        elif name == "stored_mean":
            a = rng.standard_normal(leaf.shape) * 0.1
        else:
            a = np.zeros(leaf.shape)
        return jnp.asarray(a, leaf.dtype)

    variables = jax.tree.map(np.asarray, jax.tree_util.tree_map_with_path(draw, shapes))
    variables["spectral"] = settled_spectral(variables["params"], variables["spectral"])
    return jax.tree.map(jnp.asarray, variables)


def settled_spectral(params, spectral):
    """Each spectral (u, v) after 30 power iterations on its kernel (JAX's
    (out, kh·kw·in) matrix): random vectors give a sigma far below the true
    norm, and the networks then amplify summation-order differences."""
    params = flatten_dict(np_tree(params))
    spectral = flatten_dict(np_tree(spectral))
    for path in [p for p in spectral if p[-1] == "u"]:
        k = params[path[:-2] + ("kernel",)]
        w_mat = k.transpose(3, 0, 1, 2).reshape(k.shape[3], -1) if k.ndim == 4 else k.T
        u = spectral[path]
        for _ in range(30):
            v = w_mat.T @ u
            v = v / np.linalg.norm(v)
            u = w_mat @ v
            u = u / np.linalg.norm(u)
        spectral[path], spectral[path[:-1] + ("v",)] = u, v
    return jax.tree.map(jnp.asarray, unflatten_dict(spectral))


def settled_state(state):
    """A JAX ``TrainState`` with G's and D's spectral vectors settled."""
    return state.replace(
        g_spectral=settled_spectral(state.g_params, state.g_spectral),
        d_spectral=settled_spectral(state.d_params, state.d_spectral))


def check_pred(got, want, tols=None):
    """Every pred tensor within 1e-4 of its largest magnitude (``tols``:
    other bounds by key)."""
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k, w in want.items():
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-6)
        tol = (tols or {}).get(k, 1e-4)
        np.testing.assert_allclose(got[k].detach().numpy(), w, rtol=0,
                                   atol=tol * scale, err_msg=k)
