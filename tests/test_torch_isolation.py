"""The port stands alone: importing any of its modules (or chip_smoke.py)
pulls in neither JAX nor the JAX package nor scikit-learn nor torchvision
(which the card's machine lacks), builds no kernel, and its entry points
refuse to run without a card unless asked for the CPU."""

import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = textwrap.dedent("""
    import importlib, json, pkgutil, runpy, sys
    import slrsfs_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(
        slrsfs_tpu_torch.__path__, "slrsfs_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    runpy.run_path("chip_smoke.py", run_name="chip_smoke_probe")
    from slrsfs_tpu_torch import kernels
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                           "slrsfs_tpu", "sklearn", "torchvision"))
    built = [k.name for k in kernels.KERNELS if k._fn is not None]
    print(json.dumps({"n": len(names), "leaked": leaked, "built": built}))
""")


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["n"] >= 28, res
    assert res["leaked"] == [], res
    assert res["built"] == [], res


def test_port_sources_import_no_jax_or_sklearn():
    """No import statement, also inside a function, names JAX, flax, the
    JAX package, scikit-learn or torchvision."""
    import re

    banned = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|flax|optax|slrsfs_tpu|"
                        r"sklearn|torchvision)\b", re.M)
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "slrsfs_tpu_torch")):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    found = {p: banned.findall(open(p).read()) for p in paths}
    assert len(paths) >= 30
    assert not {p: m for p, m in found.items() if m}


def test_scene_renderer_without_card_raises():
    from slrsfs_tpu_torch.cli.render import SceneRenderer

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SceneRenderer()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SceneRenderer(W=16, n_frames=2, opt_overrides=dict(ngf=8), device="cuda")


def test_chip_smoke_fails_without_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_trainer_and_train_cli_without_card_raise(tmp_path):
    from slrsfs_tpu_torch.cli import train
    from slrsfs_tpu_torch.config import Options
    from slrsfs_tpu_torch.engine.trainer import Trainer
    from slrsfs_tpu_torch.models.baseline import BaselineTrainable

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    opt = Options(ngf=8, W=16, out_channel=9,
                  refine_model_type="resnet_TinyTest_de_resnet_pconv2_nonorm")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(opt, BaselineTrainable(opt))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--data-root", str(tmp_path), "--out", str(tmp_path / "run"),
                    "--W", "16", "--ngf", "8"])
