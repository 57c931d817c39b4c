"""The controls on the card, at sizes a test run holds: each must fail its
cell's output check. Run on the card with

    python3 -m pytest -m gpu benchmark/tests/test_bench_controls_gpu.py -q
"""

import pytest
import torch

from benchmark import controls
from benchmark.harness import load_json


def _cell(name: str):
    bench = load_json("BENCHMARK.json")
    cell = [w for w in bench["workloads"] if w["name"] == name][0]
    cfg_file = [c for c in bench["configs"] if c["name"] == cell["config"]][0]["file"]
    return (cell, load_json(cfg_file),
            load_json(f"benchmark/traffic/{cell['traffic']}.json"),
            load_json(f"benchmark/limits/{name}.json"))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [1, 2147483650])
def test_render_fp8_control_fails(card, seed):
    cell, cfg, mix, limits = _cell("baseline-render768-bf16")
    mix = dict(mix, W=384, check_scenes=2)
    got = controls.render_control(cell, mix, cfg, seed, card)["control"]
    assert got["frame_mad_max"] > limits["frame_mad_max"], got


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["baseline-train256-f32", "slr-train256-f32"])
def test_training_tf32_control_fails(card, name):
    cell, cfg, mix, limits = _cell(name)
    mix = dict(mix, batch_size=4, bands=mix["bands"][::4])
    got = controls.train_control(cell, mix, cfg, 3, card)
    assert any(v > limits[k] for k, v in got["control"].items()), got
    assert any(v > limits[k] for k, v in got["half_batch"].items()), got
