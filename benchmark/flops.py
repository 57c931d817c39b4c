"""Floating-point operations of the work the timed path does, counted by
``torch.utils.flop_counter.FlopCounterMode`` on the meta device over the
benchmark's reference (``benchmark/reference``), never over the program:
the convolutions and matrix products of a scene's render at the
reference's own crop plan, and of a whole training step (G forward and
backward, both discriminator passes, VGG19 forward and backward). The
splats and integrations are not counted (no matrix products).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference.config import Options

META = torch.device("meta")


def _count(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return int(fc.get_total_flops())


@functools.lru_cache(maxsize=None)
def _render_model(build, opt_json: str, dtype: torch.dtype):
    with META:
        model = build(Options.from_json(opt_json)).eval()
    return model.to(dtype)


@functools.lru_cache(maxsize=None)
def _render_parts(build, opt_json: str, dtype: torch.dtype, size: int,
                  window: Optional[Tuple[int, int]], decode_batch: int) -> Tuple[int, int, int]:
    """(encode, one full-frame decode, one decode chunk) flops."""
    model = _render_model(build, opt_json, dtype)
    with torch.no_grad():
        img = torch.empty((1, size, size, 3), dtype=dtype, device=META)
        enc = _count(lambda: model.encode(img))
        C = model.encode(img)[0].shape[-1]
        full = _count(lambda: model.decode(torch.empty((1, size, size, C), dtype=dtype,
                                                       device=META)))
        h, w = window if window is not None else (size, size)
        chunk = _count(lambda: model.decode(torch.empty((decode_batch, h, w, C),
                                                        dtype=dtype, device=META)))
    return enc, full, chunk


def render_scene(build, opt: Options, dtype: torch.dtype, size: int, n_frames: int,
                 window: Optional[Tuple[int, int]], decode_batch: int) -> int:
    """One scene's render by the network ``build(opt)`` makes (with
    ``encode`` and ``decode``): the encode, the static full-frame decode
    when the scene is cropped to ``window`` (hc, wc), and N / decode_batch
    decode chunks on the window (or the full frame)."""
    enc, full, chunk = _render_parts(build, opt.to_json(), dtype, size, window, decode_batch)
    return enc + (full if window is not None else 0) + chunk * (n_frames // decode_batch)


@functools.lru_cache(maxsize=None)
def _train_step(opt_json: str, batch_shape: Tuple[int, int, int], moving_rows: int) -> int:
    from benchmark import harness
    from benchmark.reference.train import ReferenceTrainer, build_models

    opt = Options.from_json(opt_json)
    part = harness.model_part(opt.model_type, "train")
    B, size, T = batch_shape
    with META:
        g, d, vgg = build_models(opt, part.reference_g(opt, T))
    tr = ReferenceTrainer(opt, g, d, vgg, seed=None, steps_per_epoch=500, device=META,
                          extra_losses=part.reference_extra_losses)

    def e(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=META)

    batch = {"images": [e(B, size, size, 3) for _ in range(3)],
             "index": e(B, 3, dtype=torch.int32), "motions": e(B, size, size, 2),
             "mov_pos": e(B, moving_rows, 2, dtype=torch.int32),
             "mov_valid": e(B, moving_rows)}
    for k, v in part.batch_extras(np.random.default_rng(0), B, size).items():
        batch[k] = e(*v.shape)
    return _count(lambda: tr.step(batch))


def train_step(opt: Options, batch_size: int, size: int, n_steps: int,
               moving_rows: int) -> int:
    """One G+D step on a batch of ``batch_size`` samples at ``size``², a
    ``n_steps`` integration and moving sets of ``moving_rows`` rows."""
    return _train_step(opt.to_json(), (batch_size, size, n_steps), moving_rows)
