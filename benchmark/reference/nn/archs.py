"""Architecture tables for the BigGAN-style ResNet encoder/decoders.

These are the hyperparameter tables of reference
``models/networks/configs.py`` (get_resnet_arch), restricted to the setups the
shipped scripts exercise. The setup key is the second ``_``-separated token of
the model-type string (reference ``configs.py:2``). Values are expressed in
terms of ``ngf`` / ``out_channel`` exactly as the reference computes them.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from benchmark.reference.config import Options


def get_resnet_arch(model_type: str, opt: Options, in_channels: int = 3) -> Dict:
    setup = model_type.split("_")[1]
    ngf = opt.ngf

    if setup == "256W8UpDown64":
        # reference configs.py:94-150
        return dict(
            layers_enc=[in_channels, ngf // 2, ngf // 2, ngf // 2, ngf, ngf, ngf, ngf, 64],
            downsample=[False] * 8,
            layers_dec=[64, ngf, ngf * 2, ngf * 4, ngf * 4, ngf * 2, ngf * 2, ngf * 2, 3],
            upsample=[False, "Down", "Down", False, "Up", "Up", False, False],
            activation=["Relu"] * 8,
        )
    if setup == "256W5UpDown64":
        # reference configs.py:52-93
        return dict(
            layers_enc=[in_channels, ngf // 2, ngf // 2, ngf, ngf, 64],
            downsample=[False] * 5,
            layers_dec=[64, ngf * 2, ngf * 4, ngf * 4, ngf * 2, 3],
            upsample=["Down", "Down", False, "Up", "Up"],
            activation=["Relu"] * 5,
        )
    if setup == "256W8UpDown64BG":
        # reference configs.py:233-278 — decoder-only table for the background
        # "mean video" network: image (3ch) in, image out.
        return dict(
            layers_enc=None,
            downsample=[False] * 8,
            layers_dec=[3, ngf, ngf * 2, ngf * 4, ngf * 4, ngf * 2, ngf * 2, ngf * 2, 3],
            upsample=[False, "Down", "Down", False, "Up", "Up", False, False],
            activation=["Relu"] * 8,
        )
    if setup == "256W8UpDown64Alpha":
        # reference configs.py:313-358 — decoder-only table (image in, 2ch out).
        return dict(
            layers_enc=None,
            downsample=[False] * 8,
            layers_dec=[3, ngf, ngf * 2, ngf * 4, ngf * 4, ngf * 2, ngf * 2, ngf * 2, 2],
            upsample=[False, "Down", "Down", False, "Up", "Up", False, False],
            activation=["Relu"] * 8,
        )
    if setup == "256W8UpDown64Layers":
        # reference configs.py:407-463 — encoder emits opt.out_channel (65),
        # decoder in/out widened by the additional decoder channels.
        return dict(
            layers_enc=[in_channels, ngf // 2, ngf // 2, ngf // 2, ngf, ngf, ngf, ngf,
                        opt.out_channel],
            downsample=[False] * 8,
            layers_dec=[64 + opt.addtional_decoder_input, ngf, ngf * 2, ngf * 4, ngf * 4,
                        ngf * 2, ngf * 2, ngf * 2, 3 + opt.addtional_decoder_output],
            upsample=[False, "Down", "Down", False, "Up", "Up", False, False],
            activation=["Relu"] * 8,
        )
    if setup == "256W16UpDown64":
        # reference configs.py:151-231 — deeper 16-block decoder variant.
        return dict(
            layers_enc=[in_channels, ngf // 2, ngf // 2, ngf // 2, ngf // 2,
                        ngf, ngf, ngf, 64],
            downsample=[False] * 8,
            layers_dec=[64, ngf, ngf * 2] + [ngf * 4] * 10
                       + [ngf * 2, ngf * 2, ngf * 2, 3],
            upsample=[False, "Down", "Down"] + [False] * 9
                     + ["Up", "Up", False, False],
            activation=["Relu"] * 16,
        )
    if setup == "256W5UpDown64BG":
        # reference configs.py:279-312 — shallow BG decoder.
        return dict(
            layers_enc=None,
            downsample=[False] * 3,
            layers_dec=[3, ngf, ngf * 2, ngf * 2, ngf, 3],
            upsample=["Down", "Down", False, "Up", "Up"],
            activation=["Relu"] * 5,
        )
    if setup == "256W8UpDown64SingleAlpha":
        # reference configs.py:360-405 — single-channel alpha decoder.
        return dict(
            layers_enc=None,
            downsample=[False] * 8,
            layers_dec=[3, ngf, ngf * 2, ngf * 4, ngf * 4, ngf * 2, ngf * 2,
                        ngf * 2, 1],
            upsample=[False, "Down", "Down", False, "Up", "Up", False, False],
            activation=["Relu"] * 8,
        )
    if setup == "256W5UpDown64Layers":
        # reference configs.py:464-501 — shallow Layers decoder.
        return dict(
            layers_enc=None,
            downsample=[False] * 6,
            layers_dec=[64, ngf * 2, ngf * 4, ngf * 4, ngf * 2,
                        3 + opt.addtional_decoder_output],
            upsample=["Down", "Down", False, "Up", "Up"],
            activation=["Relu"] * 5,
        )
    if setup == "TinyTest":
        # TEST-ONLY setup (no reference analog): 2-block encoder/decoder
        # preserving the encoder(+Z)/pconv-decoder plumbing at a fraction of
        # the compile cost. Feature width is ngf (tests set out_channel =
        # ngf + 1 so the Z split works); used by trainer/engine mechanics
        # tests, never by parity tests.
        return dict(
            layers_enc=[in_channels, ngf, opt.out_channel],
            downsample=[False, False],
            layers_dec=[ngf + opt.addtional_decoder_input, ngf,
                        3 + opt.addtional_decoder_output],
            upsample=[False, False],
            activation=["Relu", "Relu"],
        )
    if setup == "TinyTestUpDown":
        # TEST-ONLY setup (no reference analog): TinyTest plus one Down/Up
        # pair in the decoder so the cropped-decode machinery's pooling
        # alignment and receptive-radius bound are exercised at CPU-test
        # sizes (tests/test_crop_rollout.py).
        return dict(
            layers_enc=[in_channels, ngf, opt.out_channel],
            downsample=[False, False],
            layers_dec=[ngf + opt.addtional_decoder_input, ngf, ngf, ngf,
                        3 + opt.addtional_decoder_output],
            upsample=[False, "Down", "Up", False],
            activation=["Relu"] * 4,
        )
    if setup == "TinyTestBG":
        # TEST-ONLY decoder-only table (image in, image out).
        return dict(
            layers_enc=None,
            downsample=[False, False],
            layers_dec=[3, ngf, 3],
            upsample=[False, False],
            activation=["Relu", "Relu"],
        )
    if setup == "256W4UpDown64Motion":
        # reference configs.py:502-538 — small motion encoder/decoder.
        return dict(
            layers_enc=[in_channels, ngf // 2, ngf // 2, ngf, 64],
            downsample=[False] * 4,
            layers_dec=[64, ngf * 2, ngf * 4, ngf * 2, 2],
            upsample=["Down", False, "Up", False],
            activation=["LRelu"] * 4,
        )
    raise ValueError(f"unknown resnet arch setup: {setup} (from {model_type})")
