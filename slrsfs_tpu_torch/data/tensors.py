"""Motion tensor loading (the reference's ``*_motion.pth`` files).

Reference ``load_compressed_tensor`` (utils/utils.py:111-115) reads an
lz4framed-compressed pickle of a torch tensor. Supported formats, by
sniffing:

* plain ``torch.save`` .pth (zip or legacy pickle),
* lz4-frame (magic 0x184D2204) via the ``lz4`` package if installed, else
  through the system ``liblz4`` (ctypes, ``data/lz4f.py``),
* numpy ``.npy`` / ``.npz``.
"""

from __future__ import annotations

import pickle

import numpy as np

_LZ4_MAGIC = b"\x04\x22\x4d\x18"


def load_compressed_tensor(path: str) -> np.ndarray:
    """Load a motion tensor as numpy, in the layout it was stored in."""
    if path.endswith(".npy"):
        return np.load(path)
    if path.endswith(".npz"):
        z = np.load(path)
        return z[list(z.files)[0]]
    with open(path, "rb") as f:
        head = f.read(4)
    if head == _LZ4_MAGIC:
        with open(path, "rb") as f:
            blob = f.read()
        try:
            import lz4.frame

            raw = lz4.frame.decompress(blob)
        except ImportError:
            from slrsfs_tpu_torch.data import lz4f

            if not lz4f.available():
                raise ImportError(
                    f"{path} is lz4-framed (the reference's format) but "
                    "neither the lz4 package nor liblz4.so is available; "
                    "re-encode it with slrsfs_tpu_torch.data.tensors.save_motion")
            raw = lz4f.decompress(blob)
        # the reference's motion files are pickled torch tensors
        return _to_numpy(pickle.loads(raw))
    import torch

    return _to_numpy(torch.load(path, map_location="cpu", weights_only=False))


def _to_numpy(t) -> np.ndarray:
    if hasattr(t, "detach"):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def save_motion(path: str, flow_hw2: np.ndarray) -> None:
    """The native compressed flow format: (H, W, 2) float32 ``.npz`` under
    the key ``flow``, as the JAX ``save_motion`` writes it."""
    flow_hw2 = np.asarray(flow_hw2, np.float32)
    if flow_hw2.ndim != 3 or flow_hw2.shape[-1] != 2:
        raise ValueError(f"motion must be (H, W, 2), got {flow_hw2.shape}")
    np.savez_compressed(path, flow=flow_hw2)


def motion_to_hw2(flow) -> np.ndarray:
    """Any stored layout ((1,{2,3},H,W), ({2,3},H,W), (H,W,{2,3})) → (H, W, 2).
    A 3-channel uv·m motion folds to uv*m (animating_softmax_splating.py:541-546)."""
    flow = _to_numpy(flow)
    if flow.ndim == 4:
        flow = flow[0]
    if flow.ndim == 3 and flow.shape[0] in (2, 3) and flow.shape[-1] not in (2, 3):
        flow = flow.transpose(1, 2, 0)
    if flow.shape[-1] == 3:
        flow = flow[..., :2] * flow[..., 2:3]
    if flow.shape[-1] != 2:
        raise ValueError(f"motion must have 2 or 3 channels, got {flow.shape}")
    return np.ascontiguousarray(flow, dtype=np.float32)
