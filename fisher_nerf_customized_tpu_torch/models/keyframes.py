"""Keyframe buffer.

Poses and ids are kept on the host (numpy); each keyframe's color and
depth are kept as given, a device tensor from the simulator or a host
array from a checkpoint, and converted to the other side only when asked.
"""
from __future__ import annotations

import numpy as np
import torch


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().astype(np.float32)
    return np.asarray(x, np.float32)


class KeyframeBuffer:
    def __init__(self, height: int, width: int):
        self.colors: list = []     # (H, W, 3) float32 in [0, 1]
        self.depths: list = []     # (H, W) float32
        self.w2cs: list[np.ndarray] = []
        self.ids: list[int] = []
        self.height, self.width = height, width

    def __len__(self):
        return len(self.ids)

    def append(self, color, depth, w2c, frame_id: int):
        self.colors.append(color)
        self.depths.append(depth)
        self.w2cs.append(np.asarray(w2c, np.float32))
        self.ids.append(int(frame_id))

    def color_dev(self, i: int, device) -> torch.Tensor:
        return torch.as_tensor(self.colors[i], dtype=torch.float32,
                               device=device)

    def depth_dev(self, i: int, device) -> torch.Tensor:
        return torch.as_tensor(self.depths[i], dtype=torch.float32,
                               device=device)

    def stacked_w2cs(self) -> np.ndarray:
        if not self.w2cs:
            return np.zeros((0, 4, 4), np.float32)
        return np.stack(self.w2cs)

    def state_dict(self):
        return dict(colors=[_to_numpy(c) for c in self.colors],
                    depths=[_to_numpy(d) for d in self.depths],
                    w2cs=self.w2cs, ids=self.ids)

    def load_state_dict(self, d):
        self.colors = [np.asarray(c, np.float32) for c in d["colors"]]
        self.depths = [np.asarray(c, np.float32) for c in d["depths"]]
        self.w2cs = [np.asarray(c, np.float32) for c in d["w2cs"]]
        self.ids = [int(i) for i in d["ids"]]
