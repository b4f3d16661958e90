"""Synthetic moving point clouds for tests and benchmarks (the port's own copy
of ``mocopci_tpu/data/synthetic.py``; same seeds give the same clouds).

The real NL-Drive dataset is an external download (``README.md:30-35`` of the
reference); this generator produces structurally equivalent samples — a base
LiDAR-like cloud undergoing rigid motion + per-point jitter across 7 virtual
timestamps (4 input frames at t=0,1/3,2/3,1; 3 gt frames between the middle
pair), with the same ``(input 4×(N,3), gt 3×(N,3))`` contract.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def _rotation(axis: np.ndarray, angle: float) -> np.ndarray:
    axis = axis / np.linalg.norm(axis)
    a = np.cos(angle / 2)
    b, c, d = -axis * np.sin(angle / 2)
    return np.array(
        [
            [a * a + b * b - c * c - d * d, 2 * (b * c + a * d), 2 * (b * d - a * c)],
            [2 * (b * c - a * d), a * a + c * c - b * b - d * d, 2 * (c * d + a * b)],
            [2 * (b * d + a * c), 2 * (c * d - a * b), a * a + d * d - b * b - c * c],
        ],
        np.float32,
    )


class SyntheticInterpolationDataset:
    """len(dataset) samples of rigidly moving clouds."""

    def __init__(
        self,
        length: int = 32,
        num_points: int = 8192,
        seed: int = 0,
        max_shift: float = 1.0,
        max_angle: float = 0.15,
        jitter: float = 0.01,
    ):
        self.length = length
        self.num_points = num_points
        self.seed = seed
        self.max_shift = max_shift
        self.max_angle = max_angle
        self.jitter = jitter

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, index: int) -> Tuple[List[np.ndarray], List[np.ndarray]]:
        rng = np.random.default_rng(self.seed * 100003 + index)
        n = self.num_points
        # LiDAR-ish: points on noisy rings at varying ranges
        r = rng.uniform(2.0, 40.0, n).astype(np.float32)
        theta = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
        z = rng.normal(0, 1.5, n).astype(np.float32)
        base = np.stack([r * np.cos(theta), r * np.sin(theta), z], -1)

        shift = rng.uniform(-self.max_shift, self.max_shift, 3).astype(np.float32)
        axis = rng.normal(size=3).astype(np.float32)
        angle = rng.uniform(-self.max_angle, self.max_angle)

        # input timestamps 0, 1/3, 2/3, 1; gt at (1/3)+(1/9)*{1,2,3}·... matching
        # the reference's time grid: gt between the middle pair at 5/12, 1/2, 7/12
        ts_in = [0.0, 1.0 / 3, 2.0 / 3, 1.0]
        ts_gt = [5.0 / 12, 0.5, 7.0 / 12]

        def frame(t: float) -> np.ndarray:
            R = _rotation(axis, angle * t)
            pts = base @ R.T + shift * t
            pts = pts + rng.normal(0, self.jitter, (n, 3)).astype(np.float32)
            return pts.astype(np.float32)

        return [frame(t) for t in ts_in], [frame(t) for t in ts_gt]
