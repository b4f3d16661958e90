"""NL-Drive dataset loader (the port's own copy of
``mocopci_tpu/data/nldrive.py``, numpy sampling path).

The reference contract (``data/no_norm_datasets.py:8-90``):
  - a scene-list text file whose rows hold 7 space-separated ``.bin``
    relative paths: 4 input frames + 3 ground-truth frames
    (gt paths picked as ``sample_names[3 + (i+1)·gt_intv]``, ``:57-61``);
  - each ``.bin`` is raw float32 reshaped (-1, 3);
  - clouds with >= ``num_points`` points are sampled without replacement;
    smaller clouds keep all points and pad by sampling with replacement;
  - returns ``(input=[pc1..pc4], gt=[f1..f3])`` float32 arrays, channels-last.

``batches`` prefetches host-side loading on a thread while the card works.
"""
from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np


class NLDriveDataset:
    def __init__(
        self,
        data_root: str,
        scene_list: str,
        num_points: int = 8192,
        interval: int = 4,
        num_frames: int = 4,
        seed: Optional[int] = None,
    ):
        self.data_root = data_root
        self.num_points = num_points
        self.interval = interval
        self.num_frames = num_frames
        self.rng = np.random.default_rng(seed)
        with open(scene_list) as f:
            self.rows: List[List[str]] = [
                line.strip("\n").split(" ") for line in f if line.strip()
            ]

    def __len__(self) -> int:
        return len(self.rows)

    def _load_and_sample(self, rel_path: str) -> np.ndarray:
        raw = np.fromfile(os.path.join(self.data_root, rel_path), dtype=np.float32).reshape(-1, 3)
        num = raw.shape[0]
        if num >= self.num_points:
            idx = self.rng.choice(num, self.num_points, replace=False)
        else:
            idx = np.concatenate(
                [np.arange(num), self.rng.choice(num, self.num_points - num, replace=True)]
            )
        return raw[idx].astype(np.float32)

    def __getitem__(self, index: int) -> Tuple[List[np.ndarray], List[np.ndarray]]:
        names = self.rows[index]
        inputs = [self._load_and_sample(names[i]) for i in range(self.num_frames)]
        gt_intv = (len(names) - self.num_frames) // (self.interval - 1)
        gts = [
            self._load_and_sample(names[3 + (i + 1) * gt_intv])
            for i in range(self.interval - 1)
        ]
        return inputs, gts


def batches(
    dataset,
    batch_size: int,
    shuffle: bool = True,
    drop_last: bool = True,
    seed: int = 0,
    prefetch: int = 2,
    host_slice: Optional[slice] = None,
) -> Iterator[dict]:
    """Yield numpy batches {'pc1': (B,N,3), 'pc2': (B,N,3), 'gt': (B,F,N,3)}.

    The model consumes only the middle two of the four loaded frames
    (``train.py:131`` of the reference passes ``input[1], input[2]``).

    ``host_slice`` (data parallelism, ``--multihost``): yield only this
    rank's rows of each global batch (``parallel.host_batch_slice``); the
    seeded order is the same on every rank, so each loads only its samples.
    A rank that holds no rows gets batches of 0 rows.
    """
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    n = len(order)
    limit = n - (n % batch_size) if drop_last else n
    idx_batches = [order[i : i + batch_size] for i in range(0, limit, batch_size)]
    if not idx_batches:
        return

    def make(idxs: Sequence[int]) -> dict:
        if not len(idxs):
            return {"pc1": np.zeros((0, 0, 3), np.float32),
                    "pc2": np.zeros((0, 0, 3), np.float32),
                    "gt": np.zeros((0, 0, 0, 3), np.float32)}
        pcs1, pcs2, gts = [], [], []
        for i in idxs:
            inputs, gt = dataset[int(i)]
            pcs1.append(inputs[1])
            pcs2.append(inputs[2])
            gts.append(np.stack(gt))
        return {"pc1": np.stack(pcs1), "pc2": np.stack(pcs2), "gt": np.stack(gts)}

    q: "queue.Queue" = queue.Queue(maxsize=prefetch)

    def producer():
        for idxs in idx_batches:
            q.put(make(idxs if host_slice is None else idxs[host_slice]))
        q.put(None)

    threading.Thread(target=producer, daemon=True).start()
    while True:
        item = q.get()
        if item is None:
            return
        yield item
