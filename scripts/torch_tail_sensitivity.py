#!/usr/bin/env python3
"""How far the tiny model's forward moves when the transformer tail's output moves.

    python3 scripts/torch_tail_sensitivity.py [--mode exact|approx] [--seeds 3]

Runs ``tests/test_torch_cuda.py``'s tiny forward (``tiny_model_config(4096)``,
the same clouds from numpy seed 0) on the CPU, once as it is and then with
the refine head's ``transformer_tail`` output multiplied by (1 + eps z), z
standard normal from a torch seed, for each eps in ``EPS`` and each seed; it
prints the largest difference to the unperturbed output, how many entries
differ by more than the card test's 1e-3, and where the largest sits.  A
kernel of the tail that leaves the plain version by eps (relative) can move
that test's result this far without being wrong.  CPU only, a few seconds a
forward.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

EPS = (1e-8, 3e-8, 1e-7, 1e-6)


def main() -> int:
    from mocopci_torch import MoCoPCI, interpolate, tiny_model_config
    from mocopci_torch.nn import transformer
    from mocopci_torch.ops import distance

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=("exact", "approx"), default="exact")
    ap.add_argument("--seeds", type=int, default=3)
    args = ap.parse_args()
    cfg = tiny_model_config(4096)
    rng = np.random.default_rng(0)
    x1 = (rng.normal(size=(1, cfg.npoints, 3)) * 10).astype(np.float32)
    x2 = (x1 + 0.1 * rng.normal(size=x1.shape)).astype(np.float32)
    distance.set_knn_mode(args.mode)
    model = MoCoPCI(cfg, device="cpu")
    want = interpolate(model, x1, x2)
    tail = transformer.transformer_tail
    try:
        for eps in EPS:
            for seed in range(args.seeds):
                gen = torch.Generator().manual_seed(seed)

                def perturbed(*inputs):
                    out = tail(*inputs)
                    return out * (1 + eps * torch.randn(out.shape, generator=gen))
                transformer.transformer_tail = perturbed
                d = (interpolate(model, x1, x2) - want).abs()
                where = tuple(int(i) for i in np.unravel_index(int(d.argmax()), d.shape))
                print(f"{args.mode} mode, eps {eps:.0e}, seed {seed}: largest difference "
                      f"{float(d.max()):.6e} at {where}, {int((d > 1e-3).sum())} entries past 1e-3",
                      flush=True)
    finally:
        transformer.transformer_tail = tail
    return 0


if __name__ == "__main__":
    sys.exit(main())
