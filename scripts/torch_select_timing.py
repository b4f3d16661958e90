#!/usr/bin/env python3
"""Exact k-smallest selection on one NVIDIA GPU: one ``select_min_k`` launch
over the whole row against the 1024-column chunk merge that the JAX package
uses because ``lax.top_k`` sorts the full row (per-chunk k least, then the k
least of the survivors).

    python3 scripts/torch_select_timing.py      # from the repository root

Shapes: 512 query rows (what ``_select_blocked`` hands to the exact
selection at 131072 references) of 16384 (one reference chunk) to 131072
references (the dense route); k = 32.  Both routes must return the same indices.
Prints the card's name and power limit, then one JSON line of median ms
(CUDA events, 20 runs).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def median_ms(fn, reps=20) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def chunk_merge(select_min_k, d: torch.Tensor, k: int) -> torch.Tensor:
    """Each 1024-column chunk's k least, then the k least of the survivors."""
    nc = d.shape[-1] // 1024
    dc = d.reshape(d.shape[:-1] + (nc, 1024))
    i = select_min_k(dc, None, k)
    v = dc.gather(-1, i.long()).flatten(-2)
    base = torch.arange(nc, dtype=torch.int32, device=d.device)[:, None] * 1024
    return select_min_k(v, (i + base).flatten(-2), k)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from mocopci_torch.kernels import select_min_k
    from mocopci_torch.ops.distance import square_distance

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    k, out = 32, {}
    for M in (16384, 32768, 65536, 131072):
        ref = torch.randn(1, M, 3, generator=gen, device=dev) * 20.0
        query = torch.randn(1, 512, 3, generator=gen, device=dev) * 20.0
        d = square_distance(query, ref)
        one, merged = select_min_k(d, None, k), chunk_merge(select_min_k, d, k)
        if not torch.equal(one, merged):
            print(f"M={M}: the routes disagree", file=sys.stderr)
            return 1
        out[f"one_launch_512x{M}_ms"] = median_ms(lambda: select_min_k(d, None, k))
        out[f"chunk_merge_512x{M}_ms"] = median_ms(lambda: chunk_merge(select_min_k, d, k))
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
