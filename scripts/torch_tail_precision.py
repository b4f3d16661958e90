#!/usr/bin/env python3
"""Hold the transformer tail's backward kernel against its plain version and
against float64, on several random draws at the train step's shape.

    python3 scripts/torch_tail_precision.py [--parent TREE] [--seeds 4]

At (B, N, K, D) = (6, 2048, 16, 64), inputs drawn as ``chip_smoke.py`` draws
them (seed s), the backward's outputs (d_rows, dxq, dq and the weight and
bias gradients as one) each over max(1, |value|): the plain float32 version
against the same computation in float64 (the ReLU masks of h0 and h1 flip
where a pre-activation lies within float32 rounding of 0, and then a row's
gradient moves), and the kernel against both; with
``--parent``, another checkout's kernel (built as ``chip_smoke.py --parent``
builds it) beside, and both timed in turns by CUDA events.  Also the count
of pre-activations within 1e-6 of 0 in float64.  Prints the card's name and
power limit.  Needs a card.
"""
from __future__ import annotations

import argparse
import importlib
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("d_rows", "dxq", "dq", "dw")     # dw: the 8 weight and bias gradients together


def flat(outputs):
    """d_rows, dxq, dq, and the 8 weight and bias gradients as one flat tensor."""
    return [*outputs[:3], torch.cat([t.reshape(-1) for t in outputs[3:]])]


def gaps(got, want):
    return [float((a.double() - b.double()).abs().max()) / max(1.0, float(b.abs().max()))
            for a, b in zip(got, want)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", metavar="TREE", help="a checkout whose kernel runs beside")
    ap.add_argument("--seeds", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_tail_precision: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from mocopci_torch.kernels import _lib

    tt = importlib.import_module("mocopci_torch.kernels.transformer_tail")
    finish = chip_smoke.build_parent(args.parent) if args.parent else None
    _lib.load()
    parent = finish() if finish else None
    dev = torch.device("cuda")
    B, M, N, K, D = 6, 2048, 2048, 16, 64
    for seed in range(1, args.seeds + 1):
        g = torch.Generator(device=dev).manual_seed(seed)

        def rnd(*shape, scale=1.0):
            return torch.randn(*shape, generator=g, device=dev) * scale

        table, xq, qq, dout = rnd(B, M, 3 + 2 * D), rnd(B, N, 3), rnd(B, N, D), rnd(B, N, D)
        ws = []
        for ci, co in [(3, D), (D, D), (D, D), (D, D)]:
            ws += [rnd(ci, co, scale=ci ** -0.5), rnd(co, scale=0.1)]
        idx = torch.randint(0, M, (B, N, K), generator=g, device=dev, dtype=torch.int32)
        p32 = flat(tt.transformer_tail_bwd_plain(table, idx, xq, qq, *ws, dout))
        p64 = flat(tt.transformer_tail_bwd_plain(table.double(), idx, xq.double(), qq.double(),
                                                 *(w.double() for w in ws), dout.double()))
        got = flat(tt.transformer_tail_bwd(table, idx, xq, qq, *ws, dout))
        print(f"seed {seed}: plain float32 against float64 "
              + " ".join(f"{n} {x:.1e}" for n, x in zip(NAMES, gaps(p32, p64))), flush=True)
        print(f"  kernel against plain float32 {max(gaps(got, p32)):.2e}, against float64 "
              + " ".join(f"{n} {x:.1e}" for n, x in zip(NAMES, gaps(got, p64))), flush=True)
        if parent is not None:
            pgot = parent.transformer_tail_bwd(table, idx, xq, qq, *ws, dout)
            print(f"  parent against plain float32 {max(gaps(pgot, p32)):.2e}, against float64 "
                  + " ".join(f"{n} {x:.1e}" for n, x in zip(NAMES, gaps(pgot, p64))), flush=True)
            print("  " + chip_smoke.beside(
                lambda: parent.transformer_tail_bwd(table, idx, xq, qq, *ws, dout),
                lambda: tt.transformer_tail_bwd(table, idx, xq, qq, *ws, dout)), flush=True)
        rows = _lib.group_rows(table.double(), idx)
        h0 = (xq.double()[:, :, None] - rows[..., :3]) @ ws[0].double() + ws[1].double()
        pos = torch.relu(h0) @ ws[2].double() + ws[3].double()
        h1 = (qq.double()[:, :, None] - rows[..., 3:3 + D] + pos) @ ws[4].double() + ws[5].double()
        print(f"  pre-activations within 1e-6 of 0 (float64): h0 {int((h0.abs() < 1e-6).sum())}, "
              f"h1 {int((h1.abs() < 1e-6).sum())}", flush=True)
    print(chip_smoke.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
