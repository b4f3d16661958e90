#!/usr/bin/env python3
"""Whether the random stress model turns on float rounding, in each package alone.

    JAX_PLATFORMS=cpu python3 scripts/torch_stress_chaos.py [--npoints 1024] [--scale 1 32]

Builds ``tests/test_torch_stress.py``'s eval forward (``stress_model_config``
at ``--npoints``, the same clouds and perturbed JAX variables from numpy seed
0, exact kNN mode) and, for each divisor in ``--scale`` of the PointConv
aggregation Dense kernels (flax name ``linear``; the test divides by 32),
prints the largest |output| and the largest difference of

- JAX against JAX with every input coordinate moved by one ulp (up);
- the port against the port under the same move;
- the port against JAX on the same inputs, which the test holds at 1e-4.

Where the first two move the output as far as the last, the gap between the
packages is the model's own sensitivity to rounding, not a fault of either.
CPU only, about a minute at 1024 points.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--npoints", type=int, default=1024)
    ap.add_argument("--scale", type=float, nargs="+", default=[1.0, 32.0])
    args = ap.parse_args()

    import jax
    import torch

    from mocopci_tpu import config as jax_config
    from mocopci_tpu.models import MoCoPCI as JaxMoCoPCI
    from mocopci_torch import MoCoPCI, interpolate, stress_model_config
    from mocopci_torch.bridge import params_from_jax
    from tests.torch_parity import init_jax, knn_mode

    n = args.npoints
    rng = np.random.default_rng(0)
    x1 = rng.normal(size=(1, n, 3)).astype(np.float32)
    x2 = (x1 + 0.05 * rng.normal(size=x1.shape)).astype(np.float32)
    up1, up2 = (np.nextafter(x, np.float32(np.inf)) for x in (x1, x2))
    jm = JaxMoCoPCI(jax_config.stress_model_config(n))
    fwd = jax.jit(lambda v, a, b: jm.apply(v, a, b, train=False)["out"])
    with knn_mode("exact"):
        base = init_jax(jm, rng, x1, x2)
        for div in args.scale:
            def scaled(path, leaf):
                keys = [getattr(p, "key", "") for p in path]
                return leaf / div if keys[-2:] == ["linear", "kernel"] else leaf
            variables = jax.tree_util.tree_map_with_path(scaled, base)
            jax_out = np.asarray(fwd(variables, x1, x2))
            jax_up = np.asarray(fwd(variables, up1, up2))
            model = MoCoPCI(stress_model_config(n), device="cpu")
            model.load_state_dict(params_from_jax(variables), strict=True)
            port = interpolate(model, x1, x2).numpy()
            port_up = interpolate(model, up1, up2).numpy()
            print(f"Dense kernels / {div:g}: largest |output| JAX {np.abs(jax_out).max():.6g}, "
                  f"port {np.abs(port).max():.6g}", flush=True)
            for what, a, b in (("JAX against JAX, inputs up one ulp", jax_out, jax_up),
                               ("port against port, inputs up one ulp", port, port_up),
                               ("port against JAX", port, jax_out)):
                d = np.abs(a.astype(np.float64) - b)
                print(f"  {what}: largest difference {d.max():.6g}, "
                      f"{int((d > 1e-4).sum())} of {d.size} entries past 1e-4", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
