"""The port's eval entry point held against the JAX package on the CPU, in the
default approx kNN mode: the tiny whole forward, the eval metrics, the
NL-Drive loader and the eval CLI."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from mocopci_tpu import ops as jops
from mocopci_tpu.data import NLDriveDataset as JaxNLDrive
from mocopci_tpu.data import batches as jax_batches
from mocopci_torch import MoCoPCI, interpolate, tiny_model_config
from mocopci_torch.bridge import params_from_jax
from mocopci_torch.data import NLDriveDataset, batches
from mocopci_torch.training import eval_step
from tests.torch_parity import approx_knn, tiny_model_variables  # noqa: F401  (fixture)

ROOT = Path(__file__).resolve().parents[1]
NPOINTS = 128


@pytest.fixture(scope="module")
def tiny():
    """Port and JAX tiny models with the same weights, and the JAX output."""
    jm, x1, x2, variables = tiny_model_variables(NPOINTS)
    want = np.asarray(jax.jit(lambda v, a, b: jm.apply(v, a, b, train=False)["out"])(
        variables, x1, x2))
    model = MoCoPCI(tiny_model_config(NPOINTS), device="cpu")
    model.load_state_dict(params_from_jax(variables), strict=True)
    return model, x1, x2, want


def test_tiny_forward_approx_mode_matches_jax(tiny):
    """At M <= 1024 only the key quantisation separates approx from exact
    selection, so the outputs agree as in exact mode."""
    model, x1, x2, want = tiny
    got = interpolate(model, x1, x2).numpy()
    assert got.shape == (1, 3, NPOINTS, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_eval_step_metrics_match_jax(tiny):
    """eval_step's CD and EMD against the JAX metrics of the same output; CD
    rtol 3e-3 (chamfer_pair's packed keys against JAX's dense CPU path)."""
    model, x1, x2, _ = tiny
    rng = np.random.default_rng(1)
    out = interpolate(model, x1, x2).numpy()
    gt = (out + 0.2 * rng.normal(size=out.shape)).astype(np.float32)
    m = eval_step(model, {"pc1": x1, "pc2": x2, "gt": gt})
    B, F, N, _ = out.shape
    cd = np.asarray(jops.chamfer_distance_per_sample(
        out.reshape(B * F, N, 3), gt.reshape(B * F, N, 3))).reshape(B, F)
    for j in range(F):
        np.testing.assert_allclose(m[f"cd_{j}"].numpy(), cd[:, j], rtol=3e-3)
        want = np.asarray(jops.earth_mover_distance_auto(out[:, j], gt[:, j])) / N
        np.testing.assert_allclose(m[f"emd_{j}"].numpy(), want, rtol=1e-4)
    assert sorted(eval_step(model, {"pc1": x1, "pc2": x2, "gt": gt}, False)) == [
        "cd_0", "cd_1", "cd_2"]


def _write_scenes(root: Path, rng) -> Path:
    """Two scene rows of 7 .bin files; some clouds smaller than the sample."""
    rows = []
    for s in range(2):
        names = []
        for f in range(7):
            name = f"scene{s}/{f:06d}.bin"
            (root / name).parent.mkdir(parents=True, exist_ok=True)
            n = int(rng.integers(40, 100))
            rng.normal(size=(n, 3)).astype(np.float32).tofile(root / name)
            names.append(name)
        rows.append(" ".join(names))
    scene_list = root / "scenes.txt"
    scene_list.write_text("\n".join(rows) + "\n")
    return scene_list


def test_nldrive_loader_matches_jax(tmp_path):
    scene_list = _write_scenes(tmp_path, np.random.default_rng(2))
    args = (str(tmp_path), str(scene_list), 64, 4, 4)
    ours, theirs = NLDriveDataset(*args, seed=3), JaxNLDrive(*args, seed=3, use_native=False)
    assert len(ours) == len(theirs) == 2
    for i in (1, 0):
        for a, b in zip(sum(ours[i], []), sum(theirs[i], [])):
            assert a.dtype == np.float32 and a.shape == (64, 3)
            np.testing.assert_array_equal(a, b)
    got = list(batches(NLDriveDataset(*args, seed=4), 2, shuffle=True, seed=5))
    want = list(jax_batches(JaxNLDrive(*args, seed=4, use_native=False), 2, shuffle=True,
                            seed=5))
    assert len(got) == len(want) == 1
    assert got[0]["gt"].shape == (2, 3, 64, 3)
    for key in ("pc1", "pc2", "gt"):
        np.testing.assert_array_equal(got[0][key], want[0][key])


def _jax_cli_keys():
    """The final JSON keys of the JAX package's eval CLI, read from its source."""
    src = (ROOT / "mocopci_tpu" / "cli" / "test.py").read_text()
    keys = set()
    for key in re.findall(r'result\[f?"([^"]+)"\] =', src):
        keys |= {key.replace("{j + 1}", str(j + 1)) for j in range(3)}
    return keys


def test_eval_cli_on_cpu():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "mocopci_torch.cli.test", "--synthetic", "2", "--tiny",
         "--npoints", str(NPOINTS), "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = res.stdout.strip().splitlines()
    assert "Average: Mean chamfer distance: " in res.stdout
    result = json.loads(lines[-1])
    assert set(result) == _jax_cli_keys() and len(result) == 14
    assert result["n_samples"] == 2
    assert all(np.isfinite(v) for v in result.values())
    assert result["cd_mean"] == pytest.approx(
        np.mean([result[f"cd_frame{j}"] for j in (1, 2, 3)]))
