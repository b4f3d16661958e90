"""Import hygiene: the PyTorch port and chip_smoke.py use nothing of JAX."""
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mocopci_tpu")


def _modules():
    pkg = ROOT / "mocopci_torch"
    for path in sorted(pkg.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_port_modules_import_without_jax():
    mods = list(_modules())
    assert "mocopci_torch.kernels.knn" in mods and len(mods) > 20
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_sources_name_no_jax_module():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|mocopci_tpu)\b", re.M)
    files = sorted((ROOT / "mocopci_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    hits = [str(p) for p in files if pat.search(p.read_text())]
    assert not hits, hits
    smoke = (ROOT / "chip_smoke.py").read_text()
    for name in FORBIDDEN:
        assert not re.search(rf"\b{name}\b", smoke), name
