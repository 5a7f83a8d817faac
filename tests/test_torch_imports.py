"""The PyTorch port stands alone: no module of ray_tpu_torch, and not
chip_smoke.py, imports JAX, flax, optax or anything of ray_tpu."""

import ast
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ray_tpu")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax_and_no_ray_tpu():
    files = sorted((ROOT / "ray_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = [f"{f.relative_to(ROOT)}: {name}" for f in files
           for name in _imports(f)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, bad
