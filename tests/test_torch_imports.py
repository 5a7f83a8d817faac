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


# what the mesh and pipeline tests' gloo ranks import: they must start
# without JAX
WORLD_FILES = ("tests/torch_world.py", "tests/torch_mesh_cases.py",
               "tests/torch_pipeline_cases.py")
MESH_MODULES = ("ray_tpu_torch.parallel.mesh",
                "ray_tpu_torch.parallel.sharding",
                "ray_tpu_torch.parallel.pipeline",
                "ray_tpu_torch.ops.ring_attention",
                "ray_tpu_torch.ops.dispatch", "ray_tpu_torch.models.axes",
                "ray_tpu_torch.train.config", "ray_tpu_torch.train.mpmd",
                "ray_tpu_torch.train.sharded_checkpoint",
                "ray_tpu_torch.util.storage")


def test_mesh_worlds_import_no_jax():
    bad = [f"{f}: {name}" for f in WORLD_FILES
           for name in _imports(ROOT / f)
           if name.split(".")[0] in FORBIDDEN[:4]
           or name.startswith("ray_tpu.")]
    assert not bad, bad


def test_every_module_imports_without_jax():
    """Import the whole package (the mesh modules by name) and the world
    helpers in a fresh interpreter: none of them pulls in JAX or the JAX
    package."""
    import subprocess
    import sys
    mods = sorted(".".join(p.relative_to(ROOT).with_suffix("").parts)
                  for p in (ROOT / "ray_tpu_torch").rglob("*.py")
                  if p.name != "__init__.py")
    assert set(MESH_MODULES) <= set(mods)
    mods += [f[:-3].replace("/", ".") for f in WORLD_FILES]
    code = (f"import importlib, sys\n"
            f"for m in {mods!r}:\n"
            f"    importlib.import_module(m)\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            f"print(bad)\nsys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
