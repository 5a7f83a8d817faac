"""The compiled DAG and channels, client mode and Tune exist in the port
as in the JAX package: every module of ``ray_tpu/{dag,experimental,client,
tune}`` has its namesake under ``ray_tpu_torch/`` exporting the same
public names; importing them loads neither torch nor JAX (a client, a
Tune driver and the node manager's channel handlers need neither); and
no module of the port still refuses the DAG or client mode (no file
names their ROADMAP items)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PACKAGES = ("dag", "experimental", "client", "tune")


def _public(path):
    """__all__ where a module has one, else its top-level public defs."""
    tree = ast.parse(path.read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets):
            return sorted(ast.literal_eval(node.value))
    return sorted(n.name for n in tree.body
                  if isinstance(n, (ast.FunctionDef, ast.ClassDef))
                  and not n.name.startswith("_"))


@pytest.mark.parametrize("package", PACKAGES)
def test_modules_mirror_the_jax_package(package):
    jax_files = sorted((ROOT / "ray_tpu" / package).glob("*.py"))
    port_files = sorted((ROOT / "ray_tpu_torch" / package).glob("*.py"))
    assert [p.name for p in jax_files] == [p.name for p in port_files]
    for j, p in zip(jax_files, port_files):
        assert set(_public(p)) >= set(_public(j)), p


def test_native_channel_sources_are_the_port_s_own():
    """The channel's C++ is the port's copy (built by the port's
    native/build.py into ray_tpu_torch/_build/native/)."""
    from ray_tpu_torch.native import build
    assert build._SOURCES["mutable_channel"] == ["mutable_channel.cpp"]
    assert build.lib_path("mutable_channel").startswith(
        str(ROOT / "ray_tpu_torch" / "_build" / "native"))
    for name in ("mutable_channel.cpp", "mutable_channel_selftest.cpp"):
        assert (ROOT / "ray_tpu_torch" / "native" / name).is_file()


def test_import_loads_no_torch_and_no_jax():
    mods = [f"ray_tpu_torch.{p}" for p in PACKAGES] + [
        f"ray_tpu_torch.{pkg}.{f.stem}" for pkg in PACKAGES
        for f in (ROOT / "ray_tpu_torch" / pkg).glob("*.py")
        if f.stem != "__init__"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'flax', 'optax', 'ray_tpu')]\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("item", ["A3e", "A3f"])
def test_no_stub_names_the_ported_items(item):
    hits = [f"{f.relative_to(ROOT)}:{i}"
            for f in sorted((ROOT / "ray_tpu_torch").rglob("*.py"))
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if item in line]
    assert not hits, hits


def test_bind_builds_a_dag_node_without_a_runtime():
    """``.bind`` on an actor method captures a ClassMethodNode (no call
    is made until the DAG is compiled)."""
    from ray_tpu_torch.actor import ActorHandle
    from ray_tpu_torch.dag import ClassMethodNode, InputNode
    handle = ActorHandle("0" * 32, ["f"])
    with InputNode() as inp:
        node = handle.f.bind(inp, k=1)
    assert isinstance(node, ClassMethodNode)
    assert node.method_name == "f" and node._upstream() == [inp]
