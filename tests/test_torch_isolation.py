"""The port stands alone: no file of `src/repro_torch/` and not
`chip_smoke.py` imports `jax` or anything of the JAX package `repro`, and
no file of the port calls `torch.topk`, whose tie order is not the JAX
package's (`chip_smoke.py` times it as a yardstick only)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted(
    str(p.relative_to(ROOT))
    for p in (ROOT / "src" / "repro_torch").rglob("*.py")) + ["chip_smoke.py"]
BANNED = {"jax", "jaxlib", "repro"}


def _imported_modules(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr",
                          getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            yield node.args[0].value


@pytest.mark.parametrize("rel", PORT_FILES)
def test_no_jax_or_repro_imports(rel):
    tree = ast.parse((ROOT / rel).read_text(), filename=rel)
    bad = [m for m in _imported_modules(tree)
           if m.split(".")[0] in BANNED]
    assert not bad, f"{rel} imports {bad}"


@pytest.mark.parametrize("rel", [f for f in PORT_FILES
                                 if f.startswith("src/")])
def test_no_torch_topk(rel):
    tree = ast.parse((ROOT / rel).read_text(), filename=rel)
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and node.attr == "topk" and \
                isinstance(node.value, ast.Name) and node.value.id == "torch":
            pytest.fail(f"{rel}:{node.lineno} calls torch.topk")
        if isinstance(node, ast.ImportFrom) and node.module == "torch":
            assert "topk" not in {a.name for a in node.names}, rel


def test_importing_the_port_loads_no_jax():
    mods = sorted({
        "repro_torch." + ".".join(Path(f).with_suffix("").parts[2:])
        for f in PORT_FILES if f.startswith("src/")})
    mods = [m.removesuffix(".__init__") for m in mods]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """Without a card (and, alone, without the rest of the repo) the chip
    check exits non-zero and prints no result line."""
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    if alone:
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(script)], env=env, cwd=cwd,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
