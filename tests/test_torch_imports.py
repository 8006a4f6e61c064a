"""The port never imports JAX nor anything of the reference package:
an AST scan of every module of src/repro_torch/ and of chip_smoke.py
(imports at any depth, including importlib calls), and a fresh
interpreter that imports every port module and finds no `jax`,
`jaxlib` or `repro` in sys.modules afterwards."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "repro"}
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules():
    out = []
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(ROOT / "src").with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def _imported_names(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.lineno, node.module
        elif isinstance(node, ast.Call):
            f = node.func
            name = (f.attr if isinstance(f, ast.Attribute)
                    else getattr(f, "id", ""))
            if name in ("import_module", "__import__") and node.args \
                    and isinstance(node.args[0], ast.Constant):
                yield node.lineno, str(node.args[0].value)


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_forbidden_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(line, name) for line, name in _imported_names(tree)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_every_port_module_imports_without_jax_or_repro():
    mods = _modules() + ["chip_smoke"]
    code = (
        "import importlib, json, sys\n"
        f"bad = {sorted(FORBIDDEN)!r}\n"
        "out = {}\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "    out[m] = sorted(k for k in sys.modules\n"
        "                    if k.split('.')[0] in bad)\n"
        "print(json.dumps(out))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300,
                       cwd=str(ROOT))
    assert r.returncode == 0, r.stderr[-3000:]
    loaded = json.loads(r.stdout.strip().splitlines()[-1])
    assert set(loaded) == set(mods)
    assert all(v == [] for v in loaded.values()), loaded
    assert len(mods) >= 20
    assert {"repro_torch.launch.dryrun", "repro_torch.quant.abstract",
            "repro_torch.roofline.analysis", "repro_torch.roofline.op_profile",
            "repro_torch.kernels.work", "repro_torch.dist.context",
            "repro_torch.dist.sharding", "repro_torch.launch.mesh"} \
        <= set(mods)


def test_scan_catches_a_forbidden_import():
    """The AST scan itself fires on the forms it is meant to catch."""
    src = ("import jax.numpy as jnp\nfrom repro.hw import WORD\n"
           "def f():\n    import importlib\n"
           "    importlib.import_module('repro.kernels')\n")
    names = [n for _, n in _imported_names(ast.parse(src))]
    assert {"jax.numpy", "repro.hw", "repro.kernels"} <= set(names)
    assert not any(n.split(".")[0] in FORBIDDEN
                   for _, n in _imported_names(ast.parse(
                       "import repro_torch\nfrom repro_torch import hw\n")))
