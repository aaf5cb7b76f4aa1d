"""The port and ``chip_smoke.py`` import neither ``jax`` nor ``repro``."""
import ast
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert res.returncode == 0, res.stderr
    mods = json.loads(res.stdout.strip().splitlines()[-1])
    assert {"repro_torch.kernels.sig_trunc", "repro_torch.kernels.sig_words",
            "repro_torch.kernels.sig_gram", "repro_torch.core.projection",
            "repro_torch.core.logsignature", "repro_torch.sigkernel.gram",
            "repro_torch.sigkernel.mmd", "repro_torch.sigkernel.krr",
            "repro_torch.sigkernel.features",
            "repro_torch.serve.engine", "repro_torch.kernels.sig_sweep",
            "repro_torch.data.pipeline"} <= set(mods)
    bad = [m for m in mods if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT).as_posix()
     for p in (ROOT / "src" / "repro_torch").rglob("*.py")]
    + ["chip_smoke.py", "examples/hurst_fbm_torch.py"]))
def test_source_imports_no_jax(path):
    bad = _imported_roots(ROOT / path) & set(FORBIDDEN)
    assert not bad, (path, bad)


def test_every_port_module_is_walked():
    import repro_torch
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    assert {"repro_torch.kernels.ops", "repro_torch.serve.batcher",
            "repro_torch.convert", "repro_torch.kernels.sig_words",
            "repro_torch.core.projection", "repro_torch.core.logsignature",
            "repro_torch.core.transforms", "repro_torch.kernels.sig_gram",
            "repro_torch.sigkernel", "repro_torch.sigkernel.gram",
            "repro_torch.sigkernel.mmd", "repro_torch.sigkernel.krr",
            "repro_torch.sigkernel.features",
            "repro_torch.serve.engine"} <= names
