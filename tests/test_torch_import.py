"""The PyTorch port stands alone: importing any of its modules (or
chip_smoke.py, which drives it on the card) pulls in neither jax nor
openobj_tpu, nor OpenCV, scikit-learn or networkx, which the card's machine
does not have. networkx may be imported only inside perception/graph.py's
branch for the non-default Greedy/GNewman methods."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "openobj_torch"


def _modules():
    for path in [*sorted(PKG.rglob("*.py")), ROOT / "chip_smoke.py"]:
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts), path


def test_import_without_jax():
    names = [name for name, _ in _modules()]
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['openobj_tpu'] = None\n"
        "sys.modules['cv2'] = None\n"
        "sys.modules['sklearn'] = None\n"
        "sys.modules['networkx'] = None\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if sys.modules[m] is not None\n"
        "       and (m == 'jax' or m.startswith(('jax.', 'openobj_tpu')))]\n"
        "assert not bad, bad\n"
        f"print('ok', {len(names)})\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def _in_networkx_branch(node, parents) -> bool:
    """Whether ``node`` lies inside an ``if`` whose test names both
    non-default graph methods (perception/graph.py's Greedy/GNewman branch)."""
    while node in parents:
        node = parents[node]
        if isinstance(node, ast.If):
            test = ast.unparse(node.test)
            if "'Greedy'" in test and "'GNewman'" in test:
                return True
    return False


@pytest.mark.parametrize("name,path", list(_modules()), ids=lambda x: str(x))
def test_no_forbidden_imports(name, path):
    tree = ast.parse(path.read_text(), filename=str(path))
    parents = {c: p for p in ast.walk(tree) for c in ast.iter_child_nodes(p)}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""]
        else:
            continue
        for m in mods:
            top = m.split(".")[0]
            assert top not in ("jax", "jaxlib", "openobj_tpu", "flax", "optax", "cv2",
                               "sklearn"), f"{name} imports {m}"
            if top == "networkx":
                assert name == "openobj_torch.perception.graph" and \
                    _in_networkx_branch(node, parents), f"{name} imports {m}"
