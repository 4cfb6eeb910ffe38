"""The PyTorch port stands alone: importing any of its modules (or
chip_smoke.py, which drives it on the card) pulls in neither jax nor
openobj_tpu, nor OpenCV, scikit-learn, networkx, PyYAML, PIL or transformers,
which the card's machine does not have (the image readers, the loaders, the
scene-level scale-out, the multi-scene runner, the dataset preflight and
chip_smoke.py do not import PIL even lazily); neither do the modules that
parallel.sharding and the sharded snapshot import at first use. networkx may be imported only inside
perception/graph.py's branch for the non-default Greedy/GNewman methods, and
transformers only in the constructors of perception/encoders.py's
transformers-based encoders. No module imports PyYAML, not even lazily: the
port reads its YAML files with utils.yaml_subset. The package's lazy
top-level names resolve to their modules' objects without jax."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

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
        "sys.modules['yaml'] = None\n"
        "sys.modules['PIL'] = None\n"
        "sys.modules['transformers'] = None\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        # what parallel.sharding and the sharded snapshot import at first use
        "for name in ('torch.distributed.checkpoint', 'torch.distributed.tensor',\n"
        "             'torch.distributed.device_mesh'):\n"
        "    importlib.import_module(name)\n"
        "from openobj_torch.core.checkpoint import (load_scene_sharded, load_state_sharded,\n"
        "                                           save_scene_sharded, save_state_sharded)\n"
        "from openobj_torch.parallel.sharding import (make_mesh, make_mesh_2d, maybe_constrain,\n"
        "                                             object_sharding, replicated, shard_scene)\n"
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


PERCEPTION = ("openobj_torch.perception", "openobj_torch.scripts.perception_matrix")
# modules that read images or drive whole scenes: no PIL either
NO_PIL = PERCEPTION + ("openobj_torch.utils.jpeg", "openobj_torch.utils.png",
                       "openobj_torch.data", "openobj_torch.native", "openobj_torch.parallel",
                       "openobj_torch.scripts.run_scenes", "openobj_torch.scripts.check_dataset",
                       "chip_smoke")


def _in_hf_constructor(node, parents) -> bool:
    """Whether ``node`` lies inside a ``__post_init__`` (the constructors of
    perception/encoders.py's transformers-based encoders)."""
    while node in parents:
        node = parents[node]
        if isinstance(node, ast.FunctionDef) and node.name == "__post_init__":
            return True
    return False


LAZY = {
    "SceneMapper": "openobj_torch.core.scene", "Camera": "openobj_torch.core.scene",
    "TrainConfig": "openobj_torch.core.trainer", "load_scene_config": "openobj_torch.config",
    "make_mapper": "openobj_torch.config", "associate": "openobj_torch.perception.pipeline",
    "AssociationConfig": "openobj_torch.perception.pipeline",
    "GraphSegmenter": "openobj_torch.perception.segmentation",
    "OnlineInstanceTracker": "openobj_torch.perception.tracking",
    "import_torch_checkpoint": "openobj_torch.interop",
    "export_torch_checkpoint": "openobj_torch.interop",
}


def test_lazy_top_level_names_without_jax():
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['openobj_tpu'] = None\n"
        "import openobj_torch\n"
        f"for name, mod in {LAZY!r}.items():\n"
        "    assert getattr(openobj_torch, name) is getattr(importlib.import_module(mod), name)\n"
        "import openobj_torch.interop as interop\n"
        "assert openobj_torch.import_torch_checkpoint is interop.import_torch_checkpoint\n"
        "assert openobj_torch.export_torch_checkpoint is interop.export_torch_checkpoint\n"
        "try:\n"
        "    openobj_torch.no_such_name\n"
        "except AttributeError:\n"
        "    pass\n"
        "import openobj_torch.core as c, openobj_torch.perception as p\n"
        "assert c.scene and c.trainer and p.encoders and p.partfeat\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


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
                               "sklearn", "yaml"), f"{name} imports {m}"
            # the perception modules use none of these, not even lazily (the
            # import check above holds the rest of the package at import)
            if name.startswith(NO_PIL):
                assert top != "PIL", f"{name} imports {m}"
            if top == "transformers":
                assert name == "openobj_torch.perception.encoders" and \
                    _in_hf_constructor(node, parents), f"{name} imports {m}"
            if top == "networkx":
                assert name == "openobj_torch.perception.graph" and \
                    _in_networkx_branch(node, parents), f"{name} imports {m}"
