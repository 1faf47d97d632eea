"""The port's layering, read from its sources: the capture-and-replay layer
(``ops/graph.py``) sits beneath every entry point, and the ops and the
sharded functions do not reach up into the entry module.

* No module under ``fraytracer_tpu_torch/ops/`` imports ``render``
  (``from ..render import ...``, ``import ...render``), and no module
  under ``parallel/`` imports a private name of it: the sharded entry
  points take the frame's public config and ray-grid frame, as the JAX
  package's ``parallel/mesh.py`` takes ``RenderConfig``.
* ``_FrameGraph`` is constructed only in ``ops/graph.py``.
* The modules the graph layer joins (``render.py``, ``ops/graph.py``,
  ``ops/wavefront.py``, ``parallel/mesh.py``) import nothing inside a
  function.

Imports only the standard library: it runs where JAX and torch are not
installed.
"""
import ast
from pathlib import Path

import pytest

PACKAGE = Path(__file__).resolve().parents[1] / "fraytracer_tpu_torch"


def sources(*parts):
    root = PACKAGE.joinpath(*parts)
    return sorted(root.rglob("*.py")) if root.is_dir() else [root]


def tree(path):
    return ast.parse(path.read_text(), filename=str(path))


RENDER = "fraytracer_tpu_torch.render"


def from_render(path):
    """The names ``path`` imports from ``render`` (``"*"``: the module
    itself), at any depth of its code."""
    pkg = path.relative_to(PACKAGE.parent).with_suffix("").parts[:-1]
    out = []
    for node in ast.walk(tree(path)):
        if isinstance(node, ast.Import):
            out += ["*" for a in node.names if a.name == RENDER]
        elif isinstance(node, ast.ImportFrom):
            base = list(pkg[:len(pkg) - node.level + 1]) if node.level \
                else []
            mod = ".".join(base + ([node.module] if node.module else []))
            if mod == RENDER:
                out += [a.name for a in node.names]
            # ``from .. import render``
            out += ["*" for a in node.names if f"{mod}.{a.name}" == RENDER]
    return out


def test_no_ops_module_imports_render():
    for path in sources("ops"):
        assert not from_render(path), path


def test_no_parallel_module_imports_a_private_name_of_render():
    seen = {}
    for path in sources("parallel"):
        names = from_render(path)
        assert not [n for n in names if n == "*" or n.startswith("_")], \
            (path, names)
        seen[path.name] = names
    assert seen["mesh.py"], "the layer test reads no import of mesh.py"


def test_frame_graphs_are_made_only_in_the_graph_layer():
    makers = set()
    for path in sources():
        for node in ast.walk(tree(path)):
            if isinstance(node, ast.Call) and (
                    getattr(node.func, "id", None) == "_FrameGraph"
                    or getattr(node.func, "attr", None) == "_FrameGraph"):
                makers.add(path.relative_to(PACKAGE).as_posix())
    assert makers == {"ops/graph.py"}


@pytest.mark.parametrize("name", ["render.py", "ops/graph.py",
                                  "ops/wavefront.py", "parallel/mesh.py"])
def test_no_function_local_imports(name):
    path = PACKAGE / name
    for fn in ast.walk(tree(path)):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            local = [n.lineno for n in ast.walk(fn)
                     if isinstance(n, (ast.Import, ast.ImportFrom))]
            assert not local, (name, fn.name, local)
