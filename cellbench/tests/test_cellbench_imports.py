"""Nothing under cellbench/ imports JAX or the JAX package, compared by
the whole top-level name (the port's name begins with the JAX
package's), and the references import nothing of the port."""

import ast
import os

from cellbench.harness import manifest
from cellbench.harness.core import banned_modules

JAX = {"jax", "jaxlib", "flax", "mmlspark_tpu"}


def _imports(path: str) -> set:
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            names.add(node.module.split(".")[0])
    return names


def _sources(sub: str = ""):
    top = os.path.join(manifest.HERE, sub)
    for dirpath, _dirs, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_jax_anywhere():
    found = {p: _imports(p) & JAX for p in _sources()}
    assert not {p: n for p, n in found.items() if n}


def test_references_import_nothing_of_the_port():
    for path in _sources("reference"):
        names = _imports(path)
        assert "mmlspark_tpu_torch" not in names, path
        assert names <= {"__future__", "contextlib", "math", "typing",
                         "torch", "numpy", "cellbench"}, (path, names)


def test_banned_modules_compares_whole_top_level_names():
    assert banned_modules(["mmlspark_tpu_torch", "mmlspark_tpu_torch.ops",
                           "jaxtyping", "flaxen"]) == []
    assert banned_modules(["jax.numpy", "mmlspark_tpu.core", "flax",
                           "jaxlib"]) == ["flax", "jax.numpy", "jaxlib",
                                          "mmlspark_tpu.core"]
