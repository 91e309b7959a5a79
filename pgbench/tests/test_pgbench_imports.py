"""Nothing under pgbench/ imports JAX or the JAX package, and the plain
reference imports nothing of the program: an AST walk over every module,
comparing each import's top-level name (before the first dot) whole."""
import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "mitsuba_path_guiding_tpu"}
PROGRAM = "mitsuba_path_guiding_torch"


def _modules(sub=""):
    root = os.path.join(HERE, sub)
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imported(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(_modules()), ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax(path):
    assert not _imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(_modules("reference")),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_reference_imports_nothing_of_the_program(path):
    names = _imported(path)
    assert PROGRAM not in names
    assert names <= {"math", "numpy", "torch"}


def test_top_level_names_compare_whole():
    # the port's name begins with the JAX package's: a prefix test would
    # confuse them
    assert not {"mitsuba_path_guiding_torch"} & FORBIDDEN
    assert "mitsuba_path_guiding_torch".startswith("mitsuba_path_guiding_t")
