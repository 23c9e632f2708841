"""The port's copy of the Nalar runtime (``repro_torch/core/``) is the JAX
package's ``repro/core/``, statement for statement.

``repro/core/`` imports no JAX, but the port imports nothing of ``repro``,
so it keeps its own copy.  Every module of the copy must parse to the same
syntax tree as its source once docstrings are set aside (they name the
package); comments are not part of the tree.  Both directories must hold
the same modules.
"""

import ast
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
REF, PORT = SRC / "repro" / "core", SRC / "repro_torch" / "core"
MODULES = sorted(p.name for p in REF.glob("*.py"))


def _tree_without_docstrings(path: Path) -> str:
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree, include_attributes=False)


def test_the_copy_has_every_module_and_no_other():
    assert len(MODULES) == 16
    assert sorted(p.name for p in PORT.glob("*.py")) == MODULES


@pytest.mark.parametrize("name", MODULES)
def test_module_is_the_reference_verbatim(name):
    assert (_tree_without_docstrings(PORT / name)
            == _tree_without_docstrings(REF / name)), name
