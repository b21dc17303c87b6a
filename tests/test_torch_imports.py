"""Import guard: every module of the port, and chip_smoke.py, imports only
the standard library, torch, numpy, scipy, einops and triton (and itself).
The card's machine has nothing else: no JAX, no JAX package, none of the
JAX server's packages (aiohttp, msgpack, pydantic, safetensors,
transformers). The one exception is `HFTokenizer`'s lazy `transformers`
import, which only a checkpoint with tokenizer files reaches. Every import
statement counts, those inside functions too."""

import ast
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "fish_speech_tpu_torch"
ALLOWED = {"torch", "numpy", "scipy", "einops", "triton",
           "fish_speech_tpu_torch"}
# (file relative to the repo, enclosing class or function) -> module
EXCEPTIONS = {("fish_speech_tpu_torch/text/tokenizer.py", "HFTokenizer"):
              "transformers"}
FILES = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(tree: ast.AST):
    """(top-level module, enclosing class/function names) of every
    absolute import."""
    def walk(node, scope):
        for child in ast.iter_child_nodes(node):
            inner = scope
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                inner = scope + (child.name,)
            if isinstance(child, ast.Import):
                for a in child.names:
                    yield a.name.split(".")[0], inner
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                yield child.module.split(".")[0], inner
            yield from walk(child, inner)

    yield from walk(tree, ())


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_imports_only_what_the_card_has(path):
    rel = str(path.relative_to(ROOT))
    bad = []
    for mod, scope in _imports(ast.parse(path.read_text(), rel)):
        if mod in ALLOWED or mod in sys.stdlib_module_names:
            continue
        if any(EXCEPTIONS.get((rel, s)) == mod for s in scope):
            continue
        bad.append(f"{mod} (in {'.'.join(scope) or 'module scope'})")
    assert not bad, f"{rel} imports {bad}"


def test_guard_sees_every_kind_of_import():
    """The walk finds imports at module scope, inside functions and
    classes, and `from` imports; relative imports are the package's."""
    src = ("import jax\nfrom fish_speech_tpu.x import y\nfrom . import z\n"
           "def f():\n    import msgpack\nclass C:\n    def g(self):\n"
           "        from pydantic import BaseModel\n")
    found = list(_imports(ast.parse(src)))
    assert found == [("jax", ()), ("fish_speech_tpu", ()),
                     ("msgpack", ("f",)), ("pydantic", ("C", "g"))]
    assert "fish_speech_tpu" not in ALLOWED
