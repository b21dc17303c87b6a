"""Import guard: every module of the port, and chip_smoke.py, imports only
the standard library, torch, numpy, scipy, einops and triton (and itself).
The card's machine has nothing else: no JAX, no JAX package, none of the
JAX server's packages (aiohttp, msgpack, pydantic, safetensors,
transformers). The exceptions are lazy imports that only an optional
path reaches: `HFTokenizer`'s `transformers` (a checkpoint with tokenizer
files) and the API client's `pyaudio` (the first backend `--play` tries, any
failure falling through to the next). Every import statement counts, those
inside functions too."""

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
              "transformers",
              ("fish_speech_tpu_torch/tools/api_client.py", "LivePlayer"):
              "pyaudio"}
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


TRAINING_MODULES = (
    "models/dual_ar.py", "train/step.py", "train/lora.py",
    "train/scheduler.py", "data/protos.py", "data/stream.py",
    "data/braceexpand.py", "data/semantic.py", "utils/file.py",
    "tools/train.py", "tools/build_dataset.py",
    "tools/create_train_split.py", "tools/merge_lora.py")


def test_guard_covers_the_training_path():
    """The training modules are among the guarded files, and the JAX
    training path's imports (optax, google.protobuf) are not allowed."""
    guarded = {str(p.relative_to(PACKAGE)) for p in FILES
               if PACKAGE in p.parents}
    assert set(TRAINING_MODULES) <= guarded
    assert not {"optax", "google", "jax", "flax"} & ALLOWED
    src = "import optax\nfrom google.protobuf import message\n"
    assert [m for m, _ in _imports(ast.parse(src))] == ["optax", "google"]


PARALLEL_MODULES = ("parallel/__init__.py", "parallel/mesh.py",
                    "parallel/tp.py", "parallel/collectives.py",
                    "serve/multihost.py")


def test_guard_covers_the_parallel_slice():
    """The parallel modules (the mesh, the TP wrappers, the collectives,
    the multihost plans) are among the guarded files; what they need of
    torch.distributed, gloo included, is there: the card's machine runs
    them on the torch it has, nothing else."""
    import torch.distributed as dist

    guarded = {str(p.relative_to(PACKAGE)) for p in FILES
               if PACKAGE in p.parents}
    assert set(PARALLEL_MODULES) <= guarded
    assert dist.is_available() and dist.is_gloo_available()


TOOLS_MODULES = (
    "ops/quant.py", "utils/spectrogram.py", "utils/profiling.py",
    "utils/logger.py", "data/vqgan.py", "i18n/__init__.py", "i18n/core.py",
    "i18n/scan.py", "tools/quantize.py", "tools/quant_drift.py",
    "tools/eval_quality.py", "tools/latency_bench.py",
    "tools/profile_decode.py", "tools/extract_vq.py", "tools/api_client.py",
    "tools/eval_in_context.py")


def test_guard_covers_the_tools_slice():
    """The remaining tools and the utilities they need are among the
    guarded files, and none of them imports at module scope what the
    exceptions allow inside a function (pyaudio) or the test harness."""
    guarded = {str(p.relative_to(PACKAGE)) for p in FILES
               if PACKAGE in p.parents}
    assert set(TOOLS_MODULES) <= guarded
    for rel in TOOLS_MODULES:
        tree = ast.parse((PACKAGE / rel).read_text())
        top = {m for m, scope in _imports(tree) if not scope}
        assert not top & {"ref_harness", "pyaudio", "jax", "msgpack"}, rel
