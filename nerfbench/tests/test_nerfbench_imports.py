"""What the benchmark may import: never JAX or the JAX package, nowhere;
never the program, in the reference; never the repo's other scripts."""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

FOLDER = Path(__file__).resolve().parents[1]
FILES = sorted(FOLDER.rglob("*.py"))
JAX = {"jax", "jaxlib", "flax", "mipnerf360_tpu"}
REPO_SCRIPTS = {"bench", "tools", "chip_smoke", "tests"}


def _top_names(path: Path):
    """Top-level names of every module a file imports (the part before the
    first dot), and of every string handed to an import function."""
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_the_scan_sees_files():
    assert len(FILES) > 20


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(FOLDER)))
def test_no_jax_and_no_repo_scripts(path):
    names = set(_top_names(path))
    assert not names & JAX, f"{path} imports {names & JAX}"
    assert not names & REPO_SCRIPTS, f"{path} imports {names & REPO_SCRIPTS}"


@pytest.mark.parametrize("path", sorted((FOLDER / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "mipnerf360_torch" not in set(_top_names(path))


def test_whole_name_match():
    """The check compares whole top-level names: the port's name starts
    with the JAX package's and is not caught."""
    from nerfbench.harness import FORBIDDEN, forbidden_modules

    assert "mipnerf360_torch".split(".")[0] not in FORBIDDEN
    sys.modules["jax._fake_for_test"] = sys.modules[__name__]
    try:
        assert forbidden_modules() == ["jax._fake_for_test"]
    finally:
        del sys.modules["jax._fake_for_test"]


def test_reference_and_program_load_no_jax():
    code = ("import nerfbench.reference.model, nerfbench.reference.rays, "
            "nerfbench.harness, mipnerf360_torch.train.trainer, "
            "mipnerf360_torch.models.mipnerf360, sys; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'mipnerf360_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=FOLDER.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
