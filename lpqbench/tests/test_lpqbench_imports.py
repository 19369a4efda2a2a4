"""The import guard: no file of the benchmark imports ``jax``, ``jaxlib`` or
the JAX package ``repro``, and the reference imports nothing of
``repro_torch`` (top-level names compared whole: ``repro_torch`` is not
``repro``)."""

import ast

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_no_jax_and_a_reference_apart_from_the_program():
    files = sorted((ROOT / "lpqbench").rglob("*.py"))
    assert len(files) > 20
    for path in files:
        names = set(_imports(path))
        assert not names & FORBIDDEN, (path, names & FORBIDDEN)
        if "reference" in path.relative_to(ROOT / "lpqbench").parts:
            assert "repro_torch" not in names, path


def test_the_guard_compares_whole_names(tmp_path):
    f = tmp_path / "x.py"
    f.write_text("import repro_torch.knn\nfrom jax import numpy\n"
                 "import reproduce\n")
    assert set(_imports(f)) == {"repro_torch", "jax", "reproduce"}
    assert set(_imports(f)) & FORBIDDEN == {"jax"}
