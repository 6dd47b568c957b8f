"""No module under renderbench/ imports JAX or the JAX package, and the
plain reference imports nothing of the port: top-level module names
compared whole (``elevenrender_tpu_torch`` is not ``elevenrender_tpu``)."""

import ast
import os

from renderbench import manifest, run

FORBIDDEN = {"jax", "jaxlib", "flax", "elevenrender_tpu"}
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources(sub=""):
    for dirpath, _, files in os.walk(os.path.join(HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_nothing_imports_jax_or_the_jax_package():
    for path in sources():
        assert not top_level_imports(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_port():
    for path in sources("reference"):
        assert "elevenrender_tpu_torch" not in top_level_imports(path), path


def test_the_names_are_compared_whole():
    assert run.FORBIDDEN == ("jax", "jaxlib", "flax", "elevenrender_tpu")
    assert "elevenrender_tpu_torch".split(".")[0] not in FORBIDDEN
    assert manifest.ROOT == os.path.dirname(HERE)
