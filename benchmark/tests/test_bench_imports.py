"""No module of the benchmark that runs on the card imports JAX or the JAX
package, and the plain reference imports nothing of the program either.
The check compares each import's top-level name whole: the port's name
begins with the JAX package's."""

import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = {"jax", "jaxlib", "flax", "linemod_pose_estimation_tpu"}
PORT = "linemod_pose_estimation_tpu_torch"


def modules(sub=""):
    top = os.path.join(BENCH, sub)
    for d, dirs, files in os.walk(top):
        dirs[:] = [x for x in dirs if x not in ("tests", "__pycache__")]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_names(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(modules()), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax(path):
    assert not set(top_names(path)) & JAX


@pytest.mark.parametrize("path", sorted(modules("reference")),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_program(path):
    assert not set(top_names(path)) & (JAX | {PORT})


def test_the_check_compares_whole_names():
    assert "linemod_pose_estimation_tpu_torch".split(".")[0] not in JAX
    from benchmark import run

    assert run.FORBIDDEN == JAX
