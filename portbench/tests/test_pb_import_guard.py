"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's),
and the plain reference and the yardstick import nothing of the port."""
import ast
import os

import pytest

from portbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "d2slam_tpu"}
PORT = "d2slam_tpu_torch"
INDEPENDENT = ("reference", "yardstick")


def modules():
    for dirpath, _, files in os.walk(harness.PB_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_the_guard_compares_whole_names():
    assert "d2slam_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "d2slam_tpu.frontend".split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", sorted(modules()), ids=lambda p: os.path.relpath(p, harness.ROOT))
def test_no_jax_and_an_independent_reference(path):
    names = set(top_level_imports(path))
    assert not names & FORBIDDEN, f"{path} imports {names & FORBIDDEN}"
    rel = os.path.relpath(path, harness.PB_DIR).split(os.sep)
    if rel[0] in INDEPENDENT:
        assert PORT not in names, f"{path} imports the port"


def test_independent_modules_import_only_each_other():
    for path in modules():
        rel = os.path.relpath(path, harness.PB_DIR).split(os.sep)
        if rel[0] not in INDEPENDENT:
            continue
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith("portbench."):
                assert node.module.split(".")[1] in INDEPENDENT, (path, node.module)


def test_a_run_loads_no_jax():
    """The runtime guard of ``run.py`` on this process: the harness and
    both drivers are loaded."""
    import portbench.drivers.depth_replay  # noqa: F401
    import portbench.drivers.vio  # noqa: F401
    assert harness.forbidden_modules() == []
