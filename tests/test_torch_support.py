"""Every port test module stands on tests/torch_support.py.

Each tests/test_torch_*.py imports torch_support in its leading block of
imports, so torch runs on one thread before the module builds a tensor; no
port test module calls torch.set_num_threads itself, but for the two child
processes, which pin themselves: `_rank_main` of test_torch_sharding.py and
the ISOLATED script of test_torch_groth16.py (a string, not code, to this
scan); and torch runs on one thread in this process.
"""

import ast
from pathlib import Path

import torch

import torch_support  # noqa: F401  (torch on one thread)

TESTS = Path(__file__).resolve().parent
MODULES = sorted(TESTS.glob("test_torch_*.py"))


def leading_imports(tree):
    """The module-level imports before the first other statement (the
    docstring aside)."""
    body = tree.body[1:] if ast.get_docstring(tree) is not None else tree.body
    out = []
    for node in body:
        if not isinstance(node, (ast.Import, ast.ImportFrom)):
            break
        out.append(node)
    return out


def imports_support(node):
    if isinstance(node, ast.Import):
        return any(a.name == "torch_support" for a in node.names)
    return node.module == "torch_support" and node.level == 0


def thread_pins(tree):
    """Each call to set_num_threads in `tree`, as the name of the top-level
    function it sits in (None at module level)."""
    out = []
    for node in tree.body:
        where = node.name if isinstance(node, ast.FunctionDef) else None
        out += [where for n in ast.walk(node) if isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute) and n.func.attr == "set_num_threads"]
    return out


def test_every_port_test_module_imports_the_support_module_first():
    assert len(MODULES) > 20 and TESTS / "test_torch_support.py" in MODULES
    missing = [p.name for p in MODULES
               if not any(imports_support(n) for n in leading_imports(ast.parse(p.read_text())))]
    assert missing == [], f"import torch_support in the leading imports of {missing}"


def test_only_the_child_processes_set_the_thread_count():
    trees = {p.name: ast.parse(p.read_text()) for p in MODULES}
    pins = {name: thread_pins(tree) for name, tree in trees.items()}
    assert {name: where for name, where in pins.items() if where} == {
        "test_torch_sharding.py": ["_rank_main"]}
    isolated = [n.value.value for n in trees["test_torch_groth16.py"].body
                if isinstance(n, ast.Assign) and [t.id for t in n.targets] == ["ISOLATED"]]
    assert len(isolated) == 1 and "torch.set_num_threads(1)" in isolated[0]


def test_torch_runs_on_one_thread():
    assert torch.get_num_threads() == 1
