"""The port stands alone: no JAX, no reference package.

A subprocess that blocks ``jax`` and ``repro`` imports every module of
``repro_torch`` and runs a small CPU search; an AST scan finds no import of
either in ``src/repro_torch/`` or in ``chip_smoke.py``.
"""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
BANNED = ("jax", "jaxlib", "repro")


def _port_modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        yield ".".join(parts)


def _sources():
    yield from sorted(PORT.rglob("*.py"))
    yield ROOT / "chip_smoke.py"


def _banned(name):
    return name is not None and name.split(".")[0] in BANNED


@pytest.mark.parametrize("path", list(_sources()),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad = [a.name for a in node.names if _banned(a.name)]
            assert not bad, (path, node.lineno, bad)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            assert not _banned(node.module), (path, node.lineno, node.module)
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", None)) in (
                    "__import__", "import_module"):
            args = [a.value for a in node.args
                    if isinstance(a, ast.Constant)]
            assert not any(_banned(a) for a in args), (path, node.lineno)


_CHILD = """
import importlib, sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["repro"] = None
for name in {modules!r}:
    importlib.import_module(name)
import numpy as np
from repro_torch.ann.scorescan import scorescan_factory
from repro_torch.core import (HNSWCostModel, Query, build_effveda,
                              build_vector_storage, metrics)
from repro_torch.data.pipeline import make_retrieval_dataset
ds = make_retrieval_dataset(n_vectors=800, dim=8, n_roles=6,
                            n_permissions=12, n_queries=20, seed=0)
res = build_effveda(ds.policy, HNSWCostModel(lam_threshold=80), k=5)
store = build_vector_storage(
    res, ds.vectors, engine_factory=scorescan_factory(ds.policy, device="cpu"),
    pack_leftovers=True, device="cpu")
qs = [Query(vector=v, roles=(int(r),), k=5)
      for v, r in zip(ds.queries, ds.query_roles)]
out = store.search(qs)
assert {{r.path for r in out}} == {{"batched+packed"}}
for q, r in zip(qs, out):
    truth = metrics.brute_force_topk(ds.vectors,
                                     store.authorized_mask(q.roles[0]),
                                     q.vector, 5)
    assert r.ids == [i for _, i in truth], (r.ids, truth)
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules if sys.modules[m] is not None)
print("OK", len(out))
"""


def test_port_imports_and_searches_without_jax_or_reference():
    modules = list(_port_modules())
    assert "repro_torch.kernels.l2_topk.kernel" in modules
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c",
                           _CHILD.format(modules=modules)],
                          capture_output=True, text=True, env=env,
                          timeout=240, check=False)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "OK 20"
