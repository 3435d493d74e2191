"""The port's package surface against the JAX package's.

Every public name of every ``pykaldi2_tpu/**/__init__.py`` (read with
``ast``; nothing of the JAX package is imported) resolves as an attribute
of the port's counterpart package, apart from the names in ``MAPPED``,
whose port counterparts go by other names; and every module file of the JAX
package has a counterpart file, apart from those in ``RENAMED`` and
``NOT_CARRIED``.
"""

import ast
import importlib
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF, PORT = ROOT / "pykaldi2_tpu", ROOT / "pykaldi2_tpu_torch"

# reference name → (port module, counterpart names): the JAX sharding and
# platform helpers have no like-named port (ROADMAP.md, "Not carried over")
MAPPED = {
    ("parallel", "local_batch_sharding"): ("pykaldi2_tpu_torch.parallel.mesh",
                                           ("local_batch_shard",)),
    ("simulation", "simulate_batch"): ("pykaldi2_tpu_torch.simulation",
                                       ("draw_simulation", "apply_simulation")),
    ("utils", "apply_platform_env"): ("pykaldi2_tpu_torch.device", ("resolve_device",)),
}
RENAMED = {"ops/lstm_pallas.py": "ops/lstm_cuda.py",
           "ops/fb_lattice_pallas.py": "ops/fb_lattice_cuda.py"}
NOT_CARRIED = {"utils/profiling.py"}   # jax.profiler; the port has utils/tracing.py


def _public_names(init: pathlib.Path) -> list:
    names = set()
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return sorted(n for n in names if not n.startswith("_"))


SUBPACKAGES = sorted(p.parent.relative_to(REF).as_posix() for p in REF.rglob("__init__.py"))


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_exports_resolve_in_port(sub):
    names = _public_names(REF / sub / "__init__.py")
    dotted = "" if sub == "." else "." + sub.replace("/", ".")
    port = importlib.import_module("pykaldi2_tpu_torch" + dotted)
    missing = []
    for name in names:
        if (sub, name) in MAPPED:
            mod, targets = MAPPED[(sub, name)]
            for t in targets:
                assert callable(getattr(importlib.import_module(mod), t)), (name, t)
        elif not hasattr(port, name):
            missing.append(name)
    assert not missing, f"pykaldi2_tpu_torch{dotted} lacks {missing}"


def test_mapping_table_names_only_missing_names():
    """A mapped name that the port comes to export under its own name
    belongs in the exports, not in the table."""
    for (sub, name), _ in MAPPED.items():
        assert name in _public_names(REF / sub / "__init__.py"), name
        port = importlib.import_module(f"pykaldi2_tpu_torch.{sub}")
        assert not hasattr(port, name), name


def test_every_module_file_has_a_counterpart():
    ref = {p.relative_to(REF).as_posix() for p in REF.rglob("*.py")}
    port = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    missing = sorted(f for f in ref - NOT_CARRIED if RENAMED.get(f, f) not in port)
    assert not missing, missing
    for f, g in RENAMED.items():
        assert f in ref and g in port and f not in port, f
    assert NOT_CARRIED <= ref and not NOT_CARRIED & port


_NO_JAX = r"""
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
from pykaldi2_tpu_torch.ops import (BatchedGraphs, batched_expected_accuracy, fsa_logz_b,
                                    fsa_occupancies_b, mmi_objective_lattice, pack_graph_batch)
from pykaldi2_tpu_torch.decode import LatticeDecoder, build_native, edit_distance, score_corpus
from pykaldi2_tpu_torch.decode import decoder
assert decoder._lib is None   # importing the package loads (and builds) nothing
print("ok")
"""


def test_new_exports_import_without_jax():
    out = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
