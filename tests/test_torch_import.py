"""The PyTorch port imports with jax absent and imports nothing of the JAX package.

Also covers device resolution: CUDA unless the caller asks for the CPU, and
a clear error (never a quiet CPU run) when there is no CUDA device.
"""

import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "pykaldi2_tpu_torch"

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["jaxlib"] = None
import pykaldi2_tpu_torch
names = [m.name for m in pkgutil.walk_packages(pykaldi2_tpu_torch.__path__,
                                               "pykaldi2_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "pykaldi2_tpu" or m.startswith("pykaldi2_tpu."))
assert not bad, bad
for n in ("graph", "graph.compile", "graph.transition_model", "decode.decoder",
          "ops.fb_lattice", "ops.fb_lattice_cuda", "ops.se_losses", "bin.train_se",
          "frontend.mfcc", "bin.compute_cmvn_stats", "bin.compute_feats", "ops.fb_dense",
          "ops.fb_block", "ops.fb_block_cuda", "ops.fb_bigram", "bin.compute_priors",
          "simulation", "simulation.resample", "simulation.rir", "simulation.iso_noise",
          "simulation.simulator", "simulation.device", "decode.wer", "decode.lattice",
          "decode.lattice_ark", "decode.mbr", "graph.vfst", "graph.openfst_io", "bin.decode",
          "graph.arpa", "ops.fb", "bin.align", "bin.build_graph", "bin.lattice_tool",
          "bin.compare_posteriors", "models.tdnn", "models.transformer",
          "decode.device_lattice", "decode.on_device", "ops.fb_batched"):
    assert "pykaldi2_tpu_torch." + n in names, n
print(len(names))
"""


def test_port_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 77  # every module of the port was imported


_BAD_IMPORT = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|optax|pykaldi2_tpu)(\.|\s|$)", re.M)


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py")] + ["chip_smoke.py"]))
def test_source_imports_no_jax_and_no_jax_package(path):
    src = (ROOT / path).read_text()
    assert not _BAD_IMPORT.findall(src), path


def test_resolve_device_cpu_by_argument_and_env(monkeypatch):
    from pykaldi2_tpu_torch.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setenv("PK2_PLATFORM", "cpu")
    assert resolve_device() == torch.device("cpu")
    monkeypatch.setenv("PK2_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="PK2_PLATFORM"):
        resolve_device()


def test_resolve_device_without_cuda_raises(monkeypatch):
    from pykaldi2_tpu_torch.device import resolve_device

    monkeypatch.delenv("PK2_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")


def test_kernel_sources_are_cuda_with_plain_c_interface():
    """K1-K12 are hand-written CUDA C++ bound through ctypes: no PyTorch
    headers, no library kernels inside."""
    from pykaldi2_tpu_torch import device as D

    assert D.KERNEL_SOURCES == ("fbank", "lstm", "latfb", "blockfb", "search")
    for name in D.KERNEL_SOURCES:
        src = (PORT / "csrc" / f"{name}.cu").read_text()
        assert 'extern "C"' in src
        for banned in ("torch/extension.h", "cublas", "cudnn", "ATen"):
            assert banned not in src, (name, banned)
    assert "arch=compute_90a,code=sm_90a" in D.NVCC_FLAGS
    assert D.BUILD_DIR == ROOT / "build" / "kernels"


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a CUDA card chip_smoke.py exits non-zero and prints no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
