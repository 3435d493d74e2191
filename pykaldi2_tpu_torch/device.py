"""Device resolution and the build/load helper for the hand-written kernels.

Device: entry points run on CUDA unless the caller asks for the CPU, either
with a ``device=`` argument or with ``PK2_PLATFORM=cpu`` (the port's
counterpart of pykaldi2_tpu/utils/__init__.py:apply_platform_env). With
neither and no CUDA device, ``resolve_device`` raises: the port never falls
back to the CPU quietly.

Kernels: every ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
``build/kernels/lib<name>.so`` at the repository root on first use (or when
the source is newer than the library) and loaded with ``ctypes``. The
sources have a plain C interface and include no PyTorch headers, so a build
takes seconds. ``build_all`` starts one ``nvcc`` per source at once.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Union

import torch

_PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "kernels"
KERNEL_SOURCES = ("fbank", "lstm", "latfb", "blockfb")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """The device an entry point runs on.

    An explicit ``device`` wins; otherwise ``PK2_PLATFORM`` (``cpu`` or
    ``cuda``/``gpu``); otherwise CUDA, which must then exist.
    """
    if device is None:
        plat = os.environ.get("PK2_PLATFORM", "").strip().lower()
        if plat == "cpu":
            return torch.device("cpu")
        if plat not in ("", "cuda", "gpu"):
            raise ValueError(f"PK2_PLATFORM={plat!r}: expected cpu or cuda")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' or set PK2_PLATFORM=cpu "
                "to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        set_fp32_exact()
    return dev


def set_fp32_exact() -> None:
    """Full-precision fp32 products on the card: no TF32 in matmuls or cuDNN
    convolutions. The front end is fp32-exact by contract (the reference
    forces precision=HIGHEST on every front-end GEMM)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    src = CSRC_DIR / f"{name}.cu"
    return not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime


def _start_build(name: str) -> subprocess.Popen:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    log = open(BUILD_DIR / f"{name}.log", "w")
    try:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    finally:
        log.close()
    proc.pk2_tmp = tmp  # type: ignore[attr-defined]
    proc.pk2_name = name  # type: ignore[attr-defined]
    return proc


def _finish_build(proc: subprocess.Popen) -> None:
    rc = proc.wait()
    name, tmp = proc.pk2_name, proc.pk2_tmp  # type: ignore[attr-defined]
    if rc != 0:
        tmp.unlink(missing_ok=True)
        log = (BUILD_DIR / f"{name}.log").read_text()
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu (exit {rc}):\n{log}")
    os.replace(tmp, _lib_path(name))  # atomic: concurrent builders never see half a file


def build_all(names: Iterable[str] = KERNEL_SOURCES, force: bool = False) -> Dict[str, str]:
    """Build the named kernel libraries in parallel (one nvcc each); returns
    {name: ptxas report} read from each build's log."""
    with _BUILD_LOCK:
        procs = [_start_build(n) for n in names if force or _stale(n)]
        errors = []
        for p in procs:
            try:
                _finish_build(p)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
    return {n: (BUILD_DIR / f"{n}.log").read_text() if (BUILD_DIR / f"{n}.log").exists()
            else "" for n in names}


_BUILD_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def load_kernel_lib(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    if _stale(name):
        build_all((name,))
    with _BUILD_LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_lib_path(name)))
            _LIBS[name] = lib
    return lib


def check_launch(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a kernel's C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {rc}")


def current_stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
