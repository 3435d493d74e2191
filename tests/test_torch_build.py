"""The kernel build's staleness check (pykaldi2_tpu_torch/device.py): a
library is rebuilt when it is missing or older than its own source or any
``csrc/*.cuh`` header, so a changed header never loads an old library on the
card. Runs on the CPU: no nvcc is called."""

import os

import pytest

from pykaldi2_tpu_torch import device as D


@pytest.fixture
def tree(tmp_path, monkeypatch):
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(D, "CSRC_DIR", csrc)
    monkeypatch.setattr(D, "BUILD_DIR", build)
    (csrc / "k.cu").write_text("// source\n")
    (csrc / "other.cu").write_text("// another source\n")
    return csrc, build


def _touch(path, mtime):
    path.touch()
    os.utime(path, (mtime, mtime))


def test_missing_library_is_stale(tree):
    assert D._stale("k")


def test_library_newer_than_every_input_is_fresh(tree):
    csrc, build = tree
    _touch(csrc / "k.cu", 1000)
    _touch(csrc / "shared.cuh", 1000)
    _touch(build / "libk.so", 2000)
    assert not D._stale("k")


def test_newer_source_makes_library_stale(tree):
    csrc, build = tree
    _touch(build / "libk.so", 2000)
    _touch(csrc / "k.cu", 3000)
    assert D._stale("k")


@pytest.mark.parametrize("header", ["shared.cuh", "mma.cuh"])
def test_newer_header_makes_library_stale(tree, header):
    csrc, build = tree
    _touch(csrc / "k.cu", 1000)
    _touch(build / "libk.so", 2000)
    assert not D._stale("k")
    _touch(csrc / header, 3000)
    assert D._stale("k")


def test_another_source_does_not_make_library_stale(tree):
    csrc, build = tree
    _touch(csrc / "k.cu", 1000)
    _touch(build / "libk.so", 2000)
    _touch(csrc / "other.cu", 3000)
    assert not D._stale("k")
