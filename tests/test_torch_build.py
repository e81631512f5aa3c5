"""The build of the port's CUDA kernels (quest_tpu_torch/_build.py), on the
CPU: no nvcc runs here. A library's key covers its source and every header
under csrc/ that the source includes, so an edited header rebuilds."""

import shutil

import pytest

from quest_tpu_torch import _build


@pytest.fixture
def pkg_copy(tmp_path, monkeypatch):
    """A temp copy of the package's csrc/, which _build then reads."""
    shutil.copytree(_build._PKG / _build.CSRC, tmp_path / _build.CSRC)
    monkeypatch.setattr(_build, "_PKG", tmp_path)
    return tmp_path / _build.CSRC


def test_window_dot_includes_the_tensor_core_header(pkg_copy):
    names = [p.name for p in _build._inputs("window_dot")]
    assert names == ["window_dot.cu", "mma.cuh"]
    assert [p.name for p in _build._inputs("fused_gates")] == ["fused_gates.cu", "mma.cuh"]


@pytest.mark.parametrize("edited,changes", [
    ("mma.cuh", {"window_dot", "fused_gates"}),
    ("window_dot.cu", {"window_dot"}),
    ("fused_gates.cu", {"fused_gates"}),
])
def test_build_key_follows_source_and_headers(pkg_copy, edited, changes):
    before = {name: _build._target(name) for name in _build.SOURCES}
    path = pkg_copy / edited
    path.write_bytes(path.read_bytes() + b"\n// edited\n")
    after = {name: _build._target(name) for name in _build.SOURCES}
    assert {name for name in before if before[name] != after[name]} == changes
    assert all(t.parent == _build.BUILD_DIR for t in after.values())


def test_nvcc_command_names_the_header_directory(pkg_copy, monkeypatch):
    seen = []

    class Proc:
        def __init__(self, cmd, **kw):
            seen.append(cmd)

    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(_build, "BUILD_DIR", pkg_copy.parent / "_build")
    monkeypatch.setattr(_build.subprocess, "Popen", Proc)
    proc, out, tmp, _ = _build._start("window_dot")
    assert isinstance(proc, Proc) and not out.exists()
    cmd = seen[0]
    assert cmd[cmd.index("-I") + 1] == str(pkg_copy)
    assert cmd[-1] == str(pkg_copy / "window_dot.cu")
