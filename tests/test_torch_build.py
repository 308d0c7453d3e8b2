"""The port's build cache (``deepspeed_tpu_torch/ops/build.py``): a
library is named by a hash of its source, the headers beside it and the
flags, so editing a header that a source includes rebuilds it; a host
source's (``csrc/*.cpp``, built by ``g++ -march=native``) also by the CPU's
identity. Runs on the CPU: for the CUDA sources only the target path is
computed; the host cases compile a one-line source with ``g++``, and a
broken one must raise with the compiler's output."""

import pytest

from deepspeed_tpu_torch.ops import build


def _tree(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "kern.cu").write_text('#include "helpers.cuh"\n__global__ void k() {}\n')
    (csrc / "helpers.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    return csrc


def test_target_is_stable_when_nothing_changes(tmp_path, monkeypatch):
    _tree(tmp_path, monkeypatch)
    first = build._target("kern")
    assert first == build._target("kern")
    assert first.parent == tmp_path / "build"
    assert first.name.startswith("libkern-") and first.suffix == ".so"


def test_editing_a_header_or_the_source_changes_the_target(tmp_path, monkeypatch):
    csrc = _tree(tmp_path, monkeypatch)
    first = build._target("kern")
    (csrc / "helpers.cuh").write_text("#pragma once\n// edited\n")
    second = build._target("kern")
    assert second != first
    (csrc / "other.cuh").write_text("#pragma once\n")      # a new header too
    third = build._target("kern")
    assert third not in (first, second)
    (csrc / "kern.cu").write_text('#include "helpers.cuh"\n')
    assert build._target("kern") != third


def test_flags_are_part_of_the_target(tmp_path, monkeypatch):
    _tree(tmp_path, monkeypatch)
    first = build._target("kern")
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert build._target("kern") != first


# -- the host sources (csrc/*.cpp, g++) -------------------------------------
def _host_tree(tmp_path, monkeypatch, cpu="model name : A\nflags : avx2"):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "hostk.cpp").write_text('extern "C" int f() { return 7; }\n')
    (csrc / "helpers.cuh").write_text("#pragma once\n")   # not a host input
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "cpu_identity", lambda: cpu)
    monkeypatch.setattr(build, "_builds", {})
    monkeypatch.setattr(build, "_libs", {})
    return csrc


def test_host_target_hashes_source_flags_and_cpu(tmp_path, monkeypatch):
    csrc = _host_tree(tmp_path, monkeypatch)
    first = build._target("hostk")
    assert first == build._target("hostk")
    assert first.name.startswith("libhostk-host-") and first.suffix == ".so"
    (csrc / "helpers.cuh").write_text("#pragma once\n// edited\n")
    assert build._target("hostk") == first        # a CUDA header: not an input
    monkeypatch.setattr(build, "cpu_identity", lambda: "model name : B")
    other_cpu = build._target("hostk")            # -march=native is per CPU
    assert other_cpu != first
    monkeypatch.setattr(build, "HOST_FLAGS", build.HOST_FLAGS + ("-g",))
    assert build._target("hostk") not in (first, other_cpu)
    (csrc / "hostk.cpp").write_text('extern "C" int f() { return 8; }\n')
    assert build._target("hostk") not in (first, other_cpu)


def test_host_flags_are_the_jax_builders():
    assert build.host_flags("cpu_adam") == ("-O3", "-march=native", "-fopenmp",
                                            "-fPIC", "-shared", "-std=c++17")
    assert build.host_flags("aio")[-1] == "-pthread"
    ident = build.cpu_identity()
    assert ident.splitlines()[0] == __import__("platform").machine()


def test_host_build_loads_and_a_failed_build_raises(tmp_path, monkeypatch):
    import shutil
    if shutil.which("g++") is None:
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            build.load("cpu_adam")
        return
    csrc = _host_tree(tmp_path, monkeypatch)
    lib = build.load("hostk")
    assert lib.f() == 7
    assert build._builds["hostk"].path.exists()
    (csrc / "broken.cpp").write_text("this is not C++;\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for broken") as err:
        build.load("broken")
    assert "error" in str(err.value)              # the compiler's output
    assert not list((tmp_path / "build").glob("libbroken*"))


def test_missing_compiler_raises(tmp_path, monkeypatch):
    _host_tree(tmp_path, monkeypatch)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        build.load("hostk")
