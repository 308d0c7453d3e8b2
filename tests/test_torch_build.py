"""The port's kernel build cache (``deepspeed_tpu_torch/ops/build.py``): a
library is named by a hash of its source, the headers beside it and the
flags, so editing a header that a source includes rebuilds it. Runs on the
CPU: only the target path is computed, nothing is compiled."""

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
