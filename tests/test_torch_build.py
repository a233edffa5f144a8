"""The kernel build's cache key (``dalle_tpu_torch/ops/_build.py``), on the
CPU: no ``nvcc`` is needed to name a library. A source is rebuilt when it or
a local header it includes changes, and only then."""

import pytest

from dalle_tpu_torch.ops import _build


def test_target_covers_the_local_headers_a_source_includes(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    (csrc / "tile.cuh").write_text('#pragma once\n#include "inner.cuh"\nint tile();\n')
    (csrc / "inner.cuh").write_text("int inner();\n")
    (csrc / "other.cuh").write_text("int other();\n")
    (csrc / "a.cu").write_text('#include <cuda_runtime.h>\n#include "tile.cuh"\nint a();\n')
    (csrc / "b.cu").write_text("int b();\n")

    def targets():
        return {s: _build._target(csrc / f"{s}.cu") for s in ("a", "b")}

    assert [p.name for p in _build._sources(csrc / "a.cu")] == ["a.cu", "tile.cuh", "inner.cuh"]
    first = targets()
    assert all(t.parent == tmp_path / "build" and t.suffix == ".so" for t in first.values())
    assert targets() == first                        # unchanged sources, same names
    (csrc / "inner.cuh").write_text("int inner(int);\n")   # a header of a header
    second = targets()
    assert second["a"] != first["a"] and second["b"] == first["b"]
    (csrc / "tile.cuh").write_text('#pragma once\n#include "inner.cuh"\nint tile(int);\n')
    third = targets()
    assert third["a"] != second["a"] and third["b"] == first["b"]
    (csrc / "other.cuh").write_text("int other(int);\n")   # included by nobody
    assert targets() == third


@pytest.mark.parametrize("source, header", [
    ("fused_attention", "tc_tile.cuh"), ("chunk_attention", "tc_tile.cuh"),
    ("persistent_attention", "tc_tile.cuh"), ("decode_attention", "decode_split.cuh"),
    ("decode_chunked_attention", "decode_split.cuh")],
    ids=["fused_attention", "chunk_attention", "persistent_attention", "decode_attention",
         "decode_chunked_attention"])
def test_tensor_core_kernels_are_rebuilt_when_the_tile_header_changes(tmp_path, monkeypatch,
                                                                       source, header):
    """K1's, K6's and K8's sources include the tensor-core tile helpers
    (``tc_tile.cuh``), K2's and K7's the cluster-split skeleton
    (``decode_split.cuh``): an edit of the header alone renames (so
    rebuilds) their library."""
    real = _build.CSRC
    names = [f"{source}.cu", header]
    assert [p.name for p in _build._sources(real / names[0])] == names
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in names:
        (csrc / name).write_text((real / name).read_text())
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    first = _build._target(csrc / names[0])
    assert _build._target(csrc / names[0]) == first
    path = csrc / header
    path.write_text(path.read_text() + "\n// edited\n")
    assert _build._target(csrc / names[0]) != first
