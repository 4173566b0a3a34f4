"""The kernel libraries' names follow their sources and the headers those
include, on the CPU (nothing is compiled here).

`_build._lib_path(name)` hashes `csrc/<name>.cu` together with the files of
`csrc/` that it includes with `#include "..."`, so that an edit to a header
shared by two kernels (`sga_sweep_h.cuh`: K1 and K5) rebuilds both, and a
source that includes none keeps the name it had.
"""

import hashlib

import pytest

from ganet_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "step.cuh").write_text("#pragma once\nconstexpr int kStep = 1;\n")
    (tmp_path / "inner.cuh").write_text("constexpr int kInner = 1;\n")
    (tmp_path / "with.cu").write_text('#include <cuda_runtime.h>\n#include "step.cuh"\nint f() { return kStep; }\n')
    (tmp_path / "nested.cu").write_text('#include "outer.cuh"\n')
    (tmp_path / "outer.cuh").write_text('  #  include "inner.cuh"\n#include "step.cuh"\n')
    (tmp_path / "alone.cu").write_text("#include <stdint.h>\nint g() { return 2; }\n")
    return tmp_path


def test_a_header_edit_renames_the_sources_that_include_it(csrc):
    with_before, nested_before = _build._lib_path("with"), _build._lib_path("nested")
    assert [p.name for p in _build._sources("with")] == ["with.cu", "step.cuh"]
    (csrc / "step.cuh").write_text("#pragma once\nconstexpr int kStep = 2;\n")
    assert _build._lib_path("with") != with_before
    assert _build._lib_path("nested") != nested_before
    assert _build._lib_path("with").name.startswith("libwith-")


def test_headers_are_followed_through_headers_once_each(csrc):
    assert [p.name for p in _build._sources("nested")] == ["nested.cu", "outer.cuh", "inner.cuh", "step.cuh"]
    before = _build._lib_path("nested")
    (csrc / "inner.cuh").write_text("constexpr int kInner = 2;\n")
    assert _build._lib_path("nested") != before


def test_a_source_without_includes_keeps_its_name(csrc):
    text = (csrc / "alone.cu").read_bytes()
    want = _build.BUILD_DIR / f"libalone-{hashlib.sha256(text).hexdigest()[:12]}.so"
    assert _build._lib_path("alone") == want
    (csrc / "step.cuh").write_text("// edited\n")
    assert _build._lib_path("alone") == want


def test_the_shared_sweep_step_is_hashed_into_k1_and_k5():
    for name in ("sga_fwd", "sga_fwd_seeded"):
        assert [p.name for p in _build._sources(name)] == [f"{name}.cu", "sga_sweep_h.cuh"]
