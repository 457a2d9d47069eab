"""The port's kernel build (``ops/_build.py``) on the CPU, without nvcc:
the key of a built library covers its source, every shared header under
``csrc/`` and the flags, so an edited header never reuses a stale
library."""

import shutil

import pytest

from video_mamba_suite_torch.ops import _build


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    """A copy of ``csrc/`` that ``_build`` reads instead of the package's."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, copy)
    monkeypatch.setattr(_build, "CSRC_DIR", copy)
    return copy


@pytest.mark.parametrize("source", ["row_mha_fwd", "flash_mha"])
def test_key_changes_with_a_shared_header(csrc_copy, source):
    header = csrc_copy / "attention_mma.cuh"
    assert f'#include "{header.name}"' in (
        csrc_copy / f"{source}.cu").read_text()
    before = _build._target(source)
    assert _build._target(source) == before           # the key is stable
    header.write_text(header.read_text() + "\n// an edit\n")
    assert _build._target(source) != before


def test_key_changes_with_a_new_header_source_and_flags(csrc_copy,
                                                       monkeypatch):
    before = _build._target("short_scan_fwd")
    (csrc_copy / "extra.cuh").write_text("// a header\n")
    with_header = _build._target("short_scan_fwd")
    assert with_header != before
    src = csrc_copy / "short_scan_fwd.cu"
    src.write_text(src.read_text() + "\n")
    with_source = _build._target("short_scan_fwd")
    assert with_source != with_header
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build._target("short_scan_fwd") != with_source
    assert _build._target("short_scan_fwd").parent == _build.BUILD_DIR
