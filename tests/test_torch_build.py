"""The port's kernel build (``ops/_build.py``) on the CPU, without nvcc:
the key of a built library covers its source, every shared header under
``csrc/`` and the flags, so an edited header never reuses a stale
library; and the kernel names that ``chip_smoke.ROUTES`` looks for in the
profiler are kernels of their sources."""

import re
import shutil
from pathlib import Path

import pytest
import torch

import chip_smoke
from video_mamba_suite_torch.ops import _build


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread runs them faster
    and keeps the test workers beside this file from being
    oversubscribed."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


REPO = Path(__file__).resolve().parent.parent


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


@pytest.mark.parametrize("entry", ["K1", "K2", "K3", "K4", "K5", "K6",
                                   "K7", "K8", "K9", "K10", "K11",
                                   "K11 bwd"])
def test_routes_name_kernels_of_their_sources(entry):
    """Each kernel ``ROUTES`` names for an entry is a ``__global__``
    function of the entry's source, so a renamed kernel fails here rather
    than on the card; for attention, bf16 names only tensor-core kernels
    (``*_mma_kernel``; K11's backward also the di kernel both types share)
    and fp32 none; the scans (K1-K8) name the same kernels for both
    types."""
    source = {"K1": chip_smoke.K1_SOURCE, "K2": chip_smoke.K2_SOURCE,
              "K3": chip_smoke.K3_SOURCE, "K4": chip_smoke.K4_SOURCE,
              "K5": chip_smoke.K5_SOURCE, "K6": chip_smoke.K6_SOURCE,
              "K7": chip_smoke.K7_SOURCE, "K8": chip_smoke.K8_SOURCE,
              "K9": chip_smoke.K9_SOURCE, "K10": chip_smoke.K10_SOURCE,
              "K11": chip_smoke.K11_SOURCE,
              "K11 bwd": chip_smoke.K11_SOURCE}[entry]
    text = (REPO / source).read_text()
    routes = {dtype: chip_smoke.ROUTES[(entry, dtype)]
              for dtype in ("bfloat16", "float32")}
    for names in routes.values():
        for name in names:
            assert re.search(r"__global__ void (?:__launch_bounds__\([^)]*\)"
                             rf"\s*)?{name}\(", text), name
    shared = set(routes["bfloat16"]) & set(routes["float32"])
    assert all(name.endswith("_mma_kernel")
               for name in set(routes["bfloat16"]) - shared)
    assert not any("_mma_" in name for name in routes["float32"])


@pytest.mark.parametrize("mangled,label", [
    ("_ZN52_GLOBAL__N__54c4fcbc_19_chunked_scan_bwd_cu_694fb74127chunked_"
     "scan_bwd_main_lanesI13__nv_bfloat16Lb0EEEvNS_6ParamsE",
     "chunked_scan_bwd_main_lanes<bf16, false>"),
    ("_ZN52_GLOBAL__N__54c4fcbc_19_chunked_scan_bwd_cu_694fb74124chunked_"
     "scan_bwd_combineENS_6ParamsEl", "chunked_scan_bwd_combine"),
    ("_ZN12_GLOBAL__N_124flash_mha_fwd_mma_kernelILi128ELi8ELb1EEEvNS_9Fwd"
     "ParamsE", "flash_mha_fwd_mma_kernel<128, 8, true>"),
    ("_ZN12_GLOBAL__N_128short_bidir_bwd_lanes_kernelIfLb1EEEvNS_10"
     "DirectionsEiiii", "short_bidir_bwd_lanes_kernel<float, true>"),
])
def test_kernel_label_reads_mangled_names(mangled, label):
    """The build phase names each kernel of ``RESOURCE_KERNELS`` from
    ptxas's mangled name: the length-prefixed nested names (nvcc's
    anonymous namespace carries a hash with digits) and the template
    arguments."""
    assert chip_smoke.kernel_label(mangled) == label
