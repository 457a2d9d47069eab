"""The padded profiler session that chip_smoke.py reads kernel names and
device times from: it records its body and idles on the host at both ends."""

import time

import pytest
import torch
from torch.profiler import ProfilerActivity

from video_mamba_suite_torch.utils.profiler_window import (
    padded_profile,
    stray_us,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread runs them faster
    and keeps the test workers beside this file from being
    oversubscribed."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_padded_profile_records_its_body_inside_the_padding():
    pad = 0.05
    x = torch.ones(8)
    t0 = time.perf_counter()
    with padded_profile([ProfilerActivity.CPU], pad) as prof:
        t1 = time.perf_counter()
        torch.add(x, x)
        t2 = time.perf_counter()
    t3 = time.perf_counter()
    assert t1 - t0 >= pad and t3 - t2 >= pad
    assert any(e.name == "aten::add" for e in prof.events())
    assert stray_us(prof) is None         # no kernel on a card to measure
