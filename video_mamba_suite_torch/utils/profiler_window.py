"""torch.profiler sessions whose window on the host's clock is padded.

The profiler keeps a kernel only where the kernel's timestamps, moved to
the host's clock, fall inside the session's window. Where the card's clock
strays from the host's by some milliseconds, a session that holds a few
short launches comes back with some of them, or none, missing. A padded
session idles ``PAD_S`` on the host after it starts and again after the
card has finished its work, so a stray of less than ``PAD_S`` either way
loses nothing.

Run as a script on a machine with a card, it measures that stray and what
the padding does about it: for ``--seconds`` it profiles 20 launches of
K10 and of K9 at a few shapes, in sessions without and with padding, and
prints how many sessions came back short or empty and the spread of the
stray (the earliest kernel's start less the earliest launch call's start,
in µs; on one clock that is positive)::

    python3 -m video_mamba_suite_torch.utils.profiler_window --seconds 120
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import time
from typing import Iterator, Optional, Sequence

import torch

PAD_S = 0.02        # seconds of host idle at each end of a padded window


@contextlib.contextmanager
def padded_profile(activities: Sequence, pad_s: float = PAD_S) -> Iterator:
    """A ``torch.profiler.profile`` session over the body of the ``with``
    block, with ``pad_s`` of host idle after the session starts and after
    the body's device work has finished (the card synchronised at both
    ends when CUDA is among ``activities``). Yields the profiler."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    on_card = ProfilerActivity.CUDA in activities
    if on_card:
        torch.cuda.synchronize()
    with torch_profile(activities=list(activities)) as prof:
        time.sleep(pad_s)
        yield prof
        if on_card:
            torch.cuda.synchronize()
        time.sleep(pad_s)


def stray_us(prof) -> Optional[float]:
    """The earliest device kernel's start less the earliest launch call's
    start in a finished session, in µs (None without either)."""
    kernels, launches = [], []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append(e.time_range.start)
        elif "LaunchKernel" in e.name:
            launches.append(e.time_range.start)
    if not kernels or not launches:
        return None
    return min(kernels) - min(launches)


def _cases():
    """(label, call) of K10 and K9 at the MIR shapes and two small ones."""
    from video_mamba_suite_torch.ops import row_mha_fwd, vision_mha_fwd

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*size, dtype=torch.bfloat16):
        return torch.randn(*size, device="cuda", generator=gen).to(dtype)

    qkv = randn(8, 16, 36, 197, 64)
    small = randn(1, 2, 6, 100, 200)
    q, k, v = (randn(128, 12, 197, 64) for _ in range(3))
    t = [randn(8, 8, 77, 64, dtype=torch.float32) for _ in range(3)]
    return [("K10 mir", lambda: row_mha_fwd(qkv)),
            ("K10 dh200", lambda: row_mha_fwd(small)),
            ("K9 vision", lambda: vision_mha_fwd(q, k, v)),
            ("K9 text fp32", lambda: vision_mha_fwd(*t))]


def main(argv: Optional[Sequence[str]] = None) -> int:
    from torch.profiler import ProfilerActivity

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seconds", type=float, default=120.0)
    parser.add_argument("--calls", type=int, default=20)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device")
        return 1
    cases = _cases()
    filler = torch.randn(4096, 4096, device="cuda")
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    stats = {pad: {"sessions": 0, "short": 0, "empty": 0, "stray_us": []}
             for pad in (0.0, PAD_S)}
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < args.seconds:
        for _ in range(50):      # keep the card busy between rounds
            filler = (filler @ filler).tanh()
        for label, call in cases:
            for pad, s in stats.items():
                with padded_profile(acts, pad) as prof:
                    for _ in range(args.calls):
                        call()
                seen = sum(e.device_type == torch.autograd.DeviceType.CUDA
                           for e in prof.events())
                s["sessions"] += 1
                s["empty"] += seen == 0
                s["short"] += 0 < seen < args.calls
                stray = stray_us(prof)
                if stray is not None:
                    s["stray_us"].append(stray)
                if seen < args.calls:
                    print(f"{time.perf_counter() - t0:.1f} s, {label}, pad "
                          f"{pad} s: {seen} of {args.calls} kernels, stray "
                          f"{stray} us", flush=True)
    out = {"device": torch.cuda.get_device_name(0), "calls": args.calls,
           "seconds": time.perf_counter() - t0, "windows": []}
    for pad, s in stats.items():
        strays = s.pop("stray_us")
        out["windows"].append(dict(
            pad_s=pad, **s,
            stray_us_min=min(strays, default=None),
            stray_us_median=statistics.median(strays) if strays else None,
            stray_us_max=max(strays, default=None)))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
