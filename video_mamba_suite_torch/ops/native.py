"""Host-side native ops of the port, built with the host's C++ compiler on
first use (``ops/_build.py`` ``build_host`` / ``load_host``) and loaded with
ctypes; a failed build raises, nothing falls back.

``read_files_parallel`` reads many raw files into one buffer on threads
(``csrc/feature_loader.cc``, the JAX package's own C++ reader: ``pread``
without the GIL). The TAL NMS op is ``tasks/tal/nms.py``'s.
"""

from __future__ import annotations

import ctypes
import os
from typing import Sequence

import numpy as np

from ._build import load_host


def _feature_loader() -> ctypes.CDLL:
    lib = load_host("feature_loader")
    lib.read_files_parallel.restype = ctypes.c_int64
    return lib


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def read_files_parallel(paths: Sequence[str], sizes: Sequence[int],
                        header_skip: int = 0,
                        num_threads: int = 4) -> np.ndarray:
    """The bytes of every file, one after another, as one uint8 array:
    ``sizes[i]`` bytes of ``paths[i]`` after its first ``header_skip``
    bytes, at offset ``sum(sizes[:i])``; ``num_threads`` threads read
    (4 when it is not positive). A file that does not open or holds too
    few bytes raises ``OSError`` naming it."""
    paths = [os.fsencode(p) for p in paths]
    sizes = np.ascontiguousarray(sizes, np.int64)
    if len(sizes) != len(paths):
        raise ValueError(f"{len(paths)} paths but {len(sizes)} sizes")
    blob = b"".join(p + b"\0" for p in paths)
    path_offsets = np.zeros(len(paths), np.int64)
    if len(paths) > 1:
        path_offsets[1:] = np.cumsum([len(p) + 1 for p in paths[:-1]])
    dst_offsets = np.zeros(len(paths), np.int64)
    if len(paths) > 1:
        dst_offsets[1:] = np.cumsum(sizes[:-1])
    dst = np.zeros(int(sizes.sum()), np.uint8)
    failed = _feature_loader().read_files_parallel(
        blob, _i64p(path_offsets), ctypes.c_int64(len(paths)),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_char)),
        _i64p(dst_offsets), _i64p(sizes), ctypes.c_int64(header_skip),
        ctypes.c_int64(num_threads))
    if failed:
        name = os.fsdecode(paths[failed - 1])
        raise OSError(f"read_files_parallel: could not read "
                      f"{sizes[failed - 1]} bytes of {name!r} after "
                      f"{header_skip} header bytes")
    return dst
