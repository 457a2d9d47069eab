"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first use
into ``build/<name>-<hash>.so`` inside the package (a git-ignored
directory), keyed by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header rebuilds.
Nothing is built when a module is imported: the CPU-only test
environment has no nvcc.

Every kernel wrapper adds one to ``LAUNCHES[<name>]`` each time it
launches its kernel, so a run can show which kernels its path went through.

The host sources ``csrc/<name>.cc`` (plain C++ for the host, such as the
1-D NMS) are compiled the same way by the C++ compiler, into
``build/<name>-host-<hash>.so`` (``build_host``, ``load_host``).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# the host sources (``csrc/*.cc``, plain C++ called from the host): the
# JAX package's flags less OpenMP and -march=native, which they do not use
HOST_CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

LAUNCHES: collections.Counter = collections.Counter()

_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    LAUNCHES.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: a CUDA toolkit is needed to build "
                       "the port's kernels")


def _target(name: str) -> Path:
    """The library's path: keyed by the source, every shared header under
    ``csrc/`` (a source may include any of them) and the flags."""
    key = hashlib.sha1()
    for path in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        key.update(path.name.encode() + b"\0" + path.read_bytes())
    key.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{key.hexdigest()[:12]}.so"


def build_all(names: Iterable[str] = ()) -> Dict[str, Path]:
    """Compile the named sources (every ``csrc/*.cu`` when none are named)
    that are not built yet, one nvcc process per source, all started
    together, and return each library's path. nvcc's output (register,
    spill and shared-memory report) is kept in ``<library>.log``."""
    names = list(names) or sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
    targets = {name: _target(name) for name in names}
    todo = [name for name, target in targets.items() if not target.exists()]
    if not todo:
        return targets
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = {}
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp)
    failed = []
    for name, (proc, tmp) in jobs.items():
        out, _ = proc.communicate()
        Path(str(targets[name]) + ".log").write_text(out)
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed for {name}:\n{out}")
        else:
            os.replace(tmp, targets[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return targets


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless it is built already and return the
    library's path."""
    return build_all([name])[name]


def build_log(name: str) -> str:
    """nvcc's output from building ``name`` (empty if it was not built)."""
    log = Path(str(_target(name)) + ".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LIBS[name] = lib
    return lib


def library(name: str, n_ints: int, n_ptrs: int) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` with the argument types of
    its C entry ``name`` set: ``n_ints`` integers (the second a 64-bit batch
    count), ``n_ptrs`` pointers, then the stream. The entry returns a
    ``cudaError_t``; ``<name>_error_string`` names it."""
    lib = load(name)
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int, ctypes.c_longlong]
                   + [ctypes.c_int] * (n_ints - 2)
                   + [ctypes.c_void_p] * (n_ptrs + 1))
    err = getattr(lib, name + "_error_string")
    err.restype = ctypes.c_char_p
    err.argtypes = [ctypes.c_int]
    return lib


def entry(source: str, name: str, argtypes) -> ctypes.CDLL:
    """The loaded library for ``csrc/<source>.cu`` with the C entry
    ``name`` given ``argtypes`` and then the stream, returning a
    ``cudaError_t`` that ``<name>_error_string`` names (for entries whose
    arguments do not follow ``library``'s pattern)."""
    lib = load(source)
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = list(argtypes) + [ctypes.c_void_p]
    err = getattr(lib, name + "_error_string")
    err.restype = ctypes.c_char_p
    err.argtypes = [ctypes.c_int]
    return lib


def _host_target(name: str) -> Path:
    """A host library's path, keyed by its source and the flags."""
    key = hashlib.sha1((CSRC_DIR / f"{name}.cc").read_bytes())
    key.update(" ".join(HOST_CXX_FLAGS).encode())
    return BUILD_DIR / f"{name}-host-{key.hexdigest()[:12]}.so"


def build_host(name: str) -> Path:
    """Compile the host source ``csrc/<name>.cc`` with the C++ compiler
    (``$CXX``, else ``c++``) unless it is built already, and return the
    library's path. A failed build raises."""
    target = _host_target(name)
    if target.exists():
        return target
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if not cxx:
        raise RuntimeError(f"no C++ compiler found to build {name}.cc")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *HOST_CXX_FLAGS, "-o", tmp,
                               str(CSRC_DIR / f"{name}.cc")],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed for {name}.cc:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


def load_host(name: str) -> ctypes.CDLL:
    """The loaded host library for ``csrc/<name>.cc``, built first if
    needed."""
    key = name + ".cc"
    lib = _LIBS.get(key)
    if lib is None:
        lib = ctypes.CDLL(str(build_host(name)))
        _LIBS[key] = lib
    return lib


def ptr(t) -> Optional[int]:
    """A tensor's device address, or None (a null pointer) for None."""
    return None if t is None else t.data_ptr()


def launch(name: str, lib: ctypes.CDLL, device, *args) -> None:
    """Call the C entry ``name`` on the current stream of ``device``; raise
    if it reports an error. Counts the launch in ``LAUNCHES[name]``."""
    import torch

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, name)(*args, stream)
    if rc != 0:
        msg = getattr(lib, name + "_error_string")(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({rc})")
    LAUNCHES[name] += 1
