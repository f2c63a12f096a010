"""Build and load the CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
use, on the machine with the card, into a shared library loaded with
``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
        -Xcompiler -fPIC -Xptxas -v \\
        -o build/repro_torch/lib<name>-<hash>.so <name>.cu

The library's name carries a hash of its source and of the headers
beside it (``page_rows.cuh``, which ``rowclone.cu`` and ``ambit.cu``
include), so an edited source or header is rebuilt and a stale library
is never loaded.  ptxas's report (registers,
spills and shared memory of each kernel) is kept beside the library as
``lib<name>-<hash>.log``.  Nothing here runs at
import time: the package imports, and its CPU paths run, on a machine
without ``nvcc``.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("rowclone", "paged_attention", "flash_attention", "drange",
           "ambit", "ssm_scan")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
_U = ctypes.c_uint
_PP = ctypes.POINTER(ctypes.c_void_p)

# entry point -> argtypes (every entry point returns a cudaError_t as int)
SIGNATURES = {
    "rowclone": {
        "rc_kv_scatter": [_P, _P, _P, _P, _I, _P, _P, _I, _I, _L, _I, _L,
                          _P],
        "rc_copy_pages": [_P, _I, _P, _P, _I, _I, _I, _P],
        "rc_copy_cluster_chunks": [],
        "rc_init_rows": [_P, _P, _I, _P, _P, _L, _I, _I, _L, _U, _P],
        "rc_copy_flat": [_P, _P, _L, _P],
        "rc_fill_flat": [_P, _L, _U, _P],
    },
    "paged_attention": {
        "pa_paged_attention": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                               _F, _I, _P],
    },
    "flash_attention": {
        "fa_flash_attention": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                               _I, _I, _I, _I, _I, _F, _I, _L, _L, _L, _P],
    },
    "drange": {
        "dr_random_u32": [_U, _U, _P, _L, _P],
        "dr_random_uniform": [_U, _U, _P, _L, _L, _P, _P],
    },
    "ambit": {
        "am_page_rows": [_P, _I, _P, _P, _I, _I, _I, _I, _P],
        "am_cluster_chunks": [],
        "am_zero_scan": [_P, _P, _I, _P, _P, _L, _I, _I, _L, _P, _P, _P,
                         _P],
        "am_alloc_mapped": [_L, _PP],
        "am_free_mapped": [_P],
        "am_stream_wait": [_P],
    },
    "ssm_scan": {
        "ss_state_scatter": [_P, _I, _P, _P, _I, _P],
        "ss_ssd_step": [_P, _P, _P, _P, _P, _L, _P, _P, _P, _L, _P, _L, _P,
                        _P, _I, _I, _I, _I, _I, _P],
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card (CUDA toolkit on PATH or in "
                       "/usr/local/cuda)")


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of the source,
    every header in ``csrc/`` (``page_rows.cuh`` is shared) and the
    flags."""
    parts = [(CSRC / f"{name}.cu").read_bytes()]
    parts += [h.read_bytes() for h in sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha1(b"".join(parts)
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str) -> Tuple[subprocess.Popen, str]:
    """Start one nvcc into a temporary file beside the target; the
    caller renames it into place once it succeeded."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def build(names: Iterable[str] = SOURCES) -> float:
    """Compile every named source whose library is missing, one ``nvcc``
    per source, all started together.  Returns the wall seconds."""
    t0 = time.perf_counter()
    procs = [(n, *_start(n)) for n in names
             if not library_path(n).exists()]
    errors = []
    for name, proc, tmp in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            library_path(name).with_suffix(".log").write_text(log)
            os.replace(tmp, library_path(name))
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """nvcc's output (ptxas's report) for the current library of
    ``csrc/<name>.cu``, or "" if it was built before the log was kept."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a nonzero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
