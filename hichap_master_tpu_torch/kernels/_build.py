"""Build the CUDA kernels of ``csrc/`` and bind them with ctypes.

Every ``csrc/*.cu`` file exposes a plain C interface (``extern "C"``
functions that take raw device pointers, sizes and a ``cudaStream_t`` and
return the ``cudaError_t`` of their launch), so the sources build in
seconds with ``nvcc`` alone: no PyTorch headers, no extension machinery.

The library is built at first use into ``_build/`` next to the package
(listed in ``.gitignore``), named by a hash of the sources and flags, so an
edited source rebuilds and an unchanged one loads the cached ``.so``.  Each
source compiles in its own ``nvcc`` process, all started together, and the
objects are linked into one library.  A failed build raises with the
compiler's output.

The host scanners of ``csrc/bedparse.cpp``, ``csrc/samparse.cpp`` and
``csrc/fastaparse.cpp`` are not CUDA: they build with the host compiler (``$CXX`` or ``g++``) into a
library of their own (``host_library_path``), so that they build and load
where there is no ``nvcc``, and bind under ``HOST_SIGNATURES``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_Q = ctypes.c_int64
# C entry points -> argument types (pointers and the stream as c_void_p;
# every function returns the launch's cudaError_t as int, except
# ice_sweep_max_batch (a batch size), segment_marginal_tile (K7's pixels
# per tile), impute_vote_constant (K6's band rows, bitmap shift, shared
# budget and band scratch), exact_index_sub_tile (K8's positions a
# sub-tile), exact_hits_fixed_smem (K9's shared bytes besides reads) and
# exact_hits_scan_segment (the genome bytes a block of K9's scan stages))
SIGNATURES = {
    "ice_sweep": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _P],
    "ice_sweep_max_batch": [_I, _I],
    "ice_matvec": [_P, _P, _P, _P, _I, _I, _I, _P],
    "sparse_marginal": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "escalation_prefix": [_P, _P, _P, _P, _I, _I, _I, _P],
    "escalation_ladder": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _I, _I, _I, _P],
    "hmm_forward_backward": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             _P],
    "hmm_viterbi": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "impute_vote": [_P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _I, _I, _I,
                    _F, _F, _P, _P, _P, _P, _P],
    "impute_vote_constant": [_I, _I],
    "segment_marginal": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "segment_marginal_tile": [],
    "exact_index_hist": [_P, _Q, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
    "exact_index_partition": [_P, _Q, _P, _P, _I, _I, _I, _I, _I, _P, _P,
                              _P, _P, _P],
    "exact_index_bucket": [_P, _P, _P, _I, _I, _P, _P, _P, _P],
    "exact_index_sub_tile": [],
    "exact_hits": [_P, _Q, _P, _P, _I, _I, _P, _P, _P, _Q, _P, _P, _P, _Q,
                   _I, _I, _P, _P, _P, _P],
    "exact_hits_fixed_smem": [],
    "exact_hits_scan": [_P, _Q, _P, _P, _I, _P, _P, _P, _P, _I, _I, _P, _P,
                        _P],
    "exact_hits_scan_segment": [],
    "intra_bin": [_P, _P, _P, _P, _P, _P, _P, _I, _Q, _Q, _P, _P],
}


# host C entry points (csrc/bedparse.cpp, csrc/samparse.cpp) -> argument
# types; each returns a long: the rows kept (bedparse_valid,
# bedparse_allelic), the rows scanned or -1 for a full intern table
# (bedparse_record; samparse_sam, samparse_fragments, which give -2 for a
# line that fails), the records parsed or -2 (samparse_bam), the bytes
# written (bedparse_gather, bedparse_format, samparse_bam_encode,
# samparse_format_sam; -1 for a full buffer), the lines or records found
# (samparse_lines, fastaparse_reads; -1 past the capacity)
_L = ctypes.c_long
_S = ctypes.POINTER(ctypes.c_char_p)
HOST_SOURCE = CSRC_DIR / "bedparse.cpp"
HOST_SOURCES = (HOST_SOURCE, CSRC_DIR / "samparse.cpp",
                CSRC_DIR / "fastaparse.cpp")
HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
HOST_SIGNATURES = {
    "bedparse_valid": [ctypes.c_char_p, _L, _S, _I, _P, _P, _P, _P],
    "bedparse_allelic": [ctypes.c_char_p, _L, _S, _I, _I, _P, _P, _P, _P,
                         _P],
    "bedparse_record": [ctypes.c_char_p, _L, _L, _L, _P, _L, _P, _P, _I, _P,
                        _P, _P, _P, _P, _P, _P, _P, _P],
    "bedparse_gather": [_P, _P, _P, _P, _L, _P],
    "bedparse_format": [_L, _I, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _L],
    "samparse_sam": [ctypes.c_char_p, _L, _P, _L, _P, _P, _I, _P] + [_P] * 21,
    "samparse_bam": [_P, _L] + [_P] * 22,
    "samparse_bam_encode": [_L] + [_P] * 17 + [_L],
    "samparse_format_sam": [_L] + [_P] * 22 + [_L],
    "samparse_lines": [_P, _L, _P, _P, _P, _P, _P, _L],
    "samparse_fragments": [ctypes.c_char_p, _L, _P, _L, _P, _P, _I, _P, _P,
                           _P, _P],
    "fastaparse_fasta": [_P, _L, _P, _P, _P, _P, _L, _P, _P],
    "fastaparse_snps": [_P, _L, _P, _L, _P, _P, _I, _P] + [_P] * 7,
    "fastaparse_fastq": [_P, _L, ctypes.c_char_p, _L, _P, _L, _P, _P, _P,
                         _P, _P],
    "fastaparse_reads": [_P, _L, _P, _P, _P, _P, _P, _P, _L, _P],
}


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libhichap_kernels_{h.hexdigest()[:16]}.so"


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or under /usr/local/cuda)")


def build(path: Path, extra_flags: tuple = ()) -> str:
    """Compile every ``csrc/*.cu`` (one ``nvcc`` each, in parallel) and link
    them into one shared library at ``path``.  Returns the compilers'
    output (``extra_flags=("-Xptxas", "-v")`` makes it report registers and
    spills per kernel)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    nvcc = nvcc_path()
    jobs = []
    for src in (p for p in sources() if p.suffix == ".cu"):
        obj = tmp.with_name(f"{tmp.name}.{src.stem}.o")
        cmd = [nvcc, *NVCC_FLAGS, *extra_flags, "-c", "-o", str(obj),
               str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log = []
    try:
        for cmd, _, proc in jobs:
            out = proc.communicate()[0]
            log.append(out)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{out}")
        cmd = [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in jobs)]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {r.returncode}):\n"
                               f"{' '.join(cmd)}\n{r.stdout}\n{r.stderr}")
    finally:
        for _, obj, proc in jobs:
            proc.wait()
            obj.unlink(missing_ok=True)
    os.replace(tmp, path)
    return "".join(log) + r.stdout + r.stderr


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The kernel library, built on first call.  Raises if it cannot be
    built or lacks an entry point."""
    path = library_path()
    if not path.exists():
        build(path)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {name} failed: cudaError_t {rc}")


def stream_ptr(device) -> int:
    """The current CUDA stream of ``device`` as an integer handle."""
    return torch.cuda.current_stream(device).cuda_stream


def host_library_path() -> Path:
    h = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    for src in HOST_SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libhichap_host_{h.hexdigest()[:16]}.so"


def build_host(path: Path) -> str:
    """Compile ``HOST_SOURCES`` with the host compiler into ``path``.
    Raises with the compiler's output if it fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *HOST_FLAGS, "-o", str(tmp),
           *(str(src) for src in HOST_SOURCES)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"host compiler not found: {' '.join(cmd)}: {e}")
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"host build failed (exit {r.returncode}):\n"
                           f"{' '.join(cmd)}\n{r.stdout}{r.stderr}")
    os.replace(tmp, path)
    return r.stdout + r.stderr


_HOST_LOCK = threading.Lock()


def load_host() -> ctypes.CDLL:
    """The host scanner library, built on first call.  Scanners run on
    several host threads (``bamProcess -t``): the first call builds once
    while the others wait."""
    with _HOST_LOCK:
        return _load_host()


@functools.lru_cache(maxsize=None)
def _load_host() -> ctypes.CDLL:
    path = host_library_path()
    if not path.exists():
        build_host(path)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in HOST_SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_long
    return lib
