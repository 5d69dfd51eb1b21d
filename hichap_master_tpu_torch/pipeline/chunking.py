"""FASTQ chunking with mate tagging, on the host.

Counterpart of ``hichap_master_tpu/pipeline/chunking.py`` (``split_reads``,
its semantics at ``:47-88``): a (possibly gzipped) FASTQ is cut into
``<prefix>_chunk{i}_{mate}.fastq.gz`` files of ``split_by`` reads, each
header written as its whitespace-separated words joined by single spaces
with ``_<mate>`` after the first word, the other three lines of a record as
read.  There is nothing here for the card to do: the stage reads, rewrites
headers and deflates, all on the host.

The input is read in blocks of lines (``io.fasta.line_blocks``: Python's
text-mode line ends ``\\n``, ``\\r``, ``\\r\\n``, written as ``\\n``) and
rewritten by host C++ (``fastaparse_fastq`` in ``csrc/fastaparse.cpp``); a
header holding a byte outside ASCII is split by Python, and text outside
ASCII must be UTF-8, as the JAX package's text mode requires.  The rules
the JAX package keeps are kept: a header that does not start with ``@``
(a blank line included) raises ``IOError``; a record cut short at the end
of the file is written as far as it goes; a chunk of 0 reads is removed.

The chunks are deflated in process, ``pigz`` or not on the PATH (the JAX
package pipes them through ``pigz -c -4`` when it is there):
``_GzipWriter`` deflates ``MEMBER_BYTES`` pieces at level ``LEVEL`` on
``io.sam.ZLIB_THREADS`` threads into one gzip member each, while the scan
goes on.  The decompressed bytes equal the JAX package's; the compressed
bytes do not (gzip headers differ).
"""

from __future__ import annotations

import collections
import os
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import List

import numpy as np

from ..io.bedio import _ptr
from ..io.fasta import _array, _check_utf8, line_blocks
from ..io.sam import ZLIB_THREADS
from ..utils.logging import get_logger

log = get_logger(__name__)

LEVEL = 4                  # the JAX package's gzip and pigz level
MEMBER_BYTES = 1 << 22     # uncompressed bytes per gzip member


def _member(data: bytes) -> bytes:
    co = zlib.compressobj(LEVEL, zlib.DEFLATED, 31)
    return co.compress(data) + co.flush()


class _GzipWriter:
    """A gzip file written as members of ``MEMBER_BYTES``, deflated on
    ``threads`` threads while the caller goes on (at most two members a
    thread in flight) and written in order."""

    def __init__(self, path: str, threads: int = ZLIB_THREADS):
        self.f = open(path, "wb")
        self.threads = threads
        self.ex = ThreadPoolExecutor(threads)
        self.pending = bytearray()
        self.queue = collections.deque()

    def write(self, data) -> None:
        self.pending += data
        while len(self.pending) >= MEMBER_BYTES:
            self._submit(bytes(self.pending[:MEMBER_BYTES]))
            del self.pending[:MEMBER_BYTES]

    def _submit(self, part: bytes) -> None:
        self.queue.append(self.ex.submit(_member, part))
        while len(self.queue) > 2 * self.threads:
            self.f.write(self.queue.popleft().result())

    def close(self) -> None:
        try:
            if self.pending:
                self._submit(bytes(self.pending))
            while self.queue:
                self.f.write(self.queue.popleft().result())
        finally:
            self.ex.shutdown()
            self.f.close()


def _header_plain(view, pos: int, mate) -> tuple:
    """The header line at ``view[pos:]`` rewritten by Python (its bytes
    are not all ASCII): (the line, where the next line starts)."""
    arr = np.frombuffer(view, np.uint8)
    end = len(arr)
    for lo in range(pos, end, 1 << 12):
        hit = np.flatnonzero((arr[lo:lo + (1 << 12)] == 10)
                             | (arr[lo:lo + (1 << 12)] == 13))
        if hit.size:
            end = lo + int(hit[0])
            break
    nxt = end + 1 + (end + 1 < len(arr) and arr[end] == 13
                     and arr[end + 1] == 10)
    toks = bytes(view[pos:end]).decode().split()
    toks[0] = f"{toks[0]}_{mate}"
    return (" ".join(toks) + "\n").encode(), min(nxt, len(arr))


def chunk_path(fq: str, folder: str, i: int, mate: int) -> str:
    """The path of chunk ``i`` of mate ``mate`` of ``fq`` in ``folder``:
    the cell prefix is the file name minus its trailing mate token, the
    chunk suffix the mate parameter (hichap_master_tpu/pipeline/
    chunking.py:50-56)."""
    base = os.path.split(fq)[1].split(".")[0].split("_")
    prefix = "_".join(base[:-1]) if len(base) > 1 else base[0]
    return os.path.join(folder, f"{prefix}_chunk{i}_{mate}.fastq.gz")


def stale_chunk(counts: List[int], split_by: int) -> bool:
    """Whether ``split_reads`` removes the chunk after the last one
    (chunk ``len(counts)``): the JAX package opens it when the last chunk
    is full, or when there is none, and removes it as empty."""
    return not counts or counts[-1] == split_by


def split_reads(fq: str, folder: str, split_by: int, mate: int) -> List[int]:
    """Split one mate file into chunks.  Returns per-chunk read counts."""
    from ..kernels._build import load_host

    os.makedirs(folder, exist_ok=True)
    path_of = lambda i: chunk_path(fq, folder, i, mate)  # noqa

    lib = load_host()
    mate_b = f"{mate}".encode()
    counts: List[int] = []
    state = np.zeros(1, np.int64)
    consumed, written, taken = (np.zeros(1, np.int64) for _ in range(3))
    is_high = np.zeros(1, np.int32)
    n, w = 0, None
    with open(fq, "rb"):
        pass                       # a missing input raises before any output
    try:
        for view in (line_blocks(fq) if split_by > 0 else ()):
            buf = _array(view)
            out = np.empty(len(view) + (len(view) // 4 + 2)
                           * (2 + len(mate_b)), np.uint8)
            pos, high = 0, False
            while pos < len(view):
                status = lib.fastaparse_fastq(
                    _ptr(buf[pos:]), len(view) - pos, mate_b, len(mate_b),
                    _ptr(state), split_by - n, _ptr(out), _ptr(consumed),
                    _ptr(written), _ptr(taken), _ptr(is_high))
                high = high or bool(is_high[0])
                if written[0]:
                    if w is None:
                        w = _GzipWriter(path_of(len(counts)))
                    w.write(memoryview(out[:int(written[0])]))
                n += int(taken[0])
                pos += int(consumed[0])
                if status == 1:            # the chunk is full
                    w.close()
                    w = None
                    counts.append(n)
                    n = 0
                elif status == 2:
                    raise IOError(f"{fq} is not a fastq file")
                elif status == 3:          # a header outside ASCII
                    line, pos = _header_plain(view, pos, mate)
                    if w is None:
                        w = _GzipWriter(path_of(len(counts)))
                    w.write(line)
                    n += 1
                    state[0] = 1
            if high:
                _check_utf8(view, fq)
    finally:
        if w is not None:
            w.close()
    if n:
        counts.append(n)
    if stale_chunk(counts, split_by) and os.path.exists(path_of(len(counts))):
        os.remove(path_of(len(counts)))    # the chunk opened at the end
    log.log(21, "split %s into %d chunks", fq, len(counts))
    return counts
