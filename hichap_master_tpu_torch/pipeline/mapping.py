"""Mapping on the card: the aligner adapters and the retrying executors.

Counterpart of ``hichap_master_tpu/pipeline/mapping.py``, with its names,
semantics and outputs (SAM byte for byte; BAM by its inflated payload) and
one argument more, ``device`` (keyword, no default).

* ``RetryingExecutor`` runs tasks, validates each expected output (missing
  or under ``min_bytes``, 100 by default, counts as failed), logs a task
  that raises, and runs the failed ones again until none fails or
  ``max_retries`` is spent (``RuntimeError``, the JAX text).  Tasks run on
  ``workers`` host threads, never in processes of their own: a process per
  task would start CUDA and build an index each.  Tasks of an aligner that
  works on the card (``FakeAligner``) run in the calling thread, index by
  index: one index is built, every chunk is mapped against it, it is freed
  and the next one is built.
* ``PBSExecutor``, ``pbs_mapping`` and ``pbs_rescue_mapping`` are the JAX
  package's (the qsub one-liner, the throttle on queued jobs, the drain
  that needs two empty readings, the resubmit); bowtie2's raw SAM is
  written by the jobs, headers included and not name-sorted.
* ``Bowtie2Aligner`` runs ``bowtie2 -x <index> -p <threads> -U <fq> -S
  <tmp>``, then orders the lines by read name as the JAX package's native
  ``hicio_sam_sort_merge`` does (unsigned bytes of QNAME up to the first
  tab, a name that is a prefix of another first, ties in line order;
  ``@`` lines dropped) and writes them unchanged, each followed by
  ``\\n``: host C++ finds the lines and names (``samparse_lines``), the
  names sort on the card as words (``columns.name_words`` +
  ``lex_order``), the host gathers the lines (``bedparse_gather``).
* ``FakeAligner`` maps each read exactly, as the JAX package's does: the
  genome upper-cased, the read not; a hit is an exact occurrence of the
  whole read inside one chromosome, overlapping ones included; the first
  hit is the first forward one (chromosomes in the genome's order, then
  position), else the first reverse-complement one; two hits or more
  (forward and reverse counted apart) set ``XS:i:0``.  ``max_hits`` keeps
  its meaning: 0 gives one hit at most (never XS), below 0 none.  The
  genome is indexed on the card (K8, ``kernels/exact_index.py``) and every
  read of a chunk is searched at once (K9, ``kernels/exact_hits.py``);
  records are ordered by name (Python's ``str`` order, stable) on the card
  and written by host C++ (``io.sam.write_sam``).  The FASTQ is read by
  ``fastaparse_reads`` with ``_read_fastq``'s rules: Python's text-mode
  line ends, the header's first word after its first byte, SEQ and QUAL
  stripped, a record cut short with empty fields, a header without a word
  raising ``IndexError``.  Text outside ASCII (where the JAX package's
  ``str.upper`` and ``str.find`` work on characters) raises
  ``ValueError``.

``walls`` (a dict) gets the synchronised seconds of each step under
``<tag>.<step>``: ``index`` (the FASTA read and K8), ``read`` (the FASTQ),
``search`` (K9; bowtie2's run for ``Bowtie2Aligner``), ``sort`` and
``write``.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import strip_chr
from ..io.bedio import _ptr
from ..io.sam import Alignments, write_sam
from ..utils.logging import get_logger
from .columns import lex_order, name_words, step, upload

log = get_logger(__name__)

MIN_OUTPUT_BYTES = 100  # outputs smaller than this count as failed
GATHER_LINES = 1 << 20  # sorted SAM lines gathered and written at a time
READ_AHEAD = 4          # FASTQs read (inflated, scanned) ahead on threads


# ------------------------------------------------------------- executors
@dataclass
class Task:
    fn: Callable
    args: tuple
    expected_output: str
    tries: int = 0


_FASTQ_SUFFIXES = (".fastq.gz", ".fastq", ".fq.gz", ".fq")


def _output_ok(path: str, min_bytes: int = MIN_OUTPUT_BYTES) -> bool:
    return os.path.exists(path) and os.path.getsize(path) >= min_bytes


class RetryingExecutor:
    """Tasks on ``workers`` host threads (1: in the calling thread, in
    order), their outputs validated, the failed ones run again."""

    def __init__(self, workers: int = 4, max_retries: int = 3,
                 min_bytes: int | None = None):
        self.workers = workers
        self.max_retries = max_retries
        # rescue outputs may legitimately be tiny (few unmapped reads):
        # min_bytes=0 validates existence only
        self.min_bytes = MIN_OUTPUT_BYTES if min_bytes is None else min_bytes

    @staticmethod
    def _attempt(t: Task) -> None:
        try:
            t.fn(*t.args)
        except Exception as e:  # noqa: BLE001
            log.warning("task for %s raised: %s", t.expected_output, e)

    def run(self, tasks: List[Task]) -> None:
        pending = list(tasks)
        while pending:
            if self.workers <= 1:
                for t in pending:
                    self._attempt(t)
            else:
                with ThreadPoolExecutor(self.workers) as ex:
                    list(ex.map(self._attempt, pending))
            failed = [t for t in pending if not self._ok(t.expected_output)]
            for t in failed:
                t.tries += 1
                if t.tries > self.max_retries:
                    raise RuntimeError(
                        f"mapping output {t.expected_output} still failing "
                        f"after {self.max_retries} retries")
            if failed:
                log.log(21, "resubmitting %d failed mapping task(s)",
                        len(failed))
            pending = failed

    def _ok(self, path: str) -> bool:
        return _output_ok(path, self.min_bytes)


class PBSExecutor:
    """qsub/qstat batch backend: tasks become shell one-liners submitted
    with qsub; submission throttles on the number of queued jobs with the
    given name; outputs validate and resubmit as in WS mode."""

    def __init__(self, num_task: int = 20, mem_gb: int = 10,
                 poll_s: float = 5.0, max_retries: int = 3,
                 qsub: str = "qsub", qstat: str = "qstat"):
        self.num_task = num_task
        self.mem_gb = mem_gb
        self.poll_s = poll_s
        self.max_retries = max_retries
        self.qsub = qsub
        self.qstat = qstat

    def available(self) -> bool:
        return shutil.which(self.qsub) is not None

    def _job_count(self, keyword: str) -> int:
        import xml.etree.ElementTree as ET

        try:
            out = subprocess.run([self.qstat, "-xl"], capture_output=True,
                                 text=True, check=False).stdout
            root = ET.fromstring(out)
        except Exception:  # noqa: BLE001
            return 0
        return sum(1 for j in root if keyword in
                   (j.findtext("Job_Name") or ""))

    def submit_shell(self, cmd: str, name: str, threads: int,
                     log_dir: str) -> None:
        script = (f'echo "{cmd}" | {self.qsub} -N {name} '
                  f"-l nodes=1:ppn={threads} -l mem={self.mem_gb}gb -d ./ "
                  f"-e {log_dir} -o {log_dir}")
        # wait until qsub has accepted the job, so that the drain below
        # cannot poll before the job is queued
        subprocess.run(script, shell=True, capture_output=True, check=False)

    def run_shell_tasks(self, cmds: List[Tuple[str, str]], name: str,
                        threads: int, log_dir: str) -> None:
        """cmds: (shell command, expected output).  Throttle, drain,
        validate, resubmit until clean."""
        pending = list(cmds)
        retries = 0
        while pending:
            for cmd, _out in pending:
                while self._job_count(name) >= self.num_task:
                    time.sleep(self.poll_s)
                self.submit_shell(cmd, name, threads, log_dir)
            # drain: TWO consecutive zero readings, since _job_count reads
            # 0 on a transient qstat error too
            zeros = 0
            while zeros < 2:
                zeros = zeros + 1 if self._job_count(name) <= 0 else 0
                time.sleep(self.poll_s)
            failed = [(c, o) for c, o in pending if not _output_ok(o)]
            if failed:
                retries += 1
                if retries > self.max_retries:
                    raise RuntimeError(
                        f"{len(failed)} PBS mapping task(s) still failing")
                log.log(21, "PBS: resubmitting %d failed task(s)", len(failed))
            pending = failed


# ----------------------------------------------------------------- input
def _file_bytes(path: str) -> np.ndarray:
    """The bytes of ``path`` (``.gz``: inflated) as one uint8 array."""
    if str(path).endswith(".gz"):
        from ..io.sam import inflate
        return np.frombuffer(bytearray(b"".join(inflate(path))), np.uint8)
    return np.fromfile(path, np.uint8)


@dataclass
class Reads:
    """A FASTQ's reads as spans of its text ``buf`` (offsets int64, lengths
    int32)."""

    buf: np.ndarray
    name_off: np.ndarray
    name_len: np.ndarray
    seq_off: np.ndarray
    seq_len: np.ndarray
    qual_off: np.ndarray
    qual_len: np.ndarray

    def __len__(self) -> int:
        return len(self.name_off)


def read_reads(path: str) -> Reads:
    """The reads of a FASTQ (``.gz`` too) by ``_read_fastq``'s rules
    (``hichap_master_tpu/pipeline/mapping.py:174-185``; host C++
    ``fastaparse_reads``)."""
    from ..kernels._build import load_host

    buf = _file_bytes(path)
    n_lines = int(np.count_nonzero(buf == 10) + np.count_nonzero(buf == 13))
    cap = n_lines // 4 + 2
    cols = [np.empty(cap, t) for t in (np.int64, np.int32) * 3]
    bad = np.zeros(1, np.int64)
    src = buf if buf.size else np.zeros(1, np.uint8)
    n = load_host().fastaparse_reads(_ptr(src), buf.size,
                                     *(_ptr(c) for c in cols), cap, _ptr(bad))
    if n == -2:
        raise IndexError(f"{path}: record {int(bad[0]) + 1} has a header "
                         "without a name (list index out of range)")
    if n == -3:
        raise ValueError(f"{path}: record {int(bad[0]) + 1} holds a byte "
                         "outside ASCII; FakeAligner on the card maps ASCII "
                         "text only")
    if n < 0:
        raise RuntimeError("fastaparse_reads: more records than lines / 4")
    return Reads(buf, *(c[:n] for c in cols))


class _ReadAhead:
    """The FASTQs of the coming tasks, in order, read by ``read_reads`` on
    ``ahead`` host threads while the card maps the current one (zlib and
    the scanner release the interpreter lock)."""

    def __init__(self, paths: Sequence[str], ahead: int = READ_AHEAD):
        self.queue = list(paths)
        self.ex = ThreadPoolExecutor(ahead)
        self.ahead = ahead
        self.pending: List[Tuple[str, object]] = []
        self._fill()

    def _fill(self) -> None:
        while self.queue and len(self.pending) < self.ahead:
            path = self.queue.pop(0)
            self.pending.append((path, self.ex.submit(read_reads, path)))

    def get(self, path: str) -> "Reads":
        """The reads of ``path``: the next one read ahead where it is that
        path, else read now."""
        if self.pending and self.pending[0][0] == path:
            _, fut = self.pending.pop(0)
            self._fill()
            return fut.result()
        return read_reads(path)

    def close(self) -> None:
        self.queue.clear()
        for _, fut in self.pending:
            fut.cancel()
        self.ex.shutdown(wait=True)


def _name_order(names: torch.Tensor, off: torch.Tensor,
                ln: torch.Tensor) -> torch.Tensor:
    """The stable order of names by their unsigned bytes, a name before
    the names it is a prefix of (on the names' device)."""
    if not len(off):
        return torch.zeros(0, dtype=torch.int64, device=off.device)
    W = max(1, (int(ln.max()) + 7) // 8)
    lnl = ln.long()
    return lex_order(name_words(names, off, lnl, W) + [lnl])


# -------------------------------------------------------------- aligners
class Bowtie2Aligner:
    """bowtie2 as a subprocess, its SAM ordered by read name on the
    card."""

    def __init__(self, bowtie2: str = "bowtie2", threads: int = 4, *,
                 device):
        self.bowtie2 = bowtie2
        self.threads = threads
        self.device = torch.device(device)

    def available(self) -> bool:
        return shutil.which(self.bowtie2) is not None

    def map_chunk(self, index: str, fq: str, out_sam: str,
                  walls=None) -> str:
        tmp = out_sam + ".unsorted"
        cmd = [self.bowtie2, "-x", index, "-p", str(self.threads), "-U", fq,
               "-S", tmp]
        with step(walls, "search", self.device):
            subprocess.run(cmd, check=True, capture_output=True)
        sort_sam_lines(tmp, out_sam, device=self.device, walls=walls)
        os.remove(tmp)
        return out_sam


def sort_sam_lines(src: str, dst: str, *, device, walls=None) -> None:
    """The body lines of the SAM text ``src`` (``@`` lines dropped) into
    ``dst`` in ``hicio_sam_sort_merge``'s order (``native/hicio.cpp:
    239-255`` of the JAX package): lines as ``std::getline`` reads them
    (``\\n`` ends a line, a ``\\r`` before it stays; an empty line is a
    record with an empty name), ordered by the unsigned bytes of the name
    up to the first tab, a prefix first, ties in line order; each written
    as read, followed by ``\\n``."""
    from ..kernels._build import load_host

    lib = load_host()
    with step(walls, "read", device):
        text = np.fromfile(src, np.uint8)
        cap = int(np.count_nonzero(text == 10)) + 1
        line_off = np.empty(cap, np.int64)
        line_len = np.empty(cap, np.int32)
        names = np.empty(max(text.size, 1), np.uint8)
        name_off = np.empty(cap, np.int64)
        name_len = np.empty(cap, np.int32)
        src_buf = text if text.size else np.zeros(1, np.uint8)
        n = lib.samparse_lines(_ptr(src_buf), text.size, _ptr(line_off),
                               _ptr(line_len), _ptr(names), _ptr(name_off),
                               _ptr(name_len), cap)
        if n < 0:
            raise RuntimeError("samparse_lines: more lines than newlines")
        line_off, line_len = line_off[:n], line_len[:n]
        used = int(name_off[n - 1] + name_len[n - 1]) if n else 0
    with step(walls, "sort", device):
        order = _name_order(upload(names[:max(used, 1)], device),
                            upload(name_off[:n], device),
                            upload(name_len[:n], device)).cpu().numpy()
    with step(walls, "write", device), open(dst, "wb") as f:
        for s in range(0, n, GATHER_LINES):
            rows = np.ascontiguousarray(order[s:s + GATHER_LINES])
            size = int(line_len[rows].sum()) + len(rows)
            out = np.empty(max(size, 1), np.uint8)
            m = lib.bedparse_gather(_ptr(src_buf), _ptr(line_off),
                                    _ptr(line_len), _ptr(rows), len(rows),
                                    _ptr(out))
            f.write(memoryview(out)[:m])


def _ascii_upper(s) -> bytes:
    """``s.upper()`` as bytes; text outside ASCII raises ``ValueError``."""
    if isinstance(s, (bytes, bytearray)):
        b = bytes(s)
        if not b.isascii():
            raise ValueError("FakeAligner on the card maps ASCII genomes "
                             "only")
        return b.upper()
    try:
        return s.upper().encode("ascii")
    except UnicodeEncodeError:
        raise ValueError("FakeAligner on the card maps ASCII genomes "
                         "only") from None


class FakeAligner:
    """Deterministic exact-match aligner (see the module's docstring), its
    search on ``device``."""

    in_process = True             # tasks run in the calling thread

    def __init__(self, genome: Optional[Dict[str, str]] = None,
                 max_hits: int = 4, *, device):
        self.genome = ({strip_chr(c): _ascii_upper(s) for c, s in
                        genome.items()} if genome else None)
        self.max_hits = max_hits
        self.device = torch.device(device)
        self._index = None            # (key, ExactIndex, chromosome names)
        self._ahead: Optional[_ReadAhead] = None

    @classmethod
    def from_fasta(cls, path: str, *, device) -> "FakeAligner":
        from ..io.fasta import read_fasta
        return cls({c: a.tobytes() for c, a in read_fasta(path).items()},
                   device=device)

    def _build(self, flat: torch.Tensor, spans: Dict[str, Tuple[int, int]]):
        """The index of the chromosomes ``spans`` (in order) of ``flat``,
        upper-cased and laid one after the other."""
        from ..kernels.exact_index import exact_index, index_k

        dev = self.device
        order = list(spans.values())
        starts = [b for b, _ in order]
        if order and starts[0] == 0 and all(
                order[i][1] == order[i + 1][0] for i in range(len(order) - 1)):
            genome = flat[:order[-1][1]]
        else:
            genome = torch.cat([flat[b:e] for b, e in order]) if order else \
                flat[:0]
        if genome.numel() and bool((genome >= 128).any()):
            raise ValueError("FakeAligner on the card maps ASCII genomes "
                             "only")
        genome = genome.contiguous()
        genome.sub_(((genome >= 97) & (genome <= 122)).to(torch.uint8) * 32)
        lens = torch.tensor([e - b for b, e in order], dtype=torch.int64)
        end = torch.cumsum(lens, 0)
        start = end - lens
        if not len(order) or not genome.numel():
            return None
        return exact_index(genome, start.to(dev), end.to(dev),
                           index_k(genome.numel()))

    def _index_for(self, index, walls=None):
        """The (ExactIndex or None, chromosome names) of ``index``: the
        fixed genome, or the FASTA at ``index``; one at a time on the
        card."""
        key = None if self.genome is not None else str(index)
        if self._index is not None and self._index[0] == key:
            return self._index[1:]
        self._index = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        with step(walls, "index", self.device):
            if self.genome is not None:
                names = list(self.genome)
                data = b"".join(self.genome[c] for c in names)
                flat = upload(np.frombuffer(bytearray(data or b"\0"),
                                            np.uint8), self.device)
                at = np.cumsum([0] + [len(self.genome[c]) for c in names])
                spans = {c: (int(at[i]), int(at[i + 1]))
                         for i, c in enumerate(names)}
            else:
                from ..io.fasta import read_fasta_device
                flat, spans = read_fasta_device(key, self.device)
                names = list(spans)
            ix = self._build(flat, spans)
            del flat
        if ix is not None:
            size = sum(t.numel() * t.element_size()
                       for t in (ix.genome, ix.bucket, ix.pos, ix.side))
            log.log(21, "index of %s: %d bases, k %d, %d windows, %d side, "
                    "%.3f GB", key or "the genome", ix.genome.numel(), ix.k,
                    len(ix.pos), len(ix.side), size / 1e9)
        self._index = (key, ix, names)
        return ix, names

    def read_ahead(self, paths: Optional[Sequence[str]]) -> None:
        """Read the FASTQs ``paths`` (the coming calls' ``fq``, in order)
        ahead on host threads; None stops."""
        if self._ahead is not None:
            self._ahead.close()
        self._ahead = _ReadAhead(paths) if paths else None

    def map_chunk(self, index: str, fq: str, out_sam: str,
                  walls=None) -> str:
        from ..kernels.exact_hits import exact_hits

        dev = self.device
        ix, names = self._index_for(index, walls)
        with step(walls, "read", dev):
            rd = self._ahead.get(fq) if self._ahead else read_reads(fq)
            R = len(rd)
            buf = upload(rd.buf if rd.buf.size else np.zeros(1, np.uint8),
                         dev)
            seq_off = upload(rd.seq_off, dev)
            seq_len = upload(rd.seq_len, dev)
        with step(walls, "search", dev):
            if ix is not None and self.max_hits >= 0 and R:
                hit, count = exact_hits(ix, buf, seq_off, seq_len)
                hit, count = hit.view(R, 2), count.view(R, 2).long()
                fwd = count[:, 0] > 0
                total = count.sum(1)
                mapped = total > 0
                g = torch.where(fwd, hit[:, 0], hit[:, 1])
                chrom = (torch.searchsorted(ix.start, g, right=True) - 1
                         ).clamp(min=0)
                pos = torch.where(mapped, g - ix.start[chrom], -1)
                chrom = torch.where(mapped, chrom, -1)
                rev = mapped & ~fwd
                multi = mapped & (total >= 2) & (self.max_hits >= 1)
            else:
                mapped = rev = multi = torch.zeros(R, dtype=torch.bool,
                                                   device=dev)
                pos = chrom = torch.full((R,), -1, dtype=torch.int64,
                                         device=dev)
        with step(walls, "sort", dev):
            order = _name_order(buf, upload(rd.name_off, dev),
                                upload(rd.name_len, dev))
            cols = [t.cpu().numpy() for t in (order, mapped, rev, multi,
                                               pos, chrom)]
        with step(walls, "write", dev):
            order, mapped, rev, multi, pos, chrom = cols
            zeros = np.zeros(R, np.int64)
            aln = Alignments(
                names=rd.buf, name_off=rd.name_off, name_len=rd.name_len,
                base_len=np.zeros(R, np.int32), tag=np.zeros(R, np.int8),
                last=np.zeros(R, np.int8),
                flag=np.where(mapped, np.where(rev, 16, 0), 4).astype(
                    np.int32),
                ref=chrom.astype(np.int32), pos=pos.astype(np.int64),
                qlen=rd.seq_len, seqs=rd.buf, seq_off=rd.seq_off,
                seq_len=rd.seq_len, tag_as=zeros, tag_xs=zeros,
                has=(mapped.astype(np.int8) | (2 * multi).astype(np.int8)),
                refs=[c.encode() for c in names], quals=rd.buf,
                qual_off=rd.qual_off, qual_len=rd.qual_len)
            write_sam(out_sam, aln, mapq=np.where(mapped, 42, 0),
                      rows=order, rev=rev)
        return out_sam


# ---------------------------------------------------------------- driver
def _map_one(aligner, index: str, fq: str, out_sam: str,
             walls=None) -> str:
    return aligner.map_chunk(index, fq, out_sam, walls)


def _map_one_bam(aligner, index: str, fq: str, out_bam: str,
                 walls=None) -> str:
    """Map to name-sorted SAM, then store the chunk as BGZF BAM
    (``io.bam.sam_to_bam``); the temporary SAM is removed."""
    from ..io.bam import sam_to_bam
    tmp_sam = out_bam[:-4] + ".tobam.tmp"
    aligner.map_chunk(index, fq, tmp_sam, walls)
    tmp_bam = out_bam + ".tmp"
    with step(walls, "write", getattr(aligner, "device", "cpu")):
        sam_to_bam(tmp_sam, tmp_bam)
    os.replace(tmp_bam, out_bam)
    os.remove(tmp_sam)
    return out_bam


def _run_tasks(tasks: List[Task], tags: List[str], workers: int,
               min_bytes, walls) -> None:
    """The tasks (args: aligner, index, FASTQ, output, step walls) through
    ``RetryingExecutor``: in the calling thread, index by index (in order
    of first use), where every aligner works on the card; else on
    ``workers`` threads.  Each task's step walls are summed into ``walls``
    under its tag."""
    tag_of = {id(t): tag for t, tag in zip(tasks, tags)}
    ahead = []
    if all(getattr(t.args[0], "in_process", False) for t in tasks):
        first: Dict[str, int] = {}
        for t in tasks:
            first.setdefault(str(t.args[1]), len(first))
        tasks = sorted(tasks, key=lambda t: first[str(t.args[1])])
        workers = 1
        for al in {id(t.args[0]): t.args[0] for t in tasks}.values():
            al.read_ahead([t.args[2] for t in tasks if t.args[0] is al])
            ahead.append(al)
    try:
        RetryingExecutor(workers=workers, min_bytes=min_bytes).run(tasks)
    finally:
        for al in ahead:
            al.read_ahead(None)
    if walls is not None:
        for t in tasks:
            for k, v in t.args[4].items():
                name = f"{tag_of[id(t)]}.{k}" if tag_of[id(t)] else k
                walls[name] = walls.get(name, 0.0) + v


def ws_mapping(fastq_dir: str, out_dir: str, indexes: Sequence[str],
               aligner=None, threads: int = 16, jobs: int = 4,
               index_tags: Optional[Sequence[str]] = None,
               out_format: str = "sam", *, device,
               walls=None) -> List[str]:
    """WS-mode mapping of every chunk FASTQ (``chunk`` in the name, a
    FASTQ suffix) against each index: ``<stem>_<tag>.<out_format>`` in
    ``out_dir``, the tags ``Maternal``/``Paternal`` for two indexes, else
    each index's basename."""
    if out_format not in ("sam", "bam"):
        raise ValueError(f"out_format must be 'sam' or 'bam', "
                         f"got {out_format!r}")
    os.makedirs(out_dir, exist_ok=True)
    if aligner is None:
        aligner = Bowtie2Aligner(threads=max(1, threads // jobs),
                                 device=device)
    chunks = sorted(f for f in os.listdir(fastq_dir)
                    if "chunk" in f and f.endswith(_FASTQ_SUFFIXES))
    if not chunks:
        raise FileNotFoundError(
            f"no chunk FASTQs ({'/'.join(_FASTQ_SUFFIXES)}) under "
            f"{fastq_dir} — run rebuildF first or check the directory")
    if index_tags is None:
        if len(indexes) == 2:
            index_tags = ("Maternal", "Paternal")
        else:
            index_tags = tuple(os.path.basename(str(i)) for i in indexes)

    map_fn = _map_one_bam if out_format == "bam" else _map_one
    tasks, tags, outs = [], [], []
    for f in chunks:
        fq = os.path.join(fastq_dir, f)
        stem = f.split(".")[0]
        for idx, tag in zip(indexes, index_tags):
            out_aln = os.path.join(out_dir, f"{stem}_{tag}.{out_format}")
            tasks.append(Task(map_fn, (aligner, idx, fq, out_aln, {}),
                              out_aln))
            tags.append(tag)
            outs.append(out_aln)
    _run_tasks(tasks, tags, jobs, None, walls)
    log.log(21, "WS mapping: %d task(s) complete", len(tasks))
    return outs


def _rescue_jobs(rescue_dir: str, out_dir: str, index_by_tag):
    """(fq_path, out_sam, index, tag) for every ``*_<tag>_unmapped.fq`` —
    the one enumeration both rescue backends share."""
    jobs = []
    for f in sorted(os.listdir(rescue_dir)):
        if not f.endswith("_unmapped.fq"):
            continue
        stem = f.removesuffix("_unmapped.fq")
        tag = next((t for t in index_by_tag if t and t in f), "")
        jobs.append((os.path.join(rescue_dir, f),
                     os.path.join(out_dir, stem + ".sam"),
                     index_by_tag[tag], tag))
    return jobs


def ws_rescue_mapping(rescue_dir: str, out_dir: str,
                      index_by_tag: Dict[str, object],
                      aligner_by_tag: Optional[Dict[str, object]] = None,
                      aligner=None, jobs: int = 4,
                      out_format: str = "sam", *, device,
                      walls=None) -> List[str]:
    """Re-map rescue FASTQs, each against its own genome: ``index_by_tag``
    maps a file-name tag (``Maternal``/``Paternal``, or "" for one index)
    to the index; ``*_<tag>_unmapped.fq`` gives ``*_<tag>.sam`` (or
    ``.bam``).  Outputs only have to exist (``min_bytes=0``)."""
    if out_format not in ("sam", "bam"):
        raise ValueError(f"out_format must be 'sam' or 'bam', "
                         f"got {out_format!r}")
    os.makedirs(out_dir, exist_ok=True)
    map_fn = _map_one_bam if out_format == "bam" else _map_one
    tasks: List[Task] = []
    outs: List[str] = []
    tags = []
    for fq, out_sam, idx, tag in _rescue_jobs(rescue_dir, out_dir,
                                              index_by_tag):
        if out_format == "bam":
            out_sam = out_sam[:-4] + ".bam"
        al = (aligner_by_tag or {}).get(tag, aligner)
        if al is None:
            al = Bowtie2Aligner(device=device)
        tags.append(tag)
        tasks.append(Task(map_fn, (al, idx, fq, out_sam, {}), out_sam))
        outs.append(out_sam)
    _run_tasks(tasks, tags, jobs, 0, walls)
    log.log(21, "rescue mapping: %d file(s)", len(tasks))
    return outs


def pbs_rescue_mapping(rescue_dir: str, out_dir: str,
                       index_by_tag: Dict[str, str], cell: str,
                       bowtie2: str = "bowtie2", threads: int = 4,
                       num_task: int = 20, mem_gb: int = 10,
                       log_dir: Optional[str] = None,
                       qsub: str = "qsub", qstat: str = "qstat") -> List[str]:
    """PBS-submitted rescue re-mapping: each ``*_<tag>_unmapped.fq`` maps
    against its own genome, with the same throttle/validate/resubmit loop
    as global mapping."""
    os.makedirs(out_dir, exist_ok=True)
    log_dir = log_dir or out_dir
    ex = PBSExecutor(num_task=num_task, mem_gb=mem_gb, poll_s=0.5,
                     qsub=qsub, qstat=qstat)
    if not ex.available():
        raise RuntimeError("qsub not found; use WS mode")
    cmds = []
    for fq, out_sam, idx, _tag in _rescue_jobs(rescue_dir, out_dir,
                                               index_by_tag):
        cmds.append((f"{bowtie2} -x {idx} -p {threads} -U {fq} -S {out_sam}",
                     out_sam))
    ex.run_shell_tasks(cmds, cell, threads, log_dir)
    return [o for _, o in cmds]


def pbs_mapping(fastq_dir: str, out_dir: str, indexes: Sequence[str],
                cell: str, bowtie2: str = "bowtie2",
                threads: int = 4, num_task: int = 20, mem_gb: int = 10,
                log_dir: Optional[str] = None,
                index_tags: Optional[Sequence[str]] = None) -> List[str]:
    """PBS-mode mapping.  Requires qsub/qstat."""
    os.makedirs(out_dir, exist_ok=True)
    log_dir = log_dir or out_dir
    ex = PBSExecutor(num_task=num_task, mem_gb=mem_gb)
    if not ex.available():
        raise RuntimeError("qsub not found; use WS mode")
    if index_tags is None:
        index_tags = (("Maternal", "Paternal") if len(indexes) == 2
                      else tuple(os.path.basename(str(i)) for i in indexes))
    chunks = sorted(f for f in os.listdir(fastq_dir)
                    if "chunk" in f and f.endswith(_FASTQ_SUFFIXES))
    if not chunks:
        raise FileNotFoundError(
            f"no chunk FASTQs ({'/'.join(_FASTQ_SUFFIXES)}) under "
            f"{fastq_dir} — run rebuildF first or check the directory")
    cmds = []
    for f in chunks:
        fq = os.path.join(fastq_dir, f)
        stem = f.split(".")[0]
        for idx, tag in zip(indexes, index_tags):
            out_sam = os.path.join(out_dir, f"{stem}_{tag}.sam")
            cmd = f"{bowtie2} -x {idx} -p {threads} -U {fq} -S {out_sam}"
            cmds.append((cmd, out_sam))
    ex.run_shell_tasks(cmds, cell, threads, log_dir)
    return [o for _, o in cmds]
