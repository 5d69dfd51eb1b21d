"""FASTA read/write, SNP tables, and the restriction-site search on the card.

Counterpart of ``hichap_master_tpu/io/fasta.py``, with its names and
semantics.  The JAX package reads FASTA and SNP text line by line in
Python's text mode; the port scans blocks of lines with host C++
(``fastaparse_fasta`` / ``fastaparse_snps`` in ``csrc/fastaparse.cpp``,
built by ``kernels/_build.load_host``), quirk for quirk:

* lines end at ``\\n``, ``\\r`` or ``\\r\\n``; ``.gz`` files are inflated
  (``io.sam.inflate``);
* ``read_fasta``: a line starting with ``>`` is a header, named by
  ``strip_chr`` of its first whitespace-separated word (an empty header
  raises ``IndexError``, as ``split()[0]`` does); every other non-empty
  line is sequence, trailing blanks included; lines before the first
  header are dropped; a later record of the same name replaces an earlier
  one.  Text outside ASCII must be UTF-8 (the JAX package decodes it);
* ``parse_snp_file``: fields split on whitespace, lines of fewer than 5
  fields skipped, each chromosome's rows sorted stably by position.  A line
  holding a byte outside ASCII, or a position that is not a plain decimal
  integer, is parsed by Python as the JAX package parses it.

``read_fasta`` returns views into one host buffer (``read_fasta_flat``
gives the buffer itself; ``read_fasta_device`` fills one buffer on a
device, each block copied there while the next is scanned).  ``write_fasta`` wraps each chromosome at 60 columns as whole
buffers on the tensor's device.  ``find_sites`` runs on a uint8 tensor on
any device: ``a..z`` folded onto ``A..Z``, the ``len(site)`` shifted
compares ANDed, then ``nonzero`` (every offset, overlapping hits included).

``load_snps`` and ``_str_alleles`` are copies of the JAX package's
(``hichap_master_tpu/io/fasta.py:99-121``); ``snp_table`` puts one
haplotype's table on a device for ``pipeline.pairs.snps_match``.
"""

from __future__ import annotations

import os
import pickle
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, Iterator, Sequence, Tuple

import numpy as np
import torch

from ..core import strip_chr
from ..utils.logging import get_logger
from .bedio import _Labels, _ptr

log = get_logger(__name__)

POS_BITS = 40      # chromosome index << POS_BITS | position: one sorted key
READ_BYTES = 1 << 26          # bytes read per block


# ------------------------------------------------------------------ blocks
def _cut(buf: np.ndarray, end: int) -> int:
    """Where the last complete line of ``buf[:end]`` ends: after its last
    ``\\n``, or after a ``\\r`` that is not the last byte (0: none)."""
    hi = end
    while hi > 0:
        lo = max(0, hi - (1 << 16))
        w = buf[lo:hi]
        nl = np.flatnonzero(w == 10)
        cr = np.flatnonzero(w[:max(0, end - 1 - lo)] == 13)
        at = max(nl[-1] if nl.size else -1, cr[-1] if cr.size else -1)
        if at >= 0:
            return lo + int(at) + 1
        hi = lo
    return 0


def line_blocks(path: str) -> Iterator[memoryview]:
    """Blocks of complete lines of ``path`` (``.gz``: inflated): each block
    ends after a ``\\n``, ``\\r`` or ``\\r\\n``, the last one of the file
    excepted.  A plain file is read into one buffer that every block
    reuses (a block is valid until the next is asked for)."""
    if str(path).endswith(".gz"):
        from .sam import inflate

        carry = b""
        for piece in inflate(path):
            buf = carry + piece if carry else piece
            cut = max(buf.rfind(b"\n"), buf.rfind(b"\r", 0, len(buf) - 1)) + 1
            view = memoryview(buf)
            if cut:
                yield view[:cut]
            carry = bytes(view[cut:])
        if carry:
            yield memoryview(carry)
        return
    buf = np.empty(READ_BYTES, np.uint8)
    keep = 0
    with open(path, "rb", buffering=0) as f:
        while True:
            if keep == buf.size:                 # a line longer than it
                grown = np.empty(2 * buf.size, np.uint8)
                grown[:keep] = buf[:keep]
                buf = grown
            n = f.readinto(memoryview(buf)[keep:])
            if not n:
                break
            end = keep + n
            cut = _cut(buf, end)
            if cut:
                yield memoryview(buf)[:cut]
            keep = end - cut
            buf[:keep] = buf[cut:end].copy()
    if keep:
        yield memoryview(buf)[:keep]


def _array(view) -> np.ndarray:
    """A block as a uint8 array (one byte when empty, so it has an
    address)."""
    return (np.frombuffer(view, np.uint8) if len(view)
            else np.zeros(1, np.uint8))


def _check_utf8(view, path: str) -> None:
    """Raise as the JAX package's text mode does where a block is not
    UTF-8."""
    try:
        bytes(view).decode()
    except UnicodeDecodeError as e:
        raise UnicodeDecodeError(e.encoding, e.object, e.start, e.end,
                                 f"{e.reason} (in {path})") from None


# ------------------------------------------------------------------- FASTA
def read_fasta_device(path: str, device) -> Tuple[torch.Tensor,
                                                   Dict[str, Tuple[int, int]]]:
    """The sequences of a FASTA file as one uint8 buffer on ``device`` and,
    per chromosome (without ``chr``), its ``(begin, end)`` in the buffer.
    Each block is scanned into one of two reused host buffers (pinned for
    a CUDA device) and copied to the device while the next is scanned."""
    from ..kernels._build import load_host

    lib = load_host()
    device = torch.device(device)
    cuda = device.type == "cuda"
    size = os.path.getsize(path)
    gz = str(path).endswith(".gz")
    out = torch.empty(max(4 * size if gz else size, 1), dtype=torch.uint8,
                      device=device)
    stage = [None, None]
    done = [None, None]
    used, k = 0, 0
    spans: Dict[str, Tuple[int, int]] = {}
    name, begin = None, 0
    n_hdr, is_high = np.zeros(1, np.int64), np.zeros(1, np.int32)
    cap = 1024
    for view in line_blocks(path):
        k ^= 1
        if done[k] is not None:
            done[k].synchronize()
        if stage[k] is None or stage[k].numel() < len(view):
            stage[k] = torch.empty(max(len(view), READ_BYTES),
                                   dtype=torch.uint8, pin_memory=cuda)
        host = stage[k].numpy()
        buf = _array(view)
        while True:
            hs, he, at = (np.empty(cap, np.int64) for _ in range(3))
            n = lib.fastaparse_fasta(
                _ptr(buf), len(view), _ptr(host), _ptr(hs), _ptr(he),
                _ptr(at), cap, _ptr(n_hdr), _ptr(is_high))
            if n >= 0:
                break
            cap *= 2
        if is_high[0]:
            _check_utf8(view, path)
        for j in range(int(n_hdr[0])):
            at_j = used + int(at[j])
            if name is not None:
                spans[name] = (begin, at_j)
            header = bytes(view[int(hs[j]):int(he[j])]).decode()
            name, begin = strip_chr(header.split()[0]), at_j
        if used + n > out.numel():
            grown = torch.empty(max(2 * out.numel(), used + n),
                                dtype=torch.uint8, device=device)
            grown[:used] = out[:used]
            out = grown
        out[used:used + n].copy_(stage[k][:n], non_blocking=cuda)
        if cuda:
            done[k] = torch.cuda.Event()
            done[k].record()
        used += int(n)
    if name is not None:
        spans[name] = (begin, used)
    if cuda:
        torch.cuda.synchronize(device)
    return out[:used], spans


def read_fasta_flat(path: str) -> Tuple[np.ndarray, Dict[str, Tuple[int,
                                                                    int]]]:
    """The sequences of a FASTA file as one host uint8 buffer and, per
    chromosome (without ``chr``), its ``(begin, end)`` in the buffer."""
    flat, spans = read_fasta_device(path, "cpu")
    return flat.numpy(), spans


def read_fasta(path: str) -> Dict[str, np.ndarray]:
    """chrom (without 'chr') → uint8 sequence array (views of one
    buffer)."""
    flat, spans = read_fasta_flat(path)
    return {c: flat[b:e] for c, (b, e) in spans.items()}


def _host_tensor(seq) -> torch.Tensor:
    return seq if isinstance(seq, torch.Tensor) else torch.from_numpy(
        np.require(seq, np.uint8, ["C", "W"]))


def wrap(seq: torch.Tensor, width: int) -> torch.Tensor:
    """``seq`` cut into lines of ``width`` bytes, each followed by ``\\n``
    (the last line shorter), on ``seq``'s device."""
    n = seq.numel()
    full, rem = divmod(n, width)
    out = torch.empty(n + full + (rem > 0), dtype=torch.uint8,
                      device=seq.device)
    body = out[:full * (width + 1)].view(full, width + 1)
    body[:, :width] = seq[:full * width].view(full, width)
    body[:, width] = 10
    if rem:
        out[full * (width + 1):-1] = seq[full * width:]
        out[-1] = 10
    return out


def _header(c: str, n: int) -> bytes:
    return f">chr{c} dna:chromosome chromosome:HapHiC:1:1:{n}:1 REF\n".encode()


def _text_record(c: str, seq: torch.Tensor, width: int) -> bytes:
    """One record whose bytes are not all ASCII, formatted as the JAX
    package formats it: decoded, its length and lines counted in
    characters."""
    try:
        text = seq.cpu().numpy().tobytes().decode()
    except UnicodeDecodeError as e:
        raise ValueError(f"write_fasta: chromosome {c!r} is not UTF-8 text "
                         f"({e.reason} at byte {e.start})") from None
    lines = "".join(text[i:i + width] + "\n"
                    for i in range(0, len(text), width))
    return _header(c, len(text)) + lines.encode()


def write_fasta(path: str, chroms, line_width: int = 60) -> None:
    """Write with the reference's header style and 60-column wrap
    (``hichap_master_tpu/io/fasta.py:52-64``); ``chroms`` maps names to
    uint8 tensors (any device) or arrays.  Each record is wrapped on its
    device as one buffer; from a CUDA device it is copied into one of two
    reused pinned buffers while the other one's record is written."""
    if line_width == 0:
        raise ValueError("write_fasta: line_width must not be zero")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    seqs = {c: _host_tensor(chroms[c]) for c in chroms}
    cuda = [t.numel() for t in seqs.values() if t.is_cuda]
    width = max(line_width, 1)
    pinned = [torch.empty(max(cuda) + max(cuda) // width + 1,
                          dtype=torch.uint8, pin_memory=True)
              for _ in range(2)] if cuda else None
    with open(path, "wb") as f, ThreadPoolExecutor(1) as ex:
        pending = [None, None]
        k = 0
        for c in sorted(seqs):
            seq = seqs[c]
            k ^= 1
            if pending[k] is not None:
                pending[k].result()          # its buffer is free again
            if line_width < 0:          # the JAX package's range() is empty
                parts = [_header(c, seq.numel())]
            elif seq.numel() and bool((seq >= 128).any()):
                log.warning("write_fasta: chromosome %s of %s holds bytes "
                            "outside ASCII; it is formatted by Python on "
                            "the host", c, path)
                parts = [_text_record(c, seq, line_width)]
            elif seq.is_cuda:
                text = wrap(seq, line_width)
                host = pinned[k][:text.numel()]
                host.copy_(text)
                parts = [_header(c, seq.numel()), host.numpy()]
            else:
                parts = [_header(c, seq.numel()),
                         wrap(seq, line_width).numpy()]
            pending[k] = ex.submit(lambda ps: [f.write(p) for p in ps], parts)
        for p in pending:
            if p is not None:
                p.result()


# ------------------------------------------------------------------ SNPs
def _snp_rows_plain(line: str):
    """``parse_snp_file``'s rule for one line: None (skipped) or (chrom,
    pos, ref, m_alt, p_alt)."""
    p = line.split()
    if len(p) < 5:
        return None
    return strip_chr(p[0]), int(p[1]), p[2], p[3], p[4]


def _gather_spans(buf: np.ndarray, off: np.ndarray, ln: np.ndarray):
    """The spans ``buf[off:off+ln]`` one after the other: (bytes, their
    offsets in it)."""
    ln = ln.astype(np.int64)
    start = np.cumsum(ln) - ln
    total = int(ln.sum())
    idx = np.repeat(off - start, ln) + np.arange(total, dtype=np.int64)
    return buf[idx] if total else np.zeros(0, np.uint8), start


def _fixed(text: np.ndarray, off: np.ndarray, ln: np.ndarray) -> np.ndarray:
    """Byte spans as a numpy unicode column (``<U{longest}``, at least
    ``<U1``), as ``np.asarray`` of the strings gives it."""
    W = max(int(ln.max(initial=0)), 1)
    pos = off[:, None] + np.arange(W)
    keep = np.arange(W) < ln[:, None]
    mat = np.where(keep, text[np.where(keep, pos, 0)] if text.size else 0,
                   0).astype(np.uint8)
    return np.ascontiguousarray(mat).view(f"S{W}").ravel().astype("U")


def parse_snp_file(path: str) -> Dict[str, dict]:
    """5-column SNP TXT (chrom, pos, ref, m_alt, p_alt) → per-chrom sorted
    arrays (``hichap_master_tpu/io/fasta.py:67-89``)."""
    from ..kernels._build import load_host

    lib = load_host()
    labels = _Labels()
    ids, poss, texts, text_offs, lens, slows = [], [], [], [], [], []
    slow_rows: Dict[int, tuple] = {}
    base_row, base_text = 0, 0
    for view in line_blocks(path):
        raw = bytes(view)
        buf = _array(view)
        cap = raw.count(b"\n") + raw.count(b"\r") + 1
        chrom, pos = np.empty(cap, np.int32), np.empty(cap, np.int64)
        a_off, a_len = np.empty(3 * cap, np.int64), np.empty(3 * cap, np.int32)
        l_off, l_len = np.empty(cap, np.int64), np.empty(cap, np.int32)
        slow = np.empty(cap, np.int8)
        while True:
            n = lib.fastaparse_snps(
                _ptr(buf), len(raw), _ptr(labels.tab), labels.tab.size,
                _ptr(labels.off), _ptr(labels.len), labels.off.size,
                _ptr(labels.n), _ptr(chrom), _ptr(pos), _ptr(a_off),
                _ptr(a_len), _ptr(l_off), _ptr(l_len), _ptr(slow))
            if n >= 0:
                break
            labels.grow()
        for r in np.flatnonzero(slow[:n]):
            o, ln = int(l_off[r]), int(l_len[r])
            slow_rows[base_row + int(r)] = _snp_rows_plain(
                raw[o:o + ln].decode())
        text, starts = _gather_spans(buf, a_off[:3 * n], a_len[:3 * n])
        ids.append(chrom[:n])
        poss.append(pos[:n])
        texts.append(text)
        text_offs.append(starts + base_text)
        lens.append(a_len[:3 * n])
        slows.append(slow[:n])
        base_row += n
        base_text += text.size
    if slow_rows:
        log.warning("parse_snp_file: %d lines of %s (bytes outside ASCII or "
                    "positions that are no plain integers) are parsed by "
                    "Python", len(slow_rows), path)
    cat = lambda xs, t: np.concatenate(xs) if xs else np.zeros(0, t)  # noqa
    ids, pos = cat(ids, np.int32), cat(poss, np.int64)
    text, t_off = cat(texts, np.uint8), cat(text_offs, np.int64)
    t_len = cat(lens, np.int32).astype(np.int64)
    slow = cat(slows, np.int8).astype(bool)

    # rows -> stripped chromosome keys, in the order first met
    names = [strip_chr(s.decode()) for s in labels.strings()]
    key_of: Dict[str, int] = {}
    label_key = np.asarray([key_of.setdefault(c, len(key_of))
                            for c in names] + [-1], np.int64)
    key = label_key[ids]                 # ids of slow rows are -1 -> -1
    for r, row in slow_rows.items():
        key[r] = -1 if row is None else key_of.setdefault(row[0],
                                                          len(key_of))
    live = key >= 0
    first = {}
    for k, r in zip(*np.unique(key[live], return_index=True)):
        first[int(k)] = int(np.flatnonzero(live)[r])
    by_key = {k: c for c, k in key_of.items()}
    out = {}
    for k in sorted(first, key=first.get):
        rows = np.flatnonzero(key == k)
        slow_here = [int(r) for r in rows if slow[r]]
        p = pos[rows].copy()
        for r in slow_here:
            p[np.searchsorted(rows, r)] = slow_rows[r][1]
        order = np.argsort(p, kind="stable")
        rows, p = rows[order], p[order]
        cols = {"pos": p}
        for j, field in enumerate(("ref", "m_alt", "p_alt")):
            if slow_here:
                vals = [slow_rows[r][2 + j] if slow[r] else
                        text[t_off[3 * r + j]:t_off[3 * r + j]
                             + t_len[3 * r + j]].tobytes().decode()
                        for r in rows]
                cols[field] = np.asarray(vals)
            else:
                cols[field] = _fixed(text, t_off[3 * rows + j],
                                     t_len[3 * rows + j])
        out[by_key[k]] = cols
    return out


def save_snps(snps: Dict[str, dict], path: str) -> None:
    """Persist as npz (keys ``<chrom>/<field>``)."""
    flat = {}
    for c, d in snps.items():
        for k, v in d.items():
            flat[f"{c}/{k}"] = v
    np.savez_compressed(path, **flat)


def _str_alleles(d: dict) -> dict:
    """Allele columns as unicode: the reference's py2 pickle stores 'S1'
    bytes, and ``snps_match`` compares against str read bases — a bytes
    column made every SNP count silently zero in allelic mode."""
    return {k: (v.astype("U") if v.dtype.kind == "S" else v)
            for k, v in d.items()}


def load_snps(path: str) -> Dict[str, dict]:
    """Load our npz or the reference's ``Snps.pickle``."""
    if path.endswith(".pickle") or path.endswith(".pkl"):
        with open(path, "rb") as f:
            raw = pickle.load(f, encoding="latin1")
        return {
            c: _str_alleles({k: np.asarray(v) for k, v in d.items()})
            for c, d in raw.items()
        }
    data = np.load(path, allow_pickle=False)
    out: Dict[str, dict] = {}
    for key in data.files:
        c, field = key.split("/", 1)
        out.setdefault(c, {})[field] = data[key]
    return {c: _str_alleles(d) for c, d in out.items()}


# ------------------------------------------------------------ site search
def find_sites(seq: torch.Tensor, site: str) -> torch.Tensor:
    """0-based start positions (int64, on ``seq``'s device) of every
    occurrence of ``site`` in the uint8 tensor ``seq``, letters compared
    uppercase (``hichap_master_tpu/io/fasta.py:124-136``)."""
    s = site.encode()
    L, n = len(s), seq.numel()
    if n < L:
        return torch.zeros(0, dtype=torch.int64, device=seq.device)
    if L == 0:
        return torch.arange(n + 1, device=seq.device)
    up = seq - 32 * ((seq >= 97) & (seq <= 122)).to(torch.uint8)
    return match_starts(up, s)


def match_starts(seq: torch.Tensor, pattern: bytes) -> torch.Tensor:
    """0-based start positions (int64) of every occurrence of the non-empty
    ``pattern`` in the uint8 tensor ``seq``, bytes compared as they are,
    overlapping hits included: the ``len(pattern)`` shifted compares
    ANDed, then ``nonzero``."""
    L, n = len(pattern), seq.numel()
    if n < L:
        return torch.zeros(0, dtype=torch.int64, device=seq.device)
    m = n - L + 1
    hits = seq[:m] == pattern[0]
    for k in range(1, L):
        hits &= seq[k:k + m] == pattern[k]
    return torch.nonzero(hits).flatten()


def find_sites_plain(seq: np.ndarray, site: str) -> np.ndarray:
    """``find_sites`` in numpy, one chromosome on the host (a copy of the
    JAX package's; the plain version that the card is held to)."""
    s = np.frombuffer(site.encode(), dtype=np.uint8)
    L = len(s)
    if len(seq) < L:
        return np.zeros(0, np.int64)
    up = np.where((seq >= 97) & (seq <= 122), seq - 32, seq)
    hits = np.ones(len(seq) - L + 1, bool)
    for k in range(L):
        hits &= up[k:len(seq) - L + 1 + k] == s[k]
    return np.flatnonzero(hits).astype(np.int64)


# ------------------------------------------------------- SNPs on a device
@dataclass
class SnpTable:
    """One haplotype's SNPs on a device: ``key`` = chromosome index <<
    ``POS_BITS`` | 1-based position, sorted; ``alt`` the haplotype's allele
    as one byte, -1 where the allele is not one ASCII character (the JAX
    package compares a read base with the whole allele string, so such an
    allele never matches)."""

    key: torch.Tensor
    alt: torch.Tensor


def _alt_bytes(alleles: np.ndarray) -> np.ndarray:
    a = np.asarray(alleles).astype("U")
    one = np.char.str_len(a) == 1
    code = np.zeros(a.size, np.int64)
    if a.size:
        code = np.ascontiguousarray(a.astype("U1")).view(np.uint32).astype(
            np.int64)
    return np.where(one & (code < 128), code, -1).astype(np.int16)


def snp_table(snps: Dict[str, dict], labels: Sequence[str], allelic: str, *,
              device) -> SnpTable:
    """The positions of ``snps`` (``load_snps``) concatenated in the order
    of ``labels`` (chromosome i's SNPs under index i; a label that
    ``snps`` lacks has none) and the alt allele of ``allelic``
    (``m_alt`` for ``Maternal``, else ``p_alt``), on ``device``."""
    field = "m_alt" if allelic == "Maternal" else "p_alt"
    keys, alts = [np.zeros(0, np.int64)], [np.zeros(0, np.int16)]
    for i, c in enumerate(labels):
        if c not in snps:
            continue
        pos = np.asarray(snps[c]["pos"], np.int64)
        if pos.size and (pos.min() < 0 or pos.max() >= 1 << POS_BITS):
            raise ValueError(f"SNP positions of {c} outside [0, 2^40)")
        keys.append((np.int64(i) << POS_BITS) | pos)
        alts.append(_alt_bytes(snps[c][field]))
    return SnpTable(torch.from_numpy(np.concatenate(keys)).to(device),
                    torch.from_numpy(np.concatenate(alts)).to(device))
