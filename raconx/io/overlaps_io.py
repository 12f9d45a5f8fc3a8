"""MHAP/PAF/SAM overlap parsing (plain or gzip) into an OverlapTable.

Pure-Python reference implementation (native C++ parser used when available).
Semantics mirror the reference record constructors:
  - MHAP: 1-based ids -> id-1; strand = a_rc ^ b_rc; error recomputed from
    spans (reference: src/overlap.cpp:15-27)
  - PAF: strand = (orientation == '-') (reference: src/overlap.cpp:29-42)
  - SAM: validity = !(flag & 0x4); strand = flag & 0x10; 1-based POS -> -1;
    full CIGAR clip/length accounting incl. strand flip of query coords
    (reference: src/overlap.cpp:44-108)
"""

from __future__ import annotations

import gzip
import re

from ..errors import RaconError
from ..core.overlaps import OverlapTable

_CIGAR_RE = re.compile(rb"(\d+)([MIDNSHP=X])")


def _read_lines(path: str):
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        for line in f:
            yield line.rstrip(b"\r\n")


def parse_paf(path: str) -> OverlapTable:
    cols: dict = {k: [] for k in ("q_names", "t_names", "q_begin", "q_end",
                                  "q_length", "t_begin", "t_end", "t_length",
                                  "strand", "error", "length")}
    for line in _read_lines(path):
        if not line:
            continue
        f = line.split(b"\t")
        if len(f) < 12:
            raise RaconError(f"[raconx::io] error: malformed PAF file {path}!")
        q_begin, q_end = int(f[2]), int(f[3])
        t_begin, t_end = int(f[7]), int(f[8])
        qs, ts = q_end - q_begin, t_end - t_begin
        length = max(qs, ts)
        cols["q_names"].append(f[0])
        cols["q_length"].append(int(f[1]))
        cols["q_begin"].append(q_begin)
        cols["q_end"].append(q_end)
        cols["strand"].append(f[4] == b"-")
        cols["t_names"].append(f[5])
        cols["t_length"].append(int(f[6]))
        cols["t_begin"].append(t_begin)
        cols["t_end"].append(t_end)
        cols["length"].append(length)
        cols["error"].append(1.0 - min(qs, ts) / length if length else 1.0)
    table = OverlapTable()
    table.finalize_from_lists(cols)
    return table


def parse_mhap(path: str) -> OverlapTable:
    cols: dict = {k: [] for k in ("q_id", "t_id", "q_begin", "q_end",
                                  "q_length", "t_begin", "t_end", "t_length",
                                  "strand", "error", "length")}
    for line in _read_lines(path):
        if not line:
            continue
        f = line.split()
        if len(f) < 12:
            raise RaconError(f"[raconx::io] error: malformed MHAP file {path}!")
        a_id, b_id = int(f[0]), int(f[1])
        a_rc, a_begin, a_end, a_len = int(f[4]), int(f[5]), int(f[6]), int(f[7])
        b_rc, b_begin, b_end, b_len = int(f[8]), int(f[9]), int(f[10]), int(f[11])
        qs, ts = a_end - a_begin, b_end - b_begin
        length = max(qs, ts)
        cols["q_id"].append(a_id - 1)
        cols["t_id"].append(b_id - 1)
        cols["q_begin"].append(a_begin)
        cols["q_end"].append(a_end)
        cols["q_length"].append(a_len)
        cols["t_begin"].append(b_begin)
        cols["t_end"].append(b_end)
        cols["t_length"].append(b_len)
        cols["strand"].append(bool(a_rc ^ b_rc))
        cols["length"].append(length)
        cols["error"].append(1.0 - min(qs, ts) / length if length else 1.0)
    table = OverlapTable()
    table.finalize_from_lists(cols)
    return table


def sam_cigar_accounting(cigar: bytes, strand: bool, t_begin: int):
    """Reference-exact SAM coordinate math (src/overlap.cpp:55-107).

    Returns (q_begin, q_end, q_length, t_end, length, error).
    """
    ops = _CIGAR_RE.findall(cigar)
    q_begin = 0
    for n, op in ops:
        if op in (b"S", b"H"):
            # reference takes atoi(cigar) -- the FIRST number -- when the
            # first clip op precedes any alignment op
            q_begin = int(ops[0][0])
            break
        if op in (b"M", b"=", b"I", b"D", b"N", b"P", b"X"):
            break
    q_aln = q_clip = t_aln = 0
    for n, op in ops:
        n = int(n)
        if op in (b"M", b"=", b"X"):
            q_aln += n
            t_aln += n
        elif op == b"I":
            q_aln += n
        elif op in (b"D", b"N"):
            t_aln += n
        elif op in (b"S", b"H"):
            q_clip += n
    q_end = q_begin + q_aln
    q_length = q_clip + q_aln
    if strand:
        q_begin, q_end = q_length - q_end, q_length - q_begin
    t_end = t_begin + t_aln
    length = max(q_aln, t_aln)
    error = 1.0 - min(q_aln, t_aln) / length if length else 1.0
    return q_begin, q_end, q_length, t_end, length, error


def parse_sam(path: str) -> OverlapTable:
    cols: dict = {k: [] for k in ("q_names", "t_names", "cigars", "q_begin",
                                  "q_end", "q_length", "t_begin", "t_end",
                                  "t_length", "strand", "error", "length",
                                  "is_valid")}
    for line in _read_lines(path):
        if not line or line.startswith(b"@"):
            continue
        f = line.split(b"\t")
        if len(f) < 11:
            raise RaconError(f"[raconx::io] error: malformed SAM file {path}!")
        flag = int(f[1])
        is_valid = not (flag & 0x4)
        strand = bool(flag & 0x10)
        t_begin = int(f[3]) - 1
        cigar = f[5]
        if len(cigar) < 2 and is_valid:
            raise RaconError(
                "[Racon::Overlap::Overlap] error: missing alignment from SAM object!")
        q_begin, q_end, q_length, t_end, length, error = sam_cigar_accounting(
            cigar, strand, t_begin)
        cols["q_names"].append(f[0])
        cols["t_names"].append(f[2])
        cols["cigars"].append(cigar)
        cols["q_begin"].append(q_begin)
        cols["q_end"].append(q_end)
        cols["q_length"].append(q_length)
        cols["t_begin"].append(t_begin)
        cols["t_end"].append(t_end)
        cols["t_length"].append(0)  # SAM carries no target length column
        cols["strand"].append(strand)
        cols["length"].append(length)
        cols["error"].append(error)
        cols["is_valid"].append(is_valid)
    table = OverlapTable()
    table.finalize_from_lists(cols)
    return table


def _names_from_blob(blob, off):
    raw = blob.tobytes()
    return [raw[off[i] : off[i + 1]] for i in range(len(off) - 1)]


def _table_from_raw(r: dict) -> OverlapTable:
    t = OverlapTable()
    t.q_names = _names_from_blob(r["qname_blob"], r["qname_off"])
    t.t_names = _names_from_blob(r["tname_blob"], r["tname_off"])
    t.cigars = _names_from_blob(r["cigar_blob"], r["cigar_off"])
    for k in ("q_id", "t_id", "q_begin", "q_end", "q_length", "t_begin",
              "t_end", "t_length", "length"):
        setattr(t, k, r[k])
    t.strand = r["strand"].astype(bool)
    t.is_valid = r["is_valid"].astype(bool)
    t.error = r["error"]
    return t


def _wrap_native_error(e: RuntimeError) -> RaconError:
    msg = str(e)
    if msg.startswith("["):  # reference-exact message (SAM missing cigar)
        return RaconError(msg)
    return RaconError(f"[raconx::io] error: {msg}")


def parse_native(path: str, fmt: int) -> OverlapTable:
    from ..native import bindings
    try:
        r = bindings.parse_overlaps(path, fmt)
    except RuntimeError as e:
        raise _wrap_native_error(e)
    return _table_from_raw(r)


class _OverlapParser:
    def __init__(self, path: str):
        self.path = path

    def parse(self) -> OverlapTable:
        from ..native import loader
        if loader.available():
            return parse_native(self.path, self.fmt)
        return self._py_parse(self.path)

    def parse_chunks(self, max_bytes: int):
        """Chunked streaming parse (reference: bioparser parse(dst, 1 GiB),
        src/polisher.cpp:26,310-355): yields OverlapTables covering
        ~max_bytes of decompressed text each, bounding host memory to one
        chunk plus the records the caller keeps. The pure-python fallback
        yields the whole file as one chunk (oracle/testing path)."""
        from ..native import loader
        if loader.available():
            from ..native import bindings
            try:
                for r in bindings.overlap_stream(self.path, self.fmt,
                                                 max_bytes):
                    yield _table_from_raw(r)
            except RuntimeError as e:
                raise _wrap_native_error(e)
        else:
            yield self._py_parse(self.path)


class PafParser(_OverlapParser):
    kind = "paf"
    fmt = 0
    _py_parse = staticmethod(parse_paf)


class MhapParser(_OverlapParser):
    kind = "mhap"
    fmt = 1
    _py_parse = staticmethod(parse_mhap)


class SamParser(_OverlapParser):
    kind = "sam"
    fmt = 2
    _py_parse = staticmethod(parse_sam)
