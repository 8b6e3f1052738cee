"""Bulk SAM emission: one native C call per batch for the hot record
shapes (src/path-print-sam.c Path_print_sam role, amortized).

The reference spreads per-record printing across 32 host threads;
tpumap emits from one host thread, so Python-object-per-record emission
was the end-to-end throughput wall.  Here the driver hands whole batch arrays
to `sam_emit_ungapped` / `sam_emit_path` (tpumap/native/sam_emit.cc)
and gets back final SAM text; each line is wrapped in a RawSamRecord
that parses lazily only if a downstream option actually inspects it.
"""
from __future__ import annotations

import ctypes

import numpy as np

_lib = None
_lib_tried = False


def _get_lib():
    global _lib, _lib_tried
    if not _lib_tried:
        _lib_tried = True
        try:
            from tpumap.native import get_lib
            _lib = get_lib()
        except Exception:
            _lib = None
    return _lib


class RawSamRecord:
    """A SamRecord over preformatted SAM text.

    The C emitters produce the final line; `flag` and `mapq` ride along
    as ints (the only fields the default output path reads).  Any other
    field access parses the line once; field mutation marks the record
    dirty so `line()` re-serializes.  API-compatible with
    tpumap.io.sam.SamRecord for every downstream consumer (filters,
    RG tagging, m8/native re-formatters, split-output routing).
    """

    __slots__ = ("_line", "flag", "mapq", "secondaries",
                 "_cols", "_tags", "_dirty", "_flag0", "_mapq0")

    def __init__(self, line: str, flag: int, mapq: int):
        self._line = line            # final SAM text, no newline
        self.flag = flag
        self.mapq = mapq
        self.secondaries = None
        self._cols = None
        self._tags = None
        self._dirty = False
        self._flag0 = flag
        self._mapq0 = mapq

    # -- lazy parse ------------------------------------------------------
    def _parse(self):
        if self._cols is None:
            c = self._line.split("\t")
            self._cols = c[:11]
            self._tags = c[11:]
        return self._cols

    @property
    def tags(self):
        self._parse()
        # hand out the mutable list; appends must survive into line()
        self._dirty = True
        return self._tags

    @tags.setter
    def tags(self, v):
        self._parse()
        self._tags = list(v)
        self._dirty = True

    def line(self) -> str:
        if (not self._dirty and self.flag == self._flag0
                and self.mapq == self._mapq0):
            return self._line
        c = self._parse()
        c[1] = str(self.flag)
        c[4] = str(self.mapq)
        return "\t".join(c + self._tags)

    def lines(self) -> str:
        out = self.line() + "\n"
        for sec in self.secondaries or ():
            out += sec.line() + "\n"
        return out


def _field(idx, name, conv=str, back=str):
    def getter(self):
        return conv(self._parse()[idx])

    def setter(self, v):
        self._parse()[idx] = back(v)
        self._dirty = True

    return property(getter, setter, None, name)


for _i, _n, _c in ((0, "qname", str), (2, "rname", str), (3, "pos", int),
                   (6, "rnext", str), (7, "pnext", int), (8, "tlen", int),
                   (9, "seq", str), (10, "qual", str)):
    setattr(RawSamRecord, _n, _field(_i, _n, _c))
RawSamRecord.cigar = _field(5, "cigar")


# ---------------------------------------------------------------------------

def _db_tables(db):
    """Cached ctypes-ready chromosome tables for a GenomeDB."""
    t = getattr(db, "_sam_bulk_tables", None)
    if t is None:
        starts = np.ascontiguousarray(db.chrom_offsets, dtype=np.uint64)
        n = len(db.chrom_names)
        spans = np.array([db.chrom_length(c) for c in range(n)],
                         dtype=np.int64)
        circ = np.array([bool(b) for b in db.circularp], dtype=np.uint8)
        blob = "".join(db.chrom_names).encode()
        off = np.zeros(n + 1, dtype=np.int64)
        np.cumsum([len(s) for s in db.chrom_names], out=off[1:])
        t = (starts, spans, circ, n, blob, off)
        db._sam_bulk_tables = t
    return t


def _blob_offsets(strings):
    blob = "".join(strings).encode()
    off = np.zeros(len(strings) + 1, dtype=np.int64)
    if strings:
        np.cumsum([len(s) for s in strings], out=off[1:])
    return blob, off


_U8 = ctypes.POINTER(ctypes.c_uint8)
_U32 = ctypes.POINTER(ctypes.c_uint32)
_U64 = ctypes.POINTER(ctypes.c_uint64)
_I32 = ctypes.POINTER(ctypes.c_int32)
_I64 = ctypes.POINTER(ctypes.c_int64)


def _p(arr, typ):
    return arr.ctypes.data_as(typ)


def _common_args(db, chunk, has_qual=None):
    """(chrom-table args, qname blob args, qual blob args) for a chunk.

    has_qual: optional hint (driver batches know whether any read carries
    quality) — saves a full generator scan per batch when False."""
    starts, spans, circ, n, rblob, roff = _db_tables(db)
    qnames = [r.accession for r in chunk]
    qblob, qoff = _blob_offsets(qnames)
    if has_qual is None:
        has_qual = any(r.quality for r in chunk)
    if has_qual:
        ublob, uoff = _blob_offsets([r.quality or "" for r in chunk])
        qual_args = (ublob, _p(uoff, _I64))
        keep = (ublob, uoff)
    else:
        qual_args = (None, None)
        keep = None
    genome_args = (_p(db.genome_packed, _U32), _p(db.genome_nmask, _U32),
                   _p(starts, _U64), _p(spans, _I64), _p(circ, _U8), n,
                   rblob, _p(roff, _I64))
    return genome_args, (qblob, _p(qoff, _I64)), qual_args, (qoff, keep)


_scratch = bytearray()


def _out_buffer(cap: int):
    """Reused output buffer: create_string_buffer zeroes its allocation
    on every call; a module-level bytearray
    amortizes that.  Returns (ctypes view, backing bytearray) — callers
    copy out the written prefix before the next call reuses it."""
    global _scratch
    if len(_scratch) < cap:
        _scratch = bytearray(cap)
    return (ctypes.c_char * len(_scratch)).from_buffer(_scratch), _scratch


def _decode_lines(out_buf, line_off, total, B):
    blob = out_buf[:total].decode("ascii")
    lines: list[str | None] = [None] * B
    off = line_off
    for i in range(B):
        a, b = off[i], off[i + 1]
        if b > a:
            lines[i] = blob[a:b - 1]        # strip the newline
    return lines


def emit_ungapped_bulk(db, chunk, codes, rnmask, lengths, diag, strand,
                       mapq, nbest, qstart, qend, emit,
                       flags=None, mate_u=None, tlen=None, raw=False):
    """Emit final SAM lines for every emit[i]!=0 row in one C call.

    codes/rnmask: (B, L) uint8 row-major read codes + N mask (forward
    orientation); diag: univcoord of query base 0 per read (uint64);
    [qstart, qend) aligned span (soft clips outside).  Paired mode:
    pass full `flags`, the mate univcoord (`mate_u`, UINT64_MAX = none)
    and signed `tlen`, with nbest=None to omit NH/HI (like the paired
    printers).  Returns a list of per-row SAM text (None where not
    emitted), or None if the native library is unavailable.  With
    raw=True returns a SamBlob instead (bytes + per-row offsets, no
    per-line Python strings — the streaming paired path).
    """
    lib = _get_lib()
    if lib is None or not len(chunk):
        return None
    B = len(chunk)
    genome_args, (qblob, qoffp), qual_args, _keep = _common_args(db, chunk)
    L = codes.shape[1]
    qn_max = max(len(r.accession) for r in chunk)
    cap = B * (6 * L + qn_max + 192)
    if raw:
        out_buf, scratch = _out_buffer(cap)
    else:
        out_buf = ctypes.create_string_buffer(cap)
    line_off = np.zeros(B + 1, dtype=np.int64)
    codes = np.ascontiguousarray(codes[:B], dtype=np.uint8)
    rnmask = np.ascontiguousarray(rnmask[:B]).view(np.uint8)
    lengths = np.ascontiguousarray(lengths[:B], dtype=np.int32)
    diag = np.ascontiguousarray(diag[:B], dtype=np.uint64)
    strand = np.ascontiguousarray(strand[:B], dtype=np.uint8)
    mapq = np.ascontiguousarray(np.clip(mapq[:B], 0, 255), dtype=np.uint8)
    if nbest is not None:
        nbest = np.ascontiguousarray(nbest[:B], dtype=np.int32)
    qstart = np.ascontiguousarray(qstart[:B], dtype=np.int32)
    qend = np.ascontiguousarray(qend[:B], dtype=np.int32)
    emit = np.ascontiguousarray(emit[:B], dtype=np.uint8)
    if flags is not None:
        flags = np.ascontiguousarray(flags[:B], dtype=np.int32)
    if mate_u is not None:
        mate_u = np.ascontiguousarray(mate_u[:B], dtype=np.uint64)
    if tlen is not None:
        tlen = np.ascontiguousarray(tlen[:B], dtype=np.int64)
    total = lib.sam_emit_ungapped(
        *genome_args, qblob, qoffp,
        _p(codes, _U8), _p(rnmask, _U8), L,
        qual_args[0], qual_args[1],
        _p(lengths, _I32), _p(diag, _U64), _p(strand, _U8),
        _p(mapq, _U8),
        _p(nbest, _I32) if nbest is not None else None,
        _p(qstart, _I32), _p(qend, _I32),
        _p(flags, _I32) if flags is not None else None,
        _p(mate_u, _U64) if mate_u is not None else None,
        _p(tlen, _I64) if tlen is not None else None,
        _p(emit, _U8), B, out_buf, cap, _p(line_off, _I64))
    if total < 0:
        return None
    if raw:
        return SamBlob(bytes(memoryview(scratch)[:total]), line_off,
                       None)
    return _decode_lines(out_buf.raw, line_off, total, B)


def emit_path_bulk(db, chunk, codes, rnmask, lengths, strand, mapq,
                   qstart, qend, seg_off, seg_q, seg_d, emit,
                   min_intron: int):
    """Emit N-exon chain-DP path records in one C call (soft clips +
    M/N/D cigar + MD with ^deletions + XS from boundary dinucleotides).
    seg_off: (B+1,) int64 flattened segment bounds into seg_q/seg_d."""
    lib = _get_lib()
    if lib is None or not len(chunk):
        return None
    B = len(chunk)
    genome_args, (qblob, qoffp), qual_args, _keep = _common_args(db, chunk)
    L = codes.shape[1]
    qn_max = max(len(r.accession) for r in chunk)
    nseg = int(seg_off[-1])
    cap = B * (8 * L + qn_max + 224) + 64 * nseg
    out_buf = ctypes.create_string_buffer(cap)
    line_off = np.zeros(B + 1, dtype=np.int64)
    codes = np.ascontiguousarray(codes[:B], dtype=np.uint8)
    rnmask = np.ascontiguousarray(rnmask[:B]).view(np.uint8)
    lengths = np.ascontiguousarray(lengths[:B], dtype=np.int32)
    strand = np.ascontiguousarray(strand[:B], dtype=np.uint8)
    mapq = np.ascontiguousarray(np.clip(mapq[:B], 0, 255), dtype=np.uint8)
    qstart = np.ascontiguousarray(qstart[:B], dtype=np.int32)
    qend = np.ascontiguousarray(qend[:B], dtype=np.int32)
    seg_off = np.ascontiguousarray(seg_off, dtype=np.int64)
    seg_q = np.ascontiguousarray(seg_q, dtype=np.int32)
    seg_d = np.ascontiguousarray(seg_d, dtype=np.uint64)
    emit = np.ascontiguousarray(emit[:B], dtype=np.uint8)
    total = lib.sam_emit_path(
        *genome_args, qblob, qoffp,
        _p(codes, _U8), _p(rnmask, _U8), L,
        qual_args[0], qual_args[1],
        _p(lengths, _I32), _p(strand, _U8), _p(mapq, _U8),
        _p(qstart, _I32), _p(qend, _I32),
        _p(seg_off, _I64), _p(seg_q, _I32), _p(seg_d, _U64),
        min_intron, _p(emit, _U8), B, out_buf, cap, _p(line_off, _I64))
    if total < 0:
        return None
    return _decode_lines(out_buf.raw, line_off, total, B)


class SamBlob:
    """One batch's final SAM text as bytes + per-row line offsets.

    The row-order mixed emitter's output: `buf[off[i]:off[i+1]]` is row
    i's newline-terminated line (empty for rows kind 0 / skipped).  The
    streaming driver writes `buf` straight to the output file object —
    per-row Python strings exist only for rows a Python override edits.
    """

    __slots__ = ("buf", "off", "kind")

    def __init__(self, buf: bytes, off, kind):
        self.buf = buf
        self.off = off          # int64[B+1]
        self.kind = kind        # uint8[B]: 0 skip, 1 unmapped, 2 sub, 3 path

    def line(self, i: int) -> bytes:
        return self.buf[self.off[i]:self.off[i + 1]]


def emit_mixed_blob(db, chunk, codes, rnmask, lengths, kind, diag, strand,
                    mapq, nbest, qstart, qend, min_intron,
                    seg_off=None, seg_q=None, seg_d=None,
                    flags=None, mate_u=None, tlen=None, has_qual=None):
    """Emit the whole batch's native rows in row order with ONE C call.

    kind uint8[B]: 0 = skip (Python line spliced in later), 1 = unmapped,
    2 = ungapped (optional soft clips), 3 = N-exon path.  Returns a
    SamBlob, or None if the native library is unavailable.
    """
    lib = _get_lib()
    if lib is None or not len(chunk):
        return None
    B = len(chunk)
    genome_args, (qblob, qoffp), qual_args, (qoff, _keep) = _common_args(
        db, chunk, has_qual=has_qual)
    L = codes.shape[1]
    qn_max = int(np.diff(qoff).max())
    nseg = int(seg_off[-1]) if seg_off is not None else 0
    cap = B * (8 * L + qn_max + 224) + 64 * nseg
    out_buf, scratch = _out_buffer(cap)
    line_off = np.zeros(B + 1, dtype=np.int64)
    codes = np.ascontiguousarray(codes[:B], dtype=np.uint8)
    rnmask = np.ascontiguousarray(rnmask[:B]).view(np.uint8)
    lengths = np.ascontiguousarray(lengths[:B], dtype=np.int32)
    kind = np.ascontiguousarray(kind[:B], dtype=np.uint8)
    diag = np.ascontiguousarray(diag[:B], dtype=np.uint64)
    strand = np.ascontiguousarray(strand[:B], dtype=np.uint8)
    mapq = np.ascontiguousarray(np.clip(mapq[:B], 0, 255), dtype=np.uint8)
    if nbest is not None:
        nbest = np.ascontiguousarray(nbest[:B], dtype=np.int32)
    qstart = np.ascontiguousarray(qstart[:B], dtype=np.int32)
    qend = np.ascontiguousarray(qend[:B], dtype=np.int32)
    if seg_off is None:
        seg_off = np.zeros(B + 1, dtype=np.int64)
        seg_q = np.zeros(0, dtype=np.int32)
        seg_d = np.zeros(0, dtype=np.uint64)
    seg_off = np.ascontiguousarray(seg_off, dtype=np.int64)
    seg_q = np.ascontiguousarray(seg_q, dtype=np.int32)
    seg_d = np.ascontiguousarray(seg_d, dtype=np.uint64)
    if flags is not None:
        flags = np.ascontiguousarray(flags[:B], dtype=np.int32)
    if mate_u is not None:
        mate_u = np.ascontiguousarray(mate_u[:B], dtype=np.uint64)
    if tlen is not None:
        tlen = np.ascontiguousarray(tlen[:B], dtype=np.int64)
    total = lib.sam_emit_mixed(
        *genome_args, qblob, qoffp,
        _p(codes, _U8), _p(rnmask, _U8), L,
        qual_args[0], qual_args[1],
        _p(lengths, _I32), _p(kind, _U8),
        _p(diag, _U64), _p(strand, _U8), _p(mapq, _U8),
        _p(nbest, _I32) if nbest is not None else None,
        _p(qstart, _I32), _p(qend, _I32),
        _p(flags, _I32) if flags is not None else None,
        _p(mate_u, _U64) if mate_u is not None else None,
        _p(tlen, _I64) if tlen is not None else None,
        _p(seg_off, _I64), _p(seg_q, _I32), _p(seg_d, _U64),
        min_intron, B, out_buf, cap, _p(line_off, _I64))
    if total < 0:
        return None
    return SamBlob(bytes(memoryview(scratch)[:total]), line_off, kind)


def emit_unmapped_bulk(db, chunk, codes, rnmask, lengths, emit, flags=None):
    """Emit unmapped SAM lines for every emit[i]!=0 row in one C call."""
    lib = _get_lib()
    if lib is None or not len(chunk):
        return None
    B = len(chunk)
    _genome_args, (qblob, qoffp), qual_args, _keep = _common_args(db, chunk)
    L = codes.shape[1]
    qn_max = max(len(r.accession) for r in chunk)
    cap = B * (2 * L + qn_max + 48)
    out_buf = ctypes.create_string_buffer(cap)
    line_off = np.zeros(B + 1, dtype=np.int64)
    codes = np.ascontiguousarray(codes[:B], dtype=np.uint8)
    rnmask = np.ascontiguousarray(rnmask[:B]).view(np.uint8)
    lengths = np.ascontiguousarray(lengths[:B], dtype=np.int32)
    emit = np.ascontiguousarray(emit[:B], dtype=np.uint8)
    if flags is not None:
        flags = np.ascontiguousarray(flags[:B], dtype=np.int32)
    total = lib.sam_emit_unmapped(
        qblob, qoffp,
        _p(codes, _U8), _p(rnmask, _U8), L,
        qual_args[0], qual_args[1],
        _p(lengths, _I32),
        _p(flags, _I32) if flags is not None else None,
        _p(emit, _U8), B, out_buf, cap, _p(line_off, _I64))
    if total < 0:
        return None
    return _decode_lines(out_buf.raw, line_off, total, B)
