"""Native (C++) host components, loaded via ctypes.

The library is built with g++ from the committed sources on first use,
into _build/ under a name keyed on a hash of the sources, the compile
flags and the host's CPU architecture, so a library built from other
sources or on another kind of machine is never loaded.  Every entry
point has a pure-Python fallback so the framework works without a
toolchain; `get_lib()` returns None in that case.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import sys

_DIR = os.path.dirname(__file__)
_SRCS = [os.path.join(_DIR, "fastq_tokenizer.cc"),
         os.path.join(_DIR, "sam_emit.cc")]
_BUILD = os.path.join(_DIR, "_build")
# no -march=native: the library stays valid on any host of the same
# architecture, which is all the key below records
_FLAGS = ["-O3", "-shared", "-fPIC"]

_lib = None
_tried = False


def build_key(srcs=None, flags=None) -> str:
    """Hash of the sources, the compile flags and the CPU architecture."""
    h = hashlib.sha256()
    h.update(" ".join(flags or _FLAGS).encode())
    h.update(platform.machine().encode())
    for s in srcs or _SRCS:
        with open(s, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def ensure_built(srcs=None, flags=None, build_dir=None) -> str:
    """Path of the library for the current key, compiling it if absent.

    The compiler writes a temporary name that is renamed into place, so
    concurrent processes never load a half-written file."""
    srcs, flags = srcs or _SRCS, flags or _FLAGS
    build_dir = build_dir or _BUILD
    path = os.path.join(build_dir,
                        f"libtpumap_native-{build_key(srcs, flags)}.so")
    if os.path.exists(path):
        return path
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++"] + flags + ["-o", tmp] + srcs,
                       check=True, capture_output=True)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def get_lib():
    """The native library, building it if needed; None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(ensure_built())
        c_long_p = ctypes.POINTER(ctypes.c_long)
        lib.fastq_scan.restype = ctypes.c_long
        lib.fastq_scan.argtypes = [
            ctypes.c_char_p, ctypes.c_long,
            c_long_p, c_long_p, c_long_p, c_long_p, c_long_p,
            ctypes.c_long]
        lib.fasta_scan.restype = ctypes.c_long
        lib.fasta_scan.argtypes = [
            ctypes.c_char_p, ctypes.c_long,
            c_long_p, c_long_p, c_long_p, c_long_p, c_long_p,
            ctypes.c_long, ctypes.c_long]
        lib.md_nm.restype = ctypes.c_long
        lib.md_nm.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                              ctypes.c_long, ctypes.c_char_p]
        lib.genome_text.restype = None
        lib.genome_text.argtypes = [
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_long, ctypes.c_long, ctypes.c_char_p]
        lib.encode_records.restype = None
        lib.encode_records.argtypes = [
            ctypes.c_char_p, c_long_p, c_long_p, ctypes.c_long,
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32)]
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.encode_packed_batch.restype = ctypes.c_long
        lib.encode_packed_batch.argtypes = [
            ctypes.c_char_p, c_long_p, c_long_p, ctypes.c_long,
            ctypes.c_char_p, c_long_p, u8p,
            ctypes.c_long, ctypes.c_long,
            u8p, u8p, i32p, u32p, u32p, u8p]
        lib.anchor_runs.restype = None
        lib.anchor_runs.argtypes = [
            u32p, ctypes.c_long, u64p, u8p, ctypes.c_long, i32p,
            ctypes.c_long, ctypes.c_long, i32p, i32p]
        lib.sam_emit_ungapped.restype = ctypes.c_long
        lib.sam_emit_ungapped.argtypes = [
            u32p, u32p,                          # genome packed/nmask
            u64p, i64p, u8p, ctypes.c_long,      # chrom table
            ctypes.c_char_p, i64p,               # rname blob/off
            ctypes.c_char_p, i64p,               # qname blob/off
            u8p, u8p, ctypes.c_long,             # codes/rnmask/Lstride
            ctypes.c_char_p, i64p,               # qual blob/off
            i32p, u64p, u8p, u8p, i32p,          # len/diag/strand/mapq/nbest
            i32p, i32p,                          # qstart/qend
            i32p, u64p, i64p,                    # flags/mate_u/tlen (paired)
            u8p, ctypes.c_long,                  # emit mask, B
            ctypes.c_char_p, ctypes.c_long, i64p]
        lib.sam_emit_unmapped.restype = ctypes.c_long
        lib.sam_emit_unmapped.argtypes = [
            ctypes.c_char_p, i64p,               # qname blob/off
            u8p, u8p, ctypes.c_long,             # codes/rnmask/Lstride
            ctypes.c_char_p, i64p,               # qual blob/off
            i32p, i32p,                          # lengths, flags
            u8p, ctypes.c_long,
            ctypes.c_char_p, ctypes.c_long, i64p]
        lib.sam_emit_mixed.restype = ctypes.c_long
        lib.sam_emit_mixed.argtypes = [
            u32p, u32p,                          # genome packed/nmask
            u64p, i64p, u8p, ctypes.c_long,      # chrom table
            ctypes.c_char_p, i64p,               # rname blob/off
            ctypes.c_char_p, i64p,               # qname blob/off
            u8p, u8p, ctypes.c_long,             # codes/rnmask/Lstride
            ctypes.c_char_p, i64p,               # qual blob/off
            i32p, u8p,                           # lengths, kind
            u64p, u8p, u8p, i32p,                # diag/strand/mapq/nbest
            i32p, i32p,                          # qstart/qend
            i32p, u64p, i64p,                    # flags/mate_u/tlen
            i64p, i32p, u64p,                    # seg_off/seg_q/seg_d
            ctypes.c_long, ctypes.c_long,        # min_intron, B
            ctypes.c_char_p, ctypes.c_long, i64p]
        lib.sam_emit_path.restype = ctypes.c_long
        lib.sam_emit_path.argtypes = [
            u32p, u32p,
            u64p, i64p, u8p, ctypes.c_long,
            ctypes.c_char_p, i64p,
            ctypes.c_char_p, i64p,
            u8p, u8p, ctypes.c_long,
            ctypes.c_char_p, i64p,
            i32p, u8p, u8p,                      # len/strand/mapq
            i32p, i32p,                          # qstart/qend
            i64p, i32p, u64p,                    # seg_off/seg_q/seg_d
            ctypes.c_long,                       # min_intron
            u8p, ctypes.c_long,
            ctypes.c_char_p, ctypes.c_long, i64p]
        _lib = lib
    except (OSError, subprocess.CalledProcessError) as exc:
        sys.stderr.write(f"tpumap: native tokenizer unavailable "
                         f"({exc}); using Python fallback\n")
        _lib = None
    return _lib
