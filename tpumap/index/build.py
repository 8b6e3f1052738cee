"""Genome database build + load (host side, numpy).

Capability-equivalent of the reference's index substrate (gmapindex +
util/gmap_build.pl; see SURVEY.md §2.1): chromosome table, 2-bit packed
genome with N-flag bitmap, and a k-mer -> sorted-genomic-positions index
(the analog of indexdb's offsets/positions pair, src/indexdb.c).

Differences from the reference, by design (device-resident index):
  * One .npz-backed directory format instead of 8 bespoke binary formats;
    arrays are laid out exactly as they will live on the device (packed uint32
    genome words, flat uint32 offsets/positions) so loading is a
    device_put, not a decode.
  * No bitpack64 compression of offsets: lookup must be a single gather.
    For k<=13 we store flat 4^k+1 uint32 offsets; k in [14,16] uses a
    two-level (meta + uint8 block counts) scheme, see kmer_offsets_mode.
  * Positions are sampled every `interval` bases like the reference
    (gmap_build -q, default 3) and stored sorted per k-mer.

A reference-compatible `.genomecomp` writer is provided purely as a parity
oracle against tests/setup.genomecomp.ok (format studied from
src/compress-write.c:51-96 and verified byte-for-byte).
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

from tpumap.io.fasta import read_fasta
from tpumap.utils import dna

FORMAT_VERSION = 1

# sparse on-disk offsets: the dense cumulative-offsets array has 4^k+1
# entries (4.3 GB at k=15) but for all but pod-scale genomes almost every
# k-mer is absent — store (present-kmer ids, counts) instead when sparse
# (the role bitpack64 differential compression plays in the reference,
# src/bitpack64-write.c; here the dense array is rebuilt at load and lives
# dense only in RAM/HBM where gather needs it)
_SPARSE_DISK_DENSITY = 0.25


def _offsets_fields(prefix: str, offsets: np.ndarray) -> dict:
    counts = np.diff(offsets.astype(np.int64))
    present = np.nonzero(counts)[0]
    if len(present) < _SPARSE_DISK_DENSITY * len(counts):
        return {prefix + "_sparse_kmers": present.astype(np.uint32),
                prefix + "_sparse_counts": counts[present].astype(np.uint32),
                prefix + "_len": np.asarray(len(offsets), dtype=np.int64)}
    return {prefix: offsets}


def _offsets_restore(prefix: str, z) -> np.ndarray:
    if prefix in z:
        return z[prefix]
    n = int(z[prefix + "_len"])
    counts = np.zeros(n, dtype=np.uint32)
    counts[z[prefix + "_sparse_kmers"].astype(np.int64) + 1] = \
        z[prefix + "_sparse_counts"]
    return np.cumsum(counts, dtype=np.uint32)


_NATIVE = None


def _native_lib():
    global _NATIVE
    if _NATIVE is None:
        try:
            from tpumap.native import get_lib
            _NATIVE = get_lib() or False
        except Exception:
            _NATIVE = False
    return _NATIVE


@dataclass
class GenomeDB:
    """Host-resident genome database."""

    name: str
    # chromosome table (the reference's chromosome.iit equivalent)
    chrom_names: list[str]
    chrom_offsets: np.ndarray   # uint64[nchrom+1], univcoord starts, [-1] = genome length
    circularp: np.ndarray       # bool[nchrom]
    # genome
    genome_packed: np.ndarray   # uint32[ceil(L/16)], 16 bases/word, base i at bits 2*(i%16)
    genome_nmask: np.ndarray    # uint32[ceil(L/32)], bit set = non-ACGT at that position
    # k-mer index
    k: int
    interval: int
    offsets: np.ndarray         # uint32[4^k+1]
    positions: np.ndarray       # uint32[n] genomic start positions, sorted per k-mer
    # mode-transformed k-mer indexes (cmet/atoi; cmetindex/atoiindex analog):
    # space name ("ct"/"ga"/"ag"/"tc") -> (offsets, positions); the
    # SNP-tolerant index (snpindex analog) lives under key "snp"
    mode_indexes: dict = None
    # SNP tolerance (snpindex analog, src/snpindex.c): alternate genome with
    # the alt alleles substituted ("genomealt", src/gsnap.c:3380-3394)
    genomealt_packed: np.ndarray = None

    @property
    def genome_length(self) -> int:
        return int(self.chrom_offsets[-1])

    def add_snp_index(self, snp_coords: np.ndarray,
                      alt_codes: np.ndarray) -> int:
        """Make the database SNP-tolerant (src/snpindex.c equivalent).

        snp_coords: 0-based univcoords of single-base SNPs; alt_codes: the
        alternate-allele 2-bit codes. Builds (a) the alternate genome
        (genomealt) used by the snp-tolerant mismatch kernel and (b) a
        k-mer index whose position lists include, for every sampled window
        overlapping a SNP, the alt-allele k-mer as well — so reads carrying
        the alt allele still seed (the reference writes these as
        .ref153offsets64strm.<snps> etc.). Returns the number of SNPs
        applied."""
        snp_coords = np.asarray(snp_coords, dtype=np.int64)
        alt_codes = np.asarray(alt_codes, dtype=np.uint8)
        keep = (snp_coords >= 0) & (snp_coords < self.genome_length)
        snp_coords, alt_codes = snp_coords[keep], alt_codes[keep]
        codes = dna.unpack_2bit(self.genome_packed, self.genome_length)
        nmask = self.get_nmask(0, self.genome_length).astype(bool)
        altg = codes.copy()
        altg[snp_coords] = alt_codes
        self.genomealt_packed = dna.pack_2bit(altg)

        # windows [p, p+k) overlapping any SNP
        L, k = self.genome_length, self.k
        near = np.zeros(L + 1, dtype=np.int32)
        starts = np.maximum(snp_coords - k + 1, 0)
        np.add.at(near, starts, 1)
        np.add.at(near, snp_coords + 1, -1)
        near = np.cumsum(near[:-1]) > 0

        n = L - k + 1
        kmers_ref = dna.kmer_codes(codes, k)
        kmers_alt = dna.kmer_codes(altg, k)
        bad = np.convolve(nmask.astype(np.int32),
                          np.ones(k, dtype=np.int32))[k - 1:L] > 0
        sel = np.arange(0, n, self.interval, dtype=np.int64)
        sel = sel[~bad[sel]]
        sel_alt = sel[near[sel] & (kmers_alt[sel] != kmers_ref[sel])]
        km = np.concatenate([kmers_ref[sel], kmers_alt[sel_alt]])
        pos = np.concatenate([sel, sel_alt]).astype(np.uint32)
        order = np.lexsort((pos, km))
        counts = np.bincount(km.astype(np.int64), minlength=4 ** k)
        offsets = np.zeros((4 ** k) + 1, dtype=np.uint32)
        offsets[1:] = np.cumsum(counts).astype(np.uint32)
        if self.mode_indexes is None:
            self.mode_indexes = {}
        self.mode_indexes["snp"] = (offsets, pos[order])
        return len(snp_coords)

    def add_mode_index(self, space: str) -> None:
        """Build a base-space-transformed k-mer index (cmetindex/atoiindex
        equivalent): k-mers hashed in the reduced alphabet so converted
        reads still seed (src/cmetindex.c, src/atoiindex.c)."""
        from tpumap.ops.mode import CODE_MAPS
        if self.mode_indexes is None:
            self.mode_indexes = {}
        codes = dna.unpack_2bit(self.genome_packed, self.genome_length)
        nmask = self.get_nmask(0, self.genome_length).astype(bool)
        tcodes = CODE_MAPS[space][codes]
        self.mode_indexes[space] = build_kmer_index(tcodes, nmask, self.k,
                                                    self.interval)

    # --- host-side sequence access (for output printers / splice models) ---

    def get_codes(self, start: int, length: int) -> np.ndarray:
        """2-bit codes for univcoords [start, start+length)."""
        w0, w1 = start >> 4, (start + length + 15) >> 4
        words = self.genome_packed[w0:w1 + 1]
        codes = dna.unpack_2bit(words, (len(words)) * 16)
        off = start - (w0 << 4)
        return codes[off:off + length]

    def get_alt_codes(self, start: int, length: int) -> np.ndarray:
        """2-bit codes from the alternate (SNP) genome."""
        w0, w1 = start >> 4, (start + length + 15) >> 4
        words = self.genomealt_packed[w0:w1 + 1]
        codes = dna.unpack_2bit(words, (len(words)) * 16)
        off = start - (w0 << 4)
        return codes[off:off + length]

    def get_alt_seq(self, start: int, length: int) -> str:
        return dna.decode(self.get_alt_codes(start, length),
                          self.get_nmask(start, length).astype(bool))

    def get_nmask(self, start: int, length: int) -> np.ndarray:
        idx = np.arange(start, start + length)
        return (self.genome_nmask[idx >> 5] >> (idx & 31)) & 1

    def get_seq(self, start: int, length: int) -> str:
        # native decode (one C pass) — the printers call this per
        # record/segment and the Python unpack+decode chain was the top
        # host cost in end-to-end RNA profiling
        lib = _native_lib()
        if (lib and 0 <= start
                and start + length <= (len(self.genome_packed) << 4)
                and start + length <= (len(self.genome_nmask) << 5)):
            import ctypes
            buf = ctypes.create_string_buffer(length + 1)
            u32p = ctypes.POINTER(ctypes.c_uint32)
            lib.genome_text(self.genome_packed.ctypes.data_as(u32p),
                            self.genome_nmask.ctypes.data_as(u32p),
                            start, length, buf)
            return buf.value.decode()
        return dna.decode(self.get_codes(start, length),
                          self.get_nmask(start, length).astype(bool))

    def chrnum(self, univcoord: int) -> int:
        """0-based chromosome index containing univcoord (EF64_chrnum analog)."""
        import bisect
        try:
            offs = self._chrom_offsets_list
        except AttributeError:
            offs = self._chrom_offsets_list = [int(x)
                                               for x in self.chrom_offsets]
        return bisect.bisect_right(offs, univcoord) - 1

    def chrom_length(self, c: int) -> int:
        """True chromosome length (circular chroms occupy a doubled
        univcoord span)."""
        span = int(self.chrom_offsets[c + 1] - self.chrom_offsets[c])
        return span // 2 if bool(self.circularp[c]) else span

    def chrpos(self, univcoord: int) -> tuple[str, int]:
        c = self.chrnum(univcoord)
        pos = int(univcoord - self.chrom_offsets[c])
        if bool(self.circularp[c]):
            pos %= self.chrom_length(c)
        return self.chrom_names[c], pos

    # --- persistence ---

    def save(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        meta = {
            "format_version": FORMAT_VERSION,
            "name": self.name,
            "k": self.k,
            "interval": self.interval,
            "chrom_names": self.chrom_names,
            "circularp": [bool(b) for b in self.circularp],
        }
        with open(os.path.join(directory, "meta.json"), "w") as f:
            json.dump(meta, f)
        extra = {}
        if self.genomealt_packed is not None:
            extra["genomealt_packed"] = self.genomealt_packed
        np.savez(os.path.join(directory, "arrays.npz"),
                 chrom_offsets=self.chrom_offsets,
                 genome_packed=self.genome_packed,
                 genome_nmask=self.genome_nmask,
                 **_offsets_fields("offsets", self.offsets),
                 positions=self.positions, **extra)
        for space, (off, pos) in (self.mode_indexes or {}).items():
            np.savez(os.path.join(directory, f"mode_{space}.npz"),
                     **_offsets_fields("offsets", off), positions=pos)

    @classmethod
    def load(cls, directory: str) -> "GenomeDB":
        with open(os.path.join(directory, "meta.json")) as f:
            meta = json.load(f)
        z = np.load(os.path.join(directory, "arrays.npz"))
        mode_indexes = {}
        import glob
        for path in glob.glob(os.path.join(directory, "mode_*.npz")):
            space = os.path.basename(path)[5:-4]
            mz = np.load(path)
            mode_indexes[space] = (_offsets_restore("offsets", mz),
                                   mz["positions"])
        return cls(mode_indexes=mode_indexes or None,
                   name=meta["name"],
                   chrom_names=meta["chrom_names"],
                   chrom_offsets=z["chrom_offsets"],
                   circularp=np.array(meta["circularp"], dtype=bool),
                   genome_packed=z["genome_packed"],
                   genome_nmask=z["genome_nmask"],
                   k=meta["k"], interval=meta["interval"],
                   offsets=_offsets_restore("offsets", z),
                   positions=z["positions"],
                   genomealt_packed=(z["genomealt_packed"]
                                     if "genomealt_packed" in z else None))

    # --- reference-format parity writer ---

    def write_genomecomp(self, path: str) -> None:
        """Write the reference `.genomecomp` file (parity oracle).

        Layout per 32-base block: uint32 high (bases 16..31), uint32 low
        (bases 0..15), uint32 flags (bit i = non-ACGT); final partial block
        padded with X (T+flag); two trailing 0xFFFFFFFF sentinel words.
        """
        L = self.genome_length
        nblocks = (L + 31) // 32
        codes = np.zeros(nblocks * 32, dtype=np.uint8)
        codes[:L] = dna.unpack_2bit(self.genome_packed, L)
        flags = np.zeros(nblocks * 32, dtype=bool)
        flags[:L] = self.get_nmask(0, L).astype(bool)
        codes[L:] = 3       # X = T + flag
        flags[L:] = True
        lanes = codes.reshape(nblocks, 32).astype(np.uint32)
        shifts = (2 * np.arange(16, dtype=np.uint32))[None, :]
        low = (lanes[:, :16] << shifts).sum(axis=1, dtype=np.uint32)
        high = (lanes[:, 16:] << shifts).sum(axis=1, dtype=np.uint32)
        fbits = (flags.reshape(nblocks, 32).astype(np.uint32)
                 << np.arange(32, dtype=np.uint32)[None, :]).sum(axis=1, dtype=np.uint32)
        out = np.empty(nblocks * 3 + 2, dtype="<u4")
        out[0:-2:3] = high
        out[1:-2:3] = low
        out[2:-2:3] = fbits
        out[-2:] = 0xFFFFFFFF
        out.tofile(path)


def build_db(fasta_paths, name: str = "genome", k: int = 15, interval: int = 3,
             circular: set[str] | None = None,
             large: bool | None = None) -> GenomeDB:
    """Build a GenomeDB from FASTA file(s) (gmap_build equivalent).

    large: force (True) or suppress (False) the uint64-coordinate build
    (the gmapl/gsnapl LARGE_GENOMES switch); None = auto by genome size.
    """
    if isinstance(fasta_paths, (str, os.PathLike)):
        fasta_paths = [fasta_paths]

    def records():
        for path in fasta_paths:
            for rec in read_fasta(path):
                yield rec.accession, rec.sequence

    return build_db_from_seqs(records(), name=name, k=k, interval=interval,
                              circular=circular, large=large)


def build_db_from_seqs(named_seqs, name: str = "genome", k: int = 15,
                       interval: int = 3,
                       circular: set[str] | None = None,
                       large: bool | None = None) -> GenomeDB:
    """Build a GenomeDB from (name, sequence) pairs (used for the
    transcriptome-as-genome index, where each transcript is a contig)."""
    names, lengths, code_chunks, nmask_chunks = [], [], [], []
    for acc, seq in named_seqs:
        codes, nmask = dna.encode(seq)
        names.append(acc)
        if acc in (circular or set()):
            # circular chromosomes occupy a doubled coordinate span so
            # alignments crossing the origin stay contiguous; reported
            # positions are wrapped modulo the true length (the
            # reference's circular-coordinate aliasing, src/chrnum.c /
            # gmapindex circular handling)
            codes = np.concatenate([codes, codes])
            nmask = np.concatenate([nmask, nmask])
        lengths.append(len(codes))
        code_chunks.append(codes)
        nmask_chunks.append(nmask)
    if not names:
        raise ValueError("no sequences found")
    codes = np.concatenate(code_chunks)
    nmask = np.concatenate(nmask_chunks)
    offsets = np.zeros(len(names) + 1, dtype=np.uint64)
    np.cumsum(lengths, out=offsets[1:])
    circularp = np.array([n in (circular or set()) for n in names], dtype=bool)

    kmer_offsets, kmer_positions = build_kmer_index(
        codes, nmask, k, interval, boundaries=offsets[1:-1], large=large)
    return GenomeDB(
        name=name, chrom_names=names, chrom_offsets=offsets,
        circularp=circularp,
        genome_packed=dna.pack_2bit(codes),
        genome_nmask=dna.pack_bits(nmask),
        k=k, interval=interval,
        offsets=kmer_offsets, positions=kmer_positions)


# positions dtype switches to uint64 at this genome length — the
# gsnapl/gmapl LARGE_GENOMES compile switch re-expressed as a runtime
# dtype decision (src/types.h:38-58, src/univcoord.h)
LARGE_GENOME_THRESHOLD = 2 ** 32
# chunk length for the k-mer scan: bounds peak host memory on multi-Gbp
# genomes (the reference's indexdb-write external-sort role)
KMER_CHUNK = 1 << 26


def build_kmer_index(codes: np.ndarray, nmask: np.ndarray, k: int,
                     interval: int, boundaries=None,
                     large: bool | None = None
                     ) -> tuple[np.ndarray, np.ndarray]:
    """k-mer -> sorted genomic positions, sampled every `interval` bases.

    Equivalent content to indexdb's offsets/positions pair
    (src/indexdb-write.c): position p (p % interval == 0, window free of
    non-ACGT) is filed under oligo(genome[p:p+k]). Windows crossing a
    chromosome boundary (`boundaries`: internal univcoord split points)
    are excluded — they would seed junk cross-chromosome diagonals.

    The scan runs in KMER_CHUNK slabs so multi-Gbp genomes never hold a
    full uint64 k-mer array; positions are uint64 when the genome exceeds
    LARGE_GENOME_THRESHOLD (or `large` forces it) — the gsnapl path. The
    single-chip DeviceIndex requires uint32 positions; large genomes go
    through parallel/large.py window sharding (local uint32 rebasing).
    """
    if k > 16:
        raise ValueError("k > 16 not supported (uint32 oligo space)")
    L = len(codes)
    n = L - k + 1
    if large is None:
        large = L >= LARGE_GENOME_THRESHOLD
    pos_dtype = np.uint64 if large else np.uint32
    if n <= 0:
        return (np.zeros((4 ** k) + 1, dtype=np.uint32),
                np.zeros(0, dtype=pos_dtype))
    bounds = (np.asarray(boundaries, dtype=np.int64)
              if boundaries is not None and len(boundaries) else None)
    sel_chunks, km_chunks = [], []
    for lo in range(0, n, KMER_CHUNK):
        hi = min(lo + KMER_CHUNK, n)
        ccodes = codes[lo:hi + k - 1]
        cmask = nmask[lo:hi + k - 1]
        kmers = dna.kmer_codes(ccodes, k)                # [hi-lo]
        bad = np.convolve(cmask.astype(np.int32),
                          np.ones(k, dtype=np.int32))[k - 1:len(ccodes)] > 0
        start = ((lo + interval - 1) // interval) * interval
        sel_local = np.arange(start - lo, hi - lo, interval, dtype=np.int64)
        keep = ~bad[sel_local]
        sel = sel_local[keep] + lo
        if bounds is not None:
            # a window [p, p+k) crosses a boundary b iff p < b <= p+k-1
            cross = (np.searchsorted(bounds, sel + k - 1, side="right")
                     > np.searchsorted(bounds, sel, side="right"))
            sel = sel[~cross]
        km_chunks.append(kmers[(sel - lo)])
        sel_chunks.append(sel.astype(pos_dtype))
    km = np.concatenate(km_chunks)
    sel = np.concatenate(sel_chunks)
    del km_chunks, sel_chunks
    order = np.argsort(km, kind="stable")
    positions = sel[order]
    counts = np.bincount(km.astype(np.int64), minlength=4 ** k)
    off_dtype = np.uint64 if len(km) >= 2 ** 32 else np.uint32
    offsets = np.zeros((4 ** k) + 1, dtype=off_dtype)
    offsets[1:] = np.cumsum(counts).astype(off_dtype)
    return offsets, positions
