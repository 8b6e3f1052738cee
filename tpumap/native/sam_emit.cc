// Bulk SAM emission (host side, C).
//
// Role analog: src/path-print-sam.c Path_print_sam for the hot cases
// (ungapped substitution alignments, with optional terminal soft clips,
// and N-exon spliced/deletion paths).  The reference amortizes printing
// across 32 threads; tpumap emits from one host thread, so the
// per-record Python emission must collapse into one C pass per batch.
//
// The emitters produce FINAL newline-terminated SAM text per read into
// a caller-provided buffer.  MD/NM are computed here from the 2-bit
// genome + read codes, matching tpumap/io/sam.py md_and_nm semantics:
//   - query N counts as a match (query_unk_mismatch_p=false,
//     src/gsnap.c:336)
//   - genome N counts as a mismatch (genome_unk_mismatch_p=true,
//     src/gsnap.c:337)
#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

const char BASES[5] = {'A', 'C', 'G', 'T', 'N'};
const char COMP[5] = {'T', 'G', 'C', 'A', 'N'};

inline char* put_u64(char* p, uint64_t v) {
    char tmp[24];
    int n = 0;
    do { tmp[n++] = '0' + (int)(v % 10); v /= 10; } while (v);
    while (n) *p++ = tmp[--n];
    return p;
}

inline char* put_str(char* p, const char* s, long n) {
    memcpy(p, s, n);
    return p + n;
}

inline int genome_base(const uint32_t* gpacked, const uint32_t* gnmask,
                       uint64_t u) {
    if ((gnmask[u >> 5] >> (u & 31)) & 1) return 4;
    return (gpacked[u >> 4] >> (2 * (u & 15))) & 3;
}

// chromosome lookup: largest c with starts[c] <= u
inline long chrnum(const uint64_t* starts, long n_chroms, uint64_t u) {
    long lo = 0, hi = n_chroms;          // starts has n_chroms+1 entries
    while (hi - lo > 1) {
        long mid = (lo + hi) >> 1;
        if (starts[mid] <= u) lo = mid; else hi = mid;
    }
    return lo;
}

// Decode the oriented read (strand 1 = reverse complement) into buf.
// codes/rnmask row for this read; L = read length.
inline void oriented_read(const uint8_t* codes, const uint8_t* rnmask,
                          long L, int strand, char* buf) {
    if (!strand) {
        for (long j = 0; j < L; j++)
            buf[j] = rnmask[j] ? 'N' : BASES[codes[j] & 3];
    } else {
        for (long j = 0; j < L; j++) {
            long s = L - 1 - j;
            buf[j] = rnmask[s] ? 'N' : COMP[codes[s] & 3];
        }
    }
}

// MD/NM over the aligned span: read chars buf[q0:q1) vs genome at
// diag+q0.  Writes "MD:Z:..." value into md (returns its length) and
// the mismatch count into *nm_out.
inline long md_scan(const char* oriented, long q0, long q1,
                    const uint32_t* gpacked, const uint32_t* gnmask,
                    uint64_t diag, char* md, long* nm_out) {
    char* p = md;
    long run = 0, nm = 0;
    for (long j = q0; j < q1; j++) {
        int g = genome_base(gpacked, gnmask, diag + (uint64_t)j);
        char gc = BASES[g];
        char rc = oriented[j];
        if ((rc == gc || rc == 'N') && g != 4) {
            run++;
        } else {
            p = put_u64(p, (uint64_t)run);
            *p++ = gc;
            run = 0;
            nm++;
        }
    }
    p = put_u64(p, (uint64_t)run);
    *nm_out = nm;
    return p - md;
}

// Intron transcription sense from boundary dinucleotides
// (tpumap/io/sam.py _junction_sense; src/knownsplicing.c sense role):
// +1 for GT..AG / GC..AG / AT..AC, -1 for CT..AC / CT..GC / GT..AT, 0.
inline int junction_sense(const uint32_t* gpacked, const uint32_t* gnmask,
                          uint64_t don_pos, uint64_t acc_end) {
    int d0 = genome_base(gpacked, gnmask, don_pos);
    int d1 = genome_base(gpacked, gnmask, don_pos + 1);
    int a0 = genome_base(gpacked, gnmask, acc_end - 2);
    int a1 = genome_base(gpacked, gnmask, acc_end - 1);
    if (d0 > 3 || d1 > 3 || a0 > 3 || a1 > 3) return 0;
    int key = (d0 << 6) | (d1 << 4) | (a0 << 2) | a1;
    // base codes: A=0 C=1 G=2 T=3
    switch (key) {
        case (2 << 6) | (3 << 4) | (0 << 2) | 2:  // GT..AG
        case (2 << 6) | (1 << 4) | (0 << 2) | 2:  // GC..AG
        case (0 << 6) | (3 << 4) | (0 << 2) | 1:  // AT..AC
            return 1;
        case (1 << 6) | (3 << 4) | (0 << 2) | 1:  // CT..AC
        case (1 << 6) | (3 << 4) | (2 << 2) | 1:  // CT..GC
        case (2 << 6) | (3 << 4) | (0 << 2) | 3:  // GT..AT
            return -1;
        default:
            return 0;
    }
}

struct ChromTab {
    const uint64_t* starts;      // n_chroms+1 univcoord starts
    const int64_t* spans;        // true chromosome lengths
    const uint8_t* circularp;
    long n_chroms;
    const char* rname_blob;
    const int64_t* rname_off;    // n_chroms+1
};

// shared per-line tail: MAPQ \t CIGAR(caller-written) ... SEQ QUAL tags
// Writes columns 1-5 (QNAME..MAPQ) and returns cursor; fills rname/pos.
inline char* line_head(char* p, const char* qname, long qname_len,
                       int flag, const ChromTab& ct, uint64_t u,
                       int mapq) {
    p = put_str(p, qname, qname_len);
    *p++ = '\t';
    p = put_u64(p, (uint64_t)flag);
    *p++ = '\t';
    long c = chrnum(ct.starts, ct.n_chroms, u);
    p = put_str(p, ct.rname_blob + ct.rname_off[c],
                ct.rname_off[c + 1] - ct.rname_off[c]);
    *p++ = '\t';
    uint64_t pos = u - ct.starts[c];
    if (ct.circularp[c]) pos %= (uint64_t)ct.spans[c];
    p = put_u64(p, pos + 1);
    *p++ = '\t';
    p = put_u64(p, (uint64_t)mapq);
    *p++ = '\t';
    return p;
}

// Per-record emitter bodies shared by the bulk entry points and the
// row-order mixed emitter.  Each returns the new cursor, or nullptr if
// `avail` bytes do not suffice (callers translate to the -1 overflow
// return).  Semantics match the original sam_emit_* loops exactly.

struct EmitCtx {
    const uint32_t* gpacked;
    const uint32_t* gnmask;
    ChromTab ct;
    const char* qname_blob;
    const int64_t* qname_off;
    const uint8_t* codes;
    const uint8_t* rnmask;
    long Lstride;
    const char* qual_blob;
    const int64_t* qual_off;
    const int32_t* lengths;
};

static char* one_unmapped(const EmitCtx& cx, long i, int flag,
                          char* p, long avail, char* seqbuf) {
    long L = cx.lengths[i];
    if (L > 8000) return p;
    if (avail < 2 * L + (cx.qname_off[i + 1] - cx.qname_off[i]) + 48)
        return nullptr;
    oriented_read(cx.codes + i * cx.Lstride, cx.rnmask + i * cx.Lstride,
                  L, 0, seqbuf);
    p = put_str(p, cx.qname_blob + cx.qname_off[i],
                cx.qname_off[i + 1] - cx.qname_off[i]);
    *p++ = '\t';
    p = put_u64(p, (uint64_t)flag);
    p = put_str(p, "\t*\t0\t0\t*\t*\t0\t0\t", 15);
    p = put_str(p, seqbuf, L);
    *p++ = '\t';
    long qlen = cx.qual_off ? (cx.qual_off[i + 1] - cx.qual_off[i]) : 0;
    if (qlen == L) {
        p = put_str(p, cx.qual_blob + cx.qual_off[i], L);
    } else {
        *p++ = '*';
    }
    *p++ = '\n';
    return p;
}

static char* one_ungapped(const EmitCtx& cx, long i, uint64_t diag,
                          int strand, int mapq, long nbest_i,
                          long q0, long q1,
                          int flag, uint64_t mate_u_i, int64_t tlen_i,
                          char* p, long avail,
                          char* seqbuf, char* mdbuf) {
    long L = cx.lengths[i];
    if (L > 8000 || q1 > L || q0 < 0 || q0 >= q1) return p;
    if (avail < 6 * L + (cx.qname_off[i + 1] - cx.qname_off[i]) + 192)
        return nullptr;
    oriented_read(cx.codes + i * cx.Lstride, cx.rnmask + i * cx.Lstride,
                  L, strand, seqbuf);
    long nm = 0;
    long mdlen = md_scan(seqbuf, q0, q1, cx.gpacked, cx.gnmask, diag,
                         mdbuf, &nm);
    p = line_head(p, cx.qname_blob + cx.qname_off[i],
                  cx.qname_off[i + 1] - cx.qname_off[i],
                  flag, cx.ct, diag + (uint64_t)q0, mapq);
    if (q0) { p = put_u64(p, (uint64_t)q0); *p++ = 'S'; }
    p = put_u64(p, (uint64_t)(q1 - q0));
    *p++ = 'M';
    if (L - q1) { p = put_u64(p, (uint64_t)(L - q1)); *p++ = 'S'; }
    if (mate_u_i != (uint64_t)-1) {
        *p++ = '\t';
        long mc = chrnum(cx.ct.starts, cx.ct.n_chroms, mate_u_i);
        long sc = chrnum(cx.ct.starts, cx.ct.n_chroms,
                         diag + (uint64_t)q0);
        if (mc == sc) {
            *p++ = '=';
        } else {
            p = put_str(p, cx.ct.rname_blob + cx.ct.rname_off[mc],
                        cx.ct.rname_off[mc + 1] - cx.ct.rname_off[mc]);
        }
        *p++ = '\t';
        uint64_t mpos = mate_u_i - cx.ct.starts[mc];
        if (cx.ct.circularp[mc]) mpos %= (uint64_t)cx.ct.spans[mc];
        p = put_u64(p, mpos + 1);
        *p++ = '\t';
        int64_t tl = tlen_i;
        if (tl < 0) { *p++ = '-'; tl = -tl; }
        p = put_u64(p, (uint64_t)tl);
        *p++ = '\t';
    } else {
        p = put_str(p, "\t*\t0\t0\t", 7);
    }
    p = put_str(p, seqbuf, L);
    *p++ = '\t';
    long qlen = cx.qual_off ? (cx.qual_off[i + 1] - cx.qual_off[i]) : 0;
    if (qlen == L) {
        const char* q = cx.qual_blob + cx.qual_off[i];
        if (!strand) p = put_str(p, q, L);
        else for (long j = L - 1; j >= 0; j--) *p++ = q[j];
    } else {
        *p++ = '*';
    }
    p = put_str(p, "\tNM:i:", 6);
    p = put_u64(p, (uint64_t)nm);
    p = put_str(p, "\tMD:Z:", 6);
    p = put_str(p, mdbuf, mdlen);
    if (nbest_i >= 0) {
        p = put_str(p, "\tNH:i:", 6);
        p = put_u64(p, (uint64_t)(nbest_i > 1 ? nbest_i : 1));
        p = put_str(p, "\tHI:i:1", 7);
    }
    *p++ = '\n';
    return p;
}

static char* one_path(const EmitCtx& cx, long i, int strand, int mapq,
                      long q0, long q1,
                      const int32_t* seg_q, const uint64_t* seg_d,
                      long s0, long s1, long min_intron,
                      char* p, long avail, char* seqbuf, char* mdbuf) {
    long L = cx.lengths[i];
    if (L > 8000 || q1 > L || q0 < 0 || q0 >= q1 || s1 <= s0) return p;
    if (avail < 8 * L + (cx.qname_off[i + 1] - cx.qname_off[i])
                + 64 * (s1 - s0) + 224)
        return nullptr;
    oriented_read(cx.codes + i * cx.Lstride, cx.rnmask + i * cx.Lstride,
                  L, strand, seqbuf);
    p = line_head(p, cx.qname_blob + cx.qname_off[i],
                  cx.qname_off[i + 1] - cx.qname_off[i],
                  strand ? 16 : 0, cx.ct, seg_d[s0] + (uint64_t)q0, mapq);
    char* md = mdbuf;
    long run = 0, nm = 0;
    long n_introns = 0, sense_sum = 0;
    bool any_sense = false;
    if (q0) { p = put_u64(p, (uint64_t)q0); *p++ = 'S'; }
    for (long s = s0; s < s1; s++) {
        long sq0 = (s == s0) ? q0 : seg_q[s];
        long sq1 = (s + 1 < s1) ? seg_q[s + 1] : q1;
        uint64_t d = seg_d[s];
        p = put_u64(p, (uint64_t)(sq1 - sq0));
        *p++ = 'M';
        for (long j = sq0; j < sq1; j++) {
            int g = genome_base(cx.gpacked, cx.gnmask, d + (uint64_t)j);
            char gc = BASES[g];
            char rc = seqbuf[j];
            if ((rc == gc || rc == 'N') && g != 4) {
                run++;
            } else {
                md = put_u64(md, (uint64_t)run);
                *md++ = gc;
                run = 0;
                nm++;
            }
        }
        if (s + 1 < s1) {
            long gap = (long)(seg_d[s + 1] - d);
            if (gap >= min_intron) {
                p = put_u64(p, (uint64_t)gap);
                *p++ = 'N';
                n_introns++;
                int sen = junction_sense(cx.gpacked, cx.gnmask,
                                         d + (uint64_t)sq1,
                                         seg_d[s + 1] + (uint64_t)sq1);
                sense_sum += sen;
                if (sen) any_sense = true;
            } else {
                p = put_u64(p, (uint64_t)gap);
                *p++ = 'D';
                md = put_u64(md, (uint64_t)run);
                run = 0;
                *md++ = '^';
                for (long g2 = 0; g2 < gap; g2++)
                    *md++ = BASES[genome_base(cx.gpacked, cx.gnmask,
                                              d + (uint64_t)(sq1 + g2))];
                nm += gap;
            }
        }
    }
    md = put_u64(md, (uint64_t)run);
    if (L - q1) { p = put_u64(p, (uint64_t)(L - q1)); *p++ = 'S'; }
    p = put_str(p, "\t*\t0\t0\t", 7);
    p = put_str(p, seqbuf, L);
    *p++ = '\t';
    long qlen = cx.qual_off ? (cx.qual_off[i + 1] - cx.qual_off[i]) : 0;
    if (qlen == L) {
        const char* q = cx.qual_blob + cx.qual_off[i];
        if (!strand) p = put_str(p, q, L);
        else for (long j = L - 1; j >= 0; j--) *p++ = q[j];
    } else {
        *p++ = '*';
    }
    p = put_str(p, "\tNM:i:", 6);
    p = put_u64(p, (uint64_t)nm);
    p = put_str(p, "\tMD:Z:", 6);
    p = put_str(p, mdbuf, md - mdbuf);
    if (n_introns) {
        p = put_str(p, "\tXS:A:", 6);
        *p++ = !any_sense ? '?' : (sense_sum >= 0 ? '+' : '-');
    }
    p = put_str(p, "\tNH:i:1\tHI:i:1\n", 15);
    return p;
}

}  // namespace

// ---------------------------------------------------------------------------
// Row-order mixed emitter: ONE C call per batch emits every native row —
// unmapped, ungapped and N-exon path records interleaved in input order
// (the Outbuffer ordered-mode contract without any per-row Python).
// kind[i]: 0 = skip (a Python override will splice its line in),
// 1 = unmapped, 2 = ungapped, 3 = path.  Returns total bytes or -1 on
// overflow.  nbest may be NULL to omit NH/HI on ungapped rows; flags
// overrides the FLAG for unmapped/ungapped rows (mate_u/tlen add the
// paired columns, as in sam_emit_ungapped).
extern "C" long sam_emit_mixed(
    const uint32_t* gpacked, const uint32_t* gnmask,
    const uint64_t* chrom_starts, const int64_t* chrom_spans,
    const uint8_t* circularp, long n_chroms,
    const char* rname_blob, const int64_t* rname_off,
    const char* qname_blob, const int64_t* qname_off,
    const uint8_t* codes, const uint8_t* rnmask, long Lstride,
    const char* qual_blob, const int64_t* qual_off,
    const int32_t* lengths, const uint8_t* kind,
    const uint64_t* diag, const uint8_t* strand,
    const uint8_t* mapq, const int32_t* nbest,
    const int32_t* qstart, const int32_t* qend,
    const int32_t* flags, const uint64_t* mate_u, const int64_t* tlen,
    const int64_t* seg_off, const int32_t* seg_q, const uint64_t* seg_d,
    long min_intron, long B,
    char* out, long out_cap, int64_t* line_off) {
    EmitCtx cx = {gpacked, gnmask,
                  {chrom_starts, chrom_spans, circularp, n_chroms,
                   rname_blob, rname_off},
                  qname_blob, qname_off, codes, rnmask, Lstride,
                  qual_blob, qual_off, lengths};
    char* p = out;
    char seqbuf[8192];
    char mdbuf[16384];
    line_off[0] = 0;
    for (long i = 0; i < B; i++) {
        long avail = out_cap - (p - out);
        char* np = p;
        switch (kind[i]) {
            case 1:
                np = one_unmapped(cx, i, flags ? flags[i] : 4, p, avail,
                                  seqbuf);
                break;
            case 2:
                np = one_ungapped(
                    cx, i, diag[i], strand[i], mapq[i],
                    nbest ? (long)nbest[i] : -1,
                    qstart[i], qend[i],
                    flags ? flags[i] : (strand[i] ? 16 : 0),
                    mate_u ? mate_u[i] : (uint64_t)-1,
                    tlen ? tlen[i] : 0,
                    p, avail, seqbuf, mdbuf);
                break;
            case 3:
                np = one_path(cx, i, strand[i], mapq[i],
                              qstart[i], qend[i], seg_q, seg_d,
                              seg_off[i], seg_off[i + 1], min_intron,
                              p, avail, seqbuf, mdbuf);
                break;
            default:
                break;
        }
        if (!np) return -1;
        p = np;
        line_off[i + 1] = p - out;
    }
    return p - out;
}

// ---------------------------------------------------------------------------
// Anchored-run delimitation for the localscan salvage path
// (src/spliceends.c trimmed-end role): per read, compare the oriented
// read codes against the genome on the anchored diagonal and report the
// first exact `runlen`-base run start (u_out) and the end of the last
// one (e_out); u_out = -1 when no run exists or the window leaves the
// genome.  Matches the Python np.convolve==runlen delimitation, which
// compares raw 2-bit codes (no N overlay).
extern "C" void anchor_runs(
    const uint32_t* gpacked, long genome_len,
    const uint64_t* diag, const uint8_t* codes, long Lstride,
    const int32_t* lengths, long R, long runlen,
    int32_t* u_out, int32_t* e_out) {
    for (long r = 0; r < R; r++) {
        u_out[r] = -1;
        e_out[r] = -1;
        long li = lengths[r];
        uint64_t a = diag[r];
        if ((long)(a + (uint64_t)li) > genome_len) continue;
        const uint8_t* c = codes + r * Lstride;
        long run = 0, first = -1, last = -1;
        for (long j = 0; j < li; j++) {
            uint64_t u = a + (uint64_t)j;
            int g = (gpacked[u >> 4] >> (2 * (u & 15))) & 3;
            if ((c[j] & 3) == g) {
                if (++run >= runlen) {
                    long start = j - runlen + 1;
                    if (first < 0) first = start;
                    last = start;
                }
            } else {
                run = 0;
            }
        }
        if (first >= 0) {
            u_out[r] = (int32_t)first;
            e_out[r] = (int32_t)(last + runlen);
        }
    }
}

// ---------------------------------------------------------------------------
// Ungapped (substitution-only) records, optional terminal soft clips.
//
// Per read i with emit[i] != 0, appends one SAM line.  line_off[i] /
// line_off[i+1] bound read i's bytes in out (equal => not emitted).
// Returns total bytes written, or -1 if out_cap would overflow.
//
// Paired-end extension (Path_print_sam mate columns): when `flags` is
// non-NULL it gives the full FLAG (0x1/0x2/0x20/0x40/0x80 set by the
// caller); `mate_u` non-NULL gives the mate's univcoord (UINT64_MAX =
// no mate info -> RNEXT '*'), RNEXT prints '=' when both sit on one
// chromosome; `tlen` non-NULL gives the signed TLEN.  `nbest` may be
// NULL to omit the NH/HI tags (the paired printers do not emit them).
extern "C" long sam_emit_ungapped(
    const uint32_t* gpacked, const uint32_t* gnmask,
    const uint64_t* chrom_starts, const int64_t* chrom_spans,
    const uint8_t* circularp, long n_chroms,
    const char* rname_blob, const int64_t* rname_off,
    const char* qname_blob, const int64_t* qname_off,
    const uint8_t* codes, const uint8_t* rnmask, long Lstride,
    const char* qual_blob, const int64_t* qual_off,
    const int32_t* lengths, const uint64_t* diag, const uint8_t* strand,
    const uint8_t* mapq, const int32_t* nbest,
    const int32_t* qstart, const int32_t* qend,
    const int32_t* flags, const uint64_t* mate_u, const int64_t* tlen,
    const uint8_t* emit, long B,
    char* out, long out_cap, int64_t* line_off) {
    EmitCtx cx = {gpacked, gnmask,
                  {chrom_starts, chrom_spans, circularp, n_chroms,
                   rname_blob, rname_off},
                  qname_blob, qname_off, codes, rnmask, Lstride,
                  qual_blob, qual_off, lengths};
    char* p = out;
    char seqbuf[8192];
    char mdbuf[16384];
    line_off[0] = 0;
    for (long i = 0; i < B; i++) {
        if (!emit[i]) { line_off[i + 1] = p - out; continue; }
        int st = strand[i];
        char* np = one_ungapped(
            cx, i, diag[i], st, mapq[i], nbest ? (long)nbest[i] : -1,
            qstart[i], qend[i],
            flags ? flags[i] : (st ? 16 : 0),
            mate_u ? mate_u[i] : (uint64_t)-1, tlen ? tlen[i] : 0,
            p, out_cap - (p - out), seqbuf, mdbuf);
        if (!np) return -1;
        p = np;
        line_off[i + 1] = p - out;
    }
    return p - out;
}

// ---------------------------------------------------------------------------
// N-exon spliced / deletion paths (the chain-DP solver output): per read,
// segments [(qpos, univdiagonal)] ascending; gaps >= min_intron emit N,
// smaller gaps emit D (with their genome bases in MD as ^bases).
// Segment data is flattened: seg_off[i]..seg_off[i+1] rows of
// (seg_q[], seg_d[]).  XS senses come from each intron's boundary
// dinucleotides (junction_sense above): the tag prints '+'/'-' by sign
// of the net sense, '?' when introns exist but none are canonical, and
// is omitted for intron-free paths — matching io/sam.py path_record.
extern "C" long sam_emit_path(
    const uint32_t* gpacked, const uint32_t* gnmask,
    const uint64_t* chrom_starts, const int64_t* chrom_spans,
    const uint8_t* circularp, long n_chroms,
    const char* rname_blob, const int64_t* rname_off,
    const char* qname_blob, const int64_t* qname_off,
    const uint8_t* codes, const uint8_t* rnmask, long Lstride,
    const char* qual_blob, const int64_t* qual_off,
    const int32_t* lengths, const uint8_t* strand, const uint8_t* mapq,
    const int32_t* qstart, const int32_t* qend,
    const int64_t* seg_off, const int32_t* seg_q, const uint64_t* seg_d,
    long min_intron,
    const uint8_t* emit, long B,
    char* out, long out_cap, int64_t* line_off) {
    EmitCtx cx = {gpacked, gnmask,
                  {chrom_starts, chrom_spans, circularp, n_chroms,
                   rname_blob, rname_off},
                  qname_blob, qname_off, codes, rnmask, Lstride,
                  qual_blob, qual_off, lengths};
    char* p = out;
    char seqbuf[8192];
    char mdbuf[16384];
    line_off[0] = 0;
    for (long i = 0; i < B; i++) {
        if (!emit[i]) { line_off[i + 1] = p - out; continue; }
        char* np = one_path(cx, i, strand[i], mapq[i],
                            qstart[i], qend[i], seg_q, seg_d,
                            seg_off[i], seg_off[i + 1], min_intron,
                            p, out_cap - (p - out), seqbuf, mdbuf);
        if (!np) return -1;
        p = np;
        line_off[i + 1] = p - out;
    }
    return p - out;
}

// ---------------------------------------------------------------------------
// Unmapped records: QNAME 4 * 0 0 * * 0 0 SEQ QUAL (forward orientation).
// With `flags` non-NULL the caller supplies the full FLAG (paired-end
// unmapped carry 0x1/0x8/0x40/0x80).
extern "C" long sam_emit_unmapped(
    const char* qname_blob, const int64_t* qname_off,
    const uint8_t* codes, const uint8_t* rnmask, long Lstride,
    const char* qual_blob, const int64_t* qual_off,
    const int32_t* lengths, const int32_t* flags,
    const uint8_t* emit, long B,
    char* out, long out_cap, int64_t* line_off) {
    EmitCtx cx = {nullptr, nullptr,
                  {nullptr, nullptr, nullptr, 0, nullptr, nullptr},
                  qname_blob, qname_off, codes, rnmask, Lstride,
                  qual_blob, qual_off, lengths};
    char* p = out;
    char seqbuf[8192];
    line_off[0] = 0;
    for (long i = 0; i < B; i++) {
        if (!emit[i]) { line_off[i + 1] = p - out; continue; }
        char* np = one_unmapped(cx, i, flags ? flags[i] : 4, p,
                                out_cap - (p - out), seqbuf);
        if (!np) return -1;
        p = np;
        line_off[i + 1] = p - out;
    }
    return p - out;
}
