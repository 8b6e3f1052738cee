// Native FASTQ/FASTA tokenizer + 2-bit encoder.
//
// The host input pipeline equivalent of the reference's C parsers
// (src/shortread.c Shortread_read_fastq_text / src/sequence.c): the
// reference keeps this layer in C for speed, and at device batch rates
// the Python line parser becomes the bottleneck, so this is the one justified
// native host component (SURVEY.md §7). One pass over the whole file
// buffer: record spans out, then batched 2-bit encoding straight into the
// numpy arrays that are device_put.
//
// Exposed via a plain C ABI for ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstring>
#include <cstdio>

extern "C" {

// Scan a FASTQ buffer; fill per-record spans (byte offsets into buf).
// Arrays must have capacity max_records. Returns the number of records,
// or -1 on malformed input.
long fastq_scan(const char *buf, long n,
                long *name_start, long *name_len,
                long *seq_start, long *seq_len,
                long *qual_start,
                long max_records) {
  long i = 0, r = 0;
  while (i < n && r < max_records) {
    while (i < n && (buf[i] == '\n' || buf[i] == '\r')) i++;
    if (i >= n) break;
    if (buf[i] != '@') return -1;
    i++;
    name_start[r] = i;
    long ns = i;
    while (i < n && buf[i] != '\n' && buf[i] != '\r' && buf[i] != ' ' &&
           buf[i] != '\t')
      i++;
    name_len[r] = i - ns;
    while (i < n && buf[i] != '\n') i++;   // rest of header
    i++;
    seq_start[r] = i;
    long ss = i;
    while (i < n && buf[i] != '\n' && buf[i] != '\r') i++;
    seq_len[r] = i - ss;
    while (i < n && buf[i] != '\n') i++;
    i++;
    if (i >= n || buf[i] != '+') return -1;
    while (i < n && buf[i] != '\n') i++;   // '+' line
    i++;
    qual_start[r] = i;
    i += seq_len[r];
    while (i < n && buf[i] != '\n') i++;   // tolerate \r
    i++;
    r++;
  }
  return r;
}

// Scan a FASTA buffer (sequences may span multiple lines). seq spans are
// (start, len) pairs of up to max_chunks chunks per record flattened into
// chunk_start/chunk_len with per-record chunk counts.
long fasta_scan(const char *buf, long n,
                long *name_start, long *name_len,
                long *chunk_start, long *chunk_len, long *nchunks,
                long max_records, long max_chunks_total) {
  long i = 0, r = -1, c = 0;
  while (i < n) {
    while (i < n && (buf[i] == '\n' || buf[i] == '\r')) i++;
    if (i >= n) break;
    if (buf[i] == '>') {
      if (r + 1 >= max_records) break;
      r++;
      nchunks[r] = 0;
      i++;
      name_start[r] = i;
      long ns = i;
      while (i < n && buf[i] != '\n' && buf[i] != '\r' && buf[i] != ' ' &&
             buf[i] != '\t')
        i++;
      name_len[r] = i - ns;
      while (i < n && buf[i] != '\n') i++;
      i++;
    } else {
      if (r < 0 || c >= max_chunks_total) return -1;
      chunk_start[c] = i;
      long cs = i;
      while (i < n && buf[i] != '\n' && buf[i] != '\r') i++;
      chunk_len[c] = i - cs;
      nchunks[r]++;
      c++;
      while (i < n && buf[i] != '\n') i++;
      i++;
    }
  }
  return r + 1;
}

// 2-bit encode record sequences into [nrec, max_len] arrays.
// spans: seq_start/seq_len from fastq_scan (single-chunk records).
// codes: A=0,C=1,G=2,T=3 (case-insensitive); anything else -> 0 + nmask.
void encode_records(const char *buf,
                    const long *seq_start, const long *seq_len, long nrec,
                    long max_len,
                    uint8_t *codes, uint8_t *nmask, int32_t *lengths) {
  static int8_t lut[256];
  static bool init = false;
  if (!init) {
    memset(lut, -1, sizeof(lut));
    lut['A'] = lut['a'] = 0;
    lut['C'] = lut['c'] = 1;
    lut['G'] = lut['g'] = 2;
    lut['T'] = lut['t'] = 3;
    init = true;
  }
  for (long r = 0; r < nrec; r++) {
    long len = seq_len[r] < max_len ? seq_len[r] : max_len;
    const char *s = buf + seq_start[r];
    uint8_t *crow = codes + r * max_len;
    uint8_t *mrow = nmask + r * max_len;
    for (long j = 0; j < len; j++) {
      int8_t v = lut[(uint8_t)s[j]];
      if (v < 0) {
        crow[j] = 0;
        mrow[j] = 1;
      } else {
        crow[j] = (uint8_t)v;
        mrow[j] = 0;
      }
    }
    for (long j = len; j < max_len; j++) {
      crow[j] = 0;
      mrow[j] = 0;
    }
    lengths[r] = (int32_t)len;
  }
}

// One-pass batch assembly (src/shortread.c Shortread_new + src/compress.c
// Compress_new_fwd roles fused): encode record sequences straight into
// BOTH the per-base arrays the host emitters need (codes/nmask) and the
// 2-bit packed words the device transfer wants (16 bases/uint32, base i
// at bits 2*(i%16) — tpumap/ops/pack.py layout), plus shifted quality
// values.  Replaces the Python make_batch + pack_reads_host pair (two
// numpy passes + a 16k-iteration quality loop) with one C pass.
// Returns 1 if any N was seen (caller then ships pnmask, else a stub).
long encode_packed_batch(
    const char* buf, const long* seq_start, const long* seq_len, long nrec,
    const char* qbuf, const long* qual_start, const uint8_t* has_qual,
    long max_len, long W,
    uint8_t* codes, uint8_t* nmask, int32_t* lengths,
    uint32_t* packed, uint32_t* pnmask, uint8_t* quals) {
  static int8_t lut[256];
  static bool init = false;
  if (!init) {
    memset(lut, -1, sizeof(lut));
    lut['A'] = lut['a'] = 0;
    lut['C'] = lut['c'] = 1;
    lut['G'] = lut['g'] = 2;
    lut['T'] = lut['t'] = 3;
    init = true;
  }
  long any_n = 0;
  for (long r = 0; r < nrec; r++) {
    long len = seq_len[r] < max_len ? seq_len[r] : max_len;
    const char* s = buf + seq_start[r];
    uint8_t* crow = codes + r * max_len;
    uint8_t* mrow = nmask + r * max_len;
    uint32_t* prow = packed + r * W;
    uint32_t* nrow = pnmask + r * W;
    memset(prow, 0, W * sizeof(uint32_t));
    memset(nrow, 0, W * sizeof(uint32_t));
    for (long j = 0; j < len; j++) {
      int8_t v = lut[(uint8_t)s[j]];
      uint32_t shift = 2u * (uint32_t)(j & 15);
      if (v < 0) {
        crow[j] = 0;
        mrow[j] = 1;
        nrow[j >> 4] |= 1u << shift;
        any_n = 1;
      } else {
        crow[j] = (uint8_t)v;
        mrow[j] = 0;
        prow[j >> 4] |= ((uint32_t)v) << shift;
      }
    }
    memset(crow + len, 0, max_len - len);
    memset(mrow + len, 0, max_len - len);
    lengths[r] = (int32_t)len;
    if (quals) {
      uint8_t* qrow = quals + r * max_len;
      if (has_qual && has_qual[r]) {
        const char* q = qbuf + qual_start[r];
        for (long j = 0; j < len; j++) {
          int qv = (uint8_t)q[j];
          qrow[j] = (uint8_t)((qv > 33 ? qv : 33) - 33);
        }
        memset(qrow + len, 30, max_len - len);
      } else {
        memset(qrow, 30, max_len);
      }
    }
  }
  return any_n;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// MD/NM computation (src/path-print-sam.c MD-string role): compare the
// oriented read against the genome text and emit the SAM MD value.
// Returns NM (mismatch count); writes the MD string (NUL-terminated)
// into md_out (caller provides >= 4*n+8 bytes).
extern "C" long md_nm(const char* read, const char* genome, long n,
                      char* md_out) {
    long nm = 0;
    long run = 0;
    char* p = md_out;
    for (long i = 0; i < n; i++) {
        // N never matches (the reference counts N as a mismatch)
        if (read[i] == genome[i] && read[i] != 'N') {
            run++;
        } else {
            p += sprintf(p, "%ld", run);
            *p++ = genome[i];
            run = 0;
            nm++;
        }
    }
    p += sprintf(p, "%ld", run);
    *p = '\0';
    return nm;
}

// ---------------------------------------------------------------------------
// Genome text extraction (Genome_get_segment / Genome_uncompress role,
// src/genome.c): decode univcoords [start, start+length) of the 2-bit
// genome (base i at bits 2*(i%16) of uint32 word i/16) to ASCII with the
// N-flag overlay (bit i%32 of word i/32).  The SAM/alignment printers
// call this once per record/segment; the Python unpack+decode chain it
// replaces was the top host cost in end-to-end RNA profiling.
extern "C" void genome_text(const uint32_t* packed, const uint32_t* nmask,
                            long start, long length, char* out) {
    static const char BASES[4] = {'A', 'C', 'G', 'T'};
    for (long i = 0; i < length; i++) {
        long p = start + i;
        int c = (packed[p >> 4] >> (2 * (p & 15))) & 3;
        int n = (nmask[p >> 5] >> (p & 31)) & 1;
        out[i] = n ? 'N' : BASES[c];
    }
    out[length] = '\0';
}
