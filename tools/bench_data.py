"""Shared benchmark workload generation (deterministic).

Used by bench.py (tpumap) and tools/measure_baseline.py (reference gsnap)
so both time exactly the same genome + reads.

Two workloads over one chr21-scale genome (46.7 Mbp — the size of human
chr21, per BASELINE.md's own plan):

* DNA: 100 bp reads, 1% substitutions (the round-1 workload, now at
  chr21 scale with a k=14 index for real HBM pressure);
* RNA: 40% of reads span 1-2 GT..AG introns from a planted gene set
  (exercises the splice/chain path; VERDICT round-1 "no spliced-read
  benchmark" gap).  Genes carry a SHORT (~32 bp) second exon so a 100 bp
  read can hold two junctions — the reference's hard multi-junction case
  (path-solve.c combine_leftright_paths).
"""
from __future__ import annotations

import pathlib

import numpy as np

# generated files and index, at the root of the checkout (gitignored)
ROOT = pathlib.Path(__file__).resolve().parent.parent / ".bench_data"
GENOME_LEN = 46_700_000
N_READS = 50_000
READ_LEN = 100
SUB_RATE = 0.01

# planted gene set: exon lengths [300, ~32, 300, 300] with GT..AG introns
N_GENES = 400
EXON_LEN = 300
INTRON_CHOICES = (200, 1000, 5000, 20000)
RNA_SPLICED_FRAC = 0.4


def gene_table():
    """[[(exon_start, exon_len), ...]] — deterministic, non-overlapping.

    Exon 1 is short (25-40 bp) so 100 bp reads can span two junctions.
    """
    rng = np.random.default_rng(7)
    genes = []
    span = GENOME_LEN // N_GENES
    for g in range(N_GENES):
        pos = g * span + 1000
        exons = []
        for ln in (EXON_LEN, int(rng.integers(25, 41)), EXON_LEN, EXON_LEN):
            exons.append((pos, ln))
            pos += ln + int(INTRON_CHOICES[int(
                rng.integers(0, len(INTRON_CHOICES)))])
        genes.append(exons)
    return genes


def genome_codes() -> np.ndarray:
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, GENOME_LEN, dtype=np.int8)
    # plant canonical GT..AG dinucleotides at every gene's intron bounds
    for exons in gene_table():
        for i in range(len(exons) - 1):
            a = exons[i][0] + exons[i][1]          # first intron base
            b = exons[i + 1][0]                    # first base after intron
            codes[a], codes[a + 1] = 2, 3          # GT
            codes[b - 2], codes[b - 1] = 0, 2      # AG
    return codes


def _codes_to_str(codes: np.ndarray) -> str:
    return codes.astype(np.uint8).tobytes().translate(
        bytes.maketrans(b"\x00\x01\x02\x03", b"ACGT")).decode()


def ensure_files() -> tuple[pathlib.Path, pathlib.Path]:
    """Write genome.fa and DNA reads.fa if missing; return their paths."""
    ROOT.mkdir(parents=True, exist_ok=True)
    gfa, rfa = ROOT / "genome.fa", ROOT / "reads.fa"
    if not gfa.exists():
        seq = _codes_to_str(genome_codes())
        with open(gfa, "w") as f:
            f.write(">chr1\n")
            for i in range(0, len(seq), 60):
                f.write(seq[i:i + 60] + "\n")
    if not rfa.exists():
        _write_dna_reads(rfa)
    return gfa, rfa


def ensure_rna_files() -> tuple[pathlib.Path, pathlib.Path]:
    """Genome + RNA reads (spliced fraction per RNA_SPLICED_FRAC)."""
    gfa, _ = ensure_files()
    rfa = ROOT / "reads_rna.fa"
    if not rfa.exists():
        _write_rna_reads(rfa)
    return gfa, rfa


def _write_dna_reads(rfa):
    codes = genome_codes()
    starts, strands, subs = read_plan()
    with open(rfa, "w") as f:
        for i in range(N_READS):
            s = codes[starts[i]:starts[i] + READ_LEN].copy()
            for j, b in subs[i]:
                s[j] = b
            if strands[i]:
                s = 3 - s[::-1]
            f.write(f">r{i}\n{_codes_to_str(s)}\n")


def read_plan():
    """Deterministic (starts, strands, substitutions) for the DNA reads."""
    rng = np.random.default_rng(1)
    starts = rng.integers(0, GENOME_LEN - READ_LEN, N_READS)
    strands = rng.random(N_READS) < 0.5
    subs = []
    for i in range(N_READS):
        nsub = rng.binomial(READ_LEN, SUB_RATE)
        subs.append([(int(rng.integers(0, READ_LEN)),
                      int(rng.integers(0, 4))) for _ in range(nsub)])
    return starts, strands, subs


def rna_read_plan():
    """Deterministic plan for RNA reads.

    Returns a list of dicts: {"segs": [(gpos, len), ...], "strand": 0/1,
    "subs": [(qpos, code), ...]} — segs are genome intervals concatenated
    to form the read (1 seg = unspliced, 2-3 segs = 1-2 junctions).
    """
    rng = np.random.default_rng(2)
    genes = gene_table()
    plan = []
    for i in range(N_READS):
        spliced = rng.random() < RNA_SPLICED_FRAC
        if not spliced:
            p = int(rng.integers(0, GENOME_LEN - READ_LEN))
            segs = [(p, READ_LEN)]
        else:
            exons = genes[int(rng.integers(0, N_GENES))]
            if rng.random() < 0.25:
                # two junctions across the short exon 1
                s1, l1 = exons[1]
                l0 = int(rng.integers(20, READ_LEN - l1 - 20))
                l2 = READ_LEN - l0 - l1
                segs = [(exons[0][0] + exons[0][1] - l0, l0),
                        (s1, l1),
                        (exons[2][0], l2)]
            else:
                e0 = int(rng.integers(0, 3))
                if e0 == 1:
                    e0 = 2                     # skip the short exon here
                l0 = int(rng.integers(20, 80))
                segs = [(exons[e0][0] + exons[e0][1] - l0, l0),
                        (exons[e0 + 1][0], READ_LEN - l0)]
        nsub = rng.binomial(READ_LEN, SUB_RATE)
        subs = [(int(rng.integers(0, READ_LEN)), int(rng.integers(0, 4)))
                for _ in range(nsub)]
        plan.append({"segs": segs, "strand": int(rng.random() < 0.5),
                     "subs": subs})
    return plan


def rna_truth():
    """Per-read truth from the RNA plan: (junction set, locus start).

    Junctions are genomic (donor_univcoord, acceptor_univcoord) pairs
    with donor = first intron base and acceptor = first exon base after
    the intron; locus start = leftmost genomic coordinate."""
    out = []
    for p in rna_read_plan():
        segs = p["segs"]
        js = {(a + n, b) for (a, n), (b, _n2) in zip(segs, segs[1:])}
        out.append((js, segs[0][0]))
    return out


# paired-end workload: DNA fragments, FR orientation (BASELINE.md row 4)
PE_N_PAIRS = 20_000
PE_FRAG_MEAN, PE_FRAG_SD = 350, 40


def pe_read_plan():
    """Deterministic paired-end plan: (frag_start, frag_len, subs1, subs2)."""
    rng = np.random.default_rng(5)
    plan = []
    for i in range(PE_N_PAIRS):
        fl = int(np.clip(rng.normal(PE_FRAG_MEAN, PE_FRAG_SD),
                         2 * READ_LEN, PE_FRAG_MEAN + 4 * PE_FRAG_SD))
        start = int(rng.integers(0, GENOME_LEN - fl))
        subs1 = [(int(rng.integers(0, READ_LEN)), int(rng.integers(0, 4)))
                 for _ in range(rng.binomial(READ_LEN, SUB_RATE))]
        subs2 = [(int(rng.integers(0, READ_LEN)), int(rng.integers(0, 4)))
                 for _ in range(rng.binomial(READ_LEN, SUB_RATE))]
        plan.append((start, fl, subs1, subs2))
    return plan


def ensure_pe_files():
    """reads_pe_1.fa / reads_pe_2.fa: FR pairs from the bench genome."""
    ensure_files()
    f1, f2 = ROOT / "reads_pe_1.fa", ROOT / "reads_pe_2.fa"
    if f1.exists() and f2.exists():
        return f1, f2
    codes = genome_codes()
    with open(f1, "w") as o1, open(f2, "w") as o2:
        for i, (start, fl, subs1, subs2) in enumerate(pe_read_plan()):
            s1 = codes[start:start + READ_LEN].copy()
            for j, b in subs1:
                s1[j] = b
            s2 = codes[start + fl - READ_LEN:start + fl].copy()
            for j, b in subs2:
                s2[j] = b
            s2 = 3 - s2[::-1]                    # mate 2 is reverse strand
            o1.write(f">p{i}/1\n{_codes_to_str(s1)}\n")
            o2.write(f">p{i}/2\n{_codes_to_str(s2)}\n")
    return f1, f2


def _write_rna_reads(rfa):
    codes = genome_codes()
    plan = rna_read_plan()
    with open(rfa, "w") as f:
        for i, p in enumerate(plan):
            s = np.concatenate([codes[a:a + n] for a, n in p["segs"]])
            for j, b in p["subs"]:
                s[j] = b
            if p["strand"]:
                s = 3 - s[::-1]
            nj = len(p["segs"]) - 1
            f.write(f">q{i}_{nj}\n{_codes_to_str(s)}\n")


# ---- grading against the generator's truth (bench.py, chip_smoke.py) ----

LOCUS_SLOP = 150        # bp between the reported and the true start


def sam_primaries(lines):
    """(qname, flag, pos, cigar, xa) of each primary record in SAM text
    lines; headers, secondary and supplementary records are skipped (the
    bench genome has one chromosome, so univcoord == chrpos)."""
    for line in lines:
        if not line or line[0] == "@":
            continue
        c = line.split("\t")
        flag = int(c[1])
        if flag & 0x900:
            continue
        xa = next((t[5:] for t in c[11:] if t.startswith("XA:Z:")), None)
        yield c[0], flag, int(c[3]), c[5], xa


def cigar_junctions(pos: int, cigar: str):
    """Genomic (donor, acceptor) pairs from pos + CIGAR."""
    if "N" not in cigar:
        return ()
    js = []
    cur = pos - 1
    num = 0
    for ch in cigar:
        if ch.isdigit():
            num = num * 10 + ord(ch) - 48
        else:
            if ch == "N":
                js.append((cur, cur + num))
                cur += num
            elif ch in "MD=X":
                cur += num
            num = 0
    return js


def ref_span(cigar: str) -> int:
    """Reference bases consumed by a CIGAR."""
    n = num = 0
    for ch in cigar:
        if ch.isdigit():
            num = num * 10 + ord(ch) - 48
        else:
            if ch in "MDN=X":
                n += num
            num = 0
    return n


def xa_junctions(pos: int, cigar: str, xa: str):
    """Candidate (donor, acceptor) pairs implied by the XA:Z: ambiguous
    splice-end alternates (tied distal placements of a demoted terminal
    exon, src/altsplice.c): qstart dists anchor at the record start
    (acceptor side), qend dists at the record end (donor side)."""
    if not xa:
        return ()
    qs, _, qe = xa.partition("|")
    js = []
    start = pos - 1
    for d in qs.split(","):
        if d:
            js.append((start - int(d), start))
    end = pos - 1 + ref_span(cigar)
    for d in qe.split(","):
        if d:
            js.append((end, end + int(d)))
    return js


def grade_dna(lines, n_reads: int | None = None) -> dict:
    """Aligned fraction and locus accuracy of DNA reads r<i>, over the
    first n_reads reads of the plan (default all)."""
    starts, _strands, _subs = read_plan()
    n = n_reads or N_READS
    mapped = loc = 0
    for qname, flag, pos, _cigar, _xa in sam_primaries(lines):
        if flag & 4:
            continue
        mapped += 1
        if abs(pos - 1 - int(starts[int(qname[1:])])) <= LOCUS_SLOP:
            loc += 1
    return {"aligned_frac": mapped / n, "locus_acc": loc / n}


def grade_rna(lines, n_reads: int | None = None) -> dict:
    """Junction precision/recall and locus accuracy of RNA reads
    q<i>_<nj> against rna_truth(), over the first n_reads reads."""
    truth = rna_truth()
    n = n_reads or len(truth)
    tp = fp = fn = xa_cred = n_loc = spliced = mapped = 0
    for qname, flag, pos, cigar, xa in sam_primaries(lines):
        tjs, tstart = truth[int(qname[1:].split("_")[0])]
        pjs = set(cigar_junctions(pos, cigar))
        if pjs:
            spliced += 1
        if not flag & 4:
            mapped += 1
        tp += len(pjs & tjs)
        fp += len(pjs - tjs)
        missed = tjs - pjs
        fn += len(missed)
        if missed and xa:
            # XA-credited: a truth junction among the tied alternates of
            # a demoted ambiguous end counts as recalled (the demotion is
            # altsplice.c behavior, not a miss)
            xa_cred += len(missed & set(xa_junctions(pos, cigar, xa)))
        if not flag & 4 and abs(pos - 1 - tstart) <= LOCUS_SLOP:
            n_loc += 1
    prec = tp / max(tp + fp, 1)
    rec = tp / max(tp + fn, 1)
    return {"mapped_frac": mapped / n, "spliced_frac": spliced / n,
            "junction_precision": prec, "junction_recall": rec,
            "junction_recall_xa": (tp + xa_cred) / max(tp + fn, 1),
            "junction_f1": 2 * prec * rec / max(prec + rec, 1e-9),
            "locus_acc": n_loc / n}


def grade_pe(lines) -> dict:
    """Fraction of first mates whose primary record is flagged concordant
    (proper pair)."""
    first = [flag for _q, flag, _p, _c, _x in sam_primaries(lines)
             if flag & 0x40]
    return {"concordant_frac": sum(1 for f in first if f & 2)
            / max(len(first), 1)}
