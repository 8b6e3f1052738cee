"""tpumap-gmap: cDNA/mRNA -> genome spliced alignment CLI.

Mirrors the behaviorally-meaningful subset of the reference gmap flags
(src/gmap.c:515-630): -g/--gseg (align against a raw genomic segment),
-D/-d (genome database), -f (output format: 2=gff3_gene,
3=gff3_match_cdna).
"""
from __future__ import annotations

import argparse
import sys

from tpumap.cli._errors import clean_errors

import numpy as np

from tpumap.gmap.engine import GmapConfig, align_cdna, align_cdna_both
from tpumap.gmap.stage1 import Stage1Config, find_regions
from tpumap.index.build import GenomeDB
from tpumap.index.device import DeviceIndex
from tpumap.io import gff3
from tpumap.io.fasta import read_fasta
from tpumap.utils import dna


def chain_goodness(chain) -> int:
    if chain is None:
        return -(10 ** 9)
    return chain.matches - 3 * chain.mismatches


def _filter_regions(regions, strand=None, chr_range=None):
    """gmap --strand / -c/--chrsubset: drop candidate regions on the
    wrong strand or outside the chromosome subset."""
    out = []
    for r in regions:
        if strand is not None and r[3] != strand:
            continue
        if chr_range is not None and not (chr_range[0] <= r[0]
                                          < chr_range[1]):
            continue
        out.append(r)
    return out


def align_query_paths(db: GenomeDB, index: DeviceIndex, qcodes, qnmask,
                      config: GmapConfig = GmapConfig(),
                      s1config: Stage1Config = Stage1Config(),
                      npaths: int = 1, known=None, strand=None,
                      chr_range=None):
    """GMAP pipeline for one query: up to npaths region alignments ranked
    by goodness (gmap -n, src/gmap.c maxpaths_report).

    Returns [(chain, univ_offset), ...]; exon genome coordinates in each
    chain are region-relative, univ_offset converts to univcoords.
    """
    regions = _filter_regions(find_regions(index, qcodes, qnmask,
                                           s1config), strand, chr_range)
    if npaths > 1:
        # tandem/nearby duplicates merge into one coarse diagonal cluster;
        # a second fine-slop clustering pass separates their placements
        from dataclasses import replace
        fine = _filter_regions(
            find_regions(index, qcodes, qnmask,
                         replace(s1config,
                                 maxtotallen=max(4 * len(qcodes), 1000),
                                 top_regions=2 * npaths)),
            strand, chr_range)
        regions = list(regions) + [r for r in fine if r not in regions]
    from tpumap.gmap.engine import align_cdna_regions

    def inputs_for(rs):
        return [(db.get_codes(gstart, gend - gstart),
                 db.get_nmask(gstart, gend - gstart).astype(bool),
                 strand, gstart)
                for (gstart, gend, weight, strand) in rs]

    paths = []
    # top-weight region first (one device call); a perfect hit makes the
    # remaining regions unnecessary for npaths=1 — the common case
    head = align_cdna_regions(qcodes, qnmask, inputs_for(regions[:1]),
                              config, known=known)
    if head and head[0] is not None and head[0].exons:
        paths.append((head[0], regions[0][0]))
    done = (npaths == 1 and paths
            and paths[0][0].mismatches == 0
            and paths[0][0].coverage == len(qcodes))
    if not done and len(regions) > 1:
        chains = align_cdna_regions(qcodes, qnmask,
                                    inputs_for(regions[1:]), config,
                                    known=known)
        for (gstart, _gend, _w, strand), chain in zip(regions[1:], chains):
            if chain is None or not chain.exons:
                continue
            paths.append((chain, gstart))
    if not paths and regions:
        # repetitive-region fallback (see align_queries_bulk)
        from dataclasses import replace as _rep
        retry = align_cdna_regions(qcodes, qnmask, inputs_for(regions[:1]),
                                   _rep(config, max_occ=128,
                                        keep_overabundant=True),
                                   known=known)
        if retry and retry[0] is not None and retry[0].exons:
            paths.append((retry[0], regions[0][0]))
    paths.sort(key=lambda p: -chain_goodness(p[0]))
    # drop duplicate/contained placements: overlapping region windows
    # re-align the same locus (or a fragment of it) with slightly
    # different spans, which the reference's clustered gregions never
    # produce — an overlapping genomic span is the same path, keep the
    # best-ranked copy (src/stage3.c Stage3_overlap role)
    uniq = []
    for chain, off in paths:
        a = off + chain.exons[0].gstart
        b = off + chain.exons[-1].gend
        dup = False
        for c2, o2 in uniq:
            a2 = o2 + c2.exons[0].gstart
            b2 = o2 + c2.exons[-1].gend
            if c2.strand == chain.strand and min(b, b2) > max(a, a2):
                dup = True
                break
        if not dup:
            uniq.append((chain, off))
    # suppress fragmentary suboptimal paths (coverage far below the
    # best path's): the reference's stage1 only surfaces gregions with
    # substantial support, so these never appear in its output
    if uniq:
        best_cov = max(c.coverage for c, _o in uniq)
        uniq = [(c, o) for c, o in uniq
                if c.coverage * 2 >= best_cov]
    return uniq[:npaths]


def align_queries_bulk(db: GenomeDB, index: DeviceIndex, encoded: list,
                       config: GmapConfig = GmapConfig(),
                       s1config: Stage1Config = Stage1Config(),
                       known=None, strand=None, chr_range=None,
                       device_ctx=None):
    """Best path for MANY queries with batched device calls: one stage-1
    call for the whole batch, then one chain call per (Qp, Rp) shape
    bucket — the per-call device latency otherwise dominates GMAP
    throughput. Returns [(chain, univ_off) | None] parallel to encoded
    [(codes, nmask)] queries."""
    from tpumap.gmap.engine import align_cdna_windows
    from tpumap.gmap.stage1 import find_regions_bulk

    regions_per_q = [_filter_regions(regs, strand, chr_range)
                     for regs in find_regions_bulk(index, encoded,
                                                   s1config)]
    # stage-1 repetitive fallback: a query whose every oligo is
    # overabundant yields no regions at all; retry those with
    # keep-first-occ semantics
    noregion = [qi for qi, regs in enumerate(regions_per_q) if not regs]
    if noregion:
        from dataclasses import replace as _rep1
        s1_hi = _rep1(s1config, max_occ=64, keep_overabundant=True)
        retry = find_regions_bulk(index, [encoded[qi] for qi in noregion],
                                  s1_hi)
        for qi, regs in zip(noregion, retry):
            regions_per_q[qi] = _filter_regions(regs, strand, chr_range)

    def make_pair(qi, region):
        (gstart, gend, _w, strand) = region
        codes, nmask = encoded[qi]
        if strand:
            qq = dna.revcomp_codes(codes)
            nn = nmask[::-1]
        else:
            qq, nn = codes, nmask
        return (qq, nn, gstart, gend - gstart, strand)

    best = {}

    def run_round(work):            # work: list of (qi, region)
        # one device call per window-size bucket (on-device region
        # extraction): the chain stage's region sort costs ~Rp log Rp
        # per problem, so padding every window to the round's maximum
        # multiplies the sort work of the common small windows.
        # ALL groups are dispatched (async) before any is finished, so
        # host-side junction refinement of group k overlaps the device
        # compute of groups k+1..n
        from collections import defaultdict
        from tpumap.gmap.engine import (_bucket,
                                        align_cdna_windows_dispatch,
                                        align_cdna_windows_finish)
        groups = defaultdict(list)
        for qi, r in work:
            groups[_bucket(r[1] - r[0])].append((qi, r))
        handles = []
        for _sz, subset in sorted(groups.items()):
            if not subset:
                continue
            pairs = [make_pair(qi, r) for qi, r in subset]
            handles.append((subset, pairs,
                            align_cdna_windows_dispatch(
                                index, pairs, config,
                                device_ctx=device_ctx)))
        # fetch group k+1 on a background thread (one concatenated
        # transfer) while group k's host junction refinement runs — the
        # blocking fetch releases the GIL (driver._start_fetch)
        from tpumap.gsnap.driver import _start_fetch
        fetches = [None] * len(handles)
        if handles:
            fetches[0] = _start_fetch(handles[0][2][2])
        for gi, (subset, pairs, h) in enumerate(handles):
            box, th = fetches[gi]
            if gi + 1 < len(handles):
                fetches[gi + 1] = _start_fetch(handles[gi + 1][2][2])
            th.join()
            if "err" in box:
                raise box["err"]
            res = align_cdna_windows_finish(db, h, known=known,
                                            fetched=box["res"])
            for (qi, _r), p, ch in zip(subset, pairs, res):
                if ch is None or not ch.exons:
                    continue
                if (qi not in best
                        or chain_goodness(ch) > chain_goodness(best[qi][0])):
                    best[qi] = (ch, p[2])

    # round 1: top-weight region per query; a perfect alignment there
    # makes the remaining regions unnecessary (the reference's gregion
    # early exit) — the second round only runs for unsolved queries
    run_round([(qi, regs[0]) for qi, regs in enumerate(regions_per_q)
               if regs])
    rest = []
    for qi, regs in enumerate(regions_per_q):
        hit = best.get(qi)
        if hit is not None:
            qlen = len(encoded[qi][0])
            ch = hit[0]
            aligned = ch.matches + ch.mismatches
            # sufficiency threshold (the found_score early-exit concept,
            # src/stage1hr-single.c:1038): a near-perfect path makes the
            # lower-weight regions not worth refining
            if (ch.coverage >= 0.98 * qlen and aligned
                    and ch.matches >= 0.99 * aligned):
                continue
        rest.extend((qi, r) for r in regs[1:])
    if rest:
        run_round(rest)
    # repetitive-region fallback: a query with candidate regions but no
    # chain may have had every oligo over the occupancy cap (tandem
    # repeats); retry its top region with a high cap
    missing = [qi for qi in range(len(encoded))
               if best.get(qi) is None and regions_per_q[qi]]
    if missing:
        from dataclasses import replace
        cfg_hi = replace(config, max_occ=128, keep_overabundant=True)
        pairs = [make_pair(qi, regions_per_q[qi][0]) for qi in missing]
        res = align_cdna_windows(index, db, pairs, cfg_hi, known=known)
        for qi, p, ch in zip(missing, pairs, res):
            if ch is not None and ch.exons:
                best[qi] = (ch, p[2])
    return [best.get(qi) for qi in range(len(encoded))]


def align_query_to_db(db: GenomeDB, index: DeviceIndex, qcodes, qnmask,
                      config: GmapConfig = GmapConfig(),
                      s1config: Stage1Config = Stage1Config()):
    """Best single path (see align_query_paths)."""
    paths = align_query_paths(db, index, qcodes, qnmask, config, s1config)
    return paths[0] if paths else (None, 0)


@clean_errors
def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    ap = argparse.ArgumentParser(prog="tpumap-gmap")
    ap.add_argument("-g", "--gseg", help="align against this genomic segment FASTA")
    ap.add_argument("-D", "--dir", help="genome database directory")
    ap.add_argument("-d", "--db", help="genome database name (informational)")
    ap.add_argument("-f", "--format", default=None,
                    choices=["1", "psl", "2", "gff3_gene", "3",
                             "gff3_match_cdna", "4", "gff3_match_est",
                             "6", "splicesites", "introns", "samse",
                             "sampe", "bedpe", "7", "map_exons",
                             "8", "map_ranges", "9", "coords"])
    ap.add_argument("-A", "--align", action="store_true",
                    help="show alignment (text format)")
    ap.add_argument("-S", "--summary", action="store_true",
                    help="show summary of alignments (text format)")
    ap.add_argument("-3", "--continuous", action="store_true",
                    help="show alignment in three continuous lines")
    ap.add_argument("-4", "--continuous-by-exon", dest="continuous_by_exon",
                    action="store_true",
                    help="show alignment in three lines per exon")
    ap.add_argument("-E", "--exons", choices=["cdna", "genomic",
                                              "cdna+introns",
                                              "genomic+introns"])
    ap.add_argument("-P", "--protein_dna", action="store_true")
    ap.add_argument("-Q", "--protein_gen", action="store_true")
    ap.add_argument("--min-trimmed-coverage", dest="min_coverage",
                    type=float, default=0.0,
                    help="only report paths covering at least this "
                         "fraction of the query")
    ap.add_argument("--min-identity", dest="min_identity",
                    type=float, default=0.0,
                    help="only report paths with at least this identity")
    ap.add_argument("-s", "--use-splicing", dest="use_splicing",
                    help="known splice sites/introns map (.iit) biasing "
                         "intron placement")
    ap.add_argument("-n", "--npaths", type=int, default=5,
                    help="maximum number of paths to report per query "
                         "(reference default 5, src/gmap.c:7075)")
    ap.add_argument("-I", "--invertmode", dest="invertmode", type=int,
                    default=0, choices=[0, 1, 2],
                    help="minus-strand display: 0 = original cDNA vs "
                         "genome (-) strand descending (default), "
                         "1 = inverted cDNA vs (-) strand text, "
                         "2 = inverted cDNA vs (+) strand text "
                         "(src/pair.c invertmode)")
    ap.add_argument("--wraplength", type=int, default=50,
                    help="alignment block width (default 50)")
    ap.add_argument("--nolengths", action="store_true",
                    help="omit intron lengths in the alignment display")
    ap.add_argument("--nomargin", action="store_true",
                    help="omit the left margin in -A output")
    ap.add_argument("--introngap", type=int, default=3,
                    help="intron-flank bases shown in the alignment "
                         "(default 3)")
    ap.add_argument("-x", "--chimera-margin", dest="chimera_margin",
                    type=int, default=0,
                    help="report chimeras when an uncovered query margin "
                         "of at least this size aligns elsewhere "
                         "(src/chimera.c; 0 disables)")
    # input modes (src/gmap.c:523-525)
    ap.add_argument("-1", "--selfalign", action="store_true",
                    help="align one stdin FASTA sequence against itself")
    ap.add_argument("-2", "--pairalign", action="store_true",
                    help="align two stdin FASTA sequences (first genomic, "
                         "second cDNA)")
    ap.add_argument("--cmdline", nargs=2, metavar=("GENOMIC", "CDNA"),
                    help="align these two command-line sequences")
    # runtime / output management
    ap.add_argument("-q", "--part",
                    help="process only fraction i/n of the queries")
    ap.add_argument("-O", "--ordered", action="store_true",
                    help="accepted for compatibility; output is always "
                         "in input order")
    ap.add_argument("-t", "--nthreads", type=int, default=None,
                    help="accepted for compatibility; parallelism comes "
                         "from device batching")
    ap.add_argument("-B", "--batch", default=None,
                    help="accepted for compatibility; the index is "
                         "always fully resident")
    ap.add_argument("--input-buffer-size", dest="batch_size", type=int,
                    default=256, help="queries per device batch")
    ap.add_argument("--output-buffer-size", type=int, default=None,
                    help="accepted for compatibility; output is streamed")
    ap.add_argument("--nofails", action="store_true",
                    help="exclude queries with no alignment")
    ap.add_argument("--failsonly", action="store_true",
                    help="print only queries with no alignment")
    ap.add_argument("--failed-input", dest="failed_input",
                    help="write unaligned queries as FASTA to this file")
    ap.add_argument("--split-output", dest="split_output",
                    help="basename for per-category output files "
                         "(nomapping/uniq/mult/chimera)")
    ap.add_argument("--append-output", action="store_true")
    # alignment knobs (src/gmap.c computation options)
    ap.add_argument("--nosplicing", action="store_true",
                    help="turn off splicing (genomic gaps are deletions)")
    ap.add_argument("-K", "--intronlength", "--max-intronlength-middle",
                    dest="max_intronlength", type=int, default=500_000,
                    help="max length for one internal intron "
                         "(src/gmap.c:347)")
    ap.add_argument("--max-intronlength-ends", dest="max_intronlength_ends",
                    type=int, default=10_000,
                    help="max length for first/last intron")
    ap.add_argument("--split-large-introns", action="store_true",
                    help="accepted for compatibility")
    ap.add_argument("-w", "--localsplicedist", type=int, default=None,
                    help="accepted for compatibility (known-splice "
                         "end distance)")
    ap.add_argument("--totallength", type=int, default=200_000,
                    help="max total intron length (src/gmap.c:348)")
    ap.add_argument("--min-intronlength", dest="min_intronlength",
                    type=int, default=9,
                    help="gaps below this are deletions (src/gmap.c:340)")
    ap.add_argument("--max-deletionlength", dest="max_deletionlength",
                    type=int, default=30,
                    help="gaps above this are introns (src/gmap.c:341)")
    ap.add_argument("--no-chimeras", dest="no_chimeras",
                    action="store_true",
                    help="same as --chimera-margin=0")
    ap.add_argument("--chimera-overlap", type=int, default=0,
                    help="overlap to show at chimera breakpoints")
    ap.add_argument("-c", "--chrsubset", dest="chrsubset",
                    help="limit search to this chromosome")
    ap.add_argument("--strand", default="both",
                    choices=["plus", "minus", "both"],
                    help="genome strand to try aligning to")
    ap.add_argument("-z", "--direction", dest="direction", default="auto",
                    choices=["sense_force", "antisense_force",
                             "sense_filter", "antisense_filter", "auto"],
                    help="cDNA direction (src/gmap.c -z)")
    ap.add_argument("--canonical-mode", dest="canonical_mode", type=int,
                    default=1, choices=[0, 1, 2],
                    help="reward for canonical/semi-canonical introns")
    ap.add_argument("--cross-species", dest="cross_species",
                    action="store_true",
                    help="more sensitive canonical-splicing search")
    ap.add_argument("--suboptimal-score", dest="suboptimal_score",
                    type=float, default=None,
                    help="with -n: report paths scoring within this of "
                         "the best (fractions of query length allowed)")
    ap.add_argument("--trim-end-exons", dest="trim_end_exons", type=int,
                    default=None,
                    help="drop terminal exons with fewer matches")
    ap.add_argument("--allow-close-indels", type=int, default=None,
                    help="accepted for compatibility")
    ap.add_argument("--microexon-spliceprob", type=float, default=None,
                    help="accepted for compatibility")
    ap.add_argument("--indel-open", type=int, default=None,
                    help="accepted for compatibility (DP open penalty)")
    ap.add_argument("--indel-extend", type=int, default=None,
                    help="accepted for compatibility (DP extend penalty)")
    ap.add_argument("--homopolymer", action="store_true",
                    help="accepted for compatibility")
    ap.add_argument("--prunelevel", type=int, default=0,
                    help="accepted for compatibility (no pruning)")
    ap.add_argument("--end-trimming-score", type=int, default=None,
                    help="accepted for compatibility")
    ap.add_argument("-k", "--kmer", type=int, default=None,
                    help="db k-mer size (validated against the database)")
    ap.add_argument("--sampling", type=int, default=None,
                    help="accepted for compatibility")
    ap.add_argument("--expand-offsets", type=int, default=None,
                    help="accepted for compatibility")
    # translation options (src/gmap.c:558-565, src/translation.c)
    ap.add_argument("-F", "--fulllength", action="store_true",
                    help="assume full-length protein (ORF starts at Met)")
    ap.add_argument("-a", "--cdsstart", type=int, default=None,
                    help="translate from this nucleotide (1-based)")
    ap.add_argument("-T", "--truncate", action="store_true",
                    help="accepted for compatibility (implies -F)")
    ap.add_argument("-Y", "--tolerant", action="store_true",
                    help="accepted for compatibility (frameshift-"
                         "corrected translation not performed)")
    ap.add_argument("--alt-start-codons", dest="alt_start_codons",
                    action="store_true",
                    help="also allow GTG/TTG initiation codons")
    ap.add_argument("--translation-code", dest="translation_code",
                    type=int, default=1,
                    help="NCBI genetic code for translation (default 1)")
    # GFF3 options (src/gmap.c:567-571)
    ap.add_argument("--gff3-add-separators", dest="gff3_add_separators",
                    type=int, default=1, choices=[0, 1],
                    help="print ### after each query (default 1)")
    ap.add_argument("--gff3-swap-phase", dest="gff3_swap_phase",
                    type=int, default=0, choices=[0, 1],
                    help="swap CDS phase 1 <-> 2")
    ap.add_argument("--gff3-fasta-annotation", type=int, default=0,
                    help="accepted for compatibility")
    ap.add_argument("--gff3-cds", dest="gff3_cds", default="cdna",
                    choices=["cdna", "genomic"],
                    help="accepted for compatibility (cDNA translation "
                         "is used for CDS coordinates)")
    # SAM options (src/gmap.c:573-584)
    ap.add_argument("--no-sam-headers", action="store_true")
    ap.add_argument("--sam-use-0M", dest="sam_use_0m", type=int, default=1)
    ap.add_argument("--sam-extended-cigar", dest="sam_extended_cigar",
                    action="store_true",
                    help="use X/= CIGAR codes instead of M")
    ap.add_argument("--sam-flipped", dest="sam_flipped",
                    action="store_true",
                    help="accepted for compatibility")
    ap.add_argument("--force-xs-dir", dest="force_xs_dir",
                    action="store_true", help="replace XS:A:? with XS:A:+")
    ap.add_argument("--md-lowercase-snp", action="store_true",
                    help="accepted for compatibility")
    ap.add_argument("--action-if-cigar-error", dest="cigar_action",
                    default="warning",
                    choices=["ignore", "warning", "noprint", "abort"])
    ap.add_argument("--read-group-id", dest="rg_id")
    ap.add_argument("--read-group-name", dest="rg_name")
    ap.add_argument("--read-group-library", dest="rg_library")
    ap.add_argument("--read-group-platform", dest="rg_platform")
    ap.add_argument("-j", "--quality-print-shift", dest="quality_shift",
                    type=int, default=0,
                    help="shift output FASTQ quality scores")
    ap.add_argument("--quality-protocol", dest="quality_protocol",
                    choices=["sanger", "illumina"])
    # map annotation (src/gmap.c -m/-M, --mapexons/--mapboth/--nflanking)
    ap.add_argument("-m", "--map", dest="mapfile",
                    help="IIT map file of annotations to report per path")
    ap.add_argument("-M", "--mapdir", dest="mapdir",
                    help="directory holding the -m map file (default: "
                         "<db>.maps inside the database directory)")
    ap.add_argument("--mapexons", action="store_true",
                    help="look up map hits for each exon separately")
    ap.add_argument("--mapboth", action="store_true",
                    help="report hits from both genome strands (this "
                         "implementation always reports all overlaps)")
    ap.add_argument("--nflanking", type=int, default=0,
                    help="also show this many flanking map entries on "
                         "each side")
    ap.add_argument("-5", "--md5", action="store_true",
                    help="print an MD5 checksum line for each query")
    ap.add_argument("--print-comment", action="store_true",
                    help="accepted for compatibility")
    ap.add_argument("--time", action="store_true", dest="timing",
                    help="print alignment timing to stderr")
    ap.add_argument("--quiet-if-excessive", dest="quiet_if_excessive",
                    action="store_true",
                    help="print nothing when more than -n paths found")
    ap.add_argument("--read-files-command", dest="read_files_command",
                    help="read input via the stdout of `COMMAND file`")
    ap.add_argument("--splicingdir", dest="splicingdir",
                    help="directory holding the -s splicing map")
    ap.add_argument("-V", "--snpsdir", dest="snpsdir", default=None,
                    help="accepted for compatibility")
    ap.add_argument("-v", "--use-snps", dest="use_snps", default=None,
                    help="accepted for compatibility; gmap alignments "
                         "are reference-based (gsnap -v implements SNP "
                         "tolerance)")
    ap.add_argument("--mode", default="standard",
                    choices=["standard", "cmet-stranded", "atoi-stranded",
                             "ttoc-stranded"],
                    help="alignment mode (src/gmap.c:581): bisulfite "
                         "(cmet) / RNA-editing (atoi) base spaces; "
                         "db-backed runs need a tpumap-cmetindex/"
                         "tpumap-atoiindex prepared db for seeding")
    ap.add_argument("--require-splicedir", action="store_true",
                    help="report spliced paths only when the intron "
                         "direction is determinate")
    ap.add_argument("--alphabet", default=None,
                    help="PMAP-only in the reference; accepted and "
                         "ignored")
    ap.add_argument("--nucleotide", "-8", action="store_true",
                    help="PMAP-only in the reference; accepted and "
                         "ignored")
    ap.add_argument("--reference", default=None,
                    help="accepted for compatibility (relative "
                         "alignment is not performed)")
    ap.add_argument("--stage2-start", type=int, default=None,
                    help="accepted for compatibility")
    ap.add_argument("--stage2-end", type=int, default=None,
                    help="accepted for compatibility")
    ap.add_argument("--stage3debug", default=None,
                    help="accepted for compatibility (debug builds only "
                         "in the reference)")
    ap.add_argument("--diagnostic", action="store_true",
                    help="accepted for compatibility")
    ap.add_argument("--graphic", action="store_true",
                    help="accepted for compatibility")
    ap.add_argument("--noexceptions", action="store_true",
                    help="accepted for compatibility")
    ap.add_argument("--use-shared-memory", type=int, default=None,
                    help="N/A: the index is HBM/host-RAM resident")
    ap.add_argument("--preload-shared-memory", action="store_true",
                    help="N/A: the index is HBM/host-RAM resident")
    ap.add_argument("--unload-shared-memory", action="store_true",
                    help="N/A: the index is HBM/host-RAM resident")
    ap.add_argument("--cmetdir", default=None,
                    help="accepted for compatibility")
    ap.add_argument("--atoidir", default=None,
                    help="accepted for compatibility")
    ap.add_argument("--version", action="version",
                    version="tpumap-gmap "
                            + __import__("tpumap").__version__
                            + " (capability reference: GMAP 2024-02-22)")
    ap.add_argument("--check", action="store_true",
                    help="check runtime assumptions and exit")
    ap.add_argument("queries", nargs="?", help="query FASTA/FASTQ")
    args = ap.parse_args(argv)

    if args.check:
        from tpumap.cli.gsnap_cli import run_check
        return run_check()
    if args.no_chimeras:
        args.chimera_margin = 0
    if args.truncate:
        args.fulllength = True
    from tpumap.gmap import translation as _translation
    if args.translation_code != 1:
        _translation.set_translation_code(args.translation_code)
    _translation.set_alt_start_codons(args.alt_start_codons)
    if args.quality_protocol == "illumina" and not args.quality_shift:
        args.quality_shift = -31
    if (args.splicingdir and args.use_splicing
            and "/" not in args.use_splicing):
        import os
        args.use_splicing = os.path.join(args.splicingdir,
                                         args.use_splicing)
    if args.use_snps:
        sys.stderr.write("note: gmap alignments are reference-based; "
                         "use gsnap -v for SNP-tolerant alignment\n")
    import time as _time
    _t0 = _time.perf_counter()
    _nq = [0]

    out = sys.stdout
    cmdline = "tpumap-gmap " + " ".join(argv)
    if args.align:
        fmt = "align"
    elif args.continuous:
        fmt = "continuous"
    elif args.continuous_by_exon:
        fmt = "continuous_by_exon"
    elif args.summary:
        fmt = "summary"
    elif args.exons:
        fmt = "exons:" + args.exons
    elif args.protein_dna:
        fmt = "protein_dna"
    elif args.protein_gen:
        fmt = "protein_gen"
    else:
        fmt = {"1": "psl", "2": "gff3_gene", "3": "gff3_match_cdna",
               "4": "gff3_match_est", "6": "splicesites",
               "7": "map_exons", "8": "map_ranges", "9": "coords",
               None: "gff3_match_cdna"}.get(args.format, args.format)
    if fmt.startswith("gff3"):
        out.write(gff3.header(cmdline))

    config = GmapConfig(
        max_intron=args.max_intronlength,
        min_intronlength=args.min_intronlength,
        max_deletionlength=args.max_deletionlength,
        splicing=not args.nosplicing,
        canonical_mode=2 if args.cross_species else args.canonical_mode,
        mode=args.mode)
    from dataclasses import replace as _dc_replace
    s1config = Stage1Config(maxtotallen=args.totallength, mode=args.mode)
    want_strand = {"plus": 0, "minus": 1, "both": None}[args.strand]

    from tpumap.cli.gsnap_cli import OutputRouter, parse_part
    part = parse_part(args.part) if args.part else None

    def shard(it):
        for i, item in enumerate(it):
            if part is None or i % part[1] == part[0]:
                yield item

    router = OutputRouter(args.split_output, out,
                          append=args.append_output)
    failed = open(args.failed_input,
                  "a" if args.append_output else "w") \
        if args.failed_input else None

    def query_category(pieces):
        if not pieces:
            return "nomapping"
        if args.chimera_margin > 0 and len(pieces) > 1:
            return "chimera"
        return "uniq" if len(pieces) == 1 else "mult"

    def handle_failure(rec, pieces):
        """--failed-input / --nofails / --failsonly bookkeeping.
        Returns True if the alignments should be printed."""
        if not pieces and failed is not None:
            failed.write(f">{rec.header}\n{rec.sequence}\n")
        if args.failsonly:
            if not pieces:
                router.get("nomapping").write(f">{rec.header}\n")
            return False
        if args.nofails and not pieces:
            return False
        return bool(pieces)

    def direction_ok(chain):
        if args.require_splicedir and chain.cdna_direction == 0 \
                and any(i.kind == "intron" for i in chain.introns):
            return False
        if args.direction == "auto":
            return True
        d = chain.cdna_direction * (-1 if chain.strand else 1)
        if args.direction in ("sense_force", "sense_filter"):
            return d >= 0
        return d <= 0

    def postprocess(pieces, qlen):
        """-z direction filter, --trim-end-exons, --suboptimal-score,
        --quiet-if-excessive."""
        _nq[0] += 1
        if args.quiet_if_excessive and len(pieces) > args.npaths:
            return []
        if args.trim_end_exons is not None:
            from tpumap.gmap.engine import trim_end_exons
            pieces = [(trim_end_exons(c, args.trim_end_exons), off)
                      for c, off in pieces]
        pieces = [(c, off) for c, off in pieces
                  if c.exons and direction_ok(c)]
        if args.suboptimal_score is not None and pieces:
            v = args.suboptimal_score
            margin = v * qlen if 0 < v < 1 else v
            best = max(chain_goodness(c) for c, _ in pieces)
            pieces = [(c, off) for c, off in pieces
                      if chain_goodness(c) >= best - margin]
        return pieces

    _dest = [out]
    orf_kw = {"fulllength": args.fulllength,
              "cdsstart": args.cdsstart - 1 if args.cdsstart else None}

    def shape_sam_text(txt):
        from tpumap.io import sam as sam_mod
        out_l = []
        for l in txt.splitlines():
            f = l.split("\t")
            rec = sam_mod.SamRecord(f[0], int(f[1]), f[2], int(f[3]),
                                    int(f[4]), f[5], f[6], int(f[7]),
                                    int(f[8]), f[9], f[10], f[11:])
            if args.rg_id:
                rec.tags.append(f"RG:Z:{args.rg_id}")
            if args.quality_shift and rec.qual != "*":
                rec.qual = "".join(
                    chr(min(126, max(33, ord(c) + args.quality_shift)))
                    for c in rec.qual)
            sam_mod.apply_sam_options(
                rec, extended_cigar_p=args.sam_extended_cigar,
                use_0m=bool(args.sam_use_0m),
                force_xs_dir=args.force_xs_dir,
                cigar_action=args.cigar_action)
            out_l.append(rec.line() + "\n")
        return "".join(out_l)

    def transform(txt):
        """Output-shaping flags applied to formatted text
        (--gff3-add-separators/--gff3-swap-phase, SAM options)."""
        if fmt.startswith("gff3"):
            if not args.gff3_add_separators:
                txt = "".join(l for l in txt.splitlines(True)
                              if l.strip() != "###")
            if args.gff3_swap_phase:
                out_l = []
                for l in txt.splitlines(True):
                    f = l.rstrip("\n").split("\t")
                    if len(f) >= 8 and f[2] == "CDS" and f[7] in ("1", "2"):
                        f[7] = "2" if f[7] == "1" else "1"
                        l = "\t".join(f) + "\n"
                    out_l.append(l)
                txt = "".join(out_l)
        elif fmt in ("samse", "sampe") and txt and not txt.startswith("@"):
            txt = shape_sam_text(txt)
        return txt

    class _TW:
        def __init__(self, f):
            self.f = f

        def write(self, txt):
            self.f.write(transform(txt))

    def dest():
        return _TW(_dest[0])

    def emit(chain, rec, qcodes, seqid, source, chrom_offset,
             region_codes=None, chrname=None, tsize=0):
        from tpumap.io import gmapfmt
        aligned = dna.revcomp_codes(qcodes) if chain.strand else qcodes
        if fmt == "gff3_match_cdna":
            dest().write(gff3.match_cdna(chain, rec.accession, seqid, source,
                                      chrom_offset=chrom_offset,
                                      qlen=len(qcodes)))
        elif fmt == "gff3_gene":
            dest().write(gff3.gene(chain, rec.accession, seqid, source,
                                query_codes=qcodes,
                                chrom_offset=chrom_offset,
                                qlen=len(qcodes)))
        elif fmt == "gff3_match_est":
            dest().write(gmapfmt.est_match(chain, rec.accession, seqid, source,
                                        qlen=len(qcodes),
                                        chrom_offset=chrom_offset))
        elif fmt == "psl":
            dest().write(gmapfmt.psl(chain, rec.accession, len(qcodes), seqid,
                                  tsize, chrom_offset=chrom_offset))
        elif fmt == "bedpe":
            from tpumap.utils import dna as dna_mod
            aligned_seq = dna_mod.decode(aligned,
                                         __import__("numpy").zeros(
                                             len(aligned), bool))
            dest().write(gmapfmt.bedpe(chain, chrname or seqid,
                                    chrom_offset=chrom_offset,
                                    query_seq=aligned_seq))
        elif fmt == "splicesites":
            dest().write(gmapfmt.splicesites(chain, rec.accession,
                                          chrname or "",
                                          chrom_offset=chrom_offset))
        elif fmt == "introns":
            dest().write(gmapfmt.introns_fmt(chain, rec.accession,
                                          chrname or "",
                                          chrom_offset=chrom_offset))
        elif fmt in ("samse", "sampe"):
            dest().write(gmapfmt.sam_se(chain, rec.accession, rec.sequence,
                                     rec.quality, seqid,
                                     chrom_offset=chrom_offset,
                                     qlen=len(qcodes),
                                     paired_flag=(fmt == "sampe"),
                                     region_codes=region_codes))
        elif fmt.startswith("exons:"):
            kind = fmt.split(":")[1]
            dest().write(gmapfmt.exons_fmt(chain, rec.header, aligned,
                                        region_codes,
                                        genomic=kind.startswith("genomic"),
                                        with_introns="+introns" in kind))
        elif fmt == "continuous":
            from tpumap.io.alignfmt import continuous_fmt
            dest().write(continuous_fmt(rec.header, chain, aligned,
                                        region_codes, len(qcodes),
                                        genome_offset=chrom_offset,
                                        invertmode=args.invertmode))
        elif fmt == "continuous_by_exon":
            from tpumap.io.alignfmt import (continuous_by_exon_body,
                                            print_alignment)
            dest().write(print_alignment(rec.header, chain, aligned,
                                         region_codes, len(qcodes),
                                         chrname=chrname,
                                         genome_offset=chrom_offset,
                                         summary_only=True,
                                         invertmode=args.invertmode,
                                         **orf_kw))
            dest().write(continuous_by_exon_body(chain, aligned,
                                                 region_codes, len(qcodes),
                                                 genome_offset=chrom_offset,
                                                 invertmode=args.invertmode))
        elif fmt in ("map_exons", "map_ranges"):
            dest().write(gmapfmt.iit_map_fmt(chain, rec.accession,
                                             rec.header, chrname,
                                             chrom_offset=chrom_offset,
                                             exons=(fmt == "map_exons")))
        elif fmt == "coords":
            from tpumap.io.alignfmt import coords_fmt
            dest().write(coords_fmt(rec.header, chain, aligned,
                                    region_codes, len(qcodes),
                                    genome_offset=chrom_offset))
        elif fmt in ("protein_dna", "protein_gen"):
            dest().write(gmapfmt.protein_fmt(chain, rec.header, aligned,
                                          region_codes,
                                          genomic=(fmt == "protein_gen"),
                                          orf_kw=orf_kw))
        else:
            from tpumap.io.alignfmt import print_alignment
            aligned = dna.revcomp_codes(qcodes) if chain.strand else qcodes
            dest().write(print_alignment(rec.header, chain, aligned,
                                      region_codes, len(qcodes),
                                      chrname=chrname,
                                      genome_offset=chrom_offset,
                                      summary_only=(fmt == "summary"),
                                      invertmode=args.invertmode,
                                      wraplength=args.wraplength,
                                      ngap=args.introngap,
                                      nolengths=args.nolengths,
                                      nomargin=args.nomargin,
                                      **orf_kw))

    region = None
    queries = None
    if args.cmdline:
        from tpumap.io.fasta import Record
        region = Record("genomic", "", args.cmdline[0])
        queries = [Record("cdna", "", args.cmdline[1])]
    elif args.selfalign:
        rec0 = next(read_fasta(sys.stdin))
        region, queries = rec0, [rec0]
    elif args.pairalign:
        it = read_fasta(sys.stdin)
        region = next(it)
        queries = [next(it)]
    elif args.gseg:
        region = next(read_fasta(args.gseg))
        if args.queries is None:
            ap.error("need a query FASTA/FASTQ file")
        queries = read_fasta(args.queries, args.read_files_command)

    if region is not None:
        rcodes, rnmask = dna.encode(region.sequence)
        for rec in shard(queries):
            if args.md5:
                import hashlib
                out.write(f"{rec.accession}\t"
                          f"{hashlib.md5(rec.sequence.upper().encode()).hexdigest()}\n")
            qcodes, qnmask = dna.encode(rec.sequence)
            chain = align_cdna_both(qcodes, qnmask, rcodes, rnmask, config,
                                    strand=want_strand)
            pieces = postprocess(
                [(chain, 0)] if chain is not None and chain.exons else [],
                len(qcodes))
            if not handle_failure(rec, pieces):
                continue
            _dest[0] = router.get(query_category(pieces))
            for chain, _off in pieces:
                emit(chain, rec, qcodes, region.accession, region.accession,
                     0, region_codes=rcodes, tsize=len(rcodes))
        router.close()
        if failed is not None:
            failed.close()
        return
    elif args.dir:
        db = GenomeDB.load(args.dir)
        if args.queries is None:
            ap.error("need a query FASTA/FASTQ file")
        if args.kmer is not None and args.kmer != db.k:
            raise ValueError(f"database was built with -k {db.k}, "
                             f"not {args.kmer}")
        index = DeviceIndex.from_host(db)
        source = args.db or db.name
        if fmt in ("samse", "sampe") and not args.no_sam_headers:
            from tpumap.io import sam as sam_mod
            out.write(sam_mod.header(db, cmdline, rg=args.rg_id,
                                     rg_name=args.rg_name,
                                     rg_library=args.rg_library,
                                     rg_platform=args.rg_platform))
        chr_range = None
        if args.chrsubset:
            if args.chrsubset not in db.chrom_names:
                raise ValueError(f"unknown chromosome {args.chrsubset!r}")
            c = db.chrom_names.index(args.chrsubset)
            chr_range = (int(db.chrom_offsets[c]),
                         int(db.chrom_offsets[c + 1]))
        known = None
        if args.use_splicing:
            from tpumap.gsnap.knownsplicing import KnownSplicing
            from tpumap.io.iit import IIT
            known = KnownSplicing.from_splicing_iit(
                IIT.read(args.use_splicing), db)
        mapiit = mapname = None
        if args.mapfile:
            import os
            from tpumap.io.iit import IIT
            cands = [args.mapfile]
            if args.mapdir:
                cands.append(os.path.join(args.mapdir, args.mapfile))
            cands.append(os.path.join(args.dir, f"{db.name}.maps",
                                      args.mapfile))
            path = next((c for c in cands if c and os.path.exists(c)),
                        None)
            if path is None:
                raise ValueError(f"map file {args.mapfile!r} not found")
            mapiit = IIT.read(path)
            mapname = os.path.basename(path)
            if mapname.endswith(".iit"):
                mapname = mapname[:-4]

        def map_hits_text(pieces):
            """gmap -m: the Maps section (reference format:
            'Map hits for path N (count):' + tab-separated entries)."""
            parts = ["\nMaps:\n"]
            for pi, (chain, univ_off) in enumerate(pieces, 1):
                ci = db.chrnum(univ_off + chain.exons[0].gstart)
                chrname = db.chrom_names[ci]
                off = univ_off - int(db.chrom_offsets[ci])
                if args.mapexons:
                    spans = [(e.gstart, e.gend) for e in chain.exons]
                else:
                    spans = [(chain.exons[0].gstart,
                              chain.exons[-1].gend)]
                seen, hits = set(), []
                for gs, ge in spans:
                    for i in mapiit.get(chrname, gs + 1 + off, ge + off):
                        if int(i) not in seen:
                            seen.add(int(i))
                            hits.append(int(i))
                if args.nflanking > 0:
                    divno = mapiit.div_index(chrname)
                    if divno >= 0:
                        d = mapiit.divdata[divno]
                        base = mapiit.cum_nintervals()[divno]
                        lo = chain.exons[0].gstart + 1 + off
                        hi = chain.exons[-1].gend + off
                        left = sorted(
                            (int(d.highs[r]), r) for r in
                            range(len(d.lows)) if d.highs[r] < lo)
                        right = sorted(
                            (int(d.lows[r]), r) for r in
                            range(len(d.lows)) if d.lows[r] > hi)
                        for _c, r in left[-args.nflanking:] + \
                                right[:args.nflanking]:
                            gi = r + base + 1
                            if gi not in seen:
                                seen.add(gi)
                                hits.append(gi)
                parts.append(f"  Map hits for path {pi} ({len(hits)}):\n")
                for gi in hits:
                    div, low, high, sign, _t = mapiit.interval(gi)
                    coords = (f"{high}..{low}" if sign < 0
                              else f"{low}..{high}")
                    parts.append(f"\t{mapname}\t{div}:{coords}\t"
                                 f"{mapiit.labels[gi - 1]}\n")
                parts.append("\n")
            return "".join(parts)

        def emit_query(rec, qcodes, pieces):
            if args.md5:
                import hashlib
                out.write(f"{rec.accession}\t"
                          f"{hashlib.md5(rec.sequence.upper().encode()).hexdigest()}\n")
            pieces = postprocess(pieces, len(qcodes))
            pieces = [(c, off) for c, off in pieces
                      if passes_filters(c, len(qcodes), args.min_coverage,
                                        args.min_identity)]
            if not handle_failure(rec, pieces):
                return
            _dest[0] = router.get(query_category(pieces))
            for chain, univ_off in pieces:
                _emit_db_hit(db, emit, fmt, rec, qcodes, chain, univ_off,
                             source)
            if mapiit is not None and fmt in ("align", "summary"):
                _dest[0].write(map_hits_text(pieces))

        if args.chimera_margin == 0 and args.npaths == 1:
            # bulk path: batched device calls across queries
            recs = list(shard(read_fasta(args.queries,
                                         args.read_files_command)))
            BATCH = args.batch_size
            for bstart in range(0, len(recs), BATCH):
                group = recs[bstart:bstart + BATCH]
                encoded = [dna.encode(r.sequence) for r in group]
                results = align_queries_bulk(db, index, encoded,
                                             config, s1config, known=known,
                                             strand=want_strand,
                                             chr_range=chr_range)
                for rec, (qcodes, qnmask), hit in zip(group, encoded,
                                                      results):
                    emit_query(rec, qcodes,
                               [hit] if hit is not None else [])
        else:
            for rec in shard(read_fasta(args.queries,
                                        args.read_files_command)):
                qcodes, qnmask = dna.encode(rec.sequence)
                if args.chimera_margin > 0:
                    from tpumap.gmap.chimera import align_query_chimera
                    pieces = align_query_chimera(
                        db, index, qcodes, qnmask, config, s1config,
                        chimera_margin=args.chimera_margin)
                else:
                    pieces = align_query_paths(db, index, qcodes, qnmask,
                                               config, s1config,
                                               npaths=args.npaths,
                                               known=known,
                                               strand=want_strand,
                                               chr_range=chr_range)
                emit_query(rec, qcodes, pieces)
        router.close()
        if failed is not None:
            failed.close()
        if args.timing:
            dt = _time.perf_counter() - _t0
            sys.stderr.write(f"Aligned {_nq[0]} queries in {dt:.3f} s "
                             f"({_nq[0] / max(dt, 1e-9):.1f} queries/sec)\n")
    else:
        ap.error("need -g, -D, --cmdline, --selfalign, or --pairalign")


def passes_filters(chain, qlen, min_coverage, min_identity):
    """gmap --min-trimmed-coverage/--min-identity path filters."""
    if min_coverage > 0 and chain.coverage < min_coverage * qlen:
        return False
    aligned = chain.matches + chain.mismatches
    if min_identity > 0 and aligned and chain.matches < min_identity * aligned:
        return False
    return True


def _emit_db_hit(db, emit, fmt, rec, qcodes, chain, univ_off, source):
    import numpy as np
    chrom_idx = db.chrnum(univ_off + chain.exons[0].gstart)
    seqid = db.chrom_names[chrom_idx]
    chrom_offset = univ_off - int(db.chrom_offsets[chrom_idx])
    g_hi = chain.exons[-1].gend
    tsize = int(db.chrom_offsets[chrom_idx + 1]
                - db.chrom_offsets[chrom_idx])
    need_region = fmt in ("align", "summary", "samse", "sampe",
                          "protein_gen", "continuous",
                          "continuous_by_exon",
                          "coords") or fmt.startswith("exons:")
    emit(chain, rec, qcodes, seqid, source, chrom_offset,
         region_codes=db.get_codes(univ_off, g_hi + 16).astype(np.uint8)
         if need_region else None,
         chrname=seqid, tsize=tsize)


if __name__ == "__main__":
    sys.exit(main())
