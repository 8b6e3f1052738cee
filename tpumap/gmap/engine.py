"""GMAP-style cDNA -> genomic-region spliced alignment.

Pipeline (capability analog of src/stage2.c + src/stage3.c):
  1. device: region 8-mer index -> query anchors -> diagonal segments ->
     best collinear chain (ops/chain.py)
  2. host: junction refinement between consecutive chained segments —
     choose each exon boundary q* minimizing mismatches and maximizing
     splice-site score (the Dynprog_genome_gap "bridge" concept,
     src/dynprog_genome.c:Dynprog_genome_gap, restricted to
     substitution-only junctions for now), plus end extension/trimming.

The result is an ExonChain: per-exon query/genome spans and per-intron
splice types — the equivalent of the reference's Pair_T array in segment
form, consumed by the GFF3/alignment printers (tpumap.io.gff3 et al.).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from tpumap.gmap import maxent
from tpumap.ops import chain as chain_ops
from tpumap.ops.splice import splice_score_canonical
from tpumap.utils import dna

PROB_WEIGHT = 3.0   # maxent prob weight vs canonical bonus in bridge score

MIN_INTRON = 9           # genomic gaps >= this are introns (path-solve.c:14)
JUNCTION_SLACK = 12      # boundary search slack around anchor-run limits
MM_COST = 3              # mismatch cost in junction placement (FULLMATCH=3
                         # match vs MISMATCH=-3 scoring, src/dynprog.h:43-59)


@dataclass
class Exon:
    qstart: int   # query span [qstart, qend) 0-based
    qend: int
    gstart: int   # genomic span [gstart, gend) 0-based region coords
    gend: int
    matches: int = 0
    mismatches: int = 0


@dataclass
class Intron:
    # classification of the junction between exon i and i+1
    kind: str           # "intron" | "deletion" | "insertion" | "gap"
    length: int
    canonical: str = "" # e.g. "GT-AG", "" if non-canonical
    donor_prob: float = 0.0
    acceptor_prob: float = 0.0


@dataclass
class ExonChain:
    exons: list[Exon] = field(default_factory=list)
    introns: list[Intron] = field(default_factory=list)
    strand: int = 0          # 0: query aligns to + region orientation
    cdna_direction: int = 0  # +1 sense, -1 antisense, 0 indeterminate

    @property
    def matches(self) -> int:
        return sum(e.matches for e in self.exons)

    @property
    def mismatches(self) -> int:
        return sum(e.mismatches for e in self.exons)

    @property
    def coverage(self) -> float:
        return sum(e.qend - e.qstart for e in self.exons)

    # non-intron gap accounting (src/pair.c:1410,1419: qindels = cdna
    # insertion bases, tindels = genome deletion bases)
    @property
    def qindels(self) -> int:
        return sum(i.length for i in self.introns if i.kind == "insertion")

    @property
    def tindels(self) -> int:
        return sum(i.length for i in self.introns if i.kind == "deletion")

    @property
    def qopens(self) -> int:
        return sum(1 for i in self.introns if i.kind == "insertion")

    @property
    def topens(self) -> int:
        return sum(1 for i in self.introns if i.kind == "deletion")


@dataclass(frozen=True)
class GmapConfig:
    index_k: int = 8
    # per-oligo occurrence cap inside a region window. The anchor-lane
    # gathers cost ~N*Qp*max_occ elements (the dominant chain-stage op
    # on-trace); 64 -> 16 -> 8 each cut measurably with identical
    # results on the bench AND the oracle byte-parity suite (at k=8 a
    # 65 kb window averages ~1 occurrence/oligo); raise for heavily
    # repetitive targets (the repetitive fallback already retries at 128)
    max_occ: int = 8
    n_segments: int = 64
    max_intron: int = 500_000
    max_qgap: int = 24
    # genomic-gap classification (gmap --min-intronlength /
    # --max-deletionlength, src/gmap.c:340-341): gaps below
    # min_intronlength are deletions, above max_deletionlength introns,
    # in between decided by splice-site evidence
    min_intronlength: int = 9
    max_deletionlength: int = 30
    # gmap --nosplicing: treat every genomic gap as a deletion
    splicing: bool = True
    # gmap --canonical-mode: 0 = no reward for canonical introns,
    # 1 = reward (default), 2 = stronger reward (--cross-species)
    canonical_mode: int = 1
    # keep the first max_occ hits of overabundant oligos instead of
    # dropping them (the repetitive-region retry path)
    keep_overabundant: bool = False
    # gmap --mode (src/gmap.c:581,5456): standard | cmet-stranded |
    # atoi-stranded | ttoc-stranded. Anchoring/chaining/mismatch counting
    # run in the reduced base space (fwd/rc spaces per ops/mode.py);
    # splice dinucleotides, MaxEnt probs and output use original bases
    mode: str = "standard"


@partial(jax.jit, static_argnums=(4,))
def _chain_pipeline(q_codes, q_valid, r_codes, r_valid, config: GmapConfig):
    """Device part: anchors -> segments -> chain for one problem."""
    k = config.index_k
    so, sp = chain_ops.region_index(r_codes, r_valid, k)
    Q = q_codes.shape[0]
    acc = jnp.zeros(Q, dtype=jnp.uint32)
    ok = jnp.ones(Q, dtype=jnp.bool_)
    for j in range(k):
        acc = (acc << 2) | jnp.roll(q_codes, -j).astype(jnp.uint32)
        ok = ok & jnp.roll(q_valid, -j)
    ok = ok & (jnp.arange(Q) < Q - k + 1)
    diag, q, aok = chain_ops.anchors_from_query(
        so, sp, acc, ok, config.max_occ,
        keep_overabundant=config.keep_overabundant, k=k)
    segs = chain_ops.anchors_to_segments(diag, q, aok, config.n_segments, k,
                                         config.max_qgap)
    order, in_chain = chain_ops.chain_segments(segs, config.max_intron)
    return segs, order, in_chain


@partial(jax.jit, static_argnums=(4,))
def _chain_pipeline_batch(q_codes, q_valid, r_codes, r_valid,
                          config: GmapConfig):
    """vmap of _chain_pipeline over a region batch (one device call for
    all candidate regions of a query — per-call dispatch and transfer
    latency dominates the per-query cost otherwise)."""
    return jax.vmap(
        lambda a, b, c, d: _chain_pipeline(a, b, c, d, config))(
            q_codes, q_valid, r_codes, r_valid)


CHAIN_M = 128   # compacted chain members returned per problem


def _compact_chain(segs, order, in_chain):
    """Device-side compaction of the chain result: the full [N, S] segment
    arrays are ~MBs of mostly-invalid entries, so only the chain is
    transferred to the host. Returns
    (diag, qstart, qend, ok) int32/bool [N, CHAIN_M] — only the in-chain,
    valid members, in chain order."""
    S = order.shape[-1]

    def row(order_row, in_chain_row, diag, qs, qe, valid):
        key = jnp.where(in_chain_row,
                        jnp.arange(S, dtype=jnp.int32),
                        jnp.int32(S) + jnp.arange(S, dtype=jnp.int32))
        perm = jnp.argsort(key)
        sel = order_row[perm][:CHAIN_M]
        ok = in_chain_row[perm][:CHAIN_M] & valid[sel]
        return (jnp.where(ok, diag[sel], 0), jnp.where(ok, qs[sel], 0),
                jnp.where(ok, qe[sel], 0), ok)

    return jax.vmap(row)(order, in_chain, segs["diag"], segs["qstart"],
                         segs["qend"], segs["valid"])


@partial(jax.jit, static_argnums=(7, 8))
def _chain_pipeline_windows(genome_packed, genome_nmask, q_codes, q_valid,
                            win_start, win_len, space_ids, Rp: int,
                            config: GmapConfig):
    """Chain pipeline with ON-DEVICE region extraction: the genome already
    lives in device memory, so shipping [N, Rp] region code arrays from
    the host (tens of MB per call) is replaced by a window gather.
    Returns the COMPACTED chain (see _compact_chain).

    space_ids int32[N]: per-row mode space (0 = fwd space, 1 = rc space,
    per ops/mode.MODE_SPACES[config.mode]); ignored in standard mode."""
    from tpumap.ops import verify as verify_ops

    r_codes = verify_ops.extract_codes_window(genome_packed, win_start, Rp)
    nm2 = verify_ops.extract_bit_window(genome_nmask, win_start, Rp // 16)
    nbase = verify_ops.mismatch_base_mask(nm2, Rp)
    in_len = (jnp.arange(Rp, dtype=jnp.int32)[None, :]
              < win_len[:, None])
    r_valid = in_len & ~nbase
    if config.mode != "standard":
        from tpumap.ops.mode import CODE_MAPS, MODE_SPACES
        sf, sr = MODE_SPACES[config.mode]
        maps = jnp.stack([jnp.asarray(CODE_MAPS[sf]),
                          jnp.asarray(CODE_MAPS[sr])])      # [2, 4]
        tmap = maps[space_ids]                              # [N, 4]
        q_codes = jnp.take_along_axis(tmap, q_codes.astype(jnp.int32),
                                      axis=1)
        r_codes = jnp.take_along_axis(tmap, r_codes.astype(jnp.int32),
                                      axis=1)
    segs, order, in_chain = jax.vmap(
        lambda a, b, c, d: _chain_pipeline(a, b, c, d, config))(
            q_codes, q_valid, r_codes, r_valid)
    return _compact_chain(segs, order, in_chain)


def align_cdna_windows_dispatch(index, pairs: list,
                                config: GmapConfig = GmapConfig(),
                                device_ctx=None):
    """Dispatch the device chain stage for a window group WITHOUT
    blocking (async): returns an opaque handle for
    align_cdna_windows_finish. Dispatching several groups before
    finishing any lets host-side refinement overlap device compute.
    device_ctx: optional MeshContext — window rows shard across the
    mesh (parallel/pipeline.MeshContext.gmap_windows)."""
    Qp = _bucket(max(len(p[0]) for p in pairs))
    Rp = _bucket(max(p[3] for p in pairs))
    if Qp // 16 > config.n_segments:
        from dataclasses import replace
        config = replace(config, n_segments=min(512, Qp // 16))
    N = len(pairs)
    qc = np.zeros((N, Qp), np.uint8)
    qv = np.zeros((N, Qp), bool)
    ws = np.zeros(N, np.uint32)
    wl = np.zeros(N, np.int32)
    sp = np.zeros(N, np.int32)
    for i, (qq, nn, gstart, glen, strand) in enumerate(pairs):
        qc[i, :len(qq)] = qq
        qv[i, :len(qq)] = ~nn.astype(bool)
        ws[i] = gstart
        wl[i] = glen
        sp[i] = strand          # strand selects the mode space (fwd/rc)
    if device_ctx is not None:
        dev = device_ctx.gmap_windows(qc, qv, ws, wl, sp, Rp, config)
    else:
        dev = _chain_pipeline_windows(
            index.genome_packed, index.genome_nmask, jnp.asarray(qc),
            jnp.asarray(qv), jnp.asarray(ws), jnp.asarray(wl),
            jnp.asarray(sp), Rp, config)
    return (pairs, config, dev)


def align_cdna_windows_finish(db, handle, known=None, fetched=None):
    """Fetch a dispatched group's chains and run host refinement.

    fetched: optional pre-fetched (cdiag, cqs, cqe, cok) numpy tuple —
    the bulk driver fetches on a background thread (one bitcast-concat
    RPC) so group k's host refinement overlaps group k+1's device wait.
    """
    pairs, config, dev = handle
    if fetched is None:
        from tpumap.utils.fetch import device_fetch
        fetched = device_fetch(dev)
    cdiag, cqs, cqe, cok = fetched

    from tpumap.ops.mode import MODE_SPACES
    spaces = MODE_SPACES[config.mode]
    out = []
    for i, (qq, nn, gstart, glen, strand) in enumerate(pairs):
        sel = np.nonzero(cok[i])[0]
        if len(sel) == 0:
            out.append(None)
            continue
        chain = [(int(cdiag[i][s]) - chain_ops.DIAG_BIAS,
                  int(cqs[i][s]), int(cqe[i][s])) for s in sel]
        rcodes = db.get_codes(gstart, glen)
        rnmask = db.get_nmask(gstart, glen).astype(bool)
        result = refine_chain(qq, nn, rcodes, rnmask, chain, config,
                              known=known, univ_off=gstart,
                              space=spaces[strand])
        if result is not None:
            result.strand = strand
        out.append(result)
    return out


def align_cdna_windows(index, db, pairs: list,
                       config: GmapConfig = GmapConfig(), known=None):
    """Chain + refine MANY (query, genome-window) problems in one device
    call with on-device region extraction.

    pairs: list of (qcodes, qnmask, gstart, glen, strand); qcodes already
    in aligned orientation. Returns [ExonChain|None] parallel to pairs.
    """
    if not pairs:
        return []
    return align_cdna_windows_finish(
        db, align_cdna_windows_dispatch(index, pairs, config), known=known)


def align_cdna_pairs(pairs: list, config: GmapConfig = GmapConfig(),
                     known=None):
    """Chain + refine MANY (query, region) problems in one device call.

    pairs: list of (qcodes, qnmask, rcodes, rnmask, strand, univ_off);
    qcodes must already be in the aligned orientation (revcomp for
    strand 1). Returns list of (ExonChain|None) parallel to pairs.
    """
    if not pairs:
        return []
    Qp = _bucket(max(len(p[0]) for p in pairs))
    Rp = _bucket(max(len(p[2]) for p in pairs))
    # long queries need more chain segments than the default (one per
    # exon plus noise; the reference accepts <=100 kbp queries,
    # src/gmap.c:113) — scale with the query bucket, bounded
    if Qp // 16 > config.n_segments:
        from dataclasses import replace
        config = replace(config, n_segments=min(512, Qp // 16))
    N = len(pairs)
    qc = np.zeros((N, Qp), np.uint8)
    qv = np.zeros((N, Qp), bool)
    rc = np.zeros((N, Rp), np.uint8)
    rv = np.zeros((N, Rp), bool)
    from tpumap.ops.mode import CODE_MAPS, MODE_SPACES
    spaces = MODE_SPACES[config.mode]
    for i, (qq, nn, rcodes, rnmask, strand, _off) in enumerate(pairs):
        sp_ = spaces[strand]
        if sp_ is not None:
            qq, rcodes = CODE_MAPS[sp_][qq], CODE_MAPS[sp_][rcodes]
        qc[i, :len(qq)] = qq
        qv[i, :len(qq)] = ~nn.astype(bool)
        rc[i, :len(rcodes)] = rcodes
        rv[i, :len(rcodes)] = ~rnmask.astype(bool)
    segs, order, in_chain = _chain_pipeline_batch(
        jnp.asarray(qc), jnp.asarray(qv), jnp.asarray(rc), jnp.asarray(rv),
        config)
    segs = {k: np.asarray(v) for k, v in segs.items()}
    order = np.asarray(order)
    in_chain = np.asarray(in_chain)

    out = []
    for i, (qq, nn, rcodes, rnmask, strand, univ_off) in enumerate(pairs):
        members = [s for s in order[i][in_chain[i]] if segs["valid"][i][s]]
        if not members:
            out.append(None)
            continue
        chain = [(int(segs["diag"][i][s]) - chain_ops.DIAG_BIAS,
                  int(segs["qstart"][i][s]), int(segs["qend"][i][s]))
                 for s in members]
        result = refine_chain(qq, nn, rcodes, rnmask, chain, config,
                              known=known, univ_off=univ_off,
                              space=spaces[strand])
        if result is not None:
            result.strand = strand
        out.append(result)
    return out


def align_cdna_regions(query_codes: np.ndarray, query_nmask: np.ndarray,
                       regions: list, config: GmapConfig = GmapConfig(),
                       known=None):
    """Chain + refine one query against SEVERAL candidate regions in one
    device call (see align_cdna_pairs).

    regions: list of (region_codes, region_nmask, strand, univ_off).
    """
    if not regions:
        return []
    rc_q = dna.revcomp_codes(query_codes)
    rc_n = query_nmask[::-1]
    pairs = [((rc_q if strand else query_codes),
              (rc_n if strand else query_nmask),
              rcodes, rnmask, strand, off)
             for (rcodes, rnmask, strand, off) in regions]
    return align_cdna_pairs(pairs, config, known=known)


def align_cdna(query_codes: np.ndarray, query_nmask: np.ndarray,
               region_codes: np.ndarray, region_nmask: np.ndarray,
               config: GmapConfig = GmapConfig(), known=None,
               univ_off: int = 0, space: str | None = None
               ) -> ExonChain | None:
    """Align one cDNA query against one genomic region (+ orientation).

    Pads to shape buckets, runs the device chain pipeline, refines exon
    boundaries on host. Returns None if no chain was found.
    space: mode base space for this orientation (ops/mode.py).
    """
    Q, R = len(query_codes), len(region_codes)
    Qp, Rp = _bucket(Q), _bucket(R)
    cq, cr = query_codes, region_codes
    if space is not None:
        from tpumap.ops.mode import CODE_MAPS
        cq, cr = CODE_MAPS[space][cq], CODE_MAPS[space][cr]
    qc = np.zeros(Qp, np.uint8); qc[:Q] = cq
    qv = np.zeros(Qp, bool); qv[:Q] = ~query_nmask.astype(bool)
    rc = np.zeros(Rp, np.uint8); rc[:R] = cr
    rv = np.zeros(Rp, bool); rv[:R] = ~region_nmask.astype(bool)

    segs, order, in_chain = _chain_pipeline(
        jnp.asarray(qc), jnp.asarray(qv), jnp.asarray(rc), jnp.asarray(rv),
        config)
    segs = {k: np.asarray(v) for k, v in segs.items()}
    order = np.asarray(order)
    in_chain = np.asarray(in_chain)

    members = [s for s in order[in_chain] if segs["valid"][s]]
    if not members:
        return None
    # order already q-sorted among chain members
    chain = [(int(segs["diag"][s]) - chain_ops.DIAG_BIAS,
              int(segs["qstart"][s]), int(segs["qend"][s])) for s in members]
    return refine_chain(query_codes, query_nmask, region_codes, region_nmask,
                        chain, config, known=known, univ_off=univ_off,
                        space=space)


def _bucket(n: int) -> int:
    b = 256
    while b < n:
        b *= 2
    return b


def _mm(query_codes, query_nmask, region_codes, region_nmask, diag, q0, q1):
    """bool[q1-q0] mismatch flags of query[q0:q1) on diagonal `diag`."""
    g0, g1 = q0 + diag, q1 + diag
    if 0 <= g0 and g1 <= len(region_codes):
        # hot path: pure slice views, no index arrays (this helper runs
        # thousands of times per bulk-GMAP batch on the 1-core host)
        mm = query_codes[q0:q1] != region_codes[g0:g1]
        np.logical_or(mm, query_nmask[q0:q1], out=mm)
        np.logical_or(mm, region_nmask[g0:g1], out=mm)
        return mm
    q = np.arange(q0, q1)
    g = q + diag
    inb = (g >= 0) & (g < len(region_codes))
    gg = np.clip(g, 0, len(region_codes) - 1)
    mm = (query_codes[q] != region_codes[gg])
    mm |= query_nmask[q].astype(bool) | region_nmask[gg].astype(bool) | ~inb
    return mm


MIN_MICROEXON = 3        # src/dynprog_single.c:83
MAX_MICROEXON = 12       # src/dynprog_single.c:87
MICROINTRON_LEN = 9      # shortest intron flanking a microexon
MICROEXON_SCAN_CAP = 262_144   # interior bases scanned per junction


def _second_mismatch(mm: np.ndarray) -> int:
    """Index of the second True in mm (len(mm)-1 if fewer than two) —
    the leftbound/rightbound scan of Dynprog_microexon_int
    (src/dynprog_single.c:1002-1047, 'while nmismatches <= 1')."""
    w = np.nonzero(mm)[0]
    return int(w[1]) if len(w) >= 2 else len(mm) - 1


def _find_microexon(query_codes, query_nmask, region_codes, region_nmask,
                    dA, dB, qL, qR, q_cmp=None, r_cmp=None):
    """Dynprog_microexon_int analog (src/dynprog_single.c:900-1181): for
    the gap between diagonals dA and dB over query [qL, qR), search for a
    short exact-match exon inside the intron interior with canonical
    dinucleotides on all four new boundaries, ranked by the MaxEnt prob
    sum of the two interior sites. Tries sense (GT..AG twice) and
    antisense (CT..AC twice). Returns (qs_m, qe_m, diag_m, probsum) or
    None."""
    from tpumap.gmap import maxent

    if q_cmp is None:
        q_cmp, r_cmp = query_codes, region_codes
    R = len(region_codes)
    rlen = qR - qL
    if rlen < 2 + MIN_MICROEXON:
        return None
    gL = qL + dA                      # genome pos of query qL on diag A
    gR = (qR - 1) + dB                # genome pos of query qR-1 on diag B
    if gL < 0 or gR >= R or gR <= gL:
        return None
    mmL = _mm(q_cmp, query_nmask, r_cmp, region_nmask, dA, qL, qR)
    mmR = _mm(q_cmp, query_nmask, r_cmp, region_nmask, dB, qL, qR)[::-1]
    leftbound = _second_mismatch(mmL)
    rightbound = _second_mismatch(mmR)

    best = None
    for i1, i2, i3, i4, anti in ((2, 3, 0, 2, False),   # GT..AG x2
                                 (1, 3, 0, 1, True)):   # CT..AC x2
        for cL in range(1, leftbound + 1):
            p = gL + cL
            if p + 1 >= R or region_codes[p] != i1 or region_codes[p + 1] != i2 \
                    or region_nmask[p] or region_nmask[p + 1]:
                continue
            mincR = max(1, rlen - MAX_MICROEXON - cL)
            maxcR = min(rightbound, rlen - MIN_MICROEXON - cL)
            for cR in range(mincR, maxcR + 1):
                p3 = gR - cR - 1
                if p3 < 0 or region_codes[p3] != i3 \
                        or region_codes[p3 + 1] != i4 \
                        or region_nmask[p3] or region_nmask[p3 + 1]:
                    continue
                mlen = rlen - cL - cR
                mid = q_cmp[qL + cL:qL + cL + mlen]
                if np.any(query_nmask[qL + cL:qL + cL + mlen]):
                    continue
                textleft = gL + cL + MICROINTRON_LEN
                textright = gR - cR - MICROINTRON_LEN + 1
                if textright - textleft > MICROEXON_SCAN_CAP:
                    textright = textleft + MICROEXON_SCAN_CAP
                if textright < textleft + mlen:
                    continue
                interior = r_cmp[textleft:textright]
                win = np.lib.stride_tricks.sliding_window_view(interior,
                                                               mlen)
                hits = np.nonzero(np.all(win == mid[None, :], axis=1))[0]
                for h in hits:
                    cand = textleft + int(h)
                    # end of left intron before, start of right intron
                    # after (src/dynprog_single.c:1125-1135)
                    if (region_codes[cand - 2] != i3
                            or region_codes[cand - 1] != i4
                            or region_codes[cand + mlen] != i1
                            or region_codes[cand + mlen + 1] != i2):
                        continue
                    if not anti:
                        p2 = maxent.acceptor_prob_at(
                            region_codes, region_nmask, cand - 1)[0]
                        p3v = maxent.donor_prob_at(
                            region_codes, region_nmask, cand + mlen)[0]
                    else:
                        p2 = maxent.antidonor_prob_at(
                            region_codes, region_nmask, cand)[0]
                        p3v = maxent.antiacceptor_prob_at(
                            region_codes, region_nmask, cand + mlen)[0]
                    probsum = float(p2) + float(p3v)
                    if best is None or probsum > best[3]:
                        best = (qL + cL, qL + cL + mlen, cand - (qL + cL),
                                probsum)
    return best


def _zap_chance_exons(chain, k):
    """Smooth_pairs_by_netgap analog (src/smooth.c): drop INTERNAL chain
    segments short enough that an exact match of that length is expected
    by chance inside the flanking genomic gap (4^len < 4 * gapspan).
    True microexons zapped here are recovered by _find_microexon with
    canonical-structure constraints."""
    if len(chain) <= 2:
        return chain
    out = [chain[0]]
    for i in range(1, len(chain) - 1):
        d, qs, qe = chain[i]
        qlen = qe - qs + k          # qe is the last anchor START
        dprev = out[-1][0]
        dnext = chain[i + 1][0]
        span = abs(int(dnext) - int(dprev))
        if qlen < 16 and span > 0 and 4.0 ** qlen < 4.0 * span:
            continue
        out.append(chain[i])
    out.append(chain[-1])
    return out


def refine_chain(query_codes, query_nmask, region_codes, region_nmask,
                 chain, config: GmapConfig, known=None,
                 univ_off: int = 0, _smooth: bool = True,
                 space: str | None = None) -> ExonChain:
    """Host refinement: junction placement + end extension/trimming.

    known: optional KnownSplicing — junction boundaries landing on known
    donor/acceptor (or antisense) site pairs get a bonus that outranks
    canonical dinucleotides and MaxEnt probabilities (the splicetrie
    known-splice path of Dynprog_genome_gap, src/dynprog_genome.c:417-474);
    univ_off converts region coordinates to univcoords for the lookup."""
    k = config.index_k
    Q = len(query_codes)
    R = len(region_codes)

    # mode spaces (gmap --mode): mismatches are counted in the reduced
    # base space; splice dinucleotides/MaxEnt use the original bases
    if space is not None:
        from tpumap.ops.mode import CODE_MAPS
        q_cmp = CODE_MAPS[space][query_codes]
        r_cmp = CODE_MAPS[space][region_codes]
    else:
        q_cmp, r_cmp = query_codes, region_codes

    # fuse chain entries on the same diagonal (continuation segments)
    fused = [list(chain[0])]
    for d, qs, qe in chain[1:]:
        if d == fused[-1][0]:
            fused[-1][2] = qe
        else:
            fused.append([d, qs, qe])
    chain = fused
    if _smooth:
        chain = _zap_chance_exons(chain, k)

    boundaries = []   # q* for each junction
    ins_offsets = []  # inserted query bases at each junction (0 if none)
    introns = []
    micro_inserts = []   # (chain index i, (d, qs, qe)) microexon entries
    for (dA, qsA, qeA), (dB, qsB, qeB) in zip(chain, chain[1:]):
        lo = max(qeA + 1, 1)
        hi = min(qsB + k, Q - 1)
        if hi < lo:
            lo = hi = max(min(qsB, Q - 1), 1)
        cand = np.arange(lo, hi + 1)
        mmA = _mm(q_cmp, query_nmask, r_cmp, region_nmask,
                  dA, lo - 1, hi + 1)
        mmB = _mm(q_cmp, query_nmask, r_cmp, region_nmask,
                  dB, lo - 1, hi + 1)
        # mismatches if boundary at q*: A covers [lo-1, q*); B covers
        # [q* + ins, hi] where ins = inserted query bases (dB < dA means
        # an insertion junction: those bases match NEITHER diagonal and
        # are excluded, not charged as mismatches)
        ins = (dA - dB) if dB < dA else 0
        costA = np.cumsum(mmA)[:len(cand)]              # A mm in [lo-1, q*)
        sfx = np.concatenate([np.cumsum(mmB[::-1])[::-1],
                              np.zeros(1, mmB.dtype)])  # sfx[t]=mm[t:]
        idxB = np.minimum(cand + ins - (lo - 1), len(mmB))
        costB = sfx[idxB]
        cost = (costA + costB).astype(np.float64) * MM_COST
        bonus, kinds = splice_score_canonical(region_codes, dA, dB, cand)
        if config.canonical_mode == 0:
            bonus = np.zeros_like(bonus)
        elif config.canonical_mode == 2:
            bonus = 2.0 * bonus
        glen = dB - dA
        splice_ok = config.splicing and glen >= config.min_intronlength
        if splice_ok:
            # MaxEnt donor/acceptor probabilities refine the placement
            # (the reference's bridge scoring, dynprog_genome.c)
            dprob = maxent.donor_prob_at(region_codes, region_nmask,
                                         cand + dA)
            aprob = maxent.acceptor_prob_at(region_codes, region_nmask,
                                            cand + dB - 1)
            bonus = bonus + PROB_WEIGHT * (dprob + aprob)
        else:
            dprob = aprob = np.zeros(len(cand))
        if known is not None and splice_ok:
            left = univ_off + dA + cand.astype(np.int64)
            right = univ_off + dB + cand.astype(np.int64)
            k_s = (np.isin(left, known.donor)
                   & np.isin(right, known.acceptor))
            k_a = (np.isin(left, known.antiacceptor)
                   & np.isin(right, known.antidonor))
            bonus = bonus + np.where(k_s | k_a, 6.0, 0.0)
        score = bonus - cost
        j = int(np.argmax(score))
        qstar = int(cand[j])
        boundaries.append(qstar)
        ins_offsets.append(ins)
        # dual-intron / microexon attempt (traverse_genome_gap ->
        # Dynprog_microexon_int, src/stage3.c:9658-9677): when the single
        # bridge is noncanonical or still mismatch-heavy and the gap can
        # hold two introns, search the interior for a canonical microexon
        # trigger: mismatch-heavy bridge, or noncanonical with at least
        # one unexplained mismatch (a CLEAN noncanonical junction stays —
        # the reference only searches when cdna_direction is determinate,
        # src/dynprog_single.c:963-967, so clean direction-less junctions
        # never grow microexons there either)
        if (_smooth and splice_ok and dB > dA
                and glen >= 2 * MICROINTRON_LEN + MIN_MICROEXON
                and (cost[j] >= 2 * MM_COST
                     or (not kinds[j] and cost[j] >= MM_COST))):
            i_pair = len(boundaries) - 1
            qGL = max(qsA if i_pair == 0 else qeA - 6, 0)
            qGR = min(qsB + k + 6, Q)
            hit = _find_microexon(query_codes, query_nmask, region_codes,
                                  region_nmask, dA, dB, qGL, qGR,
                                  q_cmp=q_cmp, r_cmp=r_cmp)
            if hit is not None:
                qs_m, qe_m, d_m, _prob = hit
                if dA < d_m < dB:
                    micro_inserts.append((i_pair, [d_m, qs_m, qe_m - 1]))
        is_intron = (dB > dA and splice_ok
                     and (glen > config.max_deletionlength or kinds[j]))
        if is_intron:
            introns.append(Intron("intron", glen, kinds[j],
                                  donor_prob=float(dprob[j]),
                                  acceptor_prob=float(aprob[j])))
        elif dB > dA:
            introns.append(Intron("deletion", glen))
        else:
            introns.append(Intron("insertion", dA - dB))

    if micro_inserts:
        # rebuild the chain with the microexons inserted and re-place all
        # boundaries (one level only: _smooth=False)
        new_chain = []
        ins = {i: e for i, e in micro_inserts}
        for i, entry in enumerate(chain):
            new_chain.append(entry)
            if i in ins:
                new_chain.append(ins[i])
        return refine_chain(query_codes, query_nmask, region_codes,
                            region_nmask, new_chain, config, known=known,
                            univ_off=univ_off, _smooth=False, space=space)

    # exon spans in query space
    qspans = []
    start = 0
    for i, (d, qs, qe) in enumerate(chain):
        # inserted query bases at the preceding junction belong to
        # neither exon (a query gap; printers read the insertion from
        # e2.qstart - e1.qend)
        qlo = (boundaries[i - 1] + ins_offsets[i - 1]) if i > 0 else 0
        qhi = boundaries[i] if i < len(boundaries) else Q
        qspans.append((qlo, min(qhi, Q), d))

    # end trimming + weak-terminal-exon pruning, iterated to a fixed point
    # (the Stage3 trim_ends + Smooth_pairs role, src/stage3.c, src/smooth.c:
    # a terminal exon must buy more score than its junction costs, else it
    # is a spurious anchor and the end is re-trimmed)
    def span_score(qlo, qhi, d):
        if qhi <= qlo:
            return 0
        mm = _mm(q_cmp, query_nmask, r_cmp, region_nmask,
                 d, qlo, qhi)
        return int((~mm).sum()) - MM_COST * int(mm.sum())

    def junction_penalty(intron: Intron) -> int:
        if intron.kind == "intron":
            return 8 if intron.canonical else 16
        return 10

    while True:
        # trim the outer ends of the terminal spans
        (qlo0, qhi0, d0) = qspans[0]
        mm0 = _mm(q_cmp, query_nmask, r_cmp, region_nmask,
                  d0, 0, qhi0)
        score = np.where(mm0, -MM_COST, 1)
        sufsum = np.cumsum(score[::-1])[::-1]
        t0 = int(np.argmax(sufsum)) if len(sufsum) else 0
        if len(sufsum) and sufsum[t0] <= 0:
            t0 = qhi0
        qspans[0] = (t0, qhi0, d0)

        (qloN, qhiN, dN) = qspans[-1]
        mmN = _mm(q_cmp, query_nmask, r_cmp, region_nmask,
                  dN, qloN, Q)
        score = np.where(mmN, -MM_COST, 1)
        prefsum = np.cumsum(score)
        tN = int(np.argmax(prefsum)) + 1 if len(prefsum) else 0
        if tN and prefsum[tN - 1] <= 0:
            tN = 0
        qspans[-1] = (qloN, qloN + tN, dN)

        if len(qspans) == 1:
            break
        # drop weak terminal exons
        s0 = span_score(*qspans[0])
        if s0 <= junction_penalty(introns[0]):
            qspans.pop(0)
            introns.pop(0)
            continue
        sN = span_score(*qspans[-1])
        if sN <= junction_penalty(introns[-1]):
            qspans.pop()
            introns.pop()
            continue
        break

    # indel-capable END extension (Dynprog_end5_gap/Dynprog_end3_gap with
    # QUERYEND_INDELS, src/dynprog_end.h:26,48 + src/dynprog.h:25): the
    # substitution-only trim above clips a query end that actually
    # continues across ONE small indel; try a shifted-diagonal outer
    # piece at each trimmed end and keep it when it buys score
    _end_gap_extend(q_cmp, query_nmask, r_cmp, region_nmask, qspans,
                    introns, Q)

    exons = []
    kept_introns = []
    for i, (qlo, qhi, d) in enumerate(qspans):
        if qhi <= qlo:
            continue
        mm = _mm(q_cmp, query_nmask, r_cmp, region_nmask,
                 d, qlo, qhi)
        if exons and i - 1 < len(introns):
            kept_introns.append(introns[i - 1])
        exons.append(Exon(qstart=qlo, qend=qhi, gstart=qlo + d, gend=qhi + d,
                          matches=int((~mm).sum()), mismatches=int(mm.sum())))
    result = ExonChain(exons=exons, introns=kept_introns)
    _set_direction(result)
    return result


MAX_END_INDEL = 3        # largest single end-gap indel tried per end
END_GAP_MIN = 3          # trimmed bases needed to attempt recovery


def _end_gap_extend(q_cmp, query_nmask, r_cmp, region_nmask, qspans,
                    introns, Q) -> None:
    """Recover ONE small indel inside a trimmed query end, in place.

    For each trimmed end, try outer pieces on a diagonal shifted by a
    1..MAX_END_INDEL-base deletion or insertion; the boundary p and the
    outer piece's own trim are chosen to maximize (matches - 3*mm) with
    an affine indel charge, and the extension is kept when the net gain
    is positive — the Dynprog_end5/3_gap QUERYEND_INDELS economics
    (match +1 / mismatch -3, open -4, extend -1)."""
    def mm_score(d, a, b):
        mm = _mm(q_cmp, query_nmask, r_cmp, region_nmask, d, a, b)
        return np.where(mm, -MM_COST, 1).astype(np.int64)

    # ---- 5' end: outer piece covers [qlo', p), main exon starts at p
    qlo0, qhi0, d0 = qspans[0]
    if qlo0 >= END_GAP_MIN:
        sc_main = mm_score(d0, 0, qlo0)
        # G[p] = score of extending the main exon down to p on d0
        G = np.concatenate([np.cumsum(sc_main[::-1])[::-1], [0]])
        best = (0, None)
        for glen in range(1, MAX_END_INDEL + 1):
            for kind in ("deletion", "insertion"):
                dO = d0 - glen if kind == "deletion" else d0 + glen
                n_ins = glen if kind == "insertion" else 0
                sc_out = mm_score(dO, 0, qlo0)
                # run[j] = best sum of a suffix of sc_out[..j) (>=1 base)
                run = np.empty(qlo0 + 1, np.int64)
                run[0] = -(2 ** 30)
                acc = 0
                for j in range(1, qlo0 + 1):
                    acc = max(acc, 0) + sc_out[j - 1]
                    run[j] = acc
                pen = 4 + glen
                for p in range(1 + n_ins, qlo0 + 1):
                    tot = G[p] + run[p - n_ins] - pen
                    if tot > best[0]:
                        best = (tot, (p, dO, kind, glen))
        if best[1] is not None:
            p, dO, kind, glen = best[1]
            n_ins = glen if kind == "insertion" else 0
            # outer piece start = argmax of the BOUNDARY-ANCHORED sums
            # (the interval must reach the junction at p - n_ins, so no
            # Kadane reset — that would pick a disconnected interval)
            sc_out = mm_score(dO, 0, p - n_ins)
            acc, start, bestv = 0, p - n_ins, 0
            for j in range(p - n_ins - 1, -1, -1):
                acc += sc_out[j]
                if acc >= bestv:
                    bestv, start = acc, j
            qspans[0] = (p, qhi0, d0)
            qspans.insert(0, (start, p - n_ins, dO))
            introns.insert(0, Intron(kind, glen))

    # ---- 3' end: main exon ends at p, outer piece covers [p + ins, qhi')
    qloN, qhiN, dN = qspans[-1]
    if Q - qhiN >= END_GAP_MIN:
        # the boundary may RETRACT a few bases into the trimmed exon so
        # an indel inside a repeat left-aligns (SAM convention; ties in
        # a homopolymer score identically and the smallest p wins)
        back = min(8, qhiN - qloN - 1)
        lo = qhiN - max(back, 0)
        sc_main = mm_score(dN, lo, Q)
        # G[t] = score delta of moving the main-exon end to lo + t
        base = np.concatenate([[0], np.cumsum(sc_main)])
        G = base - base[qhiN - lo]
        best = (0, None)
        W = Q - lo
        for glen in range(1, MAX_END_INDEL + 1):
            for kind in ("deletion", "insertion"):
                dO = dN + glen if kind == "deletion" else dN - glen
                n_ins = glen if kind == "insertion" else 0
                sc_out = mm_score(dO, lo, Q)
                run = np.empty(W + 1, np.int64)
                run[W] = -(2 ** 30)
                acc = 0
                for j in range(W - 1, -1, -1):
                    acc = max(acc, 0) + sc_out[j]
                    run[j] = acc
                pen = 4 + glen
                for t in range(0, W - n_ins):
                    # boundary p = lo + t; outer starts at p + n_ins
                    tot = G[t] + run[t + n_ins] - pen
                    if tot > best[0]:
                        best = (tot, (t, dO, kind, glen))
        if best[1] is not None:
            t, dO, kind, glen = best[1]
            n_ins = glen if kind == "insertion" else 0
            p = lo + t
            # boundary-anchored prefix sums (see 5' side)
            sc_out = mm_score(dO, p + n_ins, Q)
            acc, end, bestv = 0, p + n_ins, 0
            for j in range(len(sc_out)):
                acc += sc_out[j]
                if acc >= bestv:
                    bestv, end = acc, p + n_ins + j + 1
            qspans[-1] = (qloN, p, dN)
            qspans.append((p + n_ins, end, dO))
            introns.append(Intron(kind, glen))


def _set_direction(result: ExonChain) -> None:
    sense = sum(1 for i in result.introns if i.canonical in
                ("GT-AG", "GC-AG", "AT-AC"))
    anti = sum(1 for i in result.introns if i.canonical in
               ("CT-AC", "CT-GC", "GT-AT"))
    result.cdna_direction = (1 if sense > anti else
                             -1 if anti > sense else 0)


def align_cdna_both(query_codes, query_nmask, region_codes, region_nmask,
                    config: GmapConfig = GmapConfig(), strand=None):
    """Try + and - query orientations; return (best chain, strand).

    strand (gmap --strand): 0 = plus only, 1 = minus only, None = both."""
    from tpumap.ops.mode import MODE_SPACES
    spaces = MODE_SPACES[config.mode]
    fwd = None
    if strand in (None, 0):
        fwd = align_cdna(query_codes, query_nmask, region_codes,
                         region_nmask, config, space=spaces[0])
    rev = None
    if strand in (None, 1):
        rc = dna.revcomp_codes(query_codes)
        rcn = query_nmask[::-1].copy()
        rev = align_cdna(rc, rcn, region_codes, region_nmask, config,
                         space=spaces[1])
    if rev is None:
        if fwd is not None:
            fwd.strand = 0
        return fwd
    if fwd is None:
        rev.strand = 1
        return rev

    def goodness(c):
        if c is None:
            return -1
        return c.matches - 3 * c.mismatches

    if goodness(fwd) >= goodness(rev):
        if fwd is not None:
            fwd.strand = 0
        return fwd
    rev.strand = 1
    return rev


def trim_end_exons(chain: ExonChain, minendexon: int) -> ExonChain:
    """gmap --trim-end-exons: drop terminal exons with fewer than
    `minendexon` matches (src/gmap.c minendexon)."""
    exons = list(chain.exons)
    introns = list(chain.introns)
    changed = False
    while len(exons) > 1 and exons[0].matches < minendexon:
        exons.pop(0)
        introns.pop(0)
        changed = True
    while len(exons) > 1 and exons[-1].matches < minendexon:
        exons.pop()
        introns.pop()
        changed = True
    if not changed:
        return chain
    return ExonChain(exons=exons, introns=introns, strand=chain.strand,
                     cdna_direction=chain.cdna_direction)
