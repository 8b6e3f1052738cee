"""GMAP chimera detection (two-part cDNA alignments).

Capability analog of src/chimera.c + the chimera pass in the gmap driver
(src/gmap.c:2435-3000): when the best alignment leaves a substantial
uncovered query margin (>= chimera_margin, gmap -x), the margin is
re-aligned independently (Stage1 re-run on the margin,
src/gmap.c:2776-2956); a good margin alignment yields a second path, and
the query is reported as a chimera with a breakpoint.

The batched re-expression is host-side orchestration re-invoking the
batched region pipeline on the margin subsequence, then shifting the
resulting exon chain back into whole-query coordinates.
"""
from __future__ import annotations

import numpy as np

DEFAULT_CHIMERA_MARGIN = 30          # gmap -x default region of interest


def query_span(chain, qlen: int) -> tuple[int, int]:
    """Covered query span [qs, qe) in ORIGINAL query orientation."""
    qs = min(e.qstart for e in chain.exons)
    qe = max(e.qend for e in chain.exons)
    if chain.strand:
        return qlen - qe, qlen - qs
    return qs, qe


def shift_chain(chain, offset_in_query: int, sub_len: int, qlen: int):
    """Rewrite a chain aligned to query[offset : offset+sub_len] into
    whole-query coordinates (orientation-aware)."""
    if chain.strand:
        # chain q coords index revcomp(sub); in revcomp(full query) the
        # same bases start at qlen - (offset + sub_len)
        shift = qlen - (offset_in_query + sub_len)
    else:
        shift = offset_in_query
    for e in chain.exons:
        e.qstart += shift
        e.qend += shift
    return chain


def align_query_chimera(db, index, qcodes: np.ndarray, qnmask: np.ndarray,
                        config, s1config,
                        chimera_margin: int = DEFAULT_CHIMERA_MARGIN,
                        min_piece_coverage: float = 0.5):
    """Full-query alignment with chimera fallback.

    Returns a list of (chain, univ_offset) pieces ordered by query
    position — one entry for a normal alignment, two for a chimera.
    """
    from tpumap.cli.gmap_cli import align_query_to_db, chain_goodness

    best, off = align_query_to_db(db, index, qcodes, qnmask, config,
                                  s1config)
    if best is None:
        return []
    qlen = len(qcodes)
    pieces = [(best, off)]
    qs, qe = query_span(best, qlen)
    margins = []
    if qs >= chimera_margin:
        margins.append((0, qs))
    if qlen - qe >= chimera_margin:
        margins.append((qe, qlen))
    for (ms, me) in margins:
        sub_c = np.ascontiguousarray(qcodes[ms:me])
        sub_n = np.ascontiguousarray(qnmask[ms:me])
        piece, poff = align_query_to_db(db, index, sub_c, sub_n, config,
                                        s1config)
        if piece is None:
            continue
        if piece.coverage < min_piece_coverage * (me - ms):
            continue
        if chain_goodness(piece) <= 0:
            continue
        shift_chain(piece, ms, me - ms, qlen)
        pieces.append((piece, poff))
    # order by query position
    pieces.sort(key=lambda p: query_span(p[0], qlen)[0])
    if len(pieces) >= 2:
        # exon-exon breakpoint refinement (Chimera_find_exonexon): the
        # two parts must meet at ONE query coordinate; the best
        # donorxacceptor MaxEnt boundary near the join decides where,
        # and each part is trimmed/extended on its diagonal to meet it
        found = refine_breakpoint(db, pieces, qlen, qcodes=qcodes)
        if found is not None:
            from tpumap.utils import dna as dna_utils
            bp1 = found[0] + 1            # first right-part base
            rc = dna_utils.revcomp_codes(qcodes)
            (c1, o1), (c2, o2) = pieces[0], pieces[1]
            trim_to_query(c1, qlen, 0, bp1)
            trim_to_query(c2, qlen, bp1, qlen)
            if c1.exons:
                qs1n, _qe = query_span(c1, qlen)
                extend_to_query(db, c1, o1, rc if c1.strand else qcodes,
                                qlen, qs1n, bp1)
            if c2.exons:
                _qs, qe2n = query_span(c2, qlen)
                extend_to_query(db, c2, o2, rc if c2.strand else qcodes,
                                qlen, bp1, qe2n)
            pieces = [p for p in pieces if p[0].exons]
    return pieces


def breakpoint(pieces, qlen: int) -> int | None:
    """Chimeric breakpoint (query coordinate) between two pieces
    (Chimera_find_breakpoint concept, src/chimera.c)."""
    if len(pieces) < 2:
        return None
    (_c1, _o1), (_c2, _o2) = pieces[0], pieces[1]
    _qs1, qe1 = query_span(pieces[0][0], qlen)
    qs2, _qe2 = query_span(pieces[1][0], qlen)
    return (qe1 + qs2) // 2


def _gpos(chain, off, aligned_q: int) -> int:
    """Watson univcoord of aligned-query position `aligned_q`,
    extrapolating on the diagonal of the nearest exon."""
    e = chain.exons[0]
    for ex in chain.exons:
        if ex.qstart <= aligned_q:
            e = ex
    return off + e.gstart - e.qstart + aligned_q


def match_profile(db, piece, qcodes, qlen: int) -> np.ndarray:
    """Per-ORIGINAL-query-position match indicator under the piece's
    exon diagonals (the Pair_pathscores input, src/chimera.c:650-667)."""
    from tpumap.utils import dna as dna_utils

    chain, off = piece
    qa = dna_utils.revcomp_codes(qcodes) if chain.strand else qcodes
    prof = np.zeros(qlen, dtype=np.int32)
    for e in chain.exons:
        g0 = off + e.gstart - e.qstart
        if g0 + e.qstart < 0 or g0 + e.qend > db.genome_length:
            continue
        gseg = db.get_codes(g0 + e.qstart, e.qend - e.qstart)
        prof[e.qstart:e.qend] = (gseg == qa[e.qstart:e.qend])
    if chain.strand:
        prof = prof[::-1]
    return prof


def changepoint_scores(db, pieces, qcodes, qlen: int) -> np.ndarray:
    """score[p] = matches(left part, query <= p) + matches(right part,
    query > p) — the Chimera_find_breakpoint changepoint objective
    (src/chimera.c:671-700).  The best breakpoints maximize it."""
    m1 = np.cumsum(match_profile(db, pieces[0], qcodes, qlen))
    p2 = match_profile(db, pieces[1], qcodes, qlen)
    m2suf = np.concatenate([np.cumsum(p2[::-1])[::-1], [0]])
    return m1 + m2suf[1:qlen + 1]


def find_exonexon(db, left_piece, right_piece, qlen: int,
                  bp_start: int, bp_end: int, allowed=None):
    """Chimera_find_exonexon (src/chimera.c:1092): scan every candidate
    breakpoint in [bp_start, bp_end] for a donor-like site at the left
    part's boundary AND an acceptor-like site at the right part's
    boundary, maximizing the MaxEnt probability product; tried in the
    cDNA direction(s) the parts allow (find_exonexon_fwd/_rev).

    Returns (pos, cdna_direction, donor_prob, acceptor_prob) where the
    left part keeps query [.., pos] and the right part [pos+1, ..), or
    None if no splice-plausible boundary exists (the caller falls back
    to the changepoint midpoint, src/gmap.c:2656-2666).
    """
    from tpumap.gmap import maxent

    chain_l, off_l = left_piece
    chain_r, off_r = right_piece
    if bp_end < bp_start:
        return None
    P = list(range(bp_start, bp_end + 1))

    def _coords(chain, off, orig_qs):
        """Watson univcoord of each ORIGINAL-query base."""
        out = []
        for q in orig_qs:
            aligned = q if chain.strand == 0 else qlen - 1 - q
            out.append(_gpos(chain, off, aligned))
        return np.asarray(out, dtype=np.int64)

    # gl: coords of original base p (the LAST left-part base);
    # gr: coords of original base p+1 (the FIRST right-part base)
    gl = _coords(chain_l, off_l, P)
    gr = _coords(chain_r, off_r, [p + 1 for p in P])

    lo = int(min(gl.min(), gr.min())) - 32
    lo = max(lo, 0)
    hi = int(max(gl.max(), gr.max())) + 32
    seg = db.get_codes(lo, hi - lo)
    segn = db.get_nmask(lo, hi - lo).astype(bool)
    if len(seg) < hi - lo:
        return None
    gl_l, gr_l = gl - lo, gr - lo

    dirs = []
    dl, dr = chain_l.cdna_direction, chain_r.cdna_direction
    if dl >= 0 and dr >= 0:
        dirs.append(+1)
    if dl <= 0 and dr <= 0:
        dirs.append(-1)
    if not dirs:
        dirs = [+1, -1]

    def _at(pos):
        return seg[np.clip(pos, 0, len(seg) - 1)]

    def _probs(direction):
        # model + coordinate per (direction, piece strand), following
        # the conventions of gmap/maxent.py *_prob_at.  gl = last left
        # base, gr = first right base (watson coords); A=0 C=1 G=2 T=3.
        if direction == +1:
            if chain_l.strand == 0:      # intron ABOVE gl: GT at gl+1
                d = maxent.donor_prob_at(seg, segn, gl_l + 1)
                canon_d = (_at(gl_l + 1) == 2) & ((_at(gl_l + 2) == 3)
                                                  | (_at(gl_l + 2) == 1))
            else:                        # intron BELOW gl: AC at gl-2
                d = maxent.antidonor_prob_at(seg, segn, gl_l)
                canon_d = (_at(gl_l - 2) == 0) & (_at(gl_l - 1) == 1)
            if chain_r.strand == 0:      # intron BELOW gr: AG at gr-2
                a = maxent.acceptor_prob_at(seg, segn, gr_l - 1)
                canon_a = (_at(gr_l - 2) == 0) & (_at(gr_l - 1) == 2)
            else:                        # intron ABOVE gr: CT at gr+1
                a = maxent.antiacceptor_prob_at(seg, segn, gr_l + 1)
                canon_a = (_at(gr_l + 1) == 1) & (_at(gr_l + 2) == 3)
        else:
            if chain_l.strand == 0:      # antisense acc ABOVE gl: CT
                d = maxent.antiacceptor_prob_at(seg, segn, gl_l + 1)
                canon_d = (_at(gl_l + 1) == 1) & (_at(gl_l + 2) == 3)
            else:                        # sense acc BELOW gl: AG
                d = maxent.acceptor_prob_at(seg, segn, gl_l - 1)
                canon_d = (_at(gl_l - 2) == 0) & (_at(gl_l - 1) == 2)
            if chain_r.strand == 0:      # antisense donor BELOW gr: AC
                a = maxent.antidonor_prob_at(seg, segn, gr_l)
                canon_a = (_at(gr_l - 2) == 0) & (_at(gr_l - 1) == 1)
            else:                        # sense donor ABOVE gr: GT/GC
                a = maxent.donor_prob_at(seg, segn, gr_l + 1)
                canon_a = (_at(gr_l + 1) == 2) & ((_at(gr_l + 2) == 3)
                                                  | (_at(gr_l + 2) == 1))
        return np.asarray(d), np.asarray(a), canon_d & canon_a

    best = None
    for direction in dirs:
        d, a, canon = _probs(direction)
        # reference gating (src/chimera.c:915-921): discard sites where
        # both probs < .5; require a canonical intron type or one
        # prob > .9
        ok = ~((d < 0.5) & (a < 0.5)) & (canon | (d > 0.9) | (a > 0.9))
        if allowed is not None:
            ok = ok & allowed
        prod = np.where(ok, d * a, 0.0)
        i = int(np.argmax(prod))
        if prod[i] > 0 and (best is None or prod[i] > best[0]):
            best = (float(prod[i]), P[i], direction, float(d[i]),
                    float(a[i]))
    if best is None:
        return None
    return best[1], best[2], best[3], best[4]


def trim_to_query(chain, qlen: int, keep_lo: int, keep_hi: int):
    """Trim a chain to ORIGINAL-query span [keep_lo, keep_hi) — the
    chimeric parts must not overlap past the breakpoint
    (Stage3_clip_and_trim role in the chimera pass)."""
    if chain.strand == 0:
        alo, ahi = keep_lo, keep_hi
    else:
        alo, ahi = qlen - keep_hi, qlen - keep_lo
    kept = []
    for e in chain.exons:
        qs, qe = max(e.qstart, alo), min(e.qend, ahi)
        if qe - qs <= 0:
            continue
        e.gstart += qs - e.qstart
        e.gend -= e.qend - qe
        e.qstart, e.qend = qs, qe
        # trimmed bases were match-extended homology: charge them to
        # the match count so matches+mismatches == span again
        span = e.qend - e.qstart
        if e.matches + e.mismatches > span:
            e.matches = max(0, span - e.mismatches)
        kept.append(e)
    if kept:
        # introns pair with the SURVIVING junctions
        first = chain.exons.index(kept[0])
        chain.introns = chain.introns[first:first + len(kept) - 1]
    else:
        chain.introns = []
    chain.exons = kept
    return chain


CHIMERA_SLOP = 12        # scan window around the join (chimera.c slop)


CHANGEPOINT_TOL = 8      # exon-exon candidates must lie within this
                         # many matches of the changepoint optimum


def refine_breakpoint(db, pieces, qlen: int, qcodes=None):
    """Exon-exon-aware breakpoint (src/gmap.c:2650-2676): scan the
    junction region (overlap or touching point, +- CHIMERA_SLOP) for the
    best splice boundary among near-optimal CHANGEPOINT positions
    (Chimera_find_breakpoint restricts the exon-exon search range); when
    no splice-plausible site exists fall back to the best changepoint
    (or the midpoint without qcodes).  Returns
    (pos, cdna_direction, donor_prob, acceptor_prob) or None."""
    if len(pieces) < 2:
        return None
    _qs1, qe1 = query_span(pieces[0][0], qlen)
    qs2, _qe2 = query_span(pieces[1][0], qlen)
    lo0, hi0 = min(qe1 - 1, qs2), max(qe1 - 1, qs2)
    bp_start = max(lo0 - CHIMERA_SLOP, 0)
    bp_end = min(hi0 + CHIMERA_SLOP, qlen - 2)
    allowed = None
    scores = None
    if qcodes is not None and bp_end >= bp_start:
        scores = changepoint_scores(db, pieces, qcodes, qlen)
        win = scores[bp_start:bp_end + 1]
        allowed = win >= win.max() - CHANGEPOINT_TOL
    if hi0 - lo0 <= 8 * CHIMERA_SLOP:        # adjacent-ish parts only
        found = find_exonexon(db, pieces[0], pieces[1], qlen,
                              bp_start, bp_end, allowed=allowed)
        if found is not None:
            return found
    if scores is not None:
        p = bp_start + int(np.argmax(scores[bp_start:bp_end + 1]))
        return p, 0, 0.0, 0.0
    mid = breakpoint(pieces, qlen)
    if mid is None:
        return None
    # convention here: the breakpoint is the LAST left-part base; the
    # midpoint formula returns the first right-part base
    return max(mid - 1, 0), 0, 0.0, 0.0


def extend_to_query(db, chain, off, qcodes_aligned, qlen: int,
                    lo: int, hi: int):
    """Extend the chain's terminal exons along their diagonals so the
    chain covers ORIGINAL-query span [lo, hi) (the chimera parts must
    meet exactly at the breakpoint; reference merges/extends the parts,
    src/gmap.c:2990-3000).  qcodes_aligned: query codes already in the
    chain's aligned orientation."""
    if chain.strand == 0:
        alo, ahi = lo, hi
    else:
        alo, ahi = qlen - hi, qlen - lo

    def _count(e, aqs, aqe):
        g0 = off + e.gstart - e.qstart
        if g0 + aqs < 0 or g0 + aqe > db.genome_length:
            return None
        gseg = db.get_codes(g0 + aqs, aqe - aqs)
        mm = int(np.sum(gseg != qcodes_aligned[aqs:aqe]))
        return mm

    e0, e1 = chain.exons[0], chain.exons[-1]
    if e0.qstart > alo:
        mm = _count(e0, alo, e0.qstart)
        if mm is not None:
            n = e0.qstart - alo
            e0.gstart -= n
            e0.qstart = alo
            e0.matches += n - mm
            e0.mismatches += mm
    if e1.qend < ahi:
        mm = _count(e1, e1.qend, ahi)
        if mm is not None:
            n = ahi - e1.qend
            e1.gend += n
            e1.qend = ahi
            e1.matches += n - mm
            e1.mismatches += mm
    return chain
