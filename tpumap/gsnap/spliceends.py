"""Ambiguous / alternative splice ends (altsplice.c + spliceends.c roles).

A read whose splice junction sits within a few bases of the read end
leaves a distal residue too short to seed (< k) and too short for the
localscan salvage (< 6 bp).  The reference generates trimmed-end
candidates for these (src/spliceends.c, 5,080 LoC) and represents the
surviving alternatives on the path as Altsplice_T (src/altsplice.c):

* exactly one legal distal placement -> the junction is emitted;
* several tied placements -> the residue stays soft-clipped and the
  alternatives appear in the XA:Z: tag (src/path-print-sam.c:958-994,
  distances from the proximal splice coordinate);
* in paired-end mode the mate arbitrates (Altsplice_resolve,
  src/altsplice.c): the placement nearest the expected insert length
  wins and the junction is emitted after all.

Batched re-expression: the candidate generation is ONE device scan per side
(ops/localscan.scan_exact_sites) over batch-compacted reads — the
pattern is the splice dinucleotide fused with the clipped residue, so
every exact hit in the intron-length window is a legal placement; no
per-candidate host loop.  Proximal dinucleotides decide the sense
(GT..AG / GC..AG forward, CT..AC antisense), as in
src/splice.c:64 Splice_resolve.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

MIN_INTRON = 30
AMB_MAX = 8            # longest residue handled here (>= 6 goes to localscan
                       # too, but a splice-dinuc-anchored scan still applies)
NC_REVIEW_MAX = 14     # longest terminal exon reviewed for NONCANONICAL
                       # boundary-wobble ties (driver._noncanon_tie); longer
                       # exons anchor their boundary with enough sequence
                       # that the reference keeps the junction

TOP_ALTS = 8
SCAN_W = 65536         # window cap: the reference's localdb region scale
                       # (per-65,536-bp suffix arrays, src/localdb-write.c)
# dinucleotide base codes (A=0 C=1 G=2 T=3)
_DONORS = {(2, 3): 1, (2, 1): 1, (1, 3): -1}     # GT, GC -> +; CT -> -
_ACC_OF = {1: (0, 2), -1: (0, 1)}                # sense -> AG | AC
_ACCEPTORS = {(0, 2): 1, (0, 1): -1}             # AG -> +; AC -> -
_DON_OF = {1: (2, 3), -1: (1, 3)}                # sense -> GT | CT


@dataclass
class AmbEnd:
    side: str                    # "qstart" | "qend"
    splicecoord: int             # proximal boundary univcoord
    sense: int                   # +1 / -1 (XS strand)
    alts: list[int]              # distal coords (intron far boundaries)
    diags: list[int]             # implied distal segment diagonals
    qb: int = 0                  # query boundary of the junction

    def distances(self) -> list[int]:
        if self.side == "qend":
            return [a - self.splicecoord for a in self.alts]
        return [self.splicecoord - a for a in self.alts]


def xa_tag(ambs: list[AmbEnd]) -> str:
    """XA:Z:<qstart dists>|<qend dists> (src/path-print-sam.c:958)."""
    qs = next((a for a in ambs if a.side == "qstart"), None)
    qe = next((a for a in ambs if a.side == "qend"), None)
    return ("XA:Z:"
            + (",".join(str(d) for d in qs.distances()) if qs else "")
            + "|"
            + (",".join(str(d) for d in qe.distances()) if qe else ""))


BOUNDARY_SHIFTS = (0, -1, -2, 1, 2)   # trim boundary rarely equals the
                                      # junction exactly (an intron base
                                      # can match the read by chance);
                                      # spliceends.c probes several
                                      # trimmed positions the same way


def find_splice_ends(db, index, aligned_codes, rows, max_intron):
    """Locate distal placements for short clipped residues.

    rows: list of (i, a, tqs, tqe, li, sides) — batch row, strand-aligned
    diagonal, kept query interval, read length, and which sides to probe
    (subset of {"qstart", "qend"}); aligned_codes[i] = uint8 read codes
    already in aligned orientation.

    Each side probes boundary positions around the trim point (the
    proximal splice dinucleotide selects which are plausible), and ONE
    batched device scan covers all (read, side, boundary) tasks.

    Returns (resolved, ambiguous): resolved[i] = list of
    (side, q_boundary, distal_diag, sense); ambiguous[i] = list of
    AmbEnd.  A side appears in exactly one of the two (unique placement
    -> resolved, 2..TOP_ALTS tied placements -> ambiguous).
    """
    import jax.numpy as jnp

    from tpumap.ops import localscan

    W = min(SCAN_W, max(1024, max_intron))
    F = AMB_MAX + 2
    tasks = []      # (i, side, sense, g, qb, frag, flen, wstart)
    for (i, a, tqs, tqe, li, sides) in rows:
        c = aligned_codes[i]
        if "qend" in sides and 1 <= li - tqe:
            for s in BOUNDARY_SHIFTS:
                qb = tqe + s                      # candidate junction qpos
                v = li - qb
                if not (1 <= v <= AMB_MAX) or qb < 1:
                    continue
                g = a + qb                        # donor boundary coord
                prox = (tuple(db.get_codes(g, 2))
                        if g + 2 <= db.genome_length else None)
                sense = _DONORS.get(prox) if prox else None
                if sense is None:
                    continue
                frag = np.zeros(F, np.uint8)
                frag[0:2] = _ACC_OF[sense]
                frag[2:2 + v] = c[qb:li]
                ws = g + MIN_INTRON - 2
                tasks.append((i, "qend", sense, g, qb, frag, v + 2, ws))
        if "qstart" in sides and tqs >= 1:
            for s in BOUNDARY_SHIFTS:
                qb = tqs + s                      # first aligned qpos
                u = qb
                if not (1 <= u <= AMB_MAX) or qb > li - 1:
                    continue
                g = a + qb                        # acceptor boundary coord
                sense = (_ACCEPTORS.get(tuple(db.get_codes(g - 2, 2)))
                         if g >= 2 else None)
                if sense is None:
                    continue
                frag = np.zeros(F, np.uint8)
                frag[0:u] = c[0:u]
                frag[u:u + 2] = _DON_OF[sense]
                ws = max(g - W - u, 0)
                tasks.append((i, "qstart", sense, g, qb, frag, u + 2,
                              ws))
    resolved: dict[int, list] = {}
    ambiguous: dict[int, list] = {}
    if not tasks:
        return resolved, ambiguous

    R = 1
    while R < len(tasks):
        R *= 2
    frags = np.zeros((R, F), np.uint8)
    flens = np.zeros(R, np.int32)
    wstarts = np.zeros(R, np.uint32)
    for row, t in enumerate(tasks):
        frags[row] = t[5]
        flens[row] = t[6]
        wstarts[row] = t[7]
    pos, count = localscan.scan_exact_sites(
        index.genome_packed, jnp.asarray(wstarts), jnp.asarray(frags),
        jnp.asarray(flens), W, F, TOP_ALTS)
    from tpumap.utils.fetch import device_fetch
    pos, count = device_fetch((pos, count))
    meta = [(t[0], t[1], t[2], t[3], t[4]) for t in tasks]
    return pool_scan_hits(meta, pos, count, max_intron)


def pool_scan_hits(tasks, pos, count, max_intron):
    """Shared second half of the review: pool exact-scan hits per
    (read, side), dedup by the (wobble-invariant) distal diagonal, and
    classify unique -> resolved / tied -> AmbEnd.

    tasks: list of (i, side, sense, g, qb); pos uint32[T, TOP_ALTS]
    ascending INVALID-padded; count int32[T] total exact matches."""
    resolved: dict[int, list] = {}
    ambiguous: dict[int, list] = {}
    by_side: dict[tuple, list] = {}
    overfull: set[tuple] = set()
    for row, (i, side, sense, g, qb) in enumerate(tasks):
        if int(count[row]) > TOP_ALTS:
            overfull.add((i, side))
            continue
        for t in range(pos.shape[1]):
            p = int(pos[row, t])
            if p == 0xFFFFFFFF:
                break
            if side == "qend":
                distal = p + 2                    # residue start coord
                intron = distal - g
                diag = distal - qb
            else:
                distal = p + qb                   # donor coord (qb = u)
                intron = g - distal
                diag = p                          # residue at query 0
            if MIN_INTRON <= intron <= max_intron:
                by_side.setdefault((i, side), []).append(
                    (distal, diag, qb, sense, g))
    for (i, side), hits in by_side.items():
        if (i, side) in overfull:
            continue
        # one genomic placement surfaces from several probed boundaries
        # (junction microhomology wobble); the distal segment's DIAGONAL
        # is invariant under the wobble on both sides, so dedup by it
        uniq = {}
        for (distal, diag, qb, sense, g) in hits:
            uniq.setdefault(diag, (distal, diag, qb, sense, g))
        hits = list(uniq.values())
        if len(hits) == 1:
            distal, diag, qb, sense, _g = hits[0]
            resolved.setdefault(i, []).append((side, qb, diag, sense))
        elif 2 <= len(hits) <= TOP_ALTS:
            # report against the boundary of the first (best-trim) probe
            _d0, _dg0, qb0, sense0, g0 = hits[0]
            ambiguous.setdefault(i, []).append(AmbEnd(
                side, g0, sense0, [h[0] for h in hits],
                [h[1] for h in hits], qb0))
    return resolved, ambiguous


def pool_device_results(res, max_intron):
    """Pool the FUSED ladder's in-program review scan (ladder.refine_full
    amb_* keys): same classification as find_splice_ends, zero extra
    device dispatches."""
    valid = np.asarray(res["amb_valid"])
    rows = np.nonzero(valid)[0]
    idx = np.asarray(res["amb_idx"])
    side = np.asarray(res["amb_side"])
    sense = np.asarray(res["amb_sense"])
    g = np.asarray(res["amb_g"]).astype(np.int64)
    qb = np.asarray(res["amb_qb"])
    tasks = [(int(idx[r]), "qend" if side[r] else "qstart",
              int(sense[r]), int(g[r]), int(qb[r])) for r in rows]
    pos = np.asarray(res["amb_pos"])[rows]
    count = np.asarray(res["amb_count"])[rows]
    return pool_scan_hits(tasks, pos, count, max_intron)


def resolve_with_mate(amb: AmbEnd, li: int, mate_lo: int, mate_hi: int,
                      pairexpect: int, pairdev: int) -> int | None:
    """Altsplice_resolve (src/altsplice.c): pick the distal placement
    whose implied fragment end lands nearest the expected insert; only a
    placement within pairexpect + 4*pairdev of the mate qualifies.
    Returns the index into amb.alts or None."""
    best, best_dev = None, None
    for ix, diag in enumerate(amb.diags):
        if amb.side == "qend":
            end = diag + li                       # fragment far end
            dev = abs((mate_hi - end if mate_hi >= end else end - mate_lo))
        else:
            start = diag
            dev = abs((start - mate_lo if start >= mate_lo
                       else mate_hi - start))
        if dev <= pairexpect + 4 * pairdev and (
                best_dev is None or dev < best_dev):
            best, best_dev = ix, dev
    return best
