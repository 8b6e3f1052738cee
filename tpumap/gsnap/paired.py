"""Paired-end alignment: concordance + mate rescue.

Capability analog of the reference's paired layer (src/stage1hr-paired.c
Stage1_paired_read, src/concordance.c, src/pathpair.c): both ends run
through the same batched cascade; concordant (diagonal, strand) pairs
within the insert window are selected jointly; an end whose mate is solved
but who has no candidate itself gets a window-scan rescue (the LOCAL_MATE
method) — a verify sweep over every diagonal in the mate window, which on
the device is just a wider verify_diagonals call.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from tpumap.gsnap.engine import (AlignConfig, align_batch_cascaded,
                                 mapq_from_scores)
from tpumap.index.build import GenomeDB
from tpumap.index.device import DeviceIndex
from tpumap.io import sam
from tpumap.io.fasta import Record
from tpumap.ops import pack, verify
from tpumap.utils import dna


@partial(jax.jit, static_argnums=(3,))
def rescue_mate(index, codes: jax.Array, lengths: jax.Array, window: int,
                base_diags: jax.Array):
    """Scan every diagonal in [base, base+window) for the best mate fit.

    codes must already be oriented as the expected mate strand. Returns
    (best_diag uint32[B], best_nmm int32[B]).
    """
    B, L = codes.shape
    packed = pack.pack_reads(codes)
    nmask2 = jnp.zeros_like(packed)
    offs = jnp.arange(window, dtype=jnp.uint32)[None, :]
    diags = base_diags[:, None] + offs
    nmm = verify.verify_diagonals(index, packed, nmask2, lengths, diags)
    best = jnp.argmin(nmm, axis=1)
    return (jnp.take_along_axis(diags, best[:, None], axis=1)[:, 0],
            jnp.take_along_axis(nmm, best[:, None], axis=1)[:, 0])


@partial(jax.jit, static_argnums=(8, 9, 10, 11))
def concordance_device(d1, s1, n1, L1, d2, s2, n2, L2, pairmax: int,
                       orientation: str = "FR", pairexpect: int = 1000,
                       pairdev: int = 100):
    """Batched concordance over candidate tensors (device kernel).

    The SIMD intersect-concordance role (src/concordance.c,
    src/intersect-concordance-*.c) re-expressed as one [P, K, K]
    validity/score reduction — every pair's full candidate cross product
    is scored in one vectorized pass instead of the reference's per-read
    sorted-list walk (the K-candidate set is already score-ranked, so
    the cross product IS the intersection workload).

    d* uint32[P, K] candidate diagonals (INVALID-padded), s* int32[P, K]
    strands, n* int32[P, K] mismatch counts, L* int32[P] read lengths.

    Pair key = 8*(nmm1 + nmm2) + insert_penalty: the pathpair-eval
    insert-length model (src/pathpair-eval.c role, gsnap.c:383-385
    expected_pairlength/pairlength_deviation) charges
    |insert - pairexpect| / (5*pairdev) mismatch-equivalents capped at 2
    mismatches — a wildly-stretched insert loses to a near-expected one
    of equal alignment score, but alignment quality still dominates.

    Insert arithmetic is uint32-wrap based (no 64-bit needed): the
    required-sign difference wraps to a huge value when violated and
    fails the <= pairmax test.

    Returns (ci, cj, valid, insert): best candidate index per end,
    whether any concordant combination exists, and its insert length.
    """
    P, K = d1.shape
    vk1 = (d1 != INVALID_U32)[:, :, None]
    vk2 = (d2 != INVALID_U32)[:, None, :]
    s1b = s1[:, :, None]
    s2b = s2[:, None, :]
    L1b = L1[:, None, None].astype(jnp.int32)
    L2b = L2[:, None, None].astype(jnp.int32)
    fwd_u = d2[:, None, :] - d1[:, :, None]     # d2 - d1 (uint32 wrap)
    rev_u = d1[:, :, None] - d2[:, None, :]
    pm = jnp.uint32(pairmax)
    fwd_small = jnp.minimum(fwd_u, pm).astype(jnp.int32)
    rev_small = jnp.minimum(rev_u, pm).astype(jnp.int32)

    if orientation == "FF":
        strand_ok = s1b == s2b
        dist = jnp.minimum(fwd_small, rev_small)
        insert = dist + jnp.maximum(L1b, L2b)
        ok = (fwd_u <= pm) | (rev_u <= pm)
    else:
        strand_ok = s1b != s2b
        # geometry depends only on which end is genome-leftmost (s1==0:
        # r2 lies right of r1; s1==1: left), same for FR and RF — the
        # host reference implementation _concordant_pairs reduces to the
        # identical arithmetic for both
        first_fwd = s1b == 0
        ins_f = fwd_small + L2b
        ok_f = fwd_u <= pm
        ins_r = rev_small + L1b
        ok_r = rev_u <= pm
        insert = jnp.where(first_fwd, ins_f, ins_r)
        ok = jnp.where(first_fwd, ok_f, ok_r) & (insert > 0)
    ok = ok & (insert <= pairmax) & strand_ok & vk1 & vk2

    dev5 = max(1, 5 * pairdev)
    pen = jnp.minimum((8 * jnp.abs(insert - pairexpect)) // dev5, 16)
    key = 8 * (n1[:, :, None] + n2[:, None, :]) + pen
    key = jnp.where(ok, key, jnp.int32(2 ** 28))
    flat = key.reshape(P, K * K)
    best = jnp.argmin(flat, axis=1).astype(jnp.int32)
    ci = best // K
    cj = best % K
    valid = jnp.take_along_axis(flat, best[:, None], axis=1)[:, 0] < 2 ** 28
    ins_best = jnp.take_along_axis(insert.reshape(P, K * K), best[:, None],
                                   axis=1)[:, 0]
    return ci, cj, valid, ins_best


INVALID_U32 = np.uint32(0xFFFFFFFF)


def _concordant_pairs(cands1, cands2, L1, L2, pairmax,
                      orientation: str = "FR",
                      pairexpect: int | None = None):
    """Best concordant (c1, c2) candidate index pair or None.

    cands*: (diags uint32[K], strands int32[K], nmm int32[K]).
    FR/RF: ends on opposite strands (leftward end first for FR);
    FF (mate-pair same-strand protocols): both ends same strand
    (src/gsnap.c --orientation).
    """
    d1, s1, n1 = cands1
    d2, s2, n2 = cands2
    best = None
    for i in range(len(d1)):
        if d1[i] == 0xFFFFFFFF:
            continue
        for j in range(len(d2)):
            if d2[j] == 0xFFFFFFFF:
                continue
            if orientation == "FF":
                if s1[i] != s2[j]:
                    continue
            elif s1[i] == s2[j]:
                continue
            if orientation == "FF":
                insert = abs(int(d2[j]) - int(d1[i])) + max(L1, L2)
                ok = insert <= pairmax
            elif orientation == "RF":
                # read 1 reverse, read 2 forward, r2 upstream of r1
                if s1[i] == 1:
                    insert = int(d1[i]) + L1 - int(d2[j])
                    ok = 0 < insert <= pairmax and int(d2[j]) <= int(d1[i])
                else:
                    insert = int(d2[j]) + L2 - int(d1[i])
                    ok = 0 < insert <= pairmax and int(d1[i]) <= int(d2[j])
            elif s1[i] == 0:
                insert = int(d2[j]) + L2 - int(d1[i])
                ok = 0 < insert <= pairmax and int(d2[j]) >= int(d1[i])
            else:
                insert = int(d1[i]) + L1 - int(d2[j])
                ok = 0 < insert <= pairmax and int(d1[i]) >= int(d2[j])
            if not ok:
                continue
            score = int(n1[i]) + int(n2[j])
            # tie-break among equal-score pairings: insert length closest
            # to --pairexpect (src/gsnap.c expected_pairlength), else
            # smallest insert
            key = (score, abs(insert - pairexpect)
                   if pairexpect is not None else insert)
            if best is None or key < best[0]:
                best = (key, i, j, insert)
    return best


def align_paired_records(db: GenomeDB, index: DeviceIndex,
                         pairs: list[tuple[Record, Record]],
                         config: AlignConfig = AlignConfig(),
                         pairmax: int = 2000,
                         batch_size: int = 512,
                         novelsplicing: bool = False,
                         max_intron: int = 200_000,
                         known=None,
                         orientation: str = "FR",
                         pairexpect: int | None = None,
                         pairdev: int = 100,
                         max_insertions: int = 6, max_deletions: int = 9,
                         indel_endlength: int = 4,
                         use_localdb: bool = True, known_indels=None,
                         device_ctx=None, tr=None,
                         resolve_inner: bool = True, sink=None
                         ) -> list[tuple[sam.SamRecord, sam.SamRecord]]:
    """Paired ends run the same refinement ladder as single ends
    (refine_unsolved: indels, splices incl. salvage, no fusions in the
    paired path) after concordance/mate-rescue, so paired RNA reads get
    junction records too (the Stage1_paired_read + Pathpair machinery,
    src/stage1hr-paired.c)."""
    from tpumap.gsnap.driver import (_pack_batch, make_batch,
                                     pad_to_bucket, refine_unsolved)

    from tpumap.gsnap.engine import align_batch_cascaded_packed

    remapper = None
    if tr is not None:
        from tpumap.gsnap import remap as remap_mod
        remapper = getattr(tr[0], "_remapper", None)
        if remapper is None:
            remapper = remap_mod.TranscriptRemapper(tr[0])
            tr[0]._remapper = remapper

    # the fused paired program (ladder + in-program concordance) serves
    # every request the device can express — incl. known splicing (-s),
    # fused like the single-end path; host-context features keep the
    # staged path (mirrors driver.align_records use_fused)
    use_fused = (tr is None and known_indels is None
                 and (device_ctx is None
                      or hasattr(device_ctx, "pair_full")))
    known_dev_p = known.to_device() if (known is not None
                                        and use_fused) else None
    # ONE (B, L) shape for the whole run (see driver.align_records)
    run_L = pad_to_bucket(max((len(r.sequence)
                               for p in pairs for r in p), default=1))
    pad_tail = len(pairs) >= batch_size

    def _dispatch(start):
        chunk = pairs[start:start + batch_size]
        flat = [r for p in chunk for r in p]
        B = (2 * batch_size if (pad_tail or len(chunk) == batch_size)
             else pad_to_bucket(2 * len(chunk)))
        L = run_L
        batch = make_batch(flat, B, L)
        if use_fused:
            from tpumap.gsnap import ladder
            from tpumap.ops import pathdp
            sc = pathdp.PathScoring(max_intron=max(max_intron, 9))
            args_f = (config, L, sc,
                      novelsplicing or known is not None,
                      novelsplicing and use_localdb,
                      min(max(8192, B // 2), B),
                      min(max(2048, B // 8), B), min(2048, B),
                      pairmax, orientation, pairexpect or 1000, pairdev)
            if device_ctx is not None:
                dev = device_ctx.pair_full(_pack_batch(batch), *args_f,
                                           known=known_dev_p)
            else:
                dev = ladder.align_pair_full(
                    index, _pack_batch(batch), *args_f,
                    known=known_dev_p)
        elif device_ctx is not None:
            dev = device_ctx.cascade(index, _pack_batch(batch), config, L)
        else:
            dev = align_batch_cascaded_packed(index, _pack_batch(batch),
                                              config, L)
        return chunk, batch, L, dev

    from tpumap.io import sam_bulk as _sam_bulk
    bulk_ok = remapper is None and _sam_bulk._get_lib() is not None

    out = []
    starts = list(range(0, len(pairs), batch_size))
    from tpumap.gsnap.driver import _start_fetch
    pending = _dispatch(starts[0]) if starts else None
    fetch = _start_fetch(pending[3]) if pending else None
    for si, start in enumerate(starts):
        chunk, batch, L, dev = pending
        box, th = fetch
        if si + 1 < len(starts):
            # next batch's dispatch + fetch thread first: host work on
            # this batch overlaps the next batch's device+RPC wait
            # (driver._start_fetch)
            pending = _dispatch(starts[si + 1])
            fetch = _start_fetch(pending[3])
        n = len(chunk)
        from tpumap.utils.fetch import widen_ints
        th.join()
        if "err" in box:
            raise box["err"]
        res = widen_ints(box["res"])   # ONE transfer, then widen

        # joint concordance over the full candidate cross product — one
        # device reduction for the whole batch (src/concordance.c role);
        # the fused program already ran it in-program
        if "pe_valid" in res:
            cval = res["pe_valid"][:n]
            cd1, cs1, cn1 = (res["pe_cd1"][:n], res["pe_cs1"][:n],
                             res["pe_cn1"][:n])
            cd2, cs2, cn2 = (res["pe_cd2"][:n], res["pe_cs2"][:n],
                             res["pe_cn2"][:n])
        else:
            P = pad_to_bucket(n)

            def _ends(arr, which, fill):
                sub = arr[which:2 * n:2]
                if P > n:
                    pad = np.full((P - n, *sub.shape[1:]), fill, sub.dtype)
                    sub = np.concatenate([sub, pad], axis=0)
                return jnp.asarray(sub)

            lens = np.asarray(batch["lengths"])
            ci, cj, cval, _cins = concordance_device(
                _ends(res["cand_diags"], 0, 0xFFFFFFFF),
                _ends(res["cand_strands"], 0, 0),
                _ends(res["cand_nmm"], 0, 2 ** 14),
                _ends(lens[:, None], 0, 1)[:, 0],
                _ends(res["cand_diags"], 1, 0xFFFFFFFF),
                _ends(res["cand_strands"], 1, 0),
                _ends(res["cand_nmm"], 1, 2 ** 14),
                _ends(lens[:, None], 1, 1)[:, 0],
                pairmax, orientation, pairexpect or 1000, pairdev)
            ci, cj, cval = (np.asarray(ci)[:n], np.asarray(cj)[:n],
                            np.asarray(cval)[:n])
            take = lambda a, w, i: np.take_along_axis(
                a[w:2 * n:2], i[:, None], axis=1)[:, 0]
            cd1, cs1, cn1 = (take(res["cand_diags"], 0, ci),
                             take(res["cand_strands"], 0, ci),
                             take(res["cand_nmm"], 0, ci))
            cd2, cs2, cn2 = (take(res["cand_diags"], 1, cj),
                             take(res["cand_strands"], 1, cj),
                             take(res["cand_nmm"], 1, cj))

        # mate rescue where exactly one end has candidates; pairs where
        # BOTH ends mapped but no concordant combination exists enter the
        # EXHAUSTIVE fallback (src/stage1hr-paired.c:3409-3547): rescue
        # each end inside the other's insert window and keep the better
        # resulting concordant pair
        rescue_rows = []
        exh_pairs = set()
        for p in range(n):
            i1, i2 = 2 * p, 2 * p + 1
            ok1 = res["mapped"][i1]
            ok2 = res["mapped"][i2]
            if ok1 != ok2:
                rescue_rows.append((p, i2 if ok1 else i1, i1 if ok1 else i2))
            elif ok1 and ok2 and not cval[p]:
                exh_pairs.add(p)
                rescue_rows.append((p, i2, i1))
                rescue_rows.append((p, i1, i2))
        rescued = {}
        if rescue_rows:
            nb = pad_to_bucket(len(rescue_rows))
            codes = np.zeros((nb, L), np.uint8)
            lengths = np.ones(nb, np.int32)
            bases = np.zeros(nb, np.uint32)
            for row, (p, bad, good) in enumerate(rescue_rows):
                li = int(batch["lengths"][bad])
                c = batch["codes"][bad][:li]
                # expected mate orientation = opposite of the solved end
                want_strand = 1 - int(res["strand"][good])
                if want_strand:
                    c = dna.revcomp_codes(c)
                codes[row, :li] = c
                lengths[row] = li
                gd = int(res["diag"][good])
                if int(res["strand"][good]) == 0:
                    base = gd
                else:
                    base = max(gd + int(batch["lengths"][good]) - pairmax, 0)
                bases[row] = base
            bd, bn = rescue_mate(index, jnp.asarray(codes),
                                 jnp.asarray(lengths), pairmax,
                                 jnp.asarray(bases))
            bd, bn = np.asarray(bd), np.asarray(bn)
            for row, (p, bad, good) in enumerate(rescue_rows):
                li = int(batch["lengths"][bad])
                if bn[row] <= int(li * config.max_mismatch_frac):
                    prev = rescued.get(bad)
                    cand_r = (int(bd[row]),
                              1 - int(res["strand"][good]), int(bn[row]))
                    if prev is None or cand_r[2] < prev[2]:
                        rescued[bad] = cand_r

        # EXHAUSTIVE pairs: two rescue directions were tried; keep only
        # the better resulting concordant combination (ties -> re-place
        # end 2, like the reference's plus-first iteration order)
        for p in exh_pairs:
            i1, i2 = 2 * p, 2 * p + 1
            a, b = rescued.get(i2), rescued.get(i1)
            if a is not None and b is not None:
                tot_a = int(res["nmismatch"][i1]) + a[2]
                tot_b = int(res["nmismatch"][i2]) + b[2]
                del rescued[i1 if tot_a <= tot_b else i2]

        mapq = mapq_from_scores(res["nmismatch"], res["second_nmismatch"],
                                res["n_best"], batch["lengths"],
                                mm_qualsum=res.get("mm_qualsum"),
                                qual_mean16=res.get("qual_mean16"))

        # GMAP-style mate repair (the src/repair.c / Pathpair_resolve
        # role): an unmapped mate that substitution-only rescue could
        # not place often spans a junction inside the insert window.
        # Locate both end fragments with the window-restricted scan and
        # hand the candidate diagonals to the production chain-DP
        # solver, so repaired mates get multi-junction spliced paths.
        repair_rows = [(row, p, bad, good)
                       for row, (p, bad, good) in enumerate(rescue_rows)
                       if (novelsplicing and bad not in rescued
                           and not res["mapped"][bad])]
        repair_result = {}
        if repair_rows:
            from tpumap.ops import localscan, pathdp
            FL = 16
            W = min(65536, max(1024, pairmax))
            R = pad_to_bucket(len(repair_rows))
            frag_a = np.zeros((R, FL), np.uint8)
            frag_b = np.zeros((R, FL), np.uint8)
            frag_c = np.zeros((R, FL), np.uint8)   # middle (2-junction mates)
            flens = np.zeros(R, np.int32)
            wstarts = np.zeros(R, np.uint32)
            oriented = {}
            for rr, (row, p, bad, good) in enumerate(repair_rows):
                li = int(batch["lengths"][bad])
                c = batch["codes"][bad][:li]
                m = batch["nmask"][bad][:li]
                want_strand = 1 - int(res["strand"][good])
                if want_strand:
                    c = dna.revcomp_codes(c)
                    m = m[::-1]
                oriented[bad] = (c, m, want_strand, li)
                if li >= FL:
                    frag_a[rr] = c[:FL]
                    frag_b[rr] = c[li - FL:]
                    frag_c[rr] = c[(li - FL) // 2:(li - FL) // 2 + FL]
                    flens[rr] = FL
                wstarts[rr] = bases[row]
            scans = []
            for fr in (frag_a, frag_b, frag_c):
                pos, mm = localscan.scan_fragment(
                    index.genome_packed, jnp.asarray(wstarts),
                    jnp.asarray(fr), jnp.asarray(flens), W, FL)
                scans.append((np.asarray(pos), np.asarray(mm)))
            chain_rows = []
            for rr, (row, p, bad, good) in enumerate(repair_rows):
                c, m, want_strand, li = oriented[bad]
                cands = []
                for (pos, mm), off in zip(scans,
                                          (0, li - FL, (li - FL) // 2)):
                    for t in range(pos.shape[1]):
                        if mm[rr, t] <= 2:
                            d = int(pos[rr, t]) - off
                            if d >= 0 and d not in cands:
                                cands.append(d)
                if cands:
                    chain_rows.append((bad, cands[:8], int(wstarts[rr])))
            if chain_rows:
                nb2 = pad_to_bucket(len(chain_rows))
                K2 = 8
                codes2 = np.zeros((nb2, L), np.uint8)
                nmask2 = np.zeros((nb2, L), bool)
                lengths2 = np.ones(nb2, np.int32)
                cdiags2 = np.full((nb2, K2), 0xFFFFFFFF, np.uint32)
                for rr, (bad, cands, _w0) in enumerate(chain_rows):
                    c, m, want_strand, li = oriented[bad]
                    codes2[rr, :li] = c
                    nmask2[rr, :li] = m
                    lengths2[rr] = li
                    cdiags2[rr, :len(cands)] = cands
                from tpumap.ops.pathdp import PathScoring
                sc2 = PathScoring(max_intron=max(max_intron, 30))
                _chain = (device_ctx.chain_solve if device_ctx is not None
                          else pathdp.chain_solve)
                cres2 = _chain(index, jnp.asarray(codes2),
                               jnp.asarray(nmask2), jnp.asarray(lengths2),
                               jnp.asarray(cdiags2), scoring=sc2)
                cres2 = {k: np.asarray(v) for k, v in cres2.items()}
                for rr, (bad, cands, win0) in enumerate(chain_rows):
                    c, m, want_strand, li = oriented[bad]
                    nsegs = int(cres2["nsegs"][rr])
                    if nsegs < 1:
                        continue
                    q_start = int(cres2["q_start"][rr])
                    q_end = int(cres2["q_end"][rr])
                    nmm = int(cres2["nmm"][rr])
                    alen = q_end - q_start
                    if (nmm > max(1, int(alen * config.max_mismatch_frac))
                            or alen < max(20, int(li
                                                  * config.min_coverage))):
                        continue
                    segs = [(int(cres2["seg_q"][rr][s]),
                             int(cres2["seg_diag"][rr][s]))
                            for s in range(nsegs)]
                    chroms = {db.chrnum(d + q) for q, d in segs}
                    chroms.add(db.chrnum(segs[-1][1] + q_end - 1))
                    if len(chroms) != 1:
                        continue
                    repair_result[bad] = {
                        "segs": segs, "q_start": q_start, "q_end": q_end,
                        "strand": want_strand,
                        "score": int(cres2["score"][rr]), "nmm": nmm,
                        "_win": (win0, win0 + W + li),
                    }

        amb_res = {}
        dp_result, splice_result, _fus = refine_unsolved(
            db, index, batch, res, config, novelsplicing=novelsplicing,
            max_intron=max_intron, known=known, L=L,
            max_insertions=max_insertions, max_deletions=max_deletions,
            indel_endlength=indel_endlength, use_localdb=use_localdb,
            known_indels=known_indels, quals=batch.get("quals"),
            device_ctx=device_ctx, amb_out=amb_res, dict_all=True)
        for bad, s_rep in repair_result.items():
            cur = splice_result.get(bad)
            if cur is not None:
                # keep the ladder's solution unless it's weaker AND lies
                # entirely outside the intron-expanded mate window
                # (repetitive reads chain at the keep-first-occ copy —
                # the mate-window copy is the concordant one,
                # src/pathpair.c placement preference)
                lo, hi = s_rep["_win"]
                d0 = cur["segs"][0][1] + cur["q_start"]
                d1 = cur["segs"][-1][1] + cur["q_end"]
                if (cur["score"] > s_rep["score"]
                        or (lo <= d0 + max_intron
                            and d1 <= hi + max_intron)):
                    continue
            splice_result[bad] = s_rep

        # ---- vectorized end resolution over the whole batch ---------
        B2 = 2 * n
        len2 = np.asarray(batch["lengths"])[:B2].astype(np.int64)
        ediag = res["diag"][:B2].astype(np.int64)
        estrand = res["strand"][:B2].astype(np.int64)
        enmm = res["nmismatch"][:B2].astype(np.int64)
        evalid = res["mapped"][:B2].astype(bool).copy()
        # prefer the jointly-concordant candidate combination found by
        # the device concordance kernel
        L1v, L2v = len2[0::2], len2[1::2]
        ov = (np.asarray(cval, bool)
              & (cn1.astype(np.int64) <= L1v * config.max_mismatch_frac)
              & (cn2.astype(np.int64) <= L2v * config.max_mismatch_frac))
        for (dst, src) in ((ediag[0::2], cd1), (estrand[0::2], cs1),
                           (enmm[0::2], cn1), (ediag[1::2], cd2),
                           (estrand[1::2], cs2), (enmm[1::2], cn2)):
            dst[ov] = src[ov].astype(np.int64)
        evalid[0::2] |= ov
        evalid[1::2] |= ov
        for i, (d, s, nm) in rescued.items():
            ediag[i], estrand[i], enmm[i] = d, s, nm
            evalid[i] = True

        def end_info(i):
            if evalid[i]:
                return (int(ediag[i]), int(estrand[i]), int(enmm[i]))
            return None

        # Altsplice_resolve (src/altsplice.c): an ambiguous splice end
        # whose mate is located picks the distal placement nearest the
        # expected insert — the junction is emitted after all;
        # placements the mate cannot arbitrate keep the soft clip and
        # surface as XA:Z: below.
        if amb_res:
            from tpumap.gsnap import spliceends as se
            for i in sorted(amb_res):
                if i >= B2:
                    continue
                other_i = i ^ 1
                li_e = int(len2[i])
                lo = int(len2[other_i])
                other = end_info(other_i)
                ambs = amb_res.get(i)
                if not ambs or other is None:
                    continue
                mate_lo, mate_hi = other[0], other[0] + lo
                keep = []
                for amb in ambs:
                    ix = se.resolve_with_mate(
                        amb, li_e, mate_lo, mate_hi,
                        pairexpect or 1000, pairdev)
                    if ix is None:
                        keep.append(amb)
                        continue
                    diag = amb.diags[ix]
                    s = splice_result.get(i)
                    if s is None:
                        if "trim_qstart" not in res:
                            keep.append(amb)
                            continue
                        tqs = int(res["trim_qstart"][i])
                        tqe = min(int(res["trim_qend"][i]), li_e)
                        nmm = int(res.get("trim_nmm",
                                          res["nmismatch"])[i])
                        s = {"segs": [(tqs, int(res["diag"][i]))],
                             "q_start": tqs, "q_end": tqe,
                             "strand": int(res["strand"][i]),
                             "score": 8 * (tqe - tqs) - 32 * nmm,
                             "nmm": nmm}
                        splice_result[i] = s
                    if (amb.side == "qend"
                            and amb.qb > s["segs"][-1][0]):
                        s["score"] += 8 * (li_e - s["q_end"])
                        s["segs"] = s["segs"] + [(amb.qb, diag)]
                        s["q_end"] = li_e
                    elif (amb.side == "qstart"
                          and amb.qb < (s["segs"][1][0]
                                        if len(s["segs"]) > 1
                                        else s["q_end"])):
                        s["score"] += 8 * s["q_start"]
                        s["segs"] = ([(0, diag),
                                      (amb.qb, s["segs"][0][1])]
                                     + s["segs"][1:])
                        s["q_start"] = 0
                    else:
                        keep.append(amb)
                if keep:
                    amb_res[i] = keep
                else:
                    amb_res.pop(i, None)

        # specials: rows the refinement ladder solved beyond a plain
        # ungapped record (sparse dicts — loop those rows only)
        specials = {}
        for i in sorted(set(splice_result) | set(dp_result)):
            if i >= B2:
                continue
            sp = _special_record(db, chunk[i // 2][i & 1], i, res,
                                 dp_result, splice_result, int(len2[i]),
                                 config, int(mapq[i]), known=known)
            if sp is not None:
                specials[i] = sp

        # pair classification: the plain both-mapped no-special rows
        # (the overwhelming majority) emit through ONE native bulk call
        # with every mate field computed VECTORIZED; everything else
        # keeps the per-pair Python emitter
        irregular = np.zeros(n, bool)
        for i in specials:
            irregular[i // 2] = True
        for i in amb_res:
            if i < B2:
                irregular[i // 2] = True
        both = evalid[0::2] & evalid[1::2]
        plain = both & ~irregular if bulk_ok else np.zeros(n, bool)

        out_chunk = [None] * n
        for p in np.nonzero(~plain)[0].tolist():
            i1, i2 = 2 * p, 2 * p + 1
            r1, r2 = chunk[p]
            e1, e2 = end_info(i1), end_info(i2)
            special = {i1: specials.get(i1), i2: specials.get(i2)}
            pair_rec = _emit_pair(db, r1, r2, e1, e2, int(mapq[i1]),
                                  int(mapq[i2]), pairmax,
                                  resolve_inner=resolve_inner,
                                  special=special, keys=(i1, i2))
            if amb_res:
                from tpumap.gsnap.spliceends import xa_tag
                for idx, r_out in ((i1, pair_rec[0]), (i2, pair_rec[1])):
                    if idx in amb_res and not r_out.flag & 4:
                        r_out.tags.append(xa_tag(amb_res[idx]))
            if remapper is not None:
                # transcript remap + joint paired velocity (XX/XY tags)
                remap_mod.tag_pair(remapper, db, pair_rec[0], pair_rec[1])
            out_chunk[p] = pair_rec

        ip = np.nonzero(plain)[0]
        blob = None
        if len(ip):
            blob = _emit_plain_pairs_bulk(db, batch, chunk, ip, ediag,
                                          estrand, enmm, len2, mapq,
                                          pairmax, resolve_inner,
                                          out_chunk, raw=sink is not None)
        if sink is not None:
            # streaming: plain pairs as blob byte spans (coalescing
            # consecutive spans), irregular pairs as record lines
            buf = blob.buf if blob is not None else b""
            run_a = run_b = None
            for item in out_chunk:
                if isinstance(item, tuple) and item and \
                        item[0] == "__blob__":
                    _tag, a, b = item
                    if run_b == a:
                        run_b = b
                    else:
                        if run_a is not None:
                            sink(buf[run_a:run_b])
                        run_a, run_b = a, b
                    continue
                if run_a is not None:
                    sink(buf[run_a:run_b])
                    run_a = run_b = None
                ra, rb = item
                sink(ra.lines().encode())
                sink(rb.lines().encode())
            if run_a is not None:
                sink(buf[run_a:run_b])
        else:
            out.extend(out_chunk)
    return out


def _emit_plain_pairs_bulk(db, batch, chunk, ip, ediag, estrand, enmm,
                           len2, mapq, pairmax, resolve_inner, out_chunk,
                           raw=False):
    """Vectorized _pair_plan + one native bulk emission for the plain
    both-mapped pairs (mate fields/FLAG/TLEN byte-compatible with
    _plan_record; src/pathpair-eval.c:410-470 dovetail semantics).
    With raw=True returns the SamBlob and marks out_chunk entries with
    ("__blob__", start, end) byte spans (the streaming path)."""
    from tpumap.io import sam_bulk

    i1 = 2 * ip
    i2 = i1 + 1
    d1, d2 = ediag[i1], ediag[i2]
    s1, s2 = estrand[i1], estrand[i2]
    L1, L2 = len2[i1], len2[i2]
    m = len(ip)
    qs1 = np.zeros(m, np.int64)
    qe1 = L1.copy()
    qs2 = np.zeros(m, np.int64)
    qe2 = L2.copy()
    opp = s1 != s2
    if resolve_inner:
        # dovetail/read-through: clip the plus end past the fragment
        # end, the minus end before the fragment start
        plus1 = s1 == 0
        dplus = np.where(plus1, d1, d2)
        Lp = np.where(plus1, L1, L2)
        dminus = np.where(plus1, d2, d1)
        Lm = np.where(plus1, L2, L1)
        over_hi = (dplus + Lp) - (dminus + Lm)
        cut_hi = opp & (over_hi > 0) & (over_hi <= Lp - 20)
        over_lo = dplus - dminus
        cut_lo = opp & (over_lo > 0) & (over_lo <= Lm - 20)
        qe_plus = np.where(cut_hi, Lp - over_hi, Lp)
        qs_minus = np.where(cut_lo, over_lo, 0)
        qe1 = np.where(plus1, qe_plus, qe1)
        qe2 = np.where(~plus1, qe_plus, qe2)
        qs1 = np.where(~plus1, qs_minus, qs1)
        qs2 = np.where(plus1, qs_minus, qs2)
    f1 = (np.full(m, 0x1 | 0x40, np.int32)
          | np.where(s1 == 1, 16, 0) | np.where(s2 == 1, 0x20, 0))
    f2 = (np.full(m, 0x1 | 0x80, np.int32)
          | np.where(s2 == 1, 16, 0) | np.where(s1 == 1, 0x20, 0))
    lo = np.minimum(d1 + qs1, d2 + qs2)
    hi = np.maximum(d1 + qe1, d2 + qe2)
    tlen = hi - lo
    proper = opp & (tlen <= pairmax)
    sign1 = np.where(d1 + qs1 <= d2 + qs2, 1, -1)
    tlen1 = np.where(proper, sign1 * tlen, 0)
    tlen2 = -tlen1
    f1 |= np.where(proper, 2, 0)
    f2 |= np.where(proper, 2, 0)

    # interleave ends back into emission rows
    M = 2 * m
    rows = np.empty(M, np.int64)
    rows[0::2] = i1
    rows[1::2] = i2
    diag_r = np.empty(M, np.uint64)
    diag_r[0::2] = d1.astype(np.uint64)
    diag_r[1::2] = d2.astype(np.uint64)
    strand_r = np.empty(M, np.uint8)
    strand_r[0::2] = s1
    strand_r[1::2] = s2
    flags_r = np.empty(M, np.int32)
    flags_r[0::2] = f1
    flags_r[1::2] = f2
    mate_r = np.empty(M, np.uint64)
    mate_r[0::2] = (d2 + qs2).astype(np.uint64)
    mate_r[1::2] = (d1 + qs1).astype(np.uint64)
    tlen_r = np.empty(M, np.int64)
    tlen_r[0::2] = tlen1
    tlen_r[1::2] = tlen2
    qs_r = np.empty(M, np.int32)
    qs_r[0::2] = qs1
    qs_r[1::2] = qs2
    qe_r = np.empty(M, np.int32)
    qe_r[0::2] = qe1
    qe_r[1::2] = qe2
    mq_r = mapq[rows].astype(np.int32)
    recs = [r for p in ip.tolist() for r in chunk[p]]
    codes_np = np.asarray(batch["codes"])
    nmask_np = np.asarray(batch["nmask"])
    lines = sam_bulk.emit_ungapped_bulk(
        db, recs, np.ascontiguousarray(codes_np[rows]),
        np.ascontiguousarray(nmask_np[rows]), len2[rows],
        diag_r, strand_r, mq_r, None, qs_r, qe_r,
        np.ones(M, np.uint8), flags=flags_r, mate_u=mate_r, tlen=tlen_r,
        raw=raw)
    if raw and lines is not None:
        # streaming mode: mark each fully-emitted pair with its byte
        # span in the blob (both mates are adjacent rows 2j, 2j+1)
        blob = lines
        off = blob.off
        for j, p in enumerate(ip.tolist()):
            a, b = int(off[2 * j]), int(off[2 * j + 2])
            if (off[2 * j + 1] > off[2 * j]
                    and off[2 * j + 2] > off[2 * j + 1]):
                out_chunk[p] = ("__blob__", a, b)
            else:                   # native emitter declined a row
                r1, r2 = chunk[p]
                e1 = (int(d1[j]), int(s1[j]), int(enmm[2 * p]))
                e2 = (int(d2[j]), int(s2[j]), int(enmm[2 * p + 1]))
                out_chunk[p] = _emit_pair(
                    db, r1, r2, e1, e2, int(mq_r[2 * j]),
                    int(mq_r[2 * j + 1]), pairmax,
                    resolve_inner=resolve_inner)
        return blob
    for j, p in enumerate(ip.tolist()):
        j1, j2 = 2 * j, 2 * j + 1
        if lines is not None and lines[j1] is not None \
                and lines[j2] is not None:
            out_chunk[p] = (
                sam_bulk.RawSamRecord(lines[j1], int(flags_r[j1]),
                                      int(mq_r[j1])),
                sam_bulk.RawSamRecord(lines[j2], int(flags_r[j2]),
                                      int(mq_r[j2])))
        else:                       # native emitter declined this row
            r1, r2 = chunk[p]
            e1 = (int(d1[j]), int(s1[j]), int(enmm[2 * p]))
            e2 = (int(d2[j]), int(s2[j]), int(enmm[2 * p + 1]))
            out_chunk[p] = _emit_pair(
                db, r1, r2, e1, e2, int(mq_r[j1]), int(mq_r[j2]),
                pairmax, resolve_inner=resolve_inner)
    return None


def _special_record(db, rec, i, res, dp_result, splice_result, li, config,
                    mq, known=None):
    """A spliced or gapped record for batch row i if the refinement ladder
    produced one that beats the substitution alignment; else None."""
    max_equiv = int(li * config.max_mismatch_frac)
    if i in splice_result:
        s = splice_result[i]
        alen = s["q_end"] - s["q_start"]
        if (s["nmm"] <= max(1, int(alen * config.max_mismatch_frac))
                and alen >= max(20, int(li * config.min_coverage))):
            return (sam.path_record(
                db, rec.accession, rec.sequence, rec.quality,
                s["segs"], s["q_start"], s["q_end"], s["strand"], mq,
                known=known),
                s["segs"][0][1] + s["q_start"], s["strand"])
    if i in dp_result:
        from tpumap.ops import dp as dp_ops
        pos0, ops, score = dp_result[i]
        if (3 * li - score) // 6 <= max_equiv:
            return (sam.gapped_record(
                db, rec.accession, rec.sequence, rec.quality, pos0,
                int(res["strand"][i]), mq, ops), pos0,
                int(res["strand"][i]))
    return None


def _pair_plan(r1, r2, e1, e2, pairmax, sp1=None, sp2=None,
               resolve_inner=True):
    """Mate-field arithmetic shared by the Python and bulk emitters:
    per mate (clip qs/qe, OR-in flag bits, mate univcoord or None,
    tlen) after resolving superseding specials and --resolve-inner
    dovetail clipping (src/pathpair-eval.c:410-470)."""
    if sp1 is not None:
        e1 = (sp1[1], sp1[2], 0)
    if sp2 is not None:
        e2 = (sp2[1], sp2[2], 0)
    # --resolve-inner: a read whose aligned span runs past the mate's
    # DISTAL fragment boundary (dovetail/read-through) gets its overhang
    # soft-clipped; q ranges are in the ALIGNED orientation so q_start
    # always trims the genomic-low side
    L1, L2 = len(r1.sequence), len(r2.sequence)
    clips = [[0, L1], [0, L2]]
    if (resolve_inner and e1 is not None and e2 is not None
            and sp1 is None and sp2 is None and e1[1] != e2[1]):
        (dplus, Lp, kp), (dminus, Lm, km) = (
            ((e1[0], L1, 0), (e2[0], L2, 1)) if e1[1] == 0 else
            ((e2[0], L2, 1), (e1[0], L1, 0)))
        over_hi = (dplus + Lp) - (dminus + Lm)   # plus end past fragment
        if 0 < over_hi <= Lp - 20:
            clips[kp][1] = Lp - over_hi
        over_lo = dplus - dminus                 # minus end before start
        if 0 < over_lo <= Lm - 20:
            clips[km][0] = over_lo
    plans = []
    for (e, other, first, ki) in ((e1, e2, True, 0), (e2, e1, False, 1)):
        flag_extra = 0x1 | (0x40 if first else 0x80)
        if e is None:
            flag_extra |= 0x4
        mate_u = None
        if other is None:
            flag_extra |= 0x8
        else:
            if other[1]:
                flag_extra |= 0x20
            mate_u = other[0] + clips[1 - ki][0]
        plans.append({"e": e, "qs": clips[ki][0], "qe": clips[ki][1],
                      "flag_extra": flag_extra, "mate_u": mate_u,
                      "tlen": 0})
    # proper pair + TLEN when both mapped on opposite strands within
    # range (clipped spans: a resolved dovetail shrinks the fragment)
    if e1 is not None and e2 is not None and e1[1] != e2[1]:
        lo = min(e1[0] + clips[0][0], e2[0] + clips[1][0])
        hi = max(e1[0] + clips[0][1], e2[0] + clips[1][1])
        tlen = hi - lo
        if tlen <= pairmax:
            sign1 = (1 if e1[0] + clips[0][0] <= e2[0] + clips[1][0]
                     else -1)
            for pl, sg in ((plans[0], sign1), (plans[1], -sign1)):
                pl["flag_extra"] |= 0x2
                pl["tlen"] = sg * tlen
    return plans


def _plan_record(db, rec, pl, mq, sp=None):
    """Build the Python SamRecord a _pair_plan entry describes."""
    e = pl["e"]
    if sp is not None:
        s = sp[0]
    elif e is None:
        s = sam.unmapped_record(rec.accession, rec.sequence, rec.quality)
    else:
        s = sam.ungapped_record(db, rec.accession, rec.sequence,
                                rec.quality, e[0], e[1], mq, e[2],
                                q_start=pl["qs"], q_end=pl["qe"])
    s.flag |= pl["flag_extra"]
    if pl["mate_u"] is not None:
        rname, chrpos = db.chrpos(pl["mate_u"])
        s.rnext = "=" if (e is not None and s.rname == rname) else rname
        s.pnext = chrpos + 1
    s.tlen = pl["tlen"]
    return s


def _emit_pair(db, r1, r2, e1, e2, mq1, mq2, pairmax, special=None,
               keys=(None, None), resolve_inner=True):
    special = special or {}
    # a special (spliced/gapped/repaired) record supersedes the
    # substitution placement — resolve BOTH effective ends first so the
    # mate's flags/RNEXT/PNEXT reflect the superseding position (and a
    # repaired previously-unmapped mate clears the 0x8 flag)
    sp1, sp2 = special.get(keys[0]), special.get(keys[1])
    plans = _pair_plan(r1, r2, e1, e2, pairmax, sp1, sp2, resolve_inner)
    return (_plan_record(db, r1, plans[0], mq1, sp1),
            _plan_record(db, r2, plans[1], mq2, sp2))


