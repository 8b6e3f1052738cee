"""Host driver for the GSNAP-style engine: batching + output.

Replaces the reference's pthread worker pool (1 read = 1 task,
src/gsnap.c worker_thread) with fixed-shape read batches streamed through
the jitted device pipeline; results are printed in input order (the
Outbuffer ordered mode equivalent is trivial here because batches are
processed in order).
"""
from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np

from tpumap.gsnap.engine import (AlignConfig, align_batch_cascaded,
                                 align_batch_cascaded_packed,
                                 mapq_from_scores)
from tpumap.index.build import GenomeDB
from tpumap.index.device import DeviceIndex
from tpumap.io import sam
from tpumap.io.fasta import Record, read_seqs
from tpumap.utils import dna
from tpumap.utils.fetch import device_fetch


def pad_to_bucket(n: int, buckets=(32, 64, 96, 128, 160, 192, 256, 384, 512)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return ((n + 511) // 512) * 512


def _start_fetch(dev):
    """Fetch a device result dict on a background thread.

    The blocking fetch releases the GIL, so host work runs under the
    device work and the transfer.  Returns (box, thread); join the
    thread, then read box["res"] (box["err"] re-raises)."""
    import threading
    box = {}

    def run():
        try:
            box["res"] = device_fetch(dev)
        except BaseException as exc:      # surfaced on the main thread
            box["err"] = exc

    th = threading.Thread(target=run, daemon=True)
    th.start()
    return box, th


def _pack_batch(batch):
    """Host-pack a make_batch dict for transfer (4x fewer bytes
    host->device; unpacked again on device)."""
    import jax.numpy as jnp
    from tpumap.ops import pack
    if "packed" in batch:       # make_batch's one C pass already packed
        out = {"packed": jnp.asarray(batch["packed"]),
               "pnmask": (jnp.asarray(batch["pnmask"])
                          if batch.get("has_n", True)
                          else jnp.zeros((1, 1), dtype=jnp.uint32)),
               "lengths": jnp.asarray(batch["lengths"])}
    else:
        out = {"packed": jnp.asarray(pack.pack_reads_host(batch["codes"])),
               "pnmask": (jnp.asarray(
                              pack.pack_reads_host(
                                  batch["nmask"].astype(np.uint8)))
                          if batch["nmask"].any()
                          # N-free batch: (1,1) stub -> zeros on device
                          else jnp.zeros((1, 1), dtype=jnp.uint32)),
               "lengths": jnp.asarray(batch["lengths"])}
    if "quals" in batch:        # FASTQ input: quality-weighted MAPQ
        out["quals"] = jnp.asarray(batch["quals"])
    return out


def make_batch(records: list[Record], batch_size: int, L: int):
    codes = np.zeros((batch_size, L), dtype=np.uint8)
    nmask = np.zeros((batch_size, L), dtype=bool)
    lengths = np.zeros(batch_size, dtype=np.int32)
    lib = None
    try:
        from tpumap.native import get_lib
        lib = get_lib()
    except Exception:
        pass
    any_qual = any(r.quality for r in records)
    if lib is not None and records:
        # ONE C pass encodes every sequence into codes/nmask AND the
        # 2-bit packed transfer layout (+ shifted quals when present)
        import ctypes
        from tpumap.ops.pack import words_for
        W = words_for(L)
        packed = np.zeros((batch_size, W), dtype=np.uint32)
        pnmask = np.zeros((batch_size, W), dtype=np.uint32)
        blob = "".join(r.sequence for r in records).encode("ascii")
        lens = np.fromiter((len(r.sequence) for r in records),
                           dtype=np.int64, count=len(records))
        starts = np.zeros(len(records), dtype=np.int64)
        np.cumsum(lens[:-1], out=starts[1:])
        if any_qual:
            quals = np.empty((batch_size, L), dtype=np.uint8)
            quals[len(records):] = 30
            qblob = "".join(r.quality or "" for r in records).encode(
                "ascii", "replace")
            qlens = np.fromiter((len(r.quality or "") for r in records),
                                dtype=np.int64, count=len(records))
            qstarts = np.zeros(len(records), dtype=np.int64)
            np.cumsum(qlens[:-1], out=qstarts[1:])
            has_q = (qlens >= lens).astype(np.uint8)
        else:
            quals = qblob = None
            qstarts = has_q = None
        lp = ctypes.POINTER(ctypes.c_long)
        u8 = ctypes.POINTER(ctypes.c_uint8)
        any_n = lib.encode_packed_batch(
            blob, starts.ctypes.data_as(lp), lens.ctypes.data_as(lp),
            len(records),
            qblob, qstarts.ctypes.data_as(lp) if any_qual else None,
            has_q.ctypes.data_as(u8) if any_qual else None,
            L, W,
            codes.ctypes.data_as(u8),
            nmask.ctypes.data_as(u8),
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            pnmask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            quals.ctypes.data_as(u8) if any_qual else None)
        batch = {"codes": codes, "nmask": nmask, "lengths": lengths,
                 "packed": packed, "pnmask": pnmask,
                 "has_n": bool(any_n)}
        if any_qual:
            batch["quals"] = quals
        return batch
    for i, rec in enumerate(records):
        c, m = dna.encode(rec.sequence)
        codes[i, :len(c)] = c
        nmask[i, :len(c)] = m
        lengths[i] = len(c)
    quals = None
    for i, rec in enumerate(records):
        if rec.quality:
            if quals is None:
                quals = np.full((batch_size, L), 30, dtype=np.uint8)
            qv = np.frombuffer(rec.quality.encode("ascii"),
                               np.uint8)[:lengths[i]]
            quals[i, :len(qv)] = np.maximum(qv, 33) - 33
    batch = {"codes": codes, "nmask": nmask, "lengths": lengths}
    if quals is not None:
        batch["quals"] = quals
    return batch


from tpumap.gsnap.params import (CHAIN_K, CLIP_INDEL_TRIGGER,
                                 CLIP_SPLICE_TRIGGER, INDEL_BAND,
                                 INDEL_MARGIN, INDEL_NMM_TRIGGER,
                                 MAX_CAND_PAIRS, MIN_INTRON,
                                 SPLICE_NMM_TRIGGER)


MIN_FUSION_PIECE = 20     # src/path-fusion.c requires substantial ends
KNOWN_INDEL_BONUS = 12    # score credit for an indel at a learned site
#                           (two mismatch-equivalents; known indels are
#                           preferred over marginal substitution calls)


def _oriented_rows(batch, idx, strands, L, quals=None):
    """Gather batch rows `idx` as (codes, nmask[, quals]) with strand-1
    rows reverse-complemented — vectorized replacement for the per-read
    revcomp_codes/concatenate loops that dominated refine_unsolved's
    host time (rows beyond the read length stay zero-padded)."""
    codes = np.asarray(batch["codes"])[idx]
    nmask = np.asarray(batch["nmask"])[idx]
    li = np.asarray(batch["lengths"])[idx].astype(np.int64)
    st = np.asarray(strands).astype(bool)
    qv = quals[idx] if quals is not None else None
    if st.any():
        ar = np.arange(L)
        src = li[:, None] - 1 - ar[None, :]
        valid = src >= 0
        srcc = np.clip(src, 0, L - 1)
        rc = np.where(valid, 3 - np.take_along_axis(codes, srcc, axis=1),
                      0).astype(np.uint8)
        rm = np.where(valid, np.take_along_axis(nmask, srcc, axis=1),
                      False)
        codes = np.where(st[:, None], rc, codes)
        nmask = np.where(st[:, None], rm, nmask)
        if qv is not None:
            rq = np.where(valid, np.take_along_axis(qv, srcc, axis=1),
                          0).astype(np.uint8)
            qv = np.where(st[:, None], rq, qv)
    if quals is not None:
        return codes, nmask, qv
    return codes, nmask


def _anchor_runs(db, diags, codes_rows, lengths, runlen: int = 20):
    """Per row: first 20-base exact-run start (u) and last run end (e)
    of the read vs the genome on its anchored diagonal; u = -1 when no
    run exists (native anchor_runs, Python fallback)."""
    R, Lstride = codes_rows.shape
    u_out = np.full(R, -1, dtype=np.int32)
    e_out = np.full(R, -1, dtype=np.int32)
    try:
        from tpumap.native import get_lib
        lib = get_lib()
    except Exception:
        lib = None
    if lib is not None:
        import ctypes
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.anchor_runs(
            db.genome_packed.ctypes.data_as(u32p),
            len(db.genome_packed) << 4,
            np.ascontiguousarray(diags, np.uint64).ctypes.data_as(
                ctypes.POINTER(ctypes.c_uint64)),
            codes_rows.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            Lstride,
            np.ascontiguousarray(lengths, np.int32).ctypes.data_as(i32p),
            R, runlen, u_out.ctypes.data_as(i32p),
            e_out.ctypes.data_as(i32p))
        return u_out, e_out
    for r in range(R):
        li = int(lengths[r])
        g = db.get_codes(int(diags[r]), li)
        if len(g) < li:
            continue
        match = (codes_rows[r, :li] == g)
        runs = np.convolve(match.astype(np.int32),
                           np.ones(runlen, dtype=np.int32),
                           mode="valid") == runlen
        starts = np.nonzero(runs)[0]
        if len(starts):
            u_out[r] = int(starts[0])
            e_out[r] = int(starts[-1]) + runlen
    return u_out, e_out


def _indel_limits_ok(ops, max_insertions: int, max_deletions: int,
                     indel_endlength: int) -> bool:
    """Enforce gsnap -Y/--max-insertions, -Z/--max-deletions and
    --indel-endlength (src/gsnap.c:648-649, min_indel_end_matches) on a
    DP edit transcript (T_MATCH/T_INS/T_DEL codes, forward order)."""
    from tpumap.ops import dp as dp_ops
    if not ops:
        return True
    runs = []                     # (op, runlength)
    for o in ops:
        if runs and runs[-1][0] == o:
            runs[-1][1] += 1
        else:
            runs.append([o, 1])
    has_indel = any(o != dp_ops.T_MATCH for o, _n in runs)
    if not has_indel:
        return True
    for o, n in runs:
        if o == dp_ops.T_INS and n > max_insertions:
            return False
        if o == dp_ops.T_DEL and n > max_deletions:
            return False
    if runs[0][0] != dp_ops.T_MATCH or runs[0][1] < indel_endlength:
        return False
    if runs[-1][0] != dp_ops.T_MATCH or runs[-1][1] < indel_endlength:
        return False
    return True


def refine_unsolved(db, index, batch, res, config,
                    novelsplicing=False, max_intron=200_000, known=None,
                    find_fusions=False, tr_records=None, L=None,
                    max_insertions=6, max_deletions=9, indel_endlength=4,
                    use_localdb=True, known_indels=None, quals=None,
                    device_ctx=None, amb_out=None, dict_all=False):
    """The post-cascade refinement ladder shared by the single-end and
    paired-end drivers: banded-DP indels, splice junctions (novel +
    known-partner + localscan salvage), ambiguous splice ends, fusions.
    Returns (dp_result, splice_result, fusion_result) keyed by batch
    row; when amb_out (a dict) is given, reads whose short clipped end
    has several tied splice placements get their AmbEnd list there
    (spliceends.py — the altsplice.c representation)."""
    import jax

    from tpumap.gsnap.engine import refine_indels, refine_splices
    from tpumap.ops import dp as dp_ops
    from tpumap.ops import verify
    from tpumap.utils import dna as dna_utils
    import jax.numpy as jnp

    tr_records = tr_records or {}
    if L is None:
        L = batch["codes"].shape[1]
    known_dev = known.to_device() if known is not None else None
    chunk_len = res["nmismatch"].shape[0]

    if "in_idx" in res:
        # fused-ladder results (gsnap/ladder.align_batch_full): the indel
        # and chain stages already ran ON DEVICE inside the cascade jit;
        # apply the same host-side acceptance rules to the compacted
        # blocks, then fall through to the splice-ends/fusion stages.
        len_v = np.asarray(batch["lengths"])[:chunk_len].astype(np.int32)
        diag_v = res["diag"][:chunk_len]
        dp_result = {}
        splice_result = {}
        from tpumap.io import sam_bulk
        have_native = sam_bulk._get_lib() is not None
        if "ch_sel" in res:
            from tpumap.gsnap.spliceends import NC_REVIEW_MAX as AMB_MAX
            ch_idx = res["ch_idx"]
            segq_l = res["ch_segq"]
            segd_l = res["ch_segd"]
            nsegs_l = res["ch_nsegs"].astype(np.int32)
            st_l = res["strand"]
            sel = res["ch_sel"] & (ch_idx < chunk_len)
            # rows whose accepted path has a SHORT terminal exon need the
            # splice-ends review (altsplice.c tie demotion) and therefore
            # a mutable dict entry; everything else stays array-form and
            # emits through the native bulk path (sp_* keys below)
            last_q = np.take_along_axis(
                segq_l, np.maximum(nsegs_l - 1, 0)[:, None],
                axis=1)[:, 0].astype(np.int64)
            multi = nsegs_l >= 2
            end_short = multi & (res["ch_qend"] - last_q >= 1) & (
                res["ch_qend"] - last_q <= AMB_MAX)
            start_short = multi & (
                segq_l[:, 1].astype(np.int64) - res["ch_qstart"] >= 1) & (
                segq_l[:, 1].astype(np.int64) - res["ch_qstart"]
                <= AMB_MAX)
            # insertion junctions (diag decreases) also emit via the
            # Python path_record — the native bulk emitter assumes
            # non-negative gaps (N/D only)
            sd = segd_l.astype(np.int64)
            vpair = (np.arange(1, sd.shape[1])[None, :]
                     < nsegs_l[:, None])
            has_ins = np.any(vpair & (sd[:, 1:] < sd[:, :-1]), axis=1)
            need_dict = sel & (end_short | start_short | has_ins)
            if not have_native or dict_all or known is not None:
                # no bulk path (or a caller — the paired driver — whose
                # emitter consumes dicts only; or known splicing, whose
                # XS annotation needs path_record): dicts for all
                need_dict = sel
            for r in np.nonzero(need_dict)[0].tolist():
                i = int(ch_idx[r])
                ns = int(nsegs_l[r])
                splice_result[i] = {
                    "segs": list(zip(segq_l[r][:ns].tolist(),
                                     segd_l[r][:ns].tolist())),
                    "q_start": int(res["ch_qstart"][r]),
                    "q_end": int(res["ch_qend"][r]),
                    "strand": int(st_l[i]),
                    "score": int(res["ch_score"][r]),
                    "nmm": int(res["ch_nmm"][r]),
                }
            # array-form splice solutions for the bulk emitter
            res["sp_sel"] = sel & ~need_dict
        irows = np.nonzero(res["in_sel"])[0]
        if len(irows):
            nmm_v = res["nmismatch"]
            trim_score_v = res.get("trim_score")
            runop_l = res["in_runop"][irows].tolist()
            runlen_l = res["in_runlen"][irows].tolist()
            score_l = res["in_score"][irows].tolist()
            start_l = res["in_startoff"][irows].tolist()
            for row, r in enumerate(irows.tolist()):
                i = int(res["in_idx"][r])
                if i >= chunk_len or i in splice_result:
                    continue
                li = int(len_v[i])
                sub_score = 3 * li - 6 * int(nmm_v[i])
                if trim_score_v is not None:
                    sub_score = max(sub_score,
                                    int(trim_score_v[i]) * 3 // 8)
                if score_l[row] > sub_score:
                    ops = []
                    for op1, n in zip(runop_l[row], runlen_l[row]):
                        if not op1:
                            break
                        ops.extend([op1 - 1] * n)
                    if not _indel_limits_ok(ops, max_insertions,
                                            max_deletions,
                                            indel_endlength):
                        continue
                    dp_result[i] = (int(diag_v[i]) + start_l[row],
                                    ops, score_l[row])
        return _late_stages(db, index, batch, res, config, dp_result,
                            splice_result, novelsplicing, max_intron,
                            known, find_fusions, tr_records, L, quals,
                            amb_out, chunk_len, len_v)

    # second stage: DP refinement of high-mismatch reads (the indel
    # path; batch-compacted like the reference's method ladder). Reads
    # overlapping a LEARNED indel site (gsnap --indels-read / pass 2 of
    # --two-pass, src/knownindels.c) qualify at a lower mismatch count.
    diag_v = np.asarray(res["diag"])[:chunk_len]
    nmm_v = np.asarray(res["nmismatch"])[:chunk_len]
    len_v = np.asarray(batch["lengths"])[:chunk_len].astype(np.int32)
    strand_v = np.asarray(res["strand"])[:chunk_len]
    valid_v = diag_v != 0xFFFFFFFF
    nmm_l = nmm_v.tolist()
    need_m = valid_v & (nmm_v >= INDEL_NMM_TRIGGER)
    if "trim_qstart" in res:
        # clipped ends can hide an END indel under the nmm trigger
        # (QUERYEND_INDELS role, src/dynprog_end.h:26,48)
        tqs_c = np.asarray(res["trim_qstart"])[:chunk_len]
        tqe_c = np.minimum(np.asarray(res["trim_qend"])[:chunk_len],
                           len_v)
        need_m |= valid_v & ((tqs_c + (len_v - tqe_c))
                             >= CLIP_INDEL_TRIGGER)
    if known_indels is not None:
        for i in np.nonzero(valid_v & ~need_m & (nmm_v >= 1))[0]:
            d = int(diag_v[i])
            if known_indels.any_in(d, d + int(len_v[i])):
                need_m[i] = True
    for i in tr_records:
        if i < chunk_len:
            need_m[i] = False
    need = np.nonzero(need_m)[0]
    dp_result = {}
    if len(need):
        nb = pad_to_bucket(len(need))
        codes = np.zeros((nb, L), dtype=np.uint8)
        lengths = np.ones(nb, dtype=np.int32)
        diags = np.zeros(nb, dtype=np.uint32)
        codes[:len(need)], _ = _oriented_rows(batch, need,
                                              strand_v[need], L)
        lengths[:len(need)] = len_v[need]
        diags[:len(need)] = diag_v[need]
        ref = refine_indels(index, jnp.asarray(codes),
                            jnp.asarray(lengths), jnp.asarray(diags),
                            INDEL_BAND, INDEL_MARGIN)
        ref = device_fetch(ref)
        # plain-list views: iterating numpy elements in Python is ~10x
        # slower than list iteration, and this loop walks every op
        ops_l = ref["ops"].tolist()
        score_l = ref["score"].tolist()
        start_l = ref["start_off"].tolist()
        trim_score_l = (np.asarray(res["trim_score"]).tolist()
                        if "trim_score" in res else None)
        for row, i in enumerate(need):
            li = int(len_v[i])
            sub_score = 3 * li - 6 * nmm_l[i]
            if trim_score_l is not None:
                # an end-trimmed soft-clip may already explain the read
                # better than any indel placement
                sub_score = max(sub_score, trim_score_l[i] * 3 // 8)
            ops = [o for o in ops_l[row][::-1]
                   if o != dp_ops.T_END]
            # an indel placed AT a learned site relaxes the end-length
            # requirement and gets a score bonus (known indels admit
            # placements novel ones would not, src/knownindels.c)
            eff_endlength = indel_endlength
            bonus = 0
            if known_indels is not None:
                g = int(diag_v[i]) + start_l[row]
                goff = 0
                for o in ops:
                    if o != dp_ops.T_MATCH and known_indels.near(
                            g + goff):
                        eff_endlength = min(indel_endlength, 2)
                        bonus = KNOWN_INDEL_BONUS
                        break
                    if o != dp_ops.T_INS:
                        goff += 1
            if score_l[row] + bonus > sub_score:
                if not _indel_limits_ok(ops, max_insertions,
                                        max_deletions, eff_endlength):
                    continue
                dp_result[i] = (int(diag_v[i]) + start_l[row],
                                ops, score_l[row])

    # third stage: the chain-DP path solver (multi-junction splices +
    # deletions + soft-clip trimming in one device kernel, ops/pathdp.py —
    # the Path_solve_from_diagonals/Splice_resolve/Path_trim re-expression).
    # Candidate diagonals per read: the cascade's ranked candidates, plus
    # partners derived from known junctions, plus localscan salvage for
    # reads whose second exon never seeded.
    splice_result = {}
    if novelsplicing or known is not None:
        from tpumap.ops import pathdp
        trim_nmm = res.get("trim_nmm", res["nmismatch"])
        trim_qs = res.get("trim_qstart")
        trim_qe = res.get("trim_qend")

        chain_m = valid_v & (np.asarray(trim_nmm)[:chunk_len]
                             >= SPLICE_NMM_TRIGGER)
        if trim_qs is not None:
            clipped_v = (np.asarray(trim_qs)[:chunk_len]
                         + (len_v - np.asarray(trim_qe)[:chunk_len]))
            chain_m |= valid_v & (clipped_v >= CLIP_SPLICE_TRIGGER)
        for i in tr_records:
            if i < chunk_len:
                chain_m[i] = False
        sneed = np.nonzero(chain_m)[0]
        cands_per_read = []
        if len(sneed):
            cd_rows = np.asarray(res["cand_diags"])[sneed]
            keep = ((cd_rows != 0xFFFFFFFF)
                    & (np.asarray(res["cand_strands"])[sneed]
                       == strand_v[sneed, None]))
        for j, i in enumerate(sneed):
            # first-occurrence dedupe, order preserved
            cands = list(dict.fromkeys(cd_rows[j][keep[j]].tolist()))
            if known is not None:
                li = int(len_v[i])
                for a in list(cands):
                    for (_da, db_) in known.derived_pairs(a, li,
                                                          max_intron):
                        if db_ not in cands:
                            cands.append(db_)
            cands_per_read.append((int(strand_v[i]), cands[:CHAIN_K]))

        # one vectorized oriented gather serves salvage, the chain rows
        # and (below) the ambiguous-end codes
        sc_codes = None
        if len(sneed):
            sc_codes, sc_nmask = _oriented_rows(batch, sneed,
                                                strand_v[sneed], L)
            sc_quals = None
            if quals is not None:
                _c, _m, sc_quals = _oriented_rows(batch, sneed,
                                                  strand_v[sneed], L,
                                                  quals=np.asarray(quals))

        # localdb-equivalent salvage: reads with only ONE candidate get
        # their unseeded end located by a window-restricted fragment scan
        # (ops/localscan.py; the Spliceends_* + Localdb_get path). The
        # unaligned portion is delimited by the first/last 20-base exact
        # run against the anchored diagonal (native anchor_runs; one C
        # pass replaces the per-read get_codes + np.convolve loop).
        if novelsplicing and use_localdb and len(sneed):
            one = [j for j, (st0, cands) in enumerate(cands_per_read)
                   if len(cands) == 1]
            salv = []
            if one:
                adiag = np.array([cands_per_read[j][1][0] for j in one],
                                 dtype=np.uint64)
                alen = len_v[sneed[one]].astype(np.int32)
                acodes_rows = np.ascontiguousarray(sc_codes[one])
                u_arr, e_arr = _anchor_runs(db, adiag, acodes_rows, alen)
                for k, j in enumerate(one):
                    if u_arr[k] < 0:
                        continue
                    i = int(sneed[j])
                    st0, cands = cands_per_read[j]
                    salv.append((j, i, int(adiag[k]), st0, sc_codes[j],
                                 int(alen[k]), int(u_arr[k]),
                                 int(e_arr[k])))
            if salv:
                from tpumap.ops import localscan
                F = 16
                # window = the reference's localdb region scale (65,536 bp
                # suffix-array regions, src/localdb-write.c); splice
                # distances past W are covered by the seeded chain path
                W = min(65536, max(1024, max_intron))
                R = pad_to_bucket(len(salv))
                frag_s = np.zeros((R, F), dtype=np.uint8)
                frag_p = np.zeros((R, F), dtype=np.uint8)
                flen_s = np.ones(R, dtype=np.int32)
                flen_p = np.ones(R, dtype=np.int32)
                ws_s = np.zeros(R, dtype=np.uint32)
                ws_p = np.zeros(R, dtype=np.uint32)
                for row, (j, i, a, st, c, li, u, e) in enumerate(salv):
                    v = li - e                  # unaligned suffix len
                    if v >= 6:
                        fl = min(F, v)
                        frag_s[row, :fl] = c[e:e + fl]
                        flen_s[row] = fl
                        ws_s[row] = a + e + MIN_INTRON
                    if u >= 6:
                        fl = min(F, u)
                        frag_p[row, :fl] = c[u - fl:u]
                        flen_p[row] = fl
                        ws_p[row] = max(a - MIN_INTRON - W, 0)
                pos_s, mm_s = localscan.scan_fragment(
                    index.genome_packed, jnp.asarray(ws_s),
                    jnp.asarray(frag_s), jnp.asarray(flen_s), W, F)
                pos_p, mm_p = localscan.scan_fragment(
                    index.genome_packed, jnp.asarray(ws_p),
                    jnp.asarray(frag_p), jnp.asarray(flen_p), W, F)
                pos_s, mm_s, pos_p, mm_p = device_fetch(
                    (pos_s, mm_s, pos_p, mm_p))
                for row, (j, i, a, st, c, li, u, e) in enumerate(salv):
                    v = li - e
                    st0, cands = cands_per_read[j]
                    if v >= 6:
                        for t in range(pos_s.shape[1]):
                            if mm_s[row, t] <= 1:
                                dB = int(pos_s[row, t]) - e
                                if (MIN_INTRON <= dB - a <= max_intron
                                        and dB not in cands):
                                    cands.append(dB)
                    if u >= 6:
                        fl = min(F, u)
                        for t in range(pos_p.shape[1]):
                            if mm_p[row, t] <= 1:
                                dA = int(pos_p[row, t]) - (u - fl)
                                if (MIN_INTRON <= a - dA <= max_intron
                                        and dA not in cands):
                                    cands.append(dA)
                    cands_per_read[j] = (st0, cands[:CHAIN_K])

        row_js = [j for j, (_st0, cands) in enumerate(cands_per_read)
                  if cands]
        rows = [(int(sneed[j]),) + cands_per_read[j] for j in row_js]
        if rows:
            nb = pad_to_bucket(len(rows))
            codes = np.zeros((nb, L), dtype=np.uint8)
            nmask = np.zeros((nb, L), dtype=bool)
            lengths = np.ones(nb, dtype=np.int32)
            cdiags = np.full((nb, CHAIN_K), 0xFFFFFFFF, dtype=np.uint32)
            cquals = np.full((nb, L), 30, dtype=np.uint8)
            codes[:len(rows)] = sc_codes[row_js]
            nmask[:len(rows)] = sc_nmask[row_js]
            lengths[:len(rows)] = len_v[sneed[row_js]]
            if quals is not None:
                cquals[:len(rows)] = sc_quals[row_js]
            for row, (_i, _st0, cands) in enumerate(rows):
                cdiags[row, :len(cands)] = cands
            sc = pathdp.PathScoring(max_intron=max(max_intron, MIN_INTRON))
            _chain = (device_ctx.chain_solve if device_ctx is not None
                      else pathdp.chain_solve)
            cres = _chain(
                index, jnp.asarray(codes), jnp.asarray(nmask),
                jnp.asarray(lengths), jnp.asarray(cdiags),
                scoring=sc, with_quals=quals is not None,
                quals=jnp.asarray(cquals) if quals is not None else None,
                known=known_dev)
            cres = device_fetch(cres)
            nsegs_l = cres["nsegs"].tolist()
            score_l8 = cres["score"].tolist()
            qs_l = cres["q_start"].tolist()
            qe_l = cres["q_end"].tolist()
            nmm_cl = cres["nmm"].tolist()
            segq_l = cres["seg_q"].tolist()
            segd_l = cres["seg_diag"].tolist()
            trim_score_l2 = (np.asarray(res["trim_score"]).tolist()
                             if trim_qs is not None else None)
            for row, (i, st0, cands) in enumerate(rows):
                li = int(len_v[i])
                nsegs = nsegs_l[row]
                if nsegs < 1:
                    continue
                score8 = score_l8[row]
                # alternatives in the same 8-scale: the trimmed (or
                # full-length) substitution path and the DP indel path
                if trim_score_l2 is not None:
                    best_other = trim_score_l2[i]
                else:
                    best_other = 8 * li - 32 * nmm_l[i]
                if i in dp_result:
                    best_other = max(best_other, dp_result[i][2] * 8 // 3)
                if score8 <= best_other:
                    continue
                q_start = qs_l[row]
                q_end = qe_l[row]
                segs = list(zip(segq_l[row][:nsegs], segd_l[row][:nsegs]))
                # all segments must stay on one chromosome
                chroms = {db.chrnum(d + q) for q, d in segs}
                chroms.add(db.chrnum(segs[-1][1] + q_end - 1))
                if len(chroms) != 1:
                    continue
                splice_result[i] = {
                    "segs": segs, "q_start": q_start, "q_end": q_end,
                    "strand": st0, "score": score8,
                    "nmm": nmm_cl[row],
                }

    return _late_stages(db, index, batch, res, config, dp_result,
                        splice_result, novelsplicing, max_intron,
                        known, find_fusions, tr_records, L, quals,
                        amb_out, chunk_len, len_v)




_CANON_PAIRS = {(2, 3, 0, 2), (2, 1, 0, 2), (0, 3, 0, 1),   # GT-AG GC-AG AT-AC
                (1, 3, 0, 1), (1, 3, 2, 1), (2, 3, 0, 3)}   # antisense


def _junction_bonus_zero(db, dprox, ddist, qb, known) -> bool:
    """True iff the junction boundary at query position qb between the
    proximal diagonal dprox and distal diagonal ddist carries NO signal:
    noncanonical dinucleotides and (if given) not a known site."""
    lo, hi = (dprox, ddist) if dprox <= ddist else (ddist, dprox)
    don = db.get_codes(lo + qb, 2)
    acc = db.get_codes(hi + qb - 2, 2)
    if len(don) < 2 or len(acc) < 2:
        return False
    if (int(don[0]), int(don[1]), int(acc[0]), int(acc[1])) in _CANON_PAIRS:
        return False
    if known is not None:
        sl, sr = lo + qb, hi + qb
        if ((sl in known.donor and sr in known.acceptor)
                or (sl in known.antiacceptor and sr in known.antidonor)):
            return False
    return True


def _noncanon_tie(db, c, s, side, li, known) -> bool:
    """altsplice.c tie rule applied to the junction BOUNDARY: a solved
    junction whose boundary is noncanonical and can wobble to another
    equal-mismatch noncanonical placement has no evidence for either
    placement — the caller demotes the terminal exon to a soft clip."""
    segs = s["segs"]
    if side == "qend":
        qb, dprox, ddist = segs[-1][0], segs[-2][1], segs[-1][1]
        lo_q = segs[-2][0] + 1
        hi_q = s["q_end"] - 1
    else:
        qb, ddist, dprox = segs[1][0], segs[0][1], segs[1][1]
        lo_q = s["q_start"] + 1
        hi_q = (segs[2][0] if len(segs) > 2 else s["q_end"]) - 1
    if not _junction_bonus_zero(db, dprox, ddist, qb, known):
        return False
    d_lt = segs[-2][1] if side == "qend" else segs[0][1]   # earlier-q diag
    d_rt = segs[-1][1] if side == "qend" else segs[1][1]
    for sh in (-2, -1, 1, 2):
        qb2 = qb + sh
        if not (lo_q <= qb2 <= hi_q):
            continue
        a, b = sorted((qb, qb2))
        gl = db.get_codes(d_lt + a, b - a)
        gr = db.get_codes(d_rt + a, b - a)
        if len(gl) < b - a or len(gr) < b - a:
            continue
        seg = c[a:b]
        delta = int(np.sum(seg != gl)) - int(np.sum(seg != gr))
        if sh < 0:
            delta = -delta
        # moving the boundary by sh costs `delta` extra mismatches; a
        # zero-cost move to another signal-free boundary is a tie
        if delta == 0 and _junction_bonus_zero(db, d_lt, d_rt, qb2, known):
            return True
    return False


def _late_stages(db, index, batch, res, config, dp_result, splice_result,
                 novelsplicing, max_intron, known, find_fusions, tr_records,
                 L, quals, amb_out, chunk_len, len_v):
    """Stages shared by the fused-ladder and legacy paths: ambiguous
    splice ends (3b) and fusion search (4). Returns the refine_unsolved
    triple."""
    import jax
    import jax.numpy as jnp

    from tpumap.gsnap.engine import refine_splices
    from tpumap.ops import verify
    from tpumap.utils import dna as dna_utils

    diag_v = res["diag"][:chunk_len]
    strand_v = res["strand"][:chunk_len]
    valid_v = diag_v != 0xFFFFFFFF
    trim_nmm = res.get("trim_nmm", res["nmismatch"])
    # stage 3b: ambiguous / alternative splice ends (src/altsplice.c,
    # src/spliceends.c): terminal residues too short to seed or localscan
    # (1..AMB_MAX bases), anchored at a proximal splice dinucleotide.
    # A unique distal placement extends the path with the junction; tied
    # placements keep the soft clip and surface as XA:Z: via amb_out.
    if (novelsplicing or known is not None) and "trim_qstart" in res:
        from tpumap.gsnap import spliceends as se
        amb_rows = []
        review_rows = []    # solved splices whose terminal exon is short:
                            # the chain/localscan path picks ONE placement
                            # greedily; altsplice.c demands tied exact
                            # alternatives demote the junction back to a
                            # soft clip and surface in XA:Z:
        nc_rows = []        # short-terminal-exon junctions with a
                            # NONCANONICAL boundary: a wobble-tied boundary
                            # (equal mismatches, no dinucleotide or known
                            # signal to break it) also demotes — the
                            # altsplice.c tie rule applied to the boundary
                            # itself rather than the distal placement
        acodes = {}
        acode_req = {}
        # vectorized pre-filter: only trimmed rows whose short end can be
        # ambiguous, plus solved splices, enter the per-row logic
        tqs_v = np.asarray(res["trim_qstart"])[:chunk_len].astype(np.int64)
        tqe_v = np.minimum(np.asarray(res["trim_qend"])[:chunk_len],
                           len_v).astype(np.int64)
        u_va, v_va = tqs_v, len_v - tqe_v
        tnm_v = np.asarray(trim_nmm)[:chunk_len]
        amb_m = valid_v & (((u_va >= 1) & (u_va <= se.AMB_MAX))
                           | ((v_va >= 1) & (v_va <= se.AMB_MAX)))
        amb_m = amb_m & (tnm_v <= np.maximum(
            1, ((tqe_v - tqs_v).astype(np.float64)
                * config.max_mismatch_frac).astype(np.int64)))
        for i in sorted(set(np.nonzero(amb_m)[0].tolist())
                        | set(splice_result)):
            if i in tr_records or not valid_v[i]:
                continue
            li = int(len_v[i])
            if i in splice_result:
                s = splice_result[i]
                segs = s["segs"]
                if len(segs) < 2:
                    continue
                sides = []
                # the ambiguity/tie review applies to SPLICE junctions
                # only — terminal segments joined by an insertion or
                # deletion junction are placed by the DP, not by splice
                # evidence (altsplice.c reviews splice ends)
                end_intron = (int(segs[-1][1]) - int(segs[-2][1])
                              >= MIN_INTRON)
                start_intron = (int(segs[1][1]) - int(segs[0][1])
                                >= MIN_INTRON)
                if end_intron and 1 <= s["q_end"] - segs[-1][0] <= se.AMB_MAX:
                    sides.append(("qend", segs[-2][1], 0, segs[-1][0]))
                if start_intron and 1 <= segs[1][0] - s["q_start"] <= se.AMB_MAX:
                    sides.append(("qstart", segs[1][1], segs[1][0], li))
                if end_intron and 1 <= s["q_end"] - segs[-1][0] <= se.NC_REVIEW_MAX:
                    nc_rows.append((i, "qend"))
                if start_intron and 1 <= segs[1][0] - s["q_start"] <= se.NC_REVIEW_MAX:
                    nc_rows.append((i, "qstart"))
                if not sides and not (nc_rows and nc_rows[-1][0] == i):
                    continue
                acode_req[i] = s["strand"]
                for (side, a, tqs, tqe) in sides:
                    review_rows.append((i, a, tqs, tqe, li, (side,)))
                continue
            if i in dp_result or not amb_m[i]:
                continue
            tqs, tqe = int(tqs_v[i]), int(tqe_v[i])
            acode_req[i] = int(strand_v[i])
            amb_rows.append((i, int(diag_v[i]), tqs, tqe, li,
                             ("qstart", "qend")))
        if acode_req:
            iis = np.fromiter(acode_req.keys(), dtype=np.int64)
            sts = np.fromiter(acode_req.values(), dtype=np.int64)
            ac, _m = _oriented_rows(batch, iis, sts, L)
            acodes = {int(ii): ac[k] for k, ii in enumerate(iis)}
        if amb_rows or review_rows:
            if "amb_pos" in res:
                # the fused ladder already ran the review scan in-program
                # (ladder.refine_full amb block): pool its hits, zero
                # extra dispatches
                se_res, se_amb = se.pool_device_results(res, max_intron)
            else:
                se_res, se_amb = se.find_splice_ends(
                    db, index, acodes, amb_rows + review_rows, max_intron)
            for (i, a, tqs, tqe, li, _sides) in amb_rows:
                sides = se_res.get(i)
                if sides:
                    lo, hi = tqs, tqe             # proximal segment span
                    segs = []
                    q_start, q_end = tqs, tqe
                    for (side, qb, diag, _sense) in sides:
                        if side == "qstart":
                            segs.append((0, diag))
                            q_start, lo = 0, qb
                        else:
                            q_end, hi = li, qb
                    segs.append((lo, a))
                    for (side, qb, diag, _sense) in sides:
                        if side == "qend":
                            segs.append((qb, diag))
                    # interior mismatches at the (possibly shifted)
                    # boundaries; the distal residues matched exactly
                    c = acodes[i]
                    gseg = db.get_codes(a + lo, hi - lo)
                    nmm = int(np.sum(c[lo:hi] != gseg))
                    splice_result[i] = {
                        "segs": segs, "q_start": q_start, "q_end": q_end,
                        "strand": int(res["strand"][i]),
                        "score": 8 * (q_end - q_start) - 32 * nmm,
                        "nmm": nmm,
                    }
                if amb_out is not None and i in se_amb:
                    amb_out[i] = se_amb[i]
            # review outcomes: a unique exact placement confirms the
            # solved junction (keep); tied placements demote it —
            # terminal exon dropped, span shrunk (path_record turns the
            # residue back into a soft clip), alternatives to XA:Z:
            for (i, _a, _tqs, _tqe, _li, sides) in review_rows:
                for amb in se_amb.get(i, []):
                    if amb.side not in sides:
                        continue
                    s = splice_result[i]
                    if amb.side == "qend":
                        s["score"] -= 8 * (s["q_end"] - s["segs"][-1][0])
                        s["q_end"] = s["segs"][-1][0]
                        s["segs"] = s["segs"][:-1]
                    else:
                        s["score"] -= 8 * (s["segs"][1][0] - s["q_start"])
                        s["q_start"] = s["segs"][1][0]
                        s["segs"] = s["segs"][1:]
                    if amb_out is not None:
                        amb_out.setdefault(i, []).append(amb)
        # noncanonical boundary-wobble ties (see _noncanon_tie): demote
        # the terminal exon exactly like a tied distal placement
        for (i, side) in nc_rows:
            s = splice_result.get(i)
            if s is None or len(s["segs"]) < 2 or i not in acodes:
                continue
            if side == "qend" and s["q_end"] <= s["segs"][-1][0]:
                continue            # already demoted by the review above
            if side == "qstart" and s["q_start"] >= s["segs"][1][0]:
                continue
            if _noncanon_tie(db, acodes[i], s, side, int(len_v[i]), known):
                if side == "qend":
                    s["score"] -= 8 * (s["q_end"] - s["segs"][-1][0])
                    s["q_end"] = s["segs"][-1][0]
                    s["segs"] = s["segs"][:-1]
                else:
                    s["score"] -= 8 * (s["segs"][1][0] - s["q_start"])
                    s["q_start"] = s["segs"][1][0]
                    s["segs"] = s["segs"][1:]

    # fourth stage: fusions/translocations — same-orientation candidate
    # pairs at ANY distance (cross-chromosome included) for reads that
    # nothing else solved (Path_fusion_*, src/path-fusion.c; inversions
    # i.e. cross-strand fusions are not attempted yet)
    fusion_result = {}
    if find_fusions and "cand_diags" in res:
        fneed = []
        for i in range(chunk_len):
            solved = (i in tr_records or i in splice_result
                      or (i in dp_result and (
                          3 * int(batch["lengths"][i])
                          - dp_result[i][2]) // 6 < SPLICE_NMM_TRIGGER))
            if res["nmismatch"][i] >= SPLICE_NMM_TRIGGER and not solved:
                fneed.append(i)
        fpairs_per_read = []
        for i in fneed:
            cands = {0: [], 1: []}
            for c in range(res["cand_diags"].shape[1]):
                dg = int(res["cand_diags"][i, c])
                st = int(res["cand_strands"][i, c])
                if dg != 0xFFFFFFFF and dg not in cands[st]:
                    cands[st].append(dg)
            pairs = []
            for st in (0, 1):
                for a in cands[st]:
                    for b in cands[st]:
                        if a == b:
                            continue
                        # a fusion pair is cross-chromosome, or outside
                        # the intron window (distant/inverted-order)
                        same_chrom = db.chrnum(a) == db.chrnum(b)
                        intronic = MIN_INTRON <= b - a <= max_intron
                        if not same_chrom or not intronic:
                            pairs.append((a, b, st))
            fpairs_per_read.append(pairs[:MAX_CAND_PAIRS])
        fneed_all = list(fneed)     # inversion stage sees every candidate
        fneed = [i for i, p in zip(fneed, fpairs_per_read) if p]
        fpairs_per_read = [p for p in fpairs_per_read if p]
        if fneed:
            nb = pad_to_bucket(len(fneed))
            codes = np.zeros((nb, L), dtype=np.uint8)
            nmask = np.zeros((nb, L), dtype=bool)
            lengths = np.ones(nb, dtype=np.int32)
            dA = np.full((nb, MAX_CAND_PAIRS), 0xFFFFFFFF, dtype=np.uint32)
            dB = np.full((nb, MAX_CAND_PAIRS), 0xFFFFFFFF, dtype=np.uint32)
            strands = np.zeros((nb, MAX_CAND_PAIRS), dtype=np.int32)
            for row, (i, pairs) in enumerate(zip(fneed, fpairs_per_read)):
                li = int(batch["lengths"][i])
                st0 = pairs[0][2]
                c = batch["codes"][i]
                m = batch["nmask"][i]
                if st0:
                    c = np.concatenate([dna_utils.revcomp_codes(c[:li]),
                                        np.zeros(L - li, np.uint8)])
                    m = np.concatenate([m[:li][::-1],
                                        np.zeros(L - li, bool)])
                codes[row] = c
                nmask[row] = m
                lengths[row] = li
                for pcol, (a, b, st) in enumerate(pairs):
                    if st != st0:
                        continue
                    dA[row, pcol] = a
                    dB[row, pcol] = b
                    strands[row, pcol] = st
            fres = refine_splices(index, jnp.asarray(codes),
                                  jnp.asarray(nmask),
                                  jnp.asarray(lengths),
                                  jnp.asarray(dA), jnp.asarray(dB))
            fres = {k: np.asarray(v) for k, v in fres.items()}
            for row, i in enumerate(fneed):
                li = int(batch["lengths"][i])
                pcol = int(np.argmin(np.where(fres["valid"][row],
                                              fres["nmm"][row], li + 1)))
                if not fres["valid"][row][pcol]:
                    continue
                qstar = int(fres["qstar"][row][pcol])
                nmm = int(fres["nmm"][row][pcol])
                if (qstar < MIN_FUSION_PIECE
                        or li - qstar < MIN_FUSION_PIECE):
                    continue
                score = 3 * li - 6 * nmm - 24   # distant-join penalty
                best_other = 3 * li - 6 * int(res["nmismatch"][i])
                if i in dp_result:
                    best_other = max(best_other, dp_result[i][2])
                if score > best_other:
                    fusion_result[i] = {
                        "dA": int(dA[row, pcol]),
                        "dB": int(dB[row, pcol]),
                        "qstar": qstar,
                        "strand": int(strands[row, pcol]),
                        "nmm": nmm, "score": score,
                    }

        # INVERTED (cross-strand) fusions (src/path-fusion.c inversion
        # joins): one read piece forward, the other reverse-complemented.
        # For a (d_fwd, d_rc) candidate pair the breakpoint cost needs
        # only the two per-orientation mismatch masks:
        #   fwd-first:  cost[q] = prefF[q] + prefR[L-q]
        #   rc-first:   cost[q] = (prefR[L]-prefR[L-q]) + (prefF[L]-prefF[q])
        # because read[q:] == rc(read)[:L-q] and read[:q] == rc(read)[L-q:].
        inv_rows = []           # (i, orient, diag) -> one mask row
        inv_need = []
        for i in fneed_all:
            if i in fusion_result:
                continue
            cands = {0: [], 1: []}
            for c in range(res["cand_diags"].shape[1]):
                dg = int(res["cand_diags"][i, c])
                st = int(res["cand_strands"][i, c])
                if dg != 0xFFFFFFFF and dg not in cands[st]:
                    cands[st].append(dg)
            if cands[0] and cands[1]:
                inv_need.append((i, cands[0][:4], cands[1][:4]))
        if inv_need:
            row_of = {}
            for i, cf, cr in inv_need:
                for st, cc in ((0, cf), (1, cr)):
                    for dg in cc:
                        row_of[(i, st, dg)] = len(inv_rows)
                        inv_rows.append((i, st, dg))
            nb = pad_to_bucket(len(inv_rows))
            rcodes = np.zeros((nb, L), np.uint8)
            rnm = np.zeros((nb, L), bool)
            rdiags = np.zeros(nb, np.uint32)
            for row, (i, st, dg) in enumerate(inv_rows):
                li = int(batch["lengths"][i])
                c = batch["codes"][i]
                m = batch["nmask"][i]
                if st:
                    c = np.concatenate([dna_utils.revcomp_codes(c[:li]),
                                        np.zeros(L - li, np.uint8)])
                    m = np.concatenate([m[:li][::-1],
                                        np.zeros(L - li, bool)])
                rcodes[row] = c
                rnm[row] = m
                rdiags[row] = dg
            gwin = np.asarray(verify.extract_codes_window(
                index.genome_packed, jnp.asarray(rdiags), L))
            masks = (gwin[:len(inv_rows)] != rcodes[:len(inv_rows)]) \
                | rnm[:len(inv_rows)]
            for i, cf, cr in inv_need:
                li = int(batch["lengths"][i])
                best = None
                for dF in cf:
                    prefF = np.zeros(li + 1, np.int32)
                    np.cumsum(masks[row_of[(i, 0, dF)]][:li], out=prefF[1:])
                    for dR in cr:
                        prefR = np.zeros(li + 1, np.int32)
                        np.cumsum(masks[row_of[(i, 1, dR)]][:li],
                                  out=prefR[1:])
                        qs = np.arange(MIN_FUSION_PIECE,
                                       li - MIN_FUSION_PIECE + 1)
                        if len(qs) == 0:
                            continue
                        c1 = prefF[qs] + prefR[li - qs]
                        c2 = ((prefR[li] - prefR[li - qs])
                              + (prefF[li] - prefF[qs]))
                        j1, j2 = int(np.argmin(c1)), int(np.argmin(c2))
                        for q_, nmm_, ff in ((int(qs[j1]), int(c1[j1]), True),
                                             (int(qs[j2]), int(c2[j2]),
                                              False)):
                            if best is None or nmm_ < best[1]:
                                best = (q_, nmm_, ff, dF, dR)
                if best is None:
                    continue
                q_, nmm_, ff, dF, dR = best
                score = 3 * li - 6 * nmm_ - 24      # distant-join penalty
                best_other = 3 * li - 6 * int(res["nmismatch"][i])
                if i in dp_result:
                    best_other = max(best_other, dp_result[i][2])
                if score > best_other:
                    fusion_result[i] = {
                        "inv": True, "d_fwd": dF, "d_rc": dR,
                        "qstar": q_, "fwd_first": ff,
                        "nmm": nmm_, "score": score,
                    }

    return dp_result, splice_result, fusion_result


def _bulk_emit_chunk(db, chunk, batch, res, mapq, overrides, config,
                     known):
    """One native C call emits final SAM text for every hot-shape row
    (plain/soft-clipped ungapped + chain-DP spliced paths) in the chunk
    — the Path_print_sam cost amortization (see io/sam_bulk.py).

    overrides: (tr_records, splice_result, fusion_result, dp_result,
    amb_result).  Returns (lines, flags, methods) with lines[i] the
    final text for row i (None -> the Python loop emits it), or None if
    the native library is unavailable.
    """
    from tpumap.io import sam_bulk
    if sam_bulk._get_lib() is None:
        return None
    tr_records, splice_result, fusion_result, dp_result, amb_result, \
        *_extra = overrides
    n = len(chunk)
    li = np.asarray(batch["lengths"][:n]).astype(np.int32)
    mapped = np.asarray(res["mapped"][:n]).astype(bool)
    diag = np.asarray(res["diag"][:n]).astype(np.uint64)
    strand = np.asarray(res["strand"][:n]).astype(np.uint8)
    if config.soft_clips and "trim_qstart" in res:
        tqs = np.asarray(res["trim_qstart"][:n]).astype(np.int32)
        tqe = np.minimum(np.asarray(res["trim_qend"][:n]),
                         li).astype(np.int32)
    else:
        tqs = np.zeros(n, np.int32)
        tqe = li.copy()
    trimmed = (tqs > 0) | (tqe < li)
    alen = tqe - tqs
    trim_nmm = np.asarray(res.get("trim_nmm", res["nmismatch"])[:n])
    min_alen = np.maximum(20, (li * config.min_coverage).astype(np.int32))
    max_nmm = np.maximum(1, (alen.astype(np.float64)
                             * config.max_mismatch_frac).astype(np.int32))
    valid = np.asarray(res["diag"][:n]) != 0xFFFFFFFF
    trim_ok = valid & trimmed & (alen >= min_alen) & (trim_nmm <= max_nmm)
    plain = mapped & ~trimmed
    emit = plain | trim_ok
    for d in overrides:
        for i in d:
            if i < n:
                emit[i] = False
    sp_arr_rows = None
    if "sp_sel" in res and known is None:
        # array-form chain solutions (fused ladder): vectorized filters,
        # no per-row dict in the hot path
        rsel = np.nonzero(res["sp_sel"])[0]
        ii = res["ch_idx"][rsel].astype(np.int64)
        keep = ii < n
        rsel, ii = rsel[keep], ii[keep]
        a_qs = res["ch_qstart"][rsel].astype(np.int32)
        a_qe = res["ch_qend"][rsel].astype(np.int32)
        a_nmm = res["ch_nmm"][rsel].astype(np.int32)
        al = a_qe - a_qs
        ok = ((a_nmm <= np.maximum(
                  1, (al * config.max_mismatch_frac).astype(np.int32)))
              & (al >= np.maximum(
                  20, (li[ii] * config.min_coverage).astype(np.int32))))
        if amb_result or tr_records:
            excl = np.fromiter((int(i_) in amb_result
                                or int(i_) in tr_records for i_ in ii),
                               dtype=bool, count=len(ii))
            ok &= ~excl
        sp_arr_rows = (rsel[ok], ii[ok])
        emit[ii] = False            # spliced rows never emit as ungapped
    qstart = np.where(plain, 0, tqs).astype(np.int32)
    qend = np.where(plain, li, tqe).astype(np.int32)
    methods = np.full(n, "sub", dtype=object)
    flags = np.where(strand, 16, 0).astype(np.int32)
    lines = None
    if emit.any():
        lines = sam_bulk.emit_ungapped_bulk(
            db, chunk, batch["codes"], batch["nmask"], li, diag, strand,
            mapq, np.asarray(res["n_best"][:n]), qstart, qend, emit)
    if lines is None:
        lines = [None] * n

    # rows nothing will claim emit as unmapped in one C call (the Python
    # fallback loop only sees rows with an override entry)
    unm = ~plain & ~trim_ok
    if sp_arr_rows is not None and len(sp_arr_rows[1]):
        unm[sp_arr_rows[1]] = False
    for d in overrides:
        for i in d:
            if i < n:
                unm[i] = False
    if unm.any():
        ulines = sam_bulk.emit_unmapped_bulk(
            db, chunk, batch["codes"], batch["nmask"], li,
            unm.astype(np.uint8))
        if ulines is not None:
            for i in np.nonzero(unm)[0].tolist():
                if ulines[i] is not None:
                    lines[i] = ulines[i]
                    flags[i] = 4
                    methods[i] = "unmapped"

    # chain-DP spliced/deletion paths (known splicing falls back to the
    # Python path_record so annotated junctions can set XS)
    if (splice_result or (sp_arr_rows and len(sp_arr_rows[0]))) \
            and known is None:
        sp_rows = []
        sp_strand = np.zeros(n, np.uint8)
        sp_qs = np.zeros(n, np.int32)
        sp_qe = np.zeros(n, np.int32)
        sp_emit = np.zeros(n, np.uint8)
        counts = np.zeros(n, dtype=np.int64)
        S = res["ch_segq"].shape[1] if "ch_segq" in res else 8
        segq_m = np.zeros((n, S), np.int32)
        segd_m = np.zeros((n, S), np.uint64)
        if sp_arr_rows is not None and len(sp_arr_rows[0]):
            rsel, ii = sp_arr_rows
            ns = res["ch_nsegs"][rsel].astype(np.int64)
            sp_rows.extend(ii.tolist())
            sp_emit[ii] = 1
            a_st = strand[ii]
            flags[ii] = np.where(a_st, 16, 0)
            sp_strand[ii] = a_st
            sp_qs[ii] = res["ch_qstart"][rsel]
            sp_qe[ii] = res["ch_qend"][rsel]
            counts[ii] = ns
            segq_m[ii] = res["ch_segq"][rsel]
            segd_m[ii] = res["ch_segd"][rsel]
            methods[ii[ns > 1]] = "splice"
        for i in sorted(splice_result):
            s = splice_result[i]
            if i >= n or i in amb_result or i in tr_records:
                continue
            al = s["q_end"] - s["q_start"]
            if not (s["nmm"] <= max(1, int(al * config.max_mismatch_frac))
                    and al >= max(20, int(li[i] * config.min_coverage))):
                continue
            segs = s["segs"]
            if (segs[0][0] != s["q_start"] or len(segs) > S
                    or any(b[1] < a[1] for a, b in zip(segs, segs[1:]))):
                continue            # keep Python semantics for odd paths
                                    # (incl. insertion junctions)
            sp_rows.append(i)
            sp_emit[i] = 1
            flags[i] = 16 if s["strand"] else 0
            sp_strand[i] = s["strand"]
            sp_qs[i] = s["q_start"]
            sp_qe[i] = s["q_end"]
            counts[i] = len(segs)
            for c_, (q0, d0) in enumerate(segs):
                segq_m[i, c_] = q0
                segd_m[i, c_] = d0
            methods[i] = "splice" if len(segs) > 1 else "sub"
        if sp_rows:
            # flatten per-row segment slots in ascending (row, slot)
            # order; row i's segments are [off[i], off[i+1])
            off = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(counts, out=off[1:])
            segmask = (np.arange(S, dtype=np.int64)[None, :]
                       < counts[:, None])
            plines = sam_bulk.emit_path_bulk(
                db, chunk, batch["codes"], batch["nmask"], li, sp_strand,
                mapq, sp_qs, sp_qe, off,
                segq_m[segmask].astype(np.int32),
                segd_m[segmask].astype(np.uint64),
                sp_emit, MIN_INTRON)
            if plines is not None:
                for i in sp_rows:
                    if plines[i] is not None:
                        lines[i] = plines[i]
    return lines, flags, methods


def _mixed_emit_chunk(db, chunk, batch, res, mapq, overrides, config,
                      known):
    """Row-order blob emission: classify every row (unmapped / ungapped /
    chain-DP path / Python-override) and emit ALL native rows with one C
    call (io/sam_bulk.emit_mixed_blob).  Returns (SamBlob, methods) or
    None when the native library is unavailable.  Rows with kind 0 get
    their lines from the Python per-row ladder and are spliced into the
    blob by the streaming driver."""
    from tpumap.io import sam_bulk
    if sam_bulk._get_lib() is None:
        return None
    tr_records, splice_result, fusion_result, dp_result, amb_result, \
        *_extra = overrides
    n = len(chunk)
    li = np.asarray(batch["lengths"][:n]).astype(np.int32)
    mapped = np.asarray(res["mapped"][:n]).astype(bool)
    diag = np.asarray(res["diag"][:n]).astype(np.uint64)
    strand = np.asarray(res["strand"][:n]).astype(np.uint8)
    if config.soft_clips and "trim_qstart" in res:
        tqs = np.asarray(res["trim_qstart"][:n]).astype(np.int32)
        tqe = np.minimum(np.asarray(res["trim_qend"][:n]),
                         li).astype(np.int32)
    else:
        tqs = np.zeros(n, np.int32)
        tqe = li.copy()
    trimmed = (tqs > 0) | (tqe < li)
    alen = tqe - tqs
    trim_nmm = np.asarray(res.get("trim_nmm", res["nmismatch"])[:n])
    min_alen = np.maximum(20, (li * config.min_coverage).astype(np.int32))
    max_nmm = np.maximum(1, (alen.astype(np.float64)
                             * config.max_mismatch_frac).astype(np.int32))
    valid = np.asarray(res["diag"][:n]) != 0xFFFFFFFF
    trim_ok = valid & trimmed & (alen >= min_alen) & (trim_nmm <= max_nmm)
    plain = mapped & ~trimmed
    sub_ok = plain | trim_ok

    kind = np.where(sub_ok, np.uint8(2), np.uint8(1))
    qstart = np.where(plain, 0, tqs).astype(np.int32)
    qend = np.where(plain, li, tqe).astype(np.int32)

    # chain-DP path rows (array-form from the fused ladder + qualifying
    # dict rows); known splicing keeps the Python path for XS annotation
    S = res["ch_segq"].shape[1] if "ch_segq" in res else 8
    counts = np.zeros(n, dtype=np.int64)
    segq_m = np.zeros((n, S), np.int32)
    segd_m = np.zeros((n, S), np.uint64)
    if "sp_sel" in res and known is None:
        rsel = np.nonzero(res["sp_sel"])[0]
        ii = res["ch_idx"][rsel].astype(np.int64)
        keep = ii < n
        rsel, ii = rsel[keep], ii[keep]
        a_qs = res["ch_qstart"][rsel].astype(np.int32)
        a_qe = res["ch_qend"][rsel].astype(np.int32)
        a_nmm = res["ch_nmm"][rsel].astype(np.int32)
        al = a_qe - a_qs
        ok = ((a_nmm <= np.maximum(
                  1, (al * config.max_mismatch_frac).astype(np.int32)))
              & (al >= np.maximum(
                  20, (li[ii] * config.min_coverage).astype(np.int32))))
        if amb_result or tr_records:
            excl = np.fromiter((int(i_) in amb_result
                                or int(i_) in tr_records for i_ in ii),
                               dtype=bool, count=len(ii))
            ok &= ~excl
        rsel, ii = rsel[ok], ii[ok]
        if len(ii):
            kind[ii] = 3
            qstart[ii] = res["ch_qstart"][rsel]
            qend[ii] = res["ch_qend"][rsel]
            counts[ii] = res["ch_nsegs"][rsel].astype(np.int64)
            segq_m[ii] = res["ch_segq"][rsel]
            segd_m[ii] = res["ch_segd"][rsel]
    if known is None:
        for i in sorted(splice_result):
            if i >= n:
                continue
            s = splice_result[i]
            kind[i] = 0             # default: Python path_record (odd
            #                         paths, filters, XA-tagged rows)
            if i in amb_result or i in tr_records:
                continue
            al_ = s["q_end"] - s["q_start"]
            if not (s["nmm"] <= max(1, int(al_ * config.max_mismatch_frac))
                    and al_ >= max(20, int(li[i] * config.min_coverage))):
                continue
            segs = s["segs"]
            if (segs[0][0] != s["q_start"] or len(segs) > S
                    or any(b[1] < a[1] for a, b in zip(segs, segs[1:]))):
                continue            # odd paths keep Python semantics
            kind[i] = 3
            strand[i] = s["strand"]
            qstart[i] = s["q_start"]
            qend[i] = s["q_end"]
            counts[i] = len(segs)
            for c_, (q0, d0) in enumerate(segs):
                segq_m[i, c_] = q0
                segd_m[i, c_] = d0
    else:
        for i in splice_result:
            if i < n:
                kind[i] = 0
    for d in (tr_records, fusion_result, dp_result, amb_result):
        for i in d:
            if i < n:
                kind[i] = 0

    off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=off[1:])
    segmask = (np.arange(S, dtype=np.int64)[None, :] < counts[:, None])
    mq_eff = np.where(kind == 1, 0, mapq[:n]).astype(np.int32)
    blob = sam_bulk.emit_mixed_blob(
        db, chunk, batch["codes"], batch["nmask"], li, kind, diag, strand,
        mq_eff, np.asarray(res["n_best"][:n]), qstart, qend, MIN_INTRON,
        seg_off=off, seg_q=segq_m[segmask].astype(np.int32),
        seg_d=segd_m[segmask].astype(np.uint64),
        has_qual="quals" in batch)
    if blob is None:
        return None
    methods = np.full(n, "sub", dtype=object)
    methods[kind == 1] = "unmapped"
    methods[(kind == 3) & (counts > 1)] = "splice"
    return blob, methods


def align_records(db: GenomeDB, index: DeviceIndex, records: list[Record],
                  config: AlignConfig = AlignConfig(), novelsplicing: bool = False,
                  max_intron: int = 200_000,
                  batch_size: int = 1024, known=None,
                  tr=None, find_fusions: bool = False,
                  npaths: int = 1, show_method: bool = False,
                  stats: dict | None = None,
                  max_insertions: int = 6, max_deletions: int = 9,
                  indel_endlength: int = 4, use_localdb: bool = True,
                  merge_distant_samechr: bool = False,
                  known_indels=None,
                  device_ctx=None, sink=None,
                  pad_tail: bool | None = None) -> list[sam.SamRecord]:
    """known: optional KnownSplicing (gsnap/knownsplicing.py) — adds a
    known-site bonus in splice scoring AND derives partner diagonals from
    known junction pairs for reads whose second exon anchor is too short
    to seed.

    tr: optional (Transcriptome, DeviceIndex-over-trdb) pair enabling the
    transcriptome-guided rung (TR_EXACT1/TR_EXT analog) ahead of genomic
    search — reads solved on a transcript get their multi-intron junction
    structure from the exon table (src/stage1hr-single.c:202-260,
    src/trpath-convert.c).

    sink: optional callable taking bytes — STREAMING mode: final SAM text
    is written to sink in input order (native rows as one blob per batch,
    Python-override rows spliced in) and the function returns [] (use
    `stats` for counts).  The per-record Python object layer disappears
    from the hot path entirely (the Outbuffer file-writer role,
    src/outbuffer.c).

    pad_tail: pad a short last batch to the full batch shape (default:
    when the run holds at least one full batch), so one program serves
    the whole run."""
    import jax
    import jax.numpy as jnp

    out = []
    remapper = None
    if tr is not None:
        from tpumap.gsnap import remap as remap_mod
        remapper = getattr(tr[0], "_remapper", None)
        if remapper is None:
            remapper = remap_mod.TranscriptRemapper(tr[0])
            tr[0]._remapper = remapper

    # the fused device ladder (gsnap/ladder.py) serves every request the
    # basic single-end path can express on device — including known
    # splicing (-s, in-program partner derivation + site bonus) and
    # multi-path reporting (-n > 1, via the sec_* compaction of
    # multimapping rows' ranked candidate lists); features that need
    # extra host context keep the staged path.  A device mesh rides the
    # same one-jit program through MeshContext.ladder_full.
    # transcriptome-guided runs (-c) keep the fused genomic ladder:
    # the TR rung stays its own small dispatch and its solved rows ride
    # the override path, so TGGA no longer forces the staged pipeline
    use_fused = (not find_fusions
                 and known_indels is None
                 and (device_ctx is None
                      or hasattr(device_ctx, "ladder_full")))
    known_dev_l = known.to_device() if (known is not None
                                        and use_fused) else None

    # ONE (B, L) shape for the whole run: a bucketed tail batch would
    # compile a second program per shape, which costs far more than the
    # wasted compute of padding the tail up to a full batch.
    # Runs smaller than one batch still use the small buckets.
    run_L = pad_to_bucket(max((len(r.sequence) for r in records),
                              default=1))
    if pad_tail is None:
        pad_tail = len(records) >= batch_size

    def _dispatch(start):
        """Build + async-dispatch one batch's device work; host work on
        the previous batch overlaps this batch's device compute."""
        chunk = records[start:start + batch_size]
        B = (batch_size if (pad_tail or len(chunk) == batch_size)
             else pad_to_bucket(len(chunk)))
        L = run_L
        batch = make_batch(chunk, B, L)
        if use_fused:
            from tpumap.gsnap import ladder
            from tpumap.ops import pathdp
            sc = pathdp.PathScoring(max_intron=max(max_intron, MIN_INTRON))
            splicing_on = novelsplicing or known is not None
            # compaction sizes must scale with the batch: an RNA-seq
            # batch can be ~50% genuinely spliced, so a fixed r_chain
            # silently overflows real spliced reads out of the chain
            # stage at large B (the round-5 recall collapse at B=32k)
            r_chain = min(max(8192, B // 2), B)
            r_salv = min(max(2048, B // 8), r_chain)
            r_indel = min(2048, B)
            if device_ctx is not None:
                dev = device_ctx.ladder_full(
                    _pack_batch(batch), config, L, sc,
                    splicing_on, novelsplicing and use_localdb,
                    r_chain, r_salv, r_indel, known=known_dev_l)
            elif known_dev_l is not None:
                dev = ladder.align_batch_full_known(
                    index, _pack_batch(batch), config, L, sc,
                    splicing_on, novelsplicing and use_localdb,
                    r_chain, r_salv, r_indel, known=known_dev_l)
            else:
                dev = ladder.align_batch_full(
                    index, _pack_batch(batch), config, L, sc,
                    splicing_on, novelsplicing and use_localdb,
                    r_chain, r_salv, r_indel)
        elif device_ctx is not None:
            dev = device_ctx.cascade(index, _pack_batch(batch), config, L)
        else:
            dev = align_batch_cascaded_packed(index, _pack_batch(batch),
                                              config, L)
        return chunk, batch, L, dev

    starts = list(range(0, len(records), batch_size))
    # refine_unsolved itself dispatches device work for some configs
    # (staged-path splice-end review/salvage/chain, fusions,
    # transcriptome rung); those small dispatches must not queue behind
    # the NEXT batch's big program on the device stream, so
    # next-batch dispatch happens after refine in that case.  The fused
    # ladder runs the whole refinement (incl. the ambiguous-ends review
    # scan) in ONE program, so it always dispatches early.
    early_dispatch = (tr is None and not find_fusions
                      and (use_fused
                           or (not novelsplicing and known is None)))
    pending = _dispatch(starts[0]) if starts else None
    fetch = _start_fetch(pending[3]) if pending else None
    for si, start in enumerate(starts):
        chunk, batch, L, dev = pending
        box, th = fetch
        if si + 1 < len(starts) and early_dispatch:
            # dispatch the NEXT batch and start ITS fetch thread before
            # touching this batch's results: the blocking fetch releases
            # the GIL, so all host work below (refine, native emission,
            # next batch's C encode) runs under the next batch's device
            # work and transfer
            pending = _dispatch(starts[si + 1])
            fetch = _start_fetch(pending[3])

        # transcriptome-first rung
        tr_records = {}
        if tr is not None:
            tr_records = _tr_rung(db, tr, chunk, batch, config)
        # ONE batched transfer for the whole result dict instead of one
        # per array (wire dtypes are narrow; widen before any host
        # arithmetic)
        from tpumap.utils.fetch import widen_ints
        th.join()
        if "err" in box:
            raise box["err"]
        res = widen_ints(box["res"])
        if stats is not None and "stage2_overflow" in res:
            stats["stage2_overflow"] = (stats.get("stage2_overflow", 0)
                                        + int(res["stage2_overflow"]))
        mapq = mapq_from_scores(res["nmismatch"], res["second_nmismatch"],
                                res["n_best"], batch["lengths"],
                                mm_qualsum=res.get("mm_qualsum"),
                                qual_mean16=res.get("qual_mean16"))

        amb_result = {}
        dp_result, splice_result, fusion_result = refine_unsolved(
            db, index, batch, res, config, novelsplicing=novelsplicing,
            max_intron=max_intron, known=known, find_fusions=find_fusions,
            tr_records=tr_records, L=L,
            max_insertions=max_insertions, max_deletions=max_deletions,
            indel_endlength=indel_endlength, use_localdb=use_localdb,
            known_indels=known_indels, quals=batch.get("quals"),
            device_ctx=device_ctx, amb_out=amb_result)
        # multimapping rows' ranked candidates (-n > 1 secondaries):
        # the fused path ships them through the sec_* compaction; the
        # staged path still carries the full cand lists
        sec_map = {}
        if npaths > 1:
            if "sec_idx" in res:
                for r in np.nonzero(res["sec_sel"])[0].tolist():
                    i2 = int(res["sec_idx"][r])
                    if i2 < len(chunk):
                        sec_map[i2] = (res["sec_diags"][r],
                                       res["sec_strands"][r],
                                       res["sec_nmm"][r])
            elif "cand_diags" in res:
                nb_v = np.asarray(res["n_best"])[:len(chunk)]
                for i2 in np.nonzero(nb_v > 1)[0].tolist():
                    sec_map[i2] = (res["cand_diags"][i2],
                                   res["cand_strands"][i2],
                                   res["cand_nmm"][i2])
        if si + 1 < len(starts) and not early_dispatch:
            # refine's own device dispatches are done; NOW overlap the
            # next batch with this batch's emission work
            pending = _dispatch(starts[si + 1])
            fetch = _start_fetch(pending[3])

        # hot-shape rows (plain/soft-clipped subs + chain-DP paths) emit
        # through ONE native C call; the Python branches below keep every
        # special case (SNP/mode spaces, XA, secondaries, remap tags)
        bulk = None
        mix = None
        overrides = (tr_records, splice_result, fusion_result, dp_result,
                     amb_result, sec_map)
        from tpumap.ops.mode import MODE_SPACES
        can_bulk = (remapper is None and not show_method
                    and not config.snp_tolerant
                    and MODE_SPACES[config.mode] == (None, None))
        if sink is not None and can_bulk:
            mix = _mixed_emit_chunk(db, chunk, batch, res, mapq,
                                    overrides, config, known)
        if can_bulk and mix is None:
            bulk = _bulk_emit_chunk(db, chunk, batch, res, mapq,
                                    overrides, config, known)
        if bulk is not None:
            from tpumap.io.sam_bulk import RawSamRecord
            bulk_lines, bulk_flags, bulk_methods = bulk

        rows_iter = range(len(chunk))
        row_marks = []
        rows_py = ()
        if mix is not None:
            blob, methods_m = mix
            rows_py = np.nonzero(blob.kind == 0)[0].tolist()
            if stats is not None:
                native = blob.kind != 0
                vals, cnts = np.unique(methods_m[native],
                                       return_counts=True)
                for v, c in zip(vals.tolist(), cnts.tolist()):
                    stats[v] = stats.get(v, 0) + int(c)
            if not rows_py:
                sink(blob.buf)
                continue
            rows_iter = rows_py

        # fast path: every row bulk-emitted, no dict overrides — skip
        # the per-row branch ladder entirely (the 16 k-iteration Python
        # loop costs more than the native emission on a 1-core host)
        if (bulk is not None and not tr_records and not splice_result
                and not fusion_result and not dp_result and not amb_result
                and not show_method
                and all(l is not None for l in bulk_lines)):
            nvals = len(bulk_lines)
            unm = bulk_methods == "unmapped"
            mq_l = np.where(unm, 0, mapq[:nvals]).tolist()
            if stats is not None:
                vals, counts = np.unique(np.asarray(bulk_methods, object),
                                         return_counts=True)
                for v, c in zip(vals.tolist(), counts.tolist()):
                    stats[v] = stats.get(v, 0) + int(c)
            out.extend(map(RawSamRecord, bulk_lines,
                           bulk_flags.tolist(), mq_l))
            continue

        def _emit(record, method, nh=1):
            if not record.flag & 4 and i in amb_result:
                # ambiguous splice-end alternatives (src/altsplice.c):
                # the residue stays soft-clipped, the tied distal
                # placements go in XA:Z: (src/path-print-sam.c:958)
                from tpumap.gsnap.spliceends import xa_tag
                record.tags.append(xa_tag(amb_result[i]))
            if not record.flag & 4:
                # NH = number of co-optimal paths found (reference prints
                # NH:i on every line, src/path-print-sam.c:691,929)
                record.tags.append(f"NH:i:{max(1, nh)}")
                record.tags.append("HI:i:1")
                if remapper is not None:
                    # transcript remap + velocity tags (XX/XY,
                    # src/transcript-remap.c, src/transcript-velocity.c)
                    remap_mod.tag_record(remapper, db, record)
            if show_method:
                record.tags.append(f"YM:Z:{method}")
            if stats is not None:
                stats[method] = stats.get(method, 0) + 1
            out.append(record)

        mark0 = len(out)
        for i in rows_iter:
            rec = chunk[i]
            row_marks.append(len(out))
            if bulk is not None and bulk_lines[i] is not None:
                m = bulk_methods[i]
                if stats is not None:
                    stats[m] = stats.get(m, 0) + 1
                out.append(RawSamRecord(
                    bulk_lines[i], int(bulk_flags[i]),
                    0 if m == "unmapped" else int(mapq[i])))
                continue
            li = int(batch["lengths"][i])
            max_equiv = int(li * config.max_mismatch_frac)
            if i in tr_records:
                _emit(tr_records[i], "tr")
                continue
            if i in splice_result:
                s = splice_result[i]
                alen = s["q_end"] - s["q_start"]
                if (s["nmm"] <= max(1, int(alen * config.max_mismatch_frac))
                        and alen >= max(20, int(li * config.min_coverage))):
                    nj = len(s["segs"]) - 1
                    _emit(sam.path_record(
                        db, rec.accession, rec.sequence, rec.quality,
                        s["segs"], s["q_start"], s["q_end"], s["strand"],
                        int(mapq[i]), min_intron=MIN_INTRON, known=known),
                        "splice" if nj else "sub")
                    continue
            if i in fusion_result:
                f = fusion_result[i]
                if f.get("inv") and (3 * li - f["score"]) // 6 \
                        <= max_equiv + 4:
                    recs_f = sam.fusion_records_inverted(
                        db, rec.accession, rec.sequence, rec.quality,
                        f["d_fwd"], f["d_rc"], f["qstar"],
                        f["fwd_first"], int(mapq[i]))
                    _emit(recs_f[0], "fusion")
                    out.extend(recs_f[1:])
                    continue
                if not f.get("inv") and (3 * li - f["score"]) // 6 \
                        <= max_equiv + 4:
                    # --merge-distant-samechr: a colinear same-chromosome
                    # distant splice becomes ONE line with an N gap
                    # instead of primary+supplementary (src/gsnap.c:666)
                    if (merge_distant_samechr and f["dB"] > f["dA"]
                            and db.chrnum(f["dA"])
                            == db.chrnum(f["dB"] + f["qstar"])):
                        _emit(sam.spliced_record(
                            db, rec.accession, rec.sequence, rec.quality,
                            f["dA"], f["dB"], f["qstar"], li,
                            f["strand"], int(mapq[i]), 0), "fusion")
                        continue
                    recs_f = sam.fusion_records(
                        db, rec.accession, rec.sequence, rec.quality,
                        f["dA"], f["dB"], f["qstar"], f["strand"],
                        int(mapq[i]))
                    _emit(recs_f[0], "fusion")
                    out.extend(recs_f[1:])
                    continue
            if i in dp_result:
                pos0, ops, score = dp_result[i]
                equiv_nmm = (3 * li - score) // 6
                if equiv_nmm <= max_equiv:
                    _emit(sam.gapped_record(
                        db, rec.accession, rec.sequence, rec.quality,
                        pos0, int(res["strand"][i]), int(mapq[i]), ops),
                        "indel")
                    continue
            tqs, tqe = 0, li
            if config.soft_clips and "trim_qstart" in res:
                tqs = int(res["trim_qstart"][i])
                tqe = min(int(res["trim_qend"][i]), li)
            trimmed = tqs > 0 or tqe < li
            alen = tqe - tqs
            trim_ok = (res["diag"][i] != 0xFFFFFFFF and trimmed
                       and alen >= max(20, int(li * config.min_coverage))
                       and int(res.get("trim_nmm", res["nmismatch"])[i])
                       <= max(1, int(alen * config.max_mismatch_frac)))
            if res["mapped"][i] and not trimmed:
                from tpumap.ops.mode import MODE_SPACES
                space = MODE_SPACES[config.mode][int(res["strand"][i])]
                _emit(sam.ungapped_record(
                    db, rec.accession, rec.sequence, rec.quality,
                    int(res["diag"][i]), int(res["strand"][i]),
                    int(mapq[i]), int(res["nmismatch"][i]), space=space,
                    snp=config.snp_tolerant), "sub",
                    nh=int(res["n_best"][i]))
                if npaths > 1 and i in sec_map:
                    # secondary alignments (gsnap -n, src/gsnap.c:704):
                    # further co-optimal candidates, flagged 0x100 and
                    # attached to the primary (results stay 1:1 with
                    # input reads; printers emit rec.secondaries after)
                    sd, ss, sn = sec_map[i]
                    seen = {(int(res["diag"][i]), int(res["strand"][i]))}
                    secs = []
                    for cix in range(len(sd)):
                        if len(seen) >= npaths:
                            break
                        dg = int(sd[cix])
                        st = int(ss[cix])
                        nm = int(sn[cix])
                        if (dg == 0xFFFFFFFF or (dg, st) in seen
                                or nm > res["nmismatch"][i]):
                            continue
                        seen.add((dg, st))
                        sec = sam.ungapped_record(
                            db, rec.accession, rec.sequence, rec.quality,
                            dg, st, int(mapq[i]), nm,
                            space=MODE_SPACES[config.mode][st])
                        sec.flag |= 0x100
                        sec.tags.append(f"NH:i:{max(1, int(res['n_best'][i]))}")
                        sec.tags.append(f"HI:i:{len(secs) + 2}")
                        secs.append(sec)
                    if secs:
                        out[-1].secondaries = secs
            elif trim_ok:
                # end-trimmed / soft-clipped alignment (src/path-trim.c):
                # mismatch-dense ends are clipped; the record keeps only
                # the max-scoring query interval
                from tpumap.ops.mode import MODE_SPACES
                space = MODE_SPACES[config.mode][int(res["strand"][i])]
                _emit(sam.ungapped_record(
                    db, rec.accession, rec.sequence, rec.quality,
                    int(res["diag"][i]), int(res["strand"][i]),
                    int(mapq[i]),
                    int(res.get("trim_nmm", res["nmismatch"])[i]),
                    space=space, snp=config.snp_tolerant,
                    q_start=tqs, q_end=tqe), "sub",
                    nh=int(res["n_best"][i]))
            else:
                _emit(sam.unmapped_record(rec.accession, rec.sequence,
                                          rec.quality), "unmapped")

        if sink is not None:
            if mix is not None:
                # splice the Python rows' lines into the native blob at
                # their row offsets (input order preserved)
                row_marks.append(len(out))
                buf, off = blob.buf, blob.off
                pos = 0
                for k, i in enumerate(rows_py):
                    a = int(off[i])
                    if a > pos:
                        sink(buf[pos:a])
                    for r in out[row_marks[k]:row_marks[k + 1]]:
                        sink(r.lines().encode())
                    pos = int(off[i + 1])
                if pos < len(buf):
                    sink(buf[pos:])
            else:
                for r in out[mark0:]:
                    sink(r.lines().encode())
            del out[mark0:]
    return out


def _tr_rung(db, tr, chunk, batch, config):
    """Align the chunk against the transcriptome index and convert solved
    reads to genome-coordinate multi-exon SAM records."""
    import jax
    import jax.numpy as jnp

    transcriptome, tr_index = tr
    res = align_batch_cascaded(
        tr_index, {k: jnp.asarray(v) for k, v in batch.items()
                   if k in ("codes", "nmask", "lengths")}, config)
    res = device_fetch(res)
    mapq = mapq_from_scores(res["nmismatch"], res["second_nmismatch"],
                            res["n_best"], batch["lengths"])
    trdb = transcriptome.trdb
    out = {}
    for i, rec in enumerate(chunk):
        li = int(batch["lengths"][i])
        if not res["mapped"][i]:
            continue
        if int(res["nmismatch"][i]) > int(li * config.max_mismatch_frac):
            continue
        diag = int(res["diag"][i])
        st = int(res["strand"][i])
        trnum = trdb.chrnum(diag)
        tpos = diag - int(trdb.chrom_offsets[trnum])
        trlen = int(trdb.chrom_offsets[trnum + 1] - trdb.chrom_offsets[trnum])
        if tpos + li > trlen:
            continue            # overhangs the transcript end
        segs, minus = transcriptome.map_to_genome(trnum, tpos, li)
        genome_strand = st ^ (1 if minus else 0)
        sense = -1 if minus else 1
        out[i] = sam.multi_exon_record(
            db, rec.accession, rec.sequence, rec.quality, segs,
            genome_strand, int(mapq[i]),
            sense if len(segs) > 1 else 0,
            extra_tags=[f"XG:Z:{transcriptome.labels[trnum]}"])
    return out


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(prog="tpumap-gsnap")
    ap.add_argument("-D", "--dir", required=True, help="database directory")
    ap.add_argument("reads", help="FASTA/FASTQ file")
    ap.add_argument("--batch-size", type=int, default=1024)
    args = ap.parse_args(argv)
    db = GenomeDB.load(args.dir)
    index = DeviceIndex.from_host(db)
    records = list(read_seqs(args.reads))
    sys.stdout.write(sam.header(db, " ".join(argv or sys.argv)))
    for r in align_records(db, index, records):
        sys.stdout.write(r.line() + "\n")


if __name__ == "__main__":
    main()


def align_records_isolated(db, index, records, config=AlignConfig(),
                           batch_size: int = 1024, **kw):
    """Failure isolation (SURVEY §5 / the reference's signal handler that
    prints the problem read, src/gmap.c:4651-4708): align in batch_size
    groups; a group that raises is quarantined and re-run one read at a
    time, so a single poison read costs one batch retry instead of the
    whole run, and its accession is reported on stderr. Reads that still
    fail are emitted as unmapped records. A device runtime error (out of
    memory, a failed compile) is not a poison read: it propagates.

    With sink=..., each group's streamed bytes are buffered locally and
    flushed only when the group succeeds, so a quarantine retry never
    duplicates partial output."""
    from jax.errors import JaxRuntimeError
    sink = kw.pop("sink", None)

    # groups of a run that holds a full batch keep its one batch shape
    pad = len(records) >= batch_size

    def run(grp, pad_tail=False):
        if sink is None:
            return align_records(db, index, grp, config,
                                 batch_size=batch_size, pad_tail=pad_tail,
                                 **kw)
        chunks = []
        align_records(db, index, grp, config, batch_size=batch_size,
                      sink=chunks.append, pad_tail=pad_tail, **kw)
        for c in chunks:
            sink(c)
        return []

    out = []
    for i in range(0, len(records), batch_size):
        grp = records[i:i + batch_size]
        try:
            out.extend(run(grp, pad_tail=pad))
            continue
        except (KeyboardInterrupt, JaxRuntimeError):
            raise
        except Exception as exc:
            sys.stderr.write(f"warning: batch starting at read {i} failed "
                             f"({type(exc).__name__}: {exc}); retrying "
                             f"reads individually\n")
        for rec in grp:
            try:
                out.extend(run([rec]))
            except (KeyboardInterrupt, JaxRuntimeError):
                raise
            except Exception as exc:
                sys.stderr.write(f"error: read {rec.accession} failed "
                                 f"({type(exc).__name__}: {exc}); "
                                 f"reported as unmapped\n")
                unm = sam.unmapped_record(rec.accession, rec.sequence,
                                          rec.quality)
                if sink is not None:
                    sink(unm.lines().encode())
                else:
                    out.append(unm)
    return out
