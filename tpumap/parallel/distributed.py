"""Multi-host reductions for two-pass learning.

The reference's pass-1 learning accumulates splice/indel/insert tables
under a process-local mutex (src/gsnap.c:4259-4352, pass1_lock); its
multi-machine story is "run N independent processes with --part i/n",
which learns only each shard's junctions. A multi-host deployment runs
one jax process per host, so pass-1 tables
are ALL-GATHERED across processes before pass 2 — every host realigns
with the union of learned knowledge (SURVEY §5 "distributed backend",
§3.5 host->host boundary).

Built on jax.experimental.multihost_utils.process_allgather; in a
single-process run every function is an identity, so the same two-pass
driver code serves laptop and pod.
"""
from __future__ import annotations

import numpy as np

from tpumap.gsnap.knownindels import KnownIndels
from tpumap.gsnap.knownsplicing import KnownSplicing


def _nprocs() -> int:
    import jax
    return jax.process_count()


def allgather_array(arr: np.ndarray) -> np.ndarray:
    """Concatenate a variable-length 1-D/2-D array across processes
    (rows from process 0 first). Identity in single-process runs."""
    if _nprocs() == 1:
        return arr
    from jax.experimental import multihost_utils as mh

    arr = np.asarray(arr)
    n = np.asarray([arr.shape[0]], dtype=np.int64)
    all_n = np.asarray(mh.process_allgather(n)).reshape(-1)
    m = int(all_n.max())
    pad_shape = (m,) + arr.shape[1:]
    padded = np.zeros(pad_shape, dtype=arr.dtype)
    padded[:arr.shape[0]] = arr
    gathered = np.asarray(mh.process_allgather(padded))   # [P, m, ...]
    return np.concatenate([gathered[p, :int(all_n[p])]
                           for p in range(len(all_n))], axis=0)


def allgather_knownsplicing(ks: KnownSplicing) -> KnownSplicing:
    """Union of learned splice junctions across processes (the cross-host
    analog of Knownsplicing_new over the merged tables,
    src/gsnap.c:4340-4352)."""
    if _nprocs() == 1:
        return ks
    junc = allgather_array(ks.junctions)
    anti = allgather_array(ks.anti_junctions)
    donors = np.concatenate([junc[:, 0], anti[:, 0]])
    acceptors = np.concatenate([junc[:, 1], anti[:, 1]])
    senses = np.concatenate([np.ones(len(junc), np.int32),
                             -np.ones(len(anti), np.int32)])
    uniq = {}
    for d, a, s in zip(donors.tolist(), acceptors.tolist(),
                       senses.tolist()):
        uniq[(d, a)] = s
    if not uniq:
        return KnownSplicing.from_junctions(
            np.zeros(0, np.uint64), np.zeros(0, np.uint64),
            np.zeros(0, np.int32))
    keys = sorted(uniq)
    return KnownSplicing.from_junctions(
        np.asarray([k[0] for k in keys], np.uint64),
        np.asarray([k[1] for k in keys], np.uint64),
        np.asarray([uniq[k] for k in keys], np.int32))


def allgather_knownindels(ki: KnownIndels) -> KnownIndels:
    """Union of learned indel sites; counts of identical sites sum."""
    if _nprocs() == 1:
        return ki
    coords = allgather_array(ki.coords)
    lengths = allgather_array(ki.lengths)
    counts = allgather_array(ki.counts)
    agg: dict[tuple[int, int], int] = {}
    for c, l, n in zip(coords.tolist(), lengths.tolist(), counts.tolist()):
        agg[(c, l)] = agg.get((c, l), 0) + n
    keys = sorted(agg)
    return KnownIndels(
        np.asarray([k[0] for k in keys], np.uint64),
        np.asarray([k[1] for k in keys], np.int32),
        np.asarray([agg[k] for k in keys], np.int64))


def allreduce_insertlengths(stats: dict | None) -> dict | None:
    """Combine per-process insert-length moments into one global model
    (Pathpair_analyze_insertlengths over the union, src/gsnap.c:4357)."""
    if _nprocs() == 1:
        return stats
    from jax.experimental import multihost_utils as mh

    if stats is None:
        local = np.zeros(3, np.float64)
    else:
        n = float(stats.get("n", 1.0))
        mean = stats["mean"]
        sdev = stats["sdev"]
        local = np.asarray([n, mean * n, (sdev * sdev + mean * mean) * n],
                           dtype=np.float64)
    tot = np.asarray(mh.process_allgather(local)).reshape(-1, 3).sum(axis=0)
    if tot[0] <= 0:
        return None
    mean = tot[1] / tot[0]
    var = max(tot[2] / tot[0] - mean * mean, 0.0)
    sdev = float(np.sqrt(var))
    return {"mean": float(mean), "sdev": sdev,
            "pairmax": int(mean + 10 * max(sdev, 1.0)), "n": float(tot[0])}
