"""Multi-host ordered output merge (gsnap --ordered across processes).

The reference prints in input order from ONE process via
Outbuffer_thread_ordered (src/outbuffer.c:1387): worker threads hand
result blocks to an output thread that releases them in sequence.  A
multi-host deployment's scale-out unit is a PROCESS per host (--part i/n
auto-sharding over jax.process_count()), so the same contract needs a
cross-process gather: every process formats its own shard's records, tags each
with its GLOBAL input ordinal, and process 0 writes the merged stream
in ordinal order — byte-identical to a single-process run, including
--split-output category routing.

Transport is jax.experimental.multihost_utils.process_allgather (the
same channel as the two-pass table reduction, parallel/distributed.py);
in a single-process run everything degenerates to local pass-through.
"""
from __future__ import annotations

import numpy as np

from tpumap.parallel.distributed import _nprocs, allgather_array


class _MergeFile:
    """File-like that records (ordinal, category, text) chunks."""

    def __init__(self, merge: "OrderedMerge", cat: str | None):
        self._merge = merge
        self._cat = cat

    def write(self, text: str) -> int:
        self._merge._chunks.append((self._merge.cur, self._cat, text))
        return len(text)

    def flush(self) -> None:
        pass


class OrderedMerge:
    """Collects output chunks keyed by global input ordinal.

    Usage in a CLI write loop::

        merge = OrderedMerge(part)          # part = (pid, nproc)
        for rec, s in merge.iter(zip(records, results)):
            ...router/file writes go to merge-wrapped sinks...
        merge.finalize(writer)              # writer(cat, text) on proc 0

    iter() sets the current global ordinal (local j -> j*n + p, the
    --part modular sharding inverse) so every chunk written while an
    item is being processed is tagged with that item's input position.
    Chunks written before iteration starts (headers) carry ordinal -1
    and are emitted first, only from process 0's copy.
    """

    def __init__(self, part: tuple[int, int]):
        self.p, self.n = part
        self.cur = -1
        self._chunks: list[tuple[int, str | None, str]] = []

    def iter(self, items):
        for j, item in enumerate(items):
            self.cur = j * self.n + self.p
            yield item
        self.cur = -1

    def file(self, cat: str | None = None) -> _MergeFile:
        return _MergeFile(self, cat)

    def categories(self) -> set:
        """Local categories used (for split-output header emission)."""
        return {c for _o, c, _t in self._chunks if c is not None}

    def finalize(self, write) -> bool:
        """Gather all processes' chunks; on the writer process, call
        write(cat, text) in global input order and return True.  Other
        processes return False (they write nothing)."""
        import jax

        chunks = self._chunks
        if _nprocs() == 1:
            for o, c, t in sorted(chunks, key=lambda x: x[0]):
                write(c, t)
            return True
        # category name table: gathered as one joined string so ids are
        # globally consistent
        cats = sorted(self.categories())
        # trailing NUL so adjacent processes' name lists can't fuse
        cat_blob = np.frombuffer(
            ("\x00".join(cats) + "\x00").encode(), np.uint8)
        all_cat = allgather_array(cat_blob.reshape(-1, 1))
        names = bytes(all_cat.reshape(-1)).decode()
        table = sorted({c for c in names.split("\x00") if c})
        cat_id = {c: i for i, c in enumerate(table)}

        my_pid = jax.process_index()
        ords = np.asarray([o for o, _c, _t in chunks], np.int64)
        cids = np.asarray([-1 if c is None else cat_id[c]
                           for _o, c, _t in chunks], np.int64)
        texts = [t.encode() for _o, _c, t in chunks]
        lens = np.asarray([len(t) for t in texts], np.int64)
        blob = np.frombuffer(b"".join(texts), np.uint8)
        meta = np.stack([ords, cids, lens], axis=1) if chunks else \
            np.zeros((0, 3), np.int64)
        # every collective runs on EVERY process (matching order), the
        # early return comes after
        all_meta = allgather_array(meta)
        all_blob = allgather_array(blob.reshape(-1, 1)).reshape(-1)
        n_meta = allgather_array(np.asarray([[len(chunks)]], np.int64))
        n_blob = allgather_array(
            np.asarray([[int(lens.sum())]], np.int64)).reshape(-1)
        if my_pid != 0:
            return False
        boff = np.concatenate([[0], np.cumsum(n_blob)])
        rows = []
        mi = 0
        hdr_cats = set()     # categories whose header chunk is kept
        for p in range(len(n_blob)):
            off = int(boff[p])
            for _ in range(int(n_meta.reshape(-1)[p])):
                o, ci, ln = (int(all_meta[mi, 0]), int(all_meta[mi, 1]),
                             int(all_meta[mi, 2]))
                if o >= 0:
                    rows.append((o, mi, ci, off, ln))
                elif ci < 0:
                    # default-stream headers: process 0's copy only
                    if p == 0:
                        rows.append((o, mi, ci, off, ln))
                else:
                    # split-output category headers: keep the FIRST
                    # process's copy — a category may exist only in a
                    # non-zero process's shard
                    if ci not in hdr_cats:
                        hdr_cats.add(ci)
                        rows.append((o, mi, ci, off, ln))
                off += ln
                mi += 1
        rows.sort(key=lambda r: (r[0], r[1]))
        for o, _mi, ci, off, ln in rows:
            cat = None if ci < 0 else table[ci]
            write(cat, bytes(all_blob[off:off + ln]).decode())
        return True


class MergeRouter:
    """OutputRouter stand-in that records category-tagged chunks."""

    def __init__(self, merge: OrderedMerge):
        self._m = merge
        self._files: dict = {}

    def get(self, cat):
        return self._files.setdefault(cat, self._m.file(cat))

    def close(self) -> None:
        pass
