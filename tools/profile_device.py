#!/usr/bin/env python3
"""Device-side profile of one fused-ladder batch: top XLA ops by time.

Runs one batch of the bench workload through the fused ladder at the
CLI's default configuration and batch shape (DNA: B=32768, RNA:
B=16384 with -N 1; L=128), traces a second, compiled run with
jax.profiler, and reduces the trace's GPU planes to per-op device time,
the share of it spent in gather ops (the k-mer offsets/positions reads),
and the device busy share of the traced window.

    python tools/profile_device.py [dna|rna]      # on the GPU
"""
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def device_op_times(xplane_path: str):
    """({op name: device ns}, busy ns, window ns, [plane/line names])
    from the compute-stream lines of a trace's GPU planes (a line per
    CUDA stream, named like "Stream #13(MemcpyH2D,Compute)"; its events
    are the kernels and copies run on it)."""
    from jax.profiler import ProfileData
    ops, spans, seen = {}, [], []
    for plane in ProfileData.from_file(xplane_path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            seen.append(f"{plane.name}/{line.name}")
            if "Compute" not in line.name:
                continue
            for ev in line.events:
                ops[ev.name] = ops.get(ev.name, 0) + ev.duration_ns
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    window = (max(b for _a, b in spans) - min(a for a, _b in spans)
              if spans else 0.0)
    return ops, busy, window, seen


def main():
    import glob
    import shutil

    import jax

    from tools import bench_data
    from tpumap.gsnap import ladder
    from tpumap.gsnap.driver import _pack_batch, make_batch
    from tpumap.gsnap.engine import AlignConfig
    from tpumap.index import GenomeDB, build_db
    from tpumap.index.device import DeviceIndex
    from tpumap.io.fasta import read_fasta
    from tpumap.ops import pathdp
    from tpumap.utils.fetch import device_fetch

    rna = len(sys.argv) > 1 and sys.argv[1] == "rna"
    gfa, rfa = (bench_data.ensure_rna_files() if rna
                else bench_data.ensure_files())
    dbdir = bench_data.ROOT / "db_k14"
    if (dbdir / "meta.json").exists():
        db = GenomeDB.load(str(dbdir))
    else:
        db = build_db(gfa, name="bench", k=14, interval=3)
        db.save(str(dbdir))
    index = DeviceIndex.from_host(db)
    B, L = (16384 if rna else 32768), 128
    pb = _pack_batch(make_batch(list(read_fasta(rfa))[:B], B, L))
    # the static arguments driver.align_records passes for this run
    args = (AlignConfig(), L, pathdp.PathScoring(max_intron=200_000),
            rna, rna, min(max(8192, B // 2), B),
            min(max(2048, B // 8), min(max(8192, B // 2), B)),
            min(2048, B))

    def run():
        return device_fetch(ladder.align_batch_full(index, pb, *args))

    run()                      # compile
    t0 = time.perf_counter()
    run()
    print(f"batch wall (dispatch to host arrays): "
          f"{(time.perf_counter() - t0) * 1000:.1f} ms", file=sys.stderr)

    tdir = bench_data.ROOT / "trace"
    shutil.rmtree(tdir, ignore_errors=True)
    jax.profiler.start_trace(str(tdir))
    run()
    jax.profiler.stop_trace()
    ops, busy, window, seen = device_op_times(
        glob.glob(f"{tdir}/**/*.xplane.pb", recursive=True)[0])
    total = sum(ops.values())
    gather = sum(v for k, v in ops.items() if "gather" in k)
    print(f"device lines: {sorted(set(seen))[:6]}")
    print(f"device op time {total / 1e6:.2f} ms; gather ops "
          f"{gather / 1e6:.2f} ms; busy {busy / 1e6:.2f} ms of a "
          f"{window / 1e6:.2f} ms window")
    for name, ns in sorted(ops.items(), key=lambda kv: -kv[1])[:30]:
        print(f"{ns / 1e6:9.3f} ms  {name[:110]}")


if __name__ == "__main__":
    main()
