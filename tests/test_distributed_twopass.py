"""Multi-process two-pass table reduction (parallel/distributed.py):
two jax processes each learn DIFFERENT junctions in pass 1; after the
cross-process all-gather both hold the union (SURVEY §5 distributed backend,
src/gsnap.c:4340-4352 role)."""
import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

WORKER = r"""
import json, sys
import numpy as np
import jax

coord, nproc, pid, outdir = sys.argv[1:5]
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(coordinator_address=coord,
                           num_processes=int(nproc),
                           process_id=int(pid))

from tpumap.gsnap.knownindels import KnownIndels
from tpumap.gsnap.knownsplicing import KnownSplicing
from tpumap.parallel import distributed as dist

# each process "learned" a different junction set in pass 1
base = 10_000 * (int(pid) + 1)
ks = KnownSplicing.from_junctions(
    np.asarray([base, base + 500], dtype=np.uint64),
    np.asarray([base + 100, base + 700], dtype=np.uint64),
    np.asarray([1, -1], dtype=np.int32))
ki = KnownIndels(np.asarray([base + 5, 77_777], dtype=np.uint64),
                 np.asarray([3, -2], dtype=np.int32),
                 np.asarray([2, 1], dtype=np.int64))
stats = {"mean": 300.0 + 100 * int(pid), "sdev": 10.0, "n": 50.0}

ks2 = dist.allgather_knownsplicing(ks)
ki2 = dist.allgather_knownindels(ki)
st2 = dist.allreduce_insertlengths(stats)

out = {
    "junctions": ks2.junctions.tolist(),
    "anti": ks2.anti_junctions.tolist(),
    "indel_coords": ki2.coords.tolist(),
    "indel_counts": ki2.counts.tolist(),
    "insert_mean": st2["mean"],
    "insert_n": st2["n"],
}
with open(f"{outdir}/p{pid}.json", "w") as f:
    json.dump(out, f)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_allgather(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=str(pathlib.Path(__file__).parents[1]),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, str(script), coord, "2", str(pid), str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for pid in range(2)]
    for p in procs:
        try:
            _, err = p.communicate(timeout=200)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, err.decode()[-2000:]

    outs = [json.loads((tmp_path / f"p{pid}.json").read_text())
            for pid in range(2)]
    # both processes hold the identical union
    assert outs[0] == outs[1]
    o = outs[0]
    assert sorted(o["junctions"]) == [[10000, 10100], [20000, 20100]]
    assert sorted(o["anti"]) == [[10500, 10700], [20500, 20700]]
    # the shared indel site 77777 sums its counts
    i = o["indel_coords"].index(77777)
    assert o["indel_counts"][i] == 2
    # insert-length moments pool: mean of 50x300 + 50x400 = 350
    assert abs(o["insert_mean"] - 350.0) < 1e-6
    assert o["insert_n"] == 100.0
