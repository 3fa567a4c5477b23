"""The port's mesh across two processes: two gloo workers on localhost, with
JAX blocked from import in each (the counterpart of tests/test_multihost.py).

One worker pair checks the topology, the view blocks each process loads and
the view sum across processes.  The other runs a 4×2 mesh of CPU cells,
four in each process, against the port's single-device simultaneous result
(rtol 2e-5, atol 2e-4, as tests/test_multihost.py), then the loader and a
1×8 z-only mesh whose halo ring crosses the processes both ways (the
sequential order).

Each ``communicate`` has its own timeout (``pytest.mark.timeout`` does
nothing here, ROADMAP R6); on a timeout the parent kills the workers and
the test fails.
"""

import os
import socket
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PRELUDE = r"""
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import numpy as np
import torch
torch.set_num_threads(1)
coordinator, n, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
from libmultiviewnative_torch.parallel.distributed import (
    describe_topology, host_local_views, initialize_multihost,
)
initialize_multihost(coordinator_address=coordinator, num_processes=n, process_id=pid,
                     backend="gloo")
"""

_TOPOLOGY = _PRELUDE + r"""
from libmultiviewnative_torch.parallel.sharded import make_mesh, view_sum

topo = describe_topology()
assert topo["process_count"] == n and topo["process_index"] == pid, topo
assert topo["platform"] == "cpu" and topo["global_device_count"] == n, topo
mine = set(host_local_views(6))
assert mine == set(range(3 * pid, 3 * pid + 3)), mine

# one cell per process, both in z column 0: the view sum crosses processes
mesh = make_mesh(view_parallel=2, z_parallel=1, devices=["cpu"])
assert mesh.local_cells == [(pid, 0)], mesh.local_cells
total = view_sum({(pid, 0): torch.full((1, 4), float(pid + 1))}, mesh)
assert float(total[(pid, 0)].sum()) == 4 * 3.0, total
assert sys.modules["jax"] is None
assert not any(m.startswith("libmultiviewnative_tpu") for m in sys.modules)
print(f"proc {pid} OK", flush=True)
"""

_DECONV = _PRELUDE + r"""
from libmultiviewnative_torch.deconv.rl import deconvolve
from libmultiviewnative_torch.deconv.workspace import MultiViewData
from libmultiviewnative_torch.parallel.loader import load_sharded_workspace
from libmultiviewnative_torch.parallel.sharded import (
    MeshTensor, deconvolve_sharded_jit, make_mesh, shard_tensor,
)
from libmultiviewnative_torch.utils.synthetic import gaussian_kernel

# the same data on every process (one seed)
rng = np.random.default_rng(0)
V, shape = 4, (8, 8, 8)
views = rng.gamma(2.0, 20.0, (V,) + shape).astype(np.float32)
k1 = np.stack([gaussian_kernel((3, 3, 3), 1.0 + 0.2 * v) for v in range(V)])
k2 = np.flip(k1, axis=(1, 2, 3)).copy()
w = np.full((V,) + shape, 1.0 / V, np.float32)
psi0 = np.full(shape, float(views.mean()), np.float32)
data = MultiViewData(*(torch.from_numpy(a) for a in (views, k1, k2, w)))

def single(iters, view_order):
    return deconvolve(torch.from_numpy(psi0), data, iters, lam=0.006,
                      view_order=view_order).numpy()

def check(out, want):
    assert not out.mesh.all_local and out.blocks
    for sh in out.local_shards():
        np.testing.assert_allclose(sh.data.numpy(), want[sh.index], rtol=2e-5, atol=2e-4)

def lay_out(mesh, stack_part):
    return (shard_tensor(torch.from_numpy(psi0), mesh, ("z",)), MultiViewData(
        shard_tensor(data.views, mesh, stack_part), shard_tensor(data.kernel1, mesh, ("view",)),
        shard_tensor(data.kernel2, mesh, ("view",)), shard_tensor(data.weights, mesh, stack_part)))

# 4 view rows x 2 z blocks over 8 cells, 4 in each process: rows 0-1 here
# on process 0, rows 2-3 on process 1; the view sum crosses processes
mesh = make_mesh(view_parallel=4, z_parallel=2, devices=["cpu"] * 4)
assert mesh.local_cells == [(v, z) for v in (2 * pid, 2 * pid + 1) for z in (0, 1)]
want = single(2, "simultaneous")
psi, d = lay_out(mesh, ("view", "z"))
check(deconvolve_sharded_jit(psi, d, 2, mesh, lam=0.006), want)

# the loader reads only this process's views
calls = []
def reader_for(v):
    def r(zs):
        calls.append(v)
        return views[v][zs]
    return r
psi_l, data_l = load_sharded_workspace(mesh, [reader_for(v) for v in range(V)], list(k1),
                                       list(k2), [w[v] for v in range(V)], shape,
                                       psi0=lambda zs: psi0[zs])
assert calls and set(calls) == {2 * pid, 2 * pid + 1}, sorted(set(calls))
for sh in data_l.views.local_shards():
    np.testing.assert_array_equal(sh.data.numpy(), views[sh.index])
check(deconvolve_sharded_jit(psi_l, data_l, 2, mesh, lam=0.006), want)
psi_m, _ = load_sharded_workspace(mesh, list(views), list(k1), list(k2), [0.25] * V, shape)
assert all(float(b[0, 0, 0]) == float(np.float32(views.astype(np.float64).mean()))
           for b in psi_m.blocks.values())
print(f"proc {pid} SIMULTANEOUS OK", flush=True)

# the fused engine's z-block convolves across the same processes
fused = deconvolve_sharded_jit(psi, d, 1, mesh, lam=0.006, algorithm="fused")
check(fused, single(1, "simultaneous"))
print(f"proc {pid} FUSED OK", flush=True)

# a 1x8 z-only mesh: blocks 0-3 here on process 0, 4-7 on process 1, so
# the halo ring crosses the processes both ways (bz == halo == 1)
mesh_z = make_mesh(view_parallel=1, z_parallel=8, devices=["cpu"] * 4)
psi_z, d_z = lay_out(mesh_z, ("view", "z"))
check(deconvolve_sharded_jit(psi_z, d_z, 2, mesh_z, lam=0.006, view_order="sequential"),
      single(2, "sequential"))
print(f"proc {pid} SEQUENTIAL OK", flush=True)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_pair(script, timeout):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    coordinator = f"127.0.0.1:{_free_port()}"
    procs = [
        subprocess.Popen([sys.executable, "-u", "-c", script, coordinator, "2", str(pid)],
                         cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"the two workers did not finish within {timeout} s")
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


def test_two_process_topology_and_view_sum():
    outs = _run_pair(_TOPOLOGY, 120)
    for pid in (0, 1):
        assert f"proc {pid} OK" in outs[pid]


def test_two_process_sharded_deconvolve():
    outs = _run_pair(_DECONV, 240)
    for pid in (0, 1):
        for tag in ("SIMULTANEOUS OK", "FUSED OK", "SEQUENTIAL OK"):
            assert f"proc {pid} {tag}" in outs[pid], (pid, tag, outs[pid][-2000:])
