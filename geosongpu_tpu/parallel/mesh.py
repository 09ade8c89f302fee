"""Device meshes, sharding plans, and comm microbenchmarks.

The reference's parallel story is MPI domain decomposition configured by
file-swapped layouts (SURVEY.md SS2.10) over an OpenMPI/UCX transport that
is built and OSU-benchmarked in-repo (/root/reference/sw_stack/.../osu-bench.sh:15-86,
results archived in results/mpi_gpu_rdma/24W7.json).  Mapping here:

* `make_mesh(mesh_cfg)`: jax.sharding.Mesh over (face, y, x) axes - the
  cubed-sphere analog of NX x NY x 6 rank layouts;
* `shard_state`: NamedSharding plan for the DycoreState pytree (face and
  intra-face y decomposition; staggered +1 dims replicated in the GSPMD
  path);
* `comm_microbench`: ppermute/psum bandwidth+latency sweep - the OSU
  latency/bw analog, reporting achieved bytes/s per message size so scaling
  regressions are attributable to transport vs compute.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.config import MeshConfig


def make_mesh(cfg: MeshConfig, devices: Optional[list] = None) -> Mesh:
    devs = devices if devices is not None else jax.devices()
    n = cfg.n_devices
    if len(devs) < n:
        raise ValueError(f"mesh needs {n} devices, have {len(devs)}")
    arr = np.asarray(devs[:n]).reshape(cfg.face, cfg.y, cfg.x)
    return Mesh(arr, axis_names=("face", "y", "x"))


def state_sharding(mesh: Mesh, state) -> "jax.tree_util.PyTreeDef":
    """NamedSharding plan for a DycoreState pytree: shard the face dim over
    'face' and the intra-face y dim over 'y' where divisible; replicate
    staggered (+1) dims - the GSPMD halo gathers insert the collectives."""
    fsz = mesh.shape["face"]
    ysz = mesh.shape["y"]

    def spec(x):
        if x.ndim >= 2 and x.shape[0] == 6 and 6 % max(fsz, 1) == 0:
            parts = ["face" if fsz > 1 else None]
            if x.ndim >= 3 and x.shape[1] % ysz == 0 and ysz > 1:
                parts.append("y")
            return NamedSharding(mesh, P(*parts))
        return NamedSharding(mesh, P())

    return jax.tree.map(spec, state)


def shard_state(mesh: Mesh, state):
    return jax.tree.map(
        lambda x, s: jax.device_put(x, s), state, state_sharding(mesh, state))


# --------------------------------------------------------------------------
# OSU-analog comm microbenchmark
# --------------------------------------------------------------------------

def comm_microbench(sizes_bytes: Optional[List[int]] = None,
                    repeats: int = 20) -> Dict[str, list]:
    """ppermute ring bandwidth + psum latency across all local devices.

    Returns {"sizes": [...], "ppermute_gbps": [...], "psum_us": [...]} -
    the achieved-vs-spec table the reference archives for its MPI transport
    (results/mpi_gpu_rdma/24W7.json analog).  Runs on however many devices
    are visible (1 device -> measures loopback copy).
    """
    devs = jax.devices()
    n = len(devs)
    mesh = Mesh(np.asarray(devs), axis_names=("d",))
    sizes = sizes_bytes or [2 ** k for k in range(12, 25, 2)]  # 4KB..16MB

    from jax import shard_map

    out: Dict[str, list] = {"sizes": [], "ppermute_gbps": [], "psum_us": []}
    for size in sizes:
        elems = max(size // 4, 1)
        x = jnp.zeros((n, elems), jnp.float32)
        x = jax.device_put(x, NamedSharding(mesh, P("d")))

        @jax.jit
        def ring(x):
            def f(xs):
                perm = [(i, (i + 1) % n) for i in range(n)]
                return jax.lax.ppermute(xs, "d", perm)

            return shard_map(f, mesh=mesh, in_specs=P("d"),
                             out_specs=P("d"))(x)

        ring(x).block_until_ready()  # compile
        t0 = time.perf_counter()
        for _ in range(repeats):
            x = ring(x)
        x.block_until_ready()
        dt = (time.perf_counter() - t0) / repeats
        out["sizes"].append(size)
        out["ppermute_gbps"].append(size / dt / 1e9)

        y = jax.device_put(jnp.zeros((n, 64), jnp.float32),
                           NamedSharding(mesh, P("d")))

        @jax.jit
        def allred(y):
            def f(ys):
                return jax.lax.psum(ys, "d")

            return shard_map(f, mesh=mesh, in_specs=P("d"),
                             out_specs=P(None))(y)

        allred(y).block_until_ready()
        t0 = time.perf_counter()
        for _ in range(repeats):
            r = allred(y)
        r.block_until_ready()
        out["psum_us"].append((time.perf_counter() - t0) / repeats * 1e6)
    return out
