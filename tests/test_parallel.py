"""Multi-device tests on the virtual 8-device CPU mesh (SURVEY.md SS4: the
reference could only test multi-node on the cluster)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from geosongpu_tpu.core.config import DycoreConfig, MeshConfig
from geosongpu_tpu.models.held_suarez import build_model
from geosongpu_tpu.parallel.mesh import make_mesh, shard_state, state_sharding

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices")


def test_face_sharded_step_matches_single_device():
    cfg = DycoreConfig(npx=8, npz=8, dt=600.0, n_split=2)
    model = build_model(cfg)
    st = model.init(perturb=0.01)

    ref = model.step_fn(st)

    mesh = make_mesh(MeshConfig(face=6, y=1, x=1))
    sst = shard_state(mesh, st)
    out = jax.jit(model.step_fn.apply)(sst, model.step_fn.arrays)

    np.testing.assert_allclose(np.asarray(out.delp), np.asarray(ref.delp),
                               rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(np.asarray(out.u), np.asarray(ref.u),
                               rtol=1e-5, atol=1e-5)


def test_mixed_mesh_step_runs():
    cfg = DycoreConfig(npx=16, npz=8, dt=600.0, n_split=2)
    model = build_model(cfg)
    st = model.init(perturb=0.01)
    mesh = make_mesh(MeshConfig(face=2, y=2, x=2))
    sst = shard_state(mesh, st)
    out = jax.jit(model.step_fn.apply)(sst, model.step_fn.arrays)
    assert bool(jnp.isfinite(out.pt).all())


def test_comm_microbench_runs():
    from geosongpu_tpu.parallel.mesh import comm_microbench

    r = comm_microbench(sizes_bytes=[4096], repeats=2)
    assert len(r["sizes"]) == 1
    assert r["ppermute_gbps"][0] > 0
    assert r["psum_us"][0] > 0
