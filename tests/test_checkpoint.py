import os

import numpy as np

from geosongpu_tpu.core.config import DycoreConfig
from geosongpu_tpu.harness.checkpoint import latest_step, restore, save
from geosongpu_tpu.models.held_suarez import build_model


def test_checkpoint_roundtrip(tmp_path):
    cfg = DycoreConfig(npx=8, npz=8, dt=600.0, n_split=2)
    model = build_model(cfg)
    st = model.init(perturb=0.01)
    s1 = model.step_fn(st)

    d = str(tmp_path / "ckpts")
    save(d, s1, cfg, step=1)
    save(d, model.step_fn(s1), cfg, step=2)
    assert latest_step(d) == 2

    restored, step = restore(d, st, step=1)
    assert step == 1
    np.testing.assert_array_equal(np.asarray(restored.delp),
                                  np.asarray(s1.delp))
    np.testing.assert_array_equal(np.asarray(restored.u), np.asarray(s1.u))

    # resume: stepping the restored state matches stepping the original
    a = model.step_fn(restored)
    b = model.step_fn(s1)
    np.testing.assert_array_equal(np.asarray(a.pt), np.asarray(b.pt))


def _cache_dir_after(monkeypatch, env_value):
    import jax

    from geosongpu_tpu.harness.checkpoint import enable_compilation_cache

    if env_value is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_value)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = enable_compilation_cache()
        return path, jax.config.jax_compilation_cache_dir
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_follows_env_var(monkeypatch, tmp_path):
    want = str(tmp_path / "xla_cache")
    path, configured = _cache_dir_after(monkeypatch, want)
    assert path == configured == want
    assert os.path.isdir(want)


def test_compile_cache_defaults_to_checkout(monkeypatch):
    path, configured = _cache_dir_after(monkeypatch, None)
    checkout = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == configured == os.path.join(checkout, ".jax_cache")
