"""Platform-independent plumbing of the main path: engine resolution, the
compile-cache policy, stage checkpoints, the flow backend and the
synthetic scene writer."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hcmvs_tpu.core.config import DenseConfig, resolve_engines


def test_auto_engines_resolve_without_the_platform(monkeypatch):
    """"auto" resolves in one place, from the config alone."""
    def no_backend():
        raise AssertionError("engine choice must not ask the platform")
    monkeypatch.setattr(jax, "default_backend", no_backend)
    eng = resolve_engines(DenseConfig())
    assert eng == ("bilinear", "direct", "planes")
    from hcmvs_tpu.dense import score as S
    from hcmvs_tpu.ops.volume import use_rect_volume_build
    cfg = DenseConfig()
    assert not S.use_volume_tables(cfg)
    assert not S.use_rect_backend(cfg, 960, 1280)
    assert not use_rect_volume_build(cfg, 960, 1280)
    assert not S.use_candidate_batch(cfg)


@pytest.mark.parametrize("field,value,index", [
    ("exact_backend", "volume", 0), ("geo_backend", "rect", 1),
    ("volume_build", "rect", 2)])
def test_explicit_engines_win(field, value, index):
    cfg = DenseConfig(**{field: value})
    assert resolve_engines(cfg)[index] == value
    from hcmvs_tpu.dense import score as S
    from hcmvs_tpu.ops.volume import use_rect_volume_build
    routed = {0: S.use_volume_tables(cfg),
              1: S.use_rect_backend(cfg, 64, 96),
              2: use_rect_volume_build(cfg, 64, 96)}
    assert routed[index]
    # the rect build is 128-plane only
    if index == 2:
        assert not use_rect_volume_build(cfg.replace(volume_planes=256),
                                         64, 96)


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_helper(monkeypatch, env_set):
    from hcmvs_tpu.utils import compile_cache as CC
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
        assert CC.enable_compile_cache() is None
        assert calls == []
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        d = CC.enable_compile_cache()
        assert d == CC.DEFAULT_CACHE_DIR
        assert ("jax_compilation_cache_dir", d) in calls
        # fixed, inside the checkout
        assert os.path.dirname(d) == CC.CHECKOUT_DIR
        assert os.path.exists(os.path.join(CC.CHECKOUT_DIR, "hcmvs_tpu"))


def test_stage_checkpoint_roundtrip(tmp_path):
    from hcmvs_tpu.dense.scene_driver import SceneState
    from hcmvs_tpu.pipeline.hierarchy import (_latest_stage, _stage_path,
                                              load_stage_state,
                                              save_stage_state)
    rng = np.random.default_rng(0)
    st = SceneState(depth=jnp.asarray(rng.random((2, 8, 12)), jnp.float32),
                    normal=jnp.asarray(rng.random((2, 3, 8, 12)),
                                       jnp.float32),
                    cost=jnp.asarray(rng.random((2, 8, 12)), jnp.float32),
                    keys=jax.random.split(jax.random.PRNGKey(3), 2))
    d = str(tmp_path)
    assert _latest_stage(d) is None
    for si in (0, 1):
        save_stage_state(_stage_path(d, si), st)
    assert _latest_stage(d) == 1
    assert sorted(os.listdir(d)) == ["stage0.npz", "stage1.npz"]
    back = load_stage_state(_stage_path(d, 1))
    for f in ("depth", "normal", "cost", "keys"):
        a, b = np.asarray(getattr(st, f)), np.asarray(getattr(back, f))
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_default_schedule_finest_level():
    from hcmvs_tpu.pipeline.hierarchy import default_schedule
    assert [s.level for s in default_schedule(DenseConfig())] == \
        [3, 2, 2, 1, 1]
    sched = default_schedule(DenseConfig(), finest_level=0)
    assert [s.level for s in sched] == [2, 1, 1, 0, 0]
    assert [s.variant for s in sched] == ["A", "B", "A", "B", "A"]


def test_scene_flows_default_is_lk(monkeypatch):
    """The flow backend is a config value: "lk" by default, with no
    import-dependent switch; "farneback" without OpenCV raises."""
    import sys
    from hcmvs_tpu.dense import flow as F
    assert DenseConfig().flow_backend == "lk"
    rng = np.random.default_rng(0)
    base = rng.random((40, 56)).astype(np.float32)
    grays = np.stack([base, np.roll(base, 1, axis=1)])
    nbr = np.array([[1], [0]])
    fl = F.scene_flows(grays, nbr)
    assert fl.shape == (2, 2, 40, 56) and np.isfinite(fl).all()
    np.testing.assert_allclose(
        fl, F.scene_flows(grays, nbr, DenseConfig().flow_backend))
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="OpenCV"):
        F.scene_flows(grays, nbr, "farneback")
    with pytest.raises(ValueError):
        F.scene_flows(grays, nbr, "bogus")


def test_write_scene_mvs(tmp_path):
    from hcmvs_tpu.io.images import load_image
    from hcmvs_tpu.io.mvs import read_mvs
    from hcmvs_tpu.utils.synth import make_ridge_scene, write_scene_mvs
    sc = make_ridge_scene(np.random.default_rng(0), h=48, w=64, n_views=3)
    path, img_dir = write_scene_mvs(sc, str(tmp_path), n_sparse=50)
    scene = read_mvs(path)
    assert len(scene.images) == 3 and len(scene.points) == 50
    img = load_image(os.path.join(img_dir, scene.images[1].name),
                     gray=True)
    np.testing.assert_allclose(img, sc.images[1], atol=0.5 / 255 + 1e-6)
    # sparse points lie on the surface: reproject into view 0 at GT depth
    R, C = scene.pose_of(0)
    Xc = (scene.points - C) @ R.T
    K = scene.intrinsics_of(0, 64, 48)
    uv = Xc @ K.T
    u = np.round(uv[:, 0] / uv[:, 2]).astype(int)
    v = np.round(uv[:, 1] / uv[:, 2]).astype(int)
    np.testing.assert_allclose(Xc[:, 2], sc.depth_gt[v, u], rtol=1e-4)
