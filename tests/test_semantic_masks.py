"""Semantic-mask file ingestion end-to-end (ref: Image::maskName,
frame_main/libs/MVS/Image.h:75-99; GenerateDepthPrior over masks,
SceneDensify.cpp:1550-1950; the final hierarchy stage's --use-semantic 1,
data/frame_main/resize1/run.py)."""

import os
import sys

import dataclasses
import jax
import numpy as np
import pytest

from hcmvs_tpu.core.config import DenseConfig
from hcmvs_tpu.io.images import write_png
from hcmvs_tpu.pipeline.densify import (build_scene_tensors,
                                        find_scene_masks, load_scene_masks)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from synthetic import make_plane_scene                       # noqa: E402
from test_pipeline import CFG, _write_scene                  # noqa: E402


def _write_masks(tmp_path, sc, color_coded=False):
    """Two-region masks split at the image center column — carries real
    structure information (each half of the plane scene is one region)."""
    masks_dir = tmp_path / "masks"
    os.makedirs(masks_dir, exist_ok=True)
    h, w = sc.images[0].shape
    for i in range(len(sc.images)):
        m = np.zeros((h, w), np.uint8)
        m[:, w // 2:] = 7                      # non-contiguous raw ids
        m[:h // 4, :] = 3
        if color_coded:
            rgb = np.zeros((h, w, 3), np.uint8)
            rgb[..., 0] = m * 30
            rgb[..., 2] = 255 - m * 20
            write_png(str(masks_dir / f"im{i:04d}.png"), rgb[..., ::-1])
        else:
            write_png(str(masks_dir / f"im{i:04d}.png"), m)
    return str(masks_dir)


@pytest.fixture(scope="module")
def scene():
    return make_plane_scene(np.random.default_rng(9), h=48, w=64,
                            n_views=3)


def test_mask_discovery_and_label_space(scene, tmp_path):
    from hcmvs_tpu.io.mvs import read_mvs
    scene_path, img_dir = _write_scene(tmp_path, scene)
    masks_dir = _write_masks(tmp_path, scene)
    mvs = read_mvs(scene_path)

    assert find_scene_masks(mvs, img_dir) is None   # no masks -> None
    paths = find_scene_masks(mvs, img_dir, masks_dir)
    assert paths is not None and all(p is not None for p in paths)

    sem = load_scene_masks(paths, scene.images[0].shape)
    assert sem.shape == (3, 48, 64) and sem.dtype == np.int32
    assert sem.max() == 2                    # ids {0,3,7} -> dense {0,1,2}
    # identical raw ids map to the same label in every view
    assert (sem[0] == sem[1]).all()


def test_color_coded_masks(scene, tmp_path):
    from hcmvs_tpu.io.images import load_semantic_mask
    masks_dir = _write_masks(tmp_path, scene, color_coded=True)
    m = load_semantic_mask(os.path.join(masks_dir, "im0000.png"))
    assert m.shape == scene.images[0].shape
    assert len(np.unique(m)) == 3


def test_mask_name_field_resolution(scene, tmp_path):
    """Masks recorded in the scene itself (Image::maskName) win."""
    from hcmvs_tpu.io.mvs import read_mvs, write_mvs
    scene_path, img_dir = _write_scene(tmp_path, scene)
    masks_dir = _write_masks(tmp_path, scene)
    mvs = read_mvs(scene_path)
    for i, im in enumerate(mvs.images):
        im.mask_name = os.path.join(masks_dir, f"im{i:04d}.png")
    write_mvs(scene_path, mvs)
    mvs2 = read_mvs(scene_path)
    paths = find_scene_masks(mvs2, img_dir)
    assert paths is not None and all(p is not None for p in paths)


def test_semantic_priors_differ_from_slic_only(scene, tmp_path):
    """The mask-fed prior pass must provably differ from the SLIC
    self-prior path (the r2 gap: use_semantic silently degraded to SLIC
    because no pipeline code loaded masks)."""
    from hcmvs_tpu.dense.scene_driver import (compute_scene_priors,
                                              init_scene_state)
    from hcmvs_tpu.io.mvs import read_mvs
    scene_path, img_dir = _write_scene(tmp_path, scene)
    masks_dir = _write_masks(tmp_path, scene)
    mvs = read_mvs(scene_path)
    sem = load_scene_masks(find_scene_masks(mvs, img_dir, masks_dir),
                           scene.images[0].shape)
    grays = [im.astype(np.float32) for im in scene.images]
    t_sem = build_scene_tensors(mvs, grays, CFG, semantic=sem)
    t_slic = dataclasses.replace(t_sem, semantic=None)

    # state near GT so segment plane fits are meaningful
    state = init_scene_state(jax.random.PRNGKey(0), t_sem)
    gt = np.broadcast_to(scene.depth_gt, state.depth.shape)
    state = dataclasses.replace(
        state, depth=jax.numpy.asarray(gt * np.random.default_rng(0)
                                       .normal(1.0, 0.003, gt.shape))
        .astype(jax.numpy.float32))

    p_sem = np.asarray(compute_scene_priors(state, t_sem).prior_depth)
    p_slic = np.asarray(compute_scene_priors(state, t_slic).prior_depth)
    assert p_sem.shape == p_slic.shape
    assert not np.allclose(p_sem, p_slic)
    # where the semantic prior speaks, it matches the GT plane depth
    valid = p_sem > 0
    assert valid.mean() > 0.3
    rel = np.abs(p_sem - gt)[valid] / gt[valid]
    assert np.median(rel) < 0.02


def test_densify_with_masks(scene, tmp_path):
    """The DensifyPointCloud-analog CLI path consumes --masks-dir."""
    from hcmvs_tpu.pipeline.densify import densify
    scene_path, img_dir = _write_scene(tmp_path, scene)
    masks_dir = _write_masks(tmp_path, scene)
    cfg = CFG.replace(use_semantic=True, estimation_iters_external=2)
    out = str(tmp_path / "out_sem")
    stats = densify(scene_path, img_dir, out, cfg, verbose=False,
                    masks_dir=masks_dir)
    assert stats["valid_frac"] > 0.5
    assert stats["n_points"] > 200
