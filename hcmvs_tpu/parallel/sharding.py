"""Multi-chip sharding of the dense pipeline.

The reference has no distributed backend at all — pthread pools inside a
process, files (`mv depthmap ...`) between stages (SURVEY §2.4, run.sh).
The batched replacement: a ``jax.sharding.Mesh`` with two axes,

- ``view``: data-parallel over reference images — each device estimates a
  slice of the scene's depth maps.  Cross-view reads (the geometric
  consistency term's neighbor-map lookups and fusion's reprojections) are
  gathers across the view axis, which GSPMD lowers to all-gathers over
  ICI — the collective replacement for the reference's file-based handoff.
- ``tile``: sequence-parallel analog — one image's pixel rows split across
  devices.  The propagation stencil and patch windows read static-offset
  slices, which GSPMD lowers to halo exchanges (SURVEY §5.7).

Everything flows through standard NamedSharding + jit: the estimation code
in dense/ is unchanged; only the placement specs here differ between a
single chip, a pod slice, or the CPU-backed virtual mesh used in tests.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from hcmvs_tpu.dense.scene_driver import SceneState, SceneTensors


def make_device_mesh(n_view: Optional[int] = None,
                     n_tile: int = 1,
                     devices=None) -> Mesh:
    """Build a (view, tile) mesh over the available devices."""
    devices = devices if devices is not None else jax.devices()
    if n_view is None:
        n_view = len(devices) // n_tile
    devs = np.asarray(devices[:n_view * n_tile]).reshape(n_view, n_tile)
    return Mesh(devs, axis_names=("view", "tile"))


def scene_shardings(mesh: Mesh) -> Tuple[SceneTensors, SceneState]:
    """NamedSharding pytrees matching SceneTensors / SceneState.

    Image-indexed arrays shard over ("view", "tile") on their first two
    axes; per-scene scalars and the camera bundle are replicated (they are
    tiny and every device needs every camera for cross-view projection).
    """
    from hcmvs_tpu.ops.volume import VolumeTables

    def nshard(*spec):
        return NamedSharding(mesh, P(*spec))

    img3 = nshard("view", "tile", None)        # (N, H, W)
    # planes-first fields (dense/types.py LAYOUT RULE): (N, C, H, W) —
    # rows are axis 2, so the tile axis shards dim 2
    planes4 = nshard("view", None, "tile", None)
    per_img = nshard("view")                   # (N,)
    repl = nshard()
    # exact-scoring sweep tables: (N, V, P_pad, D) — view-sharded; the
    # flattened-pixel axis interleaves rows, so the tile axis does not
    # shard it (tile devices of a view row read the table via gather)
    vols = VolumeTables(tab=nshard("view", None, None, None),
                        sig0=nshard("view", None),
                        inv_dsig=nshard("view", None),
                        sig_lo=nshard("view", None, None, None),
                        sig_hi=nshard("view", None, None, None))

    tensors = SceneTensors(
        gray=img3,
        cams=_cam_spec(repl),  # cameras are tiny; every device needs all
        nbr_idx=nshard("view", None),
        nbr_valid=nshard("view", None),
        d_min=per_img, d_max=per_img,
        seed_depth=img3, flows=planes4, prior_depth=img3,
        semantic=img3, inject_depth=img3, inject_normal=planes4,
        vols=vols)
    state = SceneState(depth=img3, normal=planes4, cost=img3,
                       keys=nshard("view", None))
    return tensors, state


def _cam_spec(per_img):
    from hcmvs_tpu.core.camera import Camera
    return Camera(K=per_img, R=per_img, C=per_img)


def shard_scene(scene: SceneTensors, state: SceneState, mesh: Mesh
                ) -> Tuple[SceneTensors, SceneState]:
    """Place an existing host-side scene/state onto the mesh."""
    t_shard, s_shard = scene_shardings(mesh)

    def put(x, s):
        if x is None:
            return None
        return jax.device_put(x, s)

    scene_sharded = jax.tree.map(
        put, scene, _match_tree(t_shard, scene),
        is_leaf=lambda x: x is None)
    state_sharded = jax.tree.map(put, state, _match_tree(s_shard, state),
                                 is_leaf=lambda x: x is None)
    return scene_sharded, state_sharded


def _match_tree(spec_tree, value_tree):
    """Prune sharding entries whose value is None (optional fields) —
    field-wise, so container-valued fields (e.g. the VolumeTables
    NamedTuple) keep their per-leaf specs when present."""
    import dataclasses as _dc
    kw = {}
    for f in _dc.fields(type(value_tree)):
        v = getattr(value_tree, f.name)
        kw[f.name] = None if v is None else getattr(spec_tree, f.name)
    return type(value_tree)(**kw)


def shard_ba(problem, state, mesh: Mesh):
    """Place a BA problem on the mesh: observations and points shard over
    all devices (the reference has no distributed BA at all — OpenMVG runs
    single-node; SURVEY §7 hard part #3).  The per-observation Jacobian
    products and the segment-sums into the camera/point normal blocks
    then run sharded, and GSPMD inserts the cross-device reductions
    (psum) for the reduced camera system — the distributed Schur
    complement, with the tiny (C, 6, 6) camera system replicated.
    """
    from hcmvs_tpu.sfm.ba import BAProblem, BAState
    every = P(("view", "tile"))
    obs = NamedSharding(mesh, every)
    obs2 = NamedSharding(mesh, P(("view", "tile"), None))
    repl = NamedSharding(mesh, P())
    pts = NamedSharding(mesh, P(("view", "tile"), None))
    p_spec = BAProblem(
        K=repl, obs_cam=obs, obs_pt=obs, obs_uv=obs2, obs_valid=obs,
        fixed_cams=repl, dist=repl)
    s_spec = BAState(rvecs=repl, tvecs=repl, points=pts)
    problem = jax.tree.map(jax.device_put, problem, p_spec)
    state = jax.tree.map(jax.device_put, state, s_spec)
    return problem, state
