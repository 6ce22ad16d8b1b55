"""hcmvs_tpu — an SfM+MVS framework in JAX.

A ground-up JAX/XLA re-design of the capability set of HC-MVS
(reference: Liaoyongjian1/HC-MVS, an OpenMVS v1.1.1 fork pair + driver layer):

- ``sfm``      : feature detection/matching, two-view geometry, incremental
                 bundle adjustment (ref: external OpenMVG binaries driven by
                 frame_main/MvgMvsPipeline.py).
- ``dense``    : PatchMatch multi-view stereo with the full HC-MVS cost stack
                 (photometric ZNCC, geometric consistency, optical-flow
                 cross-consistency, local smoothness, planar priors) re-cast
                 as red/black checkerboard sweeps (ref:
                 frame_main/libs/MVS/DepthMap.cpp, SceneDensify.cpp).
- ``mesh``     : surface reconstruction, variational refinement, texturing
                 (ref: SceneReconstruct.cpp, SceneRefine[CUDA].cpp,
                 SceneTexture.cpp).
- ``ops``      : gather samplers, gradients and the table lookup engines.
- ``parallel`` : multi-chip sharding (view axis / tile axis) over
                 jax.sharding.Mesh; replaces the reference's pthread pools
                 and file-based stage handoff.
- ``io``       : binary-compatible `.mvs` / `.dmap` readers-writers
                 (ref: libs/MVS/Interface.h) plus PLY/OBJ and image pyramids.
- ``pipeline`` : stage drivers replicating run.sh / MvgMvsPipeline.py
                 schedules, including the 5-stage hierarchical-cross schedule.
"""

__version__ = "0.1.0"
