"""Tests that need the GPU; they skip elsewhere.

    JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu
"""

import jax
import pytest


@pytest.mark.gpu
def test_parity_gpu_vs_cpu_small(gpu):
    """chip_smoke's parity cases at a small size, GPU against the host."""
    import chip_smoke
    results = chip_smoke.run_parity(gpu, jax.devices("cpu")[0], h=96,
                                    w=128)
    bad = [r for r in results if not r[4]]
    assert not bad, bad


@pytest.mark.gpu
def test_ba_step_precision_gpu(gpu):
    """The matmul-precision pin in sfm/ba.py holds under TF32."""
    import chip_smoke
    _, _, rel = chip_smoke.run_ba_check(gpu, jax.devices("cpu")[0],
                                        n_cams=30, n_pts=2000)
    assert rel <= chip_smoke.BA_RTOL
