"""Port vs ``perf_tpu``: the geometry refiner's whole ``refine`` against
JAX's, through the collapse both packages share.

At this size (and the port at full width on the card) the refiner returns
a constant map: the raw head starts near -0.5 where the room is at about
+0.9, and Adam at 1e-2 pushes every hidden unit's pre-activation below 0
within some 30 steps; softplus(100 h) / 100 then passes almost nothing,
and the distance is the last layer's bias. 40 steps with JAX's draws on
the refiner's default field (brick + analytic), run by both packages'
``refine`` (steps, Adam, the learning-rate schedule, the guard, the
readback): the same constant map and the same normals (the hash + ``ad``
and brick + ``fd`` variants collapse alike when run so, to the same
distances and normals within 2e-6; JAX's XLA compiles of their steps would
take this file past a minute on one core). ``test_torch_refiner.py`` and
``test_torch_refiner_hash.py`` hold the steps of all three variants
before the collapse.
"""

import numpy as np

from perf_tpu.priors.pano_refiner import PanoGeoRefiner as JRefiner

from perf_tpu_torch.priors import PanoGeoRefiner

from test_torch_anchor import one_thread  # noqa: F401
from test_torch_refiner import (H, W, JaxRefinerDraws, _configs,  # noqa: F401
                                maps)


def test_both_packages_collapse_alike(maps):
    jcfg, cfg = _configs("brick_analytic", n_iters=40)
    jdist, jnormal = JRefiner(jcfg, seed=5).refine(*maps)
    jdist, jnormal = np.asarray(jdist), np.asarray(jnormal)
    dist, normal = PanoGeoRefiner(
        cfg, device="cpu", draws=JaxRefinerDraws(5, jcfg.field)).refine(*maps)
    assert dist.shape == (H, W, 1) and normal.shape == (H, W, 3)
    np.testing.assert_allclose(dist.numpy(), jdist, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(normal.numpy(), jnormal, atol=1e-5)
    # the collapse: a constant map where the room spans 0.58 to 1.0
    gt = maps[0]
    assert gt.max() - gt.min() > 0.3
    assert np.ptp(jdist) < 1e-4 and np.ptp(dist.numpy()) < 1e-4
