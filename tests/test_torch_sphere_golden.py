"""The joint predictor's golden bar (``tests/test_priors.py:43``) through
the port with the sphere field's reference-parity variant (hash + ``ad``,
the published PeRF's ``SphereDistanceField``). CPU tensors: the
``bilinear`` and ``hash_encode_grad`` wrappers take their plain versions.
"""

import numpy as np
import torch

from perf_tpu_torch.fields import SphereFieldConfig
from perf_tpu_torch.priors import (FakeCubeRoomDepthPredictor,
                                   FakeCubeRoomNormalPredictor,
                                   JointPredictorConfig, PanoJointPredictor)

from test_torch_anchor import H, W, _t, one_thread, room  # noqa: F401

# the joint predictor's golden-bar field (tests/test_priors.py:18-22): 6
# levels from 16 to 128 in 4096 rows, every level hashed
SPHERE = dict(n_levels=6, log2_table_size=12, fine_res=128)


def test_joint_predictor_recovers_the_room_hash_ad(room):
    """``tests/test_priors.py:43``'s golden bar with the reference-parity
    field: 200 + 200 distillation steps from the fake priors, median
    relative distance error < 0.15, unit normals."""
    cfg = JointPredictorConfig(gen_res=32, ratios=(1.1,), local_batch=64,
                               iters_per_phase=200, normal_bias_res=16,
                               scan_chunk=50,
                               field=SphereFieldConfig(
                                   **SPHERE, encoding="hash", grad_mode="ad"))
    pred = PanoJointPredictor(FakeCubeRoomDepthPredictor(),
                              FakeCubeRoomNormalPredictor(), cfg)
    dist, normal = pred(_t(room["rgb"]), torch.ones(H, W, 1),
                        torch.ones(H, W))
    gt = room["distance"]
    dn = dist.numpy()
    rel = np.abs(dn / dn.mean() - gt / gt.mean()) / (gt / gt.mean())
    assert np.median(rel) < 0.15, np.median(rel)
    np.testing.assert_allclose(np.linalg.norm(normal.numpy(), axis=-1), 1.0,
                               atol=1e-4)
