"""Port vs ``perf_tpu``: the joint predictor's distillation on the sphere
field's reference-parity variant (hash + ``ad``, the published PeRF's
``SphereDistanceField``).

One distillation step of each phase with JAX's own draws against
``jax.value_and_grad`` of JAX's loss, in which the distance's direction
gradient is differentiated again (second order; the port's is forward
mode, first-order autograd). CPU tensors: the ``bilinear`` and
``hash_encode_grad`` wrappers take their plain versions. A 2-level grid:
XLA's CPU compile of the second-order step grows with every level. The
golden bar with this field is in ``test_torch_sphere_golden.py``.
"""

from perf_tpu.fields.sphere_field import SphereFieldConfig as JSphere

from perf_tpu_torch.fields import SphereFieldConfig

from test_torch_anchor import one_thread, room  # noqa: F401
from test_torch_joint import check_distill_steps


def test_distill_step_hash_ad_matches_jax(room):
    """One distillation step of each phase with JAX's draws on the
    reference-parity field (hash + ad; second order in JAX) against
    jax.value_and_grad; the three Adam groups against optax."""
    # res 16 and 32: level 0 dense (17^3 corners in 8192 rows), level 1
    # hashed
    kw = dict(n_levels=2, log2_table_size=13, fine_res=32, encoding="hash",
              grad_mode="ad")
    check_distill_steps(JSphere(**kw), SphereFieldConfig(**kw), room)
