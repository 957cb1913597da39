"""Port vs ``perf_tpu``: one bucketed appearance step of the training loss
with run caps engaged (K12: the density and colour heads' encodes, the
colour head's at the window gather), against ``jax.value_and_grad`` on JAX's
own draws (``tests/test_torch_dedup_steps.py`` holds the geometry step).
"""

from test_torch_dedup import room  # noqa: F401
from test_torch_dedup_steps import check_dedup_step, field  # noqa: F401


def test_bucketed_dedup_app_step_matches_jax(room, field):  # noqa: F811
    check_dedup_step(room, field, "app")
