"""Port vs ``perf_tpu``: the geometry refiner's steps and readback on the
reference-parity field (hash + ``ad``: second order in JAX, whose XLA
compile takes most of this file's time), as ``test_torch_refiner.py``
holds the brick variants."""

from test_torch_anchor import one_thread  # noqa: F401
from test_torch_refiner import check_refiner_steps, maps  # noqa: F401


def test_refiner_steps_hash_ad_match_jax(maps):
    check_refiner_steps("hash_ad", maps)
