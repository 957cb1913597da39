"""Port vs ``perf_tpu``: the NGP hash field's snapshot bake
(``scene.field.kind: hash``) against JAX's ``bake_snapshot`` on the same
carried parameters and occupancy, as ``test_torch_snapshot.py`` holds the
brick field's. On its own because XLA's CPU compile of JAX's hash bake
(~15 s on one core) would take ``test_torch_hashgrid.py`` past a minute.
CPU tensors: the hash encode wrapper takes its plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from perf_tpu.render.snapshot import SnapshotConfig as JSnap
from perf_tpu.render.snapshot import bake_snapshot as j_bake

from perf_tpu_torch.convert import field_params_from_jax
from perf_tpu_torch.render import SnapshotConfig
from perf_tpu_torch.render.snapshot import bake_corners, bake_snapshot
from perf_tpu_torch.utils import random_field_params

from test_torch_common import (SNAP, assert_close_up_to_bf16_ties,
                               cube_room_occ, hash_fields)

JFIELD, TFIELD = hash_fields()


def test_hash_field_bake_matches_jax():
    """The snapshot bake of the hash field on carried parameters against
    JAX's ``bake_snapshot``: the occupied corner set (integers) and the
    table's support exactly; the bf16 table within one bf16 ulp (2^-7
    relative) of JAX's except at bf16 rounding ties of the heads' hidden
    units (a bounded share, a few percent at most)."""
    p, occ = random_field_params(2, TFIELD, density_gain=0.9), cube_room_occ()
    js, ts = JSnap(**SNAP), SnapshotConfig(**SNAP)
    tab_j = np.array(j_bake(jax.tree_util.tree_map(jnp.asarray, p), JFIELD,
                            jnp.asarray(occ), 64, js).astype(jnp.float32))
    tab_t = bake_snapshot(field_params_from_jax(p, TFIELD), TFIELD,
                          torch.from_numpy(occ), 64, ts).float().numpy()
    g = jax.lax.reduce_window(jnp.asarray(occ).reshape(64, 64, 64),
                              np.uint8(0), jax.lax.max, (3, 3, 3),
                              (1, 1, 1), "SAME")
    vox = np.clip((np.arange(ts.res + 1, dtype=np.float32) / ts.res
                   * 64).astype(np.int32), 0, 63)
    m = np.asarray(g)[np.ix_(vox, vox, vox)].reshape(-1)
    idx = bake_corners(torch.from_numpy(occ), 64, ts.res).numpy()
    assert np.array_equal(idx, np.nonzero(m)[0])
    assert tab_t.shape == tab_j.shape
    assert np.array_equal(tab_t != 0, tab_j != 0)
    # measured: 1 of 254,112 entries differs, by one bf16 ulp
    assert_close_up_to_bf16_ties(tab_t, tab_j, 2.0 ** -7, 1e-3, 0.03)
