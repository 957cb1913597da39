"""Icosahedral tangent-camera factory (NumPy).

A copy of ``perf_tpu/core/tangent.py:24-128`` (the port imports nothing of
the JAX package): the sphere split into 20 perspective "tangent" views, one
per icosahedron face, for the per-view priors and the perspective
inpainting; the optional extra yaw is passed explicitly (the caller owns
randomness).

Geometry: the icosahedron with vertices at the cyclic permutations of
(0, +-1, +-phi)/sqrt(1+phi^2) is rotated about x by arctan(1/phi) so that every
face has exactly two vertices at equal z; the tangent plane through each face
center is sampled on a square grid whose half extent is
|center - corner| * ratio.
"""

from __future__ import annotations

import numpy as np

_PHI = (1.0 + np.sqrt(5.0)) / 2.0


def icosahedron():
    """Unit icosahedron (12 verts, 20 faces), rotated for same-z face pairs."""
    s = 1.0 / np.sqrt(1.0 + _PHI * _PHI)
    a, b = s, _PHI * s
    verts = np.array([
        [-a, b, 0], [a, b, 0], [-a, -b, 0], [a, -b, 0],
        [0, -a, b], [0, a, b], [0, -a, -b], [0, a, -b],
        [b, 0, -a], [b, 0, a], [-b, 0, -a], [-b, 0, a],
    ], dtype=np.float64)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], dtype=np.int64)
    # Rotate about x by arctan(a/b) so horizontal vertex rings share z
    # (mirrors the reference's rotation at geo_utils.py:117-121).
    ang = np.arctan2(a, b)
    ca, sa = np.cos(ang), np.sin(ang)
    rot = np.array([[1, 0, 0], [0, ca, -sa], [0, sa, ca]])
    return (verts @ rot.T).astype(np.float32), faces


def _face_camera(pa, pb, pc, ratio):
    """One tangent camera from a face. Returns (base, down, right, to_vec)."""
    # pa must be the "sole" vertex: the one not sharing z with another.
    dz_ab, dz_bc, dz_ac = abs(pa[2] - pb[2]), abs(pb[2] - pc[2]), abs(pa[2] - pc[2])
    pairs = [(dz_bc, (pa, pb, pc)), (dz_ac, (pb, pa, pc)), (dz_ab, (pc, pa, pb))]
    _, (pa, pb, pc) = min(pairs, key=lambda t: t[0])
    # Orient b->c so that right = c - b points "rightward" (cross(c,b).z >= 0).
    if np.cross(pc, pb)[2] < 0.0:
        pb, pc = pc, pb

    pm = (pb + pc) * 0.5
    down = pa - pm
    if down[2] > 0.0:
        down = -down
    center = (pa + pb + pc) / 3.0
    right = pc - pb

    half_len = np.linalg.norm(center - pb) * ratio
    right = right / np.linalg.norm(right) * half_len
    down = down / np.linalg.norm(down) * half_len
    base = center - right - down
    return base, down * 2.0, right * 2.0, center


def tangent_cameras(gen_res: int = 512, ratio: float = 1.0, yaw: float = 0.0):
    """Direction grids + frame vectors for the 20 tangent views.

    Returns (dirs [20, r, r, 3] unit, pers_ratios [20, r, r, 1],
    to_vecs [20, 3], down_vecs [20, 3], right_vecs [20, 3]) as float32 numpy.
    ``down_vecs``/``right_vecs`` are HALF-extent plane vectors and ``to_vecs``
    points to the plane center, matching the reference's return contract
    (``geo_utils.py:65``, the ``* .5`` halving).

    ``yaw`` rotates the whole rig about z (the reference's ``ex_rot='rand'``,
    ``geo_utils.py:150-159``) — pass e.g. ``rng.uniform(0, 2*pi)``.
    """
    verts, faces = icosahedron()
    grid = (np.arange(gen_res, dtype=np.float32) + 0.5) / gen_res
    ii, jj = np.meshgrid(grid, grid, indexing="ij")

    all_dirs, all_ratios, tos, downs, rights = [], [], [], [], []
    for f in faces:
        base, down, right, to_vec = _face_camera(verts[f[0]], verts[f[1]], verts[f[2]], ratio)
        dirs = (base[None, None] + down[None, None] * ii[..., None]
                + right[None, None] * jj[..., None])
        norms = np.linalg.norm(dirs, axis=-1, keepdims=True)
        all_ratios.append(norms / np.linalg.norm(to_vec))
        all_dirs.append(dirs / norms)
        tos.append(to_vec)
        downs.append(down * 0.5)
        rights.append(right * 0.5)

    dirs = np.stack(all_dirs).astype(np.float32)
    ratios = np.stack(all_ratios).astype(np.float32)
    tos = np.stack(tos).astype(np.float32)
    downs = np.stack(downs).astype(np.float32)
    rights = np.stack(rights).astype(np.float32)

    if yaw != 0.0:
        c, s = np.cos(yaw), np.sin(yaw)
        rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=np.float32)
        dirs = dirs @ rot.T
        tos = tos @ rot.T
        downs = downs @ rot.T
        rights = rights @ rot.T

    return dirs, ratios, tos, downs, rights


def tangent_c2w(to_vecs: np.ndarray, down_vecs: np.ndarray, right_vecs: np.ndarray):
    """c2w rotations + fovs for tangent cameras (ref ``geo_utils.py:165-186``).

    Returns (c2w [n, 3, 3], fovy [n], fovx [n]).
    """
    dl = np.linalg.norm(down_vecs, axis=-1, keepdims=True)
    rl = np.linalg.norm(right_vecs, axis=-1, keepdims=True)
    tl = np.linalg.norm(to_vecs, axis=-1, keepdims=True)
    fovy = 2.0 * np.arctan(dl[..., 0] / tl[..., 0])
    fovx = 2.0 * np.arctan(rl[..., 0] / tl[..., 0])
    w2c = np.stack([right_vecs / rl, down_vecs / dl, to_vecs / tl], axis=1)
    c2w = np.transpose(w2c, (0, 2, 1))  # rows are orthonormal -> inverse = transpose
    return c2w.astype(np.float32), fovy.astype(np.float32), fovx.astype(np.float32)
