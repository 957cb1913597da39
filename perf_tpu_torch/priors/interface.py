"""Prior-model interfaces: monocular depth and surface normals.

Counterpart of ``perf_tpu/priors/interface.py``: predictors are batched
over the view axis. Images are [n, h, w, 3] in [0, 1]; depth is
[n, h, w, 1] >= 0 (scale free, callers normalise per view); normals are
[n, h, w, 3] in [0, 1] in camera space. The fake backends also take the
views' geometry (``dirs``, ``origin``, ``c2w``); real backends ignore it.
"""

from __future__ import annotations


class DepthPredictor:
    def predict_depth(self, imgs, intri=None, dirs=None, origin=None):
        raise NotImplementedError


class NormalPredictor:
    def predict_normal(self, imgs, dirs=None, origin=None, c2w=None):
        raise NotImplementedError
