"""Inpainting interfaces.

Counterpart of ``perf_tpu/inpaint/interface.py``: images are channels-last
float [H, W, 3] in [0, 1]; masks [H, W] or [H, W, 1] with 1 = hole.
"""

from __future__ import annotations


class Inpainter:
    def inpaint(self, img, mask):
        """img [H, W, 3], mask [H, W(, 1)] (1 = hole) -> [H, W, 3]."""
        raise NotImplementedError

    def inpaint_rgbd(self, img, distance, mask):
        raise NotImplementedError
