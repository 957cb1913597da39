"""PanoPersFusionInpainter: progressive per-tangent-view pano inpainting.

Counterpart of ``perf_tpu/inpaint/pano_fusion.py:33-92``: for each of the
20 tangent views (``gen_res``, ratio 1.1) in sequence (later views see
earlier results): resample the pano and its hole mask into the view, fill
the view's hole with the inpainter, reproject the view into the pano
through the view's frustum mask and clear the hole there. Every resample
is ``bilinear_sample`` (the ``bilinear`` kernel on the card). The JAX
package's second, refining inpainter (Stable Diffusion on the opened
sub-hole) is not ported.
"""

from __future__ import annotations

import torch

from ..core import (bilinear_sample, direction_to_img_coord,
                    direction_to_pers_img_coord, img_coord_from_hw,
                    img_coord_to_pano_direction, pano_sample, tangent_cameras)
from .interface import Inpainter


class PanoPersFusionInpainter(Inpainter):
    def __init__(self, inpainter, gen_res: int = 512, ratio: float = 1.1):
        self.inpainter = inpainter
        self.gen_res = gen_res
        self.ratio = ratio
        dirs, _, tos, downs, rights = tangent_cameras(gen_res, ratio)
        self._dirs = torch.from_numpy(dirs)
        self._tos, self._downs, self._rights = (
            torch.from_numpy(a) for a in (tos, downs, rights))

    def inpaint(self, img, mask):
        dev = img.device
        h, w = img.shape[0], img.shape[1]
        mask = mask.reshape(h, w, -1)[..., :1].to(torch.float32)
        pano = img
        pano_dirs = img_coord_to_pano_direction(img_coord_from_hw(
            h, w, device=dev))
        view_coords = direction_to_img_coord(self._dirs.to(dev))
        for i in range(self._dirs.shape[0]):
            view_img = pano_sample(pano, view_coords[i])
            view_mask = (pano_sample(mask, view_coords[i]) > 0.5).to(
                torch.float32)
            if float(view_mask.max()) > 0.5:
                view_img = self.inpainter.inpaint(view_img, view_mask)
            proj_coord, proj_mask = direction_to_pers_img_coord(
                pano_dirs, self._tos[i].to(dev), self._downs[i].to(dev),
                self._rights[i].to(dev))
            view_in_pano = bilinear_sample(view_img, proj_coord, "border")
            pano = pano * (1.0 - proj_mask) + view_in_pano * proj_mask
            mask = mask * (1.0 - proj_mask)
        return pano

    def inpaint_rgbd(self, img, distance, mask):
        out = self.inpaint(img, mask)
        d3 = distance.reshape(out.shape[0], out.shape[1], 1).repeat(1, 1, 3)
        return out, self.inpaint(d3, mask)[..., :1]
