"""The input panorama and its cached reference geometry.

Counterpart of ``perf_tpu/data/dataset.py:21-123``. ``Dataset`` holds the
non-Wild geometry paths (``:34-63``), each with its predictor injected:
``get_ref_distance`` (the ``*_ref_distance.npy`` cache, else a
``PanoFusionInvPredictor`` with every pixel free), ``get_ref_normal`` (the
normal cache, else a ``PanoFusionNormalPredictor`` from 1/sqrt(3)) and
``refine_geometry`` (a ``PanoGeoRefiner``). ``WildDataset`` (``:66-123``):
the
image is read; its geometry comes from the ``*_ref_distance.npy`` /
``*_ref_normal.npy`` caches beside it or, when they are missing, is
bootstrapped by the joint predictor (``joint_predictor(image, ones,
ones)``: every pixel free, no reference distance); the distances are
scaled so that their maximum is 1/1.05, and the normalised geometry is
written back with the ``*_ref_geometry.ply`` point cloud, as the JAX
package does. The image must already have the configured
``image_resize``: ``INTER_AREA`` resizing is not ported.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core import img_coord_from_hw, img_coord_to_pano_direction
from ..utils.io import read_image, write_ply


class Dataset:
    def __init__(self):
        self.image_path = None
        self.ref_distance_path = None
        self.ref_normal_path = None
        self.ref_geometry_path = None
        self.image = None
        self.ref_distance = None
        self.ref_normal = None
        self.height = 0
        self.width = 0
        self.case_name = "wp"

    def get_ref_distance(self, distance_predictor) -> torch.Tensor:
        """The cached distance map when ``ref_distance_path`` exists (the
        predictor is then not called), else the fusion predictor's [H, W]
        with every pixel free, on the predictor's device."""
        if self.ref_distance_path and os.path.exists(self.ref_distance_path):
            return torch.from_numpy(np.load(self.ref_distance_path).astype(
                np.float32))
        h, w, dev = self.height, self.width, distance_predictor.device
        dist, _ = distance_predictor(self.image,
                                     torch.zeros((h, w), device=dev),
                                     torch.ones((h, w), device=dev))
        return dist

    def get_ref_normal(self, normal_predictor) -> torch.Tensor:
        """The cached normal map, else the normal fusion predictor's [H, W,
        3] from 1/sqrt(3) with every pixel free, on the predictor's
        device."""
        if self.ref_normal_path and os.path.exists(self.ref_normal_path):
            return torch.from_numpy(np.load(self.ref_normal_path).astype(
                np.float32))
        h, w, dev = self.height, self.width, normal_predictor.device
        init = torch.full((h, w, 3), float(1.0 / np.sqrt(3.0)), device=dev)
        return normal_predictor.inpaint_normal(
            self.image, init, torch.ones((h, w), device=dev))

    def refine_geometry(self, distance_map, normal_map, refiner):
        """(distance [H, W, 1], normal [H, W, 3]) of the maps distilled
        through the sphere field of ``refiner`` (a ``PanoGeoRefiner``)."""
        return refiner.refine(distance_map, normal_map)


class WildDataset(Dataset):
    def __init__(self, conf, joint_predictor=None):
        super().__init__()
        self.image_path = str(conf["image_path"])
        stem = ".".join(self.image_path.split(".")[:-1])
        self.ref_distance_path = stem + "_ref_distance.npy"
        self.ref_normal_path = stem + "_ref_normal.npy"
        self.ref_geometry_path = stem + "_ref_geometry.ply"
        self.case_name = (self.image_path.split("/")[-2]
                          if "/" in self.image_path else "wp")

        img = read_image(self.image_path)
        self.height, self.width = img.shape[:2]
        resize = conf.get("image_resize")
        if resize and (int(resize[0]), int(resize[1])) != (self.width,
                                                            self.height):
            raise ValueError(
                f"image is {self.width}x{self.height}, image_resize is "
                f"{resize[0]}x{resize[1]}: resizing is not ported; supply "
                "the image at the configured size")
        self.image = img

        if all(os.path.exists(p) for p in (self.ref_distance_path,
                                           self.ref_normal_path)):
            self.ref_distance = np.load(self.ref_distance_path).astype(
                np.float32)
            self.ref_normal = np.load(self.ref_normal_path).astype(np.float32)
        elif joint_predictor is None:
            raise FileNotFoundError(
                f"no cached reference geometry beside {self.image_path} and "
                "no joint predictor to bootstrap it")
        else:
            h, w = self.height, self.width
            dist, normal = joint_predictor(img, np.ones((h, w, 1), np.float32),
                                           np.ones((h, w), np.float32))
            self.ref_distance = dist.cpu().numpy()
            self.ref_normal = normal.cpu().numpy()
        self.normalization()
        self.save_ref_geometry()

    def normalization(self):
        scale = float(np.max(self.ref_distance)) * 1.05
        self.ref_distance = self.ref_distance / np.float32(scale)

    def ref_point_cloud(self) -> np.ndarray:
        dirs = img_coord_to_pano_direction(
            img_coord_from_hw(self.height, self.width)).numpy()
        return dirs * self.ref_distance.reshape(self.height, self.width, 1)

    def save_ref_geometry(self):
        np.save(self.ref_distance_path, self.ref_distance)
        np.save(self.ref_normal_path, self.ref_normal)
        write_ply(self.ref_geometry_path, self.ref_point_cloud(), self.image)
