"""The input panorama and its cached reference geometry.

Counterpart of ``perf_tpu/data/dataset.py:66-123`` (``WildDataset``): the
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

from ..core import img_coord_from_hw, img_coord_to_pano_direction
from ..utils.io import read_image, write_ply


class WildDataset:
    def __init__(self, conf, joint_predictor=None):
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
