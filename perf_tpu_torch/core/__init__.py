from .rays import Rays
from .camera import (
    apply_rot, normalize, img_coord_from_hw, img_to_pano_coord,
    pano_coord_to_direction, img_coord_to_pano_direction,
    cam_rays_cam_space, gen_pano_rays, gen_pers_rays,
)
from .morphology import laplacian3, erosion, dilation, edge_keep_mask
from .optim import GuardedAdam, all_finite
