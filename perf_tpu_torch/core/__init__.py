from .rays import Rays
from .camera import (
    apply_rot, normalize, look_at, img_coord_from_hw, img_to_pano_coord,
    pano_to_img_coord, pano_coord_to_direction, img_coord_to_pano_direction,
    direction_to_pano_coord, direction_to_img_coord,
    direction_to_pers_img_coord, cam_rays_cam_space, gen_pano_rays,
    gen_pers_rays,
)
from .morphology import (laplacian3, erosion, dilation, edge_keep_mask,
                         ellipse_kernel, binary_open_close)
from .optim import GuardedAdam, all_finite
from .resample import bilinear_sample, pano_sample
from .tangent import icosahedron, tangent_cameras, tangent_c2w
