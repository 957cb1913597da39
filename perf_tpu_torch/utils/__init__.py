from .synthetic import (
    cube_room_hit, cube_room_color, render_cube_room_pano, cube_room_occ_grid,
    random_field_params,
)
from .io import (png_bytes, decode_png, colorize_single_channel_image,
                 read_image, write_image, write_ply)
