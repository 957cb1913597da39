from .brickgrid import (
    BrickGridConfig, brick_index, axis_split, lane_axes, interp_from_rows,
    encode_brick_level, brick_encode,
)
