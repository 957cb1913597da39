from .brickgrid import (
    BrickGridConfig, brick_index, axis_split, brick_encode, brick_encode_ray,
)
