from .brickgrid import (
    BrickGridConfig, brick_index, axis_split, brick_encode, brick_encode_ray,
)
from .hashgrid import (
    HashGridConfig, init_hash_table, hash_encode, hash_encode_coords,
    hash_encode_ray, level_strides,
)
