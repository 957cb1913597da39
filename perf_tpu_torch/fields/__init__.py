from .mlp import ngp_mlp_init, ngp_mlp_apply_channels
from .ngp import (
    NGPFieldConfig, TruncExp, trunc_exp, init_ngp_params, normalize_coords,
    query_density_coords, query_rgb_coords, field_eval, field_eval_plain,
)
