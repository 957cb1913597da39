from .mlp import (ngp_mlp_init, ngp_mlp_apply, ngp_mlp_apply_channels,
                  vanilla_mlp_init, vanilla_mlp_apply, vanilla_weights)
from .ngp import (
    NGPFieldConfig, TruncExp, trunc_exp, init_ngp_params, init_geo_params,
    init_app_params, reset_geo, normalize_coords, query_density_coords,
    query_rgb_coords, query_density_ray, query_rgb_ray, field_eval,
    field_eval_plain, NGPDensityFieldConfig, init_density_field,
    query_density_field,
)
from .sphere_field import (
    SphereFieldConfig, init_sphere_field, sphere_field_distance,
    sphere_field_distance_and_grad, grads_to_normal,
)
