from .mlp import (ngp_mlp_init, ngp_mlp_apply, ngp_mlp_apply_channels,
                  TruncExp, trunc_exp, NGPHead, GEO_HEAD, APP_HEAD, PROP_HEAD,
                  ngp_head_plain, ngp_head_bwd_plain, vanilla_mlp_init,
                  vanilla_mlp_apply, vanilla_weights)
from .ngp import (
    NGPFieldConfig, init_ngp_params, init_geo_params,
    init_app_params, reset_geo, normalize_coords, query_density_coords,
    query_rgb_coords, query_density_ray, query_rgb_ray, field_eval,
    field_eval_plain, NGPDensityFieldConfig, init_density_field,
    query_density_field,
)
from .sphere_field import (
    SphereFieldConfig, init_sphere_field, sphere_field_distance,
    sphere_field_distance_and_grad, grads_to_normal,
)
