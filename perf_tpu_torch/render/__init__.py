from .occgrid import occ_grid_from_points
from .renderer import (
    RenderConfig, coarse_occ_grid, probe_points, count_occupied_windows,
    select_segments, fine_windows_from_segments, windows_to_samples,
    march_windows, march_windows_plain, march_rays, beam_dilation,
    frame_march_plan, top_k, shade_composite, shade_rays, render_rays,
    render_rays_bucketed, render_image, shade_rays_eval,
)
from .snapshot import (
    SnapshotConfig, snapshot_render_cfg, bake_snapshot, bake_scatter_pack,
    bake_scatter_pack_plain, composite_snapshot, composite_snapshot_plain,
    render_snapshot_image,
)
from .prop import (
    PropRenderConfig, render_rays_prop, prop_loss, sample_from_weights,
    weights_from_density,
)
