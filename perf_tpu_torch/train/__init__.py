from .checkpoint import save_checkpoint, load_checkpoint
from .schedule import OptimConfig, lr_at, smooth_l1
from .sup_pool import PanoSupInfo, SupInfoPool, build_pano_sup_info
from .scene import NeRFScene, TrainConfig
from .prop_scene import PropNeRFScene
