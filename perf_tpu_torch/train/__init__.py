from .checkpoint import save_checkpoint, load_checkpoint
from .scene import NeRFScene
