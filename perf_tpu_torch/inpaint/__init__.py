from .interface import Inpainter
from .fake import FakeInpainter, normalized_fill
from .pano_fusion import PanoPersFusionInpainter
