from .interface import DepthPredictor, NormalPredictor
from .fake import FakeCubeRoomDepthPredictor, FakeCubeRoomNormalPredictor
from .pano_joint import JointPredictorConfig, PanoJointPredictor, TorchDraws
from .pano_fusion import (PanoFusionConfig, PanoFusionInvPredictor,
                          PanoFusionNormalPredictor)
from .pano_refiner import PanoGeoRefiner, RefinerConfig
