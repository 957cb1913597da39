from .interface import DepthPredictor, NormalPredictor
from .fake import FakeCubeRoomDepthPredictor, FakeCubeRoomNormalPredictor
from .pano_joint import JointPredictorConfig, PanoJointPredictor, TorchDraws
