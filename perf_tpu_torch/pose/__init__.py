from .circle import PoseSampler, CirclePoseSampler
from .dense_travel import DenseTravelPoseSampler
