from .dataset import WildDataset
