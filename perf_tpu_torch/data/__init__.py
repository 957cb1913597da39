from .dataset import Dataset, WildDataset
