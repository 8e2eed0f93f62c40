from .pipeline import SyntheticTextDataset, batches, make_train_batch

__all__ = ["SyntheticTextDataset", "batches", "make_train_batch"]
