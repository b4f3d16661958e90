from mocopci_torch.data.synthetic import SyntheticInterpolationDataset

__all__ = ["SyntheticInterpolationDataset"]
