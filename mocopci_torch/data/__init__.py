from mocopci_torch.data.nldrive import NLDriveDataset, batches
from mocopci_torch.data.synthetic import SyntheticInterpolationDataset

__all__ = ["NLDriveDataset", "SyntheticInterpolationDataset", "batches"]
