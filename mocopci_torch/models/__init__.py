from mocopci_torch.models.mocopci import (
    MoCoPCI,
    MultiFrameEstimator,
    MultiframeAttention,
    PointConvEncoder,
    area_resize_matrix,
    interpolate,
    time_embedding,
)

__all__ = [
    "MoCoPCI", "MultiFrameEstimator", "MultiframeAttention", "PointConvEncoder",
    "area_resize_matrix", "interpolate", "time_embedding",
]
