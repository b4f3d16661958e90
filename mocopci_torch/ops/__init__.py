"""Point-cloud ops of the port (distances, kNN, FPS, gathers, interpolation)."""
from mocopci_torch.ops.distance import cosine_distance, knn, knn_cosine, square_distance
from mocopci_torch.ops.interpolate import (
    point_warp,
    three_interpolate,
    three_nn,
    upsample,
    upsample_multi,
)
from mocopci_torch.ops.sampling import (
    farthest_point_sample,
    farthest_point_sample_pyramid,
    gather,
    group,
    group_multi,
)

__all__ = [
    "cosine_distance", "knn", "knn_cosine", "square_distance",
    "point_warp", "three_interpolate", "three_nn", "upsample", "upsample_multi",
    "farthest_point_sample", "farthest_point_sample_pyramid",
    "gather", "group", "group_multi",
]
