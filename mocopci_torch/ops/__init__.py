"""Point-cloud ops of the port (distances, kNN, FPS, gathers, interpolation,
Chamfer and EMD)."""
from mocopci_torch.ops.chamfer import (
    chamfer_distance,
    chamfer_distance_blocked,
    chamfer_distance_per_sample,
    chamfer_many,
)
from mocopci_torch.ops.distance import (
    cosine_distance,
    knn,
    knn_cosine,
    set_knn_mode,
    square_distance,
)
from mocopci_torch.ops.emd import (
    approx_match,
    earth_mover_distance,
    earth_mover_distance_auto,
    earth_mover_distance_blocked,
    emd,
    match_cost,
)
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
    "chamfer_distance", "chamfer_distance_blocked", "chamfer_distance_per_sample",
    "chamfer_many",
    "cosine_distance", "knn", "knn_cosine", "set_knn_mode", "square_distance",
    "approx_match", "earth_mover_distance", "earth_mover_distance_auto",
    "earth_mover_distance_blocked", "emd", "match_cost",
    "point_warp", "three_interpolate", "three_nn", "upsample", "upsample_multi",
    "farthest_point_sample", "farthest_point_sample_pyramid",
    "gather", "group", "group_multi",
]
