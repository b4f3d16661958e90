"""Network modules of the port (eval branches), channels-last."""
from mocopci_torch.nn.attention import (
    CrossAttention,
    CrossFrameBlock,
    EICrossformer,
    Extractor,
    Injector,
    MultiFrameBlock,
)
from mocopci_torch.nn.basic import (
    ConvLReLU,
    Dense,
    EasyMlp,
    FrameBatchNorm,
    Mlp,
    MlpT,
    PReLU,
    WeightNet,
    init_weights,
)
from mocopci_torch.nn.cross import (
    BidirectionalLayerFeatCosine,
    CrossLayerFeatCosine,
    FlowEmbeddingLayer,
)
from mocopci_torch.nn.pointconv import PointConv, PointConvD
from mocopci_torch.nn.transformer import PointTransformerBlock

__all__ = [
    "CrossAttention", "CrossFrameBlock", "EICrossformer", "Extractor", "Injector",
    "MultiFrameBlock", "ConvLReLU", "Dense", "EasyMlp", "FrameBatchNorm",
    "Mlp", "MlpT", "PReLU", "WeightNet", "init_weights",
    "BidirectionalLayerFeatCosine", "CrossLayerFeatCosine", "FlowEmbeddingLayer",
    "PointConv", "PointConvD", "PointTransformerBlock",
]
