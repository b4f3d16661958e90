"""PyTorch/CUDA port of MoCoPCI for one NVIDIA H100 (eval, and the train step
on one device: ``mocopci_torch.training``).

The JAX package ``mocopci_tpu`` is the reference; this package imports nothing
of it.  Every Pallas kernel on those paths has a hand-written CUDA kernel in
``csrc/`` with a plain PyTorch twin beside its wrapper in ``kernels/``.

    from mocopci_torch import MoCoPCI, ModelConfig, interpolate
    model = MoCoPCI(ModelConfig())            # on the card
    frames = interpolate(model, xyz1, xyz2)   # (B, 3, N, 3)
"""
from mocopci_torch.config import ModelConfig, timestamps, tiny_model_config
from mocopci_torch.models import MoCoPCI, interpolate

__all__ = ["ModelConfig", "MoCoPCI", "interpolate", "timestamps", "tiny_model_config"]
