"""b_alexnet [convnet] -- the paper's own architecture (B-AlexNet, CIFAR-10)."""
from repro_torch.models.convnet import B_ALEXNET

CONFIG = B_ALEXNET
SMOKE = B_ALEXNET  # already CPU-scale
