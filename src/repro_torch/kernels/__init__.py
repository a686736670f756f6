"""Hand-written Hopper kernels of the port, each with its plain PyTorch
version.  ``l2_topk`` replaces the reference's Pallas ``l2_topk_pallas``,
``flash_attention`` its ``flash_attention_pallas``."""
from . import flash_attention, l2_topk
