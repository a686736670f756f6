"""Hand-written Hopper kernels of the port, each with its plain PyTorch
version.  ``l2_topk`` replaces the reference's Pallas ``l2_topk_pallas``."""
from . import l2_topk
