"""repro_torch — the PyTorch / CUDA port of the authorized vector retrieval
system, for an NVIDIA H100.

Same subpackage layout as the JAX reference package ``repro``: each module
here is held against its twin at the same relative path.  The port imports
torch and numpy only.  Entry points run on the card (``device=None`` →
``cuda``) unless the caller passes ``device="cpu"``, where every kernel
wrapper takes its plain PyTorch version.

  core/     the access-aware lattice, plans, the store and its search paths
  ann/      node engines: ScoreScan on the device, exact scan on the host
  kernels/  hand-written Hopper kernels (``l2_topk``) with plain versions
  data/     synthetic retrieval data
  carry.py  builds port objects from another build's plain state
"""
