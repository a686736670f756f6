"""Authorized L2 top-k scan: the Hopper kernel, its wrapper and its plain
version.  ``ops.launches`` counts kernel launches."""
from . import ops
from .ops import L2TopKConfig, l2_topk, l2_topk_words
from .ref import l2_topk_ref, l2_topk_words_ref
