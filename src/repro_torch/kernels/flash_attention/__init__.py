"""Forward flash attention: the Hopper kernel, its wrapper and its plain
versions.  ``ops.launches`` counts kernel launches."""
from . import ops
from .ops import flash_attention
from .ref import attention_ref, flash_attention_ref
