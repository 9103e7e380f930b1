"""PyTorch/CUDA port of the 3GPP NR LDPC simulation framework.

Sits beside the JAX package ``ldpc_3gpp_tpu`` (the reference) with the same
directory layout and function names, so the counterpart of a module is found
by path.  Imports ``torch`` and numpy only; nothing of JAX or of the JAX
package.  Entry points run on a CUDA device unless the caller asks for the
CPU (``device="cpu"`` / CPU tensors).
"""
from .spec.params import LDPCParams
from .spec.tables import UnsupportedParameters

__all__ = ["LDPCParams", "UnsupportedParameters"]

__version__ = "0.1.0"
