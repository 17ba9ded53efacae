"""txr_torch: the PyTorch / CUDA port of the txr reconstruction framework.

The package mirrors ``txr``'s layout module for module (``core``, ``ops``,
``models``, ``fusion``, ``geometry``, ``io``, ``pipelines``, ``ros2``,
``utils``, ``_native``) and
imports ``torch``, ``numpy`` and the standard library only (OpenCV and
safetensors at first use where a host path needs them, Plotly at first use
in ``utils``; rclpy, optional, in ``ros2``). Entry points
run on a CUDA device unless the caller passes ``device="cpu"``; the
hand-written Hopper kernels under ``csrc/`` are built at first CUDA use (see
``txr_torch._cuda``) and the native host library at first host I/O (see
``txr_torch._native``), never at import.
"""

from txr_torch.core.device import resolve_device
from txr_torch.core.intrinsics import CameraIntrinsics
from txr_torch.core.types import PointSet, concatenate

__version__ = "0.1.0"

__all__ = ["CameraIntrinsics", "PointSet", "concatenate", "resolve_device"]
