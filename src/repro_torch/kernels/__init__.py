"""Actor-path kernels: hand-written CUDA (``csrc/``) and plain versions.

Nothing here builds or imports a compiler at import time; the CUDA
library is built by ``_build.load`` on the first launch.
"""
