"""srbd_nmpc_tpu_torch — the SRBD NMPC engine in PyTorch, for one NVIDIA H100.

Port of the batched NMPC solves of the JAX package ``srbd_nmpc_tpu`` (the
reference it is held against). Module names mirror the JAX package so each
counterpart is easy to find; the main ones:

- ``models.srbd``        : model constants, ``SRBDParams``, constraint rows
- ``models.srbd_planes`` : SRBD linearization as entry-wise stage-plane algebra
- ``ops.smallmat``       : [n, m, B] small-matrix k-loops (batch last)
- ``ops.sqp_planes``     : one fused SQP trip (plain PyTorch + CUDA kernel K1)
- ``ops.sqp_kernel``     : the dense fused SQP trips and the two-pass solve
  (plain + CUDA kernels K3a, K3b, K4)
- ``ops.permute``        : sorted lane gather/scatter (plain + CUDA kernel K2)
- ``nmpc.engine``        : speculative SQP solve with straggler compaction,
  and the iteration-synchronous loop with its QP routes
- ``parallel.sharded``   : ``solve_batch`` and its batch summary (one device)
- ``nmpc.runner``        : CLI / control-loop benchmark
- ``convert``            : parameters carried across from the JAX package

The package imports ``torch`` and ``numpy`` only; CUDA kernels are built
from ``csrc/`` by ``utils.build`` at their first launch.
"""

__version__ = "0.1.0"
