"""kubernetes_tpu_torch — the scheduler's device backend on PyTorch and CUDA.

A port of `kubernetes_tpu` (JAX) to one NVIDIA H100. The node matrix lives
on the card as int64 tensors and the filter/score/select programs run as
hand-written CUDA kernels (`ops/csrc/`), each beside a plain PyTorch version
of the same function. The package imports neither jax nor `kubernetes_tpu`:
the host layers it needs are copied here, so a decision made by the port
can be held against the JAX package bit for bit.

Layout (mirrors `kubernetes_tpu`):
  api/     Pod/Node data model
  cache/   NodeInfo aggregates and the zone-interleaved NodeTree
  oracle/  the host predicates/priorities the encoders reach
  ops/     node/pod encoders, kernels and their plain versions
  core/    TorchScheduler, the burst and serial driver
  parallel/ node-axis sharding over a mesh of devices (K9a-d)
  carry.py loads a JAX scheduler's resident state into a TorchScheduler
  obs.py   plain integer counters
"""

__version__ = "0.1.0"
