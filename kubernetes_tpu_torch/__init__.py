"""kubernetes_tpu_torch — the scheduler's device backend on PyTorch and CUDA.

A port of `kubernetes_tpu` (JAX) to one NVIDIA H100. The node matrix lives
on the card as int64 tensors and the filter/score/select programs run as
hand-written CUDA kernels (`ops/csrc/`), each beside a plain PyTorch version
of the same function. The package imports neither jax nor `kubernetes_tpu`:
the host layers it needs are copied here, so a decision made by the port
can be held against the JAX package bit for bit.

Layout (mirrors `kubernetes_tpu`):
  scheduler.py  the scheduler shell: store -> informers -> queue ->
           TorchScheduler -> bind
  api/     Pod/Node data model
  store/   the versioned store, its commit core, informers, event recorder
  queue/   the scheduling queue
  cache/   the scheduler cache, NodeInfo aggregates, the NodeTree
  oracle/  the host predicates, priorities, generic scheduler, preemption
           and gang referee
  ops/     node/pod encoders, kernels and their plain versions
  core/    TorchScheduler, the burst and serial driver, and its breaker
  parallel/ node-axis sharding over a mesh of devices (K9a-d)
  chaos/   the seeded fault-injection plane
  coscheduling/, framework/, utils/  PodGroup, the plugin framework,
           clock, heap and step tracing
  carry.py loads a JAX scheduler's resident state into a TorchScheduler
  obs/     plain integer counters, metric families, the pod ledger
"""

__version__ = "0.1.0"
