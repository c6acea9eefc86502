"""kubernetes_tpu_torch.serve — arrival-driven serving.

Copied from the reference (`kubernetes_tpu.serve`) with the port's
imports; the windows run on the port's scheduler shell and its
TorchScheduler, on the card unless the shell was given `device="cpu"`.

Every drain bench before it meant "drain a pre-built backlog"; serving
heavy traffic means pods *arrive* — over the store's watches, through
informers, forever — and the scheduler must never idle the device OR let
an unbounded queue eat the startup SLO. This package turns the burst
pipeline into a serving system:

- `loop.ServeLoop` cuts drain windows from the LIVE activeQ on a cadence
  instead of draining to empty, reusing the shell's `schedule_burst` /
  `schedule_burst_fused` machinery unchanged, so per-window decisions
  keep the shell's parity with the serial oracle.
- `backpressure.BackpressureGate` is the explicit load-shedding contract:
  pod creates are checked against activeQ-depth / in-flight-window
  watermarks at the store's admission surface and shed with 429 +
  Retry-After (`store.BackpressureError`). Accepted creates stamp the
  lifecycle ledger's admission slot, so `pod_startup_seconds_p99` scores
  true accepted-create -> commit latency under arrival load.
- `arrivals.ArrivalGenerator` is the hollow arrival client: paced pod
  creation at a target rate against the Store, honoring 429 sheds
  exactly like a well-behaved client.

The N-deep launch queue lives in `core.torch_scheduler`
(TorchScheduler.launch_depth / launch_cap / inflight_launches): while
window k's decisions commit, windows k+1..k+N-1 are already encoded and
launched, each with its device-to-host copy started into its own pinned
slot, and a refused or failed window drops its in-flight successors
unfetched.
"""
from kubernetes_tpu_torch.serve.backpressure import (   # noqa: F401
    BackpressureGate, fleet_gate,
)
from kubernetes_tpu_torch.serve.loop import ServeLoop   # noqa: F401
from kubernetes_tpu_torch.serve.arrivals import (       # noqa: F401
    ArrivalGenerator, default_pod,
)
