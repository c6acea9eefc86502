"""Plugin framework: registry, extension points, cycle context, waiting pods.

Mirrors pkg/scheduler/framework/v1alpha1/:
- Status/Code (interface.go:31-91)
- extension points of this API version: QueueSort (:123), Reserve (:135),
  Prebind (:144), Unreserve (:155), Permit (:164 — wait with timeout)
- Framework assembly from a Registry (framework.go:52: instantiate every
  registered plugin, type-assert into per-point slices)
- PluginContext (context.go:39): cycle-scoped KV store
- waitingPodsMap (waiting_pods_map.go:27)

Plus the Filter/Score points the north star assumes (added in later
reference versions; here they bridge to the predicate/priority tables and
the TPU kernels).

Copied from the reference with the port's imports:
`kubernetes_tpu.framework.v1alpha1`.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Optional

# -- Status codes (interface.go:41-57) ---------------------------------------
SUCCESS = 0
ERROR = 1
UNSCHEDULABLE = 2
WAIT = 3


class Status:
    def __init__(self, code: int = SUCCESS, message: str = ""):
        self.code = code
        self.message = message

    @staticmethod
    def success() -> "Status":
        return Status(SUCCESS)

    def is_success(self) -> bool:
        return self.code == SUCCESS

    def __repr__(self):
        names = {SUCCESS: "Success", ERROR: "Error",
                 UNSCHEDULABLE: "Unschedulable", WAIT: "Wait"}
        return f"Status({names.get(self.code, self.code)}, {self.message!r})"


class PluginContext:
    """Cycle-scoped thread-safe KV store (context.go:39)."""

    def __init__(self):
        self._data: dict[str, Any] = {}
        self._lock = threading.RLock()

    def read(self, key: str) -> Any:
        with self._lock:
            if key not in self._data:
                raise KeyError(key)
            return self._data[key]

    def write(self, key: str, value: Any) -> None:
        with self._lock:
            self._data[key] = value

    def delete(self, key: str) -> None:
        with self._lock:
            self._data.pop(key, None)


# -- plugin interfaces --------------------------------------------------------
class Plugin:
    NAME = "unnamed"

    def name(self) -> str:
        return self.NAME


class QueueSortPlugin(Plugin):
    def less(self, pod_info1, pod_info2) -> bool:
        raise NotImplementedError


class ReservePlugin(Plugin):
    def reserve(self, ctx: PluginContext, pod, node_name: str) -> Status:
        raise NotImplementedError


class PrebindPlugin(Plugin):
    def prebind(self, ctx: PluginContext, pod, node_name: str) -> Status:
        raise NotImplementedError


class UnreservePlugin(Plugin):
    def unreserve(self, ctx: PluginContext, pod, node_name: str) -> None:
        raise NotImplementedError


class PermitPlugin(Plugin):
    def permit(self, ctx: PluginContext, pod, node_name: str
               ) -> tuple[Status, float]:
        """Returns (status, timeout_seconds); WAIT parks the pod."""
        raise NotImplementedError


class WaitingPod:
    """A pod parked at Permit (waiting_pods_map.go)."""

    def __init__(self, pod, timeout: float):
        self.pod = pod
        self.timeout = timeout
        self._event = threading.Event()
        self._allowed = False

    def allow(self) -> None:
        self._allowed = True
        self._event.set()

    def reject(self) -> None:
        self._allowed = False
        self._event.set()

    def wait(self) -> bool:
        """Block until allowed/rejected/timeout. True = allowed."""
        signaled = self._event.wait(self.timeout)
        return self._allowed if signaled else False


# -- registry + framework -----------------------------------------------------
PluginFactory = Callable[[dict, "FrameworkHandle"], Plugin]


class Registry(dict):
    """name -> PluginFactory (registry.go:31)."""

    def register(self, name: str, factory: PluginFactory) -> None:
        if name in self:
            raise ValueError(f"plugin {name} already registered")
        self[name] = factory

    def unregister(self, name: str) -> None:
        if name not in self:
            raise ValueError(f"plugin {name} not registered")
        del self[name]

    def merge(self, other: "Registry") -> None:
        for name, factory in other.items():
            self.register(name, factory)


class FrameworkHandle:
    """What plugins may touch (interface.go:210): the cycle snapshot and the
    API surface."""

    def __init__(self, snapshot_fn: Callable[[], dict], store=None):
        self._snapshot_fn = snapshot_fn
        self.store = store

    def node_info_snapshot(self) -> dict:
        return self._snapshot_fn()


class Framework(FrameworkHandle):
    """Instantiates every registered plugin and dispatches per point
    (framework.go:52-90)."""

    def __init__(self, registry: Registry, plugin_args: Optional[dict] = None,
                 snapshot_fn: Callable[[], dict] = lambda: {}, store=None,
                 enabled: Optional[list[str]] = None):
        super().__init__(snapshot_fn, store)
        self.plugins: dict[str, Plugin] = {}
        self.queue_sort: list[QueueSortPlugin] = []
        self.reserve: list[ReservePlugin] = []
        self.prebind: list[PrebindPlugin] = []
        self.unreserve: list[UnreservePlugin] = []
        self.permit: list[PermitPlugin] = []
        self.waiting_pods: dict[str, WaitingPod] = {}
        self._waiting_lock = threading.RLock()
        args = plugin_args or {}
        names = enabled if enabled is not None else list(registry)
        for name in names:
            factory = registry.get(name)
            if factory is None:
                raise ValueError(f"plugin {name} not in registry")
            p = factory(args.get(name, {}), self)
            self.plugins[name] = p
            if isinstance(p, QueueSortPlugin):
                self.queue_sort.append(p)
            if isinstance(p, ReservePlugin):
                self.reserve.append(p)
            if isinstance(p, PrebindPlugin):
                self.prebind.append(p)
            if isinstance(p, UnreservePlugin):
                self.unreserve.append(p)
            if isinstance(p, PermitPlugin):
                self.permit.append(p)
        if len(self.queue_sort) > 1:
            raise ValueError("only one QueueSort plugin may be enabled")

    # -- dispatch (framework.go RunXPlugins) ---------------------------------
    def run_reserve_plugins(self, ctx: PluginContext, pod, node_name: str) -> Status:
        for p in self.reserve:
            st = p.reserve(ctx, pod, node_name)
            if not st.is_success():
                return Status(ERROR, f"reserve plugin {p.name()}: {st.message}")
        return Status.success()

    def run_prebind_plugins(self, ctx: PluginContext, pod, node_name: str) -> Status:
        for p in self.prebind:
            st = p.prebind(ctx, pod, node_name)
            if not st.is_success():
                if st.code == UNSCHEDULABLE:
                    return st
                return Status(ERROR, f"prebind plugin {p.name()}: {st.message}")
        return Status.success()

    def run_unreserve_plugins(self, ctx: PluginContext, pod, node_name: str) -> None:
        for p in self.unreserve:
            p.unreserve(ctx, pod, node_name)

    def run_permit_plugins(self, ctx: PluginContext, pod, node_name: str) -> Status:
        """Runs permits; on WAIT parks the pod and blocks until
        allow/reject/timeout (framework.go RunPermitPlugins + WaitOnPermit)."""
        timeout = 0.0
        status_code = SUCCESS
        for p in self.permit:
            st, t = p.permit(ctx, pod, node_name)
            if not st.is_success():
                if st.code == UNSCHEDULABLE:
                    return st
                if st.code == WAIT:
                    status_code = WAIT
                    timeout = max(timeout, t)
                else:
                    return Status(ERROR, f"permit plugin {p.name()}: {st.message}")
        if status_code != WAIT:
            return Status.success()
        wp = WaitingPod(pod, timeout)
        with self._waiting_lock:
            self.waiting_pods[pod.uid] = wp
        try:
            allowed = wp.wait()
        finally:
            with self._waiting_lock:
                self.waiting_pods.pop(pod.uid, None)
        if allowed:
            return Status.success()
        return Status(UNSCHEDULABLE, f"pod {pod.key} rejected while waiting at permit")

    def get_waiting_pod(self, uid: str) -> Optional[WaitingPod]:
        with self._waiting_lock:
            return self.waiting_pods.get(uid)

    def iterate_waiting_pods(self) -> list[WaitingPod]:
        with self._waiting_lock:
            return list(self.waiting_pods.values())
