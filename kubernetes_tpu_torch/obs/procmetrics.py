"""Process self-metrics — the leak-detection families.

Copied whole from the reference (`kubernetes_tpu.obs.procmetrics`) with
the port's imports.

A soak's first casualty is usually the process itself: a heap that only
grows, a file-descriptor leak from un-stopped watches, a thread that
never joins, or cyclic-GC pauses landing inside window prologues (round
17 measured 127 ms gen2 passes exactly there). None of that was visible
without attaching a profiler. This module registers the standard
process-health families EAGERLY (imported from `obs.__init__`, before
any component), so the time-series scraper sees them from sample 0 and
the soak verdict engine can run its monotonic-RSS detector over a full
trajectory:

- ``process_resident_memory_bytes`` / ``process_virtual_memory_bytes``
  — callback gauges of the resident / virtual size (VmRSS / VmSize); 0
  on platforms without procfs (the scrape must never fail);
- ``process_open_fds`` — len(/proc/self/fd) (watch leaks show up here
  long before accept() starts failing);
- ``process_threads`` — threading.active_count() (fleet drivers,
  watcher drainers, and scraper threads must come back down after a
  cell);
- ``python_gc_pause_seconds{generation}`` — a histogram fed by
  `gc.callbacks` ("start"/"stop" bracket every collection): the
  stop-the-world pauses the round-17 GC posture defers, now measurable
  without a profiler. Installed once per process; `install()` is
  idempotent and `uninstall()` exists for test isolation.

Everything here must stay allocation-light: the gauges are read on
every /metrics render AND every scraper sample (default 2 Hz in a
soak), and the gc callback runs inside the collector's pause.

Copied from the reference (`kubernetes_tpu.obs.procmetrics`) with the
port's imports. Two departures. The gc callback folds a collection only
when its children's locks are free and keeps it for a later collection
otherwise (see `_fold`: the reference's can deadlock the thread a
collection interrupted). And the /proc gauges read /proc at most every
PROC_REFRESH_S (0.25 s), one read of /proc/self/statm (the pages the
kernel reports as VmRSS and VmSize in /proc/self/status, times the page
size) and one listing of /proc/self/fd serving all three: on the card's
host those reads were most of a time-series sample's cost.
"""
from __future__ import annotations

import gc
import os
import threading
import time
from collections import deque
from typing import Optional

from kubernetes_tpu_torch import obs
from kubernetes_tpu_torch.obs.registry import MICRO_BUCKETS

try:
    _PAGE = os.sysconf("SC_PAGE_SIZE")
except (AttributeError, ValueError, OSError):
    _PAGE = 4096


#: seconds a /proc read serves the three /proc gauges for: a read costs
#: 0.04-0.36 ms on the card's host (more as the process grows), the
#: time-series scraper collects every gauge each sample (20 a second in
#: the overhead floor), and the leak detectors judge minutes
PROC_REFRESH_S = 0.25
#: the last /proc read: perf_counter, resident bytes, virtual bytes, fds
_proc_last: tuple = (float("-inf"), 0.0, 0.0, 0.0)


def _proc_values() -> tuple:
    """(resident bytes, virtual bytes, open fds), read again when the last
    read is PROC_REFRESH_S old; zeros without procfs."""
    global _proc_last
    now = time.perf_counter()
    if now - _proc_last[0] < PROC_REFRESH_S:
        return _proc_last[1:]
    rss = vsz = fds = 0.0
    try:
        fd = os.open("/proc/self/statm", os.O_RDONLY)
        try:
            fields = os.read(fd, 256).split()
        finally:
            os.close(fd)
        vsz, rss = float(fields[0]) * _PAGE, float(fields[1]) * _PAGE
    except (OSError, ValueError, IndexError):
        pass
    try:
        fds = float(len(os.listdir("/proc/self/fd")))
    except OSError:
        pass
    _proc_last = (now, rss, vsz, fds)
    return _proc_last[1:]


def resident_memory_bytes() -> float:
    return _proc_values()[0]


def virtual_memory_bytes() -> float:
    return _proc_values()[1]


def open_fds() -> float:
    return _proc_values()[2]


RSS = obs.gauge(
    "process_resident_memory_bytes",
    "Resident set size of this process (VmRSS, from /proc/self/statm; "
    "0 without procfs). The soak verdict engine's monotonic-growth "
    "detector reads this series.")
RSS.set_function(resident_memory_bytes)

VSZ = obs.gauge(
    "process_virtual_memory_bytes",
    "Virtual memory size of this process (VmSize, from /proc/self/statm; "
    "0 without procfs).")
VSZ.set_function(virtual_memory_bytes)

OPEN_FDS = obs.gauge(
    "process_open_fds",
    "Open file descriptors (len of /proc/self/fd; 0 without procfs). "
    "Un-stopped watches and leaked sockets show up here long before "
    "accept() starts failing.")
OPEN_FDS.set_function(open_fds)

THREADS = obs.gauge(
    "process_threads",
    "Live Python threads (threading.active_count()): fleet drivers, "
    "watcher drainers, and scraper threads must come back down after a "
    "bench cell.")
THREADS.set_function(lambda: float(threading.active_count()))

GC_PAUSE = obs.histogram(
    "python_gc_pause_seconds",
    "Cyclic-GC collection pauses by generation, bracketed via "
    "gc.callbacks (start->stop). The round-17 serve cells measured "
    "~127 ms gen2 passes landing as window-prologue stalls; this makes "
    "that visible without a profiler.",
    ("generation",), buckets=MICRO_BUCKETS)

GC_COLLECTED = obs.counter(
    "python_gc_collected_total",
    "Objects reclaimed by the cyclic collector, by generation (from the "
    "gc callback's info dict).", ("generation",))

# -- gc.callbacks bracket -----------------------------------------------------
# one slot per generation: gc is not reentrant per generation, and the
# callback runs inside the collector's stop-the-world pause — keep it to
# a clock read and a dict store
_gc_start: dict[int, float] = {}
_installed = False
# the generations' children, made here: the callback never takes a
# family's lock
_GENERATIONS = ("0", "1", "2")
for _g in _GENERATIONS:
    GC_PAUSE.labels(_g)
    GC_COLLECTED.labels(_g)
#: collections not folded yet: (generation, pause seconds or None,
#: objects collected)
_pending: deque = deque()


def _fold(gen: int, pause: Optional[float], collected: int) -> bool:
    """Fold one collection into its children, or leave it (False) when
    a child's lock is held. A collection runs in the thread whose
    allocation started it, which may be inside that very child's `with
    child._lock:` block (the time-series scraper's snapshot, a /metrics
    render): waiting for the lock there would never end. The reference
    observes unconditionally, and its scraper thread can hang so."""
    pause_child = GC_PAUSE.labels(str(gen))
    count_child = GC_COLLECTED.labels(str(gen))
    for child in (pause_child, count_child):
        if not child._lock.acquire(blocking=False):
            return False
        child._lock.release()
    if pause is not None:
        pause_child.observe(pause)
    if collected:
        count_child.inc(collected)
    return True


def _gc_callback(phase: str, info: dict) -> None:
    gen = info.get("generation", 0)
    if phase == "start":
        _gc_start[gen] = time.perf_counter()
        return
    t0 = _gc_start.pop(gen, None)
    pause = None if t0 is None else time.perf_counter() - t0
    collected = info.get("collected", 0)
    if pause is None and not collected:
        return
    # this collection and any left by earlier ones, oldest first
    _pending.append((gen, pause, collected))
    while _pending and _fold(*_pending[0]):
        _pending.popleft()


def install() -> None:
    """Attach the gc pause bracket (idempotent)."""
    global _installed
    if _installed:
        return
    gc.callbacks.append(_gc_callback)
    _installed = True


def uninstall() -> None:
    """Detach the bracket (test isolation)."""
    global _installed
    if _installed:
        try:
            gc.callbacks.remove(_gc_callback)
        except ValueError:
            pass
        _installed = False
        _gc_start.clear()
        _pending.clear()


install()
