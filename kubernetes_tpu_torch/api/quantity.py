"""Minimal resource.Quantity parser — "100m" CPU, "32Gi" memory, etc.

Covers the quantity forms the scheduler benchmarks use (reference:
apimachinery/pkg/api/resource). CPU strings convert to milli-cores;
byte strings convert to bytes.
"""
from __future__ import annotations

_BINARY = {"Ki": 1024, "Mi": 1024**2, "Gi": 1024**3, "Ti": 1024**4, "Pi": 1024**5}
_DECIMAL = {"k": 10**3, "M": 10**6, "G": 10**9, "T": 10**12, "P": 10**15}


def parse_cpu(s: str | int | float) -> int:
    """Parse a CPU quantity into milli-cores."""
    if isinstance(s, int):
        return s * 1000
    if isinstance(s, float):
        return int(s * 1000)
    s = s.strip()
    if s.endswith("m"):
        return int(s[:-1])
    return int(float(s) * 1000)


def parse_mem(s: str | int) -> int:
    """Parse a memory/storage quantity into bytes."""
    if isinstance(s, int):
        return s
    s = s.strip()
    for suf, mult in _BINARY.items():
        if s.endswith(suf):
            return int(float(s[: -len(suf)]) * mult)
    for suf, mult in _DECIMAL.items():
        if s.endswith(suf):
            return int(float(s[: -len(suf)]) * mult)
    return int(float(s))


def requests(cpu: str | int | float | None = None, mem: str | int | None = None,
             **scalars: int) -> dict[str, int]:
    """Build a requests dict: requests(cpu="100m", mem="200Mi", **{"example.com/foo": 2})."""
    out: dict[str, int] = {}
    if cpu is not None:
        out["cpu"] = parse_cpu(cpu)
    if mem is not None:
        out["memory"] = parse_mem(mem)
    out.update(scalars)
    return out
