"""Minimal 5-field cron schedule parser for the CronJob controller.

Supports the syntax the reference's vendored robfig/cron exposes for
CronJob schedules: numbers, `*`, lists (`a,b`), ranges (`a-b`), and steps
(`*/n`, `a-b/n`) across minute / hour / day-of-month / month / day-of-week
(0-6, Sunday=0; 7 also accepted as Sunday). Day-of-month and day-of-week
are OR'd when both are restricted, per cron convention.

Timezone: schedules are evaluated in **UTC** (`time.gmtime`), NOT the
process's local timezone. This is a deliberate divergence from the
reference's kube-controller-manager, which evaluates CronJob schedules in
its own local time (cronjob_controller.go — a documented footgun that
makes firing times depend on where the controller-manager pod runs).
Pinning UTC keeps `0 12 * * *` meaning 12:00 UTC on every host;
`TestCronSchedule.test_schedule_is_utc_not_localtime` enforces it.

The port's copy of the reference's `utils/cron.py` with the port's
imports.
"""
from __future__ import annotations

import time
from typing import Optional

_BOUNDS = [(0, 59), (0, 23), (1, 31), (1, 12), (0, 6)]


class CronParseError(ValueError):
    pass


def _parse_field(spec: str, lo: int, hi: int, dow: bool = False) -> frozenset:
    out: set[int] = set()
    for part in spec.split(","):
        step = 1
        if "/" in part:
            part, step_s = part.split("/", 1)
            try:
                step = int(step_s)
            except ValueError:
                raise CronParseError(f"bad step {step_s!r}")
            if step <= 0:
                raise CronParseError(f"bad step {step}")
        if part == "*" or part == "":
            a, b = lo, hi
        elif "-" in part:
            a_s, b_s = part.split("-", 1)
            try:
                a, b = int(a_s), int(b_s)
            except ValueError:
                raise CronParseError(f"bad range {part!r}")
        else:
            try:
                a = b = int(part)
            except ValueError:
                raise CronParseError(f"bad value {part!r}")
        top = 7 if dow else hi   # dow accepts 7 (= Sunday) anywhere
        if not (lo <= a <= top and lo <= b <= top and a <= b):
            raise CronParseError(f"value out of range: {part!r}")
        vals = range(a, b + 1, step)
        # normalize AFTER expanding so ranges through 7 work ('1-7', '5-7',
        # '0-7' all mean what vixie/robfig cron mean)
        out.update(v % 7 for v in vals) if dow else out.update(vals)
    return frozenset(out)


class CronSchedule:
    def __init__(self, expr: str):
        fields = expr.split()
        if len(fields) != 5:
            raise CronParseError(
                f"expected 5 fields, got {len(fields)}: {expr!r}")
        self.expr = expr
        self.minute = _parse_field(fields[0], *_BOUNDS[0])
        self.hour = _parse_field(fields[1], *_BOUNDS[1])
        self.dom = _parse_field(fields[2], *_BOUNDS[2])
        self.month = _parse_field(fields[3], *_BOUNDS[3])
        self.dow = _parse_field(fields[4], *_BOUNDS[4], dow=True)
        # robfig/vixie treat '*' AND '*/n' as star for the dom/dow OR rule
        self._dom_star = fields[2].split("/", 1)[0] == "*"
        self._dow_star = fields[4].split("/", 1)[0] == "*"

    def matches(self, ts: float) -> bool:
        """True when the UTC wall-clock minute containing `ts` matches
        (schedules are UTC by contract — see the module docstring)."""
        t = time.gmtime(ts)
        if t.tm_min not in self.minute or t.tm_hour not in self.hour \
                or t.tm_mon not in self.month:
            return False
        dom_ok = t.tm_mday in self.dom
        dow_ok = (t.tm_wday + 1) % 7 in self.dow   # tm_wday: Monday=0
        if self._dom_star or self._dow_star:
            return dom_ok and dow_ok
        return dom_ok or dow_ok   # both restricted: cron ORs them

    def next_after(self, ts: float, limit_days: int = 366) -> Optional[float]:
        """First matching minute strictly after `ts` (UTC), or None within
        the search horizon."""
        # round up to the next whole minute
        t = int(ts // 60 + 1) * 60
        end = t + limit_days * 86400
        while t < end:
            if self.matches(t):
                return float(t)
            t += 60
        return None
